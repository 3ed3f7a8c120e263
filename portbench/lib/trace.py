"""What a ``torch.profiler`` trace says about the device.

``reduce(prof, wall_s)`` turns one profiled span into plain numbers:
the seconds in which some operation ran on the device (the union of
their intervals, so overlapping streams count once), the span's length,
device seconds and launches by operation name, and the longest idle
gaps, each named by the innermost host operation running across it
("host" where none is: the program's own Python).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple


def profile():
    from torch.profiler import ProfilerActivity, profile as _profile

    return _profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA])


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_name_at(host: List[Tuple[float, float, str]], starts: List[float],
                  t: float) -> str:
    """The shortest host event that covers ``t`` (host events sorted by
    start)."""
    best, best_len = "host", float("inf")
    i = bisect.bisect_right(starts, t)
    # host events nest; scan back over the ones that start before t
    for a, b, name in reversed(host[max(0, i - 400):i]):
        if a <= t <= b and b - a < best_len:
            best, best_len = name, b - a
    return best


def reduce(prof, wall_s: float) -> Dict:
    from torch.autograd import DeviceType

    device, host, by_name, count = [], [], {}, {}
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            device.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
            count[e.name] = count.get(e.name, 0) + 1
        else:
            host.append((a, b, e.name))
    busy = union(device)
    busy_s = sum(b - a for a, b in busy)
    host.sort()
    starts = [h[0] for h in host]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    idle = [[_host_name_at(host, starts, (a + b) / 2)[:80], g]
            for g, a, b in gaps]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": wall_s, "by_name": by_name,
            "count_by_name": count,
            "launches": len(device),
            "device_ops": [[n[:80], s] for n, s in top], "idle_gaps": idle}


def kernel_seconds(trace: Dict, key: str) -> Tuple[float, int]:
    """Device seconds and launches of the operations whose name holds
    ``key``."""
    names = [n for n in trace["by_name"] if key in n]
    return (sum(trace["by_name"][n] for n in names),
            sum(trace["count_by_name"][n] for n in names))
