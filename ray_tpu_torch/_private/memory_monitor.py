"""Node memory-pressure watchdog: sampling + victim-selection policy.

Equivalent of the reference's memory monitor + worker-killing policy
(reference: src/ray/common/memory_monitor.h:52 +
raylet/worker_killing_policy_group_by_owner.cc): sample node usage and
per-worker RSS every ``memory_monitor_refresh_ms``; when usage crosses
``memory_usage_threshold`` pick ONE victim worker, kill it deliberately
and hand its owner a typed receipt (OutOfMemoryError with the RSS and
the node breakdown) — the alternative is the kernel OOM killer taking
the whole agent down and every owner seeing a mystery death.

The policy favors progress preservation over strict LIFO:

  1. the highest-RSS worker running a RETRIABLE task (the one actually
     ballooning, and the one whose owner can transparently resubmit),
     ties broken toward the LAST-started lease (earlier work keeps its
     progress — the reference's "kill the task submitted last");
  2. then non-retriable task / plain actor workers;
  3. pinned-loop actors (compiled-DAG / pipeline / LLM decode loops —
     killing one tears down a whole graph) and workers mid-__rt_save__
     (killing mid-snapshot risks the actor's durable state) only as a
     last resort.

Everything here is a pure function of its inputs (injectable clock,
sampler fed by the caller) so the kill policy unit-tests run without a
cluster or any real memory pressure.  The node_agent owns the asyncio
loop that drives ``OomWatchdog.tick`` and executes the kill.

Usage sources, first match wins:
  - ``memory_monitor_test_usage_file``: a fraction in a file (tests
    steer pressure without allocating anything);
  - ``memory_monitor_node_total_bytes`` > 0: sum(worker RSS) / total —
    a VIRTUAL node envelope, so several agents on one host each see
    only their own workers' pressure (bench/test overcommit stays safe);
  - /proc/meminfo: 1 - MemAvailable/MemTotal, the real node.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_rss_bytes(pid: int) -> Optional[int]:
    """ANONYMOUS resident bytes of a live process (RssAnon from
    /proc/<pid>/status), falling back to full RSS from statm; None when
    the process is gone/unreadable.

    Anonymous-only is deliberate: every worker mmaps the node's shared
    object-store arena, and prefaulted tmpfs pages show up in each
    attacher's VmRSS — a 512MB arena would make every worker look like
    a 500MB hog and the victim policy meaningless.  Task allocations
    (and the watchdog's quarry, a ballooning heap) are anonymous."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("RssAnon"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return None


def read_meminfo_fraction() -> Optional[float]:
    """Real node pressure in [0, 1] from /proc/meminfo; None if
    unreadable (non-Linux)."""
    try:
        fields: Dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                fields[key] = int(rest.split()[0])
        total = fields.get("MemTotal", 0)
        avail = fields.get("MemAvailable", fields.get("MemFree", 0))
        if total <= 0:
            return None
        return 1.0 - avail / total
    except (OSError, ValueError):
        return None


@dataclass
class WorkerSample:
    """One leased worker as the victim policy sees it."""

    worker_id: str
    rss: int                 # bytes, sampled this tick
    lease_seq: int = 0       # grant order; larger = started later
    retriable: bool = True   # granting spec had max_retries != 0
    pinned: bool = False     # running a __rt_dag_* pinned loop
    saving: bool = False     # mid-__rt_save__ state snapshot
    fid: str = ""            # granting spec's function/class id
    name: str = ""           # task/actor display name


def pick_victim(samples: List[WorkerSample]) -> Optional[WorkerSample]:
    """The worker to kill under pressure, or None when there is nothing
    killable.  Ordering: retriable-task workers first (highest RSS,
    then last-started), then non-retriable, with pinned-loop and
    mid-save workers demoted to last resort within both groups."""
    if not samples:
        return None

    def rank(s: WorkerSample) -> tuple:
        # lower tuple = better victim
        return (1 if (s.pinned or s.saving) else 0,
                0 if s.retriable else 1,
                -s.rss, -s.lease_seq)

    return min(samples, key=rank)


def is_self_poisoning(rss: int, limit: int, factor: float = 0.9) -> bool:
    """Whether one watchdog kill counts toward the poison-task
    quarantine: the victim's own RSS approached the node's kill
    ceiling (``limit`` = threshold * node total, carried in the kill
    receipt), so the task can never fit even alone.  A modest-RSS
    victim of AGGREGATE pressure just retries — counting it would
    quarantine healthy classes under overcommit.  ``limit`` <= 0 means
    no ceiling is known (test usage-file pressure): count every kill.
    The single definition both counting sites (owner task kills, head
    actor kills) share."""
    return limit <= 0 or rss >= factor * limit


def usage_fraction(test_usage_file: str = "",
                   virtual_total_bytes: int = 0,
                   worker_rss_sum: int = 0) -> Optional[float]:
    """Node memory pressure per the source precedence in the module
    docstring; None when no source is readable."""
    if test_usage_file:
        try:
            with open(test_usage_file) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return None
    if virtual_total_bytes > 0:
        return worker_rss_sum / float(virtual_total_bytes)
    return read_meminfo_fraction()


@dataclass
class OomWatchdog:
    """The kill-decision engine: threshold crossing + kill-rate limit.
    Pure against an injectable clock; the caller supplies the sampled
    usage and worker set each tick and executes any returned kill."""

    threshold: float = 0.95
    min_kill_gap_s: float = 1.0
    clock: Callable[[], float] = time.monotonic
    last_kill_at: float = field(default=0.0, init=False)
    kills: int = field(default=0, init=False)

    def tick(self, usage: Optional[float],
             samples: List[WorkerSample]) -> Optional[WorkerSample]:
        """The victim to kill this tick, or None.  A kill is produced at
        most once per ``min_kill_gap_s`` so the previous kill's memory
        actually returns before the next decision reads the gauge."""
        if usage is None or usage < self.threshold:
            return None
        now = self.clock()
        if self.last_kill_at and now - self.last_kill_at < self.min_kill_gap_s:
            return None
        victim = pick_victim(samples)
        if victim is None:
            return None
        self.last_kill_at = now
        self.kills += 1
        return victim
