"""95th percentile, over every request due in the window, of the time
from when it was due to its first token; a failed request counts as
never served."""

import math

from portbench.lib.stats import percentile


def read(record):
    if record["kind"] != "serve":
        return None
    t0, t1 = record["t0"], record["t_end"]
    ttft = [r["times"][0] - r["due"] if r["times"] and not r["failed"]
            else math.inf for r in record["requests"] if t0 <= r["due"] < t1]
    return percentile(ttft, 95) if ttft else None
