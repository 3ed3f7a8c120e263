"""95th percentile of every gap between consecutive output tokens of
every request, over the gaps that end in the window."""

from portbench.lib.stats import percentile


def read(record):
    if record["kind"] != "serve":
        return None
    t0, t1 = record["t0"], record["t_end"]
    gaps = [b - a for r in record["requests"]
            for a, b in zip(r["times"], r["times"][1:]) if t0 <= b < t1]
    return 1e3 * percentile(gaps, 95) if gaps else None
