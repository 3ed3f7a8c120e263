"""Every output token streamed to its consumer in the window, over the
window."""


def read(record):
    if record["kind"] != "serve":
        return None
    t0, t1 = record["t0"], record["t_end"]
    n = sum(1 for r in record["requests"] for t in r["times"] if t0 <= t < t1)
    return n / (t1 - t0)
