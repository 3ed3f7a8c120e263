"""The device's idle share in the traced span: 1 - (the union of its
operations' intervals / the span's wall), from ``torch.profiler``."""


def read(record):
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
