"""The engine's decode step: the change in ``stats()``'s ``decode_secs``
over the change in ``decode_steps`` across the window (the program's
host clock, each ending in the step's one read of its tokens)."""


def read(record):
    w = record.get("work")
    if not w or not w["decode_steps"]:
        return None
    return 1e3 * w["decode_secs"] / w["decode_steps"]
