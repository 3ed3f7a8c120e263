"""The paged decode kernels' (split and merge) share of their roofline
in the traced engine steps: the least time to read each lane's context
of K and V once per layer (and q and the output) over their measured
device time."""

from portbench.lib.trace import kernel_seconds
from portbench.metrics import _work


def read(record):
    t = record.get("trace")
    if not t or "trace_decode" not in record:
        return None
    seconds, launches = kernel_seconds(t, "paged_decode")
    lanes, rows = record["trace_decode"]
    if not launches or not rows:
        return None
    flops, nbytes = _work.paged_decode(record["cfg"], lanes, rows)
    layers = record["cfg"]["num_hidden_layers"]
    return _work.share_pct(layers * _work.roofline_s(flops, nbytes), seconds)
