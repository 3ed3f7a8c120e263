"""The flash forward kernel's share of its roofline in the traced steps:
its launches' least time (the larger of operations over the bf16 peak
and bytes over the memory bandwidth, at the train batch's shape) over
its measured device time."""

from portbench.lib.trace import kernel_seconds
from portbench.metrics import _work


def read(record):
    t = record.get("trace")
    if not t or record["kind"] != "train":
        return None
    seconds, launches = kernel_seconds(t, "flash_fwd")
    if not launches:
        return None
    x = _work.dims(record["cfg"])
    flops, nbytes = _work.flash_fwd(int(record["mix"]["batch"]),
                                    int(record["mix"]["seq_len"]), x["h"],
                                    x["hkv"], x["hd"])
    return _work.share_pct(launches * _work.roofline_s(flops, nbytes),
                           seconds)
