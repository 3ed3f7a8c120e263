"""AdamW's device time a step in the traced steps: the foreach
optimizer's ``multi_tensor_apply`` kernels, which nothing else in the
step launches."""

from portbench.lib.trace import kernel_seconds


def read(record):
    t = record.get("trace")
    if not t or record["kind"] != "train":
        return None
    seconds, launches = kernel_seconds(t, "multi_tensor_apply")
    return 1e3 * seconds / record["trace_steps"] if launches else None
