"""Model flops of the window's steps over the window, over the chips'
bf16 peak: 6 x (parameters except the embedding) + 6 L S d a token
(``_work.train_flops_per_token``); a recompute is not counted."""

from portbench.metrics import _work


def read(record):
    if record["kind"] != "train" or not record["steps"]:
        return None
    flops = record["tokens"] * _work.train_flops_per_token(
        record["cfg"], int(record["mix"]["seq_len"]))
    return _work.mfu_pct(flops, record["window_s"], record["chips"])
