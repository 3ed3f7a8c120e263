"""Model flops the engine computed in the window: 2 x (parameters
except the embedding) a token computed (prefill or decode; shared-prefix
tokens are not computed) and QK^T and PV over its context, over the summed wall of the engine steps that did work in it (so a fixed
offered rate does not pin it),
over the bf16 peak."""

from portbench.metrics import _work


def read(record):
    w = record.get("work")
    if not w or not w["tokens"]:
        return None
    flops = _work.forward_flops(record["cfg"], w["tokens"], w["context_sum"])
    return _work.mfu_pct(flops, record["step_wall_s"], record["chips"])
