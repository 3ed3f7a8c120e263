"""The yardstick's arithmetic: the H100's published peaks, the model's
operations per token, and each kernel's operations and bytes from its
shapes.  Every reader takes its work from here, so whatever implements a
kernel or a step is read against the same work.

Peaks are NVIDIA's data sheet for the H100 SXM, dense rates at the full
700 W power limit; a run records the card's own limit beside them.
"""

from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12    # device memory bandwidth
BF16_BYTES = 2


def dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return {"d": d, "h": h, "hkv": hkv, "hd": d // h,
            "layers": cfg["num_hidden_layers"], "vocab": cfg["vocab_size"],
            "f": cfg["intermediate_size"]}


def params_without_embedding(cfg: dict) -> int:
    """Every weight a token's forward multiplies by: the blocks, the final
    norm and the output head, not the embedding table (a lookup)."""
    x = dims(cfg)
    q, kv = x["h"] * x["hd"], x["hkv"] * x["hd"]
    per_layer = 2 * x["d"] * q + 2 * x["d"] * kv + 3 * x["d"] * x["f"] \
        + 2 * x["d"]
    return x["layers"] * per_layer + x["d"] + x["vocab"] * x["d"]


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 x (parameters except the embedding) for the weight products of
    the forward and backward passes, and 6 L S d for causal attention
    (QK^T and PV over S/2 positions on average, forward and backward);
    a recompute is not counted."""
    x = dims(cfg)
    return 6.0 * params_without_embedding(cfg) \
        + 6.0 * x["layers"] * seq_len * x["d"]


def forward_flops(cfg: dict, tokens: int, context_sum: int) -> float:
    """One forward pass over ``tokens`` tokens whose contexts (the
    positions each attends to, itself included) sum to ``context_sum``:
    2 x (parameters except the embedding) a token, and QK^T and PV over
    its context, 4 d a position a layer."""
    x = dims(cfg)
    return 2.0 * params_without_embedding(cfg) * tokens \
        + 4.0 * x["layers"] * x["d"] * context_sum


def causal_context_sum(lo: int, hi: int) -> int:
    """Sum of the contexts of positions lo .. hi - 1: position j sees
    j + 1 positions."""
    return (hi * (hi + 1) - lo * (lo + 1)) // 2


def mfu_pct(flops: float, seconds: float, chips: int = 1) -> float:
    return 100.0 * flops / seconds / (chips * PEAK_BF16_FLOPS)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_fwd(batch: int, seq: int, heads: int, kv_heads: int,
              head_dim: int) -> tuple:
    """(operations, bytes) of one causal flash forward in bf16: QK^T and
    PV over the lower triangle, 2 B H S^2 D; q, k, v read once and the
    output written once."""
    flops = 2.0 * batch * heads * seq * seq * head_dim
    nbytes = (2 * batch * seq * heads * head_dim
              + 2 * batch * seq * kv_heads * head_dim) * BF16_BYTES
    return flops, nbytes


def paged_decode(cfg: dict, lanes: int, context_rows: int) -> tuple:
    """(operations, bytes) of one layer's paged decode attention over
    ``lanes`` queries whose contexts hold ``context_rows`` positions in
    all: each K and V row read once, q read and the output written."""
    x = dims(cfg)
    flops = 4.0 * context_rows * x["h"] * x["hd"]
    nbytes = (2 * context_rows * x["hkv"] * x["hd"]
              + 2 * lanes * x["h"] * x["hd"]) * BF16_BYTES
    return flops, nbytes


def share_pct(bound_s: float, measured_s: float):
    """The roofline share, or None when nothing was measured."""
    if measured_s <= 0 or not math.isfinite(measured_s):
        return None
    return 100.0 * bound_s / measured_s
