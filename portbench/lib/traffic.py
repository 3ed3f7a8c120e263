"""The one generator of every traffic mix.

A mix is a JSON file of parameters under ``traffic/``; its ``kind`` says
which of three shapes it takes:

  train_batches  a fresh [batch, seq_len] block of token ids each step;
  closed_loop    ``clients`` streams, each sending its next request
                 when the last one has finished;
  open_poisson   requests due at a fixed mean rate ``rate_per_s``.

Sizes are drawn by quantile, not at random: each block of ``block``
requests holds the same multiset of prompt lengths, output lengths and
(open loop) gaps between arrivals, each at the quantiles (i + 1/2) /
block of its distribution, and the seed only orders them within the
block and draws the token ids.  So every seed gives the same work in
another order, and runs on different seeds differ by the system's noise,
not by the traffic's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` values at the quantiles (i + 1/2) / n of ``dist``:
    ``{"dist": "uniform" | "loguniform", "lo", "hi"}`` (integers, both
    ends included) or ``{"dist": "exponential", "mean"}`` (floats)."""
    q = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "exponential":
        return -np.log1p(-q) * float(dist["mean"])
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if kind == "uniform":
        v = lo + q * (hi + 1 - lo)
    elif kind == "loguniform":
        v = np.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo)))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.floor(v), lo, hi).astype(np.int64)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def requests(mix: dict, seed: int, vocab: int, n_blocks: int
             ) -> List[Dict]:
    """``n_blocks`` blocks of requests: each a dict of ``tokens`` (the
    shared prefix, if the mix has one, and then the request's own
    tokens), ``max_new_tokens`` and, for an open loop, ``due_s``: its
    due time from the start of the arrivals."""
    block = int(mix["block"])
    prefix_len = int(mix.get("shared_prefix", 0))
    prefix = _rng(seed, 0).integers(0, vocab, prefix_len).tolist()
    prompts = quantiles(mix["prompt_len"], block)
    outputs = quantiles(mix["output_len"], block)
    gaps = (quantiles({"dist": "exponential",
                       "mean": 1.0 / float(mix["rate_per_s"])}, block)
            if mix["kind"] == "open_poisson" else None)
    out, due = [], 0.0
    for b in range(n_blocks):
        rng = _rng(seed, 1, b)
        p, o = rng.permutation(prompts), rng.permutation(outputs)
        g = rng.permutation(gaps) if gaps is not None else None
        for i in range(block):
            req = {"tokens": prefix + rng.integers(0, vocab, int(p[i])).tolist(),
                   "max_new_tokens": int(o[i])}
            if g is not None:
                due += float(g[i])
                req["due_s"] = due
            out.append(req)
    return out


def batch_tokens(mix: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s [batch, seq_len] token ids, drawn on ``device``."""
    import torch

    from portbench.lib.weights import group_seed

    gen = torch.Generator(device).manual_seed(group_seed(seed, f"batch{step}"))
    return torch.randint(0, vocab, (int(mix["batch"]), int(mix["seq_len"])),
                         generator=gen, device=device, dtype=torch.int32)
