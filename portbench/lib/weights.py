"""Weights drawn on the device from a run's seed.

One generator call per layer (and one each for the embedding and the
output head) fills a flat buffer in the dtype the weights are served or
trained in; each weight is a view of it, scaled to std 1/sqrt(fan_in)
(the embedding to 1/sqrt(hidden)); norm scales are ones.  The same seed
gives the same values on both sides of a comparison, so the program is
fed these tensors and the reference draws them again itself.

Names are those of the program's ``LlamaModel`` state dict, the only
thing the harness knows of its layout.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.blake2b(f"{int(seed)}/{group}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def layer_shapes(cfg: dict) -> Dict[str, tuple]:
    """Linear weights of one block as [out, in], in buffer order."""
    d, hd = cfg["hidden_size"], cfg["hidden_size"] // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    f = cfg["intermediate_size"]
    return {"attn.wq": (q, d), "attn.wk": (kv, d), "attn.wv": (kv, d),
            "attn.wo": (d, q), "mlp.w1": (f, d), "mlp.w3": (f, d),
            "mlp.w2": (d, f)}


def _draw(shapes: Dict[str, tuple], seed: int, group: str,
          dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device).manual_seed(group_seed(seed, group))
    flat = torch.randn(total, dtype=dtype, device=device, generator=gen)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        w.mul_(1.0 / math.sqrt(shape[1]))
        out[name] = w
        at += n
    return out


def layer(cfg: dict, seed: int, i: int, dtype: torch.dtype, device
          ) -> Dict[str, torch.Tensor]:
    """Block ``i``'s weights, keyed by the state dict's names."""
    ws = _draw(layer_shapes(cfg), seed, f"layer{i}", dtype, device)
    out = {f"layers.{i}.{k}.weight": v for k, v in ws.items()}
    ones = torch.ones(cfg["hidden_size"], dtype=torch.float32, device=device)
    out[f"layers.{i}.attn_norm.scale"] = ones
    out[f"layers.{i}.mlp_norm.scale"] = ones.clone()
    return out


def embed(cfg: dict, seed: int, dtype: torch.dtype, device) -> torch.Tensor:
    # the table is [vocab, hidden]; its std is 1/sqrt(hidden), as the
    # view's fan-in
    shape = (cfg["vocab_size"], cfg["hidden_size"])
    return _draw({"embed": shape}, seed, "embed", dtype, device)["embed"]


def head(cfg: dict, seed: int, dtype: torch.dtype, device) -> torch.Tensor:
    shape = (cfg["vocab_size"], cfg["hidden_size"])
    return _draw({"lm_head": shape}, seed, "lm_head", dtype, device)["lm_head"]


def state_dict(cfg: dict, seed: int, dtype: torch.dtype, device
               ) -> Dict[str, torch.Tensor]:
    """Every weight of the model, as the program's state dict names it."""
    out = {"embed.weight": embed(cfg, seed, dtype, device)}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer(cfg, seed, i, dtype, device))
    out["final_norm.scale"] = torch.ones(cfg["hidden_size"],
                                         dtype=torch.float32, device=device)
    out["lm_head.weight"] = head(cfg, seed, dtype, device)
    return out


def param_count(cfg: dict) -> int:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    per_layer = sum(math.prod(s) for s in layer_shapes(cfg).values()) + 2 * d
    return 2 * v * d + cfg["num_hidden_layers"] * per_layer + d
