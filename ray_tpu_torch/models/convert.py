"""Carry weights of ray_tpu's flax Llama across to the port's modules.

The flax tree (as numpy) has, per the flax module names:

  embed/embedding                 [V, dim]
  layer_i/attn/{wq,wk,wv}/kernel  [dim, H|Hkv, D]   (DenseGeneral)
  layer_i/attn/wo/kernel          [H, D, dim]       (DenseGeneral over
                                                     axes (-2, -1))
  layer_i/mlp/{w1,w3}/kernel      [dim, hidden]
  layer_i/mlp/w2/kernel           [hidden, dim]
  layer_i/{attn_norm,mlp_norm}/scale, final_norm/scale   [dim]
  lm_head/kernel                  [dim, V]

Flax kernels are [in, out] and ``nn.Linear.weight`` is [out, in], so
every kernel is flattened to two dims and transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(kernel: Any, n_in: int) -> torch.Tensor:
    """A flax [in..., out...] kernel as an nn.Linear [out, in] weight."""
    k = np.asarray(kernel, dtype=np.float32)
    return _t(k.reshape(n_in, -1).T)


def params_from_flax(tree: Mapping[str, Any],
                     cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """State dict of :class:`LlamaModel` (fp32 CPU tensors; loading casts
    them to the model's weight dtype: ``cfg.dtype``, or fp32 for a model
    built with ``param_dtype=torch.float32``)."""
    hd = cfg.head_dim
    sd = {"embed.weight": _t(tree["embed"]["embedding"]),
          "final_norm.scale": _t(tree["final_norm"]["scale"]),
          "lm_head.weight": _linear(tree["lm_head"]["kernel"], cfg.dim)}
    for i in range(cfg.n_layers):
        layer = tree[f"layer_{i}"]
        attn, mlp = layer["attn"], layer["mlp"]
        pre = f"layers.{i}."
        sd[pre + "attn_norm.scale"] = _t(layer["attn_norm"]["scale"])
        sd[pre + "mlp_norm.scale"] = _t(layer["mlp_norm"]["scale"])
        for name in ("wq", "wk", "wv"):
            sd[pre + f"attn.{name}.weight"] = _linear(
                attn[name]["kernel"], cfg.dim)
        sd[pre + "attn.wo.weight"] = _linear(attn["wo"]["kernel"],
                                             cfg.n_heads * hd)
        for name in ("w1", "w3"):
            sd[pre + f"mlp.{name}.weight"] = _linear(mlp[name]["kernel"],
                                                     cfg.dim)
        sd[pre + "mlp.w2.weight"] = _linear(mlp["w2"]["kernel"],
                                            cfg.hidden_dim)
    return sd
