"""The training step of the flagship model on a mesh.

The port of ray_tpu/train/gspmd.py on a one-device mesh (the CUDA card,
or the CPU by name).  The JAX package jits a step over pure
(params, opt_state) trees; here ``params`` is the :class:`LlamaModel`
itself (fp32 master weights, ``cfg.dtype`` compute, as flax keeps fp32
params) and ``opt_state`` a ``torch.optim.AdamW`` with optax's
``adamw`` defaults.  ``step_fn(params, opt_state, tokens)`` keeps the
JAX call idiom and updates both in place.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from ray_tpu_torch.models.llama import LlamaModel, causal_lm_loss
from ray_tpu_torch.parallel.mesh import Mesh, shard_batch

# optax.adamw(learning_rate) with its defaults.  optax steps
# p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) on every parameter;
# torch's decoupled AdamW multiplies p by (1 - lr * wd) and then takes
# the same Adam step, which is the same update.  torch's own default
# weight_decay (1e-2) is not optax's (1e-4).
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def build_llama_train_state(cfg, mesh: Mesh, rng_seed: int = 0,
                            learning_rate: float = 3e-4,
                            batch_size: int = 8, seq_len: int = 128,
                            attention_kernel: Optional[Callable] = None,
                            param_dtype: Optional[torch.dtype] = torch.float32
                            ) -> Tuple[LlamaModel, torch.optim.AdamW,
                                       Callable, LlamaModel]:
    """Init (params, opt_state) on the mesh's device and a train step.

    Returns (params, opt_state, step_fn, model), where ``params`` and
    ``model`` are the same :class:`LlamaModel` (weights from
    ``rng_seed``, held in ``param_dtype``) and
    ``step_fn(params, opt_state, tokens) -> (params, opt_state, loss)``
    runs forward, backward and one AdamW step in place; ``loss`` is the
    pre-update loss as a 0-d tensor, left on the device (no host sync).
    ``batch_size`` and ``seq_len`` shape the JAX package's init sample;
    the port's init needs none.  Runs on ``cuda`` unless the mesh holds
    a CPU device."""
    del batch_size, seq_len
    if mesh.shape.get("sp", 1) > 1:
        raise NotImplementedError(
            "sequence-parallel meshes need ring attention over "
            "torch.distributed, which the port does not have yet")
    model = LlamaModel(cfg, kernel=attention_kernel, device=mesh.device,
                       seed=rng_seed, param_dtype=param_dtype)
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                            betas=ADAMW_BETAS, eps=ADAMW_EPS,
                            weight_decay=ADAMW_WEIGHT_DECAY)

    def step_fn(p: LlamaModel, o: torch.optim.Optimizer, tokens: Any):
        tokens = shard_batch(mesh, tokens)
        o.zero_grad(set_to_none=True)
        loss = causal_lm_loss(p(tokens), tokens)
        loss.backward()
        o.step()
        return p, o, loss.detach()

    return model, opt, step_fn, model


def param_count(params: nn.Module) -> int:
    """Elements in the model's parameters."""
    return sum(p.numel() for p in params.parameters())
