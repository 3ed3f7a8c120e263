"""The training step of the flagship model on a mesh.

The port of ray_tpu/train/gspmd.py.  The JAX package jits a step over
pure (params, opt_state) trees; here ``params`` is the
:class:`LlamaModel` itself (fp32 master weights, ``cfg.dtype`` compute,
as flax keeps fp32 params) and ``opt_state`` a ``torch.optim.AdamW``
with optax's ``adamw`` defaults.  ``step_fn(params, opt_state, tokens)``
keeps the JAX call idiom and updates both in place.

On a one-device mesh the model is an ordinary module.  On a mesh over a
process group it is laid out as the JAX package lays it out, and every
process calls ``step_fn`` with the same global batch:

  - tp: the plan of ``llama_param_rules`` over the mesh's tp group;
  - fsdp: FSDP2 ``fully_shard`` on every block and on the root over the
    2-D (dp_sp, fsdp) sub-mesh, so parameters are sharded over fsdp and
    replicated over dp and sp;
  - sp: ring attention over the sp group, each process's tokens at
    their global positions;
  - the batch: dim 0 over (dp, fsdp), dim 1 over sp (``shard_batch``).

Each process's loss is the sum over its own targets divided by the
global target count, so the gradient is the plain sum over processes:
FSDP2's reduction adds (divide factor 1) instead of averaging.  The step
reports the global mean, as the JAX step does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.models.llama import (LlamaModel, causal_lm_loss,
                                        llama_param_rules, lm_loss_sum,
                                        shifted_targets)
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
    """Init (params, opt_state) on the mesh and a train step.

    Returns (params, opt_state, step_fn, model), where ``params`` and
    ``model`` are the same :class:`LlamaModel` (weights from
    ``rng_seed``, held in ``param_dtype``; over a process group every
    process draws the whole model and keeps its shards) and
    ``step_fn(params, opt_state, tokens) -> (params, opt_state, loss)``
    runs forward, backward and one AdamW step in place; ``tokens`` is
    the global batch, ``loss`` the pre-update loss as a 0-d tensor, left
    on the device (no host sync).  ``batch_size`` and ``seq_len`` shape
    the JAX package's init sample; the port's init needs none.  Runs on
    ``cuda`` unless the mesh holds a CPU device."""
    del batch_size, seq_len
    if mesh.device_mesh is not None:
        return _build_sharded(cfg, mesh, rng_seed, learning_rate,
                              attention_kernel, param_dtype)
    if math.prod(mesh.shape.values()) > 1:
        raise NotImplementedError(
            f"mesh {mesh.shape} spans several devices: build it with "
            f"make_mesh after init_distributed (sp > 1 runs ring "
            f"attention over its process group)")
    model = LlamaModel(cfg, kernel=attention_kernel, device=mesh.device,
                       seed=rng_seed, param_dtype=param_dtype)
    opt = _adamw(model, learning_rate)

    def step_fn(p: LlamaModel, o: torch.optim.Optimizer, tokens: Any):
        tokens = shard_batch(mesh, tokens)
        o.zero_grad(set_to_none=True)
        loss = causal_lm_loss(p(tokens), tokens)
        loss.backward()
        o.step()
        return p, o, loss.detach()

    return model, opt, step_fn, model


def _adamw(model: nn.Module, learning_rate: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=learning_rate,
                             betas=ADAMW_BETAS, eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def _build_sharded(cfg, mesh: Mesh, rng_seed: int, learning_rate: float,
                   attention_kernel: Optional[Callable],
                   param_dtype: Optional[torch.dtype]):
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor.parallel import parallelize_module

    tp, sp = mesh.shape["tp"], mesh.shape["sp"]
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide n_kv_heads={cfg.n_kv_heads}: each "
            f"process must hold whole KV heads")
    if attention_kernel is None and sp > 1:
        from ray_tpu_torch.ops.ring_attention import make_ring_attention

        attention_kernel = make_ring_attention(mesh)
    model = LlamaModel(cfg, kernel=attention_kernel, device=mesh.device,
                       seed=rng_seed, param_dtype=param_dtype)
    if tp > 1:
        parallelize_module(model, mesh.device_mesh["tp"], llama_param_rules())
    for layer in model.layers:
        fully_shard(layer, mesh=mesh.fsdp_mesh)
    fully_shard(model, mesh=mesh.fsdp_mesh)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            # a plain sum: no division, and SUM on the wire (gloo has
            # neither AVG nor PREMUL_SUM)
            m.set_gradient_divide_factor(1.0)
            m.set_force_sum_reduction_for_comms(True)
    opt = _adamw(model, learning_rate)
    # tp peers compute the same loss: only the first of them reports it
    report = 1.0 if mesh.index("tp") == 0 else 0.0

    def step_fn(p: LlamaModel, o: torch.optim.Optimizer, tokens: Any):
        n_targets = tokens.shape[0] * (tokens.shape[1] - 1)
        local, targets = shard_batch(mesh, (tokens, shifted_targets(tokens)))
        o.zero_grad(set_to_none=True)
        logits = p(local, start_pos=mesh.index("sp") * local.shape[1])
        loss = lm_loss_sum(logits, targets) / n_targets
        loss.backward()
        o.step()
        total = loss.detach() * report
        dist.all_reduce(total)
        return p, o, total

    return model, opt, step_fn, model


@torch.no_grad()
def load_params(params: nn.Module, state_dict: Dict[str, torch.Tensor]
                ) -> None:
    """Load whole tensors (``params_from_flax``'s, say) into the model in
    place, so the optimizer keeps its references; over a process group
    each parameter keeps its own shard of rank 0's tensor."""
    for name, p in params.named_parameters():
        full = state_dict[name].to(p.device, p.dtype)
        if isinstance(p, DTensor):
            full = distribute_tensor(full, p.device_mesh, p.placements)
            p.to_local().copy_(full.to_local())
        else:
            p.copy_(full)


def param_count(params: nn.Module) -> int:
    """Elements in the model's parameters."""
    return sum(p.numel() for p in params.parameters())
