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
    replicated over dp and sp (where torch cannot slice that mesh, over
    fsdp alone, the replicas' grads added by an all-reduce over dp and
    sp before the optimizer step);
  - sp: ring attention over the sp group, each process's tokens at
    their global positions;
  - the batch: dim 0 over (dp, fsdp), dim 1 over sp (``shard_batch``).

Each process's loss is the sum over its own targets divided by the
global target count, so the gradient is the plain sum over processes:
FSDP2's reduction adds (divide factor 1) instead of averaging, as the
all-reduce does.  The step
reports the global mean, as the JAX step does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.models.llama import (LlamaModel, LlamaStage,
                                        causal_lm_loss, llama_param_rules,
                                        lm_loss_sum, shifted_targets)
from ray_tpu_torch.parallel.mesh import (Mesh, _as_tensor, gather_batch,
                                         shard_batch)

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
    _check_one_device(mesh)
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


def build_llama_stage_state(cfg, mesh: Mesh, layer_range: Tuple[int, int],
                            *, first: bool, last: bool, microbatch_size: int,
                            seq_len: int, num_microbatches: int,
                            rng_seed: int = 0, learning_rate: float = 3e-4,
                            attention_kernel: Optional[Callable] = None,
                            param_dtype: Optional[torch.dtype] = torch.float32
                            ) -> Dict[str, Any]:
    """One MPMD pipeline stage on its in-stage mesh: the
    :class:`LlamaStage` of ``layer_range`` (weights from ``rng_seed``:
    the stage's slice of the whole model's init), its AdamW, and the
    functions the 1F1B loop replays.  On a mesh over a process group
    (the stage's own) the stage is laid out as ``build_llama_train_state``
    lays out the whole model (tp plan, FSDP2, ring attention at sp > 1)
    and every function works on the process's shard of a microbatch.
    Returns a dict:

      params, opt_state          the stage module and its AdamW
      fwd(p, x) -> y             stage forward, no autograd graph kept
                                 (None on the last stage, whose forward
                                 is part of its loss_bwd)
      bwd(p, x, gy) -> gx        re-runs the stage forward under autograd
                                 and back-propagates ``gy``, the JAX
                                 package's recompute inside the vjp, so a
                                 stage keeps only its in-flight INPUTS;
                                 parameter grads add into ``.grad``; gx
                                 is None on the first stage
      loss_bwd(p, x, tokens) -> (loss, gx)   last stage only: the loss
                                 of the microbatch (``tokens`` whole, on
                                 the device: the targets of a sequence
                                 shard reach into the next), its grads
                                 into ``.grad``, gx (None when also
                                 first); over a group the loss is the
                                 stage's, the same on every process
      opt_step(p, o)             AdamW on the grads summed over the
                                 step's microbatches, scaled by 1/m
                                 (after reduce_grads)
      zero_grads(p)              clears the grads before a step
      reduce_grads(p)            adds the grads over the dp·sp
                                 processes that hold the same parameters
                                 where FSDP2 did not (``replica_mesh``)
      shard_value(x) -> x        the process's slice of a microbatch
                                 on its device
      whole_value(x) -> x        a whole microbatch on the device
      gather_value(x) -> x       the whole of a sliced value (y, gx),
                                 on every process of the group

    ``.grad`` is the accumulator the JAX package threads through
    ``accum``, so there is none; FSDP2 reduce-scatters each
    microbatch's grads and adds them into the sharded ``.grad``.
    ``microbatch_size`` and ``seq_len`` shape the JAX package's init
    sample; the port's init needs none."""
    del microbatch_size, seq_len
    sharded = mesh.device_mesh is not None
    _check_one_device(mesh)
    if sharded:
        attention_kernel = _sharded_kernel(cfg, mesh, attention_kernel)
    start, end = layer_range
    model = LlamaStage(cfg, start, end, first=first, last=last,
                       kernel=attention_kernel, device=mesh.device,
                       seed=rng_seed, param_dtype=param_dtype)
    sum_grads = (_shard_model(model, model.layers.values(), mesh)
                 if sharded else lambda: None)
    opt = _adamw(model, learning_rate)
    scale = 1.0 / float(num_microbatches)
    report = 1.0 if mesh.index("tp") == 0 else 0.0

    def needs_grad(x: torch.Tensor) -> torch.Tensor:
        return x.detach().requires_grad_(not first)

    def run(p: LlamaStage, x: torch.Tensor) -> torch.Tensor:
        return p(x, start_pos=mesh.index("sp") * x.shape[1])

    def fwd(p: LlamaStage, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return run(p, x)

    def bwd(p: LlamaStage, x: torch.Tensor, gy: torch.Tensor):
        x = needs_grad(x)
        torch.autograd.backward(run(p, x), gy)
        return x.grad

    def loss_bwd(p: LlamaStage, x: torch.Tensor, tokens: torch.Tensor):
        x = needs_grad(x)
        if not sharded:
            loss = causal_lm_loss(p(x), tokens)
            loss.backward()
            return loss.detach(), x.grad
        # the sum over this process's targets over the microbatch's
        # target count: the stage's loss is the sum over its processes
        # (tp peers hold the same targets: only the first reports)
        n_targets = tokens.shape[0] * (tokens.shape[1] - 1)
        targets = shard_batch(mesh, shifted_targets(tokens))
        loss = lm_loss_sum(run(p, x), targets) / n_targets
        loss.backward()
        total = loss.detach() * report
        dist.all_reduce(total)
        return total, x.grad

    def zero_grads(p: LlamaStage) -> None:
        opt.zero_grad(set_to_none=True)

    def reduce_grads(p: LlamaStage) -> None:
        sum_grads()

    def opt_step(p: LlamaStage, o: torch.optim.Optimizer) -> None:
        reduce_grads(p)
        with torch.no_grad():
            for q in p.parameters():
                if q.grad is not None:
                    q.grad.mul_(scale)
        o.step()

    return {
        "params": model, "opt_state": opt,
        "fwd": None if last else fwd,
        "bwd": None if last else bwd,
        "loss_bwd": loss_bwd if last else None,
        "opt_step": opt_step, "zero_grads": zero_grads,
        "reduce_grads": reduce_grads,
        "shard_value": lambda x: shard_batch(mesh, x),
        "whole_value": lambda x: _as_tensor(x, mesh.device),
        "gather_value": lambda x: gather_batch(mesh, x),
        "model": model, "mesh": mesh,
    }


def _adamw(model: nn.Module, learning_rate: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=learning_rate,
                             betas=ADAMW_BETAS, eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def _check_one_device(mesh: Mesh) -> None:
    if mesh.device_mesh is None and math.prod(mesh.shape.values()) > 1:
        raise NotImplementedError(
            f"mesh {mesh.shape} spans several devices: build it with "
            f"make_mesh after init_distributed (sp > 1 runs ring "
            f"attention over its process group)")


def _sharded_kernel(cfg, mesh: Mesh, attention_kernel: Optional[Callable]
                    ) -> Optional[Callable]:
    """Checks the tp split; ring attention over the sp group unless the
    caller gave a kernel."""
    tp, sp = mesh.shape["tp"], mesh.shape["sp"]
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide n_kv_heads={cfg.n_kv_heads}: each "
            f"process must hold whole KV heads")
    if attention_kernel is None and sp > 1:
        from ray_tpu_torch.ops.ring_attention import make_ring_attention

        attention_kernel = make_ring_attention(mesh)
    return attention_kernel


def _shard_model(model: nn.Module, blocks, mesh: Mesh
                 ) -> Callable[[], None]:
    """Lay ``model`` out on the mesh in place: the tp plan for the
    modules it has, then FSDP2 on each of ``blocks`` and on the root,
    summing grads.  Returns what must run between the backward and the
    optimizer step: where FSDP2 shards over fsdp alone
    (``mesh.replica_mesh``), it adds the grads over the dp·sp processes
    that hold the same parameters; else nothing."""
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor.parallel import parallelize_module

    if mesh.shape["tp"] > 1:
        parallelize_module(model, mesh.device_mesh["tp"],
                           llama_param_rules(model))
    for block in blocks:
        fully_shard(block, mesh=mesh.fsdp_mesh)
    fully_shard(model, mesh=mesh.fsdp_mesh)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            # a plain sum: no division, and SUM on the wire (gloo has
            # neither AVG nor PREMUL_SUM)
            m.set_gradient_divide_factor(1.0)
            m.set_force_sum_reduction_for_comms(True)
    if mesh.replica_mesh is None:
        return lambda: None
    group = mesh.replica_mesh.get_group()

    def sum_grads() -> None:
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad.to_local(), group=group)
    return sum_grads


def _build_sharded(cfg, mesh: Mesh, rng_seed: int, learning_rate: float,
                   attention_kernel: Optional[Callable],
                   param_dtype: Optional[torch.dtype]):
    attention_kernel = _sharded_kernel(cfg, mesh, attention_kernel)
    model = LlamaModel(cfg, kernel=attention_kernel, device=mesh.device,
                       seed=rng_seed, param_dtype=param_dtype)
    sum_grads = _shard_model(model, model.layers, mesh)
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
        sum_grads()
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
