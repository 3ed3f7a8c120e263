"""Rank functions of tests/test_torch_distributed.py, run in spawned
processes over gloo.

This module imports torch, numpy and the port, and nothing of JAX, so a
spawned rank never loads it.  Each job rendezvouses through a
``file://`` store under the test's tmp directory (no ports to clash
between xdist workers), runs one torch thread, and hands its result back
as a file that the test process reads.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.multiprocessing as mp

AXES = ("dp", "fsdp", "sp", "tp")


def start(job: str, world: int, workdir: str, *args: Any):
    """Start ``job(*args)`` on ``world`` spawned ranks."""
    os.makedirs(workdir, exist_ok=True)
    return mp.start_processes(_entry, args=(world, workdir, job, args),
                              nprocs=world, join=False,
                              start_method="spawn")


def finish(ctx, world: int, workdir: str,
           timeout: float = 240.0) -> List[Any]:
    """Each rank's result.  A rank that raises or dies fails the call;
    so does a job that outlives ``timeout``."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, workdir: str, job: str, args) -> None:
    from ray_tpu_torch.parallel import init_distributed, shutdown_distributed

    torch.set_num_threads(1)
    init_distributed("file://" + os.path.join(workdir, "rendezvous"),
                     world, rank, device="cpu")
    try:
        result = globals()[job](*args)
    finally:
        shutdown_distributed()
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


def _index(mesh) -> Dict[str, int]:
    return {a: mesh.index(a) for a in AXES}


def _flat_to_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _tiny(dtype: str = "float32"):
    import dataclasses

    from ray_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(),
                               dtype=getattr(torch, dtype))


def load_flax(model, npz: str, cfg) -> None:
    """Load flax params (an .npz of "a/b/c" paths) into a possibly
    sharded model."""
    from ray_tpu_torch.models.convert import params_from_flax
    from ray_tpu_torch.train.gspmd import load_params

    with np.load(npz) as f:
        load_params(model, params_from_flax(_flat_to_tree(dict(f)), cfg))


# ------------------------------------------------------------------ jobs


def eight_rank_cases(inputs: str, params: str, lr: float,
                     train_cases: Dict[str, tuple]) -> Dict[str, Any]:
    """Every 8-rank case on one process group: ring forwards, ring
    gradients, sharded train steps, shard_params."""
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.parallel import (MeshSpec, make_mesh, shard_batch,
                                        shard_params)
    from ray_tpu_torch.train.gspmd import build_llama_train_state

    with np.load(inputs) as f:
        data = dict(f)
    out: Dict[str, Any] = {}
    for name, spec, causal in (("ring_dp2_sp4", MeshSpec(dp=2, sp=4), True),
                               ("ring_sp8", MeshSpec(sp=8), False)):
        mesh = make_mesh(spec)
        q, k, v = shard_batch(mesh, (data["q"], data["k"], data["v"]))
        out[name] = {"index": _index(mesh),
                     "out": ring_attention(q, k, v, mesh,
                                           causal=causal).numpy()}
    mesh = make_mesh(MeshSpec(dp=2, sp=4))
    q, k, v = (x.requires_grad_() for x in shard_batch(
        mesh, (data["gq"], data["gk"], data["gv"])))
    ring_attention(q, k, v, mesh).sum().backward()
    out["ring_grads"] = {"index": _index(mesh),
                         **{n: x.grad.numpy() for n, x in
                            (("dq", q), ("dk", k), ("dv", v))}}
    mesh = make_mesh(MeshSpec(dp=2, fsdp=2, tp=2))
    placed = shard_params(mesh, {"w": np.arange(32.0).reshape(8, 4),
                                 "b": np.arange(6.0)}, {"w": {"tp": 1}})
    out["shard_params"] = {"index": _index(mesh),
                           **{n: x.to_local().numpy()
                              for n, x in placed.items()}}
    try:
        make_mesh(MeshSpec(pp=2, dp=-1))
    except NotImplementedError as e:
        out["pp_error"] = str(e)
    for name, (spec, _shape, dtype, steps) in train_cases.items():
        cfg = _tiny(dtype)
        mesh = make_mesh(MeshSpec(**spec))
        p, o, step, _ = build_llama_train_state(cfg, mesh, learning_rate=lr)
        load_flax(p, params, cfg)
        losses = []
        for _ in range(steps):
            p, o, loss = step(p, o, data[name])
            losses.append(float(loss))
        out[name] = {"index": _index(mesh), "losses": losses,
                     "wq_local": tuple(
                         p.layers[0].attn.wq.weight.to_local().shape)}
    return out


def one_rank_against_one_device(tokens: np.ndarray, lr: float,
                                steps: int) -> Dict[str, Any]:
    """The sharded step at world 1 (FSDP2 hooks over one rank) against
    the one-device step, from the same seed."""
    from ray_tpu_torch.parallel import make_mesh
    from ray_tpu_torch.train.gspmd import build_llama_train_state

    cfg = _tiny()
    out = {}
    for name, mesh in (("process", make_mesh()),
                       ("device", make_mesh(devices=["cpu"]))):
        p, o, step, _ = build_llama_train_state(cfg, mesh, learning_rate=lr)
        losses = []
        for _ in range(steps):
            p, o, loss = step(p, o, tokens)
            losses.append(float(loss))
        out[name] = {"losses": losses, "mesh": mesh.device_mesh is not None}
    return out


def checkpoint_resume(path: str, tokens: np.ndarray,
                      lr: float) -> Dict[str, Any]:
    """At MeshSpec(fsdp=2): steps 1-3 straight; then save after step 1,
    restore into a fresh model and optimizer (another seed) and take
    steps 2-3 again."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (get_state_dict,
                                                         set_state_dict)

    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train import restore_checkpoint, save_checkpoint
    from ray_tpu_torch.train.gspmd import build_llama_train_state

    cfg = _tiny()
    mesh = make_mesh(MeshSpec(fsdp=2))
    p, o, step, _ = build_llama_train_state(cfg, mesh, learning_rate=lr)
    straight = [float(step(p, o, tokens)[2])]
    model_sd, opt_sd = get_state_dict(p, o)
    save_checkpoint(path, {"model": model_sd, "opt": opt_sd, "step": 1})
    straight += [float(step(p, o, tokens)[2]) for _ in range(2)]

    p2, o2, step2, _ = build_llama_train_state(cfg, mesh, rng_seed=5,
                                               learning_rate=lr)
    model_sd, opt_sd = get_state_dict(p2, o2)
    state = restore_checkpoint(path, target={"model": model_sd,
                                             "opt": opt_sd, "step": 0})
    set_state_dict(p2, o2, model_state_dict=state["model"],
                   optim_state_dict=state["opt"])
    resumed = straight[:1] + [float(step2(p2, o2, tokens)[2])
                              for _ in range(2)]
    same = all(torch.equal(a.to_local(), b.to_local())
               for a, b in zip(p.parameters(), p2.parameters()))
    moments = all(
        torch.equal(o.state[a][key].to_local(), o2.state[b][key].to_local())
        for a, b in zip(p.parameters(), p2.parameters())
        for key in ("exp_avg", "exp_avg_sq"))
    local_bytes = sum(x.to_local().numel() * x.element_size()
                      for x in p.parameters())
    dist.barrier()
    files = {f: os.path.getsize(os.path.join(path, f))
             for f in sorted(os.listdir(path))}
    return {"straight": straight, "resumed": resumed, "step": state["step"],
            "params_equal": same, "moments_equal": moments,
            "local_param_bytes": local_bytes, "files": files}


def pipeline_stage_cases(inputs: str, params: str,
                         spec: Dict[str, int]) -> Dict[str, Any]:
    """Both stages of a 2-way split of tiny (fp32) on a stage mesh of
    ``spec`` over this group, from the flax init: the first stage's
    forward and backward (output, parameter grads), the last stage's
    loss and backward (loss, gx, parameter grads).  Every value is
    gathered whole; so is every grad (``full_tensor``)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train.gspmd import build_llama_stage_state
    from ray_tpu_torch.train.pipeline import partition_layers

    cfg = _tiny()
    mesh = make_mesh(MeshSpec(**spec))
    with np.load(inputs) as f:
        data = dict(f)
    tokens = data["tokens"]
    ranges = partition_layers(cfg, 2)
    out: Dict[str, Any] = {"index": _index(mesh)}
    for s, layers in enumerate(ranges):
        st = build_llama_stage_state(
            cfg, mesh, layers, first=s == 0, last=s == 1,
            microbatch_size=tokens.shape[0], seq_len=tokens.shape[1],
            num_microbatches=1)
        p = st["params"]
        load_flax(p, params, cfg)
        res: Dict[str, Any] = {}
        if s == 0:
            x = st["shard_value"](tokens)
            res["y"] = st["gather_value"](st["fwd"](p, x)).numpy()
            gx = st["bwd"](p, x, st["shard_value"](data["gy"]))
            res["gx_is_none"] = gx is None
        else:
            loss, gx = st["loss_bwd"](p, st["shard_value"](data["x"]),
                                      st["whole_value"](tokens))
            res["loss"] = float(loss)
            res["gx"] = st["gather_value"](gx).numpy()
        st["reduce_grads"](p)
        res["grads"] = {
            name: (q.grad.full_tensor() if isinstance(q.grad, DTensor)
                   else q.grad).numpy()
            for name, q in p.named_parameters()}
        out[f"stage{s}"] = res
    return out
