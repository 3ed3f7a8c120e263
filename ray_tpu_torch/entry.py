"""The port's entry points, the counterparts of the JAX package's harness
(``__graft_entry__.py``).

``entry()``               the flagship Llama model's no-cache forward at
                          ``LlamaConfig.small()`` over [8, 512] tokens,
                          which routes attention through the flash
                          kernel (S = 512 is causal, at least
                          ``FLASH_PREFILL_MIN_SEQ`` and a multiple of 128).
``dryrun_multichip(n)``   trains ``LlamaConfig.tiny()`` over the full
                          {dp, fsdp, sp, tp} process mesh of
                          :func:`dryrun_layout` ``(n)``, one rank a card
                          over nccl (or n gloo ranks with
                          ``device="cpu"``): forward, backward and AdamW,
                          two steps; at n >= 8 also six steps of the
                          {pp:2, fsdp:2, tp:n/4} pipeline.

    python -m ray_tpu_torch.entry [n] [--cpu]

runs the ``entry()`` forward, then ``dryrun_multichip(n)`` (n defaults
to the visible card count, or 8 with ``--cpu``).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import (DeviceLike, card_info,
                                           resolve_device)
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
from ray_tpu_torch.parallel.mesh import MeshSpec

DRYRUN_SEQ_PER_SP = 64      # each sp rank's share of the sequence
DRYRUN_TOKEN_SEED = 1
DRYRUN_TIMEOUT_S = 600.0
PIPE_MICROBATCH, PIPE_MICROBATCHES, PIPE_SEQ = 2, 4, 64
PIPE_STEPS = 6


def entry(device: DeviceLike = None
          ) -> Tuple[Callable[..., torch.Tensor], Tuple[Any, ...]]:
    """-> (forward, (model, tokens)): ``forward(model, tokens)`` returns
    the logits [8, 512, vocab], with weights from seed 0.  Runs on
    ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cfg = LlamaConfig.small()
    model = LlamaModel(cfg, device=dev, seed=0).eval()
    tokens = torch.zeros((8, 512), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def forward(model: LlamaModel, tokens: torch.Tensor) -> torch.Tensor:
        return model(tokens)

    return forward, (model, tokens)


def dryrun_layout(n: int) -> MeshSpec:
    """The dry run's mesh over ``n`` devices, the JAX harness's rule: tp
    innermost (2 when n is even), sp next (2 when 4 divides n), fsdp
    next (2 when 8 divides n), dp fills the rest."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    fsdp = 2 if n % 8 == 0 else 1
    return MeshSpec(dp=-1, fsdp=fsdp, sp=sp, tp=tp).resolve(n)


def dryrun_tokens(cfg, batch: int, seq: int) -> np.ndarray:
    """The dry run's batch: int32 tokens [batch, seq] from
    ``default_rng(DRYRUN_TOKEN_SEED)``."""
    return np.random.default_rng(DRYRUN_TOKEN_SEED).integers(
        0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)


def dryrun_body(n: int, cfg=None,
                initial_params: Optional[Dict[str, torch.Tensor]] = None,
                tokens: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """One rank's part of the dry run, in a process group of ``n`` ranks
    (``init_distributed`` first): ``cfg`` (default
    ``LlamaConfig.tiny()``) on ``make_mesh(dryrun_layout(n))``, batch
    dp·fsdp rows of 64·sp tokens, two train steps on the same tokens.
    ``initial_params`` (a whole state dict, ``params_from_flax``'s say)
    replaces the seed-0 init; ``tokens`` replaces
    :func:`dryrun_tokens`.  Checks the JAX harness's asserts (a finite
    loss > 0; the second below 1.5 times the first) and returns the
    mesh, both losses, the harness's line and this rank's device."""
    from ray_tpu_torch.parallel import make_mesh
    from ray_tpu_torch.train.gspmd import build_llama_train_state, load_params

    cfg = cfg or LlamaConfig.tiny()
    mesh = make_mesh(dryrun_layout(n))
    batch = mesh.shape["dp"] * mesh.shape["fsdp"]
    seq = DRYRUN_SEQ_PER_SP * mesh.shape["sp"]
    params, opt, step_fn, _ = build_llama_train_state(
        cfg, mesh, batch_size=batch, seq_len=seq)
    if initial_params is not None:
        load_params(params, initial_params)
    if tokens is None:
        tokens = dryrun_tokens(cfg, batch, seq)
    params, opt, loss = step_fn(params, opt, tokens)
    loss = float(loss)
    if not (loss == loss and loss > 0):
        raise AssertionError(f"bad loss {loss}")
    # one more step to prove state threading works
    _, _, loss2 = step_fn(params, opt, tokens)
    loss2 = float(loss2)
    if not loss2 < loss * 1.5:
        raise AssertionError(f"second loss {loss2} >= 1.5 x {loss}")
    shape = dict(mesh.shape)
    return {"mesh": shape, "losses": [loss, loss2],
            "line": f"dryrun_multichip ok: mesh={shape} loss {loss:.4f} "
                    f"-> {loss2:.4f}",
            "device": str(mesh.device), "card": card_info(mesh.device)}


def _dryrun_rank(rank: int, n: int, init_method: str, device: str,
                 out_dir: str) -> None:
    """A spawned rank: joins the group (``cuda:rank`` over nccl, or the
    CPU over gloo), runs :func:`dryrun_body`, rank 0 prints its line;
    each rank leaves its result in ``out_dir``."""
    from ray_tpu_torch.parallel import init_distributed, shutdown_distributed
    from ray_tpu_torch.train.pipeline import kernel_launches

    if device == "cpu":
        torch.set_num_threads(1)     # n ranks share the host's cores
    init_distributed(init_method, n, rank,
                     device="cpu" if device == "cpu" else f"cuda:{rank}")
    try:
        result = dryrun_body(n)
    finally:
        shutdown_distributed()
    if rank == 0:
        print(result["line"], flush=True)
    result["kernel_launches"] = kernel_launches()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def _check_devices(n: int, device: DeviceLike) -> str:
    """"cuda" or "cpu" for a dry run over ``n`` ranks; raises before any
    process starts when the cards cannot give each rank its own."""
    if n < 1:
        raise ValueError(f"dryrun_multichip needs n >= 1 ranks, not {n}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda" or dev.index is not None:
        raise ValueError(f"dryrun_multichip runs on cuda (a card a rank) "
                         f"or on the CPU, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"dryrun_multichip({n}) runs one rank a card and no CUDA "
            f"device is available; pass device=\"cpu\" to run {n} gloo "
            f"ranks on the CPU")
    cards = torch.cuda.device_count()
    if cards < n:
        raise RuntimeError(
            f"dryrun_multichip({n}) runs one rank a card over nccl and "
            f"sees {cards} card(s); no two ranks share a card, so n can "
            f"be at most {cards} here (device=\"cpu\" runs gloo ranks)")
    return "cuda"


def _run_ranks(n: int, device: str) -> List[Dict[str, Any]]:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(_dryrun_rank,
                                 args=(n, init_method, device, tmp),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip ranks still "
                                       f"running after {DRYRUN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:       # no rank outlives a failure
                if proc.is_alive():
                    proc.kill()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


def _dryrun_pipeline(n: int, device: str) -> Dict[str, Any]:
    """The MPMD pipeline leg: ``tiny`` over {pp:2, fsdp:2, tp:n/4}, two
    stages of n/2 ranks each, six steps on a fixed batch; the loss must
    fall.  Prints the JAX harness's line, less its TPU figures."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train.pipeline import TrainPipeline

    cfg = LlamaConfig.tiny()
    mb, m, seq = PIPE_MICROBATCH, PIPE_MICROBATCHES, PIPE_SEQ
    per_stage = n // 2
    threads = os.environ.get("OMP_NUM_THREADS")
    if device == "cpu":
        # the stage processes inherit it: one torch thread each
        os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    try:
        pipe = TrainPipeline(
            cfg, pp=2, microbatch_size=mb, num_microbatches=m, seq_len=seq,
            stage_mesh={"fsdp": 2, "tp": per_stage // 2},
            devices_per_stage=per_stage, rng_seed=0,
            device="cpu" if device == "cpu" else None)
        try:
            tokens = np.random.default_rng(DRYRUN_TOKEN_SEED).integers(
                0, cfg.vocab_size, size=(mb * m, seq), dtype=np.int32)
            losses, bubbles, rates = [], [], []
            for _ in range(PIPE_STEPS):
                out = pipe.step(tokens)
                losses.append(out["loss"])
                bubbles.append(out["bubble_pct"])
                rates.append(out["tokens_per_s"])
            if not losses[-1] < losses[0]:
                raise AssertionError(f"loss not decreasing: {losses}")
            shape = {"pp": 2, "dp": 1, "fsdp": 2, "sp": 1,
                     "tp": per_stage // 2}
            line = (f"dryrun_multichip pp ok: mesh={shape} "
                    f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                    f"bubble {min(bubbles):.1f}% "
                    f"train_tokens_per_s {max(rates):.0f}")
            print(line, flush=True)
        finally:
            pipe.teardown()
    finally:
        rt.shutdown()
    return {"mesh": shape, "losses": losses, "bubble_pct": bubbles,
            "tokens_per_s": rates, "line": line}


def dryrun_multichip(n: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Train ``LlamaConfig.tiny()`` one full step and one more over the
    mesh :func:`dryrun_layout` ``(n)``, on ``n`` spawned ranks: one
    whole card each over nccl (``device=None``: ``cuda:rank``), or gloo
    ranks on the CPU with ``device="cpu"``.  Raises at once when no card
    is visible or fewer than ``n`` are (never falls back to the CPU).
    Rank 0 prints ``dryrun_multichip ok: mesh={...} loss a -> b``.  At
    n >= 8 it then trains the {pp:2, fsdp:2, tp:n/4} pipeline on a
    cluster of the port's runtime (``ray_tpu_torch.init``).  Returns
    {"mesh", "losses", "line", "ranks": each rank's device, card and
    kernel launches, "wall_s": the ranks' wall from spawn to exit,
    "pipeline": the pipeline's results or None}."""
    device = _check_devices(n, device)
    t0 = time.perf_counter()
    ranks = _run_ranks(n, device)
    wall = time.perf_counter() - t0
    first = ranks[0]
    if any(r["losses"] != first["losses"] for r in ranks):
        raise AssertionError(f"ranks disagree on the loss: "
                             f"{[r['losses'] for r in ranks]}")
    return {"mesh": first["mesh"], "losses": first["losses"],
            "line": first["line"],
            "ranks": [{"rank": i, "device": r["device"], "card": r["card"],
                       "kernel_launches": r["kernel_launches"]}
                      for i, r in enumerate(ranks)],
            "wall_s": wall,
            "pipeline": _dryrun_pipeline(n, device) if n >= 8 else None}


def _parse_args(argv: List[str]) -> Tuple[int, Optional[str]]:
    """``[n] [--cpu]`` -> (n, device): n defaults to the visible card
    count, or 8 on the CPU."""
    device = "cpu" if "--cpu" in argv else None
    rest = [a for a in argv if a != "--cpu"]
    if len(rest) > 1:
        raise SystemExit("usage: python -m ray_tpu_torch.entry [n] [--cpu]")
    if rest:
        return int(rest[0]), device
    return (8 if device == "cpu" else torch.cuda.device_count()), device


def main(argv: List[str]) -> int:
    n, device = _parse_args(argv)
    fn, args = entry(device)
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    del fn, args, out
    dryrun_multichip(n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
