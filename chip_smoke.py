"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Builds both CUDA kernel libraries from ``ray_tpu_torch/csrc`` (in
parallel, at first use), holds each kernel against its plain PyTorch
version at the shapes the main path gives it (flash in bf16 on the
tensor cores, with the stated allowance for P rounded to bf16, and in
fp32 on the CUDA cores; paged decode at the engine's decode shape and at
long contexts, where the split across blocks matters), runs the Llama
forward at ``llama3_8b`` width
(all 32 layers, bf16, random weights from a seed) through the flash
kernel, serves a few requests through the continuous-batching engine at
that width through the paged-decode kernel, and checks greedy fp32
decoding token for token against the no-cache forward and the dense
decode path.  Then it trains: ``LlamaConfig.bench_1b()`` with remat, bf16
compute over fp32 master weights, on a one-device mesh, batch 8 x 1024
tokens (the flash kernel forward, the dense-recompute backward, AdamW),
and reports step time, tokens/s and MFU; holds one train step through
flash against one through dense attention at 2 layers of that width;
saves, restores and resumes a train state on the card; runs ring
attention's per-block forward and backward at the train shape against
dense attention; and trains the same model again through the
multi-process path (``init_distributed`` over nccl, one spawned rank per
card, a DeviceMesh with ``MeshSpec(fsdp=-1)``, FSDP2), whose first loss
must equal the single-card phase's.  Last, the port's actor runtime:
``ray_tpu_torch.init()`` on this machine, an actor pinned to the card
that takes a 256 MiB bf16 CUDA tensor out of the object store bit for
bit, two GPU tasks on disjoint cards of a cluster that claims two; the
train phase's configuration through ``TorchTrainer`` in a GPU-pinned
actor, whose six losses must match the train phase's; and a worker
killed mid-run whose resumed losses must equal an uninterrupted run's
bit for bit.  On that cluster, the MPMD pipeline: the train phase's
model, init and batch through ``TrainPipeline(pp=2)`` (stages of 11 and
9 layers, 4 microbatches of 2, each stage at ``num_gpus=0.5`` on the one
card), whose first loss must be the train phase's and whose stage
processes count their own flash launches; 2 layers in fp32 through the
pipeline against the single-program step; and a channel-compiled chain
of two half-card actors that must carry a 64 MiB bf16 CUDA tensor bit
for bit.  Then the libraries a trainer uses: two bench_1b trials of
``tune.Tuner`` at ``{"GPU": 0.5}`` each on the one card, one per
learning rate, whose first losses must be the train phase's (and the
3e-4 trial's the trainer phase's); the train phase's configuration
through ``TorchTrainer`` fed by a ``data.from_numpy`` Dataset whose
first batch is the train batch; and a placement group of two half-card
bundles whose actors both run on card "0", after whose removal a
whole-card actor starts.  Before them, one PPO learner update on the card over a
CartPole-shaped rollout against the same update on the CPU.  Then
serving through that runtime, behind the HTTP proxy:
the serve phase's engine and prompts in a ``num_gpus=1`` replica, as
concurrent SSE streams (client TTFT, the replica's decode step, its
paged launches counted inside it); 2 layers in fp32 through a replica,
bit for bit against the in-process engine; and disaggregated prefill,
a prefill and a decode replica at ``num_gpus=0.5`` each on the one
card, a 1000-token prompt's KV pack timed through the object store,
then in fp32 at 2 layers against one replica's tokens.  Last, the
cluster-operations libraries: a cluster started with the CLI
(``python -m ray_tpu_torch.scripts start --head``) runs bench_1b whole
for 3 steps in a submitted job's entrypoint process (the train phase's
losses bit for bit), stops a job that holds the card, after which a
``num_gpus=1`` actor gets it, serves its dashboard (``/metrics``,
``/api/state`` showing the held card) and runs a workflow of two
``num_gpus=1`` steps at bench_1b's widths with 4 layers (train and
checkpoint; restore and train), whose second step fails once: ``resume``
reruns it alone and the four losses equal an uninterrupted run's bit for
bit; then an autoscaler whose head advertises no card launches a
``{"GPU": 1}`` node for a pending actor, which trains bench_1b 3 steps
on card "0" (the train phase's losses again), and terminates the node
once it is idle.  Each phase prints one JSON line; a failed check raises, so the script exits
non-zero.  The last lines are the card's name and power limit (from
nvidia-smi), then {"ok": true, "device": {...}}.

On four cards or more, ``pipeline_mesh`` puts the pipeline phase's
model, init and batch through ``TrainPipeline(pp=2, stage_mesh=X)`` for
X in fsdp=2, tp=2 and sp=2, each stage two ranks on a card each in a
process group of its own (nccl), whose first loss must be the train
phase's within the dist_train bound of its layout, whose losses must
fall, whose every rank must run on a card of its own and launch flash
as its schedule says; on fewer cards it prints that it did not run.

Exits non-zero, printing no result, when no CUDA device is visible.

    python3 chip_smoke.py --dist-only fsdp=2,sp=2 dp=2,tp=2

builds the kernels, runs the single-card ``train`` phase as the
reference and then ``dist_train`` on each mesh given, one rank per
visible card (for a machine with several cards).

    python3 chip_smoke.py --pipeline-mesh-only fsdp=2 tp=2 sp=2

runs the ``train`` phase as the reference and then ``pipeline_mesh`` on
each stage layout given (four cards).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import _LLMCallable

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
PEAK_FLOPS_PER_S = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
                    torch.float32: 67e12}    # fp32 outside tensor cores
# Each element must satisfy |kernel - plain| <= atol + rtol * |plain|.
# Both compute in fp32 from the same inputs and round the output once to
# the input type: fp32 outputs differ by summation order only; a bf16
# output may land one rounding step (at most 2^-7 of its value) away,
# and rtol allows two.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2 ** -6)}
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int) -> float:
    """Median device time of one call, each launched with a cold L2
    (a 128 MiB buffer is rewritten before every call).  A ~0.1 ms sleep
    on the device before each timed call lets the host enqueue the call
    ahead of the start event, so a short kernel's time is its own and
    not the wrapper's host work."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(200_000)   # cycles, ~0.1 ms
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_device_ms(fn, keys, iters: int = 20) -> dict:
    """Device time of one call of ``fn`` per kernel family, from
    torch.profiler: {key: ms} summed over the kernels whose name holds
    ``key``; None when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in keys}
    seen = False
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        seen = True
        for k in keys:
            if k in e.name:
                out[k] += e.time_range.elapsed_us() / 1e3 / iters
    return out if seen else None


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def tol_ratio(out: torch.Tensor, ref: torch.Tensor, extra=None) -> float:
    """Largest |out - ref| over its allowance under TOL, plus ``extra``
    per element where given (pass: <= 1)."""
    atol, rtol = TOL[ref.dtype]
    diff = (out.float() - ref.float()).abs()
    allowed = atol + rtol * ref.float().abs()
    if extra is not None:
        allowed = allowed + extra
    return float((diff / allowed).max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------------ phases


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load("paged_attention", "flash_attention")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         kernel_build_s=time.perf_counter() - t0)
    torch.cuda.synchronize()
    return smi


PAGED_LENS = {
    # ragged contexts including an inactive lane; lanes 4 and 5 alias
    "main": [1000, 0, 17, 513, 256, 256, 1032, 64],
    # long contexts, where the split across blocks matters
    "long": [3000, 3137, 3500, 3999, 4000, 3333, 3071, 3800],
}


def _paged_case(dtype, gen, lens):
    """The main-path decode shape: B=8 lanes of an 8B-width model
    (H=32, Hkv=8, D=128), page_size 16, a 256-wide table (the engine's
    bucket for contexts up to 4096), shuffled physical pages, and lanes
    4 and 5 aliasing the same pages (a shared prefix)."""
    b, h, hkv, d, ps, width, num_pages = 8, 32, 8, 128, 16, 256, 4097
    pool_k = torch.randn((num_pages * ps, hkv, d), generator=gen,
                         device="cuda").to(dtype)
    pool_v = torch.randn((num_pages * ps, hkv, d), generator=gen,
                         device="cuda").to(dtype)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen,
                          device="cuda").cpu().numpy() + 1
    table = np.zeros((b, width), np.int32)
    nxt = 0
    for lane, n in enumerate(lens):
        used = -(-n // ps)
        if lane == 5 and lens[5] == lens[4]:
            table[5] = table[4]
            continue
        table[lane, :used] = perm[nxt:nxt + used]
        nxt += used
    bt = torch.from_numpy(table).cuda()
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, pool_k, pool_v, bt, cl, ps


def _paged_library(q, pool_k, pool_v, bt, cl, ps):
    """Yardstick only: -> a function that gathers each lane's context
    (padded to the longest) and makes one SDPA call.  The slot indices
    and the mask are computed once, outside the timed call, as the
    kernel's own table walk is free of host syncs."""
    n = int(cl.max())
    pos = torch.arange(n, device="cuda")
    slots = (bt[:, pos // ps].long() * ps + pos % ps)          # [B, n]
    mask = (pos[None, :] < cl[:, None].long())[:, None, None, :]

    def run():
        k = pool_k[slots].transpose(1, 2)                      # [B,Hkv,n,D]
        v = pool_v[slots].transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True)
    return run


def phase_kernel_paged(gen) -> dict:
    rows = {}
    for case, lens in PAGED_LENS.items():
        for dtype in (torch.bfloat16, torch.float32):
            if case == "long" and dtype == torch.float32:
                continue
            q, pk, pv, bt, cl, ps = _paged_case(dtype, gen, lens)
            out = pa.paged_attention(q, pk, pv, bt, cl, page_size=ps)
            ref = pa.paged_attention_ref(q, pk, pv, bt, cl, page_size=ps)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            check(bool(torch.isfinite(out).all()), "paged kernel: non-finite")
            for lane, n in enumerate(lens):
                check(n > 0 or bool((out[lane] == 0).all()),
                      "paged kernel: ctx 0 lane not zero")
            ratio = tol_ratio(out, ref)
            check(ratio <= 1,
                  f"paged kernel {case} {dtype}: err {err}, {ratio}x tol")
            kernel_ms = time_ms(
                lambda: pa.paged_attention(q, pk, pv, bt, cl, page_size=ps),
                50)
            plain_ms = time_ms(
                lambda: pa.paged_attention_ref(q, pk, pv, bt, cl,
                                               page_size=ps), 10)
            library_ms = time_ms(_paged_library(q, pk, pv, bt, cl, ps), 50)
            by_kernel = kernel_device_ms(
                lambda: pa.paged_attention(q, pk, pv, bt, cl, page_size=ps),
                ("paged_decode_split", "paged_decode_merge"))
            # bytes the function must move: each distinct used K/V row
            # once (aliased lanes share theirs), q in, out written
            pos = torch.arange(int(cl.max()), device="cuda")
            slots = bt[:, pos // ps].long() * ps + pos % ps
            live = pos[None, :] < cl[:, None].long()
            rows_read = int(torch.unique(slots[live]).numel())
            hkv, d = pk.shape[1], pk.shape[2]
            nbytes = (2 * rows_read * hkv * d + 2 * q.numel()) \
                * dtype.itemsize + bt.numel() * 4 + cl.numel() * 4
            flops = 4 * int(cl.sum()) * q.shape[2] * d   # QK^T + PV
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            rows[f"{case}_{str(dtype).split('.')[1]}"] = dict(
                max_abs_err=err, tol_atol_rtol=TOL[dtype], tol_ratio=ratio,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=nbytes,
                n_splits=pa.n_splits(bt.shape[1], ps),
                device_ms_by_kernel=by_kernel,
                shape=dict(B=8, H=32, Hkv=8, D=128, page_size=ps,
                           width=bt.shape[1], context_lens=cl.tolist()))
            del q, pk, pv, out, ref
    torch.cuda.synchronize()
    emit("kernel_paged", **rows)
    return rows["main_bfloat16"]


def phase_kernel_flash(gen) -> dict:
    rows = {}
    cases = [("8b_prefill", 2, 2048, 32, 8, 128),
             ("entry_small", 8, 512, 12, 4, 64),
             ("train_1b", 8, 1024, 12, 4, 128),
             ("pipeline_microbatch", 2, 1024, 12, 4, 128),
             # a stage rank's microbatch at fsdp=2 (half the rows) and
             # at tp=2 (half the heads)
             ("stage_rank_fsdp2", 1, 1024, 12, 4, 128),
             ("stage_rank_tp2", 2, 1024, 6, 2, 128)]
    for label, b, s, h, hkv, d in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, s, h, d), generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen,
                            device="cuda").to(dtype)
            out = fa.flash_attention(q, k, v, True)
            ref = fa.flash_attention_ref(q, k, v, True)
            # the bf16 kernel rounds P to bf16 before P.V: allow for it
            extra = (fa.p_rounding_allowance(q, k, v, True)
                     if dtype == torch.bfloat16 else None)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            check(bool(torch.isfinite(out).all()), "flash kernel: non-finite")
            ratio = tol_ratio(out, ref, extra)
            check(ratio <= 1,
                  f"flash kernel {label} {dtype}: err {err}, {ratio}x tol")
            kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, True), 20)
            plain_ms = time_ms(
                lambda: fa.flash_attention_ref(q, k, v, True), 5)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), 20)
            flops = 2 * b * h * s * s * d        # causal QK^T + PV
            nbytes = (2 * q.numel() + 2 * k.numel()) * dtype.itemsize
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            rows[f"{label}_{str(dtype).split('.')[1]}"] = dict(
                max_abs_err=err, tol_atol_rtol=TOL[dtype],
                p_allowance=extra is not None, tol_ratio=ratio,
                kernel="wgmma" if dtype == torch.bfloat16 else "cuda_cores",
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=nbytes,
                shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, causal=True))
            del q, k, v, out, ref, extra
    torch.cuda.synchronize()
    emit("kernel_flash", **rows)
    return rows["8b_prefill_bfloat16"]


def phase_forward(gen) -> int:
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device="cuda", seed=SEED).eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda", dtype=torch.int32)
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(tokens)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0   # first call: cuBLAS and pool set-up
    launches = fa.LAUNCHES
    check(tuple(logits.shape) == (2, 2048, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.bfloat16, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "8b logits not finite")
    check(launches == cfg.n_layers,
          f"flash launches {launches} != {cfg.n_layers}")
    logit_absmax = float(logits.float().abs().max())
    del logits
    warm_s = []
    with torch.no_grad():
        for _ in range(3):
            t0 = time.perf_counter()
            model(tokens)
            torch.cuda.synchronize()
            warm_s.append(time.perf_counter() - t0)
    del model
    torch.cuda.empty_cache()

    from ray_tpu_torch.entry import entry

    fwd, args = entry()
    fa.LAUNCHES = 0
    small = fwd(*args)
    torch.cuda.synchronize()
    entry_launches = fa.LAUNCHES
    check(tuple(small.shape) == (8, 512, 32000), "entry logits shape")
    check(bool(torch.isfinite(small).all()), "entry logits not finite")
    check(entry_launches == LlamaConfig.small().n_layers,
          f"entry flash launches {entry_launches}")
    del fwd, args, small
    torch.cuda.empty_cache()
    emit("forward", config="llama3_8b", n_layers=cfg.n_layers,
         tokens=[2, 2048], dtype="bfloat16", init_s=init_s,
         forward_s=statistics.median(warm_s), forward_warm_s=warm_s,
         forward_cold_s=cold_s, flash_launches=launches,
         logit_absmax=logit_absmax, entry_flash_launches=entry_launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


def phase_serve() -> tuple:
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, device="cuda", seed=SEED, max_batch=8,
                    page_size=16, prefill_chunk=64, prefix_sharing=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts, late_prompt = _serve_prompts(cfg, rng)   # the last joins late
    max_new = SERVE_NEW_TOKENS
    pa.LAUNCHES = 0
    t0 = time.perf_counter()
    seqs = [eng.submit({"tokens": p, "max_new_tokens": max_new})
            for p in prompts]
    for _ in range(8):
        eng.step()
    seqs.append(eng.submit({"tokens": late_prompt,
                            "max_new_tokens": max_new}))
    prompts.append(late_prompt)
    steps = 0
    while any(not s.done for s in seqs):
        eng.step()
        steps += 1
        check(steps < 10_000, "serve did not finish")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    st = eng.stats()
    launches = pa.LAUNCHES
    for s in seqs:
        check(len(s.generated) == max_new and s.error is None,
              f"{s.request_id}: {len(s.generated)} tokens, {s.error}")
        check(all(0 <= t < cfg.vocab_size for t in s.generated),
              "token out of range")
    check(st["used_pages"] == 0, f"pages not recycled: {st}")
    check(st["prefix_hits"] >= 1, f"no prefix hit: {st}")
    check(launches == cfg.n_layers * st["decode_steps"],
          f"paged launches {launches} != {cfg.n_layers} x "
          f"{st['decode_steps']}")
    decode_tokens = sum(len(s.generated) - 1 for s in seqs)
    ttft = [s.first_token_at - s.submitted_at for s in seqs]
    emit("serve", config="llama3_8b", n_layers=cfg.n_layers,
         dtype="bfloat16", requests=len(seqs),
         prompt_lens=[len(p) for p in prompts], max_new_tokens=max_new,
         engine_init_s=init_s, wall_s=wall_s, steps=st["steps"],
         decode_steps=st["decode_steps"], decode_secs=st["decode_secs"],
         decode_step_ms=st["decode_secs"] / st["decode_steps"] * 1e3,
         decode_tokens=decode_tokens,
         decode_tokens_per_s=decode_tokens / st["decode_secs"],
         ttft_s=ttft, ttft_median_s=statistics.median(ttft),
         paged_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         stats=st)
    phase_decode_profile(eng, rng)
    del eng
    torch.cuda.empty_cache()
    return launches, {"decode_step_ms": st["decode_secs"]
                      / st["decode_steps"] * 1e3, "ttft_s": ttft,
                      "ttft_median_s": statistics.median(ttft)}


def phase_decode_profile(eng, rng, steps: int = 5) -> None:
    """Where a decode step's time goes: 8 lanes at ~520 tokens of
    context, ``steps`` decode-only steps under torch.profiler.  Reports
    the host wall time per step and the device kernel time per step, in
    total and by kernel family; device figures are None when the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vocab = eng.cfg.vocab_size
    seqs = [eng.submit({"tokens": rng.integers(0, vocab, 512).tolist(),
                        "max_new_tokens": steps + 4}) for _ in range(8)]
    while any(s.state != "decode" for s in seqs):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    while any(not s.done for s in seqs):
        eng.step()
    torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / steps
    families = {"paged_attention": ("paged_decode",),
                "gemm": ("gemm", "gemv", "cutlass", "nvjet", "sm90_xmma")}
    fam = {k: 0.0 for k in families}
    for name, ms in by_name.items():
        for k, keys in families.items():
            if any(x in name.lower() for x in keys):
                fam[k] += ms
                break
    device_ms = sum(by_name.values()) if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit("decode_profile", lanes=8, context_tokens=512 + 1, steps=steps,
         wall_ms_per_step=wall_ms, device_ms_per_step=device_ms,
         device_busy_share=(device_ms / wall_ms if device_ms else None),
         paged_ms_per_step=fam["paged_attention"] if by_name else None,
         gemm_ms_per_step=fam["gemm"] if by_name else None,
         kernel_launches_per_step=(
             sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / steps),
         top_kernels_ms_per_step=[[n[:80], ms] for n, ms in top])


def phase_serve_identity() -> None:
    """fp32 at full width (2 layers): greedy tokens equal the argmax of
    the no-cache forward over prompt + generated (teacher forcing), and
    the dense decode path gives the same tokens."""
    import dataclasses

    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    base = rng.integers(0, cfg.vocab_size, 40).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 100, 17)] + [base, base[:30] + [7, 8, 9]]
    kw = dict(device="cuda", max_batch=8, page_size=16, prefill_chunk=64,
              prefix_sharing=True)

    def run(eng):
        seqs = [eng.submit({"tokens": p, "max_new_tokens": 8})
                for p in prompts[:4]]
        for _ in range(3):
            eng.step()
        seqs.append(eng.submit({"tokens": prompts[4],
                                "max_new_tokens": 8}))
        while any(not s.done for s in seqs):
            eng.step()
        check(eng.stats()["used_pages"] == 0, "identity: pages leaked")
        return [list(s.generated) for s in seqs]

    paged = LLMEngine(cfg, seed=SEED, **kw)
    out_paged = run(paged)
    mismatches = 0
    with torch.no_grad():
        for p, gen in zip(prompts, out_paged):
            full = torch.tensor([p + gen], dtype=torch.int32, device="cuda")
            am = paged._model(full)[0].argmax(-1).tolist()
            mismatches += sum(am[len(p) + j - 1] != t
                              for j, t in enumerate(gen))
    check(mismatches == 0, f"paged tokens differ from the full forward "
          f"at {mismatches} positions")
    dense = LLMEngine(cfg, params=paged._model.state_dict(),
                      attention_impl="dense", **kw)
    out_dense = run(dense)
    torch.cuda.synchronize()
    check(out_dense == out_paged, "dense decode tokens differ from paged")
    emit("serve_identity", config="llama3_8b width, 2 layers, fp32",
         prompts=len(prompts), tokens=out_paged,
         full_forward_mismatches=mismatches, dense_equal=True,
         cow_splits=paged.stats()["cow_splits"],
         prefix_hits=paged.stats()["prefix_hits"])
    del paged, dense
    torch.cuda.empty_cache()


# The train phase's MFU: 6 * params * tokens/s over the peak, the
# definition of bench.py's train bench, with the H100's dense bf16 peak.
MFU_DEFINITION = "6 * param_count * tokens_per_s / 989e12 (H100 dense bf16)"
TRAIN_SHAPE = (8, 1024)     # batch x sequence, as bench.py's train bench
GEMM_KEYS = ("gemm", "gemv", "cutlass", "nvjet", "sm90_xmma")


def _train_state(cfg, seed: int, **kw):
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train.gspmd import build_llama_train_state

    mesh = make_mesh(MeshSpec(dp=-1))
    params, opt, step_fn, _ = build_llama_train_state(
        cfg, mesh, rng_seed=seed, batch_size=TRAIN_SHAPE[0],
        seq_len=TRAIN_SHAPE[1], **kw)
    return mesh, params, opt, step_fn


def _train_tokens(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, TRAIN_SHAPE).astype(np.int32)


def train_step_profile(step_fn, params, opt, tokens) -> dict:
    """One train step under torch.profiler: device ms by kernel family
    (GEMMs, the flash kernel, the optimizer's multi-tensor kernels, the
    rest), the device time of the dense-recompute attention backward
    (the kernels under autograd's evaluation of the
    ``_FlashAttentionBackward`` node) and of ``opt.step``, and the host
    wall time.  Device figures are None when the profiler records no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"gemm": 0.0, "flash_kernel": 0.0, "optimizer_kernels": 0.0,
           "rest": 0.0}
    launches = 0
    under = {"flash_backward_dense": 0.0, "optimizer_step": 0.0}
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue    # a named range on the device timeline
            launches += 1
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            name = e.name.lower()
            if "flash_fwd" in name:
                fam["flash_kernel"] += ms
            elif any(k in name for k in GEMM_KEYS):
                fam["gemm"] += ms
            elif "multi_tensor_apply" in name:
                fam["optimizer_kernels"] += ms
            else:
                fam["rest"] += ms
        elif e.name == ("autograd::engine::evaluate_function: "
                        "_FlashAttentionBackward"):
            # the node's own event nests inside this range: count one
            under["flash_backward_dense"] += e.device_time_total / 1e3
        elif e.name.startswith("Optimizer.step#"):
            under["optimizer_step"] += e.device_time_total / 1e3
    device_ms = sum(fam.values())
    if not launches:
        return {"wall_ms": wall_ms, "device_ms": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_ms_by_family": fam, "device_ms_under": under,
            "kernel_launches": launches,
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


def phase_train() -> tuple:
    """The single-card training path at the repo's training width, as
    bench.py's train bench drives the JAX package: bench_1b with remat,
    bf16 compute over fp32 master weights, a one-device mesh, one fixed
    batch of 8 x 1024 tokens, 3 warm-up steps and 12 timed steps, each
    ended by a synchronize."""
    import dataclasses

    from ray_tpu_torch.parallel import shard_batch
    from ray_tpu_torch.train.gspmd import param_count

    cfg = dataclasses.replace(LlamaConfig.bench_1b(), remat=True)
    warmup, steps = 3, 12
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh, params, opt, step_fn = _train_state(cfg, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(all(p.dtype == torch.float32 for p in params.parameters()),
          "train: weights are not fp32 master weights")
    tokens = shard_batch(mesh, _train_tokens(cfg, SEED))  # placed once
    losses, step_s = [], []
    fa.LAUNCHES = 0
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, tokens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(float(loss))
        if i >= warmup:
            step_s.append(dt)
    launches = fa.LAUNCHES
    per_step = launches / (warmup + steps)
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(per_step == 2 * cfg.n_layers,
          f"flash launches per step {per_step} != 2 x {cfg.n_layers}")
    n_params = param_count(params)
    median_s = statistics.median(step_s)
    tokens_per_s = TRAIN_SHAPE[0] * TRAIN_SHAPE[1] / median_s
    mfu = 6 * n_params * tokens_per_s / PEAK_FLOPS_PER_S[torch.bfloat16]
    peak_bytes = torch.cuda.max_memory_allocated()
    profile = train_step_profile(step_fn, params, opt, tokens)
    emit("train", config="bench_1b", n_layers=cfg.n_layers, remat=True,
         compute_dtype="bfloat16", param_dtype="float32",
         mesh=mesh.shape, tokens=list(TRAIN_SHAPE), params=n_params,
         optimizer="AdamW(lr 3e-4, betas (0.9, 0.999), eps 1e-8, wd 1e-4)",
         init_s=init_s, warmup_steps=warmup, timed_steps=steps,
         step_s_median=median_s, step_s=step_s, tokens_per_s=tokens_per_s,
         mfu=mfu, mfu_definition=MFU_DEFINITION, loss_first=losses[0],
         loss_last=losses[-1], losses=losses, flash_launches=launches,
         flash_launches_per_step=per_step, max_memory_allocated=peak_bytes,
         device_ms_over_median_step=(
             profile["device_ms"] / (median_s * 1e3)
             if profile["device_ms"] else None),
         step_profile=profile)
    del params, opt, step_fn, tokens
    torch.cuda.empty_cache()
    return launches, dict(loss_first=losses[0], losses=losses,
                          step_s_median=median_s)


# train_identity: the flash step's loss against the dense step's, and
# each parameter's gradient, |g_flash - g_dense| / |g_dense| in L2 norm.
# Both compute in bf16: the flash kernel rounds P to bf16 inside an online
# softmax, dense attention rounds the normalised probabilities to bf16, so
# the attention outputs differ by about one bf16 step and the gradients,
# computed in bf16 through two layers, inherit it: at this width on the
# CPU (flash's plain version against dense, batch 1) the losses differed
# by 5e-5 and the gradients by 1.4% (median over parameters) to 2.2%
# (layer 1's wk).  A wrong kernel moves them by order one.  The phase also
# reports how far bf16 itself moves the gradients: dense bf16 against a
# dense fp32 step from the same weights.
IDENTITY_LOSS_REL = 2e-3
IDENTITY_GRAD_REL = 5e-2


def phase_train_identity() -> None:
    """bench_1b width cut to 2 layers, bf16, S = 1024, from one seed:
    one train step with attention through the flash kernel, one with
    ``attention_kernel=dense_attention``; losses and gradients agree."""
    import dataclasses

    from ray_tpu_torch.models.llama import dense_attention

    cfg = dataclasses.replace(LlamaConfig.bench_1b(), n_layers=2,
                              remat=True)
    tokens = _train_tokens(cfg, SEED + 2)
    fp32 = dataclasses.replace(cfg, dtype=torch.float32)
    runs = {}
    for name, c, kernel in (("flash", cfg, None),
                            ("dense", cfg, dense_attention),
                            ("dense_fp32", fp32, dense_attention)):
        _mesh, params, opt, step_fn = _train_state(c, SEED + 2,
                                                   attention_kernel=kernel)
        before = fa.LAUNCHES
        params, opt, loss = step_fn(params, opt, tokens)
        torch.cuda.synchronize()
        runs[name] = (float(loss), fa.LAUNCHES - before,
                      {n: p.grad for n, p in params.named_parameters()})
        del params, opt, step_fn
    (lf, nf, gf), (ld, nd, gd) = runs["flash"], runs["dense"]
    check(nf == 2 * cfg.n_layers and nd == 0,
          f"identity: flash launches {nf} / dense {nd}")

    def rel(a, b):
        return {n: float((a[n] - b[n]).norm() / b[n].norm()) for n in b}

    loss_rel = abs(lf - ld) / abs(ld)
    grad_rel = rel(gf, gd)
    bf16_rel = rel(gd, runs["dense_fp32"][2])
    worst = max(grad_rel, key=grad_rel.get)
    check(math.isfinite(lf) and loss_rel <= IDENTITY_LOSS_REL,
          f"identity: loss {lf} vs dense {ld}")
    check(grad_rel[worst] <= IDENTITY_GRAD_REL,
          f"identity: grad of {worst} differs by {grad_rel[worst]}")
    emit("train_identity", config="bench_1b width, 2 layers, bf16",
         tokens=list(TRAIN_SHAPE), loss_flash=lf, loss_dense=ld,
         loss_rel=loss_rel, loss_rel_bound=IDENTITY_LOSS_REL,
         grad_rel_max=grad_rel[worst], grad_rel_worst_param=worst,
         grad_rel_median=statistics.median(grad_rel.values()),
         grad_rel_bound=IDENTITY_GRAD_REL, flash_launches=nf,
         loss_dense_fp32=runs["dense_fp32"][0],
         bf16_vs_fp32_grad_rel_max=max(bf16_rel.values()),
         bf16_vs_fp32_grad_rel_median=statistics.median(bf16_rel.values()))
    del runs, gf, gd
    torch.cuda.empty_cache()


# After a restore the first step's loss comes from the saved weights
# alone; the next depends on a backward whose embedding gradient sums
# with atomics on the card, so it is held within a tolerance.
RESUME_LOSS_REL = 1e-3


def phase_train_checkpoint() -> None:
    """Save a train state (weights, Adam moments, step) after step 1,
    take steps 2 and 3; restore into a fresh model and optimizer and
    take steps 2 and 3 again; the losses agree."""
    import dataclasses
    import tempfile

    from ray_tpu_torch.train import restore_checkpoint, save_checkpoint

    cfg = dataclasses.replace(LlamaConfig.bench_1b(), n_layers=2,
                              remat=True)
    tokens = _train_tokens(cfg, SEED + 3)
    _mesh, params, opt, step_fn = _train_state(cfg, SEED + 3)
    params, opt, _ = step_fn(params, opt, tokens)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(tmp, "ck"), {
            "model": params.state_dict(), "opt": opt.state_dict(),
            "step": 1})
        save_s = time.perf_counter() - t0
        straight = [float(step_fn(params, opt, tokens)[2])
                    for _ in range(2)]
        del params, opt, step_fn
        _mesh, params, opt, step_fn = _train_state(cfg, SEED + 4)
        t0 = time.perf_counter()
        state = restore_checkpoint(path)
        params.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
    check(state["step"] == 1, "checkpoint: step")
    check(all(p.dtype == torch.float32 for p in params.parameters()),
          "checkpoint: weights")
    resumed = [float(step_fn(params, opt, tokens)[2]) for _ in range(2)]
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, straight)]
    check(max(rel) <= RESUME_LOSS_REL,
          f"resume: losses {resumed} vs {straight}")
    emit("train_checkpoint", config="bench_1b width, 2 layers, bf16",
         saved_after_step=1, losses_straight=straight,
         losses_resumed=resumed, loss_rel=rel,
         loss_rel_bound=RESUME_LOSS_REL,
         bitwise=[a == b for a, b in zip(resumed, straight)],
         checkpoint_bytes=nbytes, save_s=save_s, restore_s=restore_s)
    del params, opt, step_fn, state
    torch.cuda.empty_cache()


# dist_train: the train phase's configuration through the process-group
# path, one rank per visible card over nccl.  With one card the mesh is
# fsdp = 1: no exchange between ranks, but FSDP2's sharded parameters,
# its all-gather and reduce-scatter hooks, the DeviceMesh and the global
# loss all run.  Over dp and fsdp alone its first loss is the train
# phase's first loss: the same weights, tokens and products, the loss
# summed in another order.  tp adds bf16 partial sums of wo and w2 across
# ranks, and sp computes attention in ring blocks instead of flash: each
# moves the activations by about a bf16 rounding, as flash against dense
# attention does (train_identity), so those layouts take that phase's
# loss bound.
DIST_FIRST_LOSS_REL = 1e-5
DIST_SHARDED_MATH_LOSS_REL = 2e-3
DIST_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _collective_busbw(world: int, nbytes: int = 256 << 20) -> dict:
    """GB/s of an all-gather and an all-reduce of ``nbytes`` (fp32) over
    every rank, as nccl-tests counts bus bandwidth: bytes x (n - 1) / n
    (twice that for an all-reduce) over the median of 5 timed calls."""
    import torch.distributed as dist

    x = torch.ones(nbytes // 4, device="cuda")
    gathered = torch.empty(world * x.numel(), device="cuda")
    out = {}
    for name, fn, factor in (
            ("all_gather", lambda: dist.all_gather_into_tensor(gathered, x),
             world - 1),
            ("all_reduce", lambda: dist.all_reduce(x), 2 * (world - 1))):
        times = []
        for i in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            dist.barrier()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end) / 1e3)
        # all_gather moves world x nbytes in all, all_reduce nbytes
        moved = nbytes * (world if name == "all_gather" else 1)
        out[name] = moved * factor / world / statistics.median(times) / 1e9
    del x, gathered
    torch.cuda.empty_cache()
    return out


def _dist_train_rank(rank: int, world: int, port: int, out: str,
                     spec: dict) -> None:
    """One rank of ``dist_train`` (a spawned process on card ``rank``)
    on ``MeshSpec(**spec)``; rank 0 writes the results to ``out``."""
    import dataclasses

    import torch.distributed as dist

    from ray_tpu_torch.parallel import (MeshSpec, init_distributed,
                                        make_mesh, shutdown_distributed)
    from ray_tpu_torch.train.gspmd import build_llama_train_state, param_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", world, rank)
    try:
        cfg = dataclasses.replace(LlamaConfig.bench_1b(), remat=True)
        warmup, steps = 3, 12
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = make_mesh(MeshSpec(**spec))
        params, opt, step_fn, _ = build_llama_train_state(
            cfg, mesh, rng_seed=SEED, batch_size=TRAIN_SHAPE[0],
            seq_len=TRAIN_SHAPE[1])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the global batch, on the card once; each step takes its slice
        tokens = torch.from_numpy(_train_tokens(cfg, SEED)).cuda()
        losses, step_s = [], []
        fa.LAUNCHES = 0
        for i in range(warmup + steps):
            t0 = time.perf_counter()
            params, opt, loss = step_fn(params, opt, tokens)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            losses.append(float(loss))
            if i >= warmup:
                step_s.append(dt)
        launches = fa.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        profile = train_step_profile(step_fn, params, opt, tokens)
        busbw = _collective_busbw(world) if world > 1 else None
        result = dict(world_size=world, backend=dist.get_backend(),
                      collective_busbw_gb_s=busbw,
                      mesh=mesh.shape,
                      device_mesh=str(mesh.device_mesh),
                      params=param_count(params), init_s=init_s,
                      warmup_steps=warmup, timed_steps=steps,
                      losses=losses, step_s=step_s, flash_launches=launches,
                      flash_launches_per_step=launches / (warmup + steps),
                      n_layers=cfg.n_layers, max_memory_allocated=peak,
                      step_profile=profile)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        shutdown_distributed()


def phase_dist_train(train: dict, spec: dict = None) -> int:
    """The train phase's model, batch and steps through
    ``init_distributed``, ``make_mesh(MeshSpec(**spec))`` (default
    ``fsdp=-1``) and the sharded ``build_llama_train_state``, one
    spawned rank per card.  A rank that raises or dies fails the
    phase."""
    import tempfile

    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    spec = spec or {"fsdp": -1}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dist_train.json")
        ctx = mp.start_processes(_dist_train_rank,
                                 args=(world, _free_port(), out, spec),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"dist_train ranks still running after "
                                   f"{DIST_TIMEOUT_S} s")
        with open(out) as f:
            r = json.load(f)
    losses = r["losses"]
    per_step = r["flash_launches_per_step"]
    mesh = r["mesh"]
    bound = (DIST_FIRST_LOSS_REL if mesh["tp"] == mesh["sp"] == 1
             else DIST_SHARDED_MATH_LOSS_REL)
    first_rel = abs(losses[0] - train["loss_first"]) / abs(train["loss_first"])
    check(all(math.isfinite(x) for x in losses), f"dist losses {losses}")
    check(losses[-1] < losses[0], f"dist loss did not fall: {losses}")
    check(first_rel <= bound,
          f"dist first loss {losses[0]} vs train {train['loss_first']}")
    check(r["world_size"] == world == math.prod(mesh.values()),
          f"dist mesh {mesh} over {r['world_size']} ranks")
    # flash runs where attention is not a ring: twice a layer a step
    want = 2 * r["n_layers"] if mesh["sp"] == 1 else 0
    check(per_step == want,
          f"dist flash launches per step {per_step} != {want}")
    median_s = statistics.median(r["step_s"])
    tokens_per_s = TRAIN_SHAPE[0] * TRAIN_SHAPE[1] / median_s
    # the peak of every card the ranks run on
    mfu = 6 * r["params"] * tokens_per_s \
        / (world * PEAK_FLOPS_PER_S[torch.bfloat16])
    profile = r.pop("step_profile")
    emit("dist_train", config="bench_1b", remat=True,
         compute_dtype="bfloat16", param_dtype="float32",
         tokens=list(TRAIN_SHAPE), **r,
         step_s_median=median_s, tokens_per_s=tokens_per_s, mfu=mfu,
         mfu_definition=MFU_DEFINITION + ", the peak times world_size",
         loss_first=losses[0],
         loss_last=losses[-1], train_loss_first=train["loss_first"],
         first_loss_rel=first_rel, first_loss_rel_bound=bound,
         loss_rel_by_step=[abs(a - b) / abs(b) for a, b
                           in zip(losses, train["losses"])],
         train_step_s_median=train["step_s_median"],
         overhead_vs_train=median_s / train["step_s_median"] - 1,
         device_ms_over_median_step=(
             profile["device_ms"] / (median_s * 1e3)
             if profile["device_ms"] else None),
         step_profile=profile)
    return r["flash_launches"]


# ring_blocks: relative L2 error of each tensor against dense attention
# and its autograd in fp32 from the same bf16 inputs.  The blocks compute
# their scores in fp32, round P to bf16 for P.V as dense attention does,
# and their gradients in fp32; each tensor is rounded once to bf16 at
# the end (2^-9 relative).  1e-2 allows about ten such roundings; a
# wrong mask, a lost block or a wrong LSE moves a tensor by order one.
# Dense attention in bf16 is reported beside it, as a yardstick.
RING_REL = 1e-2


def phase_ring_blocks(gen) -> None:
    """Ring attention's per-block forward and backward (the functions
    each sp rank runs per ring step) at the train shape [8, 1024, 12/4,
    128] in bf16, the sequence cut into 4 blocks fed in ring order."""
    from ray_tpu_torch.models.llama import dense_attention
    from ray_tpu_torch.ops.ring_attention import ring_blocks

    b, s, h, hkv, d, n = 8, 1024, 12, 4, 128, 4
    q = torch.randn((b, s, h, d), generator=gen, device="cuda")
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    d_out = torch.randn((b, s, h, d), generator=gen, device="cuda")
    q, k, v, d_out = (x.to(torch.bfloat16) for x in (q, k, v, d_out))
    ring = ring_blocks(q, k, v, n, causal=True, d_out=d_out)

    def dense(dtype):
        xs = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        out = dense_attention(*xs, causal=True)
        out.backward(d_out.to(dtype))
        return [out.detach()] + [x.grad for x in xs]

    ref, bf16 = dense(torch.float32), dense(torch.bfloat16)
    torch.cuda.synchronize()

    def rel(a, r):
        return float((a.float() - r).norm() / r.norm())

    names = ("out", "dq", "dk", "dv")
    ring_rel = {nm: rel(a, r) for nm, a, r in zip(names, ring, ref)}
    dense_rel = {nm: rel(a, r) for nm, a, r in zip(names, bf16, ref)}
    max_abs = {nm: max_err(a, r) for nm, a, r in zip(names, ring, ref)}
    for nm in names:
        check(bool(torch.isfinite(ring[names.index(nm)]).all()),
              f"ring_blocks {nm} not finite")
        check(ring_rel[nm] <= RING_REL,
              f"ring_blocks {nm}: rel err {ring_rel[nm]} > {RING_REL}")
    fwd_ms = time_ms(lambda: ring_blocks(q, k, v, n, causal=True), 5)
    both_ms = time_ms(lambda: ring_blocks(q, k, v, n, causal=True,
                                          d_out=d_out), 5)
    emit("ring_blocks", shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, blocks=n,
                                   causal=True), dtype="bfloat16",
         reference="dense_attention + autograd in fp32 on the same inputs",
         rel_err=ring_rel, rel_err_bound=RING_REL,
         dense_bf16_rel_err=dense_rel, max_abs_err=max_abs,
         forward_ms=fwd_ms, forward_backward_ms=both_ms)
    del q, k, v, d_out, ring, ref, bf16
    torch.cuda.empty_cache()


# -------------------------------------------------------------- RL learner
#
# One PPOLearner update at PPOConfig's defaults (4 epochs of 256-row
# minibatches, Adam at 3e-4, gradients clipped to norm 0.5) over a
# CartPole-shaped rollout of 128 steps x 16 envs built from a seed
# (so it needs no gymnasium): on the card, and the same update on
# the CPU from the same weights with the same minibatch order.  Both
# compute in fp32 (TF32 is off); they differ in the order of sums.
# Adam's first steps move a weight by about lr * sign(g), so where a
# gradient sits at rounding noise the two may step apart by up to
# 2 * lr per step; the bound allows that on at most RL_DRIFT_SHARE of
# the weights and holds the rest within RL_WEIGHT_ATOL, and the losses
# within RL_STATS_REL (relative to at least 1e-3).  On the CPU, weights
# moved by one rounding step (2e-7 relative) before the same update end
# at most 3e-7 apart.

RL_T, RL_E = 128, 16
RL_WEIGHT_ATOL = 1e-5
RL_DRIFT_SHARE = 1e-3
RL_STATS_REL = 1e-4
RL_UPDATES_TIMED = 5


def _cartpole_rollout(seed: int) -> dict:
    """A [T, E] rollout with CartPole's shapes and ranges: 4-dim
    observations, 2 actions, a reward of 1 per live step, episodes that
    end about every 20 steps, the step after an end masked out."""
    rng = np.random.default_rng(seed)
    T, E = RL_T, RL_E
    done = rng.uniform(size=(T, E)) < 0.05
    mask = np.ones((T, E), np.float32)
    mask[1:][done[:-1]] = 0.0
    return {
        "obs": (rng.normal(size=(T, E, 4)) * [0.5, 0.8, 0.1, 0.8]
                ).astype(np.float32),
        "actions": rng.integers(0, 2, size=(T, E)).astype(np.int32),
        "logp": np.log(rng.uniform(0.4, 0.6, size=(T, E))
                       ).astype(np.float32),
        "values": rng.normal(10.0, 3.0, size=(T, E)).astype(np.float32),
        "rewards": mask.copy(),
        "nonterminal": (~done).astype(np.float32),
        "mask": mask,
        "last_value": rng.normal(10.0, 3.0, size=(E,)).astype(np.float32),
    }


def phase_rl_learner() -> None:
    """One PPO update on the card against the same update on the CPU,
    then updates/s on the card."""
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule

    batch = _cartpole_rollout(SEED + 8)
    card = PPOLearner(ActorCriticModule(4, 2, seed=SEED, device="cpu"),
                      seed=SEED)
    host = PPOLearner(ActorCriticModule(4, 2, seed=SEED, device="cpu"),
                      seed=SEED, device="cpu")
    check(card.device.type == "cuda", f"rl_learner: on {card.device}")
    init = host.get_weights()
    t0 = time.perf_counter()
    stats_card = card.update_from_batch(batch)
    first_update_s = time.perf_counter() - t0
    stats_host = host.update_from_batch(batch)
    got, want = card.get_weights(), host.get_weights()
    diff = {k: (got[k] - want[k]).abs() for k in want}
    worst = max(float(d.max()) for d in diff.values())
    n = sum(d.numel() for d in diff.values())
    drift = sum(int((d > RL_WEIGHT_ATOL).sum()) for d in diff.values()) / n
    steps = card.num_epochs * (RL_T * RL_E // card.minibatch_size)
    moved = max(float((want[k] - init[k]).abs().max()) for k in want)
    stats_rel = {k: abs(stats_card[k] - v) / max(abs(v), 1e-3)
                 for k, v in stats_host.items()}
    check(all(math.isfinite(v) for v in stats_card.values()),
          f"rl_learner: stats {stats_card}")
    check(moved > 1e-4, "rl_learner: the update did not move the weights")
    check(drift <= RL_DRIFT_SHARE and worst <= 2 * 3e-4 * steps,
          f"rl_learner: weights differ from the CPU's: {drift} of them "
          f"beyond {RL_WEIGHT_ATOL}, at most {worst}")
    check(max(stats_rel.values()) <= RL_STATS_REL,
          f"rl_learner: stats {stats_card} vs cpu {stats_host}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RL_UPDATES_TIMED):
        card.update_from_batch(batch)   # ends in a host read of its stats
    card_s = (time.perf_counter() - t0) / RL_UPDATES_TIMED
    t0 = time.perf_counter()
    host.update_from_batch(batch)
    host_s = time.perf_counter() - t0
    emit("rl_learner", rollout=[RL_T, RL_E], obs_dim=4, num_actions=2,
         hidden=[64, 64], minibatch_size=card.minibatch_size,
         num_epochs=card.num_epochs, adam_steps_per_update=steps,
         stats_card=stats_card, stats_cpu=stats_host, stats_rel=stats_rel,
         stats_rel_bound=RL_STATS_REL, weight_diff_max=worst,
         weight_share_beyond_atol=drift, weight_atol=RL_WEIGHT_ATOL,
         weight_share_bound=RL_DRIFT_SHARE, first_update_s=first_update_s,
         update_s=card_s, updates_per_s=1.0 / card_s,
         host_cpu_update_s=host_s)


# ------------------------------------------------------ the actor runtime
#
# The runtime's workers import this file as the module ``chip_smoke``
# (the repo root is on their PYTHONPATH), so what they run below is
# pickled by reference and never pulls the driver's state along.

RUNTIME_STORE_BYTES = 1 << 30     # the object store's arena
RUNTIME_PUT_ELEMS = 128 << 20     # bf16: 256 MiB
RUNTIME_TIMEOUT_S = 300


def _put_tensor(seed: int, elems: int = RUNTIME_PUT_ELEMS) -> torch.Tensor:
    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(elems, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


class GpuProbe:
    """An actor holding one GPU lease: what it sees, and a CUDA tensor
    taken out of the object store on its own card."""

    def info(self) -> dict:
        return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count(),
                "device_name": torch.cuda.get_device_name()}

    def receive(self, boxed: list, seed: int) -> dict:
        import ray_tpu_torch as rt

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rt.get(boxed[0])
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        return {"get_s": get_s, "device": str(got.device),
                "current_device": torch.cuda.current_device(),
                "dtype": str(got.dtype), "numel": got.numel(),
                "bit_identical": bool(torch.equal(
                    got.view(torch.int16), _put_tensor(seed).view(torch.int16)))}


def visible_devices_task(sync_dir: str) -> str:
    """A task holding one GPU lease: its CUDA_VISIBLE_DEVICES, once both
    tasks have started (so the two leases are held at once)."""
    mine = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    with open(os.path.join(sync_dir, f"{os.getpid()}.gpus"), "w") as f:
        f.write(mine)
    deadline = time.time() + 60
    while time.time() < deadline and len(
            [n for n in os.listdir(sync_dir) if n.endswith(".gpus")]) < 2:
        time.sleep(0.05)
    return mine


def phase_runtime(tmp: str) -> None:
    """``ray_tpu_torch.init()`` on this machine: its GPU count, an actor
    pinned to one card, a 256 MiB bf16 CUDA tensor through the object
    store into that actor; then a cluster that claims two GPUs, where
    two concurrent ``num_gpus=1`` tasks see disjoint cards."""
    import ray_tpu_torch as rt

    import chip_smoke as this

    t0 = time.perf_counter()
    rt.init(object_store_memory=RUNTIME_STORE_BYTES)
    try:
        init_s = time.perf_counter() - t0
        gpus = rt.cluster_resources().get("GPU", 0)
        check(gpus == torch.cuda.device_count(),
              f"runtime: the cluster counts {gpus} GPU, torch "
              f"{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        probe = rt.remote(num_gpus=1)(this.GpuProbe).remote()
        info = rt.get(probe.info.remote(), timeout=RUNTIME_TIMEOUT_S)
        actor_s = time.perf_counter() - t0
        check(info["device_count"] == 1 and info["cuda_visible_devices"]
              and len(info["cuda_visible_devices"].split(",")) == 1,
              f"runtime: the actor sees {info}")
        # twice: what the first round pays for touching fresh pages (the
        # host buffer, the arena's mappings) shows as its excess
        sent = _put_tensor(SEED)
        put_s, got = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = rt.put(sent)
            put_s.append(time.perf_counter() - t0)
            got.append(rt.get(probe.receive.remote([ref], SEED),
                              timeout=RUNTIME_TIMEOUT_S))
            del ref
        # the warm put's two halves: the copy off the card, and the put
        # of that host tensor into the store
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = sent.cpu()
        d2h_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = rt.put(host)
        host_put_s = time.perf_counter() - t0
        del ref, host
        for g in got:
            check(g["bit_identical"] and g["numel"] == sent.numel()
                  and g["device"] == f"cuda:{g['current_device']}",
                  f"runtime: the tensor came back as {g}")
        del sent
        rt.kill(probe)
    finally:
        rt.shutdown()
    sync_dir = os.path.join(tmp, "gpu_tasks")
    os.makedirs(sync_dir)
    rt.init(num_cpus=2, resources={"GPU": 2},
            object_store_memory=64 << 20)
    try:
        task = rt.remote(num_gpus=1)(this.visible_devices_task)
        seen = rt.get([task.remote(sync_dir), task.remote(sync_dir)],
                      timeout=RUNTIME_TIMEOUT_S)
    finally:
        rt.shutdown()
    sets = [set(s.split(",")) for s in seen]
    check(all(len(s) == 1 for s in sets) and not sets[0] & sets[1],
          f"runtime: the two GPU leases see {seen}")
    nbytes = RUNTIME_PUT_ELEMS * 2
    get_s = [g["get_s"] for g in got]
    emit("runtime", cluster_gpus=gpus, init_s=init_s,
         actor_first_call_s=actor_s, actor=info, put_bytes=nbytes,
         put_s=put_s, put_gb_s=[nbytes / t / 1e9 for t in put_s],
         put_split={"device_to_host_s": d2h_s, "host_tensor_put_s": host_put_s},
         get_in_actor_s=get_s, get_gb_s=[nbytes / t / 1e9 for t in get_s],
         get_device=got[0]["device"], get_dtype=got[0]["dtype"],
         bit_identical=True, faked_gpus=2, tasks_visible_devices=seen)


def trainer_loop(config: dict) -> dict:
    """The train loop TorchTrainer (and a Tune trial) runs inside its
    GPU-pinned actor: a one-rank process group over nccl,
    ``MeshSpec(fsdp=-1)``, the train phase's model and batch; reports
    each step's loss and time, with the process's flash launches so far,
    its card and its peak memory.  ``learning_rate`` overrides AdamW's
    3e-4.  With ``tokens_from="dataset"`` each step takes its batch from
    the worker's shard of the dataset "train" instead, moved to
    ``cuda:0``, and reports the host time the pull took.  It reports a
    checkpoint after each step before ``save_until`` and resumes from
    the one it is given; ``die_at`` ends the first life of the process
    at that step."""
    import dataclasses

    from torch.distributed.checkpoint.state_dict import (get_state_dict,
                                                         set_state_dict)

    from ray_tpu_torch import train as rtt
    from ray_tpu_torch.parallel import (MeshSpec, init_distributed,
                                        make_mesh, shutdown_distributed)
    from ray_tpu_torch.train.gspmd import build_llama_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    init_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        cfg = dataclasses.replace(LlamaConfig.bench_1b(), remat=True,
                                  n_layers=config["n_layers"])
        mesh = make_mesh(MeshSpec(fsdp=-1))
        params, opt, step_fn, _ = build_llama_train_state(
            cfg, mesh, rng_seed=config["seed"], batch_size=TRAIN_SHAPE[0],
            seq_len=TRAIN_SHAPE[1],
            **{k: config[k] for k in ("learning_rate",) if k in config})
        if config.get("tokens_from") == "dataset":
            batches = rtt.get_dataset_shard("train").iter_batches(
                batch_size=TRAIN_SHAPE[0])
        else:
            tokens = torch.from_numpy(
                _train_tokens(cfg, config["seed"])).cuda()
        where = {"cuda_visible_devices":
                 os.environ.get("CUDA_VISIBLE_DEVICES"),
                 "device_name": torch.cuda.get_device_name()}
        start = 0
        resumed_from = rtt.get_checkpoint()
        if resumed_from:
            from ray_tpu_torch.train import restore_checkpoint

            model_sd, opt_sd = get_state_dict(params, opt)
            state = restore_checkpoint(resumed_from, target={
                "model": model_sd, "opt": opt_sd, "step": 0})
            set_state_dict(params, opt, model_state_dict=state["model"],
                           optim_state_dict=state["opt"])
            start = state["step"] + 1
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        fa.LAUNCHES = 0
        for step in range(start, config["steps"]):
            if step == config.get("die_at") \
                    and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                os._exit(1)  # a hard worker death, not a Python error
            pull = {}
            if config.get("tokens_from") == "dataset":
                t0 = time.perf_counter()
                # a copy: the batch views the store's read-only arena
                tokens = torch.tensor(next(batches)["tokens"],
                                      device="cuda:0")
                pull = {"pull_s": time.perf_counter() - t0,
                        "batch_shape": list(tokens.shape)}
            t0 = time.perf_counter()
            params, opt, loss = step_fn(params, opt, tokens)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            ckpt, save_s = None, 0.0
            if step < config.get("save_until", 0):
                from ray_tpu_torch.train import save_checkpoint

                t0 = time.perf_counter()
                model_sd, opt_sd = get_state_dict(params, opt)
                ckpt = save_checkpoint(
                    os.path.join(rtt.get_context().trial_dir,
                                 f"ckpt_{step}"),
                    {"model": model_sd, "opt": opt_sd, "step": step})
                save_s = time.perf_counter() - t0
            rtt.report({"step": step, "loss": float(loss), "step_s": step_s,
                        "save_s": save_s, "at": time.time(), **pull,
                        "flash_launches": fa.LAUNCHES, "setup_s": setup_s,
                        "max_memory_allocated":
                        torch.cuda.max_memory_allocated(), **where},
                       checkpoint=ckpt)
        return {"flash_launches": fa.LAUNCHES,
                "steps_run": config["steps"] - start,
                "resumed_from": resumed_from, "setup_s": setup_s, **where,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
    finally:
        shutdown_distributed()


TRAINER_STEPS = 6
TRAINER_LOSS_REL = 1e-5


def phase_trainer(train: dict, tmp: str) -> tuple:
    """The train phase's configuration (bench_1b, remat, bf16 over fp32
    master weights, 8 x 1024 tokens from seed 0) through
    ``TorchTrainer(loop, ScalingConfig(num_workers=1))``: one worker
    actor holding the card.  Same weights, batch and kernels as the
    train phase, so the same losses.  Returns (flash launches, losses)."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    import chip_smoke as this

    n_layers = LlamaConfig.bench_1b().n_layers
    t0 = time.perf_counter()
    result = TorchTrainer(
        this.trainer_loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="trainer", storage_path=tmp),
        train_loop_config={"n_layers": n_layers, "seed": SEED,
                           "steps": TRAINER_STEPS}).fit()
    fit_s = time.perf_counter() - t0
    final = result.per_worker_final[0]
    losses = [m["loss"] for m in result.metrics_history]
    step_s = [m["step_s"] for m in result.metrics_history]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    check(len(losses) == TRAINER_STEPS, f"trainer: {len(losses)} reports")
    check(max(rel) <= TRAINER_LOSS_REL,
          f"trainer: losses {losses} vs train {train['losses'][:6]}")
    check(final["flash_launches"] == 2 * n_layers * TRAINER_STEPS,
          f"trainer: flash launched {final['flash_launches']} times")
    check(final["cuda_visible_devices"] and
          len(final["cuda_visible_devices"].split(",")) == 1,
          f"trainer: the worker sees {final['cuda_visible_devices']}")
    emit("trainer", config="bench_1b", remat=True, compute_dtype="bfloat16",
         param_dtype="float32", tokens=list(TRAIN_SHAPE), workers=1,
         losses=losses, train_losses=train["losses"][:TRAINER_STEPS],
         loss_rel=rel, loss_rel_bound=TRAINER_LOSS_REL, step_s=step_s,
         # the first step warms cuBLAS and the allocator in a fresh
         # process, as the train phase's warm-up steps do
         first_step_s=step_s[0], step_s_median=statistics.median(step_s[1:]),
         train_step_s_median=train["step_s_median"],
         fit_s=fit_s, **final,
         flash_launches_per_step=final["flash_launches"] / TRAINER_STEPS)
    return final["flash_launches"], losses


def phase_trainer_resume(tmp: str) -> int:
    """bench_1b width cut to 2 layers through TorchTrainer with one
    retry: the loop reports a checkpoint after steps 0-2 and its worker
    dies at step 3; the new gang restores the last checkpoint the
    trainer received (step 2's, or step 1's when the worker died before
    the trainer polled step 2's report) and runs on to step 5.  Every
    reported loss must equal an uninterrupted run's bit for bit."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    import chip_smoke as this

    loop_config = {"n_layers": 2, "seed": SEED + 5, "steps": 6}

    def fit(name: str, **extra):
        t0 = time.perf_counter()
        result = TorchTrainer(
            this.trainer_loop, scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name=name, storage_path=tmp,
                                 failure_max_retries=1),
            train_loop_config={**loop_config, **extra}).fit()
        return result, time.perf_counter() - t0

    marker = os.path.join(tmp, "died_once")
    resumed, resumed_s = fit("resume", save_until=3, die_at=3,
                             marker=marker)
    straight, straight_s = fit("straight")
    check(os.path.exists(marker), "trainer_resume: the worker never died")
    steps = [m["step"] for m in resumed.metrics_history]
    check(steps == list(range(6)), f"trainer_resume: steps {steps}")
    got = [m["loss"] for m in resumed.metrics_history]
    want = [m["loss"] for m in straight.metrics_history]
    final = resumed.per_worker_final[0]
    check(final["resumed_from"] and 3 <= final["steps_run"] <= 4,
          f"trainer_resume: the second life ran {final}")
    check(got == want, f"trainer_resume: losses {got} vs {want}")
    emit("trainer_resume", config="bench_1b width, 2 layers, bf16",
         died_at_step=3, resumed_from=os.path.basename(final["resumed_from"]),
         second_life_steps=final["steps_run"],
         second_life_setup_s=final["setup_s"],
         save_s=[m["save_s"] for m in resumed.metrics_history],
         report_at_s=[m["at"] - resumed.metrics_history[0]["at"]
                      for m in resumed.metrics_history],
         losses_resumed=got, losses_straight=want, bitwise=True,
         fit_with_death_s=resumed_s, fit_straight_s=straight_s,
         flash_launches=final["flash_launches"]
         + straight.per_worker_final[0]["flash_launches"])
    return (final["flash_launches"]
            + straight.per_worker_final[0]["flash_launches"])


def phase_runtime_and_trainers(train: dict) -> int:
    """The runtime phase, then on one cluster the trainer,
    trainer_resume, pipeline, pipeline_identity, dag_channel, tune,
    data_ingest and placement_group phases, with the runtime's session
    directories in a temporary directory; returns the flash launches
    the trainers' workers, the pipeline stages and the Tune trials
    made."""
    import tempfile

    import ray_tpu_torch as rt

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["RT_TMPDIR"] = tmp
        phase_runtime(tmp)
        rt.init(object_store_memory=RUNTIME_STORE_BYTES)
        try:
            launches, trainer_losses = phase_trainer(train, tmp)
            launches += phase_trainer_resume(tmp)
            check(PIPE_RING_BYTES + DAG_RING_BYTES < RUNTIME_STORE_BYTES // 2,
                  "the object store cannot hold the pipeline's rings")
            launches += phase_pipeline(train)
            launches += phase_pipeline_identity()
            phase_dag_channel()
            launches += phase_tune(train, trainer_losses)
            launches += phase_data_ingest(train, tmp)
            phase_placement_group()
        finally:
            rt.shutdown()
    return launches


# --------------------------------------------- the libraries a trainer uses
#
# Tune trials are the port's TrainWorker actors on fractional GPU leases,
# each running trainer_loop at the train phase's configuration; a
# Dataset of token rows feeds trainer_loop through TorchTrainer; a
# placement group reserves two half-card bundles on the one card.

TUNE_LRS = (3e-4, 1e-3)      # 3e-4 is the trainer phase's AdamW rate
TUNE_STEPS = 4
TUNE_GPUS_PER_TRIAL = 0.5
INGEST_STEPS = 6
PG_RELEASE_TIMEOUT_S = 120


def _trial_span(history: list) -> tuple:
    """(start, end) of a trial's steps on the host's wall clock."""
    return history[0]["at"] - history[0]["step_s"], history[-1]["at"]


def phase_tune(train: dict, trainer_losses: list) -> int:
    """Two bench_1b trials (remat, bf16 over fp32 master weights, the
    seed-0 init, the train phase's 8 x 1024 batch), one per learning
    rate, 4 steps each, through ``Tuner`` with ``max_concurrent_trials=2``
    at ``{"GPU": 0.5}`` a trial: both on the one card at once.  Step 0
    is the train phase's first loss (the learning rate cannot touch it);
    the 3e-4 trial is the trainer phase's first 4 steps.  Each trial
    counts its own flash launches.  Returns their sum."""
    from ray_tpu_torch import tune

    import chip_smoke as this

    n_layers = LlamaConfig.bench_1b().n_layers
    t0 = time.perf_counter()
    grid = tune.Tuner(
        this.trainer_loop,
        param_space={"learning_rate": tune.grid_search(list(TUNE_LRS)),
                     "n_layers": n_layers, "seed": SEED,
                     "steps": TUNE_STEPS},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2),
        resources_per_trial={"GPU": TUNE_GPUS_PER_TRIAL}).fit()
    fit_s = time.perf_counter() - t0
    trials = sorted(grid, key=lambda r: r.config["learning_rate"])
    check(len(trials) == 2 and all(r.state == "TERMINATED" for r in trials),
          f"tune: trials {[(r.trial_id, r.state, r.error) for r in trials]}")
    want_launches = 2 * n_layers * TUNE_STEPS
    rows = []
    for r in trials:
        hist = r.metrics_history
        losses = [m["loss"] for m in hist]
        last = hist[-1]
        check(len(losses) == TUNE_STEPS and all(map(math.isfinite, losses)),
              f"tune: {r.trial_id} losses {losses}")
        rel0 = abs(losses[0] - train["losses"][0]) / abs(train["losses"][0])
        check(rel0 <= TRAINER_LOSS_REL,
              f"tune: {r.trial_id} step 0 {losses[0]} vs train "
              f"{train['losses'][0]}")
        check(last["cuda_visible_devices"] == "0"
              and last["device_name"] == torch.cuda.get_device_name(0),
              f"tune: {r.trial_id} ran on {last['cuda_visible_devices']} "
              f"{last['device_name']}")
        check(last["flash_launches"] == want_launches,
              f"tune: {r.trial_id} launched flash {last['flash_launches']}"
              f" times, not {want_launches}")
        step_s = [m["step_s"] for m in hist]
        rows.append({"trial_id": r.trial_id,
                     "learning_rate": r.config["learning_rate"],
                     "losses": losses, "loss_step0_rel": rel0,
                     "setup_s": last["setup_s"], "step_s": step_s,
                     "step_s_median": statistics.median(step_s[1:]),
                     "flash_launches": last["flash_launches"],
                     "max_memory_allocated": last["max_memory_allocated"],
                     "cuda_visible_devices": last["cuda_visible_devices"],
                     "device_name": last["device_name"],
                     "span": _trial_span(hist)})
    low = rows[0]
    rel = [abs(a - b) / abs(b) for a, b in zip(low["losses"], trainer_losses)]
    check(low["learning_rate"] == TUNE_LRS[0] and max(rel) <= TRAINER_LOSS_REL,
          f"tune: the 3e-4 trial {low['losses']} vs trainer "
          f"{trainer_losses[:TUNE_STEPS]}")
    best = grid.get_best_result()
    check(best.trial_id in {r["trial_id"] for r in rows},
          f"tune: best result {best.trial_id}")
    (s0, e0), (s1, e1) = rows[0]["span"], rows[1]["span"]
    overlap_s = min(e0, e1) - max(s0, s1)
    emit("tune", config="bench_1b", remat=True, compute_dtype="bfloat16",
         param_dtype="float32", tokens=list(TRAIN_SHAPE),
         steps_per_trial=TUNE_STEPS, gpus_per_trial=TUNE_GPUS_PER_TRIAL,
         max_concurrent_trials=2, fit_s=fit_s, trials=rows,
         trainer_losses=trainer_losses[:TUNE_STEPS],
         loss_rel_3e4_vs_trainer=rel, loss_rel_bound=TRAINER_LOSS_REL,
         train_loss_first=train["losses"][0],
         trials_overlap_s=overlap_s, trials_overlapped=overlap_s > 0,
         driver_memory_reserved=torch.cuda.memory_reserved(),
         best_trial=best.trial_id,
         best_learning_rate=best.config["learning_rate"],
         best_loss=best.metrics["loss"],
         flash_launches=sum(r["flash_launches"] for r in rows))
    return sum(r["flash_launches"] for r in rows)


def phase_data_ingest(train: dict, tmp: str) -> int:
    """TorchTrainer fed by a Dataset: 6 x 8 rows of 1024 int32 tokens
    (rows 0-7 the train phase's batch, the rest from seed 1) through
    ``data.from_numpy``; the one worker pulls each step's batch of 8
    from its shard with ``iter_batches`` and moves it to ``cuda:0``.
    The first loss is the train phase's.  Returns the flash launches."""
    from ray_tpu_torch import data
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    import chip_smoke as this

    cfg = LlamaConfig.bench_1b()
    rest = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, ((INGEST_STEPS - 1) * TRAIN_SHAPE[0],
                            TRAIN_SHAPE[1])).astype(np.int32)
    rows = np.concatenate([_train_tokens(cfg, SEED), rest])
    ds = data.from_numpy({"tokens": rows})
    t0 = time.perf_counter()
    result = TorchTrainer(
        this.trainer_loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="data_ingest", storage_path=tmp),
        train_loop_config={"n_layers": cfg.n_layers, "seed": SEED,
                           "steps": INGEST_STEPS, "tokens_from": "dataset"},
        datasets={"train": ds}).fit()
    fit_s = time.perf_counter() - t0
    hist = result.metrics_history
    final = result.per_worker_final[0]
    losses = [m["loss"] for m in hist]
    rel0 = abs(losses[0] - train["losses"][0]) / abs(train["losses"][0])
    check(len(losses) == INGEST_STEPS and all(map(math.isfinite, losses)),
          f"data_ingest: losses {losses}")
    check(all(m["batch_shape"] == list(TRAIN_SHAPE) for m in hist),
          f"data_ingest: batches {[m['batch_shape'] for m in hist]}")
    check(rel0 <= TRAINER_LOSS_REL,
          f"data_ingest: first loss {losses[0]} vs train "
          f"{train['losses'][0]}")
    check(final["flash_launches"] == 2 * cfg.n_layers * INGEST_STEPS,
          f"data_ingest: flash launched {final['flash_launches']} times")
    pull_s = [m["pull_s"] for m in hist]
    step_s = [m["step_s"] for m in hist]
    emit("data_ingest", config="bench_1b", remat=True,
         compute_dtype="bfloat16", param_dtype="float32",
         dataset_rows=int(rows.shape[0]), row_tokens=TRAIN_SHAPE[1],
         dataset_blocks=ds.num_blocks(), batch_size=TRAIN_SHAPE[0],
         losses=losses, train_loss_first=train["losses"][0],
         loss_first_rel=rel0, loss_rel_bound=TRAINER_LOSS_REL,
         pull_s=pull_s, pull_s_median=statistics.median(pull_s[1:]),
         step_s=step_s, step_s_median=statistics.median(step_s[1:]),
         fit_s=fit_s, setup_s=final["setup_s"],
         cuda_visible_devices=final["cuda_visible_devices"],
         flash_launches=final["flash_launches"])
    return final["flash_launches"]


class BundleProbe:
    """An actor on a GPU lease (in a placement-group bundle, or holding
    the card after a job): the cards it sees, and a tensor it allocates
    on the first of them."""

    def info(self) -> dict:
        x = torch.full((1 << 20,), 2.0, device="cuda:0")
        return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count(),
                "device_name": torch.cuda.get_device_name(0),
                "allocated_on": str(x.device), "sum": float(x.sum())}


def phase_placement_group() -> None:
    """Two half-card bundles STRICT_PACKed on the one card, an actor in
    each: both see card "0" and allocate on it.  Removing the group
    gives the shares back: a ``num_gpus=1`` actor then starts within
    PG_RELEASE_TIMEOUT_S."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import placement_group, remove_placement_group

    import chip_smoke as this

    bundles = [{"GPU": 0.5, "CPU": 1}] * 2
    t0 = time.perf_counter()
    pg = placement_group(bundles, strategy="STRICT_PACK").ready(timeout=60)
    ready_s = time.perf_counter() - t0
    probes = [rt.remote(num_gpus=0.5, num_cpus=1, placement_group=pg,
                        placement_group_bundle_index=i)(this.BundleProbe)
              .remote() for i in range(len(bundles))]
    infos = rt.get([p.info.remote() for p in probes],
                   timeout=RUNTIME_TIMEOUT_S)
    for info in infos:
        check(info["cuda_visible_devices"] == "0"
              and info["device_count"] == 1
              and info["device_name"] == torch.cuda.get_device_name(0)
              and info["allocated_on"] == "cuda:0"
              and info["sum"] == 2.0 * (1 << 20),
              f"placement_group: a bundle actor saw {info}")
    remove_placement_group(pg)
    t0 = time.perf_counter()
    whole = rt.remote(num_gpus=1)(this.BundleProbe).remote()
    after = rt.get(whole.info.remote(), timeout=PG_RELEASE_TIMEOUT_S)
    whole_s = time.perf_counter() - t0
    rt.kill(whole)
    check(after["cuda_visible_devices"] == "0",
          f"placement_group: the whole-card actor saw {after}")
    emit("placement_group", bundles=bundles, strategy="STRICT_PACK",
         ready_s=ready_s, bundle_actors=infos,
         whole_card_actor_after_removal_s=whole_s, whole_card_actor=after,
         release_timeout_s=PG_RELEASE_TIMEOUT_S)


# ------------------------------------------------------- the MPMD pipeline
#
# TrainPipeline at the train phase's configuration: bench_1b at full
# width and depth, bf16 over fp32 master weights, the train phase's
# batch of 8 x 1024 tokens as 4 microbatches of 2, two stages of one
# process each.  Each stage takes half of the one card (num_gpus=0.5),
# or a card of its own where there are two.  The stages' init is the
# train phase's seed-0 init (each weight is drawn from a generator of its
# own, seeded by the seed and its name), so the first loss is the train
# phase's first loss but for bf16 products over 2 rows instead of 8.

PIPE_MICROBATCH, PIPE_MICROBATCHES = 2, 4
PIPE_STEPS = 6
PIPE_FIRST_LOSS_REL = 2e-3
# fp32 at 2 layers: the pipeline's loss is the mean of 4 microbatch
# means and its gradient their sum over 4; the single program sums over
# the batch in one.  Only the order of fp32 sums differs.
PIPE_IDENTITY_STEPS = 5
PIPE_IDENTITY_LOSS_REL = 1e-4
PIPE_TIMEOUT_S = 300
# the rings: activations and their grads cross as [2, 1024, 1536] bf16
# slots (6.3 MB), pp + 1 = 3 deep and 2 deep
PIPE_RING_BYTES = (3 + 2) * PIPE_MICROBATCH * TRAIN_SHAPE[1] * 1536 * 2
DAG_TENSOR_ELEMS = 32 << 20         # bf16: 64 MiB
DAG_SLOT_BYTES = 2 * DAG_TENSOR_ELEMS + (1 << 20)
DAG_RING_BYTES = 2 * 2 * DAG_SLOT_BYTES   # two edges, two slots each
DAG_TRIPS = 5


def _stage_gpus() -> float:
    return 1.0 if torch.cuda.device_count() >= 2 else 0.5


def _stage_flash_launches(pipe) -> list:
    """Each stage process's own count of flash kernel launches."""
    return [pipe._ctl(h, {"op": "info"}, timeout=60)["kernel_launches"]
            ["flash_attention"] for h in pipe._handles]


def _expected_stage_launches(cfg, ranges, steps: int) -> list:
    """Flash launches per stage: a forward through each of its layers
    per microbatch, and on a stage that is not the last the backward's
    re-run of that forward (the dense-recompute backward launches no
    flash kernel; no block remat)."""
    return [(end - start) * PIPE_MICROBATCHES * steps
            * (1 if s == len(ranges) - 1 else 2)
            for s, (start, end) in enumerate(ranges)]


def _run_pipeline(cfg, seed: int, tokens, steps: int,
                  stage_mesh: dict = None) -> dict:
    """Deploy a 2-stage TrainPipeline (each stage over ``stage_mesh``, a
    whole card a rank, when given), take ``steps`` steps, read each
    rank's flash launches (0 before the first step: the stage processes
    are fresh) and tear it down."""
    from ray_tpu_torch.train import TrainPipeline

    num_gpus = 1.0 if stage_mesh else _stage_gpus()
    t0 = time.perf_counter()
    pipe = TrainPipeline(cfg, pp=2, microbatch_size=PIPE_MICROBATCH,
                         num_microbatches=PIPE_MICROBATCHES,
                         seq_len=TRAIN_SHAPE[1], rng_seed=seed,
                         stage_mesh=stage_mesh, num_gpus=num_gpus,
                         step_timeout=PIPE_TIMEOUT_S,
                         compile_timeout=PIPE_TIMEOUT_S)
    deploy_s = time.perf_counter() - t0
    try:
        infos = [pipe._ctl(h, {"op": "info"}, timeout=60)
                 for h in pipe._handles]
        before = [i["kernel_launches"]["flash_attention"] for i in infos]
        check(before == [0] * len(infos),
              f"pipeline: stages start at {before}")
        outs = [pipe.step(tokens) for _ in range(steps)]
        launches = _stage_flash_launches(pipe)
    finally:
        pipe.teardown()
    return {"outs": outs, "launches": launches, "deploy_s": deploy_s,
            "num_gpus_per_stage": num_gpus, "ranges": pipe._ranges,
            "stage_devices": [i["device"] for i in infos], "infos": infos,
            "ranks_per_stage": pipe.ranks_per_stage}


def phase_pipeline(train: dict) -> int:
    """bench_1b through TrainPipeline(pp=2): 6 steps on the train
    phase's batch and init; the first loss is the train phase's within
    PIPE_FIRST_LOSS_REL, the losses fall, and each stage process
    launched the flash kernel as its schedule says.  Returns the
    stages' flash launches."""
    cfg = LlamaConfig.bench_1b()
    run = _run_pipeline(cfg, SEED, _train_tokens(cfg, SEED), PIPE_STEPS)
    outs = run["outs"]
    losses = [o["loss"] for o in outs]
    want = _expected_stage_launches(cfg, run["ranges"], PIPE_STEPS)
    first_rel = abs(losses[0] - train["losses"][0]) / abs(train["losses"][0])
    check(run["ranges"] == [(0, 11), (11, 20)],
          f"pipeline: partition {run['ranges']}")
    check(all(math.isfinite(x) for x in losses), f"pipeline: {losses}")
    check(first_rel <= PIPE_FIRST_LOSS_REL,
          f"pipeline: first loss {losses[0]} vs train {train['losses'][0]}")
    check(losses[-1] < losses[0], f"pipeline: loss did not fall: {losses}")
    check(run["launches"] == want,
          f"pipeline: stage flash launches {run['launches']} != {want}")
    wall = [o["wall_s"] for o in outs]
    per_stage = {
        f"stage{s}": {k: [o["per_stage"][s][k] for o in outs]
                      for k in ("fwd_s", "bwd_s", "opt_s", "busy_s")}
        for s in range(2)}
    emit("pipeline", config="bench_1b", n_layers=cfg.n_layers, remat=False,
         compute_dtype="bfloat16", param_dtype="float32", pp=2,
         ranges=run["ranges"], microbatch_size=PIPE_MICROBATCH,
         num_microbatches=PIPE_MICROBATCHES, tokens=list(TRAIN_SHAPE),
         num_gpus_per_stage=run["num_gpus_per_stage"],
         cards=torch.cuda.device_count(), stage_devices=run["stage_devices"],
         one_card_time_sliced=run["num_gpus_per_stage"] < 1,
         deploy_s=run["deploy_s"], losses=losses,
         train_loss_first=train["losses"][0], loss_first_rel=first_rel,
         loss_first_rel_bound=PIPE_FIRST_LOSS_REL, step_wall_s=wall,
         step_wall_s_median=statistics.median(wall[1:]),
         train_step_s_median=train["step_s_median"],
         tokens_per_s=[o["tokens_per_s"] for o in outs],
         tokens_per_s_median=statistics.median(
             o["tokens_per_s"] for o in outs[1:]),
         bubble_pct=[o["bubble_pct"] for o in outs],
         bubble_pct_median=statistics.median(
             o["bubble_pct"] for o in outs[1:]),
         per_stage=per_stage, stage_flash_launches=run["launches"],
         flash_launches_counted_in="each stage process (ctl op info)")
    return sum(run["launches"])


def phase_pipeline_identity() -> int:
    """bench_1b width cut to 2 layers, fp32: 5 steps of TrainPipeline
    (pp=2, 4 microbatches of 2) against 5 single-program steps
    (build_llama_train_state) from the same seed's init on the same
    tokens; each loss within PIPE_IDENTITY_LOSS_REL.  Returns the
    stages' flash launches."""
    import dataclasses

    cfg = dataclasses.replace(LlamaConfig.bench_1b(), n_layers=2,
                              dtype=torch.float32)
    seed = SEED + 6
    tokens = _train_tokens(cfg, seed)
    _mesh, params, opt, step_fn = _train_state(cfg, seed)
    want = [float(step_fn(params, opt, tokens)[2])
            for _ in range(PIPE_IDENTITY_STEPS)]
    del params, opt, step_fn
    torch.cuda.empty_cache()
    run = _run_pipeline(cfg, seed, tokens, PIPE_IDENTITY_STEPS)
    got = [o["loss"] for o in run["outs"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    expected = _expected_stage_launches(cfg, run["ranges"],
                                        PIPE_IDENTITY_STEPS)
    check(max(rel) <= PIPE_IDENTITY_LOSS_REL,
          f"pipeline_identity: losses {got} vs single program {want}")
    check(run["launches"] == expected,
          f"pipeline_identity: flash launches {run['launches']}")
    emit("pipeline_identity", config="bench_1b width, 2 layers, fp32",
         pp=2, ranges=run["ranges"], microbatch_size=PIPE_MICROBATCH,
         num_microbatches=PIPE_MICROBATCHES, tokens=list(TRAIN_SHAPE),
         losses_pipeline=got, losses_single_program=want, loss_rel=rel,
         loss_rel_bound=PIPE_IDENTITY_LOSS_REL,
         stage_flash_launches=run["launches"], deploy_s=run["deploy_s"])
    return sum(run["launches"])


# pipeline_mesh: the pipeline phase's model, init, batch and schedule
# with each stage over two cards, one rank a card, in a process group of
# the stage's own.  fsdp=2 computes the same sums as one card, row by
# row, so its first loss takes dist_train's fsdp bound; tp=2 and sp=2
# sum in another order, so theirs take dist_train's sharded-math bound.
PIPE_MESH_LAYOUTS = ("fsdp=2", "tp=2", "sp=2")
PIPE_MESH_CARDS = 4     # pp=2 stages of 2 ranks, a whole card a rank


def _nccl_transports(log_dir: str, pids) -> dict:
    """{transport: channel connections} in the NCCL_DEBUG=INFO files of
    the processes ``pids`` (NCCL logs "... via P2P/IPC", "via SHM/...",
    "via NET/..." for each channel it connects)."""
    import re

    counts: dict = {}
    for name in os.listdir(log_dir):
        if not name.startswith("nccl.") \
                or int(name.rsplit(".", 1)[1]) not in pids:
            continue
        with open(os.path.join(log_dir, name), errors="replace") as f:
            for line in f:
                hit = re.search(r" via (\S+)", line)
                if hit:
                    counts[hit.group(1)] = counts.get(hit.group(1), 0) + 1
    return counts


def _pipeline_mesh_layout(cfg, tokens, train: dict, spec: dict,
                          log_dir: str) -> int:
    """One layout of pipeline_mesh; returns the ranks' flash launches."""
    run = _run_pipeline(cfg, SEED, tokens, PIPE_STEPS, stage_mesh=spec)
    outs, infos, n = run["outs"], run["infos"], run["ranks_per_stage"]
    losses = [o["loss"] for o in outs]
    sharded_math = spec.get("tp", 1) > 1 or spec.get("sp", 1) > 1
    bound = DIST_SHARDED_MATH_LOSS_REL if sharded_math else \
        DIST_FIRST_LOSS_REL
    first_rel = abs(losses[0] - train["losses"][0]) / abs(train["losses"][0])
    # flash runs where attention is not a ring, on every rank as on a
    # stage of one card
    per_stage = _expected_stage_launches(cfg, run["ranges"], PIPE_STEPS)
    want = [0 if spec.get("sp", 1) > 1 else per_stage[s]
            for s in range(2) for _ in range(n)]
    cards = [i["card"]["uuid"] for i in infos]
    check(n == math.prod(spec.values()) and len(infos) == 2 * n,
          f"pipeline_mesh {spec}: {len(infos)} ranks")
    check(all(math.isfinite(x) for x in losses),
          f"pipeline_mesh {spec}: {losses}")
    check(first_rel <= bound, f"pipeline_mesh {spec}: first loss "
          f"{losses[0]} vs train {train['losses'][0]}")
    check(losses[-1] < losses[0],
          f"pipeline_mesh {spec}: loss did not fall: {losses}")
    check(run["launches"] == want, f"pipeline_mesh {spec}: rank flash "
          f"launches {run['launches']} != {want}")
    check(len(set(cards)) == len(cards),
          f"pipeline_mesh {spec}: ranks share a card: {cards}")
    wall = [o["wall_s"] for o in outs]
    transports = {
        f"stage{s}": _nccl_transports(
            log_dir, {i["pid"] for i in infos[s * n:(s + 1) * n]})
        for s in range(2)}
    emit("pipeline_mesh", ran=True, config="bench_1b", stage_mesh=spec,
         pp=2, ranks_per_stage=n, ranges=run["ranges"],
         microbatch_size=PIPE_MICROBATCH,
         num_microbatches=PIPE_MICROBATCHES, tokens=list(TRAIN_SHAPE),
         cards=torch.cuda.device_count(),
         ranks=[{k: i[k] for k in ("stage", "rank", "pid", "device", "card",
                                   "visible_devices")} for i in infos],
         deploy_s=run["deploy_s"], losses=losses,
         train_loss_first=train["losses"][0], loss_first_rel=first_rel,
         loss_first_rel_bound=bound, step_wall_s=wall,
         step_wall_s_median=statistics.median(wall[1:]),
         train_step_s_median=train["step_s_median"],
         tokens_per_s=[o["tokens_per_s"] for o in outs],
         tokens_per_s_median=statistics.median(
             o["tokens_per_s"] for o in outs[1:]),
         bubble_pct=[o["bubble_pct"] for o in outs],
         bubble_pct_median=statistics.median(
             o["bubble_pct"] for o in outs[1:]),
         bubble_pct_1f1b=100.0 / (PIPE_MICROBATCHES + 1),
         per_stage={f"stage{s}": {k: [o["per_stage"][s][k] for o in outs]
                                  for k in ("fwd_s", "bwd_s", "opt_s",
                                            "busy_s")}
                    for s in range(2)},
         busy_s_of="each stage's rank 0",
         rank_flash_launches=run["launches"],
         nccl_transports=transports)
    return sum(run["launches"])


def phase_pipeline_mesh(train: dict, layouts) -> int:
    """bench_1b through ``TrainPipeline(pp=2, stage_mesh=X)`` for each
    layout X ("fsdp=2", ...), on a cluster of its own whose stage
    processes log NCCL's setup (NCCL_DEBUG=INFO) to files; each layout's
    first loss within its bound of the train phase's, falling losses,
    each rank's flash launches as the schedule says, a card per rank.
    Needs PIPE_MESH_CARDS cards: with fewer it prints that it did not
    run.  Returns the ranks' flash launches."""
    import tempfile

    import ray_tpu_torch as rt

    cards = torch.cuda.device_count()
    if cards < PIPE_MESH_CARDS:
        emit("pipeline_mesh", ran=False, cards_seen=cards,
             cards_needed=PIPE_MESH_CARDS,
             reason="two stages of two ranks, a whole card a rank")
        return 0
    cfg = LlamaConfig.bench_1b()
    tokens = _train_tokens(cfg, SEED)
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        env = {"RT_TMPDIR": tmp, "NCCL_DEBUG": "INFO",
               "NCCL_DEBUG_SUBSYS": "INIT,P2P,SHM,NET",
               "NCCL_DEBUG_FILE": os.path.join(tmp, "nccl.%h.%p")}
        before = {k: os.environ.get(k) for k in env}
        os.environ.update(env)    # the cluster's processes inherit it
        rt.init(object_store_memory=RUNTIME_STORE_BYTES)
        try:
            for layout in layouts:
                launches += _pipeline_mesh_layout(cfg, tokens, train,
                                                  _mesh_spec(layout), tmp)
        finally:
            rt.shutdown()
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return launches


class ChannelHop:
    """An actor of the dag_channel phase's compiled chain: ``hop``
    passes its input on, ``check`` holds what reached it against the
    seeded tensor rebuilt on its own card."""

    def hop(self, x):
        return x

    def check(self, x) -> dict:
        torch.cuda.synchronize()
        want = _put_tensor(SEED + 7, DAG_TENSOR_ELEMS)
        return {"device": str(x.device), "dtype": str(x.dtype),
                "numel": x.numel(),
                "current_device": torch.cuda.current_device(),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                "bit_identical": bool(torch.equal(
                    x.view(torch.int16), want.view(torch.int16)))}


def phase_dag_channel() -> None:
    """A channel-compiled chain driver -> A -> B of two actors holding
    half a card each (a card each where there are two): a 64 MiB bf16
    CUDA tensor crosses both rings (off the card into shared memory,
    onto A's card, off it again, onto B's) and reaches B bit for bit.
    Times the round trip from ``execute`` to the result."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    import chip_smoke as this

    hop = rt.remote(num_gpus=_stage_gpus())(this.ChannelHop)
    with InputNode() as inp:
        out = hop.bind().check.bind(hop.bind().hop.bind(inp))
        out.with_channel_options(buffer_size_bytes=1 << 16)
    t0 = time.perf_counter()
    g = out.experimental_compile(use_channels=True, max_in_flight=2,
                                 buffer_size_bytes=DAG_SLOT_BYTES)
    compile_s = time.perf_counter() - t0
    sent = _put_tensor(SEED + 7, DAG_TENSOR_ELEMS)
    trips, got = [], []
    try:
        for _ in range(DAG_TRIPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(g.execute(sent).get(timeout=RUNTIME_TIMEOUT_S))
            trips.append(time.perf_counter() - t0)
    finally:
        g.teardown()
    for r in got:
        check(r["bit_identical"] and r["numel"] == sent.numel()
              and r["device"] == f"cuda:{r['current_device']}",
              f"dag_channel: the tensor reached B as {r}")
    nbytes = sent.numel() * sent.element_size()
    emit("dag_channel", chain="driver -> A -> B", tensor_bytes=nbytes,
         dtype="bfloat16", num_gpus_per_actor=_stage_gpus(),
         max_in_flight=2, slot_bytes=DAG_SLOT_BYTES, compile_s=compile_s,
         round_trip_s=trips, round_trip_s_median=statistics.median(trips[1:]),
         # two ring crossings, each off one card and onto another
         gb_s_per_crossing=[2 * nbytes / t / 1e9 for t in trips],
         bit_identical=True, at_b=got[0])


# ------------------------------------------------- serving through the runtime

SERVE_KW = dict(max_batch=8, page_size=16, prefill_chunk=64,
                prefix_sharing=True)
SERVE_NEW_TOKENS = 32
SERVE_TIMEOUT_S = 600


class CountedLLM(_LLMCallable):
    """The ``llm_deployment`` replica target with the paged kernel's
    launch count of its own process: set to 0 and read around the
    traffic, with the engine's stats at each end."""

    def reset_launches(self) -> dict:
        pa.LAUNCHES = 0
        return self._engine.stats()

    def launches(self) -> dict:
        return {"paged_launches": pa.LAUNCHES,
                "stats": self._engine.stats(),
                "device": str(self._engine.device),
                "device_name": torch.cuda.get_device_name()
                if torch.cuda.is_available() else None,
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES")}


class ShippingLLM(CountedLLM):
    """CountedLLM that also times the KV pack's trip through the object
    store: ``prefill`` (the prefill replica) times packing and the put,
    ``__call__`` (the decode replica) the get and unpacking, and
    ``transfers`` returns what it timed.  Both otherwise do what
    _LLMCallable's do."""

    def _log(self) -> list:
        if not hasattr(self, "_transfers"):
            self._transfers = []
        return self._transfers

    def prefill(self, request):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private.object_transfer import pack_kv_pages

        payload = self._engine.prefill_request(request)
        meta = payload["meta"]
        t0 = time.perf_counter()
        buf = pack_kv_pages(meta, payload["rows"])
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = rt.put(buf)
        put_s = time.perf_counter() - t0
        self._log().append({"side": "prefill", "nbytes": len(buf),
                            "pack_s": pack_s, "put_s": put_s})
        return {"request_id": meta["request_id"], "kv_ref": ref,
                "first_token": meta["first_token"], "n": meta["n"],
                "pages": meta["pages"], "nbytes": len(buf)}

    def __call__(self, request):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private.object_transfer import unpack_kv_pages

        kv_pack = None
        if isinstance(request, dict) and request.get("kv_ref") is not None:
            request = dict(request)
            ref = request.pop("kv_ref")
            t0 = time.perf_counter()
            buf = rt.get(ref, timeout=30.0)
            get_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            kv_pack = unpack_kv_pages(buf)
            self._log().append({"side": "decode", "nbytes": len(buf),
                                "get_s": get_s,
                                "unpack_s": time.perf_counter() - t0})
            del buf
        seq = self._engine.submit(request, kv_pack=kv_pack)
        try:
            yield from self._engine.iter_tokens(seq, 0)
        finally:
            self._engine.release(seq)

    def transfers(self) -> list:
        return list(self._log())


def _sse_stream(addr, name: str, payload: dict, out: dict) -> None:
    """One SSE request: fills ``out`` with the send time, the arrival of
    the first item, the items and the status."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=SERVE_TIMEOUT_S)
    try:
        out["sent"] = time.perf_counter()
        conn.request("POST", f"/{name}", body=json.dumps(payload),
                     headers={"Content-Type": "application/json",
                              "Accept": "text/event-stream"})
        resp = conn.getresponse()
        out["status"] = resp.status
        items = []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.strip():
                if not items:
                    out["first_item"] = time.perf_counter()
                items.append(json.loads(line))
        out["items"] = items
    except Exception as exc:   # the check below reports it
        out["error"] = f"{type(exc).__name__}: {exc}"
    finally:
        conn.close()


def _stream_tokens(row: dict, n_new: int, vocab: int, what: str) -> list:
    """The tokens of one finished stream, after checking it: status 200,
    ``n_new`` in-range tokens at indices 0..n_new-1, ``done`` last."""
    check("error" not in row and row.get("status") == 200,
          f"{what}: {row.get('status')} {row.get('error')}")
    items = row["items"]
    flat = [(it["i"] + j, t) for it in items
            for j, t in enumerate(it["tokens"])]
    check([i for i, _ in flat] == list(range(n_new)),
          f"{what}: indices {[i for i, _ in flat]}")
    check(all(0 <= t < vocab for _, t in flat), f"{what}: token out of range")
    check(items[-1]["done"] is True
          and not any(it["done"] for it in items[:-1]),
          f"{what}: done is not last")
    return [t for _, t in flat]


def _serial_tokens(addr, name: str, prompts, n_new: int, vocab: int):
    out = []
    for i, p in enumerate(prompts):
        row = {}
        _sse_stream(addr, name, {"tokens": p, "max_new_tokens": n_new}, row)
        out.append(_stream_tokens(row, n_new, vocab, f"{name}[{i}]"))
    return out


def _serve_prompts(cfg, rng):
    """The serve phase's 8 prompts drawn from ``rng``, the last of which
    shares a 256-token prefix with the third and joins late."""
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()

    def toks(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    prompts = [toks(16), toks(100), prefix + toks(40), toks(500),
               toks(1000), toks(37), toks(700)]
    return prompts, prefix + toks(70)


def phase_serve_runtime(addr, inprocess: dict) -> int:
    """The serve phase's engine (full-width, full-depth llama3_8b, bf16)
    behind ``llm_deployment``'s replica target in a ``num_gpus=1``
    replica, its 8 prompts as concurrent SSE requests through the HTTP
    proxy, the prefix-sharing one late.  Returns the paged launches the
    replica made for them."""
    import threading

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import Deployment

    import chip_smoke as this

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    handle = serve.run(Deployment(
        this.CountedLLM, "llm8b", llm=True,
        ray_actor_options={"num_gpus": 1}).bind(
            model=cfg, seed=SEED, **SERVE_KW))
    deploy_s = time.perf_counter() - t0
    prompts, late = _serve_prompts(cfg, np.random.default_rng(SEED))
    before = rt_get(handle.method("reset_launches")())
    rows = [{} for _ in range(len(prompts) + 1)]
    threads = [threading.Thread(
        target=_sse_stream, args=(addr, "llm8b", {
            "tokens": p, "max_new_tokens": SERVE_NEW_TOKENS}, rows[i]))
        for i, p in enumerate(prompts + [late])]
    t0 = time.perf_counter()
    for t in threads[:-1]:
        t.start()
    # the prefix-sharing request joins once three streams are flowing
    while sum("first_item" in r for r in rows[:-1]) < 3 \
            and time.perf_counter() - t0 < SERVE_TIMEOUT_S \
            and any(t.is_alive() for t in threads[:-1]):
        time.sleep(0.005)
    threads[-1].start()
    for t in threads:
        t.join(SERVE_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    after = rt_get(handle.method("launches")())
    for i, r in enumerate(rows):
        _stream_tokens(r, SERVE_NEW_TOKENS, cfg.vocab_size, f"llm8b[{i}]")
    st0, st = before, after["stats"]
    steps = st["decode_steps"] - st0["decode_steps"]
    secs = st["decode_secs"] - st0["decode_secs"]
    launches = after["paged_launches"]
    check(st["used_pages"] == 0, f"serve_runtime: pages in use {st}")
    check(st["prefix_hits"] > st0["prefix_hits"],
          f"serve_runtime: no prefix hit {st}")
    check(steps > 0 and launches == cfg.n_layers * steps,
          f"serve_runtime: paged launches {launches} != {cfg.n_layers} x "
          f"{steps}")
    check(after["device"].startswith("cuda")
          and after["cuda_visible_devices"],
          f"serve_runtime: the replica runs on {after['device']}")
    ttft = [r["first_item"] - r["sent"] for r in rows]
    emit("serve_runtime", config="llama3_8b", n_layers=cfg.n_layers,
         dtype="bfloat16", replicas=1, num_gpus=1, requests=len(rows),
         prompt_lens=[len(p) for p in prompts + [late]],
         max_new_tokens=SERVE_NEW_TOKENS, deploy_s=deploy_s, wall_s=wall_s,
         ttft_client_s=ttft, ttft_client_median_s=statistics.median(ttft),
         ttft_client_max_s=max(ttft), decode_steps=steps,
         decode_secs=secs, decode_step_ms=secs / steps * 1e3,
         paged_launches=launches, used_pages=st["used_pages"],
         prefix_hits=st["prefix_hits"] - st0["prefix_hits"],
         replica_device=after["device_name"],
         replica_cuda_visible_devices=after["cuda_visible_devices"],
         inprocess_decode_step_ms=inprocess["decode_step_ms"],
         inprocess_ttft_median_s=inprocess["ttft_median_s"],
         inprocess_ttft_max_s=max(inprocess["ttft_s"]))
    serve.delete("llm8b")
    return launches


def _identity_cfg():
    import dataclasses

    return dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                               dtype=torch.float32)


def _identity_prompts(cfg):
    rng = np.random.default_rng(SEED + 2)
    return [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (5, 100, 17, 300)]


DISAGG_PROMPT_LEN = 1000
IDENTITY_NEW_TOKENS = 8


def _disagg_prompt(cfg):
    return np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, DISAGG_PROMPT_LEN).tolist()


def phase_serve_runtime_identity(addr) -> list:
    """2 layers at 8B width, fp32, through ``llm_deployment`` in a
    ``num_gpus=1`` replica: each prompt alone, over SSE; the tokens must
    equal the in-process engine's with the same seed bit for bit.
    Returns the replica's tokens for the disaggregated phase's prompt."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = _identity_cfg()
    prompts = _identity_prompts(cfg) + [_disagg_prompt(cfg)]
    serve.run(serve.llm_deployment(
        "ident", ray_actor_options={"num_gpus": 1}, model=cfg, seed=SEED,
        **SERVE_KW))
    got = _serial_tokens(addr, "ident", prompts, IDENTITY_NEW_TOKENS,
                         cfg.vocab_size)
    serve.delete("ident")
    eng = LLMEngine(cfg, seed=SEED, **SERVE_KW)
    want = [eng.generate_batch([{"tokens": p,
                                 "max_new_tokens": IDENTITY_NEW_TOKENS}])[0]
            for p in prompts]
    check(eng.stats()["used_pages"] == 0, "identity: pages leaked")
    del eng
    torch.cuda.empty_cache()
    check(got == want, f"serve_runtime_identity: replica {got} vs "
          f"in-process {want}")
    emit("serve_runtime_identity", config="llama3_8b width, 2 layers, fp32",
         prompt_lens=[len(p) for p in prompts],
         max_new_tokens=IDENTITY_NEW_TOKENS, tokens=got, bitwise=True)
    return got[-1]


def phase_serve_disagg(addr, plain_tokens: list) -> int:
    """``llm_deployment(prefill_replicas=1)`` with both pools at
    ``num_gpus=0.5`` on the one card: a 1000-token prompt is prefilled on
    the prefill replica, its KV pack goes through the object store and
    the decode replica decodes it.  First at 8B width and full depth in
    bf16, with the pack's trip timed; then in fp32 at 2 layers, where
    the tokens must equal the non-disaggregated replica's.  Returns the
    paged launches the 8B decode replica made."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import Deployment

    import chip_smoke as this

    cfg = LlamaConfig.llama3_8b()
    prompt = _disagg_prompt(cfg)
    t0 = time.perf_counter()
    decode = serve.run(Deployment(
        this.ShippingLLM, "disagg8b", llm=True, prefill_replicas=1,
        ray_actor_options={"num_gpus": 0.5}).bind(
            model=cfg, seed=SEED, **SERVE_KW))
    deploy_s = time.perf_counter() - t0
    prefill = serve.get_handle("disagg8b-prefill")
    before = rt_get(decode.method("reset_launches")())
    row = {}
    _sse_stream(addr, "disagg8b", {"tokens": prompt,
                                   "max_new_tokens": SERVE_NEW_TOKENS}, row)
    _stream_tokens(row, SERVE_NEW_TOKENS, cfg.vocab_size, "disagg8b")
    std = rt_get(decode.method("launches")())
    stp = rt_get(prefill.method("launches")())
    shipped = rt_get(prefill.method("transfers")())
    received = rt_get(decode.method("transfers")())
    pages = -(-DISAGG_PROMPT_LEN // SERVE_KW["page_size"])
    steps = std["stats"]["decode_steps"] - before["decode_steps"]
    launches = std["paged_launches"]
    check(steps > 0 and launches == cfg.n_layers * steps,
          f"serve_disagg: decode replica's paged launches {launches} != "
          f"{cfg.n_layers} x {steps}")
    for side, info in (("decode", std), ("prefill", stp)):
        check(info["device"].startswith("cuda")
              and info["cuda_visible_devices"],
              f"serve_disagg: the {side} replica runs on {info['device']}")
        check(info["stats"]["used_pages"] == 0,
              f"serve_disagg: {side} pages in use {info['stats']}")
    check(stp["stats"]["kv_pages_shipped_out"] >= pages
          and std["stats"]["kv_pages_shipped_in"] >= pages,
          f"serve_disagg: shipped out {stp['stats']['kv_pages_shipped_out']}"
          f", in {std['stats']['kv_pages_shipped_in']} (want {pages})")
    check(len(shipped) == 1 and len(received) == 1
          and shipped[0]["nbytes"] == received[0]["nbytes"],
          f"serve_disagg: transfers {shipped} / {received}")
    serve.delete("disagg8b")
    serve.delete("disagg8b-prefill")

    small = _identity_cfg()
    serve.run(serve.llm_deployment(
        "disagg2", prefill_replicas=1, ray_actor_options={"num_gpus": 0.5},
        model=small, seed=SEED, **SERVE_KW))
    got = _serial_tokens(addr, "disagg2", [_disagg_prompt(small)],
                         IDENTITY_NEW_TOKENS, small.vocab_size)[0]
    st2 = rt_get(serve.get_handle("disagg2").method("stats")())
    check(st2["kv_pages_shipped_in"] >= pages,
          f"serve_disagg: the fp32 decode replica prefilled itself {st2}")
    check(got == plain_tokens, f"serve_disagg: disaggregated {got} vs "
          f"one replica {plain_tokens}")
    serve.delete("disagg2")
    serve.delete("disagg2-prefill")
    nbytes = shipped[0]["nbytes"]
    emit("serve_disagg", config="llama3_8b", n_layers=cfg.n_layers,
         dtype="bfloat16", num_gpus_each=0.5, prompt_len=DISAGG_PROMPT_LEN,
         max_new_tokens=SERVE_NEW_TOKENS, deploy_s=deploy_s,
         ttft_client_s=row["first_item"] - row["sent"],
         kv_pages_shipped_out=stp["stats"]["kv_pages_shipped_out"],
         kv_pages_shipped_in=std["stats"]["kv_pages_shipped_in"],
         pack_bytes=nbytes, pack_s=shipped[0]["pack_s"],
         put_s=shipped[0]["put_s"], get_s=received[0]["get_s"],
         unpack_s=received[0]["unpack_s"],
         put_gb_s=nbytes / shipped[0]["put_s"] / 1e9,
         get_gb_s=nbytes / received[0]["get_s"] / 1e9,
         used_pages={"prefill": stp["stats"]["used_pages"],
                     "decode": std["stats"]["used_pages"]},
         decode_steps=steps, paged_launches=launches,
         fp32_2_layers={"tokens": got, "equal_to_one_replica": True,
                        "kv_pages_shipped_in": st2["kv_pages_shipped_in"]})
    return launches


def rt_get(ref):
    import ray_tpu_torch as rt

    return rt.get(ref, timeout=SERVE_TIMEOUT_S)


def phase_serving(inprocess: dict) -> int:
    """The serving phases on one port cluster with the HTTP proxy, the
    session directories in a temporary directory; returns the paged
    launches the serve_runtime and serve_disagg decode replicas made."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["RT_TMPDIR"] = tmp
        rt.init(object_store_memory=RUNTIME_STORE_BYTES)
        try:
            addr = serve.start_http()
            launches = phase_serve_runtime(addr, inprocess)
            plain = phase_serve_runtime_identity(addr)
            launches += phase_serve_disagg(addr, plain)
        finally:
            for stop in (serve.shutdown_http, serve.shutdown):
                try:
                    stop()
                except Exception:
                    pass
            rt.shutdown()
    return launches


# ------------------------------------------ the cluster-operations libraries
#
# A cluster started from the shell (``python -m ray_tpu_torch.scripts
# start --head``) runs bench_1b in a submitted job's entrypoint process,
# stops a job that holds the card and gives the card to an actor, serves
# its dashboard, and runs a workflow of two GPU steps that checkpoints
# between them; an autoscaler launches a GPU node for a pending actor and
# terminates it once idle.  Every train step here is the train phase's
# (bench_1b, remat, bf16 over fp32 master weights, the seed-0 init and
# 8 x 1024 batch, a one-device mesh) in a process of its own, so its
# losses are the train phase's bit for bit; each process counts its own
# flash launches and reports them.

OPS_STEPS = 3                # job A's and the autoscaled actor's steps
OPS_TIMEOUT_S = 600
SPIN_BYTES = 16 << 30        # what job B holds on the card until stopped
WORKFLOW_LAYERS = 4          # a 20-layer checkpoint with AdamW's state
WORKFLOW_HALF_STEPS = 2      # is ~7.2 GB a write; 4 layers ~2.4 GB
AUTOSCALE_IDLE_S = 5.0


def train_steps(n_layers: int, steps: int, save_to: str = "",
                restore_from: str = "") -> dict:
    """``steps`` train steps of bench_1b at ``n_layers`` on this
    process's card, from the seed-0 init or from the checkpoint at
    ``restore_from`` (weights, AdamW's moments and step count); saves the
    state after the last step to ``save_to``.  Raises when the process
    sees no card: nothing here falls back to the CPU."""
    import dataclasses

    from ray_tpu_torch.parallel import shard_batch
    from ray_tpu_torch.train import restore_checkpoint, save_checkpoint

    check(torch.cuda.is_available(),
          "train_steps: no card visible to this process "
          f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.bench_1b(), remat=True,
                              n_layers=n_layers)
    mesh, params, opt, step_fn = _train_state(cfg, SEED)
    tokens = shard_batch(mesh, _train_tokens(cfg, SEED))
    restore_s = 0.0
    if restore_from:
        t1 = time.perf_counter()
        state = restore_checkpoint(restore_from)
        params.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        restore_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fa.LAUNCHES = 0
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    out = {"losses": losses, "step_s": step_s, "setup_s": setup_s,
           "restore_s": restore_s, "flash_launches": fa.LAUNCHES,
           "pid": os.getpid(),
           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "device_name": torch.cuda.get_device_name(0)}
    if save_to:
        t0 = time.perf_counter()
        save_checkpoint(save_to, {"model": params.state_dict(),
                                  "opt": opt.state_dict(), "step": steps})
        out.update(path=save_to, save_s=time.perf_counter() - t0,
                   checkpoint_bytes=sum(
                       os.path.getsize(os.path.join(save_to, f))
                       for f in os.listdir(save_to)))
    del params, opt, step_fn, tokens
    torch.cuda.empty_cache()
    return out


def job_train() -> None:
    """Job A's entrypoint: bench_1b whole, OPS_STEPS steps on the card in
    this process; one line ``job_train {...}`` in the job's logs."""
    out = train_steps(LlamaConfig.bench_1b().n_layers, OPS_STEPS)
    print("job_train " + json.dumps(out), flush=True)


def job_spin() -> None:
    """Job B's entrypoint: holds SPIN_BYTES on the card and multiplies
    on it until the job is stopped."""
    check(torch.cuda.is_available(), "job_spin: no card visible")
    held = torch.empty(SPIN_BYTES, dtype=torch.uint8, device="cuda")
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    print(f"job_spin pid={os.getpid()} holds {held.numel()} bytes",
          flush=True)
    while True:
        x = torch.tanh(x @ x)
        torch.cuda.synchronize()


class CardTrainer:
    """An actor on a GPU lease that trains on its card."""

    def visible(self) -> str:
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def train(self, n_layers: int, steps: int) -> dict:
        return train_steps(n_layers, steps)


def workflow_first_half(ckpt: str, counter: str) -> dict:
    """Workflow step 1: WORKFLOW_HALF_STEPS steps from the init, then a
    checkpoint; marks ``counter`` once per run."""
    with open(counter, "a") as f:
        f.write("x")
    return train_steps(WORKFLOW_LAYERS, WORKFLOW_HALF_STEPS, save_to=ckpt)


def workflow_second_half(first: dict, flag: str) -> dict:
    """Workflow step 2: fails on its first attempt (``flag`` absent),
    else restores step 1's checkpoint and takes WORKFLOW_HALF_STEPS
    more steps.  Returns step 1's result as it was handed in beside its
    own."""
    if not os.path.exists(flag):
        open(flag, "w").close()
        raise RuntimeError("workflow: step 2's first attempt fails")
    return {"first": first,
            "second": train_steps(WORKFLOW_LAYERS, WORKFLOW_HALF_STEPS,
                                  restore_from=first["path"])}


def _cli(*args, timeout: float = 120) -> subprocess.CompletedProcess:
    """``python -m ray_tpu_torch.scripts *args`` from the checkout's root
    (the ``rtpu-torch`` CLI), under this process's RT_TMPDIR."""
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def _cli_ok(*args, timeout: float = 120) -> str:
    r = _cli(*args, timeout=timeout)
    check(r.returncode == 0,
          f"rtpu-torch {' '.join(args)}: rc {r.returncode}\n{r.stdout}\n"
          f"{r.stderr}")
    return r.stdout


def _job_status(job_id: str) -> str:
    return json.loads(_cli_ok("job", "status", job_id))["status"]


def _poll(what: str, fn, timeout: float, period: float = 0.1):
    """Call ``fn`` until it returns something true; that value."""
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        check(time.monotonic() < deadline, f"{what}: not within {timeout} s")
        time.sleep(period)


def phase_cli_jobs(train: dict):
    """Job A runs bench_1b whole in its entrypoint process (its losses
    are the train phase's first OPS_STEPS bit for bit); job B holds the
    card until ``job stop``, after which a ``num_gpus=1`` actor gets it.
    Returns (flash launches, the actor, which still holds the card)."""
    import ray_tpu_torch as rt

    import chip_smoke as this

    status = _cli_ok("status")
    check("1 node(s)" in status and "'GPU': 1.0" in status,
          f"cli_jobs: status shows\n{status}")
    entry = [sys.executable, "-c"]
    t0 = time.perf_counter()
    r = _cli("job", "submit", "--wait", "--working-dir", ROOT, "--", *entry,
             "'import chip_smoke; chip_smoke.job_train()'",
             timeout=OPS_TIMEOUT_S)
    submit_to_succeeded_s = time.perf_counter() - t0
    check(r.returncode == 0 and "SUCCEEDED" in r.stdout,
          f"cli_jobs: job A ended rc {r.returncode}\n{r.stdout[-4000:]}\n"
          f"{r.stderr[-2000:]}")
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith("job_train ")]
    check(len(lines) == 1, f"cli_jobs: job A's logs\n{r.stdout[-4000:]}")
    job_a = json.loads(lines[0][len("job_train "):])
    want = train["losses"][:OPS_STEPS]
    check(job_a["losses"] == want,
          f"cli_jobs: job A's losses {job_a['losses']} vs train {want}")
    n_layers = LlamaConfig.bench_1b().n_layers
    check(job_a["flash_launches"] == 2 * n_layers * OPS_STEPS,
          f"cli_jobs: job A launched flash {job_a['flash_launches']} times")
    check(job_a["cuda_visible_devices"]
          == os.environ.get("CUDA_VISIBLE_DEVICES"),
          f"cli_jobs: the entrypoint saw {job_a['cuda_visible_devices']!r},"
          f" its node {os.environ.get('CUDA_VISIBLE_DEVICES')!r}")

    out = _cli_ok("job", "submit", "--working-dir", ROOT, "--", *entry,
                  "'import chip_smoke; chip_smoke.job_spin()'")
    job_b = out.split("submitted ", 1)[1].split()[0]

    def spinning() -> bool:
        status = _job_status(job_b)
        check(status == "RUNNING", f"cli_jobs: job B is {status}\n"
              + _cli_ok("job", "logs", job_b)[-4000:])
        return "job_spin pid=" in _cli_ok("job", "logs", job_b)

    _poll("cli_jobs: job B holding the card", spinning, OPS_TIMEOUT_S,
          period=0.5)
    free_during = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    _cli_ok("job", "stop", job_b)
    _poll("cli_jobs: job B STOPPED",
          lambda: _job_status(job_b) == "STOPPED", 120, period=0.2)
    stop_to_stopped_s = time.perf_counter() - t0
    _poll("cli_jobs: job B's memory released",
          lambda: torch.cuda.mem_get_info()[0]
          >= free_during + 0.9 * SPIN_BYTES, 120)
    stop_to_memory_free_s = time.perf_counter() - t0
    holder = rt.remote(num_gpus=1)(this.BundleProbe).remote()
    got = rt.get(holder.info.remote(), timeout=RUNTIME_TIMEOUT_S)
    stop_to_card_s = time.perf_counter() - t0
    check(got["cuda_visible_devices"] == "0"
          and got["allocated_on"] == "cuda:0"
          and got["sum"] == 2.0 * (1 << 20),
          f"cli_jobs: the actor after job B saw {got}")
    emit("cli_jobs", cluster="python -m ray_tpu_torch.scripts start --head",
         status=status.splitlines()[:2], config="bench_1b",
         job_a_steps=OPS_STEPS, job_a_losses=job_a["losses"],
         train_losses=want, bitwise=True,
         job_a_submit_to_succeeded_s=submit_to_succeeded_s,
         job_a_setup_s=job_a["setup_s"], job_a_step_s=job_a["step_s"],
         job_a_first_step_s=job_a["step_s"][0],
         job_a_cuda_visible_devices=job_a["cuda_visible_devices"],
         job_a_device_name=job_a["device_name"],
         job_a_flash_launches=job_a["flash_launches"],
         job_b_held_bytes=SPIN_BYTES, job_b_stop_to_stopped_s=stop_to_stopped_s,
         job_b_stop_to_memory_free_s=stop_to_memory_free_s,
         job_b_stop_to_card_actor_s=stop_to_card_s, card_actor=got)
    return job_a["flash_launches"], holder


def _prometheus_samples(text: str) -> int:
    """The number of samples in Prometheus exposition text; fails on a
    line that is neither a sample, a comment nor blank."""
    import re

    sample = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? (\S+)$")
    n = 0
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            m = sample.match(ln)
            check(m is not None, f"dashboard: not Prometheus text: {ln!r}")
            float(m.group(2))
            n += 1
    return n


def phase_dashboard(holder) -> None:
    """The head's dashboard on the CLI's cluster, while ``holder`` holds
    the card: a non-zero metrics port, the app, Prometheus text, and the
    node's GPU in ``/api/state``, 1 in total and 0 available; after the
    holder is killed, 1 available again."""
    import urllib.request

    import ray_tpu_torch as rt

    port = rt.api._worker().head.call("metrics_port")["port"]
    check(port > 0, "dashboard: the head serves no metrics port")

    def get(path: str):
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            body = resp.read()
            kind = resp.headers.get("Content-Type", "")
        return kind, body, time.perf_counter() - t0

    def gpus():
        node = json.loads(get("/api/state")[1])["nodes"][0]["resources"]
        # a resource with nothing left drops out of "available"
        return node["total"].get("GPU"), node["available"].get("GPU", 0.0)

    latency = {}
    kind, html, latency["/"] = get("/")
    check(kind.startswith("text/html") and b"ray_tpu cluster" in html
          and b'<script src="/app.js">' in html, "dashboard: / is not the app")
    kind, js, latency["/app.js"] = get("/app.js")
    check(kind.startswith("application/javascript")
          and b"api/snapshot" in js, "dashboard: /app.js")
    _, text, latency["/metrics"] = get("/metrics")
    samples = _prometheus_samples(text.decode())
    check(samples > 0, "dashboard: /metrics has no samples")
    _, state, latency["/api/state"] = get("/api/state")
    nodes = json.loads(state)["nodes"]
    _poll("dashboard: the held card in /api/state",
          lambda: gpus() == (1.0, 0.0), 30)
    rt.kill(holder)
    t0 = time.perf_counter()
    _poll("dashboard: the card back in /api/state",
          lambda: gpus() == (1.0, 1.0), 60)
    release_s = time.perf_counter() - t0
    emit("dashboard", metrics_port=port, get_s=latency,
         metrics_samples=samples, nodes=len(nodes),
         gpu_total_available_while_held=[1.0, 0.0],
         kill_to_card_available_s=release_s)


def phase_workflow(train_4: dict, tmp: str) -> int:
    """Two ``num_gpus=1`` steps at bench_1b's widths with WORKFLOW_LAYERS
    layers: step 1 trains and checkpoints, step 2 fails once; ``run``
    ends FAILED, ``resume`` reruns step 2 alone from step 1's stored
    result, and the four losses are ``train_4``'s, an uninterrupted run
    in the driver, bit for bit.  Returns the steps' flash launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow

    import chip_smoke as this

    workflow.init(os.path.join(tmp, "workflows"))
    counter, flag = (os.path.join(tmp, n) for n in ("first_runs", "failed"))
    step = rt.remote(num_gpus=1, max_retries=0)
    dag = step(this.workflow_second_half).bind(
        step(this.workflow_first_half).bind(os.path.join(tmp, "wf_ckpt"),
                                            counter), flag)
    t0 = time.perf_counter()
    try:
        workflow.run(dag, workflow_id="bench_1b_halves")
        failed = False
    except rt.RayError:
        failed = True
    run_s = time.perf_counter() - t0
    check(failed and workflow.get_status("bench_1b_halves") == "FAILED",
          "workflow: run did not fail on step 2's first attempt")
    t0 = time.perf_counter()
    out = workflow.resume("bench_1b_halves")
    resume_s = time.perf_counter() - t0
    check(workflow.get_status("bench_1b_halves") == "SUCCEEDED",
          "workflow: not SUCCEEDED after resume")
    check(open(counter).read() == "x", "workflow: step 1 ran again")
    # step 1's result as resume read it back from storage
    first, second = out["first"], out["second"]
    losses = first["losses"] + second["losses"]
    check(losses == train_4["losses"],
          f"workflow: losses {losses} vs uninterrupted {train_4['losses']}")
    want = 2 * WORKFLOW_LAYERS * WORKFLOW_HALF_STEPS
    check(first["flash_launches"] == want
          and second["flash_launches"] == want,
          f"workflow: flash launched {first['flash_launches']} and "
          f"{second['flash_launches']} times")
    check(first["cuda_visible_devices"] == "0"
          and second["cuda_visible_devices"] == "0",
          "workflow: a step did not see card 0")
    emit("workflow", config=f"bench_1b widths, {WORKFLOW_LAYERS} layers",
         steps_per_half=WORKFLOW_HALF_STEPS, losses=losses,
         uninterrupted_losses=train_4["losses"], bitwise=True,
         run_until_failed_s=run_s, resume_s=resume_s,
         first_step_runs=1, checkpoint_bytes=first["checkpoint_bytes"],
         checkpoint_write_s=first["save_s"],
         checkpoint_restore_s=second["restore_s"],
         step_setup_s=[first["setup_s"], second["setup_s"]],
         step_s=first["step_s"] + second["step_s"],
         step_pids=[first["pid"], second["pid"]],
         flash_launches=first["flash_launches"] + second["flash_launches"],
         driver_flash_launches=train_4["flash_launches"])
    return first["flash_launches"] + second["flash_launches"]


def phase_autoscaler(train: dict, tmp: str) -> int:
    """A head that advertises no card and an autoscaler over the fake
    provider, whose ``gpu-worker`` type owns the card: a pending
    ``num_gpus=1`` actor makes it launch that node; the actor sees card
    "0" and trains bench_1b OPS_STEPS steps, the train phase's losses
    bit for bit; once the actor is killed the node drains and is
    terminated.  Returns the actor's flash launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import AutoscalingCluster

    import chip_smoke as this

    os.environ["RT_TMPDIR"] = tmp
    cluster = AutoscalingCluster(
        head_resources={"CPU": 2, "GPU": 0},
        worker_node_types={"gpu-worker": {
            "resources": {"CPU": 2, "GPU": 1}, "min_workers": 0,
            "max_workers": 1}},
        idle_timeout_s=AUTOSCALE_IDLE_S, update_period_s=0.3)
    try:
        rt.init(address=cluster.address)
        try:
            check(rt.cluster_resources().get("GPU", 0) == 0,
                  "autoscaler: the head advertises a card")
            t0 = time.perf_counter()
            actor = rt.remote(num_gpus=1)(this.CardTrainer).remote()
            _poll("autoscaler: gpu-worker registered",
                  lambda: len(rt.nodes()) == 2, OPS_TIMEOUT_S)
            registered_s = time.perf_counter() - t0
            visible = rt.get(actor.visible.remote(), timeout=OPS_TIMEOUT_S)
            first_reply_s = time.perf_counter() - t0
            check(visible == "0", f"autoscaler: the actor sees {visible!r}")
            n_layers = LlamaConfig.bench_1b().n_layers
            got = rt.get(actor.train.remote(n_layers, OPS_STEPS),
                         timeout=OPS_TIMEOUT_S)
            want = train["losses"][:OPS_STEPS]
            check(got["losses"] == want,
                  f"autoscaler: losses {got['losses']} vs train {want}")
            check(got["flash_launches"] == 2 * n_layers * OPS_STEPS,
                  f"autoscaler: flash launched {got['flash_launches']} "
                  "times")
            types = [n.node_type
                     for n in cluster.provider.non_terminated_nodes()]
            check(types == ["gpu-worker"], f"autoscaler: nodes {types}")
            rt.kill(actor)
            t0 = time.perf_counter()
            _poll("autoscaler: the idle gpu-worker terminated",
                  lambda: not cluster.provider.non_terminated_nodes(),
                  OPS_TIMEOUT_S)
            terminated_s = time.perf_counter() - t0
            _poll("autoscaler: the scale-down recorded",
                  lambda: cluster.status()["scale_down_total"], 60)
            status = cluster.status()
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()
    emit("autoscaler", head_resources={"CPU": 2, "GPU": 0},
         node_type={"gpu-worker": {"CPU": 2, "GPU": 1}},
         idle_timeout_s=AUTOSCALE_IDLE_S, config="bench_1b",
         steps=OPS_STEPS, losses=got["losses"], train_losses=want,
         bitwise=True, cuda_visible_devices=visible,
         demand_to_node_registered_s=registered_s,
         demand_to_first_reply_s=first_reply_s,
         actor_setup_s=got["setup_s"], actor_step_s=got["step_s"],
         idle_to_terminated_s=terminated_s,
         scale_up_total=status["scale_up_total"],
         scale_down_total=status["scale_down_total"],
         last_decision=status.get("last_decision"),
         flash_launches=got["flash_launches"])
    return got["flash_launches"]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return "zombie" not in f.read()
    except OSError:
        return False


def _stop_cli_cluster() -> dict:
    """``stop`` the CLI's cluster, then wait for its head and agent to
    exit, killing any still alive after 30 s."""
    import signal

    with open(os.path.join(os.environ["RT_TMPDIR"],
                           "latest_cluster.json")) as f:
        started = json.load(f)
    pids = [started["head_pid"], *started["agent_pids"]]
    t0 = time.perf_counter()
    r = _cli("stop", timeout=60)
    deadline = time.monotonic() + 30
    while any(map(_alive, pids)) and time.monotonic() < deadline:
        time.sleep(0.2)
    killed = [p for p in pids if _alive(p)]
    for p in killed:
        os.kill(p, signal.SIGKILL)
    check(r.returncode == 0, f"rtpu-torch stop: rc {r.returncode} {r.stderr}")
    return {"stop_s": time.perf_counter() - t0, "killed_after_stop": killed}


def phase_cluster_ops(train: dict) -> int:
    """The cluster-operations phases: on a cluster started with the CLI,
    cli_jobs, dashboard and workflow; then autoscaler on a cluster of
    its own.  The clusters' session directories, the workflow storage
    and checkpoints go to a temporary directory.  Returns the flash
    launches made in the jobs, the actors and the workflow's steps, and
    in the driver's uninterrupted run the workflow is held against."""
    import tempfile

    import ray_tpu_torch as rt

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["RT_TMPDIR"] = os.path.join(tmp, "cli")
        os.makedirs(os.environ["RT_TMPDIR"])
        t0 = time.perf_counter()
        out = _cli_ok("start", "--head")
        start_s = time.perf_counter() - t0
        failed = True
        try:
            address = out.split("cluster started at ", 1)[1].split()[0]
            rt.init(address=address)
            try:
                launches, holder = phase_cli_jobs(train)
                phase_dashboard(holder)
                train_4 = train_steps(WORKFLOW_LAYERS,
                                      2 * WORKFLOW_HALF_STEPS)
                launches += train_4["flash_launches"]
                launches += phase_workflow(train_4, tmp)
            finally:
                rt.shutdown()
            failed = False
        finally:
            try:
                stopped = _stop_cli_cluster()
            except Exception as e:  # noqa: BLE001
                if not failed:
                    raise
                # the phase's own failure is what propagates
                print(f"cli cluster stop after a failure: {e!r}",
                      file=sys.stderr, flush=True)
        emit("cli_cluster", start_s=start_s, address=address, **stopped)
        autoscaler_tmp = os.path.join(tmp, "autoscaler")
        os.makedirs(autoscaler_tmp)
        launches += phase_autoscaler(train, autoscaler_tmp)
    return launches


def _mesh_spec(arg: str) -> dict:
    """"fsdp=2,sp=2" -> {"fsdp": 2, "sp": 2}."""
    return {k: int(v) for k, v in (kv.split("=") for kv in arg.split(","))}


def _finish(smi: str) -> None:
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(SEED)
    smi = phase_device()
    if argv[:1] == ["--dist-only"]:
        # layouts over several cards: the train phase as the reference,
        # then dist_train on each mesh given ("fsdp=2,sp=2" ...)
        train = phase_train()[1]
        for arg in argv[1:] or ["fsdp=-1"]:
            phase_dist_train(train, _mesh_spec(arg))
        _finish(smi)
        return 0
    if argv[:1] == ["--pipeline-mesh-only"]:
        # the train phase as the reference, then pipeline_mesh on each
        # stage layout given ("fsdp=2" ...)
        train = phase_train()[1]
        phase_pipeline_mesh(train, argv[1:] or PIPE_MESH_LAYOUTS)
        _finish(smi)
        return 0
    paged = phase_kernel_paged(gen)
    flash = phase_kernel_flash(gen)
    flash_launches = phase_forward(gen)
    paged_launches, served = phase_serve()
    phase_serve_identity()
    train_launches, train = phase_train()
    flash_launches += train_launches
    phase_train_identity()
    phase_train_checkpoint()
    phase_ring_blocks(gen)
    flash_launches += phase_dist_train(train)
    phase_rl_learner()
    flash_launches += phase_runtime_and_trainers(train)
    flash_launches += phase_pipeline_mesh(train, PIPE_MESH_LAYOUTS)
    paged_launches += phase_serving(served)
    flash_launches += phase_cluster_ops(train)
    kernels = []
    for name, row, launches, source, replaces in (
            ("flash_attention", flash, flash_launches,
             "ray_tpu_torch/csrc/flash_attention.cu",
             "ray_tpu/ops/flash_attention.py:100"),
            ("paged_attention", paged, paged_launches,
             "ray_tpu_torch/csrc/paged_attention.cu",
             "ray_tpu/ops/paged_attention.py:173")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    check(all(math.isfinite(k["ms"]) for k in kernels), "bad timing")
    emit("script", wall_s=time.perf_counter() - started)
    print(json.dumps({"kernels": kernels}), flush=True)
    _finish(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
