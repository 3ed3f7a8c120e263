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
must equal the single-card phase's.  Each phase
prints one JSON line; a failed check raises, so the script exits
non-zero.  The last lines are the card's name and power limit (from
nvidia-smi), then {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.

    python3 chip_smoke.py --dist-only fsdp=2,sp=2 dp=2,tp=2

builds the kernels, runs the single-card ``train`` phase as the
reference and then ``dist_train`` on each mesh given, one rank per
visible card (for a machine with several cards).
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
             ("train_1b", 8, 1024, 12, 4, 128)]
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


def phase_serve() -> int:
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, device="cuda", seed=SEED, max_batch=8,
                    page_size=16, prefill_chunk=64, prefix_sharing=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()

    def toks(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    prompts = [toks(16), toks(100), prefix + toks(40), toks(500),
               toks(1000), toks(37), toks(700)]
    late_prompt = prefix + toks(70)   # joins mid-flight, shares a prefix
    max_new = 32
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
    return launches


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
    paged = phase_kernel_paged(gen)
    flash = phase_kernel_flash(gen)
    flash_launches = phase_forward(gen)
    paged_launches = phase_serve()
    phase_serve_identity()
    train_launches, train = phase_train()
    flash_launches += train_launches
    phase_train_identity()
    phase_train_checkpoint()
    phase_ring_blocks(gen)
    flash_launches += phase_dist_train(train)
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
    print(json.dumps({"kernels": kernels}), flush=True)
    _finish(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
