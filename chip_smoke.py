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
decode path.  Each phase prints one JSON line; a failed check raises, so
the script exits non-zero.  The last lines are the card's name and power
limit (from nvidia-smi), then {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

from __future__ import annotations

import json
import math
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
             ("entry_small", 8, 512, 12, 4, 64)]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(SEED)
    smi = phase_device()
    paged = phase_kernel_paged(gen)
    flash = phase_kernel_flash(gen)
    flash_launches = phase_forward(gen)
    paged_launches = phase_serve()
    phase_serve_identity()
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
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
