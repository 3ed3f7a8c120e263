"""Paged attention for single-token decode with GQA.

Replaces the Pallas TPU kernel ``ray_tpu/ops/paged_attention.py``
(``_paged_kernel`` through ``paged_attention``) with the hand-written
CUDA kernel ``ray_tpu_torch/csrc/paged_attention.cu``: one thread block
per (lane, kv head) walks the lane's used pages through its block table,
copies each page's K/V rows into a ring of shared-memory buffers a few
pages ahead (``cp.async``) and carries an fp32 online softmax.  Decode
reads every used K/V byte once, so the kernel is bound by device-memory
bytes; at B * Hkv = 64 blocks it under-fills the 132 SMs of an H100,
which a split of the page loop across blocks would fix.

Layout: q [B, 1, H, D]; pools [T, Hkv, D] flat slot pools with
T = num_pages * page_size; block_tables [B, W] int32 physical page ids
(unused entries may point anywhere valid, e.g. the garbage page 0);
context_lens [B] int32 live tokens per lane (0 = inactive lane, output
is zeros).  The kernel takes D in {64, 128}, bfloat16 or float32.

On a CPU tensor :func:`paged_attention` computes the plain version
:func:`paged_attention_ref`; on a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build

LAUNCHES = 0

HEAD_DIMS = (64, 128)

_SOURCE = "paged_attention"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def load_kernel():
    """Build (at first use) and bind the kernel library."""
    return _build.function(_SOURCE, "rt_paged_attention", _ARGTYPES)


def paged_attention_ref(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, block_tables: torch.Tensor,
                        context_lens: torch.Tensor, *,
                        page_size: int) -> torch.Tensor:
    """The plain PyTorch version: per lane, gather the used slots
    through the block table and take an fp32 softmax over them."""
    b, _s, h, d = q.shape
    hkv = pool_k.shape[1]
    g = h // hkv
    w = block_tables.shape[1]
    out = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    lens = context_lens.tolist()
    for lane in range(b):
        n = min(int(lens[lane]), w * page_size)
        if n <= 0:
            continue
        pos = torch.arange(n, device=q.device)
        slots = (block_tables[lane, pos // page_size].long() * page_size
                 + pos % page_size)
        k = pool_k[slots].float()                      # [n, Hkv, D]
        v = pool_v[slots].float()
        qf = q[lane, 0].float().reshape(hkv, g, d)
        scores = torch.einsum("hgd,nhd->hgn", qf, k) / math.sqrt(d)
        probs = torch.softmax(scores, dim=-1)
        out[lane] = torch.einsum("hgn,nhd->hgd", probs, v).reshape(h, d)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _check(q, pool_k, pool_v, block_tables, context_lens, page_size):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_attention is decode-only: q must be "
                         f"[B, 1, H, D], got {tuple(q.shape)}")
    b, _s, h, d = q.shape
    if pool_k.dim() != 3 or pool_k.shape != pool_v.shape \
            or pool_k.shape[2] != d:
        raise ValueError(f"pools must both be [T, Hkv, {d}], got "
                         f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}")
    hkv = pool_k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if pool_k.shape[0] % page_size:
        raise ValueError("pool not page-aligned")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"q and pools must share one of bfloat16/float32, "
                        f"got {q.dtype}/{pool_k.dtype}/{pool_v.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(context_lens.shape) != (b,):
        raise ValueError("block_tables must be [B, W] and context_lens [B]")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (the kernel copies "
                         "16-byte vectors)")


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    page_size: int) -> torch.Tensor:
    """Single-token decode attention over paged KV pools.

    q: [B, 1, H, D] post-rope queries (the current token's k/v must
    already be written into the pools); positions < context_lens[b]
    attend.  Returns [B, 1, H, D] in q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, block_tables,
                                   context_lens, page_size=page_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, pool_k, pool_v, block_tables, context_lens, page_size)
    b, _s, h, d = q.shape
    hkv = pool_k.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), b, hkv, h // hkv, d, block_tables.shape[1],
                page_size, 1.0 / math.sqrt(d),
                int(q.dtype == torch.bfloat16), stream)
    _build.check(_SOURCE, rc, "paged_attention kernel")
    LAUNCHES += 1
    return out
