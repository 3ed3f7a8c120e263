"""Paged attention for single-token decode with GQA.

Replaces the Pallas TPU kernel ``ray_tpu/ops/paged_attention.py``
(``_paged_kernel`` through ``paged_attention``) with the hand-written
CUDA kernels of ``ray_tpu_torch/csrc/paged_attention.cu``, split-K over
the page loop: ``paged_decode_split_kernel`` runs one block per (lane,
kv head, span of ``SPLIT_ROWS`` positions), walks the span's pages
through the block table in 64-row tiles (``cp.async``) with an fp32
online softmax and writes an fp32 partial (unnormalised accumulator,
running max, denominator); ``paged_decode_merge_kernel`` combines a
lane's partials by the log-sum-exp rule.  The number of spans comes
from the table width alone, so the host never reads context lengths.
Decode reads every used K/V byte once, so the kernels are bound by
device-memory bytes.

Layout: q [B, 1, H, D]; pools [T, Hkv, D] flat slot pools with
T = num_pages * page_size; block_tables [B, W] int32 physical page ids
(unused entries may point anywhere valid, e.g. the garbage page 0);
context_lens [B] int32 live tokens per lane (0 = inactive lane, output
is zeros).  The kernels take D in {64, 128}, up to 8 query heads per kv
head, bfloat16 or float32.

On a CPU tensor :func:`paged_attention` computes the plain version
:func:`paged_attention_ref`; on a CUDA tensor it launches the kernels or
raises.  :func:`paged_partials_ref` and :func:`paged_merge_ref` are the
plain versions of the split and the merge.  ``LAUNCHES`` counts wrapper
calls that launched the kernels (one split and one merge launch each):
one per layer per decode step.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build

LAUNCHES = 0

HEAD_DIMS = (64, 128)
MAX_GROUP = 8      # query heads per kv head the split kernel unrolls
SPLIT_ROWS = 128   # positions per split block (a multiple of 64)

_SOURCE = "paged_attention"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def load_kernel():
    """Build (at first use) and bind the kernel library."""
    return _build.function(_SOURCE, "rt_paged_attention", _ARGTYPES)


def kernel_takes(head_dim: int, group: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernels take this shape: head_dim in
    :data:`HEAD_DIMS`, up to :data:`MAX_GROUP` query heads per kv head,
    bfloat16 or float32 (any page size).  The engine routes decode on
    it before any launch; the wrapper itself raises outside it."""
    return (head_dim in HEAD_DIMS and 1 <= group <= MAX_GROUP
            and dtype in (torch.bfloat16, torch.float32))


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


def n_splits(width: int, page_size: int) -> int:
    """Split blocks per (lane, kv head): from the table width alone."""
    return max(1, -(-width * page_size // SPLIT_ROWS))


def paged_partials_ref(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, block_tables: torch.Tensor,
                       context_lens: torch.Tensor, *, page_size: int,
                       start: int, stop: int):
    """The plain version of one split block: over positions
    [start, stop) of each lane's context, per query head, the fp32
    unnormalised accumulator [B, H, D], running max m [B, H] (natural
    log units) and denominator l [B, H].  A lane whose context does not
    reach ``start`` gets the empty partial (acc 0, m = -inf, l = 0)."""
    b, _s, h, d = q.shape
    hkv = pool_k.shape[1]
    g = h // hkv
    w = block_tables.shape[1]
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    lens = context_lens.tolist()
    for lane in range(b):
        hi = min(int(lens[lane]), w * page_size, stop)
        if hi <= start:
            continue
        pos = torch.arange(start, hi, device=q.device)
        slots = (block_tables[lane, pos // page_size].long() * page_size
                 + pos % page_size)
        k = pool_k[slots].float()                      # [n, Hkv, D]
        v = pool_v[slots].float()
        qf = q[lane, 0].float().reshape(hkv, g, d)
        scores = torch.einsum("hgd,nhd->hgn", qf, k) / math.sqrt(d)
        mx = scores.amax(dim=-1)                       # [Hkv, G]
        p = torch.exp(scores - mx[..., None])
        acc[lane] = torch.einsum("hgn,nhd->hgd", p, v).reshape(h, d)
        m[lane] = mx.reshape(h)
        l[lane] = p.sum(dim=-1).reshape(h)
    return acc, m, l


def paged_merge_ref(partials, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """The plain version of the merge: combine ``[(acc, m, l), ...]``
    from :func:`paged_partials_ref` by the log-sum-exp rule into
    [B, 1, H, D] in ``dtype``; a head with no used span gets zeros."""
    acc = torch.stack([p[0] for p in partials])        # [n, B, H, D]
    m = torch.stack([p[1] for p in partials])          # [n, B, H]
    l = torch.stack([p[2] for p in partials])
    mm = m.amax(dim=0)
    e = torch.where(torch.isinf(m), torch.zeros_like(m),
                    torch.exp(m - torch.where(torch.isinf(mm),
                                              torch.zeros_like(mm), mm)))
    num = (acc * e[..., None]).sum(dim=0)
    den = (l * e).sum(dim=0).clamp_min(1e-20)
    out = num / den[..., None]
    return out.unsqueeze(1).to(dtype)


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
    if not kernel_takes(d, h // hkv, q.dtype):
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS} and "
                         f"up to {MAX_GROUP} query heads per kv head, got "
                         f"head_dim {d}, {h // hkv} per kv head")
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
    width = block_tables.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    splits = n_splits(width, page_size)
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, h, splits, 2), dtype=torch.float32,
                          device=q.device)
    fn = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b,
                hkv, h // hkv, d, width, page_size, SPLIT_ROWS, splits,
                1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    _build.check(_SOURCE, rc, "paged_attention kernel")
    LAUNCHES += 1
    return out
