"""Ring attention: sequence-parallel attention over the mesh's "sp" group.

The port of ray_tpu/ops/ring_attention.py.  Each process of the sp group
holds one sequence block of Q, K and V.  The K/V block travels around the
ring (``batch_isend_irecv`` to rank ``(i + 1) % n`` of the group) while
the local Q block folds it in with an online softmax, so the whole
sequence never sits on one device.  Each exchange is started before the
block's compute and waited on after it.  As in the JAX package this is
no Pallas kernel: each block is dense PyTorch.

The JAX package differentiates ``lax.ppermute`` for free; torch's P2P
has no autograd, so the ring has a backward of its own.  The forward
saves the log-sum-exp of every query row; the backward rotates K/V once
more, recomputes each block's probabilities from that LSE, and sends a
dK/dV accumulator along with each K/V block, so after a full turn each
block's gradient is back home.

Under causal masking a block of keys wholly after the query block is
skipped: it adds exactly nothing to the online softmax.

GQA layout as in the model: q [B, S, H, D], k/v [B, S, Hkv, D], here the
LOCAL shards (the JAX function takes global arrays under ``shard_map``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

_NEG_INF = -1e30

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _mask(q_idx: int, kv_idx: int, s: int, t: int, causal: bool,
          device) -> Optional[torch.Tensor]:
    """[S, T] keep-mask of query block ``q_idx`` against key block
    ``kv_idx`` (equal-length blocks); None when every pair attends."""
    if not causal or kv_idx < q_idx:
        return None
    return torch.ones((s, t), dtype=torch.bool, device=device).tril()


def _skipped(q_idx: int, kv_idx: int, causal: bool) -> bool:
    return causal and kv_idx > q_idx


def init_carry(q: torch.Tensor, n_kv_heads: int) -> Carry:
    """(m, l, acc) before the first block: m/l [B, Hkv, G, S], acc
    [B, S, H, D], all fp32."""
    b, s, h, d = q.shape
    g = h // n_kv_heads
    m = torch.full((b, n_kv_heads, g, s), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    return (m, torch.zeros_like(m),
            torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device))


def block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_idx: int, kv_idx: int, causal: bool,
                 carry: Carry) -> Carry:
    """One online-softmax step over a K/V block (``_block_attend``):
    scores in fp32, P cast to v's dtype for the PV product."""
    if _skipped(q_idx, kv_idx, causal):
        return carry
    m, l, acc = carry
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float() \
        * (1.0 / math.sqrt(d))
    mask = _mask(q_idx, kv_idx, s, k.shape[1], causal, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhgst,bthd->bshgd", p.to(v.dtype), v).float()
    acc_new = acc * correction.permute(0, 3, 1, 2).reshape(b, s, h, 1) \
        + pv.reshape(b, s, h, d)
    return m_new, l_new, acc_new


def finish(carry: Carry, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, H, D] in ``dtype``, lse [B, Hkv, G, S] fp32)."""
    m, l, acc = carry
    b, s, h, _ = acc.shape
    l = l.clamp_min(1e-20)   # fully-masked rows (none under causal)
    out = acc / l.permute(0, 3, 1, 2).reshape(b, s, h, 1)
    return out.to(dtype), m + torch.log(l)


def block_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                d_out: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                q_idx: int, kv_idx: int, causal: bool
                ) -> Optional[Tuple[torch.Tensor, ...]]:
    """One block's share of (dq, dk, dv), fp32, with P recomputed from
    the forward's LSE; ``delta`` = rowsum(dO * O) [B, Hkv, G, S].  None
    for a block the causal mask skips."""
    if _skipped(q_idx, kv_idx, causal):
        return None
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, s, hkv, g, d)
    dog = d_out.float().reshape(b, s, hkv, g, d)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bshgd,bthd->bhgst", qg, kf) * scale
    p = torch.exp(logits - lse[..., None])
    mask = _mask(q_idx, kv_idx, s, k.shape[1], causal, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dv = torch.einsum("bhgst,bshgd->bthd", p, dog)
    dp = torch.einsum("bshgd,bthd->bhgst", dog, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhgst,bthd->bshgd", ds, kf).reshape(b, s, h, d)
    dk = torch.einsum("bhgst,bshgd->bthd", ds, qg)
    return dq, dk, dv


def row_delta(out: torch.Tensor, d_out: torch.Tensor,
              n_kv_heads: int) -> torch.Tensor:
    """rowsum(dO * O) as [B, Hkv, G, S], fp32."""
    b, s, h, _ = out.shape
    delta = (d_out.float() * out.float()).sum(-1)            # [B, S, H]
    return delta.reshape(b, s, n_kv_heads, h // n_kv_heads) \
        .permute(0, 2, 3, 1)


# ------------------------------------------------------- the ring itself


def _shift(x: torch.Tensor, group: dist.ProcessGroup
           ) -> Callable[[], torch.Tensor]:
    """Start sending ``x`` to the next rank of the ring and receiving
    the previous rank's; returns the wait that yields what arrived."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    buf = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (i + 1) % n),
                   group),
        dist.P2POp(dist.irecv, buf,
                   dist.get_global_rank(group, (i - 1) % n), group)])

    def wait() -> torch.Tensor:
        for r in reqs:
            r.wait()
        return buf
    return wait


def ring_forward(q, k, v, group, causal: bool):
    """``_ring_body``: -> (out, lse) of the local query block."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    kv = torch.stack((k, v))
    carry = init_carry(q, k.shape[2])
    for t in range(n):
        pending = _shift(kv, group) if t < n - 1 else None
        carry = block_attend(q, kv[0], kv[1], i, (i - t) % n, causal, carry)
        if pending is not None:
            kv = pending()
    return finish(carry, q.dtype)


def ring_backward(q, k, v, out, lse, d_out, group, causal: bool):
    """-> (dq, dk, dv) of the local blocks, in their dtypes.  Each K/V
    block's accumulator rides the ring one step behind it and is home
    after a full turn."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    delta = row_delta(out, d_out, k.shape[2])
    kv = torch.stack((k, v))
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    acc_wait = None
    for t in range(n):
        kv_wait = _shift(kv, group) if t < n - 1 else None
        grads = block_grads(q, kv[0], kv[1], d_out, lse, delta, i,
                            (i - t) % n, causal)
        if acc_wait is not None:
            acc = acc_wait()    # this block's accumulator, from upstream
        if grads is not None:
            dq += grads[0]
            acc[0] += grads[1]
            acc[1] += grads[2]
        acc_wait = _shift(acc, group)
        if kv_wait is not None:
            kv = kv_wait()
    dkv = acc_wait()
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = ring_forward(q, k, v, group, causal)
        ctx.group, ctx.causal = group, causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, d_out.contiguous(),
                                   ctx.group, ctx.causal)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "sp",
                   causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over the mesh's ``axis_name`` group.
    q/k/v are this process's blocks (batch over (dp, fsdp), sequence
    over sp, heads over tp already split); block i of the group holds
    positions [i·S, (i+1)·S).  At sp == 1 this is ``default_attention``
    (the flash kernel for long causal sequences), as in JAX."""
    if mesh.shape[axis_name] == 1:
        from ray_tpu_torch.models.llama import default_attention

        return default_attention(q, k, v, causal=causal)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention needs equal q and k/v blocks, "
                         f"got {q.shape[1]} and {k.shape[1]}")
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), mesh.group(axis_name),
                                causal)


def make_ring_attention(mesh, axis_name: str = "sp") -> Callable:
    """Attention-kernel hook for ``LlamaModel(kernel=...)``."""

    def kernel(q, k, v, causal: bool = True):
        return ring_attention(q, k, v, mesh, axis_name=axis_name,
                              causal=causal)

    return kernel


# ------------------------------------------- the ring on one device


def ring_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                n_blocks: int, causal: bool = True,
                d_out: Optional[torch.Tensor] = None):
    """The ring played out on one device: the sequence cut into
    ``n_blocks`` blocks, each step feeding every query block the K/V
    block that the ring would hand it, through the same
    :func:`block_attend` and :func:`block_grads` as the processes use,
    in the same order (dK/dV summed as their accumulators travel).
    Returns out, or (out, dq, dk, dv) when ``d_out`` is given."""
    def split(x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[1] % n_blocks:
            raise ValueError(f"sequence {x.shape[1]} does not split into "
                             f"{n_blocks} blocks")
        return list(x.chunk(n_blocks, dim=1))

    n = n_blocks
    qs, ks, vs = split(q), split(k), split(v)
    carries = [init_carry(qb, k.shape[2]) for qb in qs]
    for t in range(n):
        for i in range(n):
            j = (i - t) % n
            carries[i] = block_attend(qs[i], ks[j], vs[j], i, j, causal,
                                      carries[i])
    done = [finish(c, q.dtype) for c in carries]
    out = torch.cat([o for o, _ in done], dim=1)
    if d_out is None:
        return out
    dos = split(d_out)
    deltas = [row_delta(o, do, k.shape[2]) for (o, _), do in zip(done, dos)]
    dq = [torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
          for qb in qs]
    dk = [torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
          for kb in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for t in range(n):
        for i in range(n):
            j = (i - t) % n
            g = block_grads(qs[i], ks[j], vs[j], dos[i], done[i][1],
                            deltas[i], i, j, causal)
            if g is not None:
                dq[i] += g[0]
                dk[j] += g[1]
                dv[j] += g[2]
    return (out, torch.cat(dq, 1).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
            torch.cat(dv, 1).to(v.dtype))
