"""Flash attention (forward) with GQA and causal masking.

Replaces the Pallas TPU kernel ``ray_tpu/ops/flash_attention.py``
(``_flash_kernel`` through ``_flash_forward`` and the ``flash_attention``
custom_vjp) with the hand-written CUDA kernels of
``ray_tpu_torch/csrc/flash_attention.cu``.  bf16 runs on the tensor
cores: one warp-specialised block per (128-row query tile, head, batch),
a producer warp streaming K/V tiles with TMA through an mbarrier ring
and two consumer warpgroups running both products on ``wgmma`` with an
fp32 online softmax in registers.  fp32 keeps the CUDA-core kernel
(``wgmma`` would take fp32 only as TF32).  Both stop at the diagonal
tile for causal attention.

The bf16 kernel rounds the probabilities P to bf16 on their way into
the P.V product; :func:`p_rounding_allowance` bounds what that costs.

The backward is not a kernel, as in the reference: it recomputes through
the port's ``dense_attention``.

Layout: q [B, S, H, D]; k/v [B, T, Hkv, D] (GQA groups = H // Hkv).  The
kernels take D in {64, 128} and S, T multiples of 64, in bfloat16 or
float32, with 16-byte aligned data pointers (TMA's rule; the wrapper
raises rather than copy); the output is in q's dtype.

On CPU tensors :func:`flash_attention` computes the plain version
:func:`flash_attention_ref`; on CUDA tensors it launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build

LAUNCHES = 0

TILE = 64          # query rows per block and kv rows per tile
HEAD_DIMS = (64, 128)

_SOURCE = "flash_attention"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def load_kernel():
    """Build (at first use) and bind the kernel library."""
    return _build.function(_SOURCE, "rt_flash_attention", _ARGTYPES)


def _probs(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 softmax(q k^T / sqrt(D)) as [B, Hkv, G, S, T]."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qf, k.float()) / math.sqrt(d)
    if causal:
        keep = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    return torch.softmax(scores, dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function, as the JAX
    kernel computes it: fp32 scores, softmax and probabilities, output
    cast to q's dtype.  (The bf16 CUDA kernel rounds P to bf16 before
    P.V; see :func:`p_rounding_allowance`.)"""
    b, s, h, d = q.shape
    probs = _probs(q, k, causal)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def p_rounding_allowance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Per output element, a bound on what rounding P to bf16 moves it:
    2^-8 * (softmax(S) . |V|), from the plain version's fp32 softmax.
    Each p moves by at most 2^-8 of itself (half a bf16 step), weighted
    by the |v| it multiplies.  [B, S, H, D] fp32."""
    b, s, h, d = q.shape
    probs = _probs(q, k, causal)
    mag = torch.einsum("bhgst,bthd->bshgd", probs, v.float().abs())
    return mag.reshape(b, s, h, d) * 2.0 ** -8


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,S,H,D] and k/v [B,T,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         f"do not pair up")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if s % TILE or t % TILE:
        raise ValueError(f"flash kernel needs S ({s}) and T ({t}) to be "
                         f"multiples of {TILE}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of bfloat16/float32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"loads tiles with TMA)")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """The forward alone: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    fn = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, k.shape[1], h, k.shape[2], d, 1.0 / math.sqrt(d),
                int(bool(causal)), int(q.dtype == torch.bfloat16), stream)
    _build.check(_SOURCE, rc, "flash_attention kernel")
    LAUNCHES += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; the backward recomputes through dense_attention
    (not default_attention, which would route long sequences back here)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g_out):
        from ray_tpu_torch.models.llama import dense_attention

        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(need) for x, need
                      in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = dense_attention(*inputs, causal=ctx.causal)
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g_out))
        return (*(next(grads) if x.requires_grad else None
                  for x in inputs), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention with a dense-recompute backward."""
    return _FlashAttention.apply(q, k, v, causal)
