"""Llama-family decoder-only transformer in PyTorch.

The port of ray_tpu/models/llama.py, with the same math and the same
public functions:

  - compute in ``cfg.dtype`` (bfloat16 by default) with fp32 softmax,
    norms and rope angles; GQA attention with rotary embeddings that
    rotate halves, not interleaved pairs;
  - the no-cache forward routes long causal self-attention through the
    flash kernel (``default_attention``), and the cache forward writes
    post-rope K/V into flat per-layer slot pools and attends either
    through the paged decode kernel (block tables + context lengths) or
    the dense gather ``cached_attention`` (chunked prefill, dense decode).

The flax model keeps fp32 params and casts each kernel to ``cfg.dtype``
before its dot (and the embedding before its lookup).  By default this
module holds those weights in ``cfg.dtype`` once, which gives identical
forward numbers and is what serving wants.  Training passes
``param_dtype=torch.float32``: the linear and embedding weights are then
fp32 master weights, each cast to ``cfg.dtype`` before its product and
the embedding rows after their lookup, so the optimizer steps them in
fp32 as optax does.  The RMSNorm scales are fp32 either way, as flax
multiplies by them in fp32.
Pools are updated in place (``index_copy_``) where the JAX engine
donated them to jit.

Over a process group (``train.gspmd``), ``llama_param_rules`` is the
tensor-parallel plan; attention takes its head counts from its local
projections, the no-cache forward its positions from ``start_pos``,
and the loss of a sequence shard is ``lm_loss_sum`` over
``shifted_targets``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # recompute each block in the backward pass

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Test-size config."""
        return cls(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, hidden_dim=128, max_seq_len=128)

    @classmethod
    def small(cls) -> "LlamaConfig":
        """~110M params."""
        return cls(vocab_size=32000, dim=768, n_layers=12, n_heads=12,
                   n_kv_heads=4, hidden_dim=2048, max_seq_len=2048)

    @classmethod
    def bench_1b(cls) -> "LlamaConfig":
        """~600M params; every matmul dim a multiple of 128."""
        return cls(vocab_size=32000, dim=1536, n_layers=20, n_heads=12,
                   n_kv_heads=4, hidden_dim=4096, max_seq_len=2048)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, hidden_dim=14336, max_seq_len=8192)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        embed = self.vocab_size * self.dim
        per_layer = (
            self.dim * self.n_heads * self.head_dim          # wq
            + 2 * self.dim * self.n_kv_heads * self.head_dim  # wk, wv
            + self.n_heads * self.head_dim * self.dim         # wo
            + 3 * self.dim * self.hidden_dim                  # w1, w2, w3
            + 2 * self.dim                                    # norms
        )
        return embed * 2 + per_layer * self.n_layers + self.dim


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary position embedding over the last dim. x: [B, S, H, D]."""
    half = x.shape[-1] // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * freqs      # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# Self-attention prefills at or above this length route through the flash
# kernel instead of materializing the [S, S] score matrix.  Module-level
# so tests can lower it; sequences must also be a multiple of 128.
FLASH_PREFILL_MIN_SEQ = 512


def default_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Dense attention, or the flash kernel for long causal
    self-attention (>= FLASH_PREFILL_MIN_SEQ, multiple of 128).
    q: [B,S,H,D], k/v: [B,S,Hkv,D]."""
    s, t = q.shape[1], k.shape[1]
    if (causal and s == t and s >= FLASH_PREFILL_MIN_SEQ
            and s % 128 == 0):
        from ray_tpu_torch.ops import flash_attention as fa

        return fa.flash_attention(q, k, v, True)
    return dense_attention(q, k, v, causal)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The dense softmax-attention math itself: scores upcast to fp32,
    scaled by 1/sqrt(d), masked with -1e30, and the probabilities cast
    to v's dtype before the PV product."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    q5 = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", q5, k).float()
    logits = logits / math.sqrt(d)
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, h, d)


def cached_attention(q: torch.Tensor, pool_k: torch.Tensor,
                     pool_v: torch.Tensor, ctx: torch.Tensor,
                     ctx_pos: torch.Tensor, ctx_mask: torch.Tensor,
                     q_pos: torch.Tensor) -> torch.Tensor:
    """Attention over a slot-pool KV cache.

    q: [B,S,H,D] (post-rope); pools [T,Hkv,D] (already holding this
    call's keys/values); ctx: [B,L] physical slot of each context entry
    (garbage entries point at slot 0); ctx_pos: [B,L] the position each
    entry holds; ctx_mask: [B,L] validity; q_pos: [B,S].  Causality is a
    position mask, so one function serves chunked prefill and decode."""
    b, s, h, d = q.shape
    hkv = pool_k.shape[1]
    length = ctx.shape[1]
    idx = ctx.reshape(-1).long()   # torch indexes with int64
    ck = pool_k[idx].reshape(b, length, hkv, d)
    cv = pool_v[idx].reshape(b, length, hkv, d)
    q5 = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bshgd,blhd->bhgsl", q5, ck).float()
    logits = logits / math.sqrt(d)
    mask = (ctx_pos[:, None, :] <= q_pos[:, :, None]) \
        & ctx_mask[:, None, :]                      # [B,S,L]
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype)
    out = torch.einsum("bhgsl,blhd->bshgd", probs, cv)
    return out.reshape(b, s, h, d)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class Linear(nn.Linear):
    """A bias-free ``nn.Linear`` that computes in ``dtype``.  A weight
    held in another dtype (``param_dtype``, fp32 master weights) is cast
    before the product, as flax casts each kernel before its dot; a
    weight held in ``dtype`` is used as it is."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(n_in, n_out, bias=False,
                         dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if w.dtype != self.compute_dtype:
            w = w.to(self.compute_dtype)
        return F.linear(x, w)


def _linear(cfg: LlamaConfig, n_in: int, n_out: int, device,
            param_dtype: Optional[torch.dtype]) -> Linear:
    return Linear(n_in, n_out, cfg.dtype, param_dtype, device)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, kernel: Optional[Callable] = None,
                 page_size: int = 0, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.kernel = kernel        # pluggable attention (flash/ring)
        self.page_size = page_size  # > 0 enables the paged decode kernel
        hd = cfg.head_dim
        self.wq = _linear(cfg, cfg.dim, cfg.n_heads * hd, device, param_dtype)
        self.wk = _linear(cfg, cfg.dim, cfg.n_kv_heads * hd, device,
                          param_dtype)
        self.wv = _linear(cfg, cfg.dim, cfg.n_kv_heads * hd, device,
                          param_dtype)
        self.wo = _linear(cfg, cfg.n_heads * hd, cfg.dim, device, param_dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        # head counts from the projections: under tensor parallelism a
        # process holds n_heads / tp and n_kv_heads / tp of them
        q = _rope(self.wq(x).view(b, s, -1, hd), positions, cfg.rope_theta)
        k = _rope(self.wk(x).view(b, s, -1, hd), positions, cfg.rope_theta)
        v = self.wv(x).view(b, s, -1, hd)
        hkv = k.shape[2]
        if cache is not None:
            # incremental path: write post-rope k/v into this layer's
            # flat slot pools in place, attend over the context.  Slot 0
            # is the engine's garbage slot: inactive lanes and prefill
            # padding all write there, so the index holds duplicates.
            # index_copy_ with duplicate indices is nondeterministic on
            # CUDA, which is harmless only because slot 0 is masked out
            # of every context.
            flat = cache["slots"].reshape(-1)
            pool_k, pool_v = cache["k"], cache["v"]
            pool_k.index_copy_(0, flat, k.reshape(b * s, hkv, hd))
            pool_v.index_copy_(0, flat, v.reshape(b * s, hkv, hd))
            if cache.get("block_tables") is not None and s == 1 \
                    and self.page_size > 0:
                from ray_tpu_torch.ops import paged_attention as pa

                out = pa.paged_attention(q, pool_k, pool_v,
                                         cache["block_tables"],
                                         cache["context_lens"],
                                         page_size=self.page_size)
            else:
                out = cached_attention(q, pool_k, pool_v, cache["ctx"],
                                       cache["ctx_pos"], cache["ctx_mask"],
                                       positions)
        else:
            out = (self.kernel or default_attention)(q, k, v)
        return self.wo(out.reshape(b, s, -1))


class Mlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.w1 = _linear(cfg, cfg.dim, cfg.hidden_dim, device, param_dtype)
        self.w3 = _linear(cfg, cfg.dim, cfg.hidden_dim, device, param_dtype)
        self.w2 = _linear(cfg, cfg.hidden_dim, cfg.dim, device, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, kernel: Optional[Callable] = None,
                 page_size: int = 0, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attn = Attention(cfg, kernel, page_size, device, param_dtype)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.mlp = Mlp(cfg, device, param_dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions, cache)
        return x + self.mlp(self.mlp_norm(x))


class LlamaModel(nn.Module):
    """The decoder.  ``seed`` initializes the weights with flax's scales
    from a ``torch.Generator`` on the model's device; ``seed=None``
    leaves them uninitialized for a caller that loads a state_dict
    (e.g. from ``models.convert.params_from_flax``).  ``param_dtype``
    holds the linear and embedding weights in that dtype (fp32 master
    weights for training) while computing in ``cfg.dtype``; None holds
    them in ``cfg.dtype``."""

    def __init__(self, cfg: LlamaConfig, kernel: Optional[Callable] = None,
                 page_size: int = 0, device: DeviceLike = None,
                 seed: Optional[int] = 0,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        # build on the meta device and allocate once: the default
        # nn.Linear init would otherwise run over every weight first
        meta = torch.device("meta")
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim,
                                  dtype=param_dtype or cfg.dtype, device=meta)
        self.layers = nn.ModuleList(
            Block(cfg, kernel, page_size, meta, param_dtype)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, meta)
        self.lm_head = _linear(cfg, cfg.dim, cfg.vocab_size, meta,
                               param_dtype)
        self.to_empty(device=dev)
        if seed is not None:
            self.init_weights(torch.Generator(dev).manual_seed(int(seed)))

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: dense kernels lecun-normal (normal with
        variance 1/fan_in truncated at two of its untruncated standard
        deviations), the embedding normal with std 1/sqrt(dim), norm
        scales ones.  Drawn in fp32, then cast to the weights' dtype."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                w = torch.empty(mod.weight.shape, dtype=torch.float32,
                                device=mod.weight.device)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
            elif isinstance(mod, nn.Embedding):
                w = torch.empty(mod.weight.shape, dtype=torch.float32,
                                device=mod.weight.device)
                nn.init.normal_(w, 0.0, 1.0 / math.sqrt(mod.embedding_dim),
                                generator=generator)
                mod.weight.copy_(w)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)

    def forward(self, tokens: torch.Tensor,
                cache: Optional[Dict[str, Any]] = None, start_pos: int = 0):
        """No cache: tokens [B, S] -> logits [B, S, V], the tokens at
        positions ``start_pos`` on (a sequence shard of sp rank i starts
        at i·S; rope needs the global positions).  With a cache
        (``k``/``v`` lists of per-layer pools, ``slots``, ``q_pos`` and
        either ``block_tables``/``context_lens`` or ``ctx``/``ctx_pos``/
        ``ctx_mask``): -> (logits, pools), the pools updated in place."""
        cfg = self.cfg
        # rows looked up in the stored dtype, then cast: the same values
        # as flax's cast of the whole table, without a copy of the table
        x = self.embed(tokens).to(cfg.dtype)
        if cache is not None:
            positions = cache["q_pos"]
            paged = cache.get("block_tables") is not None
            for i, layer in enumerate(self.layers):
                layer_cache = {"k": cache["k"][i], "v": cache["v"][i],
                               "slots": cache["slots"]}
                if paged:
                    layer_cache["block_tables"] = cache["block_tables"]
                    layer_cache["context_lens"] = cache["context_lens"]
                else:
                    layer_cache.update(ctx=cache["ctx"],
                                       ctx_pos=cache["ctx_pos"],
                                       ctx_mask=cache["ctx_mask"])
                x = layer(x, positions, layer_cache)
            logits = self.lm_head(self.final_norm(x))
            return logits, {"k": cache["k"], "v": cache["v"]}
        positions = torch.arange(start_pos, start_pos + tokens.shape[1],
                                 device=tokens.device,
                                 dtype=torch.int32).expand(tokens.shape)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions)
        return self.lm_head(self.final_norm(x))


def make_kv_pools(cfg: LlamaConfig, num_slots: int, dtype: Any = None,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Allocate flat per-layer KV slot pools [num_slots, Hkv, D].

    ``num_slots`` = pages x page_size; slot 0 is the garbage slot for
    inactive batch lanes (the engine never hands it to a sequence)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (num_slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(cfg.n_layers)]}


def _index(slots: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(slots, np.int64), device=device)


def _host_rows(rows: Any) -> torch.Tensor:
    """A host tensor from exported rows: a torch tensor, or a numpy
    array (including the ml_dtypes bfloat16 arrays the JAX engine
    exports, which torch.from_numpy cannot read directly)."""
    if isinstance(rows, torch.Tensor):
        return rows
    arr = np.array(rows)  # a writable copy: torch refuses read-only arrays
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def gather_kv_slots(pools: Dict[str, Any], slots: Any) -> Dict[str, Any]:
    """Read the KV rows at ``slots`` out of every layer's pool as host
    (CPU) tensors — the export half of KV-page shipping."""
    out = {}
    for side in ("k", "v"):
        idx = _index(slots, pools[side][0].device)
        out[side] = [p.index_select(0, idx).cpu() for p in pools[side]]
    return out


def scatter_kv_slots(pools: Dict[str, Any], slots: Any,
                     rows: Dict[str, Any]) -> Dict[str, Any]:
    """Write previously-gathered KV rows into ``slots`` of every layer's
    pool, in place (the import half of KV-page shipping).  Returns the
    pools."""
    for side in ("k", "v"):
        idx = _index(slots, pools[side][0].device)
        for p, r in zip(pools[side], rows[side]):
            p.index_copy_(0, idx, _host_rows(r).to(p.device, p.dtype))
    return pools


def copy_kv_slots(pools: Dict[str, Any], src_slots: Any,
                  dst_slots: Any) -> Dict[str, Any]:
    """Copy KV rows ``src_slots`` -> ``dst_slots`` within every layer's
    pool, in place — the copy-on-write split.  Returns the pools."""
    for side in ("k", "v"):
        dev = pools[side][0].device
        src, dst = _index(src_slots, dev), _index(dst_slots, dev)
        for p in pools[side]:
            p.index_copy_(0, dst, p.index_select(0, src))
    return pools


def kv_pool_bytes(cfg: LlamaConfig, num_slots: int) -> int:
    """Resident bytes of one replica's KV pools (both k and v)."""
    return (2 * cfg.n_layers * num_slots * cfg.n_kv_heads
            * cfg.head_dim * cfg.dtype.itemsize)


def llama_param_rules() -> Dict[str, Any]:
    """The tensor-parallel plan (``parallelize_module``) by module path,
    the counterpart of the JAX package's PartitionSpec rules.  Flax
    kernels are [in, out]; ``nn.Linear.weight`` is [out, in], so "tp on
    the out dim" is dim 0 here.  Each entry and the JAX spec it stands
    for (the tp part; fsdp is FSDP2's, below):

      embed          RowwiseParallel: the table [V, dim] split over the
                     vocabulary, each id looked up where it lives and
                     the rows summed   <- ``P("tp", "fsdp")``
      attn.wq/wk/wv  ColwiseParallel: weight dim 0 (heads) over tp, so a
                     process holds n_heads/tp and n_kv_heads/tp heads
                                       <- ``P("fsdp", "tp", None)``
      attn.wo        RowwiseParallel: weight dim 1 (heads) over tp, the
                     partial outputs all-reduced   <- ``P("tp", None,
                     "fsdp")``
      mlp.w1/w3      ColwiseParallel: the hidden dim over tp
                                       <- ``P("fsdp", "tp")``
      mlp.w2         RowwiseParallel   <- ``P("tp", "fsdp")``
      lm_head        ColwiseParallel over the vocabulary, the logits
                     gathered whole for the loss   <- ``P("fsdp", "tp")``
      norms          not listed: replicated   <- ``P(None)``

    FSDP2 then shards dim 0 of each (local) weight over fsdp where JAX
    shards the other big dim: the values are the same, only their
    memory layout differs, so the two compare by value."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel)

    return {
        "embed": RowwiseParallel(input_layouts=Replicate()),
        "layers.*.attn.wq": ColwiseParallel(),
        "layers.*.attn.wk": ColwiseParallel(),
        "layers.*.attn.wv": ColwiseParallel(),
        "layers.*.attn.wo": RowwiseParallel(),
        "layers.*.mlp.w1": ColwiseParallel(),
        "layers.*.mlp.w3": ColwiseParallel(),
        "layers.*.mlp.w2": RowwiseParallel(),
        "lm_head": ColwiseParallel(output_layouts=Replicate()),
    }


def lm_loss_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross entropy of ``logits`` [B, S, V] against
    ``targets`` [B, S], upcast to fp32 only here; a target of -1 (past
    the end of the sequence) counts nothing."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets.clamp_min(0).long()[..., None])
    return torch.where(targets >= 0, lse - picked[..., 0], 0.0).sum()


def shifted_targets(tokens: Any) -> Any:
    """Each position's next token, -1 after the last: [B, S] like
    ``tokens``, so a sequence shard's targets are the same slice of it
    (the last position of shard i looks up the first token of shard
    i + 1)."""
    if isinstance(tokens, torch.Tensor):
        return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                         dim=1)
    tokens = np.asarray(tokens)
    return np.concatenate(
        [tokens[:, 1:], np.full_like(tokens[:, :1], -1)], axis=1)


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy with shifted targets, upcast to fp32
    only here."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - picked).mean()
