"""Parity of the port's attention ops (ray_tpu_torch/ops) with ray_tpu's.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, as tests/test_ops.py and tests/test_paged_attention.py
run them on the CPU) and through the port on CPU tensors, where each
wrapper computes its kernel's plain PyTorch version.  The CUDA kernels
themselves run only on a GPU: tests/test_torch_gpu.py holds them against
the plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import force_cpu_jax

from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import paged_attention as tpa

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

# fp32 parity: the same math in another summation order
RTOL = ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ paged decode


def _rand_paged_case(rng, batch, ctx_lens, n_heads, n_kv_heads, head_dim,
                     page_size, num_pages):
    """Random pools + a shuffled page assignment per lane (page 0 is the
    garbage page, never assigned), as numpy arrays."""
    t = num_pages * page_size
    pool_k = rng.normal(size=(t, n_kv_heads, head_dim)).astype(np.float32)
    pool_v = rng.normal(size=(t, n_kv_heads, head_dim)).astype(np.float32)
    q = rng.normal(size=(batch, 1, n_heads, head_dim)).astype(np.float32)
    used = [-(-c // page_size) for c in ctx_lens]
    width = max(max(used), 1)
    assert sum(used) <= num_pages - 1, "case needs more pages"
    pages = list(rng.permutation(np.arange(1, num_pages)))
    bt = np.zeros((batch, width), np.int32)
    for b in range(batch):
        for p in range(used[b]):
            bt[b, p] = pages.pop()
    return q, pool_k, pool_v, bt, np.asarray(ctx_lens, np.int32)


def _dense_arrays(bt, ctx_lens, page_size):
    batch = bt.shape[0]
    length = bt.shape[1] * page_size
    ctx = np.zeros((batch, length), np.int32)
    ctx_pos = np.zeros((batch, length), np.int32)
    ctx_mask = np.zeros((batch, length), bool)
    for b in range(batch):
        for pos in range(int(ctx_lens[b])):
            ctx[b, pos] = bt[b, pos // page_size] * page_size \
                + pos % page_size
            ctx_pos[b, pos] = pos
            ctx_mask[b, pos] = True
    q_pos = np.maximum(ctx_lens.astype(np.int32) - 1, 0)[:, None]
    return ctx, ctx_pos, ctx_mask, q_pos


def _jax_paged(q, pk, pv, bt, cl, page_size):
    from ray_tpu.ops.paged_attention import paged_attention

    return np.asarray(paged_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(cl), page_size=page_size))


def _jax_dense(q, pk, pv, bt, cl, page_size):
    from ray_tpu.models.llama import cached_attention

    ctx, ctx_pos, ctx_mask, q_pos = _dense_arrays(bt, cl, page_size)
    return np.asarray(cached_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(ctx),
        jnp.asarray(ctx_pos), jnp.asarray(ctx_mask), jnp.asarray(q_pos)))


def _port_paged(q, pk, pv, bt, cl, page_size):
    before = tpa.LAUNCHES
    out = tpa.paged_attention(_t(q), _t(pk), _t(pv), _t(bt), _t(cl),
                              page_size=page_size)
    assert tpa.LAUNCHES == before, "a CPU tensor must not launch the kernel"
    return out.numpy()


@pytest.mark.parametrize("batch,ctx_lens,heads,kv_heads,page_size", [
    (1, [1], 4, 2, 8),                 # single token, single lane
    (2, [5, 16], 4, 4, 8),             # MHA (group=1), page-exact length
    (3, [13, 1, 9], 4, 2, 4),          # GQA group=2, ragged
    (4, [31, 8, 17, 2], 8, 2, 8),      # GQA group=4, multi-page ragged
    (2, [7, 23], 4, 2, 16),            # bigger pages than one context
])
def test_paged_ref_matches_jax_kernel_and_dense(batch, ctx_lens, heads,
                                                kv_heads, page_size):
    rng = np.random.default_rng(batch * 100 + heads * 10 + page_size)
    case = _rand_paged_case(rng, batch, ctx_lens, heads, kv_heads,
                            head_dim=16, page_size=page_size, num_pages=24)
    out = _port_paged(*case, page_size)
    np.testing.assert_allclose(out, _jax_paged(*case, page_size),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _jax_dense(*case, page_size),
                               rtol=RTOL, atol=ATOL)


def test_paged_ref_garbage_lanes_are_zero():
    """Inactive lanes (context length 0) give finite zeros, never NaN,
    while live lanes stay exact."""
    rng = np.random.default_rng(7)
    case = _rand_paged_case(rng, 4, [11, 0, 3, 0], 4, 2, head_dim=8,
                            page_size=4, num_pages=16)
    out = _port_paged(*case, 4)
    assert np.all(np.isfinite(out))
    assert np.all(out[1] == 0) and np.all(out[3] == 0)
    np.testing.assert_allclose(out, _jax_paged(*case, 4), rtol=RTOL,
                               atol=ATOL)


def test_paged_ref_all_garbage_batch_is_zero():
    rng = np.random.default_rng(11)
    case = _rand_paged_case(rng, 3, [0, 0, 0], 4, 2, head_dim=8,
                            page_size=8, num_pages=8)
    out = _port_paged(*case, 8)
    assert np.all(out == 0)
    np.testing.assert_array_equal(out, _jax_paged(*case, 8))


def test_paged_ref_wide_table():
    """Trailing table entries past a lane's used pages (the engine's
    bucketed width) must not perturb the result."""
    rng = np.random.default_rng(3)
    q, pk, pv, bt, cl = _rand_paged_case(rng, 2, [9, 4], 4, 2, head_dim=16,
                                         page_size=4, num_pages=16)
    wide = np.zeros((2, 8), np.int32)
    wide[:, :bt.shape[1]] = bt
    ref = _jax_paged(q, pk, pv, bt, cl, 4)
    np.testing.assert_allclose(_port_paged(q, pk, pv, wide, cl, 4), ref,
                               rtol=RTOL, atol=ATOL)


def test_paged_ref_shared_pages_between_lanes():
    """Two lanes whose tables alias the SAME physical pages each read
    the shared KV (prefix sharing is invisible to the kernel)."""
    rng = np.random.default_rng(5)
    q, pk, pv, bt, cl = _rand_paged_case(rng, 2, [12, 12], 4, 2,
                                         head_dim=8, page_size=4,
                                         num_pages=16)
    bt[1] = bt[0]
    out = _port_paged(q, pk, pv, bt, cl, 4)
    np.testing.assert_allclose(out, _jax_dense(q, pk, pv, bt, cl, 4),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _jax_paged(q, pk, pv, bt, cl, 4),
                               rtol=RTOL, atol=ATOL)


def test_paged_ref_bf16_within_one_rounding():
    """bf16 inputs: the plain version computes in fp32 from the same
    bf16 values and rounds once, so it sits within a bf16 rounding of
    the fp32 result on those values."""
    rng = np.random.default_rng(9)
    q, pk, pv, bt, cl = _rand_paged_case(rng, 3, [13, 1, 9], 4, 2,
                                         head_dim=16, page_size=4,
                                         num_pages=24)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, pk, pv))
    out = tpa.paged_attention(qb, kb, vb, _t(bt), _t(cl), page_size=4)
    assert out.dtype == torch.bfloat16
    ref = _jax_paged(qb.float().numpy(), kb.float().numpy(),
                     vb.float().numpy(), bt, cl, 4)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("span_pages,ctx_lens,alias", [
    (1, [5, 16, 0, 13], False),    # spans of one page; a lane at ctx 0
    (3, [31, 8, 24, 2], False),    # several pages; 24 ends on a span edge
    (16, [9, 4, 0, 3], False),     # one span wider than every context
    (2, [16, 16, 7, 0], True),     # lanes 0 and 1 alias their pages
])
def test_paged_split_merge_matches_ref_and_jax(span_pages, ctx_lens, alias):
    """The split kernel's plain version over page spans, merged by the
    merge's plain version, equals the unsplit plain version and the JAX
    kernel (interpret mode) in fp32; a lane with context 0 is exactly
    zero."""
    page_size = 4
    rng = np.random.default_rng(span_pages * 10 + len(ctx_lens))
    q, pk, pv, bt, cl = _rand_paged_case(rng, len(ctx_lens), ctx_lens, 8, 2,
                                         head_dim=16, page_size=page_size,
                                         num_pages=32)
    if alias:
        bt[1] = bt[0]
    span = span_pages * page_size
    total = bt.shape[1] * page_size
    args = (_t(q), _t(pk), _t(pv), _t(bt), _t(cl))
    parts = [tpa.paged_partials_ref(*args, page_size=page_size, start=lo,
                                    stop=lo + span)
             for lo in range(0, total, span)]
    out = tpa.paged_merge_ref(parts).numpy()
    np.testing.assert_allclose(out, _port_paged(q, pk, pv, bt, cl, page_size),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _jax_paged(q, pk, pv, bt, cl, page_size),
                               rtol=RTOL, atol=ATOL)
    for lane, n in enumerate(ctx_lens):
        if n == 0:
            assert np.all(out[lane] == 0)


@pytest.mark.parametrize("bad,exc", [
    (None, None),
    ("q_seq", ValueError), ("pool_shape", ValueError),
    ("heads", ValueError), ("page_align", ValueError),
    ("dtype", TypeError), ("index_dtype", TypeError),
    ("table_rows", ValueError), ("contiguous", ValueError),
    ("head_dim", ValueError), ("misaligned", ValueError),
    ("group", ValueError),
])
def test_paged_wrapper_checks(bad, exc):
    """What the kernel does not take is refused before any launch."""
    d = 64
    q = torch.zeros(2, 1, 4, d)
    pk = torch.zeros(16, 2, d)
    pv = torch.zeros(16, 2, d)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    cl = torch.zeros(2, dtype=torch.int32)
    ps = 4
    if bad == "q_seq":
        q = torch.zeros(2, 3, 4, d)
    elif bad == "pool_shape":
        pv = torch.zeros(16, 2, 32)
    elif bad == "heads":
        q = torch.zeros(2, 1, 3, d)
    elif bad == "page_align":
        ps = 5
    elif bad == "dtype":
        q = q.half()
    elif bad == "index_dtype":
        cl = cl.long()
    elif bad == "table_rows":
        bt = torch.zeros(3, 2, dtype=torch.int32)
    elif bad == "contiguous":
        pk = torch.zeros(16, d, 2).transpose(1, 2)
    elif bad == "head_dim":
        q, pk, pv = q[..., :16].clone(), pk[..., :16].clone(), \
            pv[..., :16].clone()
    elif bad == "misaligned":
        pk = torch.zeros(16 * 2 * d + 1)[1:].view(16, 2, d)
    elif bad == "group":
        q = torch.zeros(2, 1, 18, d)    # 9 query heads per kv head
    if exc is None:
        tpa._check(q, pk, pv, bt, cl, ps)
        return
    with pytest.raises(exc):
        tpa._check(q, pk, pv, bt, cl, ps)


def test_paged_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 2, 8, device="meta")
    pool = torch.zeros(8, 1, 8, device="meta")
    idx = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.paged_attention(q, pool, pool, idx, idx[0], page_size=4)


# ------------------------------------------------------------- flash prefill


def _qkv(b=2, s=64, h=4, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_jax_flash_and_dense(causal):
    from ray_tpu.models.llama import dense_attention
    from ray_tpu.ops.flash_attention import flash_attention

    q, k, v = _qkv(s=128, d=64)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    before = tfa.LAUNCHES
    out = tfa.flash_attention(_t(q), _t(k), _t(v), causal).numpy()
    assert tfa.LAUNCHES == before
    np.testing.assert_allclose(
        out, np.asarray(flash_attention(jq, jk, jv, causal, 32, 32, True)),
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        out, np.asarray(dense_attention(jq, jk, jv, causal=causal)),
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        out, tfa.flash_attention_ref(_t(q), _t(k), _t(v), causal).numpy(),
        atol=0, rtol=0)


def test_flash_autograd_matches_jax_grads():
    """The autograd Function's dense-recompute backward gives the grads
    of JAX's custom_vjp, for q, k and v."""
    import jax

    from ray_tpu.ops.flash_attention import flash_attention

    q, k, v = _qkv(s=64, d=32, seed=1)
    w = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        return (flash_attention(q, k, v, True, 32, 32, True) * w).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, True) * _t(w)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=2e-4)


def test_flash_autograd_only_requested_grads():
    q, k, v = (_t(x) for x in _qkv(s=64, d=16, seed=3))
    q.requires_grad_()
    tfa.flash_attention(q, k, v, True).sum().backward()
    assert q.grad is not None and k.grad is None and v.grad is None


@pytest.mark.parametrize("causal", [True, False])
def test_flash_p_rounding_allowance_bounds_bf16_p(causal):
    """Rounding P to bf16 before P.V (as the bf16 kernel does) moves each
    output by no more than p_rounding_allowance."""
    q, k, v = (_t(x) for x in _qkv(s=128, d=64, seed=4))
    probs = tfa._probs(q, k, causal)
    b, s, h, d = q.shape
    rounded = torch.einsum("bhgst,bthd->bshgd",
                           probs.bfloat16().float(), v).reshape(b, s, h, d)
    exact = tfa.flash_attention_ref(q, k, v, causal)
    allow = tfa.p_rounding_allowance(q, k, v, causal)
    err = (rounded - exact).abs()
    assert bool((err <= allow + 1e-6).all())
    assert float(err.max()) > 0   # the rounding is real, not a no-op


@pytest.mark.parametrize("shape,exc", [
    ((2, 64, 4, 2, 48), ValueError),    # head_dim outside {64, 128}
    ((2, 96, 4, 2, 64), ValueError),    # S not a multiple of the tile
    ((2, 64, 3, 2, 64), ValueError),    # heads do not group
])
def test_flash_wrapper_checks(shape, exc):
    b, s, h, hkv, d = shape
    q = torch.zeros(b, s, h, d)
    kv = torch.zeros(b, s, hkv, d)
    with pytest.raises(exc):
        tfa._check(q, kv, kv)


def test_flash_wrapper_checks_dtype():
    q = torch.zeros(1, 64, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa._check(q, q, q)


# ---------------------------------------------------- default_attention


def test_default_attention_routes_long_prefill_through_flash(monkeypatch):
    """At or above FLASH_PREFILL_MIN_SEQ (and a multiple of 128),
    default_attention goes through flash_attention and agrees with the
    dense math it replaces; the grad runs through the dense-recompute
    backward without re-entering the routing."""
    calls = []
    real = tfa.flash_attention

    def spy(q, k, v, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    monkeypatch.setattr(tllama, "FLASH_PREFILL_MIN_SEQ", 128)
    q, k, v = (_t(x) for x in _qkv(s=128, d=32))
    routed = tllama.default_attention(q, k, v, causal=True)
    assert calls == [tuple(q.shape)]
    dense = tllama.dense_attention(q, k, v, causal=True)
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)
    qg = q.clone().requires_grad_()
    tllama.default_attention(qg, k, v).sum().backward()
    assert len(calls) == 2 and torch.isfinite(qg.grad).all()


def test_default_attention_short_or_unaligned_stays_dense(monkeypatch):
    """Below the threshold, non-causal, or non-128-multiple sequences
    keep the dense path."""
    def boom(*a, **kw):
        raise AssertionError("flash kernel must not be used here")

    monkeypatch.setattr(tfa, "flash_attention", boom)
    monkeypatch.setattr(tllama, "FLASH_PREFILL_MIN_SEQ", 128)
    q, k, v = (_t(x) for x in _qkv(s=64, d=32))
    tllama.default_attention(q, k, v, causal=True)       # short
    tllama.default_attention(q, k, v, causal=False)      # non-causal
    q2, k2, v2 = (_t(x) for x in _qkv(s=192, d=32))
    tllama.default_attention(q2, k2, v2, causal=True)    # not 128-aligned
    q3, k3, v3 = (_t(x) for x in _qkv(s=256, d=32))
    monkeypatch.setattr(tllama, "FLASH_PREFILL_MIN_SEQ", 512)
    tllama.default_attention(q3, k3, v3, causal=True)    # below threshold
