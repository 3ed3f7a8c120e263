"""Parity of the port's Llama (ray_tpu_torch/models) with ray_tpu's flax
model, on weights carried across by ``params_from_flax``.

Inputs are made with numpy from a seed and fed to both frameworks; fp32
is held tightly (atol 1e-4 on logits of magnitude ~5) and bf16 within
3e-2 of the largest logit (the two frameworks round bf16 at different
places: torch's silu and einsum round once where XLA may round twice).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import force_cpu_jax

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_flax

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

MODEL = {"vocab_size": 64, "dim": 32, "n_layers": 2, "n_heads": 4,
         "n_kv_heads": 2, "hidden_dim": 64, "max_seq_len": 64}
FP32_ATOL = 1e-4
BF16_REL = 3e-2


def _cfgs(jdtype=jnp.float32, tdtype=torch.float32):
    return jl.LlamaConfig(dtype=jdtype, **MODEL), \
        tl.LlamaConfig(dtype=tdtype, **MODEL)


_flax_params = {}


def _flax(jcfg, page_size=0):
    """(flax model, its fp32 params from seed 0), params cached per
    width (the dtype does not change the param tree)."""
    model = jl.LlamaModel(jcfg, page_size=page_size)
    if "p" not in _flax_params:
        _flax_params["p"] = model.init(
            jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"]
    return model, _flax_params["p"]


def _port(tcfg, params, page_size=0):
    model = tl.LlamaModel(tcfg, page_size=page_size, device="cpu",
                          seed=None)
    model.load_state_dict(params_from_flax(params, tcfg))
    return model.eval()


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, MODEL["vocab_size"], shape).astype(np.int32)


# ---------------------------------------------------------- full forward


def test_no_cache_forward_matches_flax_fp32():
    jcfg, tcfg = _cfgs()
    jm, params = _flax(jcfg)
    toks = _tokens((2, 24))
    ref = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(toks)).numpy()
    assert out.shape == (2, 24, MODEL["vocab_size"])
    np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


def test_no_cache_forward_matches_flax_bf16():
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    jm, params = _flax(jcfg)
    toks = _tokens((2, 24), seed=1)
    ref = np.asarray(jm.apply({"params": params}, toks)).astype(np.float32)
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(toks))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= BF16_REL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_no_cache_forward_routes_through_flash_when_long(monkeypatch):
    """The no-cache forward of a long aligned sequence takes the flash
    path (its plain version on the CPU) and still matches flax, whose
    own routing takes the interpret-mode Pallas kernel."""
    from ray_tpu_torch.ops import flash_attention as tfa

    monkeypatch.setattr(jl, "FLASH_PREFILL_MIN_SEQ", 128)
    monkeypatch.setattr(tl, "FLASH_PREFILL_MIN_SEQ", 128)
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, max_seq_len=128)
    tcfg = dataclasses.replace(tcfg, max_seq_len=128)
    jm, params = _flax(jcfg)
    toks = _tokens((1, 128), seed=2)
    ref = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(toks)).numpy()
    assert len(calls) == MODEL["n_layers"]
    np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


def test_remat_gives_the_same_loss_and_grads():
    """cfg.remat recomputes each block in the backward pass: same loss,
    same grads as keeping the activations."""
    jcfg, tcfg = _cfgs()
    _jm, params = _flax(jcfg)
    toks = torch.from_numpy(_tokens((2, 16), seed=5))
    grads = []
    for remat in (False, True):
        model = _port(dataclasses.replace(tcfg, remat=remat), params)
        loss = tl.causal_lm_loss(model(toks), toks)
        loss.backward()
        grads.append((loss.item(), model.layers[0].attn.wq.weight.grad))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5,
                               atol=1e-7)


# ----------------------------------------------------------- cache forward


PS = 4          # page size
CTX = 16        # pages_per_seq * page_size
PAGES = {0: [3, 7, 1, 9], 1: [5, 2, 11, 6]}   # shuffled physical pages


def _slot(lane, pos):
    return PAGES[lane][pos // PS] * PS + pos % PS


def _prefill_arrays(chunks):
    """Dense-gather cache arrays for one prefill call: ``chunks`` maps a
    lane to its (lo, hi) token range; other lanes are inactive."""
    lanes, c = 2, 8
    a = {"slots": np.zeros((lanes, c), np.int32),
         "q_pos": np.zeros((lanes, c), np.int32),
         "ctx": np.zeros((lanes, CTX), np.int32),
         "ctx_pos": np.zeros((lanes, CTX), np.int32),
         "ctx_mask": np.zeros((lanes, CTX), bool)}
    for lane, (lo, hi) in chunks.items():
        for j, pos in enumerate(range(lo, hi)):
            a["slots"][lane, j] = _slot(lane, pos)
            a["q_pos"][lane, j] = pos
        for pos in range(hi):
            a["ctx"][lane, pos] = _slot(lane, pos)
            a["ctx_pos"][lane, pos] = pos
            a["ctx_mask"][lane, pos] = True
    return a


def _decode_arrays(lens):
    """Paged-decode cache arrays: lane b writes position lens[b]."""
    a = {"slots": np.zeros((2, 1), np.int32),
         "q_pos": np.zeros((2, 1), np.int32),
         "block_tables": np.zeros((2, 4), np.int32),
         "context_lens": np.zeros((2,), np.int32)}
    for lane, n in enumerate(lens):
        a["slots"][lane, 0] = _slot(lane, n)
        a["q_pos"][lane, 0] = n
        a["block_tables"][lane] = PAGES[lane]
        a["context_lens"][lane] = n + 1
    return a


def _to_torch(a):
    out = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("slots", "ctx"):
        if k in out:
            out[k] = out[k].long()
    return out


def test_cache_forward_prefill_then_paged_decode_matches_flax():
    """Chunked prefill (dense gather, one lane idle in the second chunk)
    then paged decode steps: logits and the written pools agree."""
    jcfg, tcfg = _cfgs()
    jm, params = _flax(jcfg, page_size=PS)
    tm = _port(tcfg, params, page_size=PS)
    num_slots = 12 * PS
    jpools = jl.make_kv_pools(jcfg, num_slots)
    tpools = tl.make_kv_pools(tcfg, num_slots, device="cpu")
    prompts = {0: _tokens(11, seed=3), 1: _tokens(5, seed=4)}

    def call(tokens, arrays, live):
        nonlocal jpools
        jcache = {"k": jpools["k"], "v": jpools["v"],
                  **{k: jnp.asarray(v) for k, v in arrays.items()}}
        jlogits, jpools = jm.apply({"params": params}, tokens, jcache)
        with torch.no_grad():
            tlogits, _ = tm(torch.from_numpy(tokens),
                            {"k": tpools["k"], "v": tpools["v"],
                             **_to_torch(arrays)})
        for lane, cols in live.items():
            np.testing.assert_allclose(
                tlogits[lane, cols].numpy(),
                np.asarray(jlogits)[lane, cols], atol=FP32_ATOL, rtol=0)
        return tlogits

    # chunk 1: lane 0 positions 0..7, lane 1 its whole 5-token prompt
    toks = np.zeros((2, 8), np.int32)
    toks[0] = prompts[0][:8]
    toks[1, :5] = prompts[1]
    call(toks, _prefill_arrays({0: (0, 8), 1: (0, 5)}),
         {0: slice(0, 8), 1: slice(0, 5)})
    # chunk 2: lane 0 positions 8..10, lane 1 idle
    toks = np.zeros((2, 8), np.int32)
    toks[0, :3] = prompts[0][8:]
    logits = call(toks, _prefill_arrays({0: (8, 11)}), {0: slice(0, 3)})
    nxt = [int(logits[0, 2].argmax()), 0]
    lens = [11, 5]
    for _ in range(3):
        toks = np.asarray([[nxt[0]], [nxt[1]]], np.int32)
        logits = call(toks, _decode_arrays(lens), {0: 0, 1: 0})
        nxt = [int(x) for x in logits[:, 0].argmax(-1)]
        lens = [n + 1 for n in lens]
    for side in ("k", "v"):
        for jp, tp in zip(jpools[side], tpools[side]):
            # slot 0 takes the idle lanes' duplicate writes: excluded
            np.testing.assert_allclose(tp[1:].numpy(), np.asarray(jp)[1:],
                                       atol=1e-5, rtol=0)


# ------------------------------------------------------------- components


@pytest.mark.parametrize("cfg_name", ["tiny", "small", "bench_1b",
                                      "llama3_8b"])
def test_num_params_agree(cfg_name):
    tcfg = getattr(tl.LlamaConfig, cfg_name)()
    jcfg = getattr(jl.LlamaConfig, cfg_name)()
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.head_dim == jcfg.head_dim
    model = tl.LlamaModel(tcfg, device="meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) == tcfg.num_params()


def test_param_count_matches_flax_tree():
    jcfg, tcfg = _cfgs()
    _jm, params = _flax(jcfg)
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert n == tcfg.num_params()
    assert set(params_from_flax(params, tcfg)) == set(
        _port(tcfg, params).state_dict())


@pytest.mark.parametrize("jdtype,tdtype,tol", [
    (jnp.float32, torch.float32, 1e-5),
    (jnp.bfloat16, torch.bfloat16, 2 ** -7),
])
def test_rope_matches(jdtype, tdtype, tol):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    ref = np.asarray(jl._rope(jnp.asarray(x, jdtype), jnp.asarray(pos),
                              500000.0)).astype(np.float32)
    out = tl._rope(torch.from_numpy(x).to(tdtype), torch.from_numpy(pos),
                   500000.0)
    assert out.dtype == tdtype
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)


def test_rmsnorm_matches_flax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    ref = np.asarray(jl.RMSNorm(1e-5).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x)))
    norm = tl.RMSNorm(32, 1e-5)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        out = norm(torch.from_numpy(x)).numpy()
        bf = norm(torch.from_numpy(x).bfloat16())
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert bf.dtype == torch.bfloat16 and norm.scale.dtype == torch.float32


def test_causal_lm_loss_matches():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 9, 64)).astype(np.float32)
    toks = rng.integers(0, 64, (2, 9)).astype(np.int32)
    ref = float(jl.causal_lm_loss(jnp.asarray(logits), jnp.asarray(toks)))
    out = float(tl.causal_lm_loss(torch.from_numpy(logits),
                                  torch.from_numpy(toks)))
    assert abs(out - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_bf16_matches(causal):
    """bf16 dense attention casts probabilities to v's dtype before the
    PV product in both frameworks."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 16, 4 if i == 0 else 2, 16))
               .astype(np.float32) for i in range(3))
    ref = np.asarray(jl.dense_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        causal=causal)).astype(np.float32)
    out = tl.dense_attention(*(torch.from_numpy(x).bfloat16()
                               for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2,
                               rtol=2e-2)


def test_cached_attention_chunked_prefill_matches():
    rng = np.random.default_rng(9)
    pool_k = rng.normal(size=(32, 2, 8)).astype(np.float32)
    pool_v = rng.normal(size=(32, 2, 8)).astype(np.float32)
    q = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    ctx = rng.integers(1, 32, (2, 10)).astype(np.int32)
    ctx_pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    ctx_mask = np.ones((2, 10), bool)
    ctx_mask[1, 7:] = False
    q_pos = np.asarray([[3, 4, 5, 6], [0, 1, 2, 6]], np.int32)
    args = (q, pool_k, pool_v, ctx, ctx_pos, ctx_mask, q_pos)
    ref = np.asarray(jl.cached_attention(*(jnp.asarray(a) for a in args)))
    out = tl.cached_attention(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_kv_pool_bytes_and_shapes_match(jdtype, tdtype):
    jcfg, tcfg = _cfgs(jdtype, tdtype)
    assert tl.kv_pool_bytes(tcfg, 40) == jl.kv_pool_bytes(jcfg, 40)
    pools = tl.make_kv_pools(tcfg, 40, device="cpu")
    jpools = jl.make_kv_pools(jcfg, 40)
    assert [tuple(p.shape) for p in pools["k"]] == \
        [tuple(p.shape) for p in jpools["k"]]
    assert sum(p.nbytes for p in pools["k"] + pools["v"]) == \
        tl.kv_pool_bytes(tcfg, 40)


def test_init_scales_follow_flax():
    """Dense kernels: variance 1/fan_in; embedding: std 1/sqrt(dim);
    norms ones.  Same seed, same weights."""
    cfg = tl.LlamaConfig(vocab_size=2048, dim=256, n_layers=1, n_heads=4,
                         n_kv_heads=2, hidden_dim=512, max_seq_len=64,
                         dtype=torch.float32)
    m = tl.LlamaModel(cfg, device="cpu", seed=3).requires_grad_(False)
    attn = m.layers[0].attn
    assert abs(float(attn.wq.weight.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(m.layers[0].mlp.w2.weight.std())
               - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert float(attn.wq.weight.abs().max()) <= 2 * 256 ** -0.5 / 0.8796 + 1e-6
    assert abs(float(m.embed.weight.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert bool((m.final_norm.scale == 1).all())
    again = tl.LlamaModel(cfg, device="cpu", seed=3)
    other = tl.LlamaModel(cfg, device="cpu", seed=4)
    assert torch.equal(again.lm_head.weight, m.lm_head.weight)
    assert not torch.equal(other.lm_head.weight, m.lm_head.weight)


# ------------------------------------------------- slot-pool round trips


def test_gather_scatter_copy_round_trip():
    """scatter(gather(x)) is identity on the touched slots, and
    copy_kv_slots makes dst rows equal src rows (the CoW primitive)."""
    cfg = tl.LlamaConfig(vocab_size=16, dim=16, n_layers=2, n_heads=4,
                         n_kv_heads=2, hidden_dim=16, max_seq_len=32,
                         dtype=torch.float32)
    rng = np.random.default_rng(13)
    for _trial in range(5):
        num_slots = 40
        pools = tl.make_kv_pools(cfg, num_slots, device="cpu")
        for p in pools["k"] + pools["v"]:
            p.copy_(torch.from_numpy(rng.normal(size=p.shape)))
        n = int(rng.integers(1, 12))
        slots = rng.choice(np.arange(1, num_slots), size=n, replace=False)
        rows = tl.gather_kv_slots(pools, slots)
        fresh = tl.scatter_kv_slots(
            tl.make_kv_pools(cfg, num_slots, device="cpu"), slots, rows)
        back = tl.gather_kv_slots(fresh, slots)
        for side in ("k", "v"):
            for a, b in zip(rows[side], back[side]):
                assert torch.equal(a, b)
        free = [s for s in range(1, num_slots) if s not in set(slots)]
        dst = np.asarray(free[:n], np.int32)
        tl.copy_kv_slots(pools, slots, dst)
        after_src = tl.gather_kv_slots(pools, slots)
        after_dst = tl.gather_kv_slots(pools, dst)
        for side in ("k", "v"):
            for a, b in zip(after_src[side], after_dst[side]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_rows_exported_by_jax_scatter_into_port_pools(jdtype, tdtype):
    """JAX's gather_kv_slots rows (numpy, ml_dtypes bfloat16 for bf16
    pools) land bit for bit in the port's pools."""
    jcfg, tcfg = _cfgs(jdtype, tdtype)
    rng = np.random.default_rng(14)
    jpools = jl.make_kv_pools(jcfg, 24)
    jpools = {s: [jnp.asarray(rng.normal(size=p.shape), jdtype)
                  for p in jpools[s]] for s in ("k", "v")}
    slots = np.asarray([3, 9, 4, 17], np.int32)
    rows = jl.gather_kv_slots(jpools, slots)
    tpools = tl.scatter_kv_slots(
        tl.make_kv_pools(tcfg, 24, device="cpu"), slots, rows)
    for side in ("k", "v"):
        for jp, tp in zip(jpools[side], tpools[side]):
            want = torch.tensor(np.asarray(jp[slots], np.float32)).to(tdtype)
            assert torch.equal(tp[torch.from_numpy(slots).long()], want)
