"""Parity of the port's multi-process mesh (ray_tpu_torch/parallel,
ops/ring_attention, train) with the JAX package on its virtual 8-device
CPU mesh.

The JAX side runs in this process.  The torch side runs as spawned ranks
over gloo (``tests/torch_dist_ranks.py``, which imports no JAX), one
torch thread each, rendezvousing through a file under the test's tmp
directory.  Both start from the same numpy inputs and from one flax
init, carried across as an .npz and ``params_from_flax``.  All eight-rank
cases share one process group; that job, the one-rank job and the
two-rank checkpoint job all run while the JAX side computes.

Bounds and their reasons:
  - ring attention forward: 2e-5 absolute and relative, the JAX tests'
    own bound against dense attention (tests/test_ops.py); both are fp32
    online softmaxes that sum in different orders.
  - ring gradients dq, dk, dv: 5e-5, the JAX gradient test's bound; dk
    and dv come from the port's own ring backward.
  - fp32 losses of three train steps: 1e-5 relative, as on one device
    (tests/test_torch_train.py).
  - bf16 compute over fp32 master weights: the first loss within 1e-2
    relative, as on one device; bf16 rounds at other places in the two.
  - one rank over gloo against the one-device step: 1e-6 relative; the
    two differ in how the loss is summed, nothing else.
  - a checkpoint resume: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dist_ranks as ranks
from tests.conftest import force_cpu_jax

from ray_tpu.models import llama as jl
from ray_tpu.ops.ring_attention import ring_attention as j_ring
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import gspmd as jg
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops.ring_attention import ring_blocks
from ray_tpu_torch.parallel import (MeshSpec, batch_pspec, init_distributed,
                                    make_mesh, shard_batch)

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

LR = 3e-4
STEPS = 3
RING_TOL = 2e-5
GRAD_TOL = 5e-5
LOSS_REL = 1e-5
ONE_RANK_REL = 1e-6
BF16_LOSS_REL = 1e-2
# name: (mesh, tokens, dtype, steps)
TRAIN_CASES = {
    "train_dp2_fsdp2_tp2": (dict(dp=2, fsdp=2, tp=2), (4, 32), "float32", 3),
    "train_dp2_sp2_tp2": (dict(dp=2, sp=2, tp=2), (2, 64), "float32", 3),
    # bf16 compute over fp32 master weights: the casts on DTensors
    "train_bf16_dp2_fsdp2_tp2": (dict(dp=2, fsdp=2, tp=2), (4, 32),
                                 "bfloat16", 2)}
FP32_CASES = [n for n, c in TRAIN_CASES.items() if c[2] == "float32"]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, tl.LlamaConfig.tiny().vocab_size, shape).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _jmesh(**spec):
    return jmesh.make_mesh(jmesh.MeshSpec(**spec), devices=jax.devices()[:8])


def _jax_cases(data, init):
    """Every JAX-side result, on the virtual 8-device mesh."""
    out = {}
    q, k, v = (jnp.asarray(data[n]) for n in ("q", "k", "v"))
    for name, spec, causal in (("ring_dp2_sp4", dict(dp=2, sp=4), True),
                               ("ring_sp8", dict(sp=8), False)):
        mesh = _jmesh(**spec)
        with mesh:
            out[name] = np.asarray(jax.jit(lambda q, k, v: j_ring(
                q, k, v, mesh, causal=causal, head_axis=None))(q, k, v))
    mesh = _jmesh(dp=2, sp=4)
    gq, gk, gv = (jnp.asarray(data[n]) for n in ("gq", "gk", "gv"))
    with mesh:
        grads = jax.jit(jax.grad(lambda q, k, v: j_ring(
            q, k, v, mesh, head_axis=None).sum(), argnums=(0, 1, 2)))(
                gq, gk, gv)
    out["ring_grads"] = dict(zip(("dq", "dk", "dv"),
                                 (np.asarray(g) for g in grads)))
    for name, (spec, shape, dtype, steps) in TRAIN_CASES.items():
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(),
                                   dtype=getattr(jnp, dtype))
        params, opt, step, _ = jg.build_llama_train_state(
            jcfg, _jmesh(**spec), learning_rate=LR, batch_size=shape[0],
            seq_len=shape[1])
        start = _flat(jax.tree_util.tree_map(np.asarray, params))
        assert all(np.array_equal(start[key], init[key]) for key in init)
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, data[name])
            losses.append(float(loss))
        out[name] = losses
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(torch results by rank of every eight-rank case, JAX results,
    inputs, every job's results by rank)."""
    work = tmp_path_factory.mktemp("eight")
    rng = np.random.default_rng(0)
    data = {"q": _normal(rng, 2, 64, 4, 16), "k": _normal(rng, 2, 64, 2, 16),
            "v": _normal(rng, 2, 64, 2, 16), "gq": _normal(rng, 2, 32, 4, 16),
            "gk": _normal(rng, 2, 32, 2, 16), "gv": _normal(rng, 2, 32, 2, 16)}
    for i, (name, (_spec, shape, _dt, _n)) in enumerate(TRAIN_CASES.items()):
        data[name] = _tokens(shape, seed=i)
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    # the draw of jg.build_llama_train_state(rng_seed=0); checked there
    init = _flat(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jl.LlamaModel(jcfg).init(r, jnp.zeros((4, 32), jnp.int32))
    )(jax.random.PRNGKey(0))["params"]))
    np.savez(work / "inputs.npz", **data)
    np.savez(work / "params.npz", **init)
    # the one- and two-rank jobs start too: all of them run while the
    # JAX side computes
    jobs = {"eight": (8, ("eight_rank_cases", str(work / "inputs.npz"),
                          str(work / "params.npz"), LR, TRAIN_CASES)),
            "one": (1, ("one_rank_against_one_device",
                        _tokens((4, 32), seed=3), LR, STEPS)),
            "checkpoint": (2, ("checkpoint_resume", str(work / "ck"),
                               _tokens((4, 32), seed=4), LR))}
    started = {name: ranks.start(job, world, str(work / name), *args)
               for name, (world, (job, *args)) in jobs.items()}
    try:
        want = _jax_cases(data, init)
        done = {name: ranks.finish(ctx, jobs[name][0], str(work / name))
                for name, ctx in started.items()}
    finally:
        for ctx in started.values():     # no rank outlives a failure
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    return done["eight"], want, data, done


def _block(x, index, shape):
    """Rank ``index``'s block of a global [B, S, ...] array on a mesh of
    ``shape``: dim 0 over (dp, fsdp), dim 1 over sp."""
    nb = shape.get("dp", 1) * shape.get("fsdp", 1)
    b = x.shape[0] // nb
    s = x.shape[1] // shape.get("sp", 1)
    i = index["dp"] * shape.get("fsdp", 1) + index["fsdp"]
    return x[i * b:(i + 1) * b, index["sp"] * s:(index["sp"] + 1) * s]


@pytest.mark.parametrize("name,shape", [
    ("ring_dp2_sp4", dict(dp=2, sp=4)),    # causal
    ("ring_sp8", dict(sp=8)),              # non-causal
])
def test_ring_forward_matches_jax(runs, name, shape):
    got, want, _, _ = runs
    for rank in got:
        r = rank[name]
        np.testing.assert_allclose(r["out"], _block(want[name], r["index"],
                                                    shape),
                                   atol=RING_TOL, rtol=RING_TOL)


def test_ring_gradients_match_jax(runs):
    got, want, _, _ = runs
    for rank in got:
        r = rank["ring_grads"]
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(
                r[g], _block(want["ring_grads"][g], r["index"],
                             dict(dp=2, sp=4)),
                atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=g)


def test_ring_blocks_on_one_device_match_jax(runs):
    """The same block functions played out on one device, in ring order:
    the forward and all three gradients."""
    _got, want, data, _ = runs
    out = ring_blocks(*(torch.from_numpy(data[n]) for n in ("q", "k", "v")),
                      n_blocks=4, causal=True)
    np.testing.assert_allclose(out.numpy(), want["ring_dp2_sp4"],
                               atol=RING_TOL, rtol=RING_TOL)
    q, k, v = (torch.from_numpy(data[n]) for n in ("gq", "gk", "gv"))
    _out, *grads = ring_blocks(q, k, v, n_blocks=4, causal=True,
                               d_out=torch.ones(q.shape))
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(g.numpy(), want["ring_grads"][name],
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("name", FP32_CASES)
def test_sharded_train_losses_match_jax(runs, name):
    got, want, _, _ = runs
    losses = [rank[name]["losses"] for rank in got]
    assert all(x == losses[0] for x in losses), losses   # one global mean
    for a, b in zip(losses[0], want[name]):
        assert abs(a - b) <= LOSS_REL * abs(b), (losses[0], want[name])
    assert losses[0][-1] < losses[0][0]
    # the weights really are sharded: wq [64, 64] over tp, then fsdp
    spec = TRAIN_CASES[name][0]
    rows = 64 // spec.get("tp", 1) // spec.get("fsdp", 1)
    assert all(rank[name]["wq_local"] == (rows, 64) for rank in got)


def test_sharded_bf16_step_matches_jax(runs):
    """bf16 compute over fp32 master weights at dp2·fsdp2·tp2: each
    weight cast to bf16 before its product and the embedding rows after
    their lookup, on DTensors as on one device; the first loss within
    1e-2 relative (bf16 rounds at other places in the two), both
    falling."""
    got, want, _, _ = runs
    name = "train_bf16_dp2_fsdp2_tp2"
    losses, jlosses = got[0][name]["losses"], want[name]
    assert abs(losses[0] - jlosses[0]) <= BF16_LOSS_REL * abs(jlosses[0])
    assert losses[-1] < losses[0] and jlosses[-1] < jlosses[0]


def test_shard_params_and_batch_placement(runs):
    """shard_params over dp2·fsdp2·tp2: a rule puts w's dim 1 over tp;
    b has no rule, so its largest dim goes over fsdp.  A pipeline axis
    raises, naming TrainPipeline."""
    got, _want, _data, _ = runs
    w, b = np.arange(32.0).reshape(8, 4), np.arange(6.0)
    for rank in got:
        r = rank["shard_params"]
        t, f = r["index"]["tp"], r["index"]["fsdp"]
        np.testing.assert_array_equal(r["w"], w[:, 2 * t:2 * t + 2])
        np.testing.assert_array_equal(r["b"], b[3 * f:3 * f + 3])
        assert "TrainPipeline" in rank["pp_error"]
    assert batch_pspec() == {"dp": 0, "fsdp": 0}


def test_one_rank_over_gloo_matches_the_one_device_step(runs):
    out = runs[3]["one"][0]
    assert out["process"]["mesh"] and not out["device"]["mesh"]
    for a, b in zip(out["process"]["losses"], out["device"]["losses"]):
        assert abs(a - b) <= ONE_RANK_REL * abs(b), out


def test_sharded_checkpoint_resumes_bitwise(runs):
    """Saved at MeshSpec(fsdp=2) after step 1 and restored into a fresh
    model and optimizer: steps 2-3 equal the straight run's bit for bit,
    and each rank's file holds its own shards only."""
    out = runs[3]["checkpoint"]
    for r in out:
        assert r["resumed"] == r["straight"], r
        assert r["step"] == 1 and r["params_equal"] and r["moments_equal"]
    files = out[0]["files"]
    assert {"__0_0.distcp", "__1_0.distcp", "tree.json"} <= set(files)
    local = out[0]["local_param_bytes"]      # half of the weights
    for f in ("__0_0.distcp", "__1_0.distcp"):
        # weights and two Adam moments of one shard: at least 3x local,
        # and less than a whole copy (6x local) would take
        assert 3 * local <= files[f] < 6 * local, files


def test_entry_points_of_the_mesh_on_one_device(monkeypatch):
    """Without a process group: a one-device mesh places whole tensors,
    a spec over several devices raises, and init_distributed without a
    GPU raises unless asked for the CPU."""
    mesh = make_mesh(devices=["cpu"])
    toks = _tokens((2, 8), seed=5)
    placed = shard_batch(mesh, {"t": toks})["t"]
    assert torch.equal(placed, torch.from_numpy(toks))
    with pytest.raises(NotImplementedError, match="init_distributed"):
        make_mesh(MeshSpec(fsdp=2), devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("localhost:1", 1, 0)


def test_sharded_loss_sums_to_the_global_mean():
    """Sequence shards' summed losses over the global target count give
    causal_lm_loss: the last position of a shard takes the next shard's
    first token, the very last has none."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 16, 32, generator=gen)
    tokens = torch.from_numpy(_tokens((2, 16), seed=6)) % 32
    targets = tl.shifted_targets(tokens)
    total = sum(tl.lm_loss_sum(logits[:, i:i + 4], targets[:, i:i + 4])
                for i in range(0, 16, 4)) / (2 * 15)
    torch.testing.assert_close(total, tl.causal_lm_loss(logits, tokens))
    assert np.array_equal(tl.shifted_targets(tokens.numpy()),
                          targets.numpy())


def test_tp_needs_whole_kv_heads():
    """tp must divide n_kv_heads; the check runs before any process
    group is touched."""
    from ray_tpu_torch.parallel.mesh import Mesh
    from ray_tpu_torch.train import gspmd as tg

    mesh = Mesh((torch.device("cpu"),), MeshSpec(tp=4), device_mesh=object())
    cfg = tl.LlamaConfig.tiny()            # 2 kv heads
    with pytest.raises(ValueError, match="n_kv_heads"):
        tg.build_llama_train_state(cfg, mesh)
