"""Parity of the port's training path (ray_tpu_torch/train, parallel) with
ray_tpu.train.gspmd on a one-device CPU mesh.

Both sides start from the same weights: the flax params that the JAX
``build_llama_train_state`` draws from its ``rng_seed`` are carried
across with ``params_from_flax`` and loaded in place into the port's
model, so the optimizer keeps its references.  The same numpy tokens
feed both.

Bounds and their reasons:
  - fp32 losses agree within 1e-5 relative: the two frameworks sum in
    different orders, nothing more.
  - fp32 parameters after the steps: at least 99.9% of elements within
    1e-5, and every element within 2 * lr * steps.  Adam's first steps
    are about lr * sign(g); where a gradient sits at rounding noise the
    two frameworks may step in opposite directions, 2 * lr apart per
    step, and nothing else can move an element further.
  - bf16 (bf16 compute over fp32 master weights): the first loss within
    1e-2 relative, as bf16 rounds at different places in the two.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import force_cpu_jax

from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import gspmd as jg
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.train import gspmd as tg

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

LR = 3e-4
STEPS = 5
LOSS_REL = 1e-5
PARAM_ATOL = 1e-5
PARAM_SHARE = 0.999
BF16_LOSS_REL = 1e-2


def _cfgs(jdtype, tdtype, **kw):
    return (dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jdtype, **kw),
            dataclasses.replace(tl.LlamaConfig.tiny(), dtype=tdtype, **kw))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, tl.LlamaConfig.tiny().vocab_size, shape).astype(np.int32)


def _host(tree):
    # copies: the JAX step donates its params
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


_jax_runs = {}


def _jax_run(name, jcfg, tokens, steps):
    """(initial params, per-step losses, final params) of the JAX train
    step on a one-device CPU mesh, once per configuration."""
    if name not in _jax_runs:
        mesh = jmesh.make_mesh(jmesh.MeshSpec(dp=-1),
                               devices=jax.devices()[:1])
        params, opt, step, _ = jg.build_llama_train_state(
            jcfg, mesh, learning_rate=LR, batch_size=tokens.shape[0],
            seq_len=tokens.shape[1])
        init = _host(params)
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, tokens)
            losses.append(float(loss))
        _jax_runs[name] = (init, losses, _host(params))
    return _jax_runs[name]


def _port_state(tcfg, flax_params, **kw):
    mesh = tmesh.make_mesh(devices=["cpu"])
    params, opt, step, model = tg.build_llama_train_state(
        tcfg, mesh, learning_rate=LR, **kw)
    assert params is model
    params.load_state_dict(params_from_flax(flax_params, tcfg))
    return params, opt, step


def _port_losses(params, opt, step, tokens, steps):
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens)
        assert loss.dim() == 0 and not loss.requires_grad
        losses.append(float(loss))
    return losses


def _assert_params_match(model, flax_final, tcfg, steps):
    want = params_from_flax(flax_final, tcfg)
    got = model.state_dict()
    total = close = 0
    for name, w in want.items():
        diff = (got[name].float() - w).abs()
        assert float(diff.max()) <= 2 * LR * steps, name
        total += diff.numel()
        close += int((diff <= PARAM_ATOL).sum())
    assert close >= PARAM_SHARE * total, (close, total)


# --------------------------------------------------------------- parity


def test_fp32_losses_and_params_match_jax():
    jcfg, tcfg = _cfgs(jnp.float32, torch.float32)
    tokens = _tokens((4, 32))
    init, jlosses, jfinal = _jax_run("fp32", jcfg, tokens, STEPS)
    params, opt, step = _port_state(tcfg, init)
    assert all(p.dtype == torch.float32 for p in params.parameters())
    losses = _port_losses(params, opt, step, tokens, STEPS)
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= LOSS_REL * abs(b), (losses, jlosses)
    _assert_params_match(params, jfinal, tcfg, STEPS)


def test_bf16_first_loss_matches_and_both_fall():
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    tokens = _tokens((4, 32), seed=1)
    init, jlosses, _ = _jax_run("bf16", jcfg, tokens, 3)
    params, opt, step = _port_state(tcfg, init)
    # fp32 master weights under bf16 compute, as flax's fp32 params
    assert params.lm_head.weight.dtype == torch.float32
    assert params.embed.weight.dtype == torch.float32
    losses = _port_losses(params, opt, step, tokens, 3)
    assert abs(losses[0] - jlosses[0]) <= BF16_LOSS_REL * abs(jlosses[0])
    assert losses[-1] < losses[0] and jlosses[-1] < jlosses[0]


def test_flash_routed_step_matches_jax(monkeypatch):
    """At S = 128 with the flash threshold lowered on both sides, the
    JAX step runs the Pallas kernel in interpret mode (backward: dense
    recompute) and the port's step goes through flash_attention (its
    plain version on the CPU); they still agree."""
    from ray_tpu_torch.ops import flash_attention as tfa

    monkeypatch.setattr(jl, "FLASH_PREFILL_MIN_SEQ", 128)
    monkeypatch.setattr(tl, "FLASH_PREFILL_MIN_SEQ", 128)
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    jcfg, tcfg = _cfgs(jnp.float32, torch.float32)
    tokens = _tokens((2, 128), seed=2)
    steps = 3
    init, jlosses, jfinal = _jax_run("flash", jcfg, tokens, steps)
    params, opt, step = _port_state(tcfg, init)
    losses = _port_losses(params, opt, step, tokens, steps)
    assert len(calls) == steps * tcfg.n_layers
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= LOSS_REL * abs(b), (losses, jlosses)
    _assert_params_match(params, jfinal, tcfg, steps)


def test_param_count_matches_config_and_jax():
    jcfg, tcfg = _cfgs(jnp.float32, torch.float32)
    init, _, _ = _jax_run("fp32", jcfg, _tokens((4, 32)), STEPS)
    params, _, _ = _port_state(tcfg, init)
    n = tg.param_count(params)
    assert n == tcfg.num_params()
    assert n == sum(x.size for x in jax.tree_util.tree_leaves(init))


def test_master_weights_keep_the_serving_forward():
    """param_dtype=None holds linear and embedding weights in cfg.dtype
    (the engine's weights are unchanged); fp32 master weights loaded
    from the same flax tree stay fp32 and give the same bf16 logits,
    bit for bit: each weight is cast to bf16 before its product."""
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    init, _, _ = _jax_run("bf16", jcfg, _tokens((4, 32), seed=1), 3)
    sd = params_from_flax(init, tcfg)
    serve = tl.LlamaModel(tcfg, device="cpu", seed=None)
    master = tl.LlamaModel(tcfg, device="cpu", seed=None,
                           param_dtype=torch.float32)
    serve.load_state_dict(sd)
    master.load_state_dict(sd)
    for name, p in serve.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith("scale")
                           else torch.bfloat16), name
    assert all(p.dtype == torch.float32 for p in master.parameters())
    toks = torch.from_numpy(_tokens((2, 16), seed=3))
    with torch.no_grad():
        a, b = serve(toks), master(toks)
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a, b)


# ------------------------------------------------------------ checkpoints


def test_resume_from_checkpoint_is_bitwise(tmp_path):
    """4 steps straight equal 2 steps, save, restore into a fresh model
    and optimizer, 2 more steps: losses, weights and Adam moments bit
    for bit (CPU, fp32)."""
    from ray_tpu_torch.train import restore_checkpoint, save_checkpoint

    jcfg, tcfg = _cfgs(jnp.float32, torch.float32)
    tokens = _tokens((4, 32))
    init, _, _ = _jax_run("fp32", jcfg, tokens, STEPS)
    params, opt, step = _port_state(tcfg, init)
    straight = _port_losses(params, opt, step, tokens, 4)

    p1, o1, step1 = _port_state(tcfg, init)
    first = _port_losses(p1, o1, step1, tokens, 2)
    path = save_checkpoint(str(tmp_path / "ck"), {
        "model": p1.state_dict(), "opt": o1.state_dict(), "step": 2})
    del p1, o1
    p2, o2, step2 = tg.build_llama_train_state(
        tcfg, tmesh.make_mesh(devices=["cpu"]), rng_seed=5,
        learning_rate=LR)[:3]
    state = restore_checkpoint(path)
    assert state["step"] == 2
    p2.load_state_dict(state["model"])
    o2.load_state_dict(state["opt"])
    resumed = first + _port_losses(p2, o2, step2, tokens, 2)
    assert resumed == straight
    for a, b in zip(params.parameters(), p2.parameters()):
        assert torch.equal(a, b)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[a][key], o2.state[b][key])


def test_checkpoint_roundtrip(tmp_path):
    from ray_tpu_torch.train import restore_checkpoint, save_checkpoint

    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": torch.tensor(7, dtype=torch.int32),
             "groups": [{"betas": (0.9, 0.999), "ids": [0, 1]}],
             "by_id": {0: torch.ones(2), 1: np.arange(3, dtype=np.int32)}}
    path = save_checkpoint(str(tmp_path / "ck"), state)
    restored = restore_checkpoint(path)
    assert float(restored["params"]["w"][1][2]) == 5.0
    assert int(restored["step"]) == 7
    assert restored["step"].dtype == torch.int32
    assert restored["groups"] == [{"betas": (0.9, 0.999), "ids": [0, 1]}]
    assert list(restored["by_id"]) == [0, 1]    # int keys stay ints
    assert restored["by_id"][1].dtype == torch.int32
    # restore with a target tree: its dtypes (and devices) win, and the
    # target itself is left as it was
    target = {"params": {"w": torch.zeros((2, 3), dtype=torch.bfloat16)},
              "step": 0}
    restored2 = restore_checkpoint(path, target=target)
    assert restored2["params"]["w"].dtype == torch.bfloat16
    assert float(restored2["params"]["w"][0][1]) == 1.0
    assert float(target["params"]["w"].abs().sum()) == 0.0


def test_checkpoint_manager_topk(tmp_path):
    import os

    from ray_tpu_torch.train import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "mgr"), num_to_keep=2,
                            metric="loss", mode="min")
    p1 = mgr.save({"x": torch.tensor(1.0)}, {"loss": 3.0})
    p2 = mgr.save({"x": torch.tensor(2.0)}, {"loss": 1.0})
    p3 = mgr.save({"x": torch.tensor(3.0)}, {"loss": 2.0})
    assert not os.path.exists(p1)  # worst evicted
    assert mgr.best_checkpoint() == p2
    assert mgr.latest_checkpoint() == p3


def test_checkpoint_manager_persists_to_storage(tmp_path):
    """A manager on a fresh host finds the index and the checkpoints in
    storage."""
    from ray_tpu_torch.train import (CheckpointManager, StorageContext,
                                     restore_checkpoint)

    storage = StorageContext(str(tmp_path / "store"), "exp")
    mgr = CheckpointManager(str(tmp_path / "host_a"), storage=storage)
    path = mgr.save({"w": torch.full((3,), 4.0)}, {"loss": 1.0})
    shutil.rmtree(tmp_path / "host_a")
    again = CheckpointManager(str(tmp_path / "host_b"), storage=storage)
    assert again.latest_checkpoint() == path
    local = again.fetch(path)
    assert torch.equal(restore_checkpoint(local)["w"], torch.full((3,), 4.0))


# ------------------------------------------------------------------- mesh


def test_mesh_spec_resolution():
    from ray_tpu_torch.parallel import MeshSpec

    s = MeshSpec(dp=-1, fsdp=2, tp=2).resolve(8)
    assert (s.dp, s.fsdp, s.tp) == (2, 2, 2)
    with pytest.raises(ValueError):
        MeshSpec(dp=3).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=-1, tp=-1).resolve(8)
    assert tmesh.mesh_axes_for(8, MeshSpec(dp=-1, tp=2)) == \
        jmesh.mesh_axes_for(8, jmesh.MeshSpec(dp=-1, tp=2))


def test_one_device_mesh_and_placement():
    from ray_tpu_torch.parallel import (MeshSpec, make_mesh, shard_batch,
                                        shard_params)

    mesh = make_mesh(MeshSpec(dp=-1), devices=["cpu"])
    assert mesh.shape == {"pp": 1, "dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    assert mesh.devices == (torch.device("cpu"),)
    toks = shard_batch(mesh, {"tokens": _tokens((2, 8))})["tokens"]
    assert isinstance(toks, torch.Tensor) and toks.dtype == torch.int32
    placed = shard_params(mesh, {"w": [np.ones(3, np.float32)],
                                 "n": 3}, rules={"w": None})
    assert placed["w"][0].device == torch.device("cpu")
    assert placed["n"] == 3
    # a mesh over several devices is not ported: it raises, it never
    # runs on one device instead
    with pytest.raises(NotImplementedError, match="process groups"):
        make_mesh(MeshSpec(dp=2), devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        make_mesh(MeshSpec(dp=2), devices=["cpu"])
    sp_mesh = tmesh.Mesh((torch.device("cpu"),), MeshSpec(sp=2))
    with pytest.raises(NotImplementedError, match="ring attention"):
        tg.build_llama_train_state(tl.LlamaConfig.tiny(), sp_mesh)
