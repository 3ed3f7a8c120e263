"""Pipeline stages over several devices: the port's in-stage mesh
(ray_tpu_torch/train/pipeline.py, train/gspmd.py) against ray_tpu's, on
the CPU.

  - Per stage: each stage of a 2-way split of ``LlamaConfig.tiny()``
    (fp32) on an in-stage mesh of fsdp, tp, sp, dp or fsdp×tp, built by
    ``build_llama_stage_state`` over spawned gloo ranks
    (``tests/torch_dist_ranks.py``, which imports no JAX), against the
    JAX ``build_llama_stage_state`` on a JAX mesh of the same shape over
    the conftest's virtual CPU devices, from one flax init carried
    across with ``params_from_flax``: the stage output, ``gx``, the
    loss and the gathered parameter grads within 1e-5 relative (the
    two frameworks sum in different orders, nothing more).
  - ``LlamaStage.forward(x, start_pos)`` rotates at the given positions,
    as ``LlamaModel.forward`` does.
  - The gate: ``TrainPipeline(pp=2, stage_mesh={"fsdp": 2},
    device="cpu")`` (four stage actors, a gloo group a stage) over real
    channels tracks the JAX single-program losses over 5 steps within
    the reference test's ``rtol=2e-2, atol=1e-3`` (bf16 compute), and
    so do stages of tp=2, sp=2, dp=2 and fsdp=2 × tp=2; in fp32 it
    equals the one-rank-a-stage pipeline within 1e-5.
  - A killed rank fails ``step()`` within 30 s and no rank is left
    running; the refusals come at once.

Every blocking call has a timeout.
"""

import dataclasses
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dist_ranks as ranks
from tests.conftest import force_cpu_jax

import ray_tpu_torch as rt
from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import gspmd as jg
from ray_tpu.train import pipeline as jp
from ray_tpu_torch._private.errors import SchedulingError
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.train.pipeline import TrainPipeline
from tests.torch_waits import bounded

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

STAGE_REL = 1e-5
LOSS_RTOL, LOSS_ATOL = 2e-2, 1e-3
FP32_REL = 1e-5
MB, SEQ = 2, 16             # the per-stage microbatch
B, S, M = 4, 32, 2          # the pipelines' global batch, sequence, microbatches
STEPS = 5
LAYOUTS = {"fsdp2": dict(fsdp=2), "tp2": dict(tp=2), "sp2": dict(sp=2),
           "dp2": dict(dp=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}


def _tokens(cfg, batch, seq, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _close(got, want, rel=STAGE_REL):
    """Each element within ``rel`` of the reference's largest value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


# ------------------------------------------------------------ per stage


def _jax_stages(jcfg, flax, data, spec):
    """The JAX stage functions on a JAX mesh of ``spec``: stage 0's
    output and grads, stage 1's loss, gx and grads, grads as the port's
    state-dict names."""
    from ray_tpu.models.llama import llama_param_rules
    from ray_tpu.parallel.mesh import shard_params

    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    n = int(np.prod(list(spec.values())))
    mesh = jmesh.make_mesh(jmesh.MeshSpec(**spec), devices=jax.devices()[:n])
    ranges = jp.partition_layers(jcfg, 2)
    tokens = data["tokens"]
    out = {}
    for s, layers in enumerate(ranges):
        st = jg.build_llama_stage_state(
            jcfg, mesh, layers, first=s == 0, last=s == 1,
            microbatch_size=tokens.shape[0], seq_len=tokens.shape[1],
            num_microbatches=1)
        p = shard_params(mesh, jp.slice_params_for_stage(flax, ranges, s),
                         llama_param_rules())
        sv = st["shard_value"]
        if s == 0:
            res = {"y": np.asarray(st["fwd"](p, sv(tokens)))}
            gp, _ = st["bwd"](p, sv(tokens), sv(data["gy"]))
        else:
            loss, gp, gx = st["loss_bwd"](p, sv(data["x"]), sv(tokens))
            res = {"loss": float(loss), "gx": np.asarray(gx)}
        res["grads"] = {k: v.numpy() for k, v in params_from_flax(
            jax.tree_util.tree_map(np.asarray, gp), tcfg).items()}
        out[f"stage{s}"] = res
    return out


@pytest.fixture(scope="module")
def stage_runs(tmp_path_factory):
    """{layout: (torch results by rank, JAX results)}.  The layouts' rank
    jobs run one after another on a thread (at most four processes at a
    time) while this process computes the JAX side."""
    work = tmp_path_factory.mktemp("stages")
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    data = {"tokens": _tokens(jcfg, MB, SEQ),
            "x": rng.normal(size=(MB, SEQ, jcfg.dim)).astype(np.float32),
            "gy": rng.normal(size=(MB, SEQ, jcfg.dim)).astype(np.float32)}
    flax = jax.tree_util.tree_map(np.asarray, jl.LlamaModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    np.savez(work / "inputs.npz", **data)
    np.savez(work / "params.npz", **_flat(flax))
    torch_out, errors = {}, []

    def run_jobs():
        try:
            for name, spec in LAYOUTS.items():
                n = int(np.prod(list(spec.values())))
                ctx = ranks.start("pipeline_stage_cases", n,
                                  str(work / name), str(work / "inputs.npz"),
                                  str(work / "params.npz"), spec)
                try:
                    torch_out[name] = ranks.finish(ctx, n, str(work / name),
                                                   timeout=120)
                finally:
                    for proc in ctx.processes:   # no rank outlives a failure
                        if proc.is_alive():
                            proc.kill()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    jobs = threading.Thread(target=run_jobs, daemon=True)
    jobs.start()
    want = {name: _jax_stages(jcfg, flax, data, spec)
            for name, spec in LAYOUTS.items()}
    jobs.join(timeout=600)
    assert not jobs.is_alive(), "rank jobs still running after 600 s"
    if errors:
        raise errors[0]
    return {name: (torch_out[name], want[name]) for name in LAYOUTS}


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_on_a_mesh_matches_the_jax_stage(stage_runs, layout, stage):
    """A stage over a process mesh equals the JAX stage over a device
    mesh of the same shape: output (stage 0) or loss and gx (stage 1),
    and every parameter grad, on every rank."""
    by_rank, want = stage_runs[layout]
    want = want[f"stage{stage}"]
    for got in (r[f"stage{stage}"] for r in by_rank):
        if stage == 0:
            _close(got["y"], want["y"])
            assert got["gx_is_none"]
        else:
            assert abs(got["loss"] - want["loss"]) \
                <= STAGE_REL * abs(want["loss"])
            _close(got["gx"], want["gx"])
        assert set(got["grads"]) == set(want["grads"])
        for name, grad in want["grads"].items():
            _close(got["grads"][name], grad)


def test_stage_forward_rotates_at_start_pos():
    """A stage holding the whole model, given a sequence shard that
    starts at position k, equals ``LlamaModel`` on that shard at
    ``start_pos=k``: rope rotates each token at its global position,
    as an sp rank's shard needs."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    model = tl.LlamaModel(cfg, device="cpu", seed=0)
    stage = tl.LlamaStage(cfg, 0, cfg.n_layers, first=True, last=True,
                          device="cpu", seed=0)
    x = torch.from_numpy(_tokens(cfg, 2, 8))
    with torch.no_grad():
        want = model(x, start_pos=8)
        got = stage(x, start_pos=8)
        unshifted = stage(x)
    assert torch.equal(got, want)
    assert not torch.allclose(unshifted, want)


# ------------------------------------------------------------ pipelines


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    # the stage processes inherit it: one torch thread each
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    # three faked cards: enough for two stages of one card, not of two
    bounded(lambda: rt.init(num_cpus=4, resources={"GPU": 3},
                            object_store_memory=128 * 1024 * 1024),
            120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads


@pytest.fixture(scope="module")
def jax_run():
    """(flax init, 5 losses) of the JAX single-program step on a
    one-device CPU mesh, for tiny at its default bf16 compute."""
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh as jmake
    from ray_tpu.train.gspmd import build_llama_train_state

    cfg = jl.LlamaConfig.tiny()
    mesh = jmake(MeshSpec(), devices=jax.devices()[:1])
    params, opt, step_fn, _ = build_llama_train_state(
        cfg, mesh, batch_size=B, seq_len=S, rng_seed=0)
    init = jax.tree_util.tree_map(np.array, params)
    tokens = _tokens(cfg, B, S)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step_fn(params, opt, tokens)
        losses.append(float(loss))
    return init, losses


def _pipeline(cfg, init, stage_mesh=None, **kw):
    return bounded(lambda: TrainPipeline(
        cfg, pp=2, microbatch_size=B // M, num_microbatches=M, seq_len=S,
        stage_mesh=stage_mesh,
        initial_params=params_from_flax(init, cfg), device="cpu",
        step_timeout=60.0, compile_timeout=60.0, **kw), 120,
        "TrainPipeline()")


def _losses(pipe, steps=STEPS):
    tokens = _tokens(pipe.cfg, B, S)
    return [bounded(lambda: pipe.step(tokens), 90, "step()")
            for _ in range(steps)]


def _infos(pipe):
    return [bounded(lambda: pipe._ctl(h, {"op": "info"}, timeout=30), 60)
            for h in pipe._handles]


@pytest.fixture(scope="module")
def fsdp_pipeline(cluster, jax_run):
    """A 2-stage pipeline of two gloo ranks a stage (fsdp=2) from the
    JAX init: the trajectory test, then the death test, which poisons
    it for good and so runs last."""
    pipe = _pipeline(tl.LlamaConfig.tiny(), jax_run[0], {"fsdp": 2})
    try:
        yield pipe
    finally:
        bounded(lambda: pipe.teardown(timeout=30.0), 60, "teardown")


def test_mesh_pipeline_matches_the_jax_single_program_loss(fsdp_pipeline,
                                                           jax_run):
    """The gate: two stages of two ranks each over real channels track
    the JAX step's loss trajectory over 5 steps from the same weights
    and tokens; each rank is a process of its own, numbered within its
    stage, whose reports come from rank 0."""
    pipe = fsdp_pipeline
    assert pipe.ranks_per_stage == 2 and len(pipe._handles) == 4
    reports = _losses(pipe)
    losses = [r["loss"] for r in reports]
    assert np.allclose(jax_run[1], losses, rtol=LOSS_RTOL,
                       atol=LOSS_ATOL), (jax_run[1], losses)
    assert losses[-1] < losses[0]
    last = reports[-1]
    assert last["step"] == STEPS
    assert [r["stage"] for r in last["per_stage"]] == [0, 1]
    infos = _infos(pipe)
    assert [(i["stage"], i["rank"]) for i in infos] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({i["pid"] for i in infos}) == 4
    assert all(i["device"] == "cpu" and i["step"] == STEPS for i in infos)


@pytest.mark.parametrize("layout", ["tp2", "sp2", "dp2", "fsdp2_tp2"])
def test_each_layout_tracks_the_jax_single_program_loss(cluster, jax_run,
                                                        layout):
    """Stages of tp=2, sp=2 (ring attention over the stage's group),
    dp=2 and the reference dry run's fsdp=2 × tp=2 (eight rank
    processes) track the JAX step's losses as the gate does."""
    pipe = _pipeline(tl.LlamaConfig.tiny(), jax_run[0], LAYOUTS[layout])
    try:
        losses = [r["loss"] for r in _losses(pipe)]
    finally:
        bounded(lambda: pipe.teardown(timeout=30.0), 60, "teardown")
    assert np.allclose(jax_run[1], losses, rtol=LOSS_RTOL,
                       atol=LOSS_ATOL), (jax_run[1], losses)
    assert losses[-1] < losses[0]


def test_mesh_pipeline_in_fp32_equals_one_rank_stages(cluster, jax_run):
    """In fp32, stages of two ranks (fsdp=2) take the same 5 steps as
    stages of one rank, from the same init and tokens."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    runs = {}
    for name, stage_mesh in (("one", None), ("fsdp2", {"fsdp": 2})):
        pipe = _pipeline(cfg, jax_run[0], stage_mesh)
        try:
            runs[name] = [r["loss"] for r in _losses(pipe)]
        finally:
            bounded(lambda: pipe.teardown(timeout=30.0), 60, "teardown")
    np.testing.assert_allclose(runs["fsdp2"], runs["one"], rtol=FP32_REL)


@pytest.mark.parametrize("kw,error,match", [
    (dict(stage_mesh={"fsdp": 2}, num_gpus=0.5), ValueError, "whole card"),
    (dict(stage_mesh={"tp": 2}), SchedulingError, "needs 4 GPU"),
    (dict(stage_mesh={"fsdp": 4}, device="cpu"), ValueError,
     "microbatch_size"),
    (dict(stage_mesh={"sp": 3}, device="cpu"), ValueError, "seq_len"),
], ids=["card_share", "too_few_cards", "microbatch", "sequence"])
def test_stage_mesh_refusals_come_at_once(cluster, kw, error, match):
    """A stage over several cards takes whole ones, and all of them must
    be in the cluster (it claims three); a stage mesh must split the
    microbatch's rows and its sequence.  Each is refused before any
    actor starts."""
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        TrainPipeline(tl.LlamaConfig.tiny(), pp=2, microbatch_size=2,
                      num_microbatches=2, seq_len=32, **kw)
    assert time.monotonic() - t0 < 10


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_mesh_pipeline_fails_on_a_rank_death(fsdp_pipeline):
    """A killed rank fails in-flight and later step() calls within 30 s
    instead of hanging; its stage peer, possibly blocked in a collective
    with it, is killed, and teardown leaves no rank running.  Runs
    last: it destroys the shared pipeline."""
    pipe = fsdp_pipeline
    tokens = _tokens(pipe.cfg, B, S)
    assert bounded(lambda: pipe.step(tokens), 90)["loss"] is not None
    pids = [i["pid"] for i in _infos(pipe)]
    os.kill(pids[3], signal.SIGKILL)   # stage 1, rank 1
    t0 = time.monotonic()

    def step_until_it_raises():
        while time.monotonic() - t0 < 30:
            pipe.step(tokens)

    with pytest.raises(Exception) as exc_info:
        bounded(step_until_it_raises, 60, "step() after a rank death")
    assert not isinstance(exc_info.value, AssertionError)
    assert time.monotonic() - t0 < 30
    bounded(lambda: pipe.teardown(timeout=30.0), 60, "teardown")
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not [p for p in pids if _alive(p)]


@pytest.mark.slow
def test_mesh_pipeline_rank_restart_resume(cluster):
    """SIGKILL one rank of a two-rank stage mid-run: it restarts,
    ``resume()`` forms every stage's group again, rolls every rank to
    the newest common snapshot step (each its own shards and AdamW
    moments), and the next step's loss is an uninterrupted run's, bit
    for bit, with the step counter intact."""
    cfg = tl.LlamaConfig.tiny()

    def make():
        return TrainPipeline(cfg, pp=2, microbatch_size=B // M,
                             num_microbatches=M, seq_len=S, device="cpu",
                             stage_mesh={"fsdp": 2}, max_restarts=2,
                             step_timeout=60.0)

    pipe = make()
    try:
        straight = [r["loss"] for r in _losses(pipe, 4)]
    finally:
        bounded(lambda: pipe.teardown(timeout=30.0), 60)
    pipe = make()
    try:
        reports = _losses(pipe, 3)
        assert reports[-1]["step"] == 3
        pid = _infos(pipe)[2]["pid"]     # stage 1, rank 0
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30

        def step_until_it_raises():
            while time.monotonic() < deadline:
                pipe.step(_tokens(cfg, B, S))

        with pytest.raises(Exception):
            bounded(step_until_it_raises, 60)
        resumed = bounded(lambda: pipe.resume(timeout=180.0), 240)
        assert resumed == 3
        out = _losses(pipe, 1)[0]
        assert out["step"] == 4 and out["loss"] == straight[3]
        assert [i["step"] for i in _infos(pipe)] == [4] * 4
    finally:
        bounded(lambda: pipe.teardown(timeout=30.0), 60)
