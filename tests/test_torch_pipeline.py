"""The port's MPMD pipeline (ray_tpu_torch/train/pipeline.py) against
ray_tpu's, on the CPU.

  - The schedule, the partition, the bubble and the slicing helpers: the
    cases of tests/test_train_pipeline.py:26-95, and the port's
    partition equal to the JAX package's.
  - ``LlamaStage``: each stage of ``LlamaConfig.tiny()`` (fp32) equals
    the JAX ``LlamaStage`` on the same flax weights, carried across with
    ``params_from_flax`` of the stage's subtree, within 1e-5 (the two
    frameworks sum in different orders, nothing more); a stage drawn
    from a seed holds exactly its slice of the whole model drawn from it.
  - The gate: a 2-stage ``TrainPipeline(device="cpu")`` over real
    channels and pinned actor loops tracks the JAX single-program
    losses (``build_llama_train_state`` in this process, its init
    carried across) over 5 steps within the reference test's
    ``rtol=2e-2, atol=1e-3`` (bf16 compute: the two frameworks round at
    different places).
  - A killed stage fails ``step()`` within 30 s, and the pipeline stays
    failed; the restart/resume ride stays ``slow``, as in the reference.

Every blocking call has a timeout.
"""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import force_cpu_jax

import ray_tpu_torch as rt
from ray_tpu.models import llama as jl
from ray_tpu.train import pipeline as jp
from ray_tpu_torch._private.errors import SchedulingError
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.train.pipeline import (PipelineError, PipelineStage,
                                          TrainPipeline, bubble_pct,
                                          in_flight_bound, one_f_one_b,
                                          partition_layers,
                                          slice_params_for_stage)
from tests.torch_waits import bounded

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

STAGE_TOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 2e-2, 1e-3
B, S, M = 4, 32, 2          # global batch, sequence, microbatches
STEPS = 5


def _tokens(cfg, batch, seq, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)


def _flax_init(cfg, seed=0):
    """The JAX package's full-model init as a numpy tree."""
    model = jl.LlamaModel(cfg)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------- schedule units


def test_one_f_one_b_ordering_and_counts():
    for n_stages in (2, 3, 4):
        for m in (1, 2, 4, 8):
            for stage in range(n_stages):
                ops = one_f_one_b(stage, n_stages, m)
                assert ops == jp.one_f_one_b(stage, n_stages, m)
                fs = [k for op, k in ops if op == "F"]
                bs = [k for op, k in ops if op == "B"]
                assert fs == list(range(m))
                assert bs == list(range(m))
                pos = {("F", k): i for i, (op, k) in enumerate(ops)
                       if op == "F"}
                for i, (op, k) in enumerate(ops):
                    if op == "B":
                        assert i > pos[("F", k)]
                if stage == n_stages - 1:
                    assert ops[:2 * m:2] == [("F", k) for k in range(m)]


def test_one_f_one_b_in_flight_bound():
    for n_stages in (2, 3, 4):
        for m in (1, 2, 4, 16):
            for stage in range(n_stages):
                lead = peak = 0
                for op, _k in one_f_one_b(stage, n_stages, m):
                    lead += 1 if op == "F" else -1
                    peak = max(peak, lead)
                assert peak == in_flight_bound(stage, n_stages, m)
                assert peak <= n_stages


def test_bubble_accounting():
    assert bubble_pct([1.0, 1.0], 1.0) == 0.0
    assert bubble_pct([0.5, 0.5], 1.0) == 50.0
    assert bubble_pct([1.2, 1.1], 1.0) == 0.0
    assert bubble_pct([], 1.0) == 0.0


@pytest.mark.parametrize("name", ["tiny", "small", "bench_1b", "llama3_8b"])
def test_partition_layers_equals_the_jax_package(name):
    tcfg, jcfg = getattr(tl.LlamaConfig, name)(), \
        getattr(jl.LlamaConfig, name)()
    for pp in range(1, min(tcfg.n_layers, 4) + 1):
        assert partition_layers(tcfg, pp) == jp.partition_layers(jcfg, pp)


def test_partition_layers_balance():
    cfg = tl.LlamaConfig.llama3_8b()
    ranges = partition_layers(cfg, 4)
    assert ranges[0][0] == 0 and ranges[-1][1] == cfg.n_layers
    for (a, b), (c, _d) in zip(ranges, ranges[1:]):
        assert b == c and b > a
    counts = [b - a for a, b in ranges]
    assert counts[-1] < max(counts[1:-1])
    assert partition_layers(tl.LlamaConfig.bench_1b(), 2) == \
        [(0, 11), (11, 20)]
    with pytest.raises(ValueError):
        partition_layers(tl.LlamaConfig.tiny(), 3)


def test_slice_params_for_stage_covers_state_dict():
    full = tl.LlamaModel(tl.LlamaConfig.tiny(), device="meta",
                         seed=None).state_dict()
    ranges = [(0, 1), (1, 2)]
    s0 = slice_params_for_stage(full, ranges, 0)
    s1 = slice_params_for_stage(full, ranges, 1)
    assert not set(s0) & set(s1) and set(s0) | set(s1) == set(full)
    assert "embed.weight" in s0 and "layers.0.attn.wq.weight" in s0
    assert {"final_norm.scale", "lm_head.weight",
            "layers.1.mlp.w2.weight"} <= set(s1)
    assert not any(k.startswith("layers.1.") for k in s0)


# -------------------------------------------------------------- LlamaStage


def _fp32_cfgs():
    return (dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32),
            dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32))


@pytest.mark.parametrize("pp", [1, 2])
def test_llama_stage_equals_the_jax_stage(pp):
    """Every stage of a pp-way split of tiny (fp32), on the same flax
    weights, from the same input (tokens into stage 0, the JAX stage's
    activations into later ones)."""
    jcfg, tcfg = _fp32_cfgs()
    flax = _flax_init(jcfg)
    ranges = jp.partition_layers(jcfg, pp)
    x = _tokens(tcfg, 2, 16)
    for s, (start, end) in enumerate(ranges):
        first, last = s == 0, s == pp - 1
        sub = jp.slice_params_for_stage(flax, ranges, s)
        jstage = jl.LlamaStage(jcfg, start=start, end=end, first=first,
                               last=last)
        want = np.asarray(jstage.apply({"params": sub}, jnp.asarray(x)))
        tstage = tl.LlamaStage(tcfg, start, end, first=first, last=last,
                               device="cpu", seed=None)
        sd = params_from_flax(sub, tcfg)
        assert set(sd) == set(tstage.state_dict())
        tstage.load_state_dict(sd)
        with torch.no_grad():
            got = tstage(torch.from_numpy(np.array(x))).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=STAGE_TOL,
                                   atol=STAGE_TOL)
        x = want


def test_stage_seeded_init_is_the_slice_of_the_models():
    cfg = tl.LlamaConfig.tiny()
    full = tl.LlamaModel(cfg, device="cpu", seed=3,
                         param_dtype=torch.float32).state_dict()
    ranges = partition_layers(cfg, 2)
    for s, (start, end) in enumerate(ranges):
        stage = tl.LlamaStage(cfg, start, end, first=s == 0, last=s == 1,
                              device="cpu", seed=3,
                              param_dtype=torch.float32)
        sd = stage.state_dict()
        assert set(sd) == set(slice_params_for_stage(full, ranges, s))
        for k, v in sd.items():
            assert torch.equal(v, full[k]), k
    other = tl.LlamaStage(cfg, 0, 1, first=True, device="cpu", seed=4)
    assert not torch.equal(other.embed.weight,
                           full["embed.weight"].to(other.embed.weight.dtype))


def test_stage_state_round_trips_through_save_and_restore():
    """__rt_save__ holds CPU tensors keyed by parameter name; a fresh
    stage restored from them holds the same weights, AdamW moments and
    step, and takes the same next optimizer step."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    spec = {"stage": 1, "n_stages": 2, "cfg": cfg, "ranges": [(0, 1), (1, 2)],
            "microbatch_size": 2, "seq_len": 16, "num_microbatches": 1,
            "rng_seed": 0, "device": "cpu"}
    a = PipelineStage(spec)
    x = torch.randn((2, 16, cfg.dim), generator=torch.Generator()
                    .manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 2, 16))

    def train_step(stage):
        st = stage._st
        st["zero_grads"](st["params"])
        st["loss_bwd"](st["params"], x, toks)
        st["opt_step"](st["params"], st["opt_state"])

    train_step(a)
    a._step = 1
    saved = a.__rt_save__()
    assert all(v.device.type == "cpu" for v in saved["params"].values())
    assert set(saved["opt"]) == set(saved["params"])
    b = PipelineStage({**spec, "rng_seed": 7})
    b.__rt_restore__(saved)
    assert b._step == 1
    for stage in (a, b):
        train_step(stage)
    for (name, p), q in zip(a._st["params"].named_parameters(),
                            b._st["params"].parameters()):
        assert torch.equal(p, q), name


# ------------------------------------------------------------ e2e pipeline


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    # the stage processes inherit it: one torch thread pool of two each
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    bounded(lambda: rt.init(num_cpus=4,
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


@pytest.fixture(scope="module")
def pipeline(cluster, jax_run):
    """One shared 2-stage CPU pipeline from the JAX init: the trajectory
    test, then the death test, which poisons it for good and so runs
    last (tier-1 runs this module in definition order)."""
    cfg = tl.LlamaConfig.tiny()
    pipe = bounded(lambda: TrainPipeline(
        cfg, pp=2, microbatch_size=B // M, num_microbatches=M, seq_len=S,
        initial_params=params_from_flax(jax_run[0], cfg), device="cpu",
        step_timeout=60.0, compile_timeout=60.0), 120, "TrainPipeline()")
    try:
        yield pipe
    finally:
        bounded(lambda: pipe.teardown(timeout=30.0), 60, "teardown")


def test_pipeline_without_gpus_raises_at_once(cluster):
    t0 = time.monotonic()
    with pytest.raises(SchedulingError, match="device='cpu'"):
        TrainPipeline(tl.LlamaConfig.tiny(), pp=2, microbatch_size=2,
                      num_microbatches=2, seq_len=32)
    assert time.monotonic() - t0 < 10


def test_pipeline_matches_the_jax_single_program_loss(pipeline, jax_run):
    """The gate: 2 stages over real channels track the JAX step's loss
    trajectory over 5 steps from the same weights and tokens."""
    tokens = _tokens(pipeline.cfg, B, S)
    reports = [bounded(lambda: pipeline.step(tokens), 90, "step()")
               for _ in range(STEPS)]
    losses = [r["loss"] for r in reports]
    assert np.allclose(jax_run[1], losses, rtol=LOSS_RTOL,
                       atol=LOSS_ATOL), (jax_run[1], losses)
    assert losses[-1] < losses[0]
    last = reports[-1]
    assert last["step"] == STEPS
    assert 0.0 <= last["bubble_pct"] <= 100.0
    assert [r["stage"] for r in last["per_stage"]] == [0, 1]
    for rep in last["per_stage"]:
        assert rep["busy_s"] > 0
        assert rep["fwd_s"] > 0 if rep["stage"] == 0 else rep["fwd_s"] == 0
    assert last["tokens_per_s"] > 0
    info = bounded(lambda: pipeline._ctl(pipeline._handles[0],
                                         {"op": "info"}, timeout=30), 60)
    assert info["device"] == "cpu" and info["step"] == STEPS
    # the plain versions ran: a CPU stage launches no kernel
    assert info["kernel_launches"] == {"flash_attention": 0,
                                       "paged_attention": 0}


def test_pipeline_poisoned_on_stage_death(pipeline):
    """A killed stage worker fails in-flight and later step() calls
    within 30 s instead of hanging; the pipeline stays failed, and with
    no checkpoints there is nothing to resume.  Runs last: it destroys
    the shared pipeline."""
    tokens = _tokens(pipeline.cfg, B, S)
    assert bounded(lambda: pipeline.step(tokens), 90)["loss"] is not None
    info = bounded(lambda: pipeline._ctl(pipeline._handles[1],
                                         {"op": "info"}, timeout=30), 60)
    os.kill(info["pid"], signal.SIGKILL)
    t0 = time.monotonic()

    def step_until_it_raises():
        while time.monotonic() - t0 < 30:
            pipeline.step(tokens)

    with pytest.raises(Exception) as exc_info:
        bounded(step_until_it_raises, 60, "step() after a stage death")
    assert not isinstance(exc_info.value, AssertionError)
    assert time.monotonic() - t0 < 30
    with pytest.raises(Exception):
        bounded(lambda: pipeline.step(tokens), 30)
    with pytest.raises(PipelineError):
        bounded(lambda: pipeline.resume(timeout=5.0), 30)


@pytest.mark.slow
def test_pipeline_stage_restart_resume(cluster):
    """Port of test_train_pipeline.py:233: SIGKILL one stage's worker
    mid-run; the actor restarts with its __rt_restore__ state, resume()
    rolls every stage to the newest common snapshot step, and training
    continues with the step counter intact."""
    cfg = tl.LlamaConfig.tiny()
    pipe = TrainPipeline(cfg, pp=2, microbatch_size=B // M,
                         num_microbatches=M, seq_len=S, device="cpu",
                         max_restarts=2, step_timeout=60.0)
    try:
        tokens = _tokens(cfg, B, S)
        for _ in range(3):
            out = bounded(lambda: pipe.step(tokens), 90)
        assert out["step"] == 3
        info = pipe._ctl(pipe._handles[1], {"op": "info"}, timeout=30)
        os.kill(info["pid"], signal.SIGKILL)
        deadline = time.monotonic() + 30

        def step_until_it_raises():
            while time.monotonic() < deadline:
                pipe.step(tokens)

        with pytest.raises(Exception):
            bounded(step_until_it_raises, 60)
        resumed = bounded(lambda: pipe.resume(timeout=180.0), 240)
        assert resumed == 3
        out = bounded(lambda: pipe.step(tokens), 90)
        assert out["step"] == 4
        assert np.isfinite(out["loss"])
    finally:
        bounded(lambda: pipe.teardown(timeout=30.0), 60)
