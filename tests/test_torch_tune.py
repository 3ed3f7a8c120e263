"""The port's Tune library (ray_tpu_torch.tune) held against ray_tpu.tune.

Search spaces expand to the same variants for one seed in both packages.
The deterministic trainables of tests/test_tune.py run through both
Tuners: with ``max_concurrent_trials=1`` ASHA sees the reports in one
order, so it stops the same trials and picks the same best config in
both; PBT's clones depend on the order in which concurrent reports
arrive, so the port is held to the JAX test's own assertions (a clone
was made, the best score beats 3.0).  A trial is the port's TrainWorker
on a lease: on a cluster that claims two GPUs (no card is touched), two
concurrent ``{"GPU": 1}`` trials each see one card of their own through
``CUDA_VISIBLE_DEVICES``.  Last, trials that train ``LlamaConfig.tiny()``
in fp32 on the CPU from a converted flax init report the losses of a
direct ``build_llama_train_state`` run at the trial's learning rate
within 1e-6, and those of the JAX ``gspmd`` step within the 1e-5
relative of tests/test_torch_train.py.

Trainables are built inside functions, so cloudpickle sends them by
value: a trial's worker imports nothing of this file (nor of JAX).
The JAX Tuner runs first in a ray_tpu cluster, shut down before the
port's cluster starts.  Every blocking call is bounded.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import tune as jtune
from ray_tpu_torch import tune

from tests.conftest import force_cpu_jax
from tests.torch_waits import bounded

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

FIT_S = 180
LOSS_REL_JAX = 1e-5        # tests/test_torch_train.py's fp32 bound
LOSS_ABS_DIRECT = 1e-6
LLAMA_LRS = (3e-4, 1e-3)
LLAMA_STEPS = 3
TOKENS = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)

SPACES = {
    "random": ({"lr": tune.loguniform(1e-5, 1e-1), "b": tune.choice([1, 2]),
                "u": tune.uniform(0, 1), "n": tune.randint(0, 10)}, 4, 0),
    "grid_and_random": ({"x": tune.grid_search([0, 1, 2]),
                         "lr": tune.loguniform(1e-4, 1e-2)}, 2, 3),
}


def _jax_space(name):
    return {
        "random": {"lr": jtune.loguniform(1e-5, 1e-1),
                   "b": jtune.choice([1, 2]), "u": jtune.uniform(0, 1),
                   "n": jtune.randint(0, 10)},
        "grid_and_random": {"x": jtune.grid_search([0, 1, 2]),
                            "lr": jtune.loguniform(1e-4, 1e-2)},
    }[name]


@pytest.mark.parametrize("name", sorted(SPACES))
def test_variants_equal_ray_tpu_tunes_for_one_seed(name):
    space, samples, seed = SPACES[name]
    got = tune.search.generate_variants(space, samples, seed)
    assert got == jtune.search.generate_variants(_jax_space(name), samples,
                                                 seed)
    assert got == tune.search.generate_variants(space, samples, seed)
    assert len(got) == samples * (3 if "x" in space else 1)


# ------------------------------------------------------- the trainables


def _quadratic(pkg):
    def trainable(config):
        import importlib

        train = importlib.import_module(pkg + ".train")
        score = (config["x"] - 3) ** 2
        train.report({"score": score})
        return score
    return trainable


def _asha_trainable(pkg):
    def trainable(config):
        import importlib
        import time

        train = importlib.import_module(pkg + ".train")
        for step in range(1, 21):
            loss = config["quality"] * 10.0 / step
            train.report({"loss": loss, "training_iteration": step})
            time.sleep(0.005)
        return True
    return trainable


def _asha(pkg):
    t = jtune if pkg == "ray_tpu" else tune
    sched = t.ASHAScheduler(metric="loss", mode="min", max_t=20,
                            grace_period=2, reduction_factor=2)
    return t.Tuner(
        _asha_trainable(pkg),
        param_space={"quality": t.grid_search([1, 8, 1, 8, 8, 2])},
        tune_config=t.TuneConfig(metric="loss", mode="min", scheduler=sched,
                                 max_concurrent_trials=1))


def _grid(pkg):
    t = jtune if pkg == "ray_tpu" else tune
    return t.Tuner(_quadratic(pkg),
                   param_space={"x": t.grid_search([0, 1, 2, 3, 4])},
                   tune_config=t.TuneConfig(metric="score", mode="min"))


def _summary(grid):
    best = grid.get_best_result()
    return {"trials": sorted((r.trial_id, r.config["quality"]
                              if "quality" in r.config else r.config["x"],
                              r.state) for r in grid),
            "best_config": dict(best.config),
            "best_metrics": {k: v for k, v in best.metrics.items()
                             if k in ("loss", "score",
                                      "training_iteration")}}


@pytest.fixture(scope="module")
def jax_results():
    ray_tpu.init(num_cpus=4, object_store_memory=64 << 20)
    try:
        return {"asha": _summary(bounded(_asha("ray_tpu").fit, FIT_S,
                                         "ASHA fit()")),
                "grid": _summary(bounded(_grid("ray_tpu").fit, FIT_S,
                                         "grid fit()"))}
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster(jax_results, tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=4, resources={"GPU": 2},
                            object_store_memory=64 << 20), 120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


@pytest.mark.parametrize("kind", ["grid", "asha"])
def test_search_and_asha_match_ray_tpu_tune(cluster, jax_results, kind):
    tuner = {"grid": _grid, "asha": _asha}[kind]("ray_tpu_torch")
    got = _summary(bounded(tuner.fit, FIT_S, f"{kind} fit()"))
    assert got == jax_results[kind]
    if kind == "grid":
        assert got["best_config"] == {"x": 3}
    else:
        assert got["best_config"]["quality"] == 1
        assert "STOPPED" in {s for _i, _q, s in got["trials"]}


def test_pbt_exploits_and_explores(cluster):
    def trainable(config):
        import json
        import time

        from ray_tpu_torch import train

        state = {"score": 0.0}
        ck = config.get("__restore_checkpoint__")
        if ck:
            state = json.loads(ck)
        for _ in range(6):
            time.sleep(0.1)
            state["score"] += 1.0 - abs(config["lr"] - 1.0)
            train.report({"score": state["score"]},
                         checkpoint=json.dumps(state))

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        quantile_fraction=0.25,
        hyperparam_mutations={"lr": [0.25, 0.5, 1.0, 2.0]}, seed=0)
    grid = bounded(tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.25, 0.5, 1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=pbt,
                                    max_concurrent_trials=4)).fit,
        FIT_S, "PBT fit()")
    assert [r for r in grid if r.trial_id.startswith("clone_")]
    assert grid.get_best_result().metrics["score"] > 3.0


def test_trial_error_recorded(cluster):
    def trainable(config):
        if config["x"] == 1:
            raise ValueError("bad trial")
        from ray_tpu_torch import train

        train.report({"ok": 1})
        return True

    results = bounded(tune.Tuner(
        trainable, param_space={"x": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="ok", mode="max")).fit,
        FIT_S, "fit()")
    by_x = {r.config["x"]: r for r in results}
    assert by_x[0].state == "TERMINATED"
    assert by_x[1].state == "ERROR" and "bad trial" in by_x[1].error


def test_result_dataframe(cluster):
    def trainable(config):
        from ray_tpu_torch import train

        train.report({"m": config["x"] * 2})

    results = bounded(tune.Tuner(
        trainable, param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="m", mode="max")).fit,
        FIT_S, "fit()")
    df = results.get_dataframe()
    assert set(df["config/x"]) == {1, 2} and set(df["m"]) == {2, 4}


def test_experiment_snapshot_and_restore(cluster, tmp_path):
    marker_dir = str(tmp_path / "runs")
    os.makedirs(marker_dir)

    def trainable(config):
        import os

        from ray_tpu_torch import train

        open(os.path.join(config["marker_dir"], f"run-{config['x']}"),
             "a").write("x")
        train.report({"loss": config["x"] * 1.0})

    grid = bounded(tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 3]),
                     "marker_dir": marker_dir},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        storage_path=str(tmp_path), name="exp1").fit, FIT_S, "fit()")
    assert len(grid) == 3 and grid.get_best_result().metrics["loss"] == 1.0
    assert (tmp_path / "exp1" / "experiment_state.pkl").exists()
    runs_before = len(os.listdir(marker_dir))
    restored = tune.Tuner.restore(str(tmp_path / "exp1"), trainable)
    grid2 = bounded(restored.fit, FIT_S, "restored fit()")
    assert len(grid2) == 3
    assert grid2.get_best_result().metrics["loss"] == 1.0
    assert len(os.listdir(marker_dir)) == runs_before


def test_trials_see_their_own_faked_card(cluster, tmp_path):
    """Two concurrent trials at ``{"GPU": 1}`` on a cluster that claims
    two GPUs: each reports one card, and the two differ.  Each waits
    until both have started, so both leases are held at once."""
    sync = str(tmp_path)

    def trainable(config):
        import os
        import time

        from ray_tpu_torch import train

        mine = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        open(os.path.join(config["sync"], f"{os.getpid()}.gpus"), "w").close()
        deadline = time.time() + 60
        while time.time() < deadline and len(os.listdir(config["sync"])) < 2:
            time.sleep(0.05)
        train.report({"gpus": mine, "both_started":
                      len(os.listdir(config["sync"])) >= 2})

    grid = bounded(tune.Tuner(
        trainable, param_space={"i": tune.grid_search([0, 1]),
                                "sync": sync},
        tune_config=tune.TuneConfig(metric="both_started", mode="max",
                                    max_concurrent_trials=2),
        resources_per_trial={"GPU": 1}).fit, FIT_S, "fit()")
    seen = sorted(r.metrics["gpus"] for r in grid)
    assert all(r.state == "TERMINATED" and r.metrics["both_started"]
               for r in grid)
    assert seen == ["0", "1"]


# ------------------------------------------------------- Llama trials


def _jax_llama_losses(lr):
    from ray_tpu.models import llama as jl
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.train import gspmd as jg
    import jax.numpy as jnp

    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    mesh = jmesh.make_mesh(jmesh.MeshSpec(dp=-1), devices=jax.devices()[:1])
    params, opt, step, _ = jg.build_llama_train_state(
        cfg, mesh, learning_rate=lr, batch_size=TOKENS.shape[0],
        seq_len=TOKENS.shape[1])
    init = jax.tree_util.tree_map(np.array, params)
    losses = []
    for _ in range(LLAMA_STEPS):
        params, opt, loss = step(params, opt, TOKENS)
        losses.append(float(loss))
    return init, losses


def _llama_trainable():
    def trainable(config):
        import dataclasses

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models.convert import params_from_flax
        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.parallel import make_mesh
        from ray_tpu_torch.train.gspmd import (build_llama_train_state,
                                               load_params)

        torch.set_num_threads(1)
        cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
        params, opt, step, _ = build_llama_train_state(
            cfg, make_mesh(devices=["cpu"]),
            learning_rate=config["learning_rate"])
        load_params(params, params_from_flax(config["init"], cfg))
        tokens = torch.from_numpy(config["tokens"])
        for _ in range(config["steps"]):
            params, opt, loss = step(params, opt, tokens)
            train.report({"loss": float(loss)})
    return trainable


def test_llama_trials_match_a_direct_run_and_the_jax_step(cluster):
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_flax
    from ray_tpu_torch.parallel import make_mesh
    from ray_tpu_torch.train.gspmd import build_llama_train_state, load_params

    jax_runs = {lr: _jax_llama_losses(lr) for lr in LLAMA_LRS}
    init = jax_runs[LLAMA_LRS[0]][0]
    grid = bounded(tune.Tuner(
        _llama_trainable(),
        param_space={"learning_rate": tune.grid_search(list(LLAMA_LRS)),
                     "init": init, "tokens": TOKENS, "steps": LLAMA_STEPS},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2)).fit,
        FIT_S, "fit()")
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    for r in grid:
        lr = r.config["learning_rate"]
        got = [m["loss"] for m in r.metrics_history]
        assert r.state == "TERMINATED" and len(got) == LLAMA_STEPS
        params, opt, step, _ = build_llama_train_state(
            cfg, make_mesh(devices=["cpu"]), learning_rate=lr)
        load_params(params, params_from_flax(init, cfg))
        direct = []
        for _ in range(LLAMA_STEPS):
            params, opt, loss = step(params, opt, torch.from_numpy(TOKENS))
            direct.append(float(loss))
        np.testing.assert_allclose(got, direct, rtol=0, atol=LOSS_ABS_DIRECT)
        np.testing.assert_allclose(got, jax_runs[lr][1], rtol=LOSS_REL_JAX)
    best = grid.get_best_result()
    assert best.config["learning_rate"] in LLAMA_LRS
