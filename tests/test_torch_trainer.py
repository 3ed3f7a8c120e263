"""TorchTrainer on the port's runtime, held against JaxTrainer on ray_tpu's.

Both trainers run a 2-layer fp32 Llama (``LlamaConfig.tiny()``) for 3
steps from the same weights on the same numpy tokens: JaxTrainer with
``ray_tpu.train.gspmd`` on a one-device CPU mesh in a ray_tpu cluster,
then TorchTrainer with ``ScalingConfig(use_gpu=False)`` in a port
cluster, its model loaded through ``params_from_flax`` from the flax
init the JAX worker returns.  The reported losses agree within 1e-5
relative, the bound of tests/test_torch_train.py (the frameworks sum in
different orders, nothing more); two gloo workers at ``MeshSpec(dp=2)``
agree with one worker within 1e-5 too.  The rest ports the trainer's
tests of tests/test_train.py to the port.

Train loops are built inside functions so cloudpickle sends them by
value: a worker imports nothing of this file (nor of JAX, on the port's
side).  Every blocking call has a timeout: a ``fit()`` that has not
returned within ``FIT_S`` fails its test instead of stalling the run.
"""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch import train

from tests.torch_waits import bounded

torch.set_num_threads(2)   # six xdist workers share the test machine

LR = 3e-4
STEPS = 3
LOSS_REL = 1e-5
FIT_S = 240        # a fit() that has not returned by then has stalled
TOKENS = np.random.default_rng(0).integers(0, 256, (4, 32)).astype(np.int32)


def _jax_loop():
    def loop(config):
        import dataclasses

        import jax
        import jax.numpy as jnp
        import numpy as np

        from ray_tpu import train as jtrain
        from ray_tpu.models.llama import LlamaConfig
        from ray_tpu.parallel.mesh import MeshSpec, make_mesh
        from ray_tpu.train.gspmd import build_llama_train_state

        cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=jnp.float32)
        mesh = make_mesh(MeshSpec(dp=-1), devices=jax.devices()[:1])
        tokens = config["tokens"]
        params, opt, step, _ = build_llama_train_state(
            cfg, mesh, learning_rate=config["lr"],
            batch_size=tokens.shape[0], seq_len=tokens.shape[1])
        init = jax.tree_util.tree_map(np.array, params)
        for _ in range(config["steps"]):
            params, opt, loss = step(params, opt, tokens)
            jtrain.report({"loss": float(loss)})
        return init
    return loop


def _port_loop():
    def loop(config):
        import dataclasses

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train as ttrain
        from ray_tpu_torch.models.convert import params_from_flax
        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.parallel import MeshSpec, make_mesh
        from ray_tpu_torch.train.gspmd import (build_llama_train_state,
                                               load_params)

        torch.set_num_threads(1)
        cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
        mesh = (make_mesh(MeshSpec(dp=-1)) if dist.is_initialized()
                else make_mesh(devices=["cpu"]))
        params, opt, step, _ = build_llama_train_state(
            cfg, mesh, learning_rate=config["lr"])
        load_params(params, params_from_flax(config["init"], cfg))
        for _ in range(config["steps"]):
            params, opt, loss = step(params, opt, config["tokens"])
            ttrain.report({"loss": float(loss),
                           "rank": ttrain.get_context().get_world_rank()})
        return {"world": dist.get_world_size() if dist.is_initialized()
                else 1, "device": str(mesh.device),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
    return loop


@pytest.fixture(scope="module")
def jax_reference():
    """(losses, flax init) of JaxTrainer in a ray_tpu cluster, which is
    shut down before the port's cluster starts."""
    from ray_tpu.train import JaxTrainer, ScalingConfig

    def own(tree):
        # the arrays view ray_tpu's arena; a view released after its
        # cluster is gone stalls on an RPC to the dead agent
        if isinstance(tree, dict):
            return {k: own(v) for k, v in tree.items()}
        return np.array(tree, copy=True)

    ray_tpu.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        result = bounded(JaxTrainer(
            _jax_loop(), scaling_config=ScalingConfig(num_workers=1),
            train_loop_config={"tokens": TOKENS, "lr": LR,
                               "steps": STEPS}).fit, FIT_S, "fit()")
        out = ([m["loss"] for m in result.metrics_history],
               own(result.per_worker_final[0]))
        del result
    finally:
        ray_tpu.shutdown()
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=2,
                            object_store_memory=64 * 1024 * 1024),
            120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def _fit_port(init, workers):
    return bounded(train.TorchTrainer(
        _port_loop(),
        scaling_config=train.ScalingConfig(num_workers=workers,
                                           use_gpu=False),
        train_loop_config={"tokens": TOKENS, "lr": LR, "steps": STEPS,
                           "init": init}).fit, FIT_S, "fit()")


_port_runs = {}


def _port_losses(init, workers):
    if workers not in _port_runs:
        result = _fit_port(init, workers)
        _port_runs[workers] = ([m["loss"] for m in result.metrics_history],
                               result.per_worker_final)
    return _port_runs[workers]


def test_one_worker_matches_jax_trainer(jax_reference, cluster):
    jlosses, init = jax_reference
    losses, finals = _port_losses(init, 1)
    assert len(losses) == len(jlosses) == STEPS
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= LOSS_REL * abs(b), (losses, jlosses)
    assert finals == [{"world": 1, "device": "cpu", "visible": ""}]


def test_two_gloo_workers_match_one(jax_reference, cluster):
    """Two workers join one gloo process group before the loop starts
    and train ``MeshSpec(dp=2)``: rank 0 reports the global loss."""
    _jlosses, init = jax_reference
    one, _ = _port_losses(init, 1)
    two, finals = _port_losses(init, 2)
    assert [f["world"] for f in finals] == [2, 2]
    for a, b in zip(two, one):
        assert abs(a - b) <= LOSS_REL * abs(b), (two, one)


def test_default_scaling_config_without_gpus_raises_at_once(cluster):
    """ScalingConfig() asks for a GPU per worker; on a cluster with none
    fit() names the shortfall instead of waiting for a lease, and
    nothing falls back to the CPU."""
    assert train.ScalingConfig().worker_resources() == {"GPU": 1}
    assert train.ScalingConfig(use_gpu=False).worker_resources() == {}
    t0 = time.monotonic()
    with pytest.raises(rt.SchedulingError, match="needs 2 GPU"):
        bounded(train.TorchTrainer(lambda: None,
                                   scaling_config=train.ScalingConfig(
                                       num_workers=2)).fit, FIT_S, "fit()")
    assert time.monotonic() - t0 < 10


# --------------------------------------------- ports of tests/test_train.py


def test_trainer_error_surfaces(cluster):
    def bad_loop(config):
        raise RuntimeError("train exploded")

    trainer = train.TorchTrainer(
        bad_loop, scaling_config=train.ScalingConfig(num_workers=1,
                                                     use_gpu=False),
        train_loop_config={})
    with pytest.raises(train.TrainingFailedError, match="train exploded"):
        bounded(trainer.fit, FIT_S, "fit()")


def test_worker_group_execute(cluster):
    g = bounded(lambda: train.WorkerGroup(3), 120, "WorkerGroup(3)")
    try:
        infos = g.execute("node_info", timeout=60)
        assert len(infos) == 3 and len({i["pid"] for i in infos}) == 3
        assert all(i["ip"] for i in infos)
    finally:
        bounded(g.shutdown, 60, "WorkerGroup.shutdown")


def test_report_outside_session_raises():
    with pytest.raises(RuntimeError, match="TorchTrainer"):
        train.report({"x": 1})


def test_fit_retries_worker_death_and_resumes(cluster):
    """Worker death mid-fit rebuilds the gang and resumes from the last
    reported checkpoint."""
    marker = os.path.join(tempfile.mkdtemp(), "died_once")

    def loop(config):
        import json
        import os

        from ray_tpu_torch import train

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt:
            with open(os.path.join(ckpt, "state.json")) as f:
                start = json.load(f)["step"] + 1
        for step in range(start, 6):
            if step == 3 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                os._exit(1)  # hard worker death, not a python error
            d = os.path.join(train.get_context().trial_dir, f"ckpt_{step}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": step}, f)
            train.report({"step": step}, checkpoint=d)
        return "done"

    trainer = train.TorchTrainer(
        loop,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=train.RunConfig(name="ft_run", failure_max_retries=1),
        train_loop_config={"marker": marker})
    result = bounded(trainer.fit, FIT_S, "fit()")
    steps = [m["step"] for m in result.metrics_history]
    assert result.per_worker_final == ["done"]
    # ran 0,1,2 then died at 3; resumed from the last checkpoint the
    # trainer received through 5
    assert steps == [0, 1, 2, 3, 4, 5], steps


def test_fit_exhausted_retries_raises(cluster):
    def loop():
        os._exit(1)

    trainer = train.TorchTrainer(
        loop,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=train.RunConfig(failure_max_retries=1))
    with pytest.raises(train.TrainingFailedError):
        bounded(trainer.fit, FIT_S, "fit()")
