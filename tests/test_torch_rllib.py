"""The port's PPO slice (ray_tpu_torch/rllib) against ray_tpu's, on the CPU.

  - GAE: the port's reverse loop over T equals the JAX learner's own
    reverse ``lax.scan`` on the same arrays up to fp32 rounding (1e-6:
    both take the same operations in the same order).
  - One update: the JAX ``PPOLearner`` and the port's, from the same
    flax init (carried across with ``rl_module.params_from_flax``), on
    the same rollout, with the minibatch equal to the batch so the
    shuffled order of rows cannot matter, leave the weights within
    fp32 tolerance of each other (bounds and reasons at
    ``PARAM_ATOL``) and report the same losses within 1e-5 relative.
  - The env runner, as an actor of the port's cluster, returns a
    consistent [T, E] CartPole rollout (it needs gymnasium).
  - PPO learns CartPole on the port's cluster, the learner on the CPU,
    as tests/test_rllib.py:78 does on ray_tpu's.

Every blocking call has a timeout.
"""

import os

import numpy as np
import pytest
import torch

import jax

from tests.conftest import force_cpu_jax

import ray_tpu_torch as rt
from ray_tpu.rllib.core import learner as jlearner
from ray_tpu.rllib.core import rl_module as jmodule
from ray_tpu_torch.rllib.core.learner import PPOLearner, gae
from ray_tpu_torch.rllib.core.rl_module import (ActorCriticModule,
                                                params_from_flax)
from tests.torch_waits import bounded

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

GAE_TOL = 1e-6
STATS_REL = 1e-5
# Adam's first steps move each weight by about lr * sign(g): where a
# gradient sits at rounding noise the two frameworks may step in
# opposite directions, 2 * lr apart per step, and nothing else can move
# a weight further; everywhere else they agree to fp32 rounding.
PARAM_ATOL = 1e-5
PARAM_SHARE = 0.999


def _rollout(T, E, seed=0, obs_dim=4):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(T, E, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(T, E)).astype(np.int32),
        "logp": rng.uniform(-1.2, -0.3, size=(T, E)).astype(np.float32),
        "values": rng.normal(size=(T, E)).astype(np.float32),
        "rewards": rng.uniform(0, 1, size=(T, E)).astype(np.float32),
        "nonterminal": (rng.uniform(size=(T, E)) > 0.05).astype(np.float32),
        "mask": (rng.uniform(size=(T, E)) > 0.1).astype(np.float32),
        "last_value": rng.normal(size=(E,)).astype(np.float32),
    }


def _jax_gae(learner):
    """The JAX learner's own GAE: the reverse scan its update closes
    over."""
    fn = learner._build_update().__wrapped__
    free = dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))
    return free["gae"]


def test_gae_equals_the_jax_reverse_scan():
    module = jmodule.ActorCriticModule(obs_dim=4, num_actions=2)
    jl = jlearner.PPOLearner(module, gamma=0.98, gae_lambda=0.9)
    b = _rollout(64, 8)
    keys = ("rewards", "values", "last_value", "nonterminal", "mask")
    want = np.asarray(_jax_gae(jl)(*(b[k] for k in keys)))
    got = gae(*(torch.from_numpy(b[k]) for k in keys), 0.98, 0.9).numpy()
    assert got.shape == (64, 8)
    np.testing.assert_allclose(got, want, rtol=GAE_TOL, atol=GAE_TOL)


def test_module_equals_the_flax_module():
    module = jmodule.ActorCriticModule(obs_dim=4, num_actions=3,
                                       hidden=(32, 16))
    params = module.init(jax.random.PRNGKey(0))
    obs = np.random.default_rng(1).normal(size=(10, 4)).astype(np.float32)
    logits, value = (np.asarray(a) for a in module.apply(params, obs))
    port = ActorCriticModule(4, 3, hidden=(32, 16), device="cpu")
    port.load_state_dict(params_from_flax(params, hidden=(32, 16)))
    with torch.no_grad():
        tl, tv = port(torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), value, rtol=1e-5, atol=1e-6)
    assert torch.equal(port.forward_inference(torch.from_numpy(obs)),
                       torch.from_numpy(np.argmax(logits, -1)))


def test_module_init_scales():
    """flax's scales: orthogonal heads of gain 0.01 and 1.0, zero
    biases, the same draw from the same seed."""
    m = ActorCriticModule(4, 2, seed=5, device="cpu")
    w = m.policy_head.weight
    np.testing.assert_allclose((w @ w.T).detach().numpy(),
                               1e-4 * np.eye(2), atol=1e-9)
    v = m.value_head.weight.detach()
    assert abs(float(v.norm()) - 1.0) < 1e-5
    assert all(float(p.detach().abs().max()) == 0
               for n, p in m.named_parameters()
               if n.endswith("bias"))
    again = ActorCriticModule(4, 2, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(m.state_dict().values(), again.state_dict().values()))


def test_learner_update_matches_the_jax_learner():
    T, E = 32, 4
    batch = _rollout(T, E, seed=2)
    module = jmodule.ActorCriticModule(obs_dim=4, num_actions=2)
    jl = jlearner.PPOLearner(module, minibatch_size=T * E, num_epochs=3,
                             lr=1e-3, seed=0)
    init = jax.tree_util.tree_map(np.array, jl.params)
    jstats = jl.update_from_batch(batch)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jl.params))

    port = ActorCriticModule(4, 2, device="cpu")
    port.load_state_dict(params_from_flax(init))
    tlrn = PPOLearner(port, minibatch_size=T * E, num_epochs=3, lr=1e-3,
                      seed=0, device="cpu")
    tstats = tlrn.update_from_batch(batch)
    for k, v in jstats.items():
        assert abs(tstats[k] - v) <= STATS_REL * max(abs(v), 1e-3), \
            (k, tstats[k], v)
    got = tlrn.get_weights()
    moved = 0.0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        assert float(diff.max()) <= 2 * 1e-3 * 3, name
        assert float((diff <= PARAM_ATOL).float().mean()) >= PARAM_SHARE, \
            (name, float(diff.max()))
        moved = max(moved, float((w - params_from_flax(init)[name])
                                 .abs().max()))
    assert moved > 1e-4, "the update did not move the weights"


def test_learner_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOLearner(ActorCriticModule(4, 2, device="cpu"))


# ------------------------------------------------------------ the cluster


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    # the env runners inherit it: a policy over 8 envs needs no thread
    # pool, and a pool per runner crowds the machine
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    bounded(lambda: rt.init(num_cpus=4,
                            object_store_memory=64 * 1024 * 1024),
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


def test_env_runner_rollout(cluster):
    """Port of test_rllib.py:54: an EnvRunner actor returns a consistent
    [T, E] rollout."""
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    module_cfg = {"obs_dim": 4, "num_actions": 2}
    runner = rt.remote(EnvRunner).remote("CartPole-v1", 4, module_cfg,
                                         seed=0)
    weights = ActorCriticModule(**module_cfg, device="cpu").get_weights()
    ro = rt.get(runner.sample.remote(weights, 64), timeout=120)
    assert ro["obs"].shape == (64, 4, 4)
    assert ro["actions"].shape == (64, 4)
    for k in ("logp", "values", "rewards", "nonterminal", "mask"):
        assert ro[k].shape == (64, 4) and ro[k].dtype == np.float32, k
    assert ro["last_value"].shape == (4,)
    assert np.all(ro["logp"] <= 0)
    assert ro["mask"].mean() > 0.5
    assert len(ro["episode_returns"]) > 0
    rt.kill(runner)


def test_ppo_learns_cartpole(cluster):
    """Port of test_rllib.py:78: CartPole reward > 450, the learner on
    the CPU."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=128)
            .training(lr=2.5e-4, minibatch_size=128, num_epochs=4)
            .learners(device="cpu")
            .debugging(seed=3)
            .build())

    def learn():
        best = 0.0
        for _ in range(150):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best > 450:
                break
        return best

    try:
        best = bounded(learn, 300, "PPO training")
        assert best > 450, f"PPO only reached {best} return"
        assert bounded(lambda: algo.evaluate(num_episodes=5), 120) > 400
    finally:
        algo.stop()
