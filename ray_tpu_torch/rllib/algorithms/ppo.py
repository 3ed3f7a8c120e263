"""PPO: sample -> update -> weight-sync on the port's actors.

The port of ray_tpu/rllib/algorithms/ppo.py (reference:
rllib/algorithms/ppo/ppo.py:403 training_step — sample via EnvRunners,
update via the learner group, sync weights back; algorithm_config.py for
the typed builder).  The learner is PyTorch (core/learner.py) on the
card, or on the CPU when ``.learners(device="cpu")`` asks for it;
EnvRunners are CPU actors, and the weights travel through the object
store as a state dict of CPU tensors — a put per iteration fanned to
every runner.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional


class PPOConfig:
    """Typed config builder (reference: AlgorithmConfig chaining)."""

    def __init__(self):
        self.env_name = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 128
        self.lr = 3e-4
        self.gamma = 0.99
        self.gae_lambda = 0.95
        self.clip_eps = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 4
        self.minibatch_size = 256
        self.hidden = (64, 64)
        self.seed = 0
        self.learner_device = None  # the card

    def environment(self, env: str) -> "PPOConfig":
        self.env_name = env
        return self

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 8,
                    rollout_fragment_length: int = 128) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 lambda_: Optional[float] = None,
                 clip_param: Optional[float] = None,
                 vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 num_epochs: Optional[int] = None,
                 minibatch_size: Optional[int] = None,
                 model_hidden: Optional[tuple] = None) -> "PPOConfig":
        for name, val in [("lr", lr), ("gamma", gamma),
                          ("gae_lambda", lambda_), ("clip_eps", clip_param),
                          ("vf_coeff", vf_loss_coeff),
                          ("entropy_coeff", entropy_coeff),
                          ("num_epochs", num_epochs),
                          ("minibatch_size", minibatch_size),
                          ("hidden", model_hidden)]:
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, device: Optional[str] = None) -> "PPOConfig":
        """The learner's device: None for the card, or "cpu"."""
        self.learner_device = device
        return self

    def debugging(self, seed: int = 0) -> "PPOConfig":
        self.seed = seed
        return self

    def build(self) -> "PPO":
        return PPO(self)

    def to_trainable(self, stop_reward: float = float("inf"),
                     max_iterations: int = 100) -> Callable:
        """A Tune-compatible trainable running this PPO config; config
        overrides from the Tuner's param_space are applied on top
        (reference: Algorithm as a Tune Trainable)."""
        base = self

        def trainable(config: Dict[str, Any]):
            from ray_tpu_torch import train as rt_train

            algo_cfg = PPOConfig()
            algo_cfg.__dict__.update(base.__dict__)
            algo_cfg.__dict__.update(config)
            algo = algo_cfg.build()
            try:
                for _ in range(max_iterations):
                    result = algo.train()
                    rt_train.report(result)
                    if result["episode_return_mean"] >= stop_reward:
                        break
            finally:
                algo.stop()

        return trainable


class PPO:
    """The algorithm driver (reference: Algorithm.step/training_step)."""

    def __init__(self, config: PPOConfig):
        import gymnasium as gym
        import ray_tpu_torch
        from ray_tpu_torch.rllib.core.learner import PPOLearner
        from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule
        from ray_tpu_torch.rllib.env_runner import EnvRunner

        self.config = config
        probe = gym.make(config.env_name)
        obs_dim = int(probe.observation_space.shape[0])
        num_actions = int(probe.action_space.n)
        probe.close()
        module_config = {"obs_dim": obs_dim, "num_actions": num_actions,
                         "hidden": tuple(config.hidden)}
        self.module = ActorCriticModule(**module_config, seed=config.seed,
                                        device="cpu")
        self.learner = PPOLearner(
            self.module, lr=config.lr, gamma=config.gamma,
            gae_lambda=config.gae_lambda, clip_eps=config.clip_eps,
            vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
            num_epochs=config.num_epochs,
            minibatch_size=config.minibatch_size, seed=config.seed,
            device=config.learner_device)
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        self.runners = [
            runner_cls.remote(config.env_name, config.num_envs_per_runner,
                              module_config, seed=config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)]
        self.iteration = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        """One iteration: parallel rollouts -> update -> metrics
        (reference: ppo.py:403 training_step)."""
        import numpy as np
        import ray_tpu_torch

        t0 = time.perf_counter()
        weights_ref = ray_tpu_torch.put(self.learner.get_weights())
        T = self.config.rollout_fragment_length
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(weights_ref, T) for r in self.runners],
            timeout=600)
        sample_s = time.perf_counter() - t0
        batch = {
            k: np.concatenate([ro[k] for ro in rollouts], axis=1)
            for k in ("obs", "actions", "logp", "values", "rewards",
                      "nonterminal", "mask")}
        batch["last_value"] = np.concatenate(
            [ro["last_value"] for ro in rollouts], axis=0)
        t1 = time.perf_counter()
        stats = self.learner.update_from_batch(batch)
        update_s = time.perf_counter() - t1
        for ro in rollouts:
            self._recent_returns.extend(ro["episode_returns"])
        self._recent_returns = self._recent_returns[-100:]
        self.iteration += 1
        env_steps = T * self.config.num_envs_per_runner * len(self.runners)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else 0.0),
            "num_env_steps_sampled": env_steps * self.iteration,
            "env_steps_per_s": env_steps / max(sample_s + update_s, 1e-9),
            "time_sample_s": round(sample_s, 4),
            "time_update_s": round(update_s, 4),
            **stats,
        }

    def evaluate(self, num_episodes: int = 10) -> float:
        import ray_tpu_torch

        weights_ref = ray_tpu_torch.put(self.learner.get_weights())
        return ray_tpu_torch.get(
            self.runners[0].evaluate.remote(weights_ref, num_episodes),
            timeout=300)

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self) -> None:
        import ray_tpu_torch

        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
