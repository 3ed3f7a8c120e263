"""EnvRunner: vectorized environment sampling actor.

The port of ray_tpu/rllib/env_runner.py (reference:
rllib/env/single_agent_env_runner.py — gymnasium vector envs stepped
with the current module weights, returning episodes to the algorithm).
It runs as a CPU actor of the port's runtime, whose lease hides every
card, so its policy runs on the CPU, named explicitly; rollout arrays
ride the object store back to the learner.

Gymnasium >= 1.0 vector autoreset is NextStep mode: the step after a
terminal one resets that sub-env (its transition is a reset, not a
real step) — those transitions are masked out of the loss instead of
being special-cased.
"""

from __future__ import annotations

from typing import Any, Dict


class EnvRunner:
    def __init__(self, env_name: str, num_envs: int,
                 module_config: Dict[str, Any], seed: int = 0):
        import gymnasium as gym
        import numpy as np
        import torch

        from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule

        self.envs = gym.make_vec(env_name, num_envs=num_envs)
        self.num_envs = num_envs
        self.module = ActorCriticModule(**module_config, device="cpu")
        self._gen = torch.Generator().manual_seed(int(seed))
        obs, _ = self.envs.reset(seed=seed)
        self._obs = np.asarray(obs, dtype=np.float32)
        # envs needing a reset-step next (NextStep autoreset bookkeeping)
        self._autoreset = np.zeros(num_envs, dtype=bool)
        self._episode_return = np.zeros(num_envs, dtype=np.float64)
        self._episode_len = np.zeros(num_envs, dtype=np.int64)
        self._completed: list = []  # finished episode returns

    def _policy(self, obs):
        import torch

        return self.module.forward_exploration(torch.from_numpy(obs),
                                               self._gen)

    def sample(self, weights, num_steps: int) -> Dict[str, Any]:
        """Collect a [T, E] rollout with the given weights (a state dict).

        Returns numpy arrays: obs/actions/logp/values/rewards/
        nonterminal/mask + last_value, plus episode stats.
        """
        import numpy as np

        self.module.load_state_dict(weights)
        T, E = num_steps, self.num_envs
        out = {
            "obs": np.zeros((T, E) + self._obs.shape[1:], np.float32),
            "actions": np.zeros((T, E), np.int32),
            "logp": np.zeros((T, E), np.float32),
            "values": np.zeros((T, E), np.float32),
            "rewards": np.zeros((T, E), np.float32),
            "nonterminal": np.ones((T, E), np.float32),
            "mask": np.ones((T, E), np.float32),
        }
        self._completed = []
        for t in range(T):
            action, logp, value = self._policy(self._obs)
            action = action.numpy()
            out["obs"][t] = self._obs
            out["actions"][t] = action
            out["logp"][t] = logp.numpy()
            out["values"][t] = value.numpy()
            # transitions taken from an autoreset step carry no reward
            # signal for the PREVIOUS episode: mask them out
            out["mask"][t] = (~self._autoreset).astype(np.float32)
            obs, reward, terminated, truncated, _ = self.envs.step(action)
            reward = np.asarray(reward, np.float32)
            terminated = np.asarray(terminated)
            truncated = np.asarray(truncated)
            out["rewards"][t] = reward * (~self._autoreset)
            # value bootstrap stops at termination; truncation bootstraps
            out["nonterminal"][t] = (~terminated).astype(np.float32)
            live = ~self._autoreset
            self._episode_return[live] += reward[live]
            self._episode_len[live] += 1
            done = (terminated | truncated) & live
            for i in np.nonzero(done)[0]:
                self._completed.append(
                    (float(self._episode_return[i]),
                     int(self._episode_len[i])))
                self._episode_return[i] = 0.0
                self._episode_len[i] = 0
            self._autoreset = terminated | truncated
            self._obs = np.asarray(obs, np.float32)
        _, _, last_value = self._policy(self._obs)
        out["last_value"] = last_value.numpy()
        out["episode_returns"] = [r for r, _ in self._completed]
        out["episode_lens"] = [l for _, l in self._completed]
        return out

    def evaluate(self, weights, num_episodes: int = 5,
                 max_steps: int = 1000) -> float:
        """Mean greedy-policy return (reference: evaluation rollouts)."""
        import numpy as np
        import torch

        self.module.load_state_dict(weights)
        env = self.envs
        obs, _ = env.reset()
        obs = np.asarray(obs, np.float32)
        returns: list = []
        ep_ret = np.zeros(self.num_envs)
        autoreset = np.zeros(self.num_envs, dtype=bool)
        steps = 0
        while len(returns) < num_episodes and steps < max_steps:
            action = self.module.forward_inference(
                torch.from_numpy(obs)).numpy()
            obs, r, term, trunc, _ = env.step(action)
            obs = np.asarray(obs, np.float32)
            live = ~autoreset
            ep_ret[live] += np.asarray(r)[live]
            done = (np.asarray(term) | np.asarray(trunc)) & live
            for i in np.nonzero(done)[0]:
                returns.append(float(ep_ret[i]))
                ep_ret[i] = 0.0
            autoreset = np.asarray(term) | np.asarray(trunc)
            steps += 1
        # leftover state belongs to training sampling: reset cleanly
        obs, _ = self.envs.reset()
        self._obs = np.asarray(obs, np.float32)
        self._autoreset[:] = False
        self._episode_return[:] = 0.0
        self._episode_len[:] = 0
        return float(np.mean(returns)) if returns else 0.0
