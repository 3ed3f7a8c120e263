"""PPO Learner: the gradient-update half of the algorithm, in PyTorch.

The port of ray_tpu/rllib/core/learner.py (reference:
rllib/core/learner/learner.py, learner_group.py:64 — update_from_batch;
PPO loss rllib/algorithms/ppo/torch/ppo_torch_learner.py).  One update
computes GAE over the [T, E] rollout (a reverse loop over T, where the
JAX package runs ``lax.scan``), normalizes the advantages, then runs
``num_epochs`` passes of shuffled minibatches, each a clipped-surrogate
PPO loss with value and entropy terms, ``clip_grad_norm_`` and one
``torch.optim.Adam`` step (optax's ``clip_by_global_norm`` + ``adam``).
The permutations come from a ``torch.Generator`` seeded from ``seed``.
The learner runs on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device

# optax.adam's defaults, which torch.optim.Adam's equal
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
_BATCH_KEYS = ("obs", "actions", "logp", "values", "rewards", "nonterminal",
               "mask", "last_value")


def gae(rewards: torch.Tensor, values: torch.Tensor,
        last_value: torch.Tensor, nonterminal: torch.Tensor,
        mask: torch.Tensor, gamma: float, lam: float) -> torch.Tensor:
    """Generalized advantage estimates [T, E], from the last step back:
    ``adv_t = (delta_t + gamma * lam * nonterminal_t * adv_{t+1}) *
    mask_t`` with ``delta_t = r_t + gamma * v_{t+1} * nonterminal_t -
    v_t`` (``v_T`` is ``last_value``); a masked (reset) transition
    carries nothing."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    advs = torch.empty_like(rewards)
    carry = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = (rewards[t] + gamma * next_values[t] * nonterminal[t]
                 - values[t])
        carry = (delta + gamma * lam * nonterminal[t] * carry) * mask[t]
        advs[t] = carry
    return advs


class PPOLearner:
    def __init__(self, module, *, lr: float = 3e-4, gamma: float = 0.99,
                 gae_lambda: float = 0.95, clip_eps: float = 0.2,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 num_epochs: int = 4, minibatch_size: int = 256,
                 max_grad_norm: float = 0.5, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.clip_eps = clip_eps
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        self.max_grad_norm = max_grad_norm
        self.opt = torch.optim.Adam(self.module.parameters(), lr=lr,
                                    betas=ADAM_BETAS, eps=ADAM_EPS)
        # the minibatch permutations, drawn on the host
        self._gen = torch.Generator().manual_seed(int(seed) + 1)

    def _loss(self, b: Dict[str, torch.Tensor]):
        logits, values = self.module(b["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, b["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - b["logp_old"])
        m = b["mask"]
        msum = m.sum().clamp_min(1.0)
        adv = b["adv"]
        surr = torch.minimum(
            ratio * adv,
            ratio.clamp(1 - self.clip_eps, 1 + self.clip_eps) * adv)
        pi_loss = -(surr * m).sum() / msum
        vf_loss = ((values - b["v_target"]).square() * m).sum() / msum
        entropy = (-(logp_all.exp() * logp_all).sum(-1) * m).sum() / msum
        total = pi_loss + self.vf_coeff * vf_loss \
            - self.entropy_coeff * entropy
        return total, (pi_loss, vf_loss, entropy)

    def _tensors(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k in _BATCH_KEYS:
            x = torch.as_tensor(np.asarray(batch[k]))
            x = x.long() if k == "actions" else x.float()
            out[k] = x.to(self.device)
        return out

    def update_from_batch(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One PPO update over a [T, E] rollout batch.  Returns the mean
        of each loss term over every minibatch step."""
        b = self._tensors(batch)
        T, E = b["rewards"].shape
        with torch.no_grad():
            adv = gae(b["rewards"], b["values"], b["last_value"],
                      b["nonterminal"], b["mask"], self.gamma,
                      self.gae_lambda)
            v_target = adv + b["values"]
            flat = {
                "obs": b["obs"].reshape(T * E, -1),
                "actions": b["actions"].reshape(T * E),
                "logp_old": b["logp"].reshape(T * E),
                "adv": adv.reshape(T * E),
                "v_target": v_target.reshape(T * E),
                "mask": b["mask"].reshape(T * E),
            }
            # normalize advantages over valid transitions
            m = flat["mask"]
            msum = m.sum().clamp_min(1.0)
            mean = (flat["adv"] * m).sum() / msum
            var = ((flat["adv"] - mean).square() * m).sum() / msum
            flat["adv"] = (flat["adv"] - mean) / torch.sqrt(var + 1e-8)
        N = T * E
        mb = min(self.minibatch_size, N)  # small rollouts: one = all
        n_mb = max(1, N // mb)
        stats = []
        for _ in range(self.num_epochs):
            perm = torch.randperm(N, generator=self._gen)[:n_mb * mb]
            perm = perm.to(self.device)
            for i in range(n_mb):
                idx = perm[i * mb:(i + 1) * mb]
                total, aux = self._loss({k: v[idx] for k, v in flat.items()})
                self.opt.zero_grad(set_to_none=True)
                total.backward()
                torch.nn.utils.clip_grad_norm_(self.module.parameters(),
                                               self.max_grad_norm)
                self.opt.step()
                stats.append(torch.stack([total.detach(), *aux]).detach())
        mean_stats = torch.stack(stats).mean(0).tolist()  # one host read
        return dict(zip(("total_loss", "policy_loss", "vf_loss", "entropy"),
                        mean_stats))

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The module's weights as CPU tensors (store-friendly)."""
        return self.module.get_weights()
