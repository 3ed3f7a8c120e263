"""RLModule: the policy/value network of the PPO slice, in PyTorch.

The port of ray_tpu/rllib/core/rl_module.py (reference:
rllib/core/rl_module/rl_module.py:867 — forward_inference /
forward_exploration / forward_train as the three entry points): a
discrete-action actor-critic MLP as an ``nn.Module`` that holds its own
weights.  Its weights travel between processes as a state dict of CPU
tensors (``get_weights`` / ``load_state_dict``); ``params_from_flax``
carries the JAX package's flax params across.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device


def _tower(obs_dim: int, hidden: Sequence[int]) -> nn.Sequential:
    layers, n_in = [], obs_dim
    for h in hidden:
        layers += [nn.Linear(n_in, h), nn.Tanh()]
        n_in = h
    return nn.Sequential(*layers)


class ActorCriticModule(nn.Module):
    """Discrete-action actor-critic MLP (reference: rllib's default
    fcnet Catalog models, models/catalog.py).  Separate actor and critic
    tanh towers: a shared trunk lets the high-magnitude value loss
    thrash the policy features (reference: rllib vf_share_layers=False
    default for PPO).

    ``seed`` draws flax's initializers from a ``torch.Generator``: hidden
    kernels lecun-normal, the policy head orthogonal with gain 0.01, the
    value head orthogonal with gain 1.0, biases zero."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        n_last = self.hidden[-1] if self.hidden else obs_dim
        self.actor = _tower(obs_dim, self.hidden)
        self.policy_head = nn.Linear(n_last, num_actions)
        self.critic = _tower(obs_dim, self.hidden)
        self.value_head = nn.Linear(n_last, 1)
        self._init(torch.Generator().manual_seed(int(seed)))
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        heads = {self.policy_head: 0.01, self.value_head: 1.0}
        for mod in self.modules():
            if not isinstance(mod, nn.Linear):
                continue
            if mod in heads:
                nn.init.orthogonal_(mod.weight, gain=heads[mod],
                                    generator=gen)
            else:
                # lecun normal: variance 1/fan_in, truncated at 2 std
                std = (1.0 / mod.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
            mod.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.policy_head.weight.device

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [N, A], value [N])."""
        logits = self.policy_head(self.actor(obs))
        value = self.value_head(self.critic(obs))[..., 0]
        return logits, value

    @torch.no_grad()
    def forward_inference(self, obs: torch.Tensor) -> torch.Tensor:
        """Greedy action (reference: forward_inference)."""
        logits, _ = self(obs)
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def forward_exploration(self, obs: torch.Tensor,
                            generator: torch.Generator):
        """Sampled action + logp + value (reference: forward_exploration);
        ``generator`` lives on the module's device."""
        logits, value = self(obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        action = torch.multinomial(logp_all.exp(), 1,
                                   generator=generator)[:, 0]
        logp = logp_all.gather(-1, action[:, None])[:, 0]
        return action, logp, value

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The state dict as CPU tensors of its own (store-friendly)."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.state_dict().items()}


def params_from_flax(tree: Mapping[str, Any],
                     hidden: Sequence[int] = (64, 64)
                     ) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`ActorCriticModule` from the JAX
    package's flax params (``module.init(rng)``, with or without the
    outer ``"params"``).  Flax names its Dense layers in creation order:
    the actor's hidden layers, the policy head, the critic's hidden
    layers, the value head; kernels are [in, out], ``nn.Linear`` weights
    [out, in]."""
    tree = tree.get("params", tree)
    n = len(hidden)
    names = ([f"actor.{2 * i}" for i in range(n)] + ["policy_head"]
             + [f"critic.{2 * i}" for i in range(n)] + ["value_head"])
    sd = {}
    for i, name in enumerate(names):
        dense = tree[f"Dense_{i}"]
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(dense["kernel"], dtype=np.float32).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(dense["bias"], dtype=np.float32))
    return sd
