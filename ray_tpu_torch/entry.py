"""The port's forward entry point: the flagship Llama model's no-cache
forward at ``LlamaConfig.small()`` over [8, 512] tokens, which routes
attention through the flash kernel (S = 512 is causal, at least
``FLASH_PREFILL_MIN_SEQ`` and a multiple of 128)."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel


def entry(device: DeviceLike = None
          ) -> Tuple[Callable[..., torch.Tensor], Tuple[Any, ...]]:
    """-> (forward, (model, tokens)): ``forward(model, tokens)`` returns
    the logits [8, 512, vocab], with weights from seed 0.  Runs on
    ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cfg = LlamaConfig.small()
    model = LlamaModel(cfg, device=dev, seed=0).eval()
    tokens = torch.zeros((8, 512), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def forward(model: LlamaModel, tokens: torch.Tensor) -> torch.Tensor:
        return model(tokens)

    return forward, (model, tokens)
