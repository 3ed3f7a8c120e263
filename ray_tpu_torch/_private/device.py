"""Device resolution for the port's entry points.

The port runs on the GPU.  The CPU is honoured only when the caller asks
for it by name (the parity tests do); a missing GPU is an error, never a
silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` when ``device`` is None; otherwise ``device`` itself.

    Raises RuntimeError when the resolved device is CUDA and no CUDA
    device is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
