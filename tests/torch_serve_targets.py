"""Replica targets of tests/test_torch_serve.py.

The port's replica processes import this module by reference (the
deployment's class is pickled by its module path), so it imports the
port, torch and numpy, and nothing of JAX or ray_tpu.
"""

from __future__ import annotations

import os
import sys

from ray_tpu_torch.serve.llm import _LLMCallable

_REFERENCE_ROOTS = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


class ProbedLLM(_LLMCallable):
    """An ``llm_deployment`` replica target that also reports what its
    process holds."""

    def process(self) -> dict:
        return {"pid": os.getpid(),
                "reference_roots": sorted(
                    {k.split(".")[0] for k in sys.modules
                     if k.split(".")[0] in _REFERENCE_ROOTS}),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES")}
