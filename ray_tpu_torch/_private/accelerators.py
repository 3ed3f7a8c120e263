"""Accelerator detection: NVIDIA GPUs as a first-class resource.

Ported from ray_tpu's accelerator layer (reference:
python/ray/_private/accelerators/nvidia_gpu.py — CUDA_VISIBLE_DEVICES
:14, device count via the driver :56).  A node advertises ``"GPU": n``;
the node agent maps each lease's share of that count onto concrete
entries of its own visible-device list (node_agent.py, ``gpu_ids``) and
the worker exports them as ``CUDA_VISIBLE_DEVICES`` (worker.py).  TPU
slice metadata and the ``TPU-*`` gang resources have no counterpart on
a GPU host and are not carried over.

Detection imports no torch: the variable when set, else the CUDA
driver's own count (``cuDeviceGetCount`` through ctypes, which does not
create a context on any card).  Device files are not counted: a
container may hold ``/dev/nvidia*`` files for cards it cannot use.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional

GPU_RESOURCE = "GPU"


def visible_devices() -> Optional[List[str]]:
    """The entries of ``CUDA_VISIBLE_DEVICES``, or None when it is unset
    (every card the driver has is visible)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is None:
        return None
    if env.strip() in ("", "none", "NoDevFiles", "-1"):
        return []
    return [d.strip() for d in env.split(",") if d.strip() not in ("", "-1")]


def _driver_device_count() -> int:
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0  # no driver: no usable card
    count = ctypes.c_int(0)
    if cuda.cuInit(0) != 0 or cuda.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def num_gpus() -> int:
    visible = visible_devices()
    return len(visible) if visible is not None else _driver_device_count()


def detect_accelerators() -> Dict[str, float]:
    gpus = num_gpus()
    return {GPU_RESOURCE: float(gpus)} if gpus > 0 else {}
