"""The process group under a multi-process mesh.

The port of ``TrainWorker.init_jax_distributed``
(ray_tpu/train/worker_group.py): every process of a job calls
:func:`init_distributed` with the same coordinator and its own id, and
from then on :func:`ray_tpu_torch.parallel.make_mesh` lays its mesh over
the processes instead of over one device.  A process drives one device:
``cuda:LOCAL_RANK`` over nccl (the default), or the CPU over gloo when
the caller names it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ray_tpu_torch._private.device import DeviceLike, resolve_device


def _init_method(coordinator: str) -> str:
    """``host:port`` (the JAX coordinator's form) becomes a tcp URL; a
    URL (``tcp://``, ``file://``, ``env://``) is taken as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: DeviceLike = None) -> int:
    """Join the job's process group; returns the world size, as
    ``jax.device_count()`` does after ``jax.distributed.initialize``.

    ``device=None`` runs on ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the
    environment, else ``process_id`` modulo the visible cards) over
    nccl, and raises without a GPU; ``device="cpu"`` runs over gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=_init_method(coordinator),
                                world_size=num_processes, rank=process_id,
                                device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=_init_method(coordinator),
                                world_size=num_processes, rank=process_id)
    else:
        raise ValueError(f"init_distributed runs on cuda or cpu, not {dev}")
    return dist.get_world_size()


def local_device() -> torch.device:
    """The device this process drives in its process group."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
