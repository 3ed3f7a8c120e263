"""Parallelism primitives of the port: the mesh vocabulary of
ray_tpu.parallel over one device (the CUDA card, or the CPU by name), or
over the processes of a torch.distributed group."""

from ray_tpu_torch.parallel.distributed import (init_distributed,
                                                shutdown_distributed)
from ray_tpu_torch.parallel.mesh import (MeshSpec, batch_pspec,
                                         gather_batch, make_mesh,
                                         mesh_axes_for, shard_batch,
                                         shard_params)

__all__ = ["MeshSpec", "batch_pspec", "gather_batch", "init_distributed",
           "make_mesh", "mesh_axes_for", "shard_batch", "shard_params",
           "shutdown_distributed"]
