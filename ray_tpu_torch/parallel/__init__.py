"""Parallelism primitives of the port: the mesh vocabulary of
ray_tpu.parallel over one device (the CUDA card, or the CPU by name).
Meshes over several devices wait for torch.distributed process groups."""

from ray_tpu_torch.parallel.mesh import (MeshSpec, make_mesh, mesh_axes_for,
                                         shard_batch, shard_params)

__all__ = ["MeshSpec", "make_mesh", "mesh_axes_for", "shard_batch",
           "shard_params"]
