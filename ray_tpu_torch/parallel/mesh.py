"""Device mesh construction and placement helpers.

The port of ray_tpu/parallel/mesh.py.  The mesh axis vocabulary is the
same:
  - "dp":   pure data parallelism (params replicated, batch sharded)
  - "fsdp": fully-sharded data parallelism (params + batch sharded)
  - "tp":   tensor parallelism (heads / mlp-hidden sharded)
  - "sp":   sequence/context parallelism (sequence dim sharded; ring
            attention rotates K/V around the sp group)
  - "pp":   pipeline stages: not an axis of one program here;
            ``train.TrainPipeline`` runs one actor per stage

``MeshSpec`` and ``mesh_axes_for`` are copies of the JAX package's.
Without a process group a mesh spans one device: the CUDA card by
default, or a CPU device when the caller names it.  After
:func:`ray_tpu_torch.parallel.init_distributed` a mesh spans the
processes of the group, one device each, as a
``torch.distributed.DeviceMesh``; rank r sits where JAX puts device r,
row-major over ``AXIS_ORDER``, so it holds the same batch and sequence
slice.

A placement is written as a dict from mesh axis to the tensor dim it
shards, the counterpart of a ``PartitionSpec``: ``{"dp": 0, "fsdp": 0}``
is ``P(("dp", "fsdp"))``.  Axes that shard one dim split it in
``AXIS_ORDER``, outer axis first, as JAX splits it.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.distributed import local_device

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout; -1 on at most one axis means 'fill'."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        fills = [a for a, v in sizes.items() if v == -1]
        if len(fills) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if fills:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[fills[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return MeshSpec(**sizes)

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def nontrivial_axes(self) -> List[str]:
        return [a for a in AXIS_ORDER if getattr(self, a) > 1]


def mesh_axes_for(n_devices: int, spec: Optional[MeshSpec] = None
                  ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    spec = (spec or MeshSpec(dp=-1)).resolve(n_devices)
    sizes = spec.axis_sizes()
    return tuple(AXIS_ORDER), tuple(sizes[a] for a in AXIS_ORDER)


@dataclass(frozen=True)
class Mesh:
    """A resolved mesh: ``shape`` maps each axis of AXIS_ORDER to its
    size (as ``jax.sharding.Mesh.shape`` does), ``devices`` holds this
    process's device, and ``device_mesh`` is the DeviceMesh over the
    process group (None for a one-device mesh).  ``fsdp_mesh`` is
    FSDP2's: the 2-D (dp_sp, fsdp) sub-mesh, parameters replicated over
    dp and sp together and sharded over fsdp.  Where torch cannot slice
    that, it is the 1-D fsdp sub-mesh, and ``replica_mesh`` the 1-D
    dp_sp sub-mesh over whose processes, which hold the same
    parameters, the grads are still to be summed (None when there is
    nothing to sum)."""

    devices: Tuple[torch.device, ...]
    spec: MeshSpec
    device_mesh: Optional[DeviceMesh] = None
    fsdp_mesh: Optional[DeviceMesh] = None
    replica_mesh: Optional[DeviceMesh] = None

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.axis_sizes()

    @property
    def device(self) -> torch.device:
        """The device this process computes on."""
        return self.devices[0]

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str) -> dist.ProcessGroup:
        """The process group along ``axis`` (its peers differ only
        there)."""
        if self.device_mesh is None:
            raise ValueError("a one-device mesh has no process groups")
        return self.device_mesh.get_group(axis)


_MULTI_DEVICE = (
    "meshes over more than one device (dp/fsdp/tp/sp > 1) need "
    "torch.distributed process groups: call "
    "ray_tpu_torch.parallel.init_distributed in every process first")
_PIPELINE = ("pp > 1 is not a mesh axis of one program: train pipeline "
             "stages with ray_tpu_torch.train.TrainPipeline, one actor "
             "per stage")

# The DeviceMesh's own dim order: AXIS_ORDER with sp moved ahead of
# fsdp, so that dp and sp, the axes that replicate parameters, sit side
# by side and flatten into FSDP2's replicate dim "dp_sp".  The ranks are
# still where AXIS_ORDER puts them.
DEVICE_MESH_ORDER = ("pp", "dp", "sp", "fsdp", "tp")


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Build a mesh.  With ``devices`` (or without a process group), a
    mesh over those devices (default: the one CUDA device), which must
    be one; raises RuntimeError when the devices are CUDA and no CUDA
    device is visible, and NotImplementedError when ``spec`` resolves
    to more than one device.  With a process group and no ``devices``,
    a mesh over the group's processes; ``pp > 1`` raises
    NotImplementedError."""
    if devices is None and dist.is_initialized():
        return _process_mesh(spec)
    devs = tuple(resolve_device(d) for d in
                 (devices if devices is not None else [None]))
    names, sizes = mesh_axes_for(len(devs), spec)
    if math.prod(sizes) > 1:
        raise NotImplementedError(_MULTI_DEVICE)
    return Mesh(devs, MeshSpec(**dict(zip(names, sizes))))


def _process_mesh(spec: Optional[MeshSpec]) -> Mesh:
    n = dist.get_world_size()
    spec = (spec or MeshSpec(dp=-1)).resolve(n)
    if spec.pp > 1:
        raise NotImplementedError(_PIPELINE)
    dev = local_device()
    sizes = spec.axis_sizes()
    ranks = torch.arange(n).reshape([sizes[a] for a in AXIS_ORDER])
    ranks = ranks.permute([AXIS_ORDER.index(a) for a in DEVICE_MESH_ORDER])
    dm = DeviceMesh(dev.type, ranks, mesh_dim_names=DEVICE_MESH_ORDER)
    dm["dp", "sp"]._flatten("dp_sp")
    with warnings.catch_warnings():
        # FSDP2 and tensor parallelism must share one root mesh; slicing
        # the flattened dim from the root is how to get there
        warnings.filterwarnings("ignore", message="Slicing a flattened dim")
        # torch 2.11 refuses the (dp_sp, fsdp) slice where sp > 1 at
        # fsdp = 1, and where dp_sp is 1 at tp > 1: its layout gives a
        # dim of size 1 a stride out of order (torch 2.13 slices all)
        replicas = sizes["dp"] * sizes["sp"]
        if (sizes["fsdp"] == 1 and sizes["sp"] > 1) \
                or (replicas == 1 and sizes["tp"] > 1):
            return Mesh((dev,), spec, dm, dm["fsdp"],
                        dm["dp_sp"] if replicas > 1 else None)
        fsdp_mesh = dm["dp_sp", "fsdp"]
    return Mesh((dev,), spec, dm, fsdp_mesh)


def batch_pspec() -> Dict[str, int]:
    """Placement of an activation batch: dim 0 over dp and fsdp
    (``P(("dp", "fsdp"))``)."""
    return {"dp": 0, "fsdp": 0}


def _tree_map(fn: Callable[[str, Any], Any], tree: Any,
              path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _as_tensor(x: Any, device: torch.device) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (np.ndarray, np.generic)):
        # a writable copy: torch refuses read-only arrays
        return torch.from_numpy(np.array(x)).to(device)
    return x


def _local_slice(mesh: Mesh, x: torch.Tensor,
                 placement: Dict[str, int]) -> torch.Tensor:
    """This process's block of ``x`` under ``placement``."""
    for d in sorted(set(placement.values())):
        axes = [a for a in AXIS_ORDER if placement.get(a) == d]
        parts, idx = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.index(a)
        if x.shape[d] % parts:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"over {axes} ({parts} parts)")
        size = x.shape[d] // parts
        x = x.narrow(d, idx * size, size)
    return x


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This process's slice of a tree of host arrays or tensors, on its
    device (numpy int32 tokens become an int32 tensor): dim 0 over
    (dp, fsdp), and dim 1 (sequence) over sp when sp > 1, as the JAX
    package places a batch.  Every process passes the whole batch."""
    def put(_path, x):
        x = _as_tensor(x, mesh.device)
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        placement = batch_pspec()
        if x.dim() >= 2 and mesh.shape["sp"] > 1:
            placement["sp"] = 1
        return _local_slice(mesh, x, placement).contiguous()
    return _tree_map(put, batch)


def gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole of a tensor that :func:`shard_batch` split, on every
    process of the mesh: all-gathers dim 0 over fsdp and then dp, and
    dim 1 over sp.  Processes that differ only in tp hold the same
    value already.  A one-device mesh returns ``x``."""
    for axis, dim in (("fsdp", 0), ("dp", 0), ("sp", 1)):
        n = mesh.shape[axis]
        if n == 1 or (dim == 1 and x.dim() < 2):
            continue
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
        x = torch.cat(parts, dim=dim)
    return x


def _placements(placement: Optional[Dict[str, int]]):
    placement = placement or {}
    return [Shard(placement[a]) if a in placement else Replicate()
            for a in DEVICE_MESH_ORDER]


def shard_params(mesh: Mesh, params: Any,
                 rules: Optional[Dict[str, Optional[Dict[str, int]]]] = None
                 ) -> Any:
    """Place a parameter tree on the mesh.  On one device every leaf is
    replicated whatever ``rules`` say.  Over a process group each tensor
    becomes a DTensor: the first rule whose key is a substring of the
    leaf's path ("a/b/c") gives its placement (None: replicated);
    without one, its largest dim is sharded over fsdp when it divides,
    as the JAX package's fallback does.  Values come from rank 0."""
    def put(path, x):
        x = _as_tensor(x, mesh.device)
        if mesh.device_mesh is None or not isinstance(x, torch.Tensor):
            return x
        for pattern, placement in (rules or {}).items():
            if pattern in path:
                break
        else:
            placement = None
            fsdp = mesh.shape["fsdp"]
            if fsdp > 1 and x.dim() >= 1:
                best = max(range(x.dim()), key=lambda i: x.shape[i])
                if x.shape[best] % fsdp == 0:
                    placement = {"fsdp": best}
        return distribute_tensor(x, mesh.device_mesh,
                                 _placements(placement))
    return _tree_map(put, params)
