"""Device mesh construction and placement helpers.

The port of ray_tpu/parallel/mesh.py.  The mesh axis vocabulary is the
same:
  - "dp":   pure data parallelism (params replicated, batch sharded)
  - "fsdp": fully-sharded data parallelism (params + batch sharded)
  - "tp":   tensor parallelism (heads / mlp-hidden sharded)
  - "sp":   sequence/context parallelism (sequence dim sharded)
  - "pp":   pipeline stages

``MeshSpec`` and ``mesh_axes_for`` are copies of the JAX package's.  A
mesh here spans one device: the one CUDA card by default, or a CPU
device when the caller names it.  Layouts over several devices need
``torch.distributed`` process groups and are not ported yet, so a spec
that resolves to more than one device raises instead of running on one.
On one device every placement is replicated, so ``shard_batch`` and
``shard_params`` move a tree of tensors or numpy arrays onto the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device

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
    size (as ``jax.sharding.Mesh.shape`` does) and ``devices`` holds the
    devices in axis order."""

    devices: Tuple[torch.device, ...]
    spec: MeshSpec

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.axis_sizes()

    @property
    def device(self) -> torch.device:
        """The device of a one-device mesh."""
        if len(self.devices) != 1:
            raise NotImplementedError(_MULTI_DEVICE)
        return self.devices[0]


_MULTI_DEVICE = (
    "meshes over more than one device (dp/fsdp/tp/sp/pp > 1) need "
    "torch.distributed process groups, which the port does not have yet")


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Build a mesh over ``devices`` (default: the one CUDA device).

    Raises RuntimeError when the devices are CUDA and no CUDA device is
    visible, and NotImplementedError when ``spec`` resolves to more
    than one device."""
    devs = tuple(resolve_device(d) for d in
                 (devices if devices is not None else [None]))
    names, sizes = mesh_axes_for(len(devs), spec)
    if math.prod(sizes) > 1:
        raise NotImplementedError(_MULTI_DEVICE)
    return Mesh(devs, MeshSpec(**dict(zip(names, sizes))))


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _place(device: torch.device) -> Callable[[Any], Any]:
    def put(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (np.ndarray, np.generic)):
            # a writable copy: torch refuses read-only arrays
            return torch.from_numpy(np.array(x)).to(device)
        return x
    return put


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """Place a tree of host arrays or tensors on the mesh (numpy int32
    tokens become an int32 tensor).  Every leaf is whole on the mesh's
    one device: dim 0 over (dp, fsdp) and dim 1 over sp are axes of
    size 1 here."""
    return _tree_map(_place(mesh.device), batch)


def shard_params(mesh: Mesh, params: Any,
                 rules: Optional[Dict[str, Any]] = None) -> Any:
    """Place a parameter tree on the mesh.  On one device every leaf is
    replicated whatever ``rules`` say (the JAX package's per-path
    PartitionSpec rules only shard over axes larger than 1)."""
    del rules
    return _tree_map(_place(mesh.device), params)
