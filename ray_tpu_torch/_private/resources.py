"""Resource sets with fixed-point arithmetic.

Equivalent of the reference's scheduling resource primitives
(reference: src/ray/common/scheduling/resource_set.h, fixed_point.h,
cluster_resource_data.h): quantities are fixed-point integers with 1e-4
granularity so fractional resources (0.1 CPU) add and subtract exactly;
"TPU" is a first-class resource name alongside CPU/GPU/memory, and TPU
pod slices appear as custom resources (reference:
python/ray/_private/accelerators/tpu.py:335-398).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

PRECISION = 10_000  # 1e-4 resource granularity, matches reference FixedPoint

# Well-known resource names.
CPU = "CPU"
GPU = "GPU"
TPU = "TPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


def _to_fixed(v: float) -> int:
    return round(v * PRECISION)


def _from_fixed(v: int) -> float:
    return v / PRECISION


class ResourceSet:
    """An immutable-by-convention mapping of resource name -> fixed quantity."""

    __slots__ = ("_q",)

    def __init__(self, quantities: Optional[Mapping[str, float]] = None,
                 _fixed: Optional[Dict[str, int]] = None):
        if _fixed is not None:
            self._q = {k: v for k, v in _fixed.items() if v != 0}
        else:
            self._q = {}
            for k, v in (quantities or {}).items():
                fv = _to_fixed(v)
                if fv < 0:
                    raise ValueError(f"negative resource {k}={v}")
                if fv:
                    self._q[k] = fv

    # ---- accessors -------------------------------------------------------

    def get(self, name: str) -> float:
        return _from_fixed(self._q.get(name, 0))

    def names(self) -> Iterable[str]:
        return self._q.keys()

    def is_empty(self) -> bool:
        return not self._q

    def to_dict(self) -> Dict[str, float]:
        return {k: _from_fixed(v) for k, v in self._q.items()}

    def key(self) -> tuple:
        """Hashable scheduling-class key (reference: SchedulingClass)."""
        return tuple(sorted(self._q.items()))

    # ---- arithmetic ------------------------------------------------------

    def fits(self, other: "ResourceSet") -> bool:
        """True if `other` (a demand) fits within self (availability)."""
        return all(self._q.get(k, 0) >= v for k, v in other._q.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._q)
        for k, v in other._q.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet(_fixed=out)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        """Subtract, clamping at zero would hide bugs — raises on underflow."""
        out = dict(self._q)
        for k, v in other._q.items():
            nv = out.get(k, 0) - v
            if nv < 0:
                raise ValueError(f"resource underflow on {k}")
            out[k] = nv
        return ResourceSet(_fixed=out)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._q == other._q

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


class NodeResources:
    """Mutable per-node accounting: total and available."""

    def __init__(self, total: ResourceSet):
        self.total = total
        self.available = total

    def can_fit(self, demand: ResourceSet) -> bool:
        return self.available.fits(demand)

    def is_feasible(self, demand: ResourceSet) -> bool:
        """Could this node *ever* run the demand (ignores current load)."""
        return self.total.fits(demand)

    def acquire(self, demand: ResourceSet) -> bool:
        if not self.available.fits(demand):
            return False
        self.available = self.available.subtract(demand)
        return True

    def release(self, demand: ResourceSet) -> None:
        merged = self.available.add(demand)
        # guard against double-release drifting above total; rebuild so the
        # no-zero-entries ResourceSet invariant holds
        clamped = {k: min(v, self.total._q.get(k, 0)) for k, v in merged._q.items()}
        self.available = ResourceSet(_fixed=clamped)

    def utilization(self) -> float:
        """Max over resources of used/total; 0 when idle (hybrid policy input)."""
        worst = 0.0
        for k, tot in self.total._q.items():
            if tot <= 0:
                continue
            used = tot - self.available._q.get(k, 0)
            worst = max(worst, used / tot)
        return worst

    def to_dict(self) -> Dict[str, Any]:
        return {"total": self.total.to_dict(), "available": self.available.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NodeResources":
        nr = cls(ResourceSet(d["total"]))
        nr.available = ResourceSet(d["available"])
        return nr
