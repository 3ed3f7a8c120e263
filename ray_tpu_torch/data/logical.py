"""Logical plan + rewrite rules for ray_tpu_torch.data.

Small re-imagining of the reference's logical/physical planner split
(reference: python/ray/data/_internal/logical/interfaces.py LogicalPlan
+ Rule; rules/operator_fusion.py OperatorFusionRule;
planner/planner.py): a Dataset accumulates LogicalOp nodes; before
execution the plan runs through an ordered list of rewrite rules, and
the physical executor consumes the rewritten plan.  Today's rules:

  * LimitPushdown — adjacent ``limit`` nodes merge (min wins) and a
    limit hops ahead of row-count-preserving per-row maps, so the
    executor stops launching block tasks at the limit instead of
    transforming rows it will drop (reference:
    rules/limit_pushdown.py).

  * FuseMapOperators — adjacent per-row/per-batch transforms collapse
    into one ``fused_map`` node executed as a single task (or actor
    call) per block, the fusion the reference expresses in
    operator_fusion.py.

The rule list is the extension seam: later rules (predicate pushdown,
exchange planning) append here without touching the Dataset surface.
The executor fails loudly on plan nodes it has no physical translation
for, so a new rule cannot silently drop work.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Optional

# map-like ops are fusable: one task per block applies the whole chain
MAP_LIKE = ("map", "map_batches", "flat_map", "filter")


class LogicalOp:
    """One node of the (linear, for now) logical plan."""

    __slots__ = ("name", "payload")

    def __init__(self, name: str, payload: Any = None):
        self.name = name
        self.payload = payload  # _Op for map-likes; op params otherwise

    def describe(self) -> str:
        if self.name == "fused_map":
            inner = ", ".join(getattr(o.fn, "__name__", o.kind)
                              for o in self.payload)
            return f"FusedMap[{inner}]"
        if self.name == "limit":
            return f"Limit[{self.payload}]"
        if self.payload is not None and hasattr(self.payload, "kind"):
            fn = getattr(self.payload.fn, "__name__", "fn")
            return f"{self.name.title()}({fn})"
        return self.name.title()


class Rule(ABC):
    """A plan-to-plan rewrite (reference: logical/interfaces.py Rule)."""

    name: str = "rule"

    @abstractmethod
    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        ...


class FuseMapOperators(Rule):
    """Collapse adjacent map-like ops into one fused_map node so the
    executor runs the whole chain as a single task per block
    (reference: rules/operator_fusion.py)."""

    name = "fuse_map_operators"

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        out: List[LogicalOp] = []
        for op in ops:
            if op.name in MAP_LIKE:
                if out and out[-1].name == "fused_map":
                    out[-1].payload.append(op.payload)
                else:
                    out.append(LogicalOp("fused_map", [op.payload]))
            else:
                out.append(op)
        return out


class LimitPushdown(Rule):
    """Merge adjacent ``limit`` nodes (min wins) and push a limit ahead
    of a preceding per-row ``map`` — maps are 1:1 and order-preserving,
    so limiting first is equivalent and spares transforming rows the
    limit would drop.  Non-row-preserving ops (filter, flat_map,
    map_batches) block the hop.  Runs before fusion so the map-likes
    left adjacent after the hop still fuse."""

    name = "limit_pushdown"

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        out = list(ops)
        changed = True
        while changed:
            changed = False
            i = 0
            while i < len(out):
                node = out[i]
                if node.name != "limit" or i == 0:
                    i += 1
                    continue
                prev = out[i - 1]
                if prev.name == "limit":
                    out[i - 1] = LogicalOp(
                        "limit", min(prev.payload, node.payload))
                    del out[i]
                    changed = True
                elif prev.name == "map":
                    out[i - 1], out[i] = node, prev
                    changed = True
                    i += 1
                else:
                    i += 1
        return out


DEFAULT_RULES: List[Rule] = [LimitPushdown(), FuseMapOperators()]


def optimize(ops: List[LogicalOp],
             rules: Optional[List[Rule]] = None) -> List[LogicalOp]:
    for rule in (rules if rules is not None else DEFAULT_RULES):
        ops = rule.apply(ops)
    return ops


def describe(ops: List[LogicalOp]) -> str:
    return " -> ".join(op.describe() for op in ops) or "(empty)"
