"""Scheduling strategies for tasks and actors.

Equivalent of the reference's strategy objects
(reference: python/ray/util/scheduling_strategies.py —
NodeAffinitySchedulingStrategy :1, NodeLabelSchedulingStrategy, and the
"SPREAD"/"DEFAULT" string strategies).
"""

from __future__ import annotations

from typing import Dict, Optional, Union


class NodeAffinitySchedulingStrategy:
    """Pin a task/actor to one node.  ``soft=False`` fails scheduling if
    the node cannot take it; ``soft=True`` falls back to the default
    policy."""

    def __init__(self, node_id: str, soft: bool = False):
        if not node_id:
            raise ValueError("node_id is required")
        self.node_id = node_id
        self.soft = soft

    def to_wire(self) -> Dict[str, object]:
        return {"type": "node_affinity", "node_id": self.node_id,
                "soft": self.soft}


class NodeLabelSchedulingStrategy:
    """Restrict placement to nodes whose labels match ``hard`` exactly."""

    def __init__(self, hard: Optional[Dict[str, str]] = None):
        self.hard = dict(hard or {})

    def to_wire(self) -> Dict[str, object]:
        return {"type": "node_label", "hard": self.hard}


SchedulingStrategyT = Union[str, NodeAffinitySchedulingStrategy,
                            NodeLabelSchedulingStrategy, None]


def strategy_to_wire(strategy: SchedulingStrategyT) -> Dict[str, object]:
    if strategy is None or strategy == "DEFAULT":
        return {}
    if strategy == "SPREAD":
        return {"type": "spread"}
    if isinstance(strategy, (NodeAffinitySchedulingStrategy,
                             NodeLabelSchedulingStrategy)):
        return strategy.to_wire()
    raise ValueError(f"unknown scheduling strategy: {strategy!r}")
