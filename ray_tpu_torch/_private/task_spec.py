"""Typed task specification and wire argument encoding.

Equivalent of the reference's TaskSpecification
(reference: src/ray/common/task/task_spec.h, protobuf common.proto
TaskSpec): everything a node agent / worker needs to schedule and run a
task, as a msgpack-able dict. Args follow the reference's inline-vs-ref
split (reference: ray_config_def.h:206 max_direct_call_object_size):
small serialized values travel inside the spec; large ones are put into
the object store and travel as (object_id, owner_address) references.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.resources import ResourceSet

NORMAL_TASK = 0
ACTOR_CREATION_TASK = 1
ACTOR_TASK = 2


@dataclass
class WireArg:
    """One positional/keyword argument on the wire."""

    # exactly one of `value` (serialized bytes, inline) or `object_id` is set
    value: Optional[bytes] = None
    object_id: Optional[str] = None  # hex
    owner_addr: Optional[Tuple[str, int]] = None  # (host, port) of owner's RPC
    kw: Optional[str] = None  # keyword name; None for positional
    # locality hints, stamped from the owner's reference table at submit
    # time (reference: lease_policy.cc best-effort locality data): the
    # node-agent addr holding the primary plasma copy, and its size —
    # pick_node scores feasible nodes by argument bytes already local,
    # and the granting agent prefetches hinted args on lease grant
    size: int = 0
    loc: Optional[Tuple[str, int]] = None  # (host, port) of a holder agent

    def to_wire(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.value is not None:
            d["v"] = self.value
        elif self.object_id is None:
            raise ValueError("WireArg needs exactly one of value/object_id")
        else:
            d["oid"] = self.object_id
            if self.owner_addr:
                d["owner"] = list(self.owner_addr)
            if self.size:
                d["sz"] = self.size
            if self.loc:
                d["loc"] = list(self.loc)
        if self.kw:
            d["kw"] = self.kw
        return d

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "WireArg":
        owner = d.get("owner")
        loc = d.get("loc")
        return cls(
            value=d.get("v"),
            object_id=d.get("oid"),
            owner_addr=tuple(owner) if owner else None,
            kw=d.get("kw"),
            size=d.get("sz", 0),
            loc=tuple(loc) if loc else None,
        )


@dataclass
class TaskSpec:
    task_id: str  # hex
    job_id: str
    kind: int = NORMAL_TASK
    function_id: str = ""  # hex key into the head's function table
    args: List[WireArg] = field(default_factory=list)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 3
    # actor fields
    actor_id: str = ""
    method_name: str = ""
    seqno: int = 0  # per-(caller, actor) ordered delivery
    caller_id: str = ""  # worker id of the submitter, for seqno namespacing
    max_restarts: int = 0  # actor creation only
    max_concurrency: int = 1  # actor creation only
    # scheduling hints
    name: str = ""
    owner_addr: Optional[Tuple[str, int]] = None  # owner RPC addr for returns
    placement_group_id: str = ""
    bundle_index: int = -1
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    # {} | {"type": "spread"} | {"type": "node_affinity", ...} |
    # {"type": "node_label", "hard": {...}} (see util/scheduling_strategies)
    scheduling_strategy: Dict[str, Any] = field(default_factory=dict)
    # active trace context at submission ({"tid": ..., "sid": ...});
    # only present for sampled traces — the worker-side execute span
    # parents to it (see _private/tracing.py)
    trace_ctx: Optional[Dict[str, str]] = None
    # absolute wall-clock deadline (epoch seconds; 0.0 = unbounded),
    # stamped at submission from .options(timeout_s=...) / the ambient
    # deadline context and re-activated by the executing worker so
    # nested .remote() calls inherit the caller's remaining budget
    # (see _private/deadlines.py)
    deadline: float = 0.0

    def resource_set(self) -> ResourceSet:
        return ResourceSet(self.resources)

    def scheduling_class(self) -> tuple:
        """Tasks with the same shape share worker leases (reference:
        SchedulingClassDescriptor in task_spec.h keys on resources AND
        function descriptor — including the function keeps per-class
        service-time stats meaningful, so one fast function can't drag a
        slow one into deep pipelining)."""
        from ray_tpu_torch._private.runtime_env import env_key

        import json

        return (ResourceSet(self.resources).key(), self.kind,
                self.function_id, self.placement_group_id, self.bundle_index,
                env_key(self.runtime_env),
                json.dumps(self.scheduling_strategy, sort_keys=True))

    def to_wire(self) -> Dict[str, Any]:
        d = {
            "tid": self.task_id,
            "jid": self.job_id,
            "kind": self.kind,
            "fid": self.function_id,
            "args": [a.to_wire() for a in self.args],
            "nret": self.num_returns,
            "res": self.resources,
            "retries": self.max_retries,
            "aid": self.actor_id,
            "method": self.method_name,
            "seq": self.seqno,
            "caller": self.caller_id,
            "max_restarts": self.max_restarts,
            "max_conc": self.max_concurrency,
            "name": self.name,
            "owner": list(self.owner_addr) if self.owner_addr else None,
            "pg": self.placement_group_id,
            "bundle": self.bundle_index,
            "renv": self.runtime_env,
            "strat": self.scheduling_strategy,
        }
        if self.trace_ctx:
            d["trace"] = self.trace_ctx
        if self.deadline:
            d["dl"] = self.deadline
        return d

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "TaskSpec":
        owner = d.get("owner")
        return cls(
            task_id=d["tid"],
            job_id=d["jid"],
            kind=d.get("kind", NORMAL_TASK),
            function_id=d.get("fid", ""),
            args=[WireArg.from_wire(a) for a in d.get("args", [])],
            num_returns=d.get("nret", 1),
            resources=d.get("res", {}),
            max_retries=d.get("retries", 3),
            actor_id=d.get("aid", ""),
            method_name=d.get("method", ""),
            seqno=d.get("seq", 0),
            caller_id=d.get("caller", ""),
            max_restarts=d.get("max_restarts", 0),
            max_concurrency=d.get("max_conc", 1),
            name=d.get("name", ""),
            owner_addr=tuple(owner) if owner else None,
            placement_group_id=d.get("pg", ""),
            bundle_index=d.get("bundle", -1),
            runtime_env=d.get("renv", {}),
            scheduling_strategy=d.get("strat", {}),
            trace_ctx=d.get("trace"),
            deadline=d.get("dl", 0.0),
        )
