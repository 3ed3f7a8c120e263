"""Workflow executor: durable, resumable DAG execution.

Equivalent of the reference's workflow executor
(reference: python/ray/workflow/workflow_executor.py:1,
task_executor.py — each step's output is checkpointed to storage before
its dependents run; resume replays the DAG, skipping checkpointed
steps; a step may return ``continuation(dag)`` to extend the workflow
dynamically).

Execution model: steps run as regular cluster tasks, submitted eagerly
(independent steps run in parallel); results are fetched and persisted
in deterministic topological order.  A driver crash between persists
loses only unpersisted steps — resume re-submits exactly those.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.dag.nodes import (ClassMethodNode, ClassNode, DAGNode,
                               FunctionNode, InputNode, MultiOutputNode)
from ray_tpu_torch.workflow.storage import WorkflowStorage


class Continuation:
    """Wrapper a step returns to hand the workflow off to a new DAG."""

    def __init__(self, dag: DAGNode):
        if not isinstance(dag, DAGNode):
            raise TypeError("continuation(...) takes a bound DAG node")
        self.dag = dag


def _check_supported(dag: DAGNode) -> None:
    for node in dag.topological():
        if isinstance(node, (ClassNode, ClassMethodNode)):
            raise TypeError(
                "workflows are task-based: actor nodes are not durable "
                "(reference drops virtual actors); use tasks or run the "
                "actor inside a step")
        if isinstance(node, InputNode):
            raise TypeError("workflows capture their inputs at .bind() "
                            "time; InputNode is for compiled DAGs")


def _step_keys(dag: DAGNode, prefix: str) -> Dict[int, str]:
    """Deterministic step key per node: topological index + task name.
    Stable across resume because topological() is deterministic for a
    given (unpickled) DAG structure."""
    keys = {}
    for i, node in enumerate(dag.topological()):
        if isinstance(node, FunctionNode):
            keys[id(node)] = f"{prefix}{i:04d}-{node.name}"
    return keys


class WorkflowExecutor:
    def __init__(self, storage: WorkflowStorage, workflow_id: str):
        self.storage = storage
        self.workflow_id = workflow_id

    def run_dag(self, dag: DAGNode, key_prefix: str = "") -> Any:
        """Execute one DAG level; recurses into continuations.

        Wave scheduler: a step is submitted once every dependency has a
        *persisted* value (never a raw ref — an upstream step may return
        a continuation, whose durable value only exists after the
        continuation DAG ran).  Independent steps still run in parallel.
        """
        import ray_tpu_torch

        _check_supported(dag)
        keys = _step_keys(dag, key_prefix)
        memo: Dict[int, Any] = {}     # node id -> durable value
        in_flight: Dict[Any, DAGNode] = {}  # ref -> node
        order = dag.topological()
        done = set()

        def deps_ready(node: DAGNode) -> bool:
            return all(id(c) in memo for c in node._children())

        while len(done) < len(order):
            progressed = False
            for node in order:
                if id(node) in memo or node in (n for n in in_flight.values()):
                    continue
                if not deps_ready(node):
                    continue
                if isinstance(node, FunctionNode):
                    key = keys[id(node)]
                    if self.storage.has_step(self.workflow_id, key):
                        memo[id(node)] = self.storage.load_step(
                            self.workflow_id, key)
                        done.add(id(node))
                        self.storage.log_event(
                            self.workflow_id,
                            {"event": "step_cached", "step": key})
                    else:
                        args, kwargs = node._resolved_args(memo)
                        in_flight[node._remote_fn.remote(*args, **kwargs)] = \
                            node
                        self.storage.log_event(
                            self.workflow_id,
                            {"event": "step_started", "step": key})
                    progressed = True
                elif isinstance(node, MultiOutputNode):
                    memo[id(node)] = [memo[id(n)] for n in node._outputs]
                    done.add(id(node))
                    progressed = True
                else:  # nested constants / structures
                    memo[id(node)] = node._apply(memo, (), {})
                    done.add(id(node))
                    progressed = True
            if in_flight:
                ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1)
                for ref in ready:
                    node = in_flight.pop(ref)
                    key = keys[id(node)]
                    value = ray_tpu_torch.get(ref)
                    if isinstance(value, Continuation):
                        self.storage.log_event(
                            self.workflow_id,
                            {"event": "continuation", "step": key})
                        value = self.run_dag(value.dag, key_prefix=key + ".")
                    self.storage.save_step(self.workflow_id, key, value)
                    self.storage.log_event(
                        self.workflow_id,
                        {"event": "step_finished", "step": key})
                    memo[id(node)] = value
                    done.add(id(node))
            elif not progressed:
                raise RuntimeError("workflow DAG made no progress "
                                   "(cycle or unsupported node)")
        return memo[id(dag)]

    def run(self, dag: DAGNode) -> Any:
        self.storage.set_status(self.workflow_id, "RUNNING")
        try:
            result = self.run_dag(dag)
        except BaseException:
            self.storage.set_status(self.workflow_id, "FAILED")
            raise
        self.storage.save_result(self.workflow_id, result)
        self.storage.set_status(self.workflow_id, "SUCCEEDED")
        return result
