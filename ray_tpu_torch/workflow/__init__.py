"""Durable workflows: run task DAGs whose step outputs are checkpointed,
so a crashed run resumes where it left off.

Equivalent of the reference's ``ray.workflow``
(reference: python/ray/workflow/api.py:1 — run/run_async/resume/
get_status/get_output/list_all/delete + continuation).

Usage:
    @ray_tpu_torch.remote
    def fetch(x): ...

    wf = process.bind(fetch.bind(1), fetch.bind(2))
    workflow.run(wf, workflow_id="etl-2026-07-30")
    # after a crash:
    workflow.resume("etl-2026-07-30")
"""

from __future__ import annotations

import threading
import uuid
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

from ray_tpu_torch.dag.nodes import DAGNode
from ray_tpu_torch.workflow.executor import Continuation, WorkflowExecutor
from ray_tpu_torch.workflow.storage import WorkflowStorage

_storage: Optional[WorkflowStorage] = None
_lock = threading.Lock()


def init(storage: Optional[str] = None) -> None:
    """Set the storage root (defaults to RT_WORKFLOW_STORAGE or
    ~/.ray_tpu/workflows)."""
    global _storage
    with _lock:
        _storage = WorkflowStorage(storage)


def _get_storage() -> WorkflowStorage:
    global _storage
    with _lock:
        if _storage is None:
            _storage = WorkflowStorage()
        return _storage


def continuation(dag: DAGNode) -> Continuation:
    """Return this from a step to continue the workflow with a new DAG;
    the step's durable result becomes the continuation's output."""
    return Continuation(dag)


def run(dag: DAGNode, *, workflow_id: Optional[str] = None) -> Any:
    """Execute a DAG durably; blocks until the result is available.
    Re-running a finished workflow_id returns the stored result."""
    storage = _get_storage()
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:12]}"
    if storage.get_status(workflow_id) == "SUCCEEDED":
        return storage.load_result(workflow_id)
    storage.save_dag(workflow_id, dag)
    return WorkflowExecutor(storage, workflow_id).run(dag)


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None) -> Future:
    """Like run(), returning a concurrent.futures.Future."""
    fut: Future = Future()

    def body():
        try:
            fut.set_result(run(dag, workflow_id=workflow_id))
        except BaseException as exc:  # noqa: BLE001 — delivered via future
            fut.set_exception(exc)

    threading.Thread(target=body, daemon=True,
                     name=f"workflow-{workflow_id}").start()
    return fut


def resume(workflow_id: str) -> Any:
    """Re-drive a FAILED/RUNNING(orphaned) workflow from its snapshot;
    checkpointed steps are skipped."""
    storage = _get_storage()
    status = storage.get_status(workflow_id)
    if status is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    if status == "SUCCEEDED":
        return storage.load_result(workflow_id)
    dag = storage.load_dag(workflow_id)
    return WorkflowExecutor(storage, workflow_id).run(dag)


def resume_async(workflow_id: str) -> Future:
    fut: Future = Future()

    def body():
        try:
            fut.set_result(resume(workflow_id))
        except BaseException as exc:  # noqa: BLE001
            fut.set_exception(exc)

    threading.Thread(target=body, daemon=True,
                     name=f"workflow-resume-{workflow_id}").start()
    return fut


def get_status(workflow_id: str) -> str:
    status = _get_storage().get_status(workflow_id)
    if status is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    return status


def get_output(workflow_id: str) -> Any:
    """Stored result of a SUCCEEDED workflow."""
    storage = _get_storage()
    status = storage.get_status(workflow_id)
    if status != "SUCCEEDED":
        raise ValueError(
            f"workflow {workflow_id!r} has no output (status={status})")
    return storage.load_result(workflow_id)


def list_all() -> List[Tuple[str, str]]:
    return _get_storage().list_all()


def delete(workflow_id: str) -> None:
    _get_storage().delete(workflow_id)


__all__ = ["init", "run", "run_async", "resume", "resume_async",
           "get_status", "get_output", "list_all", "delete", "continuation"]
