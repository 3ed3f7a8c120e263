"""Durable workflow storage: filesystem layout + atomic writes.

Equivalent of the reference's workflow storage
(reference: python/ray/workflow/workflow_storage.py:1 — step results,
DAG snapshot, and status live under a per-workflow directory; writes
are atomic so a crash mid-write never corrupts completed state).

Layout:
    <root>/<workflow_id>/dag.pkl          the bound DAG (cloudpickle)
    <root>/<workflow_id>/status           json: {"status": ..., ts}
    <root>/<workflow_id>/result.pkl       final output when SUCCEEDED
    <root>/<workflow_id>/steps/<key>.pkl  durable per-step results
    <root>/<workflow_id>/log.jsonl        append-only step event log
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, List, Optional, Tuple

_DEFAULT_ROOT = os.path.join(
    os.environ.get("RT_WORKFLOW_STORAGE",
                   os.path.expanduser("~/.ray_tpu/workflows")))


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class WorkflowStorage:
    def __init__(self, root: Optional[str] = None):
        self.root = root or _DEFAULT_ROOT

    def _wf_dir(self, workflow_id: str) -> str:
        if not workflow_id or "/" in workflow_id or workflow_id.startswith("."):
            raise ValueError(f"invalid workflow id: {workflow_id!r}")
        return os.path.join(self.root, workflow_id)

    # ----------------------------------------------------------------- DAG

    def save_dag(self, workflow_id: str, dag: Any) -> None:
        import cloudpickle

        _atomic_write(os.path.join(self._wf_dir(workflow_id), "dag.pkl"),
                      cloudpickle.dumps(dag))

    def load_dag(self, workflow_id: str) -> Any:
        import cloudpickle

        path = os.path.join(self._wf_dir(workflow_id), "dag.pkl")
        with open(path, "rb") as f:
            return cloudpickle.loads(f.read())

    # -------------------------------------------------------------- status

    def set_status(self, workflow_id: str, status: str) -> None:
        _atomic_write(os.path.join(self._wf_dir(workflow_id), "status"),
                      json.dumps({"status": status,
                                  "ts": time.time()}).encode())

    def get_status(self, workflow_id: str) -> Optional[str]:
        path = os.path.join(self._wf_dir(workflow_id), "status")
        try:
            with open(path) as f:
                return json.load(f)["status"]
        except (OSError, ValueError, KeyError):
            return None

    def list_all(self) -> List[Tuple[str, str]]:
        try:
            ids = sorted(os.listdir(self.root))
        except OSError:
            return []
        out = []
        for wid in ids:
            status = self.get_status(wid)
            if status is not None:
                out.append((wid, status))
        return out

    def delete(self, workflow_id: str) -> None:
        import shutil

        shutil.rmtree(self._wf_dir(workflow_id), ignore_errors=True)

    # --------------------------------------------------------------- steps

    def _step_path(self, workflow_id: str, key: str) -> str:
        safe = key.replace("/", "_").replace("..", "_")
        if len(safe) > 100:
            # deep continuation chains produce unbounded keys; the digest
            # stays deterministic because the key itself is
            import hashlib

            safe = safe[:60] + "-" + hashlib.sha256(safe.encode()).hexdigest()
        return os.path.join(self._wf_dir(workflow_id), "steps", safe + ".pkl")

    def has_step(self, workflow_id: str, key: str) -> bool:
        return os.path.exists(self._step_path(workflow_id, key))

    def save_step(self, workflow_id: str, key: str, value: Any) -> None:
        import cloudpickle

        _atomic_write(self._step_path(workflow_id, key),
                      cloudpickle.dumps(value))

    def load_step(self, workflow_id: str, key: str) -> Any:
        import cloudpickle

        with open(self._step_path(workflow_id, key), "rb") as f:
            return cloudpickle.loads(f.read())

    # -------------------------------------------------------------- result

    def save_result(self, workflow_id: str, value: Any) -> None:
        import cloudpickle

        _atomic_write(os.path.join(self._wf_dir(workflow_id), "result.pkl"),
                      cloudpickle.dumps(value))

    def load_result(self, workflow_id: str) -> Any:
        import cloudpickle

        path = os.path.join(self._wf_dir(workflow_id), "result.pkl")
        with open(path, "rb") as f:
            return cloudpickle.loads(f.read())

    # ----------------------------------------------------------------- log

    def log_event(self, workflow_id: str, event: dict) -> None:
        path = os.path.join(self._wf_dir(workflow_id), "log.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps({**event, "ts": time.time()}) + "\n")

    def read_log(self, workflow_id: str) -> List[dict]:
        path = os.path.join(self._wf_dir(workflow_id), "log.jsonl")
        try:
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]
        except OSError:
            return []
