"""Function/actor-class table over the head's internal KV.

Equivalent of the reference's GCS function table
(reference: python/ray/_private/function_manager.py — export_function /
fetch_and_register; storage is internal KV keys "fn:<job>:<id>").

Functions are cloudpickled once per driver and cached per worker process.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict

import cloudpickle


class FunctionManager:
    def __init__(self, head_rpc):
        self._head = head_rpc  # SyncRpcClient to the head
        self._cache: Dict[str, Any] = {}
        self._exported: set = set()
        self._lock = threading.Lock()

    @staticmethod
    def function_id(pickled: bytes) -> str:
        return hashlib.sha256(pickled).hexdigest()[:40]

    def export(self, fn_or_class: Any) -> str:
        """Pickle and upload; returns the function id (content-addressed,
        so re-exports of the same code are free)."""
        pickled = cloudpickle.dumps(fn_or_class)
        fid = self.function_id(pickled)
        with self._lock:
            if fid in self._exported:
                return fid
        self._head.call("kv_put", key=f"fn:{fid}", value=pickled, overwrite=False)
        with self._lock:
            self._exported.add(fid)
            self._cache[fid] = fn_or_class
        return fid

    def fetch(self, fid: str) -> Any:
        with self._lock:
            if fid in self._cache:
                return self._cache[fid]
        reply = self._head.call("kv_get", key=f"fn:{fid}")
        blob = reply.get("value")
        if blob is None:
            raise KeyError(f"function {fid} not found in cluster function table")
        obj = cloudpickle.loads(blob)
        with self._lock:
            self._cache[fid] = obj
        return obj
