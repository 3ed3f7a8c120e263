"""In-process memory store for small objects.

Equivalent of the reference's CoreWorkerMemoryStore
(reference: src/ray/core_worker/store_provider/memory_store/memory_store.h):
inlined task returns and errors live here, keyed by object id; values too
large to inline are represented by an IN_PLASMA sentinel that redirects
`get` to the shared-memory store.

Thread model: the user thread blocks in `wait_ready`; the RPC IO thread
calls `set_*` — coordination is a per-entry threading.Event.

Ported from ray_tpu's memory store for one fault: a garbage collection
that runs inside one of the store's locked regions (an allocation there
can start one) may free the last ObjectRef of an owned object, whose
``__del__`` reaches :meth:`MemoryStore.evict` on the same thread
(object_ref.py ``__del__`` -> worker ``_free_object``).  The store's lock
is not reentrant, so that evict would wait on itself forever.  The lock
here knows its holder: an evict from the holding thread is deferred and
applied as the holder leaves its region.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class _Entry:
    __slots__ = ("event", "value", "raw", "error", "in_plasma", "node_addr",
                 "waiters")

    def __init__(self):
        self.event = threading.Event()
        self.value: Any = None       # cached deserialized value
        self.raw: Optional[bytes] = None  # serialized inline bytes
        self.error: Optional[BaseException] = None
        self.in_plasma = False
        self.node_addr: Optional[Tuple[str, int]] = None
        self.waiters: Dict[int, Any] = {}  # token -> callback


class _StoreLock:
    """The store's non-reentrant lock, which knows the thread holding it
    and applies the evictions deferred while it was held."""

    __slots__ = ("_lock", "owner", "deferred", "_entries")

    def __init__(self, entries: Dict[str, "_Entry"]):
        self._lock = threading.Lock()
        self.owner: Optional[int] = None
        self.deferred: List[str] = []
        self._entries = entries

    def __enter__(self):
        self._lock.acquire()
        self.owner = threading.get_ident()
        return self

    def __exit__(self, *exc):
        try:
            # a collection during these pops may defer more: drain to empty
            while self.deferred:
                self._entries.pop(self.deferred.pop(), None)
        finally:
            self.owner = None
            self._lock.release()


class MemoryStore:
    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self._lock = _StoreLock(self._entries)
        self._waiter_tokens = 0

    def _entry(self, oid: str) -> _Entry:
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                e = self._entries[oid] = _Entry()
            return e

    def _fire(self, e: _Entry) -> None:
        e.event.set()
        with self._lock:
            waiters = list(e.waiters.values())
            e.waiters.clear()
        for cb in waiters:
            try:
                cb()
            except Exception:
                pass

    # ---- producer side -----------------------------------------------------

    def ensure(self, oid: str) -> None:
        """Pre-create a pending entry (a submitted task's future return)."""
        self._entry(oid)

    def set_value(self, oid: str, value: Any) -> None:
        e = self._entry(oid)
        e.value = value
        self._fire(e)

    def set_raw(self, oid: str, raw: bytes) -> None:
        """Store serialized inline bytes; deserialized lazily on first get."""
        e = self._entry(oid)
        e.raw = raw
        self._fire(e)

    def set_error(self, oid: str, error: BaseException) -> None:
        e = self._entry(oid)
        e.error = error
        self._fire(e)

    def set_in_plasma(self, oid: str, node_addr: Tuple[str, int]) -> None:
        e = self._entry(oid)
        e.in_plasma = True
        e.node_addr = node_addr
        self._fire(e)

    def fail_pending(self, error: BaseException) -> None:
        """Resolve every still-pending entry with an error — wakes all
        blocked waiters (get()s, dependency resolution threads parked on
        entry events).  Called at shutdown so no executor thread stays
        blocked on an object that can no longer arrive."""
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if not e.event.is_set():
                e.error = error
                self._fire(e)

    def reset(self, oid: str) -> None:
        """Forget a resolution (used when re-executing a task for recovery)."""
        with self._lock:
            self._entries.pop(oid, None)

    def clear_resolution(self, oid: str) -> None:
        """Flip a resolved entry back to pending IN PLACE, so existing
        waiters (holding the entry object) block until the recomputed
        value arrives.  A racing reader may still see the old resolution;
        its fetch fails and it retries through the reconstruction path."""
        with self._lock:
            e = self._entries.get(oid)
        if e is not None:
            e.event.clear()
            e.value = None
            e.raw = None
            e.error = None
            e.in_plasma = False
            e.node_addr = None

    # ---- consumer side -----------------------------------------------------

    def known(self, oid: str) -> bool:
        with self._lock:
            return oid in self._entries

    def ready(self, oid: str) -> bool:
        with self._lock:
            e = self._entries.get(oid)
        return e is not None and e.event.is_set()

    def peek(self, oid: str) -> Optional[_Entry]:
        with self._lock:
            e = self._entries.get(oid)
        return e if e is not None and e.event.is_set() else None

    def wait_ready(self, oid: str, timeout: Optional[float] = None) -> Optional[_Entry]:
        """Block until the entry resolves; None on timeout or unknown id."""
        with self._lock:
            e = self._entries.get(oid)
        if e is None:
            return None
        if not e.event.wait(timeout):
            return None
        return e

    def add_waiter(self, oid: str, callback) -> Optional[int]:
        """Register a callback fired (once) when the entry resolves.

        Returns None and does NOT register if the entry is already ready
        (caller should count it immediately); otherwise returns a token
        for remove_waiter.  Callbacks run on the resolving thread (the
        RPC IO thread) and must not block.
        """
        e = self._entry(oid)
        with self._lock:
            if e.event.is_set():
                return None
            self._waiter_tokens += 1
            token = self._waiter_tokens
            e.waiters[token] = callback
            return token

    def remove_waiter(self, oid: str, token: int) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                e.waiters.pop(token, None)

    def evict(self, oid: str) -> None:
        if self._lock.owner == threading.get_ident():
            # reached from a collection inside this thread's own locked
            # region: waiting would deadlock, so the region's exit pops it
            self._lock.deferred.append(oid)
            return
        with self._lock:
            self._entries.pop(oid, None)
