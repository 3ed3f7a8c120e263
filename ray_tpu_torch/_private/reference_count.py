"""Distributed reference counting (v1).

Equivalent role to the reference's ReferenceCounter
(reference: src/ray/core_worker/reference_count.h): every object has an
owner (the worker that created it); the owner frees the object only when

  - its own local (Python) references are gone,
  - no in-flight task submission still carries the ref as an argument,
  - and every registered borrower has reported its references gone.

Borrowers are workers that deserialized the ref (from task args or from
another object); they register with the owner on first sight and send
`remove_borrow` when their local count drops to zero.  This is a
simplification of the reference's borrower chains (a borrower that
forwards a ref to a third worker tells that worker to register with the
*owner* directly, so the owner always has the full borrower set —
reference handles this with WaitForRefRemoved chains instead).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple


class _Ref:
    __slots__ = ("local", "submitted", "borrowers", "owned", "freed",
                 "lineage_pinned", "call_site", "name", "created")

    def __init__(self, owned: bool):
        self.local = 0
        self.submitted = 0           # in-flight task submissions using it
        self.borrowers: Set[Tuple[str, int]] = set()   # remote borrower addrs
        self.owned = owned
        self.freed = False
        self.lineage_pinned = False  # keep TaskSpec for lineage re-execution
        # memory accounting (`rtpu memory`): where the ref was minted
        # (user frame of the put()/.remote() call), the producing
        # task/actor-method name, and creation time for leak-TTL checks
        self.call_site = ""
        self.name = ""
        self.created = time.monotonic()


class _CounterLock:
    """The counter's lock, which tells whether the calling thread holds
    it and runs, once that thread releases it, the work deferred while
    it was held: a garbage collection inside the lock that finalises an
    ObjectRef must not wait for the lock its own thread holds.  An RLock
    only so that ``_is_owned`` answers atomically with the acquire; the
    counter never re-enters it."""

    __slots__ = ("_lock", "deferred")

    def __init__(self):
        self._lock = threading.RLock()
        self.deferred: List[Callable[[], None]] = []

    def held_here(self) -> bool:
        return self._lock._is_owned()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        if self._lock._is_owned():
            return
        # a collection during one of these may defer more: drain to empty
        while self.deferred:
            try:
                self.deferred.pop(0)()
            except Exception:  # noqa: BLE001 — ignored, as in __del__
                pass


class ReferenceCounter:
    """Thread-safe; `on_release(oid)` fires (outside the lock) when an
    *owned* object's count reaches zero."""

    def __init__(self, on_release: Callable[[str], None]):
        self._lock = _CounterLock()
        self._refs: Dict[str, _Ref] = {}
        self._on_release = on_release

    def held_here(self) -> bool:
        """True in the thread that holds this counter's lock: where a
        collection inside the lock finalises an ObjectRef."""
        return self._lock.held_here()

    def defer(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once the holding thread releases the lock (call
        only where :meth:`held_here`)."""
        self._lock.deferred.append(fn)

    # ---- local references --------------------------------------------------

    def add_local(self, oid: str, owned: bool) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                ref = self._refs[oid] = _Ref(owned)
            ref.local += 1

    def remove_local(self, oid: str) -> bool:
        """Returns True if this was a *borrowed* ref whose count hit zero
        (caller should notify the owner)."""
        release = False
        borrowed_done = False
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return False
            ref.local -= 1
            if ref.local <= 0 and ref.submitted <= 0:
                if ref.owned:
                    if not ref.borrowers and not ref.freed:
                        ref.freed = True
                        release = True
                else:
                    self._refs.pop(oid, None)
                    borrowed_done = True
        if release:
            self._on_release(oid)
        return borrowed_done

    # ---- submission pins ---------------------------------------------------

    def add_submitted(self, oid: str) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                ref = self._refs[oid] = _Ref(owned=True)
            ref.submitted += 1

    def remove_submitted(self, oid: str) -> bool:
        release = False
        borrowed_done = False
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return False
            ref.submitted -= 1
            if ref.local <= 0 and ref.submitted <= 0:
                if ref.owned:
                    if not ref.borrowers and not ref.freed:
                        ref.freed = True
                        release = True
                else:
                    self._refs.pop(oid, None)
                    borrowed_done = True
        if release:
            self._on_release(oid)
        return borrowed_done

    # ---- borrower protocol (owner side) ------------------------------------

    def add_borrower(self, oid: str, borrower: Tuple[str, int]) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                ref = self._refs[oid] = _Ref(owned=True)
            ref.borrowers.add(tuple(borrower))

    def remove_borrower(self, oid: str, borrower: Tuple[str, int]) -> None:
        release = False
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return
            ref.borrowers.discard(tuple(borrower))
            if (ref.local <= 0 and ref.submitted <= 0 and not ref.borrowers
                    and ref.owned and not ref.freed):
                ref.freed = True
                release = True
        if release:
            self._on_release(oid)

    # ---- introspection -----------------------------------------------------

    def set_meta(self, oid: str, call_site: str = "", name: str = "") -> None:
        """Attach creation metadata to an existing ref (no-op for unknown
        oids — the caller registers the ref first via add_local)."""
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return
            if call_site:
                ref.call_site = call_site
            if name:
                ref.name = name

    def summary(self) -> List[Dict[str, Any]]:
        """One record per live ref — the worker half of `rtpu memory`
        (reference: CoreWorker's ownership-table dump behind `ray
        memory`).  Snapshot under the lock, dict-building outside it."""
        with self._lock:
            snap = [(oid, r.owned, r.local, r.submitted, len(r.borrowers),
                     r.lineage_pinned, r.call_site, r.name, r.created)
                    for oid, r in self._refs.items() if not r.freed]
        now = time.monotonic()
        return [{"oid": oid, "owned": owned, "local": local,
                 "submitted": submitted, "borrowers": borrowers,
                 "lineage_pinned": pinned, "call_site": cs, "name": name,
                 "age_s": round(now - created, 3)}
                for (oid, owned, local, submitted, borrowers, pinned,
                     cs, name, created) in snap]

    def count(self, oid: str) -> int:
        with self._lock:
            ref = self._refs.get(oid)
            return 0 if ref is None else ref.local + ref.submitted

    def owned_ids(self) -> List[str]:
        with self._lock:
            return [oid for oid, r in self._refs.items() if r.owned and not r.freed]

    def is_freed(self, oid: str) -> bool:
        with self._lock:
            ref = self._refs.get(oid)
            return ref is not None and ref.freed

    def pin_lineage(self, oid: str) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is not None:
                ref.lineage_pinned = True
