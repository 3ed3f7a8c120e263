"""Actor pool: round-robins work over a fixed set of actor handles.

Equivalent of the reference's ``ray.util.ActorPool``
(reference: python/ray/util/actor_pool.py:1 — submit/get_next/
get_next_unordered/map/map_unordered/has_next/has_free/push/pop_idle).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, TypeVar

import ray_tpu_torch

V = TypeVar("V")


class ActorPool:
    """Utility for processing a stream of work items over a set of actors.

    ``fn`` passed to submit/map receives ``(actor_handle, value)`` and must
    return an ObjectRef, e.g. ``pool.submit(lambda a, v: a.work.remote(v), v)``.
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool requires at least one actor")
        self._in_flight: Dict[Any, tuple] = {}   # ref -> (actor, index)
        self._index_to_ref: Dict[int, Any] = {}  # submitted, not yet claimed
        self._done: Dict[int, Any] = {}          # completed, actor recycled
        self._pending: List[tuple] = []          # (fn, value) behind busy actors
        self._next_task_index = 0
        self._next_return_index = 0

    # ------------------------------------------------------------ submission

    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        """Schedule fn(actor, value) on an idle actor, or queue it."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._in_flight[ref] = (actor, self._next_task_index)
            self._index_to_ref[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending

    def has_next(self) -> bool:
        return bool(self._in_flight) or bool(self._pending) or bool(self._done)

    # --------------------------------------------------------------- results

    def _recycle(self, ref) -> None:
        """Mark an in-flight ref completed; put its actor back to work."""
        actor, idx = self._in_flight.pop(ref)
        self._index_to_ref.pop(idx, None)
        self._done[idx] = ref
        self._idle.append(actor)
        if self._pending:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)

    def _drain_one(self, timeout: float | None) -> None:
        """Block until any in-flight ref completes and recycle its actor."""
        if not self._in_flight:
            raise RuntimeError("ActorPool deadlock: queued work but no actors")
        ready, _ = ray_tpu_torch.wait(
            list(self._in_flight), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("ActorPool wait timed out")
        self._recycle(ready[0])

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in submission order (blocks)."""
        if not self.has_next():
            raise StopIteration("no results pending")
        idx = self._next_return_index
        while idx not in self._done:
            ref = self._index_to_ref.get(idx)
            if ref is not None:
                # wait on the specific future we must return next
                ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
                if not ready:
                    raise TimeoutError("get_next timed out")
                self._recycle(ref)
            else:
                # still queued behind busy actors: free a slot first
                self._drain_one(timeout)
        self._next_return_index += 1
        return ray_tpu_torch.get(self._done.pop(idx))

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in completion order (blocks)."""
        if not self.has_next():
            raise StopIteration("no results pending")
        if not self._done:
            self._drain_one(timeout)
        idx = next(iter(self._done))
        self._next_return_index = max(self._next_return_index, idx + 1)
        return ray_tpu_torch.get(self._done.pop(idx))

    # ------------------------------------------------------------------ maps

    def map(self, fn: Callable[[Any, V], Any],
            values: Iterable[V]) -> Iterator[Any]:
        """Apply fn over values; yields results in submission order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any],
                      values: Iterable[V]) -> Iterator[Any]:
        """Apply fn over values; yields results as they complete."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ------------------------------------------------------------ membership

    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool."""
        busy = {a for a, _ in self._in_flight.values()}
        if actor in self._idle or actor in busy:
            raise ValueError("actor already in pool")
        self._idle.append(actor)
        if self._pending:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)

    def pop_idle(self) -> Any | None:
        """Remove and return an idle actor, or None if all are busy."""
        if self._idle:
            return self._idle.pop()
        return None
