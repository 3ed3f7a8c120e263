"""Distributed FIFO queue backed by an actor.

Equivalent of the reference's ``ray.util.queue.Queue``
(reference: python/ray/util/queue.py:1 — actor-backed queue with
put/get/put_nowait/get_nowait/qsize/empty/full + batch variants and
Empty/Full mirroring the stdlib).  The reference hosts the buffer in an
asyncio actor; here the buffer lives in a threaded actor
(max_concurrency) and *blocking* semantics are driven client-side with
short bounded waits so an abandoned caller can never wedge an actor
thread forever.
"""

from __future__ import annotations

import queue as _stdlib_queue
import time
from typing import Any, List, Optional

import ray_tpu_torch

Empty = _stdlib_queue.Empty
Full = _stdlib_queue.Full

_SLICE = 2.0  # max seconds an actor thread blocks per call


@ray_tpu_torch.remote(max_concurrency=64)
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = _stdlib_queue.Queue(maxsize=maxsize)

    def put(self, item, timeout: float) -> bool:
        try:
            self._q.put(item, block=True, timeout=min(timeout, _SLICE))
            return True
        except Full:
            return False

    def get(self, timeout: float):
        try:
            return True, self._q.get(block=True, timeout=min(timeout, _SLICE))
        except Empty:
            return False, None

    def put_nowait_batch(self, items: List[Any]) -> bool:
        """All-or-nothing: atomically accepts the whole batch or none."""
        q = self._q
        with q.not_full:  # the Condition shares q.mutex
            if q.maxsize > 0 and len(q.queue) + len(items) > q.maxsize:
                return False
            q.queue.extend(items)
            q.unfinished_tasks += len(items)
            q.not_empty.notify(len(items))
            return True

    def get_nowait_batch(self, num_items: int,
                         allow_partial: bool) -> Optional[List[Any]]:
        """Atomically drains num_items (or up to that many when
        allow_partial).  None = not enough items; nothing was drained."""
        q = self._q
        with q.not_empty:
            avail = len(q.queue)
            if avail < num_items and not allow_partial:
                return None
            take = min(num_items, avail)
            out = [q.queue.popleft() for _ in range(take)]
            q.not_full.notify(take)
            return out

    def qsize(self) -> int:
        return self._q.qsize()

    def maxsize(self) -> int:
        return self._q.maxsize


class Queue:
    """A first-in-first-out queue usable from any worker in the cluster."""

    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**(actor_options or {})).remote(maxsize)
        # fail fast if the actor could not be placed
        ray_tpu_torch.get(self.actor.maxsize.remote(), timeout=60)

    # -------------------------------------------------------------- blocking

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            return self.put_nowait(item)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = _SLICE if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if ray_tpu_torch.get(self.actor.put.remote(item, max(wait, 0.01)),
                           timeout=60):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            return self.get_nowait()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = _SLICE if deadline is None \
                else max(0.0, deadline - time.monotonic())
            ok, item = ray_tpu_torch.get(self.actor.get.remote(max(wait, 0.01)),
                                   timeout=60)
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty

    # ----------------------------------------------------------- nonblocking

    def put_nowait(self, item: Any) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote([item]),
                           timeout=60):
            raise Full

    def get_nowait(self) -> Any:
        out = ray_tpu_torch.get(self.actor.get_nowait_batch.remote(1, False),
                          timeout=60)
        if out is None:
            raise Empty
        return out[0]

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items)),
                           timeout=60):
            raise Full(f"batch of {len(items)} does not fit")

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        out = ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items, False),
                          timeout=60)
        if out is None:
            raise Empty(f"fewer than {num_items} items available")
        return out

    # ------------------------------------------------------------ inspection

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote(), timeout=60)

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self, force: bool = False) -> None:
        """Terminate the backing actor; pending items are lost."""
        ray_tpu_torch.kill(self.actor, no_restart=True)
