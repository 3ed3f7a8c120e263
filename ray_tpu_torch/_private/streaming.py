"""Streaming generator returns (``num_returns="streaming"``).

TPU-native re-imagining of the reference's streaming generator machinery
(reference: python/ray/_raylet.pyx:272 ObjectRefGenerator, :1104
execute_streaming_generator_*; core_worker.proto
ReportGeneratorItemReturns): a task or actor method whose body is a
generator reports each yielded value to its owner AS IT IS PRODUCED —
the owner consumes items while the task is still running, which is what
token-streaming inference (the TPU serving shape) and streaming data
ingestion ride on.

Design differences from the reference, on purpose:
  * items ride the already-open owner->worker RPC connection as oneway
    server->client pushes (ordered by TCP), not a separate
    ReportGeneratorItemReturns RPC with acks — one in-order byte stream
    replaces the reference's item-index reordering buffer;
  * item ObjectIDs reuse the deterministic return-index scheme
    (ObjectID.from_index(task_id, i+1)), so a streamed item IS an
    ordinary owned object afterwards: plasma-stored when large, inline
    in the owner's memory store when small, gettable/borrowable like any
    return value;
  * backpressure is the transport's (TCP + the consumer draining);
    the reference's _generator_backpressure_num_objects is not needed
    for the target workloads (small token/batch items).

Known limits (v1, documented not hidden): streaming tasks are not
automatically retried on worker death (consumed prefixes cannot be
un-consumed; the error surfaces at the next ``__next__``), and an
``ObjectRefGenerator`` cannot be pickled or passed to another task.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef

STREAMING = -1  # TaskSpec.num_returns wire value for streaming tasks


class StreamState:
    """Owner-side record of one in-flight generator task's stream."""

    __slots__ = ("arrived", "total", "error", "event", "_async_waiters",
                 "_wlock")

    def __init__(self):
        self.arrived = 0                 # contiguous items reported so far
        self.total: Optional[int] = None  # set when the task finishes
        self.error: Optional[BaseException] = None
        self.event = threading.Event()   # wakes blocked consumers
        # one-shot zero-arg callbacks fired on any stream transition
        # (item arrival, error, completion) — the async consumption path
        # (next_ref_async) parks event-loop futures here instead of a
        # thread on `event`
        self._async_waiters: list = []
        self._wlock = threading.Lock()

    def wake(self) -> None:
        self.event.set()
        with self._wlock:
            waiters, self._async_waiters = self._async_waiters, []
        for cb in waiters:
            try:
                cb()
            except Exception:
                pass

    def add_async_waiter(self, cb) -> None:
        """Register a callback for the next wake().  Callers MUST
        re-check stream state after registering (a wake between their
        check and the registration is otherwise lost) — a stale callback
        firing later is harmless, so no dedup/removal is needed."""
        with self._wlock:
            self._async_waiters.append(cb)


class ObjectRefGenerator:
    """Iterator of ObjectRefs for a streaming task's yields.

    Each ``__next__`` blocks until the worker has reported item i, then
    returns an ObjectRef resolving to it (already local to the owner:
    inline bytes in the memory store, or a recorded plasma location).
    Ends with StopIteration after the task finishes and every yielded
    item has been handed out; a task error raises at the position where
    the stream broke (items before it stay consumable).
    """

    def __init__(self, worker, task_id: str):
        self._worker = worker
        self._task_id = task_id
        self._next = 0

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        return self.next_ref(timeout=None)

    @property
    def task_id(self) -> str:
        return self._task_id

    def next_ref(self, timeout: Optional[float] = None) -> ObjectRef:
        """__next__ with an optional timeout (raises TimeoutError)."""
        import time as _time

        w = self._worker
        s = w._streams.get(self._task_id)
        if s is None:
            raise StopIteration
        deadline = None if timeout is None else _time.monotonic() + timeout
        # consuming inside a task blocks this worker like get() does:
        # donate the lease's CPU so the producer can schedule on a full
        # node (reference: HandleWorkerBlocked — same rule as get)
        notify = self._should_notify(s)
        if notify:
            w._notify_blocked(True)
        try:
            while True:
                if self._next < s.arrived:
                    tid = TaskID.from_hex(self._task_id)
                    oid = ObjectID.from_index(tid, self._next + 1).hex()
                    self._next += 1
                    return ObjectRef(oid, owner_addr=w.address)
                if s.error is not None:
                    raise s.error
                if s.total is not None and self._next >= s.total:
                    w._streams.pop(self._task_id, None)
                    raise StopIteration
                s.event.clear()
                # re-check after clear: the producer may have fired
                # between the checks above and the clear (lost-wake
                # guard).  total alone is not progress — only
                # total-with-all-items-handed-out is (a broader check
                # would spin when total lands before trailing items)
                if (self._next < s.arrived or s.error is not None
                        or (s.total is not None and self._next >= s.total)):
                    continue
                remaining = None if deadline is None \
                    else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"no streamed item within {timeout}s")
                s.event.wait(min(0.5, remaining) if remaining is not None
                             else 0.5)
        finally:
            if notify:
                w._notify_blocked(False)

    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        return await self.next_ref_async()

    async def next_ref_async(self,
                             timeout: Optional[float] = None) -> ObjectRef:
        """Awaitable ``__next__``: resolves on the calling event loop via
        stream-state wake callbacks — no thread parked per consumer (the
        async Serve ingress awaits many streams on one loop).  Raises
        StopAsyncIteration at end-of-stream and TimeoutError on timeout.

        Unlike the sync path this never donates the lease's CPU
        (worker-blocked notification): it is meant for event-loop
        consumers (driver/proxy loops), which hold no exec lease."""
        import asyncio
        import time as _time

        w = self._worker
        s = w._streams.get(self._task_id)
        if s is None:
            raise StopAsyncIteration
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            if self._next < s.arrived:
                tid = TaskID.from_hex(self._task_id)
                oid = ObjectID.from_index(tid, self._next + 1).hex()
                self._next += 1
                return ObjectRef(oid, owner_addr=w.address)
            if s.error is not None:
                raise s.error
            if s.total is not None and self._next >= s.total:
                w._streams.pop(self._task_id, None)
                raise StopAsyncIteration
            fut = loop.create_future()
            s.add_async_waiter(lambda: loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None)))
            # lost-wake guard: the producer may have fired between the
            # checks above and the registration — re-check before
            # parking.  The total condition must include the index
            # comparison: total-set-with-items-still-in-flight would
            # otherwise spin here without awaiting or timing out.
            if (self._next < s.arrived or s.error is not None
                    or (s.total is not None and self._next >= s.total)):
                continue
            remaining = None if deadline is None \
                else deadline - _time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(f"no streamed item within {timeout}s")
            try:
                # 0.5 s recheck cap mirrors the sync path's robustness
                # against a missed wake; the common case resolves via the
                # callback well before it
                await asyncio.wait_for(
                    fut, min(0.5, remaining) if remaining is not None
                    else 0.5)
            except asyncio.TimeoutError:
                pass

    def _should_notify(self, s: StreamState) -> bool:
        from ray_tpu_torch._private.worker import MODE_WORKER

        w = self._worker
        return (w.mode == MODE_WORKER and bool(w._exec.task_id)
                and not (self._next < s.arrived or s.total is not None
                         or s.error is not None))

    def completed(self) -> bool:
        s = self._worker._streams.get(self._task_id)
        return s is None or s.total is not None or s.error is not None

    def cancel(self) -> None:
        """Fire-and-forget cancellation of the producing task: the
        worker raises TaskCancelledError in the replica-side generator,
        whose finally releases whatever it holds (an LLM decode's KV
        pages, file handles, ...).  Non-blocking — posted to the owner's
        IO loop so an event-loop caller (the Serve proxy tearing down an
        abandoned SSE stream) is never parked behind the cancel RPC."""
        w = self._worker
        try:
            w._spawn(w._cancel_async(self._task_id, False))
        except Exception:
            pass  # runtime shutting down: the stream dies with it

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator cannot be pickled or passed to tasks; "
            "consume it in the owning process")

    def __del__(self):
        # stop accepting items for an abandoned stream; already-arrived
        # unconsumed items are released with the owner's memory store
        try:
            self._worker._streams.pop(self._task_id, None)
        except Exception:
            pass
