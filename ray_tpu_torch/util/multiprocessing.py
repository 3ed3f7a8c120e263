"""Drop-in ``multiprocessing.Pool`` running on the cluster.

Equivalent of the reference's ``ray.util.multiprocessing.Pool``
(reference: python/ray/util/multiprocessing/pool.py:1 — Pool with
apply/apply_async/map/map_async/starmap/imap/imap_unordered over actor
workers).  Workers are plain actors; chunking matches the stdlib's
heuristic so small-item workloads aren't dominated by per-task overhead.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional

from ray_tpu_torch._private.errors import GetTimeoutError

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool


@ray_tpu_torch.remote
class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run_chunk(self, fn, chunk: List[tuple]) -> List[Any]:
        return [fn(*args) for args in chunk]

    def run_call(self, fn, args: tuple, kwds: dict) -> List[Any]:
        return [fn(*args, **kwds)]


class AsyncResult:
    """Matches ``multiprocessing.pool.AsyncResult``: get/wait/ready/successful."""

    def __init__(self, refs: List[Any], single: bool, unchunk: bool,
                 callback=None, error_callback=None):
        self._refs = refs
        self._single = single
        self._unchunk = unchunk
        self._callback = callback
        self._error_callback = error_callback
        self._value = None
        self._exc: Optional[BaseException] = None
        self._fetched = False
        self._lock = threading.Lock()
        if callback is not None or error_callback is not None:
            # stdlib fires callbacks when the result completes, not when
            # the caller asks for it
            threading.Thread(target=self._fetch, daemon=True,
                             name="mp-pool-callback").start()

    def _fetch(self):
        """Resolve and cache the final outcome; refs must be complete
        (or the caller accepts blocking until they are)."""
        with self._lock:
            if self._fetched:
                return
            try:
                chunks = ray_tpu_torch.get(self._refs)
                out = list(itertools.chain.from_iterable(chunks)) \
                    if self._unchunk else chunks
                self._value = out[0] if self._single else out
                if self._callback is not None:
                    self._callback(self._value)
            except BaseException as exc:  # noqa: BLE001 — via get()
                self._exc = exc
                if self._error_callback is not None:
                    self._error_callback(exc)
            self._fetched = True

    def get(self, timeout: Optional[float] = None) -> Any:
        # wait OUTSIDE the cache lock: a timed-out get must not poison
        # the result, and must not block on the callback thread's fetch
        if not self._fetched and timeout is not None:
            ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                    timeout=timeout)
            if len(ready) < len(self._refs):
                raise GetTimeoutError("result not ready within timeout")
        self._fetch()
        if self._exc is not None:
            raise self._exc
        return self._value

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        self._fetch()
        return self._exc is None


def _chunk(iterable: Iterable, chunksize: int):
    it = iter(iterable)
    while True:
        block = list(itertools.islice(it, chunksize))
        if not block:
            return
        yield block


class Pool:
    """Process pool where each "process" is a cluster actor."""

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), ray_remote_args: Optional[dict] = None):
        if processes is None:
            total = ray_tpu_torch.cluster_resources().get("CPU", 1)
            processes = max(1, int(total))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._processes = processes
        cls = _PoolWorker.options(**(ray_remote_args or {}))
        self._actors = [cls.remote(initializer, tuple(initargs))
                        for _ in range(processes)]
        self._closed = False
        self._next_apply = 0  # round-robins apply/apply_async

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _default_chunksize(self, n_items: int) -> int:
        # stdlib heuristic: ~4 chunks per worker
        chunksize, extra = divmod(n_items, self._processes * 4)
        return chunksize + 1 if extra else max(1, chunksize)

    def _submit_chunks(self, fn, argtuples: List[tuple], chunksize):
        chunksize = chunksize or self._default_chunksize(len(argtuples))
        fn_ref = ray_tpu_torch.put(fn)  # ship the function once, not per chunk
        n = len(self._actors)
        refs = []
        for i, block in enumerate(_chunk(argtuples, chunksize)):
            actor = self._actors[i % n]
            refs.append(actor.run_chunk.remote(fn_ref, block))
        return refs

    # -------------------------------------------------------------- apply

    def apply(self, fn: Callable, args=(), kwds=None) -> Any:
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args=(), kwds=None,
                    callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        actor = self._actors[self._next_apply % len(self._actors)]
        self._next_apply += 1
        ref = actor.run_call.remote(fn, tuple(args), kwds or {})
        return AsyncResult([ref], single=True, unchunk=True,
                           callback=callback, error_callback=error_callback)

    # ---------------------------------------------------------------- map

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None, callback=None,
                  error_callback=None) -> AsyncResult:
        self._check_running()
        args = [(x,) for x in iterable]
        refs = self._submit_chunks(fn, args, chunksize)
        return AsyncResult(refs, single=False, unchunk=True,
                           callback=callback, error_callback=error_callback)

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_running()
        refs = self._submit_chunks(fn, [tuple(t) for t in iterable], chunksize)
        return AsyncResult(refs, single=False, unchunk=True).get()

    def starmap_async(self, fn: Callable, iterable: Iterable[tuple],
                      chunksize: Optional[int] = None) -> AsyncResult:
        self._check_running()
        refs = self._submit_chunks(fn, [tuple(t) for t in iterable], chunksize)
        return AsyncResult(refs, single=False, unchunk=True)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1):
        self._check_running()
        refs = self._submit_chunks(fn, [(x,) for x in iterable], chunksize)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check_running()
        refs = self._submit_chunks(fn, [(x,) for x in iterable], chunksize)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for ref in ready:
                yield from ray_tpu_torch.get(ref)

    # ------------------------------------------------------------ lifecycle

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a, no_restart=True)
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
