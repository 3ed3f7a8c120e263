"""Driver log streaming: tail worker logs on the node agent, push to
subscribed drivers.

Equivalent role to the reference's log monitor
(reference: python/ray/_private/log_monitor.py:103 — a per-node daemon
tailing ``/logs`` and publishing increments over GCS pubsub, printed by
the driver with ``(pid=..., ip=...)`` prefixes).  Here the monitor runs
inside the node agent's event loop and streams over the existing RPC
push path: a driver (or ``rtpu logs``) calls ``subscribe_logs`` on an
agent and receives ``log_lines`` oneway pushes on that same connection —
no extra daemon, no polling from the driver side.

Each agent tails only the files of workers IT spawned (several agents
may share one session ``logs/`` dir in tests), so a driver subscribed to
every agent sees each line exactly once.  While nobody is subscribed the
monitor does no IO at all; the first subscriber gets an optional
tail-backlog and streaming starts from the then-current end of file.
Files registered while subscribers exist (fresh workers) stream from
byte 0, so a worker's first ``print()`` is never lost.
"""

from __future__ import annotations

import asyncio
import os
from typing import Any, Dict, List, Optional


class _TailedFile:
    __slots__ = ("path", "pid", "worker_id", "offset", "partial", "missing",
                 "dead")

    def __init__(self, path: str, pid: int, worker_id: str,
                 offset: Optional[int]):
        self.path = path
        self.pid = pid
        self.worker_id = worker_id
        # None = "seek to end when streaming starts" (pre-subscription
        # history is served via the tail backlog, not replayed)
        self.offset = offset
        self.partial = b""  # trailing bytes of an incomplete last line
        self.missing = False
        # worker reaped: the file is drained one last time (the death
        # message is usually its final lines) and then evicted, so
        # _files doesn't grow — and poll doesn't stat — one entry per
        # dead worker forever under churn
        self.dead = False


def _tail_lines(path: str, n: int) -> List[str]:
    """Last ``n`` decoded lines of a file (bounded read from the end)."""
    if n <= 0:
        return []
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 64 * 1024 * max(1, n // 256 + 1)))
            data = f.read()
    except OSError:
        return []
    lines = data.decode(errors="replace").splitlines()
    return lines[-n:]


class LogMonitor:
    """Tails registered files, fanning line increments out to
    subscribed RPC connections as ``log_lines`` pushes."""

    def __init__(self, node_id: str):
        self.node_id = node_id
        self._files: Dict[str, _TailedFile] = {}
        self._subs: Dict[int, Any] = {}  # id(conn) -> RpcServerConnection
        self._task: Optional[asyncio.Task] = None
        self.lines_streamed = 0  # observability for node_info/tests

    # ---- registration ------------------------------------------------------

    def add_file(self, path: str, pid: int, worker_id: str = "") -> None:
        """Register a worker's log file.  With live subscribers the file
        streams from its beginning (it's brand new); otherwise content
        up to the first subscription is backlog only."""
        if path in self._files:
            return
        self._files[path] = _TailedFile(
            path, pid, worker_id, offset=0 if self._subs else None)

    def mark_dead(self, worker_id: str) -> None:
        """The worker was reaped: schedule its file for drain-then-evict
        (idle files — nobody ever subscribed — evict on the first poll
        after a subscription sets their offset to EOF)."""
        for tf in self._files.values():
            if tf.worker_id == worker_id:
                tf.dead = True

    def subscribe(self, conn, tail: int = 0) -> List[Dict[str, Any]]:
        """Add a push target; returns up to ``tail`` backlog lines per
        file.  Streaming for previously idle files starts at EOF."""
        for tf in self._files.values():
            if tf.offset is None:
                try:
                    tf.offset = os.path.getsize(tf.path)
                except OSError:
                    tf.offset = 0
        self._subs[id(conn)] = conn
        self._ensure_task()
        backlog: List[Dict[str, Any]] = []
        if tail > 0:
            for tf in self._files.values():
                lines = _tail_lines(tf.path, tail)
                if lines:
                    backlog.append({"pid": tf.pid,
                                    "worker_id": tf.worker_id[:12],
                                    "lines": lines})
        return backlog

    def unsubscribe(self, conn) -> None:
        self._subs.pop(id(conn), None)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # ---- tail loop ---------------------------------------------------------

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        from ray_tpu_torch._private.config import config

        period = max(0.05, config.log_monitor_poll_ms / 1000.0)
        while True:
            await asyncio.sleep(period)
            if not self._subs:
                continue  # idle: no stat/read syscalls at all
            batch = self._poll_once()
            if batch:
                await self._push(batch)

    def _poll_once(self) -> List[Dict[str, Any]]:
        from ray_tpu_torch._private.config import config

        cap = int(config.log_monitor_max_read_bytes)
        batch: List[Dict[str, Any]] = []
        evict: List[str] = []
        for tf in self._files.values():
            if tf.missing or tf.offset is None:
                if tf.missing or tf.dead:
                    evict.append(tf.path)
                continue
            try:
                size = os.path.getsize(tf.path)
            except OSError:
                tf.missing = True
                evict.append(tf.path)
                continue
            if size < tf.offset:
                tf.offset = 0  # truncated/rotated: start over
                tf.partial = b""
            lines_b: List[bytes] = []
            if size > tf.offset:
                try:
                    with open(tf.path, "rb") as f:
                        f.seek(tf.offset)
                        data = f.read(cap)
                except OSError:
                    continue
                tf.offset += len(data)
                data = tf.partial + data
                lines_b = data.split(b"\n")
                tf.partial = lines_b.pop()  # incomplete last piece
            if tf.dead and tf.offset >= size:
                # fully drained after death: flush any unterminated tail
                # and drop the entry (bounds _files under worker churn)
                if tf.partial:
                    lines_b.append(tf.partial)
                    tf.partial = b""
                evict.append(tf.path)
            if not lines_b:
                continue
            lines = [ln.decode(errors="replace") for ln in lines_b]
            self.lines_streamed += len(lines)
            batch.append({"pid": tf.pid, "worker_id": tf.worker_id[:12],
                          "lines": lines})
        for path in evict:
            self._files.pop(path, None)
        return batch

    async def _push(self, batch: List[Dict[str, Any]]) -> None:
        payload = {"node_id": self.node_id, "batch": batch}
        for key, conn in list(self._subs.items()):
            try:
                await conn.push("log_lines", payload)
            except Exception:
                # connection gone: drop the subscriber (the agent's
                # on_peer_disconnect usually beats us to it)
                self._subs.pop(key, None)

    # ---- one-shot reads ----------------------------------------------------

    def tail(self, lines: int = 100) -> List[Dict[str, Any]]:
        """Last N lines of every tracked file (no subscription)."""
        out: List[Dict[str, Any]] = []
        for tf in self._files.values():
            got = _tail_lines(tf.path, lines)
            if got:
                out.append({"pid": tf.pid, "worker_id": tf.worker_id[:12],
                            "lines": got})
        return out
