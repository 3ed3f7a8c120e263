"""Control-plane RPC: length-prefixed msgpack over asyncio TCP.

Equivalent role to the reference's typed gRPC wrappers
(reference: src/ray/rpc/grpc_server.h, grpc_client.h) — every daemon
(control service, node agent, worker) exposes one RPC server; clients are
pooled and retryable.  We use a compact msgpack framing instead of gRPC:
the control plane carries small messages (leases, directory updates,
heartbeats); bulk data rides the object plane, never RPC.

Frame:  [u32 length][msgpack (kind, req_id, method, payload)]
  kind: 0=request, 1=reply, 2=error, 3=oneway
Payload is a msgpack-native structure (dict/list/bytes/str/int/float).

Servers subclass `RpcHost` and define ``async def rpc_<method>(self, **kw)``.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import struct
import threading
from typing import Any, Dict, Iterator, Optional

import msgpack

from ray_tpu_torch._private import fault_injection

_REQUEST, _REPLY, _ERROR, _ONEWAY = 0, 1, 2, 3
_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 30


def is_loopback(host: Any) -> bool:
    """Shared by the head's driver-callback classification and the
    worker's bind-host pick — ONE definition, so the two sides can
    never drift into classifying the same address differently."""
    h = str(host)
    return h.startswith("127.") or h in ("localhost", "::1")


def backoff_delays(base_s: float = 0.05, cap_s: float = 1.0,
                   rng: Optional[random.Random] = None
                   ) -> Iterator[float]:
    """Reconnect/refusal-retry schedule: exponential backoff with
    jitter, capped.  Each draw is uniform in [ceiling/2, ceiling] with
    the ceiling doubling from ``base_s`` up to ``cap_s`` — so a head
    restart with hundreds of agents/drivers in the retry loop does not
    produce a synchronized dial storm every N ms (every client draws
    its own phase), while the half-ceiling floor keeps the loop from
    hot-spinning against a refused socket.  ``rng`` is injectable so
    the schedule is unit-testable deterministically."""
    draw = (rng or random).uniform
    ceiling = max(1e-6, float(base_s))
    cap_s = max(float(cap_s), ceiling)
    while True:
        yield draw(ceiling / 2.0, ceiling)
        ceiling = min(ceiling * 2.0, cap_s)


class RpcError(Exception):
    """Remote handler raised; message carries the remote traceback string."""


class ConnectionLost(Exception):
    pass


def _pack(kind: int, req_id: int, method: str, payload: Any) -> bytes:
    body = msgpack.packb((kind, req_id, method, payload), use_bin_type=True)
    return _LEN.pack(len(body)) + body


async def _read_frame(reader: asyncio.StreamReader):
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > _MAX_FRAME:
        raise ConnectionLost(f"oversized frame: {length}")
    body = await reader.readexactly(length)
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


class RpcHost:
    """Base for RPC-serving daemons. Handlers: ``async def rpc_<name>``.

    A host may expose ``rpc_op_loops`` — a ``{method: event_loop}`` map —
    to route specific ops onto OTHER event loops: the server's read loop
    dispatches a routed frame straight onto the owning loop (no hop
    through the serving loop's task queue) and marshals the reply bytes
    back.  This is how the sharded head (head_shards.py) keeps task-event
    and heartbeat ingest off its scheduling loop."""

    rpc_op_loops: Dict[str, asyncio.AbstractEventLoop] = {}

    async def dispatch(self, method: str, payload: Dict[str, Any]) -> Any:
        handler = getattr(self, f"rpc_{method}", None)
        if handler is None:
            raise RpcError(f"{type(self).__name__} has no method {method!r}")
        return await handler(**(payload or {}))

    def on_peer_disconnect(self, peer: "RpcServerConnection") -> None:
        """Override to observe client disconnects (e.g. worker death)."""


class RpcServerConnection:
    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.meta: Dict[str, Any] = {}  # set by register handlers

    async def push(self, method: str, payload: Any) -> None:
        """Server→client oneway push (used for pubsub, task push)."""
        self.writer.write(_pack(_ONEWAY, 0, method, payload))
        await self.writer.drain()


class RpcServer:
    def __init__(self, host_obj: RpcHost, listen_host: str = "127.0.0.1", port: int = 0):
        self._host_obj = host_obj
        self._listen_host = listen_host
        self._port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self.connections: set[RpcServerConnection] = set()
        self._wants_conn_cache: Dict[str, bool] = {}
        # concurrent.futures for handlers routed to foreign loops: a
        # run_coroutine_threadsafe future nothing references can be
        # GC'd mid-flight — retain until done
        self._routed_inflight: set = set()

    @property
    def port(self) -> int:
        return self._port

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle_conn, self._listen_host, self._port
        )
        self._port = self._server.sockets[0].getsockname()[1]
        return self._port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for conn in list(self.connections):
                try:
                    conn.writer.close()
                except Exception:
                    pass
            await self._server.wait_closed()

    async def _handle_conn(self, reader, writer):
        conn = RpcServerConnection(writer)
        self.connections.add(conn)
        try:
            while True:
                try:
                    kind, req_id, method, payload = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError,
                        ConnectionLost):
                    break
                except Exception:
                    # malformed frame or msgpack garbage: drop the peer,
                    # never the server — but leave a trace for debugging
                    import traceback

                    traceback.print_exc()
                    break
                if kind in (_ONEWAY, _REQUEST):
                    chaos = fault_injection.decide("rpc.recv", key=method)
                    if chaos is not None:
                        if chaos.action == "sever":
                            break  # connection dies under the peer
                        if chaos.action == "drop":
                            continue  # frame read, never dispatched
                        if chaos.action == "delay":
                            await fault_injection.sleep_async(chaos.delay_s)
                if kind == _ONEWAY:
                    target = self._route_loop(method)
                    if target is not None:
                        self._spawn_routed(
                            self._run_oneway(conn, method, payload), target)
                    else:
                        asyncio.ensure_future(
                            self._run_oneway(conn, method, payload))
                elif kind == _REQUEST:
                    # per-op loop routing: a frame for a shard-owned op
                    # dispatches onto the owning loop straight from the
                    # read loop; the reply marshals back to THIS loop,
                    # which owns the StreamWriter (see _run_request)
                    target = self._route_loop(method)
                    if target is not None:
                        self._spawn_routed(
                            self._run_request(conn, writer, req_id, method,
                                              payload,
                                              origin_loop=
                                              asyncio.get_running_loop()),
                            target)
                    else:
                        asyncio.ensure_future(
                            self._run_request(conn, writer, req_id, method,
                                              payload)
                        )
        finally:
            self.connections.discard(conn)
            try:
                self._host_obj.on_peer_disconnect(conn)
            except Exception:
                pass
            try:
                writer.close()
            except Exception:
                pass

    async def _run_oneway(self, conn, method, payload):
        try:
            payload = dict(payload or {})
            if self._wants_conn(method):
                payload["_conn"] = conn
            await self._host_obj.dispatch(method, payload)
        except Exception:
            import traceback

            traceback.print_exc()

    def _route_loop(self, method: str):
        """The foreign loop that owns this op, or None for the serving
        loop (the empty default map costs one attribute read + ``get``)."""
        # duck-typed hosts (e.g. the serve rpc ingress) may not carry
        # the RpcHost class attribute at all
        op_loops = getattr(self._host_obj, "rpc_op_loops", None)
        if not op_loops:
            return None
        target = op_loops.get(method)
        if target is None:
            return None
        try:
            if target is asyncio.get_running_loop():
                return None
        except RuntimeError:
            pass
        return target

    def _spawn_routed(self, coro, target_loop) -> None:
        fut = asyncio.run_coroutine_threadsafe(coro, target_loop)
        self._routed_inflight.add(fut)
        fut.add_done_callback(self._routed_inflight.discard)

    async def _run_request(self, conn, writer, req_id, method, payload,
                           origin_loop=None):
        try:
            payload = dict(payload or {})
            if self._wants_conn(method):
                payload["_conn"] = conn
            result = await self._host_obj.dispatch(method, payload)
            out = _pack(_REPLY, req_id, method, result)
        except Exception as e:
            import traceback

            out = _pack(_ERROR, req_id, method, f"{e}\n{traceback.format_exc()}")
        if origin_loop is not None \
                and origin_loop is not asyncio.get_running_loop():
            # routed handler: the StreamWriter belongs to the serving
            # loop — marshal the reply bytes back and write/drain there
            try:
                origin_loop.call_soon_threadsafe(
                    self._write_from_origin, writer, out)
            except RuntimeError:
                pass  # serving loop closed mid-flight
            return
        try:
            writer.write(out)
            await writer.drain()
        except (ConnectionResetError, RuntimeError):
            pass

    def _write_from_origin(self, writer, out: bytes) -> None:
        async def _w():
            try:
                writer.write(out)
                await writer.drain()
            except (ConnectionResetError, RuntimeError):
                pass

        asyncio.ensure_future(_w())

    def _wants_conn(self, method: str) -> bool:
        cached = self._wants_conn_cache.get(method)
        if cached is not None:
            return cached
        handler = getattr(self._host_obj, f"rpc_{method}", None)
        code = getattr(handler, "__code__", None) if handler is not None else None
        if code is None:
            result = False
        else:
            nparams = code.co_argcount + code.co_kwonlyargcount
            result = "_conn" in code.co_varnames[:nparams]
        self._wants_conn_cache[method] = result
        return result


class RpcClient:
    """Async client with reconnect-on-demand and push-message callback."""

    def __init__(self, host: str, port: int, on_push=None, label: str = ""):
        self.host, self.port = host, port
        self._on_push = on_push
        self._label = label
        self._reader = None
        self._writer = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._req_ids = itertools.count(1)
        self._read_task = None
        self._lock = asyncio.Lock()
        # True once the connection is unusable (read loop exited or
        # close() called).  Client caches must key replacement on THIS,
        # not on `connected`: a freshly created client is not yet
        # connected, and replacing it mid-connect orphans its read task
        # (GC'd while pending -> "Task was destroyed" spew + fd leak).
        self.dead = False

    @property
    def connected(self) -> bool:
        return self._writer is not None

    async def connect(self) -> None:
        from ray_tpu_torch._private.config import config

        async with self._lock:
            if self._writer is not None:
                return
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                timeout=config.rpc_connect_timeout_s,
            )
            self.dead = False  # a successful reconnect resurrects
            self._read_task = asyncio.ensure_future(self._read_loop())

    async def close(self) -> None:
        self.dead = True
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        task, self._read_task = self._read_task, None
        if task is not None:
            task.cancel()
            # Run the cancelled read loop to completion now: a Task left
            # pending when the loop stops spews "Task was destroyed but
            # it is pending!" at interpreter teardown.
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    async def _read_loop(self):
        try:
            while True:
                kind, req_id, method, payload = await _read_frame(self._reader)
                if kind in (_REPLY, _ERROR):
                    fut = self._pending.pop(req_id, None)
                    if fut is not None and not fut.done():
                        if kind == _REPLY:
                            fut.set_result(payload)
                        else:
                            fut.set_exception(RpcError(payload))
                elif kind == _ONEWAY and self._on_push is not None:
                    try:
                        res = self._on_push(method, payload)
                        if asyncio.iscoroutine(res):
                            asyncio.ensure_future(res)
                    except Exception:
                        import traceback

                        traceback.print_exc()
        except (asyncio.IncompleteReadError, ConnectionResetError, asyncio.CancelledError):
            pass
        except Exception:
            import traceback

            traceback.print_exc()
        finally:
            self.dead = True
            self._writer = None
            err = ConnectionLost(f"connection to {self._label or self.host}:{self.port} lost")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()

    async def call(self, method: str, timeout: Optional[float] = None, **payload) -> Any:
        from ray_tpu_torch._private.config import config

        if self._writer is None:
            await self.connect()
        writer = self._writer
        if writer is None:
            raise ConnectionLost(f"connection to {self._label or self.host}:{self.port} lost")
        req_id = next(self._req_ids)
        frame = _pack(_REQUEST, req_id, method, payload)
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            if await self._chaos_send(method):
                writer.write(frame)
                await writer.drain()
            # else: chaos "drop" — frame never hits the wire; the caller
            # times out exactly like a frame lost by the network would
        except ConnectionLost:
            self._pending.pop(req_id, None)
            raise
        except (OSError, RuntimeError, AttributeError) as e:
            self._pending.pop(req_id, None)
            raise ConnectionLost(str(e)) from e
        try:
            return await asyncio.wait_for(
                fut, timeout if timeout is not None else config.rpc_call_timeout_s
            )
        finally:
            self._pending.pop(req_id, None)

    async def _chaos_send(self, method: str) -> bool:
        """rpc.send chaos site.  True = write the frame; False = drop it
        silently (the request then times out, like a frame the network
        lost).  A "sever" decision closes the transport and raises
        ConnectionLost, like a real mid-call connection break."""
        if not fault_injection._rules:
            return True  # disarmed: skip even the key formatting
        chaos = fault_injection.decide(
            "rpc.send", key=f"{self._label}:{method}")
        if chaos is None:
            return True
        if chaos.action == "delay":
            await fault_injection.sleep_async(chaos.delay_s)
            return True
        if chaos.action == "sever":
            writer, self._writer = self._writer, None
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass
            raise ConnectionLost(
                f"chaos: connection to {self._label or self.host}:"
                f"{self.port} severed")
        return False  # drop

    async def oneway(self, method: str, **payload) -> None:
        if self._writer is None:
            await self.connect()
        writer = self._writer
        if writer is None:
            raise ConnectionLost(f"connection to {self._label or self.host}:{self.port} lost")
        try:
            if not await self._chaos_send(method):
                return  # chaos "drop": oneways vanish without a trace
            writer.write(_pack(_ONEWAY, 0, method, payload))
            await writer.drain()
        except (OSError, RuntimeError, AttributeError) as e:
            raise ConnectionLost(str(e)) from e


class EventLoopThread:
    """A dedicated asyncio loop thread.

    Worker/driver processes execute user code on the main thread; all their
    RPC (server + clients) runs here.  Mirrors the role of the reference
    core worker's io_service thread (reference: src/ray/core_worker/
    core_worker_process.h — the boost::asio io context).
    """

    def __init__(self, name: str = "rt-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: Optional[float] = None):
        """Run coroutine on the loop from a foreign thread, blocking."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        if threading.current_thread() is self._thread:
            # already on the loop: create_task directly —
            # run_coroutine_threadsafe would pay a self-pipe wakeup
            # SYSCALL per call even from the loop thread, and the
            # dispatch pump spawns a push per batch on the hot path
            return self.loop.create_task(coro)
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        async def _drain():
            # Sweep repeatedly: cancellation callbacks may spawn new
            # tasks (ensure_future in push handlers); a task left pending
            # at loop teardown spews "Task was destroyed but it is
            # pending!" when it is later garbage collected.
            for _ in range(3):
                tasks = [t for t in asyncio.all_tasks(self.loop)
                         if t is not asyncio.current_task()]
                if not tasks:
                    break
                for task in tasks:
                    task.cancel()
                # let cancelled tasks run their (possibly awaiting) cleanup
                await asyncio.gather(*tasks, return_exceptions=True)
            self.loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(_drain(), self.loop)
        except RuntimeError:
            pass
        self._thread.join(timeout=5)


class SyncRpcClient:
    """Blocking facade over RpcClient for use from the main thread.

    With ``retry_lost_s`` > 0, calls that fail on connection loss or
    refusal retry until the window closes — this is what lets drivers
    and workers ride out a head restart (reference: gcs_rpc_client.h
    retryable GCS client).  The retry schedule is ``backoff_delays``:
    exponential with jitter, capped — many clients riding out the same
    head restart desynchronize instead of dialing in lockstep.
    """

    def __init__(self, host: str, port: int, io: EventLoopThread, on_push=None,
                 label="", retry_lost_s: float = 0.0):
        self._io = io
        self._client = RpcClient(host, port, on_push=on_push, label=label)
        self._retry_lost_s = retry_lost_s

    @property
    def aio(self) -> RpcClient:
        return self._client

    def call(self, method: str, timeout: Optional[float] = None, **payload) -> Any:
        import time as _time

        from ray_tpu_torch._private.config import config

        # Outer margin over the inner asyncio timeout so a wedged IO loop
        # cannot block the caller forever.
        inner = timeout if timeout is not None else config.rpc_call_timeout_s
        deadline = _time.monotonic() + self._retry_lost_s
        delays = backoff_delays()
        while True:
            try:
                return self._io.run(
                    self._client.call(method, timeout=timeout, **payload),
                    timeout=inner + 30.0,
                )
            except (ConnectionLost, ConnectionRefusedError, OSError,
                    asyncio.TimeoutError):
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(min(next(delays),
                                max(0.0, deadline - _time.monotonic())))

    def oneway(self, method: str, **payload) -> None:
        from ray_tpu_torch._private.config import config

        self._io.run(
            self._client.oneway(method, **payload),
            timeout=config.rpc_call_timeout_s,
        )

    def close(self):
        try:
            self._io.run(self._client.close(), timeout=5)
        except Exception:
            pass
