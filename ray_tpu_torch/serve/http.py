"""HTTP ingress for ray_tpu_torch.serve.

Equivalent of the reference's per-node proxy actors
(reference: python/ray/serve/_private/proxy.py — uvicorn HTTP ingress
routing to DeploymentHandles via the router).  This proxy is an actor
hosting a minimal asyncio HTTP/1.1 server (no third-party deps in the
image): requests to ``/<deployment>`` are routed through a
DeploymentHandle, so they get the same least-outstanding-requests
balancing, replica refresh, and autoscaling metrics as in-cluster
callers.

The data plane is ASYNC END TO END: every request runs as one coroutine
on the proxy event loop — handle routing via ``remote_async`` /
``stream_async`` and value resolution via awaitable object refs
(``worker.get_async``), so in-flight capacity is bounded by the
configurable shed gate (503 beyond ``serve_max_inflight_requests``),
not by an executor thread pool.  Trace context rides contextvars (one
asyncio task per request isolates them); connections are keep-alive
with HTTP/1.1 pipelining, and chunked/SSE responses leave the
connection open.  The pre-async executor-thread dispatch survives as
``legacy_threads=True`` purely as the bench baseline for serve_rps.

Routing convention:
  GET  /<name>            -> callable invoked with the query dict ({} if none)
  POST /<name>  (json)    -> callable invoked with the parsed JSON body
  POST /<name>  (other)   -> callable invoked with the raw body bytes
  GET  /-/healthz         -> 200 "ok" (proxy liveness)
Responses are JSON-encoded when possible, else ``str()``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional
from urllib.parse import parse_qsl, urlsplit

PROXY_NAME = "_serve_http_proxy"

# sentinel first element of a _read_request error result
_PARSE_ERR = "_err"

# sentinel for "stream produced no first item" in the prefetch path
_NO_ITEM = object()


def _is_overload_error(e) -> bool:
    """Replica-side admission shed (serve/llm.py LLMOverloadedError)
    riding inside a RayTaskError chain — matched structurally so the
    proxy can answer 503 without importing the llm module on the hot
    path."""
    return _chain_has(e, "LLMOverloadedError")


def _is_deadline_error(e) -> bool:
    """DeadlineExceededError — raised proxy-side by a bounded await, or
    replica-side (LLM admission, a bounded nested get) and carried in a
    RayTaskError chain.  Mapped to 504 Gateway Timeout: the budget is
    spent, retrying the same request cannot help."""
    return _chain_has(e, "DeadlineExceededError")


def _chain_has(e, name: str) -> bool:
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if type(e).__name__ == name or name in str(e):
            return True
        e = getattr(e, "cause", None) or e.__cause__
    return False


class _GateCharge:
    """Once-only holder of one admission-gate slot.  Released by the
    gated stream's finally on any consumed path; the __del__ fallback
    covers a stream dropped before its first iteration — an unstarted
    async generator's finally never runs, so GC of the wrapper (which
    pins this object in its closure) is the only signal left."""

    __slots__ = ("_proxy", "_lock", "_released")

    def __init__(self, proxy):
        self._proxy = proxy
        self._lock = threading.Lock()
        self._released = False

    def release(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
        proxy = self._proxy

        def dec():
            proxy._inflight -= 1

        try:
            if threading.get_ident() == proxy._loop_thread_ident:
                dec()
            else:
                proxy._loop.call_soon_threadsafe(dec)
        except RuntimeError:
            pass  # loop closed: the proxy is going away

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class _HttpProxy:
    """Actor wrapping the asyncio HTTP server (one per ingress port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_inflight: Optional[int] = None,
                 legacy_threads: bool = False):
        import asyncio

        from ray_tpu_torch._private.config import config
        from ray_tpu_torch._private.metrics import (default_registry,
                                              serve_proxy_inflight_gauge,
                                              serve_request_latency_histogram,
                                              serve_sheds_counter)

        self._handles: Dict[str, Any] = {}
        self._legacy = legacy_threads
        self._max_inflight = int(
            max_inflight if max_inflight is not None
            else config.serve_max_inflight_requests)
        self._inflight = 0  # loop-confined: touched only on the proxy loop
        self._latency = serve_request_latency_histogram()
        # 503s by reason — the serve autoscaler's SLO-pressure signal
        self._sheds = serve_sheds_counter()
        # inflight gauge sampled at metrics render — zero cost on the
        # request hot path (see metrics.serve_proxy_inflight_gauge).
        # The collector is deregistered when the serve loop exits so a
        # recycled worker process hosting successive proxies doesn't
        # accumulate closures over dead instances.
        inflight_g = serve_proxy_inflight_gauge()
        self._inflight_collector = lambda: inflight_g.set(self._inflight)
        default_registry.add_collector(self._inflight_collector)
        self._loop = asyncio.new_event_loop()
        self._loop_thread_ident = None  # set by the serve thread
        self._started = threading.Event()
        self._addr: Optional[tuple] = None
        self._thread = threading.Thread(
            target=self._serve_forever, args=(host, port),
            name="serve-http", daemon=True)
        self._thread.start()
        self._started.wait(30)

    def _serve_forever(self, host: str, port: int):
        import asyncio

        self._loop_thread_ident = threading.get_ident()
        asyncio.set_event_loop(self._loop)

        from ray_tpu_torch._private.config import config

        # stream buffer comfortably above the header cap so the 431
        # path (not a raw ValueError from readline) handles long lines
        limit = max(2 ** 16, 2 * int(config.serve_max_header_bytes))

        probe_task = None

        async def _start():
            nonlocal probe_task
            from ray_tpu_torch._private.profiling import loop_lag_probe

            server = await asyncio.start_server(self._client, host, port,
                                                limit=limit)
            self._addr = server.sockets[0].getsockname()[:2]
            # health probe for the proxy's own loop: request handling is
            # loop-confined, so lag here IS added request latency
            probe_task = asyncio.ensure_future(loop_lag_probe("serve_proxy"))
            self._started.set()
            return server

        server = self._loop.run_until_complete(_start())
        try:
            self._loop.run_forever()
        finally:
            # a forever-task left pending when the loop dies spews
            # "Task was destroyed but it is pending!" at teardown
            if probe_task is not None:
                probe_task.cancel()
            from ray_tpu_torch._private.metrics import default_registry

            default_registry.remove_collector(self._inflight_collector)
            server.close()

    def address(self):
        return list(self._addr) if self._addr else None

    def health(self):
        return True

    # ---- connection handling ----------------------------------------------

    async def _client(self, reader, writer):
        """Per-connection driver: a parse loop feeds an ordered queue of
        response slots consumed by one writer coroutine — request N+1 is
        parsed and ROUTED while N is still executing (HTTP/1.1
        pipelining), responses always leave in request order.  The
        bounded queue is the per-connection pipelining backpressure."""
        import asyncio

        from ray_tpu_torch._private.config import config

        slots: "asyncio.Queue" = asyncio.Queue(
            maxsize=max(1, int(config.serve_pipeline_depth)))
        wtask = asyncio.ensure_future(self._response_writer(slots, writer))
        tasks = []
        try:
            while not wtask.done():
                req = await self._read_request(reader)
                if req is None:
                    break  # clean EOF / client went away
                if req[0] is _PARSE_ERR:
                    # framing is untrustworthy after a parse error:
                    # respond and close
                    slot = asyncio.get_running_loop().create_future()
                    slot.set_result((req[1], req[2], None, False))
                    await self._put_slot(slots, slot, wtask)
                    break
                method, target, headers, body, keep = req
                slot = asyncio.get_running_loop().create_future()
                if not await self._put_slot(slots, slot, wtask):
                    break  # writer died with the queue full: tear down
                tasks.append(asyncio.ensure_future(self._handle_request(
                    method, target, headers, body, keep, slot)))
                tasks = [t for t in tasks if not t.done()]
                if not keep:
                    break  # last request on this connection
            # end-of-responses sentinel
            await self._put_slot(slots, None, wtask)
            try:
                await wtask
            except Exception:
                pass
        except (ConnectionError, TimeoutError):
            pass  # peer went away: normal
        except asyncio.IncompleteReadError:
            pass
        except Exception as e:
            import sys

            print(f"[serve.http] connection handler error: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
        finally:
            wtask.cancel()
            for t in tasks:
                t.cancel()
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    async def _put_slot(slots, slot, wtask) -> bool:
        """Enqueue a response slot, raced against writer-task exit: a
        full pipeline queue with a dead writer (peer reset mid-burst)
        must never park the connection coroutine forever.  Returns False
        when the writer is gone."""
        import asyncio

        put = asyncio.ensure_future(slots.put(slot))
        await asyncio.wait({put, wtask},
                           return_when=asyncio.FIRST_COMPLETED)
        if put.done():
            return True
        put.cancel()
        return False

    async def _read_request(self, reader):
        """Parse one request.  Returns (method, target, headers, body,
        keep), an (``_PARSE_ERR``, status, payload) triple for requests
        answered with an error + close, or None on EOF.

        Defensive by design (one misbehaving client must not take the
        proxy down): malformed Content-Length -> 400, header bytes
        beyond serve_max_header_bytes -> 431, bodies beyond
        serve_max_body_bytes -> 413.  HTTP/1.0 is close-by-default —
        keep-alive only on explicit opt-in."""
        import asyncio

        from ray_tpu_torch._private.config import config

        max_head = int(config.serve_max_header_bytes)
        try:
            while True:  # tolerate stray blank lines between requests
                line = await reader.readline()
                if not line:
                    return None
                if line not in (b"\r\n", b"\n"):
                    break
            if len(line) > max_head:
                return (_PARSE_ERR, "431 Request Header Fields Too Large",
                        b'{"error": "request line too long"}')
            try:
                method, target, version = line.decode("latin1").split(" ", 2)
            except ValueError:
                return (_PARSE_ERR, "400 Bad Request",
                        b'{"error": "malformed request line"}')
            headers: Dict[str, str] = {}
            total = len(line)
            while True:
                h = await reader.readline()
                if not h:
                    return None  # EOF mid-headers
                if h in (b"\r\n", b"\n"):
                    break
                total += len(h)
                if total > max_head:
                    return (_PARSE_ERR,
                            "431 Request Header Fields Too Large",
                            b'{"error": "headers too large"}')
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
        except (ConnectionError, asyncio.IncompleteReadError):
            return None
        except ValueError:
            # readline overran the stream buffer: a single header line
            # beyond even the raised limit
            return (_PARSE_ERR, "431 Request Header Fields Too Large",
                    b'{"error": "header line too long"}')
        http10 = version.strip().upper().startswith("HTTP/1.0")
        conn = headers.get("connection", "").lower()
        keep = (conn == "keep-alive") if http10 else (conn != "close")
        te = headers.get("transfer-encoding", "").lower()
        if te and te != "identity":
            # a chunked body we don't de-frame would be re-parsed as
            # pipelined requests — the classic smuggling vector; refuse
            # instead of desyncing
            return (_PARSE_ERR, "501 Not Implemented",
                    b'{"error": "transfer-encoding not supported"}')
        body = b""
        cl = headers.get("content-length")
        if cl:
            try:
                length = int(cl)
                if length < 0:
                    raise ValueError(cl)
            except ValueError:
                return (_PARSE_ERR, "400 Bad Request",
                        b'{"error": "invalid content-length"}')
            if length > int(config.serve_max_body_bytes):
                return (_PARSE_ERR, "413 Payload Too Large",
                        b'{"error": "request body too large"}')
            if length:
                try:
                    body = await reader.readexactly(length)
                except (ConnectionError, asyncio.IncompleteReadError):
                    return None
        return method, target, headers, body, keep

    async def _handle_request(self, method, target, headers, body, keep,
                              slot):
        import asyncio

        try:
            status, payload, stream = await self._route(method, target,
                                                        headers, body)
        except asyncio.CancelledError:
            # connection teardown cancelled us: wake a writer parked on
            # this slot, then stay cancelled (never fabricate a 500)
            if not slot.done():
                slot.cancel()
            raise
        except Exception as e:
            status, payload, stream = (
                "500 Internal Server Error",
                json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                None)
        if not slot.done():
            slot.set_result((status, payload, stream, keep))

    async def _response_writer(self, slots, writer):
        """Drain response slots in request order (the pipelining
        contract), writing chunked/SSE responses item by item.  The
        connection stays alive after a chunked response — its framing
        is self-terminating (``0\\r\\n\\r\\n``)."""
        while True:
            slot = await slots.get()
            if slot is None:
                return
            status, payload, stream, keep = await slot
            if stream is not None:
                if hasattr(stream, "__anext__"):
                    await self._write_chunked(writer, stream, keep)
                else:
                    # legacy baseline: blocking generator, force-close
                    await self._write_chunked_legacy(writer, stream)
                    return
            else:
                writer.write(
                    b"HTTP/1.1 " + status.encode() + b"\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(payload)).encode() +
                    b"\r\n"
                    b"Connection: " + (b"keep-alive" if keep else b"close") +
                    b"\r\n\r\n" + payload)
                await writer.drain()
            if not keep:
                return

    # ---- routing ----------------------------------------------------------

    async def _route(self, method: str, target: str, headers, body: bytes):
        """Tracing + admission wrapper around the actual routing: an
        inbound W3C ``traceparent`` header continues the external
        caller's trace (reference: serve's OTel middleware); a malformed
        header is ignored — the request proceeds untraced-from-outside
        but still starts its own sampled root.  The span context is
        activated on the request's contextvars (each request is its own
        asyncio task, so contexts are isolated) and flows through
        remote_async/stream_async into the replica spans.

        Admission: beyond ``serve_max_inflight_requests`` concurrently
        routed requests the proxy sheds load with 503 instead of
        queueing — memory stays bounded and the caller gets an
        actionable signal (health checks bypass the gate)."""
        from ray_tpu_torch._private import tracing

        path = urlsplit(target).path
        if path.strip("/") == "-/healthz":
            return await self._route_inner(method, target, headers, body)
        if not self._legacy and self._inflight >= self._max_inflight:
            self._latency.observe(0.0, tags={"code": "503"})
            self._sheds.inc(tags={"reason": "proxy"})
            self._note_shed(path.strip("/"))
            return ("503 Service Unavailable",
                    b'{"error": "proxy overloaded, try again"}', None)
        self._inflight += 1
        stream = None
        t0 = time.perf_counter()
        span = tracing.start_span(
            f"http {method} {path}", kind=tracing.KIND_SERVER,
            parent=tracing.parse_traceparent(headers.get("traceparent")))
        token = tracing.activate(span.context()) if span else None
        # an absolute X-Request-Deadline-Ms header becomes the ambient
        # deadline for this request's whole coroutine tree: the handle
        # call stamps it into the replica task spec, so every nested
        # .remote()/get() downstream spends only the caller's remaining
        # budget (deadlines.py — the W3C-traceparent of latency bounds)
        from ray_tpu_torch._private import deadlines

        dl = deadlines.from_header(headers.get(deadlines.DEADLINE_HEADER))
        dl_token = deadlines.activate(dl) if dl is not None else None
        try:
            status, payload, stream = await self._route_inner(
                method, target, headers, body)
        except BaseException as e:
            if span is not None:
                span.end(error=f"{type(e).__name__}: {e}")
            raise
        finally:
            if stream is not None and hasattr(stream, "__anext__"):
                # a live stream keeps its in-flight charge until it
                # finishes — otherwise long-lived SSE streams would
                # escape the shed gate microseconds after admission
                stream = self._gated_stream(stream, _GateCharge(self))
            else:
                self._inflight -= 1
            if dl_token is not None:
                deadlines.restore(dl_token)
            if token is not None:
                tracing.restore(token)
        self._latency.observe(time.perf_counter() - t0,
                              tags={"code": status.split(" ", 1)[0]})
        if span is not None:
            span.set_attribute("http.status", status.split(" ", 1)[0])
            span.end(error="" if status.startswith("2") else status)
        return status, payload, stream

    def _note_shed(self, name: str) -> None:
        """Report a shed against the deployment's handle so the
        metrics pusher carries it to the controller — the replica
        autoscaler's scale-up trigger (declared headroom (c))."""
        handle = self._handles.get(name)
        if handle is not None:
            try:
                handle.note_shed()
            except Exception:
                pass

    @staticmethod
    def _gated_stream(agen, charge: _GateCharge):
        """Pass stream items through; the charge releases when the
        stream ends (exhausted, errored, generator finalized) — and,
        because the unstarted wrapper pins `charge` in its closure, via
        _GateCharge.__del__ if the stream is dropped before its first
        iteration (where no finally could ever run)."""
        async def _gen():
            try:
                async for item in agen:
                    yield item
            finally:
                charge.release()
                # close the chain explicitly: GC finalization of the
                # inner generators is too late for disconnect-cancel
                try:
                    await agen.aclose()
                except Exception:
                    pass

        return _gen()

    async def _route_inner(self, method: str, target: str, headers,
                           body: bytes):
        parts = urlsplit(target)
        path = parts.path.strip("/")
        if path == "-/healthz":
            return "200 OK", b'"ok"', None
        if not path or "/" in path:
            return "404 Not Found", json.dumps(
                {"error": f"no route {parts.path!r}"}).encode(), None
        if method == "GET":
            arg: Any = dict(parse_qsl(parts.query))
        elif headers.get("content-type", "").startswith("application/json"):
            try:
                arg = json.loads(body or b"null")
            except ValueError:
                return "400 Bad Request", b'{"error": "invalid json"}', None
        else:
            arg = body
        # streaming negotiation (reference: serve streaming responses via
        # StreamingResponse): Accept: text/event-stream opts the request
        # into a chunked response fed by the replica's generator
        want_stream = headers.get("accept", "").startswith(
            "text/event-stream")
        if self._legacy:
            return await self._route_legacy(path, arg, want_stream)
        try:
            if want_stream:
                gen = await self._stream_async_values(path, arg)
                # prefetch the FIRST item before committing a status
                # line: replica-side admission errors (the LLM tier's
                # 503 shed, bad requests) become real status codes
                # instead of an error chunk behind a 200 — and TTFT for
                # token streams was always going to wait for this item
                try:
                    first = await gen.__anext__()
                except StopAsyncIteration:
                    first = _NO_ITEM
                except Exception as e:
                    with_suppress = getattr(gen, "aclose", None)
                    if with_suppress is not None:
                        try:
                            await with_suppress()
                        except Exception:
                            pass
                    if _is_overload_error(e):
                        self._sheds.inc(tags={"reason": "replica"})
                        self._note_shed(path)
                        return ("503 Service Unavailable", json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}).encode(),
                            None)
                    if _is_deadline_error(e):
                        # budget gone before the first item (LLM
                        # admission refusal, expired while queued): a
                        # real status line, not an error chunk
                        return ("504 Gateway Timeout", json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}).encode(),
                            None)
                    raise
                return "200 OK", b"", self._chain_first(first, gen)
            result = await self._call_async(path, arg)
        except KeyError:
            return "404 Not Found", json.dumps(
                {"error": f"no deployment named {path!r}"}).encode(), None
        except Exception as e:
            if _is_overload_error(e):
                # replica-side admission shed on the unary path: a real
                # 503 (retriable), not a 500 — and autoscale pressure
                self._sheds.inc(tags={"reason": "replica"})
                self._note_shed(path)
                return "503 Service Unavailable", json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(), None
            if _is_deadline_error(e):
                # the request's end-to-end deadline expired inside the
                # cluster: 504, the budget is spent
                return "504 Gateway Timeout", json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(), None
            return "500 Internal Server Error", json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode(), None
        try:
            payload = json.dumps(result).encode()
        except TypeError:
            payload = json.dumps(str(result)).encode()
        return "200 OK", payload, None

    @staticmethod
    def _chain_first(first, agen):
        """Re-attach a prefetched first item in front of the remaining
        stream; closing the chain closes the underlying stream (the
        disconnect-cancel path rides these aclose hops)."""
        async def _gen():
            try:
                if first is not _NO_ITEM:
                    yield first
                async for item in agen:
                    yield item
            finally:
                await agen.aclose()

        return _gen()

    async def _call_async(self, name: str, arg: Any):
        """The hot path: submit + await through the handle's
        dead-replica-retrying call_async on this loop — no executor
        thread anywhere.  A request whose replica died mid-flight (node
        churn) is transparently re-sent to a surviving replica inside
        the handle; the proxy-level fallback below additionally covers
        wholesale replica replacement (stale cached handle) by
        refreshing the handle once, like the sync path always did."""
        import ray_tpu_torch

        from ray_tpu_torch._private.errors import DeadlineExceededError

        handle = await self._resolve_handle_async(name)
        try:
            return await handle.call_async(arg, _timeout=120)
        except ray_tpu_torch.RayTaskError:
            raise  # user exception: retrying cannot change the outcome
        except DeadlineExceededError:
            raise  # budget spent: a retry would just spend more
        except ray_tpu_torch.RayError:
            handle = await self._resolve_handle_async(name, fresh=True)
            return await handle.call_async(arg, _timeout=120)

    async def _stream_async_values(self, name: str, arg: Any):
        """Async iterator of ITEM VALUES for an SSE response.  The
        replica call is submitted EAGERLY, here in the route coroutine
        — the ingress span is still active, so the serve.stream span
        parents correctly (the returned generator first runs later, in
        the writer task's context).  A stale cached handle refreshes
        once — safe to restart the stream unconditionally only before
        any item was consumed.

        Mid-stream replica death is additionally survivable for
        RESUMABLE streams — ones whose every item is a dict carrying an
        integer generation index "i" (the LLM serving contract): the
        request is re-sent once with ``emit_from`` = last delivered
        index + 1 (and the original dict arg, so a ``request_id``
        re-attaches to live sequence state on a surviving replica).
        The client sees at most one duplicated token boundary; greedy
        decode is deterministic, so a re-prefill on a survivor yields
        identical tokens."""
        import ray_tpu_torch

        info: Dict[str, Any] = {}
        if isinstance(arg, dict) and not arg.get("request_id"):
            # stamp the rid HERE, before the first submit: the
            # disaggregated-prefill hop (handle._maybe_prefill) and any
            # mid-stream resume then address the same engine sequence —
            # shipped KV pages and re-attach both key on request_id
            import uuid

            arg["request_id"] = uuid.uuid4().hex
        handle = await self._resolve_handle_async(name)
        agen = await handle.stream_async(arg, _info=info)

        async def _values():
            import asyncio

            from ray_tpu_torch._private.config import config
            from ray_tpu_torch._private.errors import (ActorDiedError,
                                                 ActorUnavailableError,
                                                 DeadlineExceededError,
                                                 RayWorkerError)

            dead_errors = (ActorDiedError, ActorUnavailableError,
                           RayWorkerError)
            nonlocal handle, agen
            yielded = False
            resumable = isinstance(arg, dict)
            last_i = None
            # pre-first-item restarts keep the old once-only budget;
            # mid-stream RESUMES get the dead-replica retry budget,
            # excluding replicas this stream already saw die (a fresh
            # roster may briefly still list them, and their zero
            # inflight would draw the least-outstanding pick back)
            attempts = 1 + max(0, int(config.serve_dead_replica_retries))
            retries = 0
            dead: set = set()
            try:
                while True:
                    try:
                        try:
                            ref = await agen.__anext__()
                        except StopAsyncIteration:
                            return
                        value = await ray_tpu_torch.get_async(ref, timeout=120)
                    except ray_tpu_torch.RayTaskError:
                        raise  # user/application error: never retried
                    except DeadlineExceededError:
                        # the stream's budget expired mid-decode: close
                        # with the typed error chunk (the chunk writer's
                        # producer-error path), never resume-retry
                        raise
                    except ray_tpu_torch.RayError as e:
                        retries += 1
                        if isinstance(e, dead_errors) and info.get("rid"):
                            # only replica DEATH blacklists the replica;
                            # transient runtime errors must not strip a
                            # healthy roster
                            dead.add(info["rid"])
                            handle._drop_replica(info["rid"])
                        if not yielded:
                            if retries > 1:
                                raise
                            handle = await self._resolve_handle_async(
                                name, fresh=True)
                            agen = await handle.stream_async(
                                arg, _exclude=dead, _info=info)
                            continue
                        if resumable and last_i is not None \
                                and retries <= attempts:
                            await asyncio.sleep(0.25 * retries)
                            handle = await self._resolve_handle_async(
                                name, fresh=True)
                            agen = await handle.stream_async(
                                {**arg, "emit_from": last_i + 1},
                                _exclude=dead, _info=info)
                            continue
                        raise  # mid-stream death, not resumable
                    yielded = True
                    if resumable and isinstance(value, dict) \
                            and isinstance(value.get("i"), int):
                        # coalesced items cover [i, i+len(tokens)-1]
                        span = value.get("tokens")
                        last_i = value["i"] + (
                            len(span) - 1 if isinstance(span, list)
                            and span else 0)
                    else:
                        resumable = False
                    yield value
            finally:
                # closing the value stream closes the handle stream,
                # whose finally cancels an unfinished replica-side
                # generator — the disconnect -> free-KV-pages path
                try:
                    await agen.aclose()
                except Exception:
                    pass

        return _values()

    async def _write_chunked(self, writer, agen, keep: bool):
        """One HTTP/1.1 chunk per streamed item (JSON + newline), pulled
        off the async value iterator on this loop.  Chunked framing is
        self-terminating, so the connection stays alive afterwards.

        Client disconnect (write/drain raising a connection error) stops
        the pull loop IMMEDIATELY — no error chunk is owed to a dead
        peer — and the finally's aclose cascades down the stream chain:
        gate charge released, handle inflight released, replica-side
        generator cancelled (an abandoned LLM decode frees its KV pages
        instead of generating to max_seq_len)."""
        try:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Transfer-Encoding: chunked\r\n"
                         b"Connection: " +
                         (b"keep-alive" if keep else b"close") +
                         b"\r\n\r\n")
            await writer.drain()
            while True:
                # the PRODUCER pull gets its own try: any replica-side
                # failure (including timeouts, which share bases with
                # connection errors) is reported to the still-live peer
                # as an error chunk — only WRITER failures below mean
                # the peer itself is gone
                try:
                    item = await agen.__anext__()
                except StopAsyncIteration:
                    break
                except Exception as e:
                    data = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    writer.write(hex(len(data))[2:].encode() + b"\r\n"
                                 + data + b"\r\n")
                    break
                try:
                    data = json.dumps(item).encode() + b"\n"
                except TypeError:
                    data = json.dumps(str(item)).encode() + b"\n"
                writer.write(hex(len(data))[2:].encode() + b"\r\n"
                             + data + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionError, TimeoutError, OSError):
            pass  # disconnect: the finally tears the producer down
        finally:
            # explicit close, not GC: a peer that vanished mid-stream
            # must release the admission-gate charge NOW (asyncgen
            # finalization can sit behind a traceback cycle until a
            # full GC pass)
            try:
                await agen.aclose()
            except Exception:
                pass

    # ---- handle cache -----------------------------------------------------

    async def _resolve_handle_async(self, name: str, fresh: bool = False):
        """Cached-handle lookup (the hot path: one dict read).  A cache
        miss resolves through the controller on an executor thread —
        explicitly NOT the request hot path (first request per
        deployment, or a post-RayError refresh)."""
        import asyncio

        if not fresh and name in self._handles:
            return self._handles[name]
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self._resolve_handle, name, fresh)

    def _resolve_handle(self, name: str, fresh: bool = False):
        from ray_tpu_torch.serve import api as serve_api

        if fresh:
            self._handles.pop(name, None)
        handle = self._handles.get(name)
        if handle is None:
            try:
                handle = serve_api.get_handle(name)
            except ValueError:
                raise KeyError(name)
            self._handles[name] = handle
        return handle

    # ---- legacy executor-thread dispatch (bench baseline only) -------------

    async def _route_legacy(self, path: str, arg: Any, want_stream: bool):
        """The pre-async data plane, kept verbatim as the measurable
        baseline for bench.py's serve_rps comparison: two thread hops
        per request, concurrency capped by the executor pool."""
        import asyncio

        from ray_tpu_torch._private import tracing

        trace_ctx = tracing.current_context()
        loop = asyncio.get_running_loop()
        try:
            if want_stream:
                gen = await loop.run_in_executor(
                    None, self._stream_blocking, path, arg, trace_ctx)
                return "200 OK", b"", gen
            result = await loop.run_in_executor(
                None, self._call_blocking, path, arg, trace_ctx)
        except KeyError:
            return "404 Not Found", json.dumps(
                {"error": f"no deployment named {path!r}"}).encode(), None
        except Exception as e:
            return "500 Internal Server Error", json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode(), None
        try:
            payload = json.dumps(result).encode()
        except TypeError:
            payload = json.dumps(str(result)).encode()
        return "200 OK", payload, None

    async def _write_chunked_legacy(self, writer, gen):
        """Chunk writer for the legacy blocking generator: items pulled
        in the executor; the connection closes afterwards (the old
        force-close behavior, preserved for baseline fidelity)."""
        import asyncio

        loop = asyncio.get_running_loop()
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        _end = object()
        try:
            while True:
                item = await loop.run_in_executor(None, next, gen, _end)
                if item is _end:
                    break
                try:
                    data = json.dumps(item).encode() + b"\n"
                except TypeError:
                    data = json.dumps(str(item)).encode() + b"\n"
                writer.write(hex(len(data))[2:].encode() + b"\r\n"
                             + data + b"\r\n")
                await writer.drain()
        except Exception as e:
            data = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
            writer.write(hex(len(data))[2:].encode() + b"\r\n"
                         + data + b"\r\n")
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    @staticmethod
    def _with_trace(trace_ctx, fn, *args):
        """Run fn with the ingress span active, restoring the thread's
        context immediately after — the window is kept tight because
        executor threads are shared across requests (and a generator
        frame resuming on one must not leak its context)."""
        if trace_ctx is None:
            return fn(*args)
        from ray_tpu_torch._private import tracing

        token = tracing.activate(trace_ctx)
        try:
            return fn(*args)
        finally:
            tracing.restore(token)

    def _stream_blocking(self, name: str, arg: Any, trace_ctx=None):
        """Resolve the handle and return an iterator of ITEM VALUES
        (refs resolved here, off the event loop).  Like _call_blocking,
        a stale cached handle (replicas replaced wholesale) refreshes
        once — safe to restart the stream only before any item was
        consumed."""
        import ray_tpu_torch

        handle = self._resolve_handle(name)

        def _values():
            nonlocal handle
            gen = self._with_trace(trace_ctx, handle.stream, arg)
            yielded = retried = False
            while True:
                try:
                    ref = next(gen, None)
                    if ref is None:
                        return
                    value = ray_tpu_torch.get(ref, timeout=120)
                except ray_tpu_torch.RayError:
                    if yielded or retried:
                        raise  # mid-stream death: cannot transparently restart
                    retried = True
                    handle = self._resolve_handle(name, fresh=True)
                    gen = self._with_trace(trace_ctx, handle.stream, arg)
                    continue
                yielded = True
                yield value

        return _values()

    def _call_blocking(self, name: str, arg: Any, trace_ctx=None):
        import ray_tpu_torch

        handle = self._resolve_handle(name)
        try:
            return ray_tpu_torch.get(
                self._with_trace(trace_ctx, handle.remote, arg),
                timeout=120)
        except ray_tpu_torch.RayError:
            # replicas may have been replaced wholesale: refresh once
            handle = self._resolve_handle(name, fresh=True)
            return ray_tpu_torch.get(
                self._with_trace(trace_ctx, handle.remote, arg),
                timeout=120)


def _proxy_name(node_id: str) -> str:
    return f"{PROXY_NAME}:{node_id[:12]}"


def start_http(host: str = "127.0.0.1", port: int = 0,
               max_inflight: Optional[int] = None,
               legacy_threads: bool = False):
    """Start (or fetch) the primary HTTP ingress; returns (host, port).

    One proxy per node (reference: _private/proxy.py runs per-node
    ingress actors): each proxy is pinned to its node via the implicit
    ``node:<id>`` resource and binds its own port, so requests enter on
    any node and route to replicas anywhere with locality-aware
    balancing.  Returns the primary (first node) proxy's address; use
    `proxy_addresses()` for all of them.

    ``max_inflight`` overrides the serve_max_inflight_requests shed
    gate; ``legacy_threads`` starts the executor-thread baseline data
    plane (bench comparisons only).  Both apply only to proxies CREATED
    by this call — an already-running proxy keeps its settings (use
    shutdown_http() first to change them).
    """
    addrs = start_per_node_http(host, port, max_inflight=max_inflight,
                                legacy_threads=legacy_threads)
    if not addrs:
        raise RuntimeError("HTTP proxy failed to bind")
    return addrs[0]


def start_per_node_http(host: str = "127.0.0.1", port: int = 0,
                        max_inflight: Optional[int] = None,
                        legacy_threads: bool = False):
    """Ensure a proxy on every node; returns [(host, port), ...].

    A fixed `port` applies only when nodes live on distinct hosts;
    multi-node-on-one-box tests must use port=0.
    """
    import ray_tpu_torch
    import ray_tpu_torch.api as rapi

    addrs = []
    for node in ray_tpu_torch.nodes():
        nid = node["node_id"]
        pname = _proxy_name(nid)
        try:
            proxy = ray_tpu_torch.get_actor(pname)
        except ValueError:
            try:
                proxy = rapi.ActorClass(
                    _HttpProxy, name=pname, lifetime="detached",
                    max_concurrency=16,
                    resources={f"node:{nid[:12]}": 0.001},
                ).remote(host, port, max_inflight, legacy_threads)
            except Exception as create_exc:
                # most likely a name collision (an RpcError, not a
                # RayError): another driver is creating this proxy
                # concurrently — wait for the winner to register the name
                deadline = time.monotonic() + 30
                while True:
                    try:
                        proxy = ray_tpu_torch.get_actor(pname)
                        break
                    except ValueError:
                        if time.monotonic() >= deadline:
                            raise create_exc
                        time.sleep(0.2)
        addr = ray_tpu_torch.get(proxy.address.remote(), timeout=120)
        if addr is None:
            # never leave a bind-failed proxy registered under the node
            # name — it would shadow every future start attempt
            try:
                ray_tpu_torch.kill(proxy)
            except Exception:
                pass
            raise RuntimeError(
                f"HTTP proxy failed to bind on node {nid[:12]} "
                f"(port {port} in use?)")
        addrs.append((addr[0], addr[1]))
    return addrs


def proxy_addresses():
    """Addresses of every live per-node proxy."""
    import ray_tpu_torch

    out = []
    for node in ray_tpu_torch.nodes():
        try:
            proxy = ray_tpu_torch.get_actor(_proxy_name(node["node_id"]))
            addr = ray_tpu_torch.get(proxy.address.remote(), timeout=30)
            if addr is not None:
                out.append((addr[0], addr[1]))
        except Exception:
            continue
    return out


def shutdown_http():
    import ray_tpu_torch

    killed = []
    for node in ray_tpu_torch.nodes():
        pname = _proxy_name(node["node_id"])
        try:
            proxy = ray_tpu_torch.get_actor(pname)
            ray_tpu_torch.kill(proxy)
            killed.append(pname)
        except Exception:
            continue
    # wait (bounded) for the names to deregister so an immediate
    # restart — bench alternates data planes proxy-by-proxy — can't
    # race a stale name into a dead-actor handle
    deadline = time.monotonic() + 10
    for pname in killed:
        while time.monotonic() < deadline:
            try:
                ray_tpu_torch.get_actor(pname)
            except ValueError:
                break  # name gone
            except Exception:
                break  # head unreachable: nothing more to wait on
            time.sleep(0.05)
