"""Distributed tracing: spans, context propagation, sampled buffering.

Equivalent of the reference's ``ray.util.tracing`` OpenTelemetry
integration (reference: python/ray/util/tracing/tracing_helper.py —
trace context is injected into the task spec on submission and
extracted worker-side so execute spans parent to the caller's submit
span), without the OpenTelemetry dependency: a span here is a plain
dict-able record with W3C-style ids.

Model:
  - trace_id (32 hex) / span_id (16 hex) / parent_id, name, kind
    (CLIENT for submit-side, SERVER for execute/ingress, INTERNAL
    otherwise), start/end wall timestamps, attributes, status.
  - The ACTIVE context rides a contextvar: every thread (and, via
    ``run_coroutine_threadsafe``'s context copy, every async task body)
    sees the span it is running under; nested ``.remote()`` submissions
    inherit it, which is what chains driver → task → subtask into one
    trace.
  - Sampling is decided once at the root span (``trace_sampling_ratio``)
    and propagated as a flag; unsampled requests pay nothing (no span
    objects, no wire field).
  - Finished spans land in a bounded per-process buffer drained by the
    CoreWorker's task-event flush (worker → head) into the head's trace
    store; overflow increments ``rt_trace_spans_dropped`` instead of
    growing without bound.

W3C trace-context interop: `parse_traceparent` / `format_traceparent`
implement the ``00-<trace>-<span>-<flags>`` header format so Serve's
HTTP ingress can continue traces started by external callers.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.config import config

KIND_INTERNAL = "INTERNAL"
KIND_CLIENT = "CLIENT"
KIND_SERVER = "SERVER"

_UNSET = object()  # distinguishes "no parent given" from "explicitly root"

_current: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("rt_trace_ctx", default=None)

_buf_lock = threading.Lock()
_buffer: List[Dict[str, Any]] = []
_counts = {"sampled": 0, "dropped": 0, "flushes": 0}
_pushed = {"sampled": 0, "dropped": 0, "flushes": 0}  # synced to Counters
_metrics = None
_metrics_lock = threading.Lock()

# config snapshot, refreshed on a short TTL: config attribute access
# costs ~3µs (env-var lookup per read) which is real money at 2+ reads
# per span on the submit hot path; a 0.2s-stale sampling ratio is
# invisible in practice (toggles take effect within one warm-up)
_cfg_cache = {"at": -1.0, "enabled": True, "ratio": 1.0, "buf": 4096}


def _cfg() -> Dict[str, Any]:
    now = time.monotonic()
    if now - _cfg_cache["at"] > 0.2:
        _cfg_cache["enabled"] = bool(config.tracing_enabled)
        _cfg_cache["ratio"] = float(config.trace_sampling_ratio)
        _cfg_cache["buf"] = int(config.trace_buffer_size)
        _cfg_cache["at"] = now
    return _cfg_cache


def _get_metrics():
    """Tracing self-metrics on the process's default registry (workers
    push it to their node agent; daemons expose it directly)."""
    global _metrics
    if _metrics is None:
        with _metrics_lock:
            if _metrics is None:
                from ray_tpu_torch._private.metrics import Counter

                _metrics = {
                    "sampled": Counter("rt_trace_spans_sampled",
                                       "spans recorded by this process"),
                    "dropped": Counter("rt_trace_spans_dropped",
                                       "spans lost to buffer overflow or "
                                       "flush failure"),
                    "flushes": Counter("rt_trace_flush_batches",
                                       "span batches flushed to the head"),
                }
    return _metrics


class SpanContext:
    """What propagates: ids + the sampling decision."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_wire(self) -> Dict[str, str]:
        return {"tid": self.trace_id, "sid": self.span_id}

    def __repr__(self):
        return f"SpanContext({self.trace_id[:8]}…/{self.span_id[:8]}…)"


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "start", "end_ts", "attributes", "status")

    def __init__(self, trace_id: str, span_id: str, parent_id: str,
                 name: str, kind: str,
                 attributes: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.start = time.time()
        self.end_ts = 0.0
        self.attributes = attributes
        self.status = ""  # "" = OK; else the error string

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, True)

    def set_attribute(self, key: str, value: Any) -> None:
        if self.attributes is None:
            self.attributes = {}
        self.attributes[key] = value

    def end(self, error: str = "") -> None:
        self.end_ts = time.time()
        if error:
            self.status = str(error)[:200]
        _record(self.to_wire())

    def to_wire(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "kind": self.kind, "start": self.start, "end": self.end_ts,
        }
        if self.status:
            d["status"] = self.status
        if self.attributes:
            d["attrs"] = self.attributes
        return d


# ------------------------------------------------------------------ ids


def new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{random.getrandbits(64):016x}"


# ------------------------------------------------------------- context


def current_context() -> Optional[SpanContext]:
    return _current.get()


def activate(ctx: Optional[SpanContext]):
    """Make `ctx` the active trace context on this thread/coroutine;
    returns a token for `restore`."""
    return _current.set(ctx)


def restore(token) -> None:
    _current.reset(token)


_NOT_SAMPLED = SpanContext("", "", sampled=False)


class suppressed:
    """Context manager marking this thread's work as never-sampled —
    for internal control loops (health probes, metrics pushes) whose
    submissions would otherwise mint a root trace every tick and churn
    real traces out of the bounded head store."""

    def __enter__(self):
        self._token = _current.set(_NOT_SAMPLED)
        return self

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


# wire marker for a NEGATIVE sampling decision: the executing worker
# must inherit "this tree is unsampled" or nested submissions would
# re-roll sampling mid-call-tree (minting partial orphan root traces)
_NS_WIRE = {"ns": 1}


def ctx_from_wire(d: Optional[Dict[str, Any]]) -> Optional[SpanContext]:
    """Inverse of the wire context: {"tid","sid"} for a sampled parent,
    {"ns":1} for a propagated not-sampled decision, None for untraced."""
    if not d:
        return None
    if d.get("ns"):
        return _NOT_SAMPLED
    tid, sid = d.get("tid"), d.get("sid")
    if not tid or not sid:
        return None
    return SpanContext(tid, sid, True)


def begin_submit(name: str, kind: str = KIND_CLIENT
                 ) -> tuple:
    """Span + wire context for a task/actor submission: returns
    (span | None, wire_ctx | None).  Unlike start_span, a negative
    decision (root sampled out, unsampled or suppressed parent) still
    yields the not-sampled wire marker so the whole downstream tree
    honors the decision made once at the root."""
    cfg = _cfg()
    if not cfg["enabled"]:
        return None, None
    parent = _current.get()
    if parent is None:
        if random.random() >= cfg["ratio"]:
            return None, _NS_WIRE
        span = Span(new_trace_id(), new_span_id(), "", name, kind)
        return span, span.context().to_wire()
    if not parent.sampled:
        return None, _NS_WIRE
    span = Span(parent.trace_id, new_span_id(), parent.span_id, name, kind)
    return span, span.context().to_wire()


# -------------------------------------------------------------- spans


def start_span(name: str, kind: str = KIND_INTERNAL, parent=_UNSET,
               attributes: Optional[Dict[str, Any]] = None
               ) -> Optional[Span]:
    """Open a span. Returns None when tracing is disabled or the trace
    is unsampled — callers treat None as "do nothing" so the unsampled
    hot path allocates nothing.

    parent: omitted → the active context; None → force a new root;
    a SpanContext → that parent (e.g. extracted from a traceparent
    header or a TaskSpec)."""
    cfg = _cfg()
    if not cfg["enabled"]:
        return None
    if parent is _UNSET:
        parent = _current.get()
    if parent is None:
        if random.random() >= cfg["ratio"]:
            return None
        trace_id, parent_id = new_trace_id(), ""
    else:
        if not parent.sampled:
            return None
        trace_id, parent_id = parent.trace_id, parent.span_id
    return Span(trace_id, new_span_id(), parent_id, name, kind, attributes)


def _record(wire_span: Dict[str, Any]) -> None:
    # hot path: buffer append + plain-int accounting only; the Counter
    # objects are synced from _counts on the drain cadence (~1/s)
    with _buf_lock:
        if len(_buffer) >= _cfg_cache["buf"]:
            _counts["dropped"] += 1
            return
        _buffer.append(wire_span)
        _counts["sampled"] += 1


def _sync_metrics() -> None:
    """Push accumulated counts into the registry Counters (cheap to do
    once per drain; too expensive per span on this hot path).  No-op
    until something was actually counted, so an untraced process never
    registers the counters (registering would flip has_samples() and
    start the worker→agent metrics push for nothing)."""
    with _buf_lock:
        deltas = {k: _counts[k] - _pushed[k] for k in _counts}
        if not any(deltas.values()):
            return
        _pushed.update(_counts)
    m = _get_metrics()
    for k, d in deltas.items():
        if d:
            m[k].inc(d)


def drain() -> List[Dict[str, Any]]:
    """Take every buffered span (called by the flush loop)."""
    global _buffer
    with _buf_lock:
        batch, _buffer = _buffer, []
    _sync_metrics()
    return batch


def count_flush() -> None:
    with _buf_lock:
        _counts["flushes"] += 1


def count_dropped(n: int) -> None:
    """Spans lost after drain (e.g. the flush RPC failed)."""
    with _buf_lock:
        _counts["dropped"] += n


def stats() -> Dict[str, int]:
    with _buf_lock:
        return dict(_counts, buffered=len(_buffer))


# ------------------------------------------------- head-side store


class TraceStore:
    """The head's bounded trace store: trace_id -> {spans, start, end,
    root}, insertion-ordered so the oldest traces fall off at the cap
    (the task-event store pattern applied to spans).

    Owned by the head's task-event ingest plane (head_shards.py): every
    method runs on that plane's loop, and cross-loop readers (dashboard
    HTTP, CLI RPCs) reach it via the plane's run_sync routing — the
    store itself needs no lock."""

    def __init__(self, max_traces: int, max_spans: int):
        self.traces: Dict[str, Dict[str, Any]] = {}
        self.max_traces = int(max_traces)
        self.max_spans = int(max_spans)
        self.spans_dropped = 0

    def ingest(self, spans: List[Dict[str, Any]]) -> None:
        for s in spans:
            trace_id = s.get("trace_id")
            if not trace_id:
                continue
            ent = self.traces.get(trace_id)
            if ent is None:
                while len(self.traces) >= self.max_traces:
                    self.traces.pop(next(iter(self.traces)))
                ent = self.traces[trace_id] = {
                    "trace_id": trace_id, "spans": [],
                    "start": s.get("start", 0.0), "end": 0.0, "root": "",
                }
            if len(ent["spans"]) >= self.max_spans:
                self.spans_dropped += 1
                continue
            ent["spans"].append(s)
            start = s.get("start") or 0.0
            if start and (not ent["start"] or start < ent["start"]):
                ent["start"] = start
            ent["end"] = max(ent["end"], s.get("end") or 0.0)
            if not s.get("parent_id"):
                ent["root"] = s.get("name", "")

    @staticmethod
    def _summary(ent: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "trace_id": ent["trace_id"],
            "num_spans": len(ent["spans"]),
            "root": ent.get("root", ""),
            "start": ent.get("start", 0.0),
            "end": ent.get("end", 0.0),
            "duration_s": max(0.0, (ent.get("end") or 0.0)
                              - (ent.get("start") or 0.0)),
        }

    def summaries(self, limit: int) -> List[Dict[str, Any]]:
        """Newest-first summaries (shared by the RPC, HTTP and dashboard
        surfaces so they can't drift apart)."""
        out = [self._summary(e)
               for e in reversed(list(self.traces.values()))]
        return out[:max(0, limit)]

    def detail(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Summary + start-sorted spans for one trace, or None."""
        ent = self.traces.get(trace_id)
        if ent is None:
            return None
        trace = self._summary(ent)
        trace["spans"] = sorted(ent["spans"],
                                key=lambda s: s.get("start", 0.0))
        return trace


# ------------------------------------------------- W3C trace-context


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-" \
           f"{'01' if ctx.sampled else '00'}"


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C ``traceparent`` header; malformed input returns None
    (the request proceeds untraced — never an error)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) \
            or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or span_id == "0" * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    sampled = bool(int(flags, 16) & 0x01)
    return SpanContext(trace_id, span_id, sampled)
