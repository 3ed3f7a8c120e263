"""Metrics: process-local registry + Prometheus text exposition.

Equivalent of the reference's stats layer
(reference: src/ray/stats/metric.h:102 — OpenCensus measures exported
through the node metrics agent to Prometheus endpoints;
src/ray/stats/metric_defs.cc for the core metric set;
python/ray/util/metrics.py for the user-facing API).

Design: every process owns one MetricsRegistry.  Daemons (head, node
agent) expose theirs over a minimal HTTP endpoint (`GET /metrics`);
workers push periodic snapshots to their node agent, which re-exports
them with worker labels — one scrape target per node, like the
reference's reporter agent (dashboard/modules/reporter/reporter_agent.py).
"""

from __future__ import annotations

import asyncio
import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(tags: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((tags or {}).items()))


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 registry: Optional["MetricsRegistry"] = None):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._registry = registry or default_registry
        self._registry.register(self)

    def _tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        base = self._registry.default_tags
        return {**base, **(tags or {})} if base else (tags or {})

    def render(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, description="", registry=None):
        super().__init__(name, description, registry)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        key = _labelkey(self._tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def render(self) -> List[str]:
        with self._lock:
            items = list(self._values.items())
        out = [f"# HELP {self.name} {self.description}",
               f"# TYPE {self.name} counter"]
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, description="", registry=None):
        super().__init__(name, description, registry)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[_labelkey(self._tags(tags))] = float(value)

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        key = _labelkey(self._tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        self.inc(-value, tags)

    def render(self) -> List[str]:
        with self._lock:
            items = list(self._values.items())
        out = [f"# HELP {self.name} {self.description}",
               f"# TYPE {self.name} gauge"]
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    DEFAULT_BOUNDARIES = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60]

    def __init__(self, name, description="", boundaries=None, registry=None):
        super().__init__(name, description, registry)
        self.boundaries = list(boundaries or self.DEFAULT_BOUNDARIES)
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _labelkey(self._tags(tags))
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def render(self) -> List[str]:
        with self._lock:
            items = [(k, list(c), self._sums.get(k, 0.0))
                     for k, c in self._counts.items()]
        out = [f"# HELP {self.name} {self.description}",
               f"# TYPE {self.name} histogram"]
        for key, counts, total in items:
            cum = 0
            for b, c in zip(self.boundaries, counts):
                cum += c
                lk = key + (("le", str(b)),)
                out.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            cum += counts[-1]
            lk = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {cum}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} {total}")
        return out


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # foreign snapshots re-exported verbatim (worker pushes)
        self._foreign: Dict[str, Tuple[str, float]] = {}
        self.foreign_ttl_s = 30.0
        # merged into every sample's tags (e.g. worker_id) so pushed
        # snapshots from many workers don't collide on one endpoint
        self.default_tags: Dict[str, str] = {}
        self._collectors: List[Any] = []  # callables run before render

    def register(self, metric: _Metric) -> None:
        with self._lock:
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, fn) -> None:
        """fn() runs right before each render — the place to sample
        gauges from live state (store occupancy, queue depths)."""
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        """Deregister a collector.  Hosts with a shorter lifetime than
        the process (CoreWorker across init/shutdown cycles, restarted
        serve proxies) MUST remove their collectors — the registry is a
        process singleton, so a leaked closure pins its whole object
        graph and re-runs on every render forever."""
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def ingest_foreign(self, source: str, text: str) -> None:
        """Store a pushed snapshot (e.g. from a worker) for re-export."""
        with self._lock:
            self._foreign[source] = (text, time.monotonic())

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass
        with self._lock:
            metrics = list(self._metrics.values())
            now = time.monotonic()
            self._foreign = {s: (t, ts) for s, (t, ts) in
                             self._foreign.items()
                             if now - ts < self.foreign_ttl_s}
            foreign = [t for t, _ in self._foreign.values()]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        for text in foreign:
            lines.extend(text.splitlines())
        return "\n".join(_merge_families(lines)) + "\n"

    def has_samples(self) -> bool:
        with self._lock:
            return bool(self._metrics)

    def foreign_sample_sum(self, name: str) -> Optional[float]:
        """Sum a gauge/counter family's sample values across the pushed
        worker snapshots (None when no pusher reports it).  Cheap line
        scan over the cached exposition texts — how the node agent folds
        worker-process signals (the LLM replica's queue depth and
        tokens-per-step) into its heartbeat gauge summary without a
        side-channel RPC."""
        with self._lock:
            now = time.monotonic()
            texts = [t for t, ts in self._foreign.values()
                     if now - ts < self.foreign_ttl_s]
        total, found = 0.0, False
        for text in texts:
            for ln in text.splitlines():
                if not ln.startswith(name) or ln.startswith("#"):
                    continue
                rest = ln[len(name):]
                if rest[:1] not in ("{", " "):
                    continue  # longer name sharing the prefix
                try:
                    total += float(ln.rsplit(" ", 1)[1])
                    found = True
                except (ValueError, IndexError):
                    pass
        return total if found else None


def _merge_families(lines: List[str]) -> List[str]:
    """Merge exposition lines from several sources into one valid text
    exposition: exactly one HELP/TYPE header per metric family, with all
    of a family's samples contiguous under it.  Needed because every
    worker pushes a snapshot carrying its own headers — Prometheus
    rejects duplicate TYPE lines and interleaved families."""
    order: List[str] = []  # family names in first-seen order
    families: Dict[str, Dict[str, Any]] = {}
    suffix_of: Dict[str, str] = {}  # histogram child name -> family

    def fam(name: str) -> Dict[str, Any]:
        base = suffix_of.get(name, name)
        f = families.get(base)
        if f is None:
            f = families[base] = {"help": None, "type": None, "samples": []}
            order.append(base)
        return f

    for ln in lines:
        if not ln:
            continue
        if ln.startswith("# "):
            parts = ln.split(None, 3)
            if len(parts) < 3:
                continue
            kind, name = parts[1], parts[2]
            f = fam(name)
            if kind == "HELP" and f["help"] is None:
                f["help"] = ln
            elif kind == "TYPE" and f["type"] is None:
                f["type"] = ln
                if len(parts) > 3 and parts[3].startswith("histogram"):
                    for suffix in ("_bucket", "_count", "_sum"):
                        suffix_of[name + suffix] = name
            continue
        name = ln.split("{", 1)[0].split(" ", 1)[0]
        fam(name)["samples"].append(ln)

    out: List[str] = []
    for base in order:
        f = families[base]
        if f["help"]:
            out.append(f["help"])
        if f["type"]:
            out.append(f["type"])
        out.extend(f["samples"])
    return out


default_registry = MetricsRegistry()

_xfer_metrics: Optional[Tuple[Counter, Histogram]] = None


def object_transfer_metrics() -> Tuple[Counter, Histogram]:
    """Process-singleton bulk-transfer metrics, observed on the PULLING
    node agent once per completed cross-node object transfer:
    ``ray_tpu_object_transfer_bytes_total`` (labeled by plane=bulk|rpc
    and direction=in) and ``ray_tpu_object_transfer_seconds`` (wall time
    per transfer, same labels) — throughput is bytes_total/seconds_sum
    per plane.  Lives here so the agent's registry exports them on the
    standard per-node Prometheus endpoint."""
    global _xfer_metrics
    if _xfer_metrics is None:
        _xfer_metrics = (
            Counter("ray_tpu_object_transfer_bytes_total",
                    "bytes moved between node object stores"),
            Histogram("ray_tpu_object_transfer_seconds",
                      "wall time of one cross-node object transfer",
                      boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                                  0.25, 0.5, 1, 2.5, 5, 10, 30, 60]),
        )
    return _xfer_metrics


_dag_metrics: Optional[Tuple[Histogram, Counter]] = None


def dag_metrics() -> Tuple[Histogram, Counter]:
    """Process-singleton compiled-DAG metrics (dag/execution.py +
    dag/channel.py): ``ray_tpu_dag_execute_latency_seconds`` — wall
    time from ``CompiledGraph.execute()`` to the result landing in
    ``CompiledDAGRef.get()``, observed driver-side — and
    ``ray_tpu_dag_channel_ops_total`` — channel version reads/writes
    plus executes, labeled by op=read|write|execute.  Drivers and actor
    workers each export through the standard worker→node-agent push."""
    global _dag_metrics
    if _dag_metrics is None:
        _dag_metrics = (
            Histogram("ray_tpu_dag_execute_latency_seconds",
                      "compiled-DAG execute-to-result latency",
                      boundaries=[0.0002, 0.0005, 0.001, 0.0025, 0.005,
                                  0.01, 0.025, 0.05, 0.1, 0.25, 1, 5, 30]),
            Counter("ray_tpu_dag_channel_ops_total",
                    "compiled-DAG channel version operations"),
        )
    return _dag_metrics


_loop_lag_gauge: Optional[Gauge] = None


def loop_lag_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_event_loop_lag_seconds``: scheduling
    lag of the process's event loop(s), sampled by the always-on
    profiling.loop_lag_probe and labeled by role (head | agent | driver
    | worker | serve_proxy).  The first gauge to read when something
    feels wedged — a loop hogged by a long callback lags here seconds
    before RPCs time out."""
    global _loop_lag_gauge
    if _loop_lag_gauge is None:
        _loop_lag_gauge = Gauge(
            "ray_tpu_event_loop_lag_seconds",
            "event-loop scheduling lag measured by the liveness probe")
    return _loop_lag_gauge


_pump_depth_gauge: Optional[Gauge] = None


def dispatch_pump_depth_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_dispatch_pump_depth``: tasks sitting
    in this owner's dispatch pump (pending per-class + per-actor queues,
    not yet pushed to a leased worker) — sampled by a collector at
    scrape/push time.  Rising depth with idle cluster CPU is the
    signature of owner-side dispatch being the bottleneck (ROADMAP open
    item 3)."""
    global _pump_depth_gauge
    if _pump_depth_gauge is None:
        _pump_depth_gauge = Gauge(
            "ray_tpu_dispatch_pump_depth",
            "owner-side tasks queued in the dispatch pump")
    return _pump_depth_gauge


_dag_occupancy_gauge: Optional[Gauge] = None


def dag_channel_occupancy_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_dag_channel_occupancy``: versions in
    flight in a compiled-DAG channel ring (writer seq minus the slowest
    reader's cursor), labeled by channel oid prefix.  Occupancy pinned
    at max_in_flight marks the pipeline stage readers can't keep up
    with — the pipeline-bubble signal the MPMD work needs."""
    global _dag_occupancy_gauge
    if _dag_occupancy_gauge is None:
        _dag_occupancy_gauge = Gauge(
            "ray_tpu_dag_channel_occupancy",
            "compiled-DAG channel ring versions in flight")
    return _dag_occupancy_gauge


_serve_inflight_gauge: Optional[Gauge] = None


def serve_proxy_inflight_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_serve_proxy_inflight``: requests
    currently admitted past the Serve proxy's shed gate (serve/http.py),
    sampled by a collector at scrape time.  Tracks how close the proxy
    runs to ``serve_max_inflight_requests``."""
    global _serve_inflight_gauge
    if _serve_inflight_gauge is None:
        _serve_inflight_gauge = Gauge(
            "ray_tpu_serve_proxy_inflight",
            "serve HTTP requests currently in flight past the shed gate")
    return _serve_inflight_gauge


_task_event_dropped: Optional[Counter] = None


def task_events_dropped_counter() -> Counter:
    """Process-singleton ``ray_tpu_task_events_dropped_total``: task
    state-transition records discarded before reaching the head's
    store, labeled ``shard`` with WHERE the loss happened —
    ``shard=owner`` for owner-side buffer overflow
    (``task_events_buffer_size`` before a flush could drain it),
    ``shard=task_events`` for head ingest-inbox overflow
    (``head_inbox_max_frames``).  A nonzero rate means the
    observability plane is lossy — raise the relevant bound or
    investigate a wedged flush/shard; the drop itself is deliberate
    (events must never backpressure the submit hot path)."""
    global _task_event_dropped
    if _task_event_dropped is None:
        _task_event_dropped = Counter(
            "ray_tpu_task_events_dropped_total",
            "task events dropped on buffer or ingest-inbox overflow")
    return _task_event_dropped


_head_inbox_depth: Optional[Gauge] = None


def head_inbox_depth_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_head_inbox_depth``: high-water mark
    of a head ingest shard's inbound queue over the last drain window,
    labeled ``shard`` (``task_events`` = event frames queued before the
    per-tick merge; ``telemetry`` = heartbeat updates queued toward the
    scheduling core).  The saturation early-warning: depth climbing
    toward ``head_inbox_max_frames`` means drops are imminent while
    ``ray_tpu_event_loop_lag_seconds{role=head_shard}`` shows which
    plane is too slow."""
    global _head_inbox_depth
    if _head_inbox_depth is None:
        _head_inbox_depth = Gauge(
            "ray_tpu_head_inbox_depth",
            "head ingest shard inbound-queue high-water mark")
    return _head_inbox_depth


_dispatch_batch_hist: Optional[Histogram] = None


def dispatch_batch_size_histogram() -> Histogram:
    """Process-singleton ``ray_tpu_dispatch_batch_size``: tasks carried
    per owner→worker push frame (1 = the unbatched direct call).  The
    companion gauge to ``ray_tpu_dispatch_pump_depth`` when hunting a
    tasks/s plateau: high pump depth with batch size pinned at 1 means
    the pump is fragmenting — frames, not payload bytes, cap small-task
    throughput."""
    global _dispatch_batch_hist
    if _dispatch_batch_hist is None:
        _dispatch_batch_hist = Histogram(
            "ray_tpu_dispatch_batch_size",
            "tasks per owner-side push_tasks frame",
            boundaries=[1, 2, 4, 8, 16, 32, 64])
    return _dispatch_batch_hist


_pipeline_metrics: Optional[Tuple[Gauge, Counter]] = None


def pipeline_metrics() -> Tuple[Gauge, Counter]:
    """Process-singleton MPMD pipeline instrumentation (driver-side,
    set from per-stage loop reports each optimizer step):
    ``ray_tpu_pipeline_bubble_pct`` — idle share of the step window,
    labeled stage=<i> (that stage's idle %) plus stage=all (the whole
    pipeline's bubble: 1 - Σbusy / (S·wall));
    ``ray_tpu_pipeline_stage_busy_seconds_total`` — cumulative stage
    compute seconds labeled stage + phase=fwd|bwd|opt (bwd includes the
    recompute-forward)."""
    global _pipeline_metrics
    if _pipeline_metrics is None:
        _pipeline_metrics = (
            Gauge("ray_tpu_pipeline_bubble_pct",
                  "pipeline idle percentage per stage and overall"),
            Counter("ray_tpu_pipeline_stage_busy_seconds_total",
                    "cumulative pipeline stage compute seconds by phase"),
        )
    return _pipeline_metrics


_ft_metrics: Optional[Tuple[Counter, Counter, Counter]] = None


def fault_tolerance_metrics() -> Tuple[Counter, Counter, Counter]:
    """Process-singleton fault-tolerance counters:
    ``ray_tpu_actor_restarts_total`` — head-side, one per ALIVE→
    RESTARTING transition (an actor worker/node died with restart budget
    left); ``ray_tpu_object_reconstructions_total`` — owner-side lineage
    reconstruction outcomes, labeled outcome=ok|failed (failed = the
    object is permanently lost after the retry budget); and
    ``ray_tpu_chaos_injections_total`` — one per fault-injection rule
    firing, labeled by site (fault_injection.py)."""
    global _ft_metrics
    if _ft_metrics is None:
        _ft_metrics = (
            Counter("ray_tpu_actor_restarts_total",
                    "actor restarts begun after a worker/node death"),
            Counter("ray_tpu_object_reconstructions_total",
                    "lineage reconstructions of lost objects by outcome"),
            Counter("ray_tpu_chaos_injections_total",
                    "chaos fault-injection rule firings by site"),
        )
    return _ft_metrics


_leaked_bytes_gauge: Optional[Gauge] = None


def object_leaked_bytes_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_object_leaked_bytes``: bytes the
    head's periodic memory scan attributes to leaks, labeled by
    kind=dead_owner|borrowed_ttl|channel_slot (head.py leak tripwires).
    Set on every complete scan, so it returns to 0 once the leak is
    cleaned up.  Alert on dead_owner/channel_slot staying nonzero —
    those are definite leaks.  borrowed_ttl is a SUSPICION signal: a
    borrow older than the TTL is indistinguishable from an actor
    legitimately caching refs for the job's lifetime, so long-running
    workloads keep it nonzero by design (tune object_leak_ttl_s to
    your hold patterns before paging on it)."""
    global _leaked_bytes_gauge
    if _leaked_bytes_gauge is None:
        _leaked_bytes_gauge = Gauge(
            "ray_tpu_object_leaked_bytes",
            "object-store bytes flagged as leaked by the head memory scan")
    return _leaked_bytes_gauge


_scan_partial_gauge: Optional[Gauge] = None


def memory_scan_partial_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_memory_scan_partial``: 1 while the
    head's leak scan sees a partial ownership join (unreachable owner,
    truncated table, gapped driver) — leak values hold their last
    complete reading during that time, so a frozen
    ``ray_tpu_object_leaked_bytes`` is only trustworthy when this is
    0.  Alert on it staying 1."""
    global _scan_partial_gauge
    if _scan_partial_gauge is None:
        _scan_partial_gauge = Gauge(
            "ray_tpu_memory_scan_partial",
            "1 while the head memory scan's ownership join is partial "
            "(leak detection suspended, gauges hold last complete values)")
    return _scan_partial_gauge


_store_breakdown_gauge: Optional[Gauge] = None


def object_store_breakdown_gauge() -> Gauge:
    """Process-singleton ``ray_tpu_object_store_bytes``: the node
    store's byte breakdown, labeled by kind=arena_used|arena_free|
    pinned|spilled|channel|mmap_cache — sampled by an agent collector at
    scrape time from StoreCore.byte_breakdown().  The per-node half of
    `rtpu memory`, exported so dashboards can graph who owns the arena
    without polling the state API."""
    global _store_breakdown_gauge
    if _store_breakdown_gauge is None:
        _store_breakdown_gauge = Gauge(
            "ray_tpu_object_store_bytes",
            "node object-store bytes by kind (arena/pinned/spilled/...)")
    return _store_breakdown_gauge


_memory_pressure_metrics = None


def memory_pressure_metrics() -> Tuple[Counter, Gauge, Gauge]:
    """Process-singleton memory-pressure resilience families (see
    _private/memory_monitor.py + node_agent watchdog + head.py
    quarantine): ``ray_tpu_oom_kills_total`` — agent-side, one per
    watchdog kill, labeled reason=node_pressure|chaos;
    ``ray_tpu_node_memory_pressure`` — the agent's sampled node memory
    usage fraction (the watchdog's own gauge, also gossiped on
    heartbeats for pressure-aware scheduling); and
    ``ray_tpu_quarantined_tasks`` — head-side, the number of task/actor
    classes currently quarantined as poison (fail-fast with
    PoisonedTaskError instead of worker churn)."""
    global _memory_pressure_metrics
    if _memory_pressure_metrics is None:
        _memory_pressure_metrics = (
            Counter("ray_tpu_oom_kills_total",
                    "workers deliberately killed by the node memory "
                    "watchdog, by reason"),
            Gauge("ray_tpu_node_memory_pressure",
                  "sampled node memory usage fraction (watchdog input)"),
            Gauge("ray_tpu_quarantined_tasks",
                  "task/actor classes currently poison-quarantined"),
        )
    return _memory_pressure_metrics


_checksum_failures_counter: Optional[Counter] = None


def object_checksum_failures_counter() -> Counter:
    """Process-singleton ``ray_tpu_object_checksum_failures_total``:
    bulk-pull payloads whose CRC32 did not match the holder's seal-time
    checksum — the pull quarantines that copy (the holder re-verifies
    and drops a genuinely-corrupt secondary) and retries from an
    alternate holder, so a nonzero rate means corruption is being
    CAUGHT, not served."""
    global _checksum_failures_counter
    if _checksum_failures_counter is None:
        _checksum_failures_counter = Counter(
            "ray_tpu_object_checksum_failures_total",
            "object pulls whose payload failed CRC32 verification")
    return _checksum_failures_counter


_autoscaler_metrics = None


def autoscaler_metrics() -> Tuple[Gauge, Counter, Histogram]:
    """Process-singleton autoscaler families (head-side; see
    _private/head.py drain state machine + autoscaler/autoscaler.py):
    ``ray_tpu_autoscaler_nodes`` — node counts by
    state=running|draining|pending_launch (pending_launch comes from the
    autoscaler's status report, the rest from the head node table);
    ``ray_tpu_autoscaler_scale_events_total`` — scale decisions acted
    on, labeled kind=up|down; ``ray_tpu_autoscaler_drain_seconds`` —
    wall time of each graceful drain (lease quiesce + actor migration +
    object re-replication), the latency cost of a scale-down."""
    global _autoscaler_metrics
    if _autoscaler_metrics is None:
        _autoscaler_metrics = (
            Gauge("ray_tpu_autoscaler_nodes",
                  "autoscaler node view by state "
                  "(running|draining|pending_launch)"),
            Counter("ray_tpu_autoscaler_scale_events_total",
                    "autoscaler scale decisions acted on, by kind=up|down"),
            Histogram("ray_tpu_autoscaler_drain_seconds",
                      "graceful node drain duration",
                      boundaries=[0.1, 0.5, 1, 2, 5, 10, 30, 60, 120]),
        )
    return _autoscaler_metrics


_serve_sheds_counter: Optional[Counter] = None


def serve_sheds_counter() -> Counter:
    """Process-singleton ``ray_tpu_serve_sheds_total``: requests turned
    away with 503, labeled reason=proxy (the proxy-wide inflight gate)
    or reason=replica (replica-side admission shed, e.g. an LLM
    engine's full admission queue).  A rising rate is the serve
    autoscaler's SLO-pressure signal — replicas (and, transitively,
    nodes) should be scaling up while this climbs."""
    global _serve_sheds_counter
    if _serve_sheds_counter is None:
        _serve_sheds_counter = Counter(
            "ray_tpu_serve_sheds_total",
            "serve requests shed with 503, by reason=proxy|replica")
    return _serve_sheds_counter


_deadline_counter: Optional[Counter] = None


def deadline_metrics() -> Counter:
    """Process-singleton ``ray_tpu_deadline_exceeded_total``: requests
    /tasks failed because their end-to-end deadline expired, labeled by
    enforcement site — where=queued (failed fast without dispatching:
    owner pump, agent lease queue, or worker task queue), running (the
    owner's deadline sweep cancelled an in-flight task), get (a
    ``get()`` bounded by the ambient budget ran out), admission (the
    LLM engine refused a sequence whose remaining budget cannot cover
    prefill + one decode step).  A rising queued share means work is
    arriving already-doomed — shed earlier; a rising running share
    means budgets are too tight for the service time."""
    global _deadline_counter
    if _deadline_counter is None:
        _deadline_counter = Counter(
            "ray_tpu_deadline_exceeded_total",
            "deadline expiries by enforcement site "
            "(queued|running|get|admission)")
    return _deadline_counter


_serve_tail_metrics: Optional[Tuple[Counter, Counter]] = None


def serve_tail_metrics() -> Tuple[Counter, Counter]:
    """Process-singleton Serve tail-tolerance counters (serve/api.py):
    ``ray_tpu_serve_hedges_total`` — hedged duplicate requests fired
    against a second replica, labeled outcome=won (the hedge's response
    was used; the primary was slow) or lost (the primary finished
    first; the hedge was cancelled).  A high won share marks a gray
    replica the circuit breaker should be evicting.
    ``ray_tpu_serve_circuit_open_total`` — per-replica circuit-breaker
    open transitions (a replica's windowed error/slow score crossed the
    threshold and it was removed from routing until a half-open probe
    re-admits it), labeled by deployment."""
    global _serve_tail_metrics
    if _serve_tail_metrics is None:
        _serve_tail_metrics = (
            Counter("ray_tpu_serve_hedges_total",
                    "hedged serve requests by outcome (won|lost)"),
            Counter("ray_tpu_serve_circuit_open_total",
                    "per-replica circuit breaker open transitions"),
        )
    return _serve_tail_metrics


_serve_request_latency: Optional[Histogram] = None


def serve_request_latency_histogram() -> Histogram:
    """Process-singleton ``ray_tpu_serve_request_latency_seconds``:
    proxy-side ingress latency, observed once per routed HTTP request in
    serve/http.py (socket-in to response-ready, labeled by status code).
    Lives here so the proxy actor's registry exports it through the
    standard worker->node-agent push path."""
    global _serve_request_latency
    if _serve_request_latency is None:
        _serve_request_latency = Histogram(
            "ray_tpu_serve_request_latency_seconds",
            "serve HTTP ingress request latency (proxy-side)",
            boundaries=[0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1, 2.5, 5, 10, 60])
    return _serve_request_latency


_llm_metrics: Optional[Tuple[Counter, Gauge, Gauge, Histogram,
                             Gauge, Gauge, Histogram]] = None


def llm_metrics() -> Tuple[Counter, Gauge, Gauge, Histogram, Gauge, Gauge,
                           Histogram]:
    """Process-singleton LLM serving-tier metrics (serve/llm.py, set by
    the replica engine each decode step):
    ``ray_tpu_llm_tokens_total`` — tokens processed, labeled
    phase=prefill|decode (decode rate IS the serving throughput);
    ``ray_tpu_llm_kv_pages`` — paged KV-cache pages by state=used|free
    (used pinned at capacity + queue depth rising = scale out);
    ``ray_tpu_llm_batch_size`` — decode lanes in the last engine step;
    ``ray_tpu_llm_ttft_seconds`` — submit-to-first-token latency
    (admission queueing + chunked prefill, the serving SLO histogram);
    ``ray_tpu_llm_queue_depth`` — sequences waiting in the admission
    queue; ``ray_tpu_llm_tokens_per_step`` — tokens the last engine
    step processed (prefill chunk + decode lanes);
    ``ray_tpu_llm_decode_step_seconds`` — wall time of one decode
    forward over the batch (the paged-attention kernel's target: step
    time should track USED context, not max context).  The queue/step
    gauges also ride the agent heartbeat into the head time-series ring
    (``rtpu status --watch`` serving-pressure pane)."""
    global _llm_metrics
    if _llm_metrics is None:
        _llm_metrics = (
            Counter("ray_tpu_llm_tokens_total",
                    "LLM tokens processed by phase (prefill|decode)"),
            Gauge("ray_tpu_llm_kv_pages",
                  "paged KV-cache pages by state (used|free)"),
            Gauge("ray_tpu_llm_batch_size",
                  "decode lanes in the last continuous-batching step"),
            Histogram("ray_tpu_llm_ttft_seconds",
                      "LLM time-to-first-token (submit to first emit)",
                      boundaries=[0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                                  0.5, 1, 2.5, 5, 10, 30]),
            Gauge("ray_tpu_llm_queue_depth",
                  "sequences waiting in the LLM admission queue"),
            Gauge("ray_tpu_llm_tokens_per_step",
                  "tokens processed by the last LLM engine step"),
            Histogram("ray_tpu_llm_decode_step_seconds",
                      "wall time of one batched LLM decode forward",
                      boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01,
                                  0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5]),
        )
    return _llm_metrics


_llm_prefix_metrics: Optional[Tuple[Counter, Counter]] = None


def llm_prefix_metrics() -> Tuple[Counter, Counter]:
    """Process-singleton prefix-sharing / disaggregated-prefill metrics
    (serve/llm.py):
    ``ray_tpu_llm_prefix_hits_total`` — admissions that attached at
    least one shared KV page from the refcounted prefix index, labeled
    kind=page|cow (cow = a mid-page divergence that copy-on-write split
    into a private page); ``ray_tpu_llm_kv_pages_shipped_total`` — KV
    pages exported by prefill replicas / imported by decode replicas
    over the bulk transfer plane, labeled direction=out|in.  The
    shared-page population itself rides the existing
    ``ray_tpu_llm_kv_pages`` gauge as state=shared."""
    global _llm_prefix_metrics
    if _llm_prefix_metrics is None:
        _llm_prefix_metrics = (
            Counter("ray_tpu_llm_prefix_hits_total",
                    "LLM admissions that attached shared prefix KV pages "
                    "(kind=page|cow)"),
            Counter("ray_tpu_llm_kv_pages_shipped_total",
                    "KV pages shipped between prefill and decode "
                    "replicas (direction=out|in)"),
        )
    return _llm_prefix_metrics


async def start_metrics_http_server(registry: MetricsRegistry,
                                    host: str = "127.0.0.1",
                                    port: int = 0,
                                    extra_routes=None
                                    ) -> Tuple[asyncio.AbstractServer, int]:
    """Minimal HTTP/1.0 exposition endpoint: `GET /metrics`, plus any
    ``extra_routes`` ({path: () -> (content_type, bytes)}) — the head
    mounts its dashboard page here.  A route key ENDING in "/" is a
    prefix route: its handler is called with the remaining path suffix
    (e.g. "/api/traces/" serves /api/traces/<trace_id>).  A handler
    carrying a truthy ``wants_query`` attribute additionally receives
    the raw query string as its last positional argument, and a handler
    returning a coroutine is awaited on the serving loop (the head's
    /api/stack and /api/profile fan out over RPC).

    Handcrafted on asyncio (no aiohttp in the image); Prometheus needs
    nothing beyond status line + content-type + body."""
    extra_routes = extra_routes or {}

    def _match(path: str):
        """Exact route → (handler, None); prefix route → (handler,
        suffix); no match → (None, None)."""
        h = extra_routes.get(path)
        if h is not None:
            return h, None
        for key, fn in extra_routes.items():
            if len(key) > 1 and key.endswith("/") \
                    and path.startswith(key) and len(path) > len(key):
                return fn, path[len(key):]
        return None, None

    async def handle(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10.0)
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), timeout=10.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request.decode("latin-1").split()
            raw_path = parts[1] if len(parts) >= 2 else "/"
            path, _, query = raw_path.partition("?")
            ctype = b"text/plain; version=0.0.4"
            route, suffix = _match(path)
            if route is not None:
                try:
                    args = [] if suffix is None else [suffix]
                    if getattr(route, "wants_query", False):
                        args.append(query)
                    res = route(*args)
                    if asyncio.iscoroutine(res):
                        res = await res
                    ct, body = res
                    ctype = ct.encode()
                    status = b"200 OK"
                except Exception as e:  # route bug must not kill serving
                    body = f"error: {e}\n".encode()
                    status = b"500 Internal Server Error"
            elif path in ("/metrics", "/"):
                body = registry.render().encode()
                status = b"200 OK"
            else:
                body = b"not found\n"
                status = b"404 Not Found"
            writer.write(b"HTTP/1.0 " + status +
                         b"\r\nContent-Type: " + ctype +
                         b"\r\nContent-Length: " + str(len(body)).encode() +
                         b"\r\n\r\n" + body)
            await writer.drain()
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(handle, host, port)
    bound = server.sockets[0].getsockname()[1]
    return server, bound
