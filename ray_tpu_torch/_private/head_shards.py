"""Head control-plane ingest shards (multi-loop head, ISSUE 18).

Every control-plane message in the cluster used to funnel through the
single head event loop: task-event frames, heartbeats carrying
object-directory deltas and gauge summaries, trace spans, dashboard
polls, autoscaler snapshots — all interleaved with the latency-critical
scheduling work (actor/PG state machines, lease placement).  ROADMAP
item 2 measured the result: 6.8% multi-client scaling efficiency at 8
drivers, with the head loop as the structural ceiling.

This module splits the head into a scheduling core plus independent
*ingest shards*, each on its own event-loop thread (the pattern from
"Exploring the limits of Concurrency in ML Training on Google TPUs",
arxiv 2011.03641: keep the latency-critical decision path on one
thread, push everything that only observes cluster state onto parallel
ingest planes):

  - ``TaskEventPlane`` owns the task-event inbox + store, the
    sched-latency histogram feed, and the trace-span store.  The rpc
    surface (``task_events``, ``trace_spans``, ``list_tasks``,
    ``list_traces``, ``get_trace``) dispatches onto its loop directly
    (rpc.py per-op loop routing), so a 10k-task burst's event merge
    never steals a cycle from scheduling.
  - ``TelemetryPlane`` owns heartbeat ingest: object-directory delta
    application (the PR-8 sharded directory is already lock-per-shard
    and safe to write from this thread), the gauge-summary time-series
    ring, and pressure/chaos-version bookkeeping.  It assembles the
    heartbeat reply from a *membership snapshot* the scheduling core
    publishes (versioned, lock-free read) and forwards the per-node
    state the core does need (availability, pending demands, heartbeat
    liveness) over a single-producer queue drained once per core tick.

Consistency model (the PR-8 ``DirectoryMirror`` epoch/version handshake
generalized):

  - core -> shards: ``VersionedSnapshot`` — the publisher swaps an
    immutable (version, payload) cell; readers on any thread see either
    the old or the new snapshot, never a torn one.  Staleness is
    bounded by one publish (membership changes republish synchronously
    with the mutation).
  - shards -> core: ``CrossShardQueue`` — producers append under a
    lock, the consumer loop drains the whole backlog in ONE scheduled
    callback per tick (the head-side half of event batching, applied to
    cross-thread writes).  Entry updates land within one core tick.

``head_ingest_shards=0`` (config) is the single-loop compat mode: the
planes still exist and run the same code, but on the head's own loop —
one code path, two deployment shapes.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import config

__all__ = ["VersionedSnapshot", "CrossShardQueue", "IngestShard",
           "HeadShards", "TaskEventPlane", "TelemetryPlane"]


class VersionedSnapshot:
    """Single-writer published snapshot with a monotonic version.

    ``publish`` swaps one (version, payload) tuple; ``read`` returns it.
    Both are single attribute operations — atomic under the GIL, so a
    reader on a foreign thread sees a consistent pair without a lock
    (the DirectoryMirror version-handshake pattern, minus the wire).

    The version seed is the wall clock in nanoseconds: a publisher that
    restarts (head restart rebuilding its snapshots) seeds ABOVE every
    version the old incarnation could have published, so downstream
    "only apply newer" guards stay correct across the boundary without
    persisting a counter.
    """

    __slots__ = ("_cell",)

    def __init__(self, payload: Any = None,
                 start_version: Optional[int] = None):
        v0 = int(time.time_ns() if start_version is None else start_version)
        self._cell: Tuple[int, Any] = (v0, payload)

    def publish(self, payload: Any) -> int:
        version = self._cell[0] + 1
        self._cell = (version, payload)
        return version

    def read(self) -> Tuple[int, Any]:
        return self._cell

    @property
    def version(self) -> int:
        return self._cell[0]

    @property
    def payload(self) -> Any:
        return self._cell[1]


class CrossShardQueue:
    """Single-producer-per-shard queue drained once per consumer tick.

    Producers (shard loops) append under a lock and schedule AT MOST one
    drain callback on the consumer loop; the callback sweeps the whole
    backlog, so a heartbeat burst from 100 agents costs the scheduling
    core one callback, not 100.  ``high_water`` tracks the deepest
    backlog since the last ``take_high_water`` — exported as
    ``ray_tpu_head_inbox_depth{shard=...}`` so ingest saturation is
    visible before anything is dropped.
    """

    def __init__(self, consumer_loop: asyncio.AbstractEventLoop,
                 drain_cb: Callable[[List[Any]], None], name: str = ""):
        self.name = name
        self._loop = consumer_loop
        self._drain_cb = drain_cb
        self._lock = threading.Lock()
        self._items: List[Any] = []
        self._scheduled = False
        self._high_water = 0

    def put(self, item: Any) -> None:
        with self._lock:
            self._items.append(item)
            depth = len(self._items)
            if depth > self._high_water:
                self._high_water = depth
            if self._scheduled:
                return
            self._scheduled = True
        try:
            self._loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            # consumer loop closed (head shutting down): drop silently
            with self._lock:
                self._scheduled = False

    def _drain(self) -> None:
        with self._lock:
            items, self._items = self._items, []
            self._scheduled = False
        if not items:
            return
        try:
            self._drain_cb(items)
        except Exception:
            import traceback

            traceback.print_exc()

    def take_high_water(self) -> int:
        with self._lock:
            hw, self._high_water = self._high_water, len(self._items)
        return hw


class IngestShard:
    """One ingest plane: a dedicated event-loop thread plus its own
    loop-lag probe (``ray_tpu_event_loop_lag_seconds{role=head_shard,
    shard=<name>}``) so `rtpu status --watch` shows WHICH plane is hot.

    In single-loop compat mode the shard wraps the head's own loop
    (``own_thread=False``): same API, no thread, no extra probe — the
    head's existing role=head probe already covers it.
    """

    def __init__(self, name: str,
                 loop: Optional[asyncio.AbstractEventLoop] = None,
                 loop_thread: Optional[Any] = None):
        from ray_tpu_torch._private.rpc import EventLoopThread

        self.name = name
        if loop is not None:
            self._elt = None
            self.loop = loop
            self.own_thread = False
        else:
            self._elt = loop_thread or EventLoopThread(
                name=f"rt-head-{name}")
            self.loop = self._elt.loop
            self.own_thread = loop_thread is None
        self.loop_lag = 0.0
        self._probe: Optional[Any] = None

    def start_lag_probe(self) -> None:
        if self._elt is None:
            return

        from ray_tpu_torch._private.profiling import loop_lag_probe

        def _lag(sample: float) -> None:
            self.loop_lag = sample

        self._probe = self._elt.spawn(loop_lag_probe(
            "head_shard", on_sample=_lag, tags={"shard": self.name}))

    def on_loop(self) -> bool:
        try:
            return asyncio.get_running_loop() is self.loop
        except RuntimeError:
            return False

    async def run_sync(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the shard loop and await the result from any
        loop.  Same-loop calls execute inline (compat mode and handlers
        already routed here pay nothing)."""
        if self.on_loop():
            return fn()

        async def _call():
            return fn()

        return await asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(_call(), self.loop))

    def stop(self) -> None:
        if self._elt is not None and self.own_thread:
            self._elt.stop()


class HeadShards:
    """The head's shard set, shaped by ``config.head_ingest_shards``:

      0  -> compat: both planes on the head loop (no threads)
      1  -> one shared ingest loop hosting both planes
      2+ -> a task-event loop and a telemetry loop (the two ingest
            planes are the natural partition; more shards would split
            the task-event STORE and force cross-shard reads)
    """

    def __init__(self, count: int, head_loop: asyncio.AbstractEventLoop):
        self.count = max(0, int(count))
        if self.count == 0:
            self.task_events = IngestShard("task_events", loop=head_loop)
            self.telemetry = IngestShard("telemetry", loop=head_loop)
        elif self.count == 1:
            from ray_tpu_torch._private.rpc import EventLoopThread

            shared = EventLoopThread(name="rt-head-ingest")
            self.task_events = IngestShard("task_events",
                                           loop_thread=shared)
            self.telemetry = IngestShard("telemetry", loop_thread=shared)
            self._shared = shared
        else:
            self.task_events = IngestShard("task_events")
            self.telemetry = IngestShard("telemetry")

    @property
    def sharded(self) -> bool:
        return self.count > 0

    def start(self) -> None:
        self.task_events.start_lag_probe()
        # with one shared loop the second probe would double-sample it
        # under a different shard label — skip it
        if self.telemetry.loop is not self.task_events.loop:
            self.telemetry.start_lag_probe()

    def op_loops(self) -> Dict[str, asyncio.AbstractEventLoop]:
        """The per-op loop routing map RpcServer consults: a frame for
        a shard-owned op dispatches onto the owning shard's loop from
        the reader, never hopping through the head loop's task queue."""
        if not self.sharded:
            return {}
        ev, tel = self.task_events.loop, self.telemetry.loop
        return {"task_events": ev, "trace_spans": ev, "list_tasks": ev,
                "list_traces": ev, "get_trace": ev,
                "heartbeat": tel, "timeseries": tel}

    def stop(self) -> None:
        stopped = set()
        for shard in (self.task_events, self.telemetry):
            if id(shard.loop) not in stopped:
                stopped.add(id(shard.loop))
                shard.stop()
            elif getattr(self, "_shared", None) is not None:
                pass  # shared loop already stopped via the first shard
        shared = getattr(self, "_shared", None)
        if shared is not None:
            shared.stop()


# --------------------------------------------------------------- planes


class TaskEventPlane:
    """Task-event + trace ingest: inbox, merged store, sched-latency
    histogram feed, trace store.  Mutations run on the owning shard's
    loop; the scheduling core and HTTP surfaces read through the
    published ``stats`` snapshot or via ``shard.run_sync`` for the
    heavier record copies (dashboard snapshot, timeline)."""

    def __init__(self, shard: IngestShard):
        from ray_tpu_torch._private.tracing import TraceStore

        self.shard = shard
        self.records: Dict[str, Dict[str, Any]] = {}
        self._inbox: List[List[Dict[str, Any]]] = []
        self._drain_scheduled = False
        self._inbox_high_water = 0
        self._dropped_total = 0
        self._sched_observed: Dict[str, set] = {}
        self.sched_hist = None  # installed by HeadService._start_metrics
        self.trace_store = TraceStore(
            max_traces=int(config.trace_store_max_traces),
            max_spans=int(config.trace_store_max_spans))
        self.finished_total = 0
        self._p99_cache = (0.0, 0.0)  # (computed_at, value)
        # stats snapshot: the scheduling core's lock-free read surface
        # (autoscaler SLO signal, dashboard counts) — one publish per
        # drain tick
        self.stats = VersionedSnapshot(payload=self._stats_payload())
        self._dropped_counter = None
        self._depth_gauge = None

    # ---- ingest (shard loop) -------------------------------------------

    def ingest(self, events: List[Dict[str, Any]]) -> None:
        """Queue one rpc frame's events; the merge runs once per loop
        tick over every frame that landed in the window (head-side half
        of the event batching).  The inbox is bounded: under saturation
        the OLDEST frame drops (newest state wins for an observability
        store) and the loss is counted per shard."""
        max_frames = int(config.head_inbox_max_frames)
        self._inbox.append(events)
        depth = len(self._inbox)
        if depth > self._inbox_high_water:
            self._inbox_high_water = depth
        if max_frames > 0 and depth > max_frames:
            dropped = self._inbox.pop(0)
            self._count_dropped(len(dropped))
        if not self._drain_scheduled:
            self._drain_scheduled = True
            asyncio.get_running_loop().call_soon(self.drain)

    def ingest_spans(self, spans: List[Dict[str, Any]]) -> None:
        self.trace_store.ingest(spans)

    def drain(self) -> None:
        self._drain_scheduled = False
        batches, self._inbox = self._inbox, []
        for events in batches:
            self._apply(events)
        cap = config.task_events_buffer_size
        while len(self.records) > cap:
            oldest = next(iter(self.records))
            self.records.pop(oldest)
            self._sched_observed.pop(oldest, None)
        self._set_depth_gauge()
        self.stats.publish(self._stats_payload())

    def _apply(self, events: List[Dict[str, Any]]) -> None:
        rank = {"SUBMITTED": 0, "LEASED": 1, "RUNNING": 2,
                "FINISHED": 3, "FAILED": 3}
        terminal = ("FINISHED", "FAILED")
        for ev in events:
            tid = ev.get("task_id", "")
            if not tid:
                continue
            rec = self.records.get(tid)
            if rec is None:
                rec = self.records[tid] = {"task_id": tid}
            was_terminal = rec.get("state") in terminal
            for k, v in ev.items():
                if v is None:
                    continue
                if k == "state":
                    # owner (SUBMITTED/LEASED) and executor (RUNNING/...)
                    # flush on independent clocks; a late-arriving earlier
                    # state must not regress the record
                    if rank.get(v, 0) < rank.get(rec.get("state"), -1):
                        continue
                rec[k] = v
            if not was_terminal and rec.get("state") in terminal:
                self.finished_total += 1
            self._observe_sched_latency(rec)

    def _observe_sched_latency(self, rec: Dict[str, Any]) -> None:
        """Once a task record is terminal, decompose its lifetime into
        queued→leased→running→finished phase durations and feed the
        ray_tpu_task_sched_latency_seconds histogram.

        Each phase is observed at most once per task, but independently:
        the executor's RUNNING/FINISHED batch usually lands before the
        owner's SUBMITTED/LEASED batch (the owner holds non-terminal
        events for its periodic flush), so the queued/leased phases only
        become computable on a later merge.  Negative deltas (events
        stamped by different process clocks) clamp to 0."""
        if self.sched_hist is None:
            return
        if rec.get("state") not in ("FINISHED", "FAILED"):
            return
        done = self._sched_observed.setdefault(rec.get("task_id", ""),
                                               set())
        sub = rec.get("submitted_ts")
        leased = rec.get("leased_ts")
        run = rec.get("running_ts")
        end = rec.get("finished_ts") or rec.get("failed_ts")
        h = self.sched_hist
        if "queued" not in done and sub is not None and leased is not None:
            done.add("queued")
            h.observe(max(0.0, leased - sub), tags={"phase": "queued"})
        if "leased" not in done and leased is not None and run is not None:
            done.add("leased")
            h.observe(max(0.0, run - leased), tags={"phase": "leased"})
        if "running" not in done and run is not None and end is not None:
            done.add("running")
            h.observe(max(0.0, end - run), tags={"phase": "running"})

    def _count_dropped(self, n: int) -> None:
        self._dropped_total += n
        if self._dropped_counter is None:
            from ray_tpu_torch._private.metrics import task_events_dropped_counter

            self._dropped_counter = task_events_dropped_counter()
        self._dropped_counter.inc(n, tags={"shard": self.shard.name})

    def _set_depth_gauge(self) -> None:
        hwm, self._inbox_high_water = self._inbox_high_water, 0
        if self._depth_gauge is None:
            from ray_tpu_torch._private.metrics import head_inbox_depth_gauge

            self._depth_gauge = head_inbox_depth_gauge()
        self._depth_gauge.set(hwm, tags={"shard": self.shard.name})

    # ---- published stats (any thread) ----------------------------------

    def _stats_payload(self) -> Dict[str, Any]:
        return {"num_events": len(self.records),
                "num_traces": len(self.trace_store.traces),
                "finished_total": self.finished_total,
                "queued_p99_ms": self._queued_p99_ms(),
                "dropped_total": self._dropped_total}

    def _queued_p99_ms(self, sample: int = 500,
                       max_age_s: float = 0.25) -> float:
        """Queued-phase (submitted->leased) p99 over the most recent
        records — the autoscaler's scheduler-latency SLO signal.
        Cached briefly: recomputing a 500-record walk on every drain
        tick of a burst would cost more than the merge itself."""
        now = time.monotonic()
        at, val = self._p99_cache
        if now - at < max_age_s:
            return val
        recs = list(self.records.values())[-sample:]
        waits = []
        for rec in recs:
            sub, leased = rec.get("submitted_ts"), rec.get("leased_ts")
            if sub is not None and leased is not None:
                waits.append(max(0.0, leased - sub))
        if waits:
            waits.sort()
            val = round(
                waits[min(len(waits) - 1, int(len(waits) * 0.99))] * 1000,
                3)
        else:
            val = 0.0
        self._p99_cache = (now, val)
        return val

    # ---- reads (shard loop; route via rpc op map or shard.run_sync) ----

    def list_tasks(self, state: str = "", name: str = "",
                   limit: int = 1000) -> List[Dict[str, Any]]:
        out = []
        for rec in reversed(list(self.records.values())):
            if state and rec.get("state") != state:
                continue
            if name and rec.get("name") != name:
                continue
            out.append(dict(rec))
            if len(out) >= limit:
                break
        return out

    def recent_records(self, limit: int = 200) -> List[Dict[str, Any]]:
        recent = sorted(self.records.values(),
                        key=lambda r: r.get("running_ts")
                        or r.get("submitted_ts") or 0,
                        reverse=True)[:limit]
        return [dict(r) for r in recent]

    def all_records(self) -> List[Dict[str, Any]]:
        return [dict(r) for r in self.records.values()]

    def summarize_tasks(self) -> Tuple[Dict[str, Dict[str, Any]],
                                       Dict[str, int]]:
        """Per-function aggregates for `rtpu summary`: state counts plus
        queued/running duration samples, and per-method actor-call
        counts.  Runs on the shard loop; the core merges the result with
        its own actor/node state."""
        from ray_tpu_torch._private.task_spec import ACTOR_TASK, NORMAL_TASK

        tasks: Dict[str, Dict[str, Any]] = {}
        methods: Dict[str, int] = {}
        for rec in self.records.values():
            name = rec.get("name") or "?"
            kind = rec.get("kind", NORMAL_TASK)
            row = tasks.get(name)
            if row is None:
                row = tasks[name] = {"kind": kind, "states": {},
                                     "queued_s": [], "running_s": []}
            st = rec.get("state", "?")
            row["states"][st] = row["states"].get(st, 0) + 1
            sub = rec.get("submitted_ts")
            run = rec.get("running_ts")
            end = rec.get("finished_ts") or rec.get("failed_ts")
            lease = rec.get("leased_ts") or run
            if sub is not None and lease is not None:
                row["queued_s"].append(max(0.0, lease - sub))
            if run is not None and end is not None:
                row["running_s"].append(max(0.0, end - run))
            if kind == ACTOR_TASK:
                methods[name] = methods.get(name, 0) + 1
        return tasks, methods


class TelemetryPlane:
    """Heartbeat ingest: object-directory delta application, the
    gauge-summary time-series ring, pressure/chaos bookkeeping, and
    heartbeat reply assembly.

    Reply assembly reads the MEMBERSHIP snapshot the scheduling core
    publishes (addr/labels/totals/draining/chaos/quarantine payloads —
    republished synchronously with every mutation) and this plane's own
    per-node telemetry; the per-node state the core needs back
    (availability, pending demands, liveness) rides ``to_core``, the
    single-producer queue the core drains once per tick.  The ring and
    the chaos-fired table take a small lock: they are read from the
    core loop (autoscaler trend tails, status surfaces) while this loop
    appends — the lock covers microseconds of deque/dict work, never
    reply assembly."""

    def __init__(self, shard: IngestShard, directory: Any,
                 membership: VersionedSnapshot,
                 to_core: CrossShardQueue):
        self.shard = shard
        self.dir = directory
        self.membership = membership
        self.to_core = to_core
        self._ts_lock = threading.Lock()
        self._tseries: Dict[Tuple[str, str], Any] = {}
        # per-node heartbeat-derived telemetry (shard-loop owned)
        self.node_telem: Dict[str, Dict[str, Any]] = {}
        # last full gauge summary per node: heartbeats carry summary
        # DELTAS (unchanged gauges are not re-serialized every beat —
        # the dir_version gossip pattern applied to the metrics echo),
        # so the ring re-records from this cache to keep its cadence
        self._last_metrics: Dict[str, Dict[str, float]] = {}
        self._fired_lock = threading.Lock()
        self._chaos_fired: Dict[str, Dict[str, int]] = {}
        # published cluster view (membership + latest availability):
        # heartbeat replies serve it; the core reads it for spillback
        # pushes without walking this plane's state
        self.cluster = VersionedSnapshot(payload={})

    # ---- heartbeat (shard loop) ----------------------------------------

    def heartbeat(self, node_id: str, available: Dict[str, float],
                  pending: Optional[List[Dict[str, float]]] = None,
                  objects_delta: Optional[Dict[str, Any]] = None,
                  dir_versions: Optional[List[int]] = None,
                  metrics: Optional[Dict[str, float]] = None,
                  memory: Optional[Dict[str, Any]] = None,
                  pressure: Optional[float] = None,
                  seen_chaos_version: int = 0,
                  seen_quarantine_version: int = 0,
                  chaos_fired: Optional[Dict[str, int]] = None
                  ) -> Dict[str, Any]:
        _mv, member = self.membership.read()
        nodes = (member or {}).get("nodes") or {}
        ninfo = nodes.get(node_id)
        if ninfo is None:
            # not in the core's published membership: restarted head
            # that reaped us, or a reap raced this beat — re-register
            return {"unknown_node": True}
        now_mono = time.monotonic()
        telem = self.node_telem.get(node_id)
        if telem is None:
            telem = self.node_telem[node_id] = {}
        telem["available"] = dict(available or {})
        telem["pending"] = pending or []
        telem["last_heartbeat"] = now_mono
        if memory:
            telem["memory"] = memory
        if pressure is not None:
            telem["pressure"] = float(pressure)
        need_metrics = False
        if metrics:
            cached = self._last_metrics.setdefault(node_id, {})
            for k, v in metrics.items():
                if v is None:  # agent retired this gauge
                    cached.pop(str(k), None)
                else:
                    cached[str(k)] = v
        elif node_id not in self._last_metrics:
            # delta-gated summary but no cache (this plane restarted
            # with the head): ask the agent to re-send everything —
            # the DeltaReporter epoch-handshake pattern
            need_metrics = True
        cached = self._last_metrics.get(node_id)
        if cached:
            now = time.time()
            for name, value in cached.items():
                self.ts_record(node_id[:12], name, value, now)
        if objects_delta is not None:
            # delta vs what this agent last acked — applied per shard,
            # bumping only the touched shards' versions.  A delta built
            # against a stale epoch (head restarted underneath the
            # agent) is only safe if it is a full re-send; otherwise the
            # epoch in our reply makes the agent re-send everything.
            # The directory is lock-per-shard (PR 8): safe to write
            # from this thread while the core reads locations.
            if objects_delta.get("full") \
                    or objects_delta.get("epoch") == self.dir.epoch:
                self.dir.apply_delta(
                    node_id, objects_delta.get("add") or (),
                    objects_delta.get("remove") or (),
                    full=bool(objects_delta.get("full")))
        chaos_stale = seen_chaos_version != (member or {}).get(
            "chaos_version", 0)
        if not chaos_stale and chaos_fired:
            # counts only make sense against the CURRENT rule set
            with self._fired_lock:
                self._chaos_fired[node_id] = dict(chaos_fired)
        # forward what the scheduling core owns: entry freshness,
        # availability for placement, pending demand for the autoscaler
        self.to_core.put({"node_id": node_id,
                          "available": dict(available or {}),
                          "pending": pending or [],
                          "memory": memory,
                          "pressure": pressure,
                          "hb_mono": now_mono})
        reply = {"cluster": self._publish_view(member),
                 "version": (member or {}).get("version", 0),
                 "dir_epoch": self.dir.epoch,
                 "dir": self.dir.updates_since(dir_versions),
                 "scalable": (member or {}).get("scalable") or []}
        if need_metrics:
            reply["need_metrics"] = True
        if chaos_stale:
            # catch-up for agents that missed the chaos_rules push (late
            # join, agent restart, dropped connection)
            reply["chaos"] = (member or {}).get("chaos_payload") or {
                "rules": [], "version": 0}
        if seen_quarantine_version != (member or {}).get(
                "quarantine_version", 1):
            reply["quarantine"] = (member or {}).get(
                "quarantine_payload") or {"version": 1, "entries": {}}
        return reply

    def _publish_view(self, member: Optional[Dict[str, Any]]
                      ) -> Dict[str, Any]:
        """Assemble the gossiped cluster view: static membership from
        the core's snapshot, availability/pressure from the freshest
        heartbeat telemetry (falling back to registration-time values
        for nodes that have not beaten yet)."""
        view: Dict[str, Any] = {}
        for nid, ninfo in ((member or {}).get("nodes") or {}).items():
            telem = self.node_telem.get(nid) or {}
            avail = telem.get("available")
            if avail is None:
                avail = ninfo.get("available") or {}
            pressure = telem.get("pressure", ninfo.get("pressure"))
            view[nid] = {"addr": ninfo["addr"],
                         "res": {"total": ninfo.get("total") or {},
                                 "available": avail},
                         "labels": ninfo.get("labels") or {},
                         "xfer": ninfo.get("xfer", 0),
                         **({"draining": True}
                            if ninfo.get("draining") else {}),
                         **({"pressure": pressure}
                            if pressure is not None else {})}
        self.cluster.publish({"view": view,
                              "version": (member or {}).get("version", 0)})
        return view

    def drop_node(self, node_id: str) -> None:
        """Core-loop call on node death: prune this plane's per-node
        state.  Dict pops are GIL-atomic; the ring takes its lock."""
        self.node_telem.pop(node_id, None)
        self._last_metrics.pop(node_id, None)
        with self._fired_lock:
            self._chaos_fired.pop(node_id, None)
        with self._ts_lock:
            for key in [k for k in self._tseries
                        if k[0] == node_id[:12]]:
                self._tseries.pop(key, None)

    # ---- chaos-fired bookkeeping (any thread) --------------------------

    def chaos_fired_counts(self) -> Dict[str, Dict[str, int]]:
        with self._fired_lock:
            return {nid: dict(c) for nid, c in self._chaos_fired.items()}

    def clear_chaos_fired(self) -> None:
        with self._fired_lock:
            self._chaos_fired.clear()

    # ---- time-series ring (any thread; internally locked) --------------

    def ts_record(self, node: str, name: str, value: float,
                  ts: Optional[float] = None) -> None:
        key = (node, name)
        with self._ts_lock:
            dq = self._tseries.get(key)
            if dq is None:
                from collections import deque as _deque

                dq = self._tseries[key] = _deque(
                    maxlen=int(config.timeseries_max_samples))
            try:
                dq.append((ts if ts is not None else time.time(),
                           float(value)))
            except (TypeError, ValueError):
                pass

    def ts_tail(self, metric: str, k: int = 10) -> Dict[str, List[float]]:
        """Last k ring samples of one heartbeat metric per node — the
        autoscaler's trend-smoothing input (PR-6 time-series ring)."""
        out: Dict[str, List[float]] = {}
        with self._ts_lock:
            for (node, name), dq in self._tseries.items():
                if name == metric and dq:
                    out[node] = [v for _ts, v in list(dq)[-k:]]
        return out

    def timeseries_payload(self) -> Dict[str, Any]:
        with self._ts_lock:
            items = [((node, name), list(dq))
                     for (node, name), dq in sorted(self._tseries.items())]
        return {"series": [
            {"node": node, "name": name,
             "points": [[round(ts, 3), v] for ts, v in pts]}
            for (node, name), pts in items]}
