"""Signal-driven elastic autoscaler (v2).

Equivalent of the reference's StandardAutoscaler + ResourceDemandScheduler
+ monitor loop (reference: python/ray/autoscaler/_private/autoscaler.py,
resource_demand_scheduler.py, monitor.py), grown from the v1 raw-queue
poll into a subsystem wired through the head:

  1. each pass reads the head's **autoscaler snapshot** — queued +
     parked-infeasible lease demands, PENDING placement-group bundles
     and PENDING actors (the three demand sources the reference
     bin-packs from load_metrics), PLUS the signals earlier subsystems
     built: lease-queue-depth trends off the PR-6 time-series ring,
     scheduler-latency p99 off the task-event store, per-node store
     byte breakdowns off PR-9 memory accounting, and Serve/LLM queue
     pressure off the heartbeat gauge summaries;
  2. demand NO existing node can ever fit launches immediately (waiting
     cannot resolve infeasibility — reference: upscaling on infeasible
     resource requests); demand that merely queues behind busy capacity
     (backlog) must be SUSTAINED for ``autoscaler_upscale_consecutive``
     passes before nodes launch — one spike that drains on its own
     must not thrash the cluster (hysteresis);
  3. scale-down is **drain-based**: an idle node past the timeout is
     handed to the head's graceful drain state machine
     (rpc_drain_node_graceful: lease quiesce, ``__rt_save__`` actor
     migration, sole-primary-copy re-replication) and the provider
     only terminates it after the head reports ``drained`` — never
     below min_workers, never the head node.  The drain victim is the
     idle node holding the FEWEST store bytes (cheapest
     re-replication, from the PR-9 breakdowns).

TPU slices stay atomic launch groups (``launch_group: k`` launches k
hosts together; reference: gcp/node.py GCPTPU pod bring-up), and
launches run on background threads tracked as *pending* so a slow boot
never stalls the decision loop.  ``stop()`` is idempotent; in-flight
launches are joined briefly and otherwise ADOPTED — the provider tracks
their nodes, so a successor autoscaler (or shutdown()) finds them.

The head handshake follows the DeltaReporter epoch pattern: the
snapshot carries the head's boot epoch, and a change (head restart)
triggers node-type re-registration within one pass.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch.autoscaler.node_provider import NodeProvider, ProviderNode


class AutoscalerConfig:
    def __init__(self, node_types: Dict[str, Dict[str, Any]],
                 idle_timeout_s: float = 60.0,
                 update_period_s: float = 1.0,
                 upscale_consecutive: Optional[int] = None,
                 sched_p99_threshold_ms: Optional[float] = None):
        """node_types: {name: {"resources": {...}, "min_workers": 0,
        "max_workers": N, "launch_group": 1}}"""
        self.node_types = node_types
        self.idle_timeout_s = idle_timeout_s
        self.update_period_s = update_period_s
        # backlog hysteresis: consecutive passes of sustained feasible-
        # but-queued demand before it may launch capacity
        self.upscale_consecutive = int(
            upscale_consecutive if upscale_consecutive is not None
            else config.autoscaler_upscale_consecutive)
        # scheduler-latency SLO pressure (0 disables)
        self.sched_p99_threshold_ms = float(
            sched_p99_threshold_ms if sched_p99_threshold_ms is not None
            else config.autoscaler_sched_p99_threshold_ms)


class _PendingLaunch:
    __slots__ = ("node_type", "count", "started", "thread", "done",
                 "nodes")

    def __init__(self, node_type: str, count: int, started: float,
                 thread: threading.Thread):
        self.node_type = node_type
        self.count = count
        self.started = started
        self.thread = thread
        self.done = False  # create_node returned
        self.nodes: List[ProviderNode] = []


class StandardAutoscaler:
    def __init__(self, head_addr, provider: NodeProvider,
                 config: AutoscalerConfig, *,
                 head_client: Any = None,
                 clock: Callable[[], float] = time.monotonic):
        cfg = config
        self.provider = provider
        self.config = cfg
        self.clock = clock  # injectable for deterministic unit tests
        self._io = None
        if head_client is not None:
            self.head = head_client
        else:
            from ray_tpu_torch._private.rpc import EventLoopThread, SyncRpcClient

            self._io = EventLoopThread(name="autoscaler-io")
            self.head = SyncRpcClient(head_addr[0], head_addr[1], self._io,
                                      label="head", retry_lost_s=15.0)
        self._idle_since: Dict[str, float] = {}  # cluster node id -> t
        self._stop = threading.Event()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pending: List[_PendingLaunch] = []
        # node_id (cluster) -> provider_id being drained right now
        self._draining: Dict[str, str] = {}
        # backlog hysteresis: consecutive passes with unmet-but-feasible
        # demand, per demand shape key
        self._backlog_streak: Dict[str, int] = {}
        self._slo_streak = 0
        self._last_decision = "startup"
        self._events_delta = {"up": 0, "down": 0}
        self.scale_up_total = 0
        self.scale_down_total = 0
        self._registration = {
            name: {"resources": t.get("resources", {})}
            for name, t in cfg.node_types.items()}
        # register synchronously at construction — work submitted the
        # moment the cluster is up must see the scalable shapes, not
        # fail infeasible — and learn the head's boot epoch from the
        # reply; a later epoch CHANGE in the snapshot (head restart)
        # re-registers within one pass (DeltaReporter handshake)
        self._seen_epoch: Optional[str] = None
        self._register()

    # ---- lifecycle ---------------------------------------------------------

    def _register(self) -> None:
        try:
            reply = self.head.call("register_autoscaler",
                                   node_types=self._registration)
            self._seen_epoch = reply.get("epoch") or self._seen_epoch
        except Exception:
            pass  # head briefly unreachable: retried on epoch mismatch

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="autoscaler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Idempotent shutdown.  In-flight launches are joined briefly;
        ones still running are ADOPTED — their threads only register
        nodes with the provider, which a successor autoscaler (or
        provider.shutdown()) observes via non_terminated_nodes()."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            pending = list(self._pending)
        for p in pending:
            p.thread.join(timeout=2)
        try:
            self.head.close()
        except Exception:
            pass
        if self._io is not None:
            self._io.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.config.update_period_s):
            try:
                self.update()
            except Exception:
                import traceback

                traceback.print_exc()

    # ---- one reconcile pass ------------------------------------------------

    def update(self) -> None:
        state = self.head.call("autoscaler_snapshot")
        epoch = state.get("epoch")
        if epoch != self._seen_epoch:
            # head restarted (or first contact): it lost the registered
            # node types — re-register before acting on the snapshot
            # (epoch-handshake, the DeltaReporter pattern).  _register
            # adopts the epoch only from a SUCCESSFUL reply, so a
            # transient registration failure retries next pass instead
            # of leaving the head typeless until its next restart
            self._register()
        self._reap_pending(state)
        demands = self._collect_demands(state)
        unmet, infeasible_now = self._split_unmet(state, demands)
        backlog = self._sustained_backlog(unmet, state)
        to_launch = self._plan_scale_up(infeasible_now + backlog)
        if to_launch:
            self._last_decision = (
                f"scale up {to_launch} "
                f"({len(infeasible_now)} infeasible, "
                f"{len(backlog)} sustained-backlog demands)")
        self._enforce_min_workers()
        self._advance_drains(state)
        self._scale_down(state, demands)
        self._report()

    # ---- demand plane ------------------------------------------------------

    def _collect_demands(self, state) -> List[ResourceSet]:
        demands: List[ResourceSet] = []
        for n in state["nodes"]:
            if n.get("draining"):
                continue
            demands.extend(ResourceSet(d) for d in n["pending"])
        demands.extend(ResourceSet(b["resources"])
                       for b in state["pending_pg_bundles"])
        demands.extend(ResourceSet(d) for d in state["pending_actors"])
        return demands

    def _split_unmet(self, state, demands: List[ResourceSet]):
        """First-fit-decreasing onto current availability.  Leftovers
        split into (backlog, infeasible-now): a demand NO live node's
        TOTALS fit can never run on the current fleet and scales up
        immediately; one that merely doesn't fit current *availability*
        is backlog and goes through hysteresis."""
        live = [n for n in state["nodes"]
                if n["heartbeat_age_s"] < 30.0 and not n.get("draining")]
        frees = [ResourceSet(n["available"]) for n in live]
        totals = [ResourceSet(n["total"]) for n in live]
        backlog: List[ResourceSet] = []
        infeasible: List[ResourceSet] = []
        for d in sorted(demands, key=lambda r: -sum(r.to_dict().values())):
            for i, free in enumerate(frees):
                if free.fits(d):
                    frees[i] = free.subtract(d)
                    break
            else:
                if any(t.fits(d) for t in totals):
                    backlog.append(d)
                else:
                    infeasible.append(d)
        return backlog, infeasible

    def _sustained_backlog(self, backlog: List[ResourceSet],
                           state) -> List[ResourceSet]:
        """Hysteresis: feasible-but-queued demand only counts once it
        has persisted for ``upscale_consecutive`` passes, corroborated
        by the head's lease-queue-depth ring staying non-empty (trend
        smoothing — a single spike whose queue already drained never
        launches).  Scheduler-latency p99 over the configured SLO
        behaves like one extra backlog demand of the largest shape."""
        signals = state.get("signals") or {}
        ring = signals.get("lease_queue_depth") or {}
        # the ring only sees demand that reached an agent's lease queue;
        # head-parked demand (PENDING actors, unplaced PG bundles) never
        # does, yet its very presence in the CURRENT snapshot is live
        # pressure — without this, a pending actor whose shape fits a
        # busy node's totals would never convert its streak to a launch
        queue_live = (any(vals and vals[-1] > 0 for vals in ring.values())
                      or bool(state.get("pending_actors"))
                      or bool(state.get("pending_pg_bundles")))
        keys_seen = set()
        sustained: List[ResourceSet] = []
        for d in backlog:
            key = repr(sorted(d.to_dict().items()))
            keys_seen.add(key)
            streak = self._backlog_streak.get(key, 0) + 1
            self._backlog_streak[key] = streak
            if streak >= self.config.upscale_consecutive \
                    and (queue_live or not ring):
                sustained.append(d)
        # streaks of shapes no longer queued reset — hysteresis measures
        # CONSECUTIVE pressure
        self._backlog_streak = {k: v for k, v
                                in self._backlog_streak.items()
                                if k in keys_seen}
        thresh = self.config.sched_p99_threshold_ms
        p99 = float(signals.get("sched_queued_p99_ms") or 0.0)
        if thresh > 0 and p99 > thresh:
            self._slo_streak += 1
            if self._slo_streak >= self.config.upscale_consecutive \
                    and not sustained and self.config.node_types:
                first = next(iter(self.config.node_types.values()))
                sustained.append(ResourceSet(first.get("resources", {})))
        else:
            self._slo_streak = 0
        return sustained

    # ---- scale up ----------------------------------------------------------

    def _counts_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for node in self.provider.non_terminated_nodes():
            counts[node.node_type] = counts.get(node.node_type, 0) + 1
        with self._lock:
            for p in self._pending:
                if not p.done:  # done launches already show in provider
                    counts[p.node_type] = \
                        counts.get(p.node_type, 0) + p.count
        return counts

    def _plan_scale_up(self, unmet: List[ResourceSet]) -> Dict[str, int]:
        if not unmet:
            return {}
        counts = self._counts_by_type()
        # capacity already in flight covers demand first: a launch takes
        # several passes to boot + register, and re-launching for the
        # same pending demand every pass would churn nodes (the async
        # cousin of v1's blocking create_node, which hid this window)
        planned: List[List[Any]] = []  # [node_type, remaining ResourceSet]
        with self._lock:
            for p in self._pending:
                shape = self.config.node_types.get(
                    p.node_type, {}).get("resources", {})
                for _ in range(p.count):
                    planned.append([p.node_type, ResourceSet(shape)])
        to_launch: Dict[str, int] = {}
        for d in unmet:
            placed = False
            for p in planned:
                if p[1].fits(d):
                    p[1] = p[1].subtract(d)
                    placed = True
                    break
            if placed:
                continue
            for name, t in self.config.node_types.items():
                shape = ResourceSet(t.get("resources", {}))
                if not shape.fits(d):
                    continue
                group = max(1, int(t.get("launch_group", 1)))
                have = counts.get(name, 0) + to_launch.get(name, 0)
                if have + group > int(t.get("max_workers", 8)):
                    continue
                to_launch[name] = to_launch.get(name, 0) + group
                fresh = [[name, ResourceSet(t.get("resources", {}))]
                         for _ in range(group)]
                fresh[0][1] = fresh[0][1].subtract(d)
                planned.extend(fresh)
                break
            # no type fits: the demand is truly infeasible — the agent
            # fails it through the normal infeasible path
        for name, count in to_launch.items():
            self._launch(name, count)
        return to_launch

    def _launch(self, name: str, count: int) -> None:
        """Background launch so a slow provider boot (subprocess spawn,
        cloud API) never stalls the decision loop; tracked as pending
        both for max_workers accounting and `rtpu status`."""
        t = self.config.node_types[name]
        resources = dict(t.get("resources", {}))
        pending = _PendingLaunch(name, count, self.clock(), None)

        def run():
            try:
                pending.nodes = self.provider.create_node(name, resources,
                                                          count)
                with self._lock:
                    # per NODE, symmetric with per-node drain counting
                    self.scale_up_total += count
                    self._events_delta["up"] += count
                # stays in _pending until its nodes REGISTER (appear in
                # the head snapshot): the launch keeps covering its
                # demand across the boot->register->snapshot staleness
                # window (see _reap_pending)
                pending.done = True
            except Exception:
                import traceback

                traceback.print_exc()
                with self._lock:
                    if pending in self._pending:
                        self._pending.remove(pending)

        pending.thread = threading.Thread(
            target=run, name=f"autoscaler-launch-{name}", daemon=True)
        with self._lock:
            self._pending.append(pending)
        pending.thread.start()

    def _reap_pending(self, state) -> None:
        """A launch stops being 'pending' once every node it created is
        REGISTERED (visible in the head snapshot) — only then does the
        demand it covered show against real availability.  A 60s
        backstop reaps launches whose nodes never made it (boot crash),
        so their capacity stops masking still-unmet demand forever."""
        seen = {n["node_id"] for n in state.get("nodes", ())}
        now = self.clock()
        with self._lock:
            kept = []
            for p in self._pending:
                if p.done and all(n.cluster_node_id in seen
                                  for n in p.nodes):
                    continue
                if now - p.started > 60.0 and not p.thread.is_alive():
                    continue
                kept.append(p)
            self._pending = kept

    def _enforce_min_workers(self) -> None:
        counts = self._counts_by_type()
        for name, t in self.config.node_types.items():
            deficit = int(t.get("min_workers", 0)) - counts.get(name, 0)
            if deficit > 0:
                self._launch(name, deficit)

    # ---- drain-based scale down -------------------------------------------

    def _store_bytes(self, state, node_id: str) -> int:
        for n in state["nodes"]:
            if n["node_id"] == node_id:
                return int((n.get("memory") or {}).get("arena_used", 0))
        return 0

    def _scale_down(self, state,
                    cluster_pending: List[ResourceSet]) -> None:
        now = self.clock()
        by_cluster_id: Dict[str, ProviderNode] = {
            n.cluster_node_id: n
            for n in self.provider.non_terminated_nodes()
            if n.cluster_node_id}
        counts = self._counts_by_type()
        live_ids = set()
        # pass 1: refresh idle clocks
        idle_candidates: List[str] = []
        for n in state["nodes"]:
            nid = n["node_id"]
            live_ids.add(nid)
            pnode = by_cluster_id.get(nid)
            if pnode is None or n["is_head_node"] or n.get("draining") \
                    or nid in self._draining:
                continue
            total = ResourceSet(n["total"])
            # cluster-pending demand (parked actors, unplaced PG
            # bundles, queued leases): an idle node whose TOTALS fit any
            # of it was probably just launched FOR it — draining would
            # churn
            busy = (n["pending"]
                    or total != ResourceSet(n["available"])
                    or any(total.fits(d) for d in cluster_pending))
            if busy:
                self._idle_since.pop(nid, None)
                continue
            since = self._idle_since.setdefault(nid, now)
            t = self.config.node_types.get(pnode.node_type, {})
            if (now - since >= self.config.idle_timeout_s
                    and counts.get(pnode.node_type, 0)
                    - sum(1 for d_nid, _pid in self._draining.items()
                          if by_cluster_id.get(d_nid) is not None
                          and by_cluster_id[d_nid].node_type
                          == pnode.node_type)
                    > int(t.get("min_workers", 0))):
                idle_candidates.append(nid)
        # pass 2: ONE drain victim per pass — the idle node with the
        # fewest stored bytes (cheapest re-replication per the PR-9
        # byte breakdowns); serializing drains keeps re-replication
        # targets plentiful and the accounting simple
        if idle_candidates and not self._draining:
            victim = min(idle_candidates,
                         key=lambda nid: self._store_bytes(state, nid))
            try:
                r = self.head.call("drain_node_graceful", node_id=victim)
            except Exception:
                r = {"ok": False}
            if r.get("ok"):
                self._draining[victim] = by_cluster_id[victim].provider_id
                self._idle_since.pop(victim, None)
                self._last_decision = f"draining idle node {victim[:12]}"
        self._idle_since = {k: v for k, v in self._idle_since.items()
                            if k in live_ids}

    def _advance_drains(self, state) -> None:
        """Terminate provider nodes whose graceful drain completed; a
        failed drain releases the node back to service (the head
        already cleared its draining flag)."""
        drains = state.get("drains") or {}
        for nid, pid in list(self._draining.items()):
            rec = drains.get(nid)
            if rec is None:
                try:
                    rec = self.head.call("drain_status", node_id=nid)
                except Exception:
                    continue
            st = rec.get("state")
            if st == "drained":
                self.provider.terminate_node(pid)
                with self._lock:
                    self.scale_down_total += 1
                    self._events_delta["down"] += 1
                self._draining.pop(nid, None)
                self._last_decision = f"drained + terminated {nid[:12]}"
            elif st in ("failed", "none"):
                self._draining.pop(nid, None)
                self._last_decision = (
                    f"drain of {nid[:12]} {st}: "
                    f"{rec.get('detail', '')}"[:120])

    # ---- status ------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        counts = self._provider_counts()
        # everything mutable reads under the lock: status() is called
        # from foreign threads (bench, AutoscalingCluster.status) while
        # the autoscaler thread mutates these
        with self._lock:
            return {
                "pending_launches": sum(p.count for p in self._pending),
                "draining": list(self._draining),
                "last_decision": self._last_decision,
                "scale_up_total": self.scale_up_total,
                "scale_down_total": self.scale_down_total,
                "node_counts": counts,
            }

    def _provider_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        try:
            for node in self.provider.non_terminated_nodes():
                counts[node.node_type] = counts.get(node.node_type, 0) + 1
        except Exception:
            pass
        return counts

    def _report(self) -> None:
        """Push this pass's status to the head (best-effort): the
        debuggability surface behind /api/autoscaler and `rtpu status`,
        plus scale-event deltas for the head-side counter."""
        st = self.status()
        with self._lock:
            delta = dict(self._events_delta)
        st["events_delta"] = delta
        try:
            self.head.call("autoscaler_report", status=st)
        except Exception:
            return  # unreported deltas carry to the next pass
        with self._lock:
            for k, v in delta.items():
                self._events_delta[k] -= v
