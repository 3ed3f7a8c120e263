"""Head service: the cluster control plane (GCS equivalent).

Ported from ray_tpu's head: it equals the copy but for forwarding a
lease's ``gpu_ids`` (not TPU chips) with an actor's creation push.

Equivalent role to the reference's GCS server
(reference: src/ray/gcs/gcs_server/gcs_server.h:78 — GcsNodeManager,
GcsActorManager, GcsKvManager, GcsHealthCheckManager, function table via
internal KV).  One process per cluster, all state in memory (the
reference's InMemoryStoreClient mode; Redis persistence is a later
layer).

Services, all over the msgpack RPC plane (rpc.py):
  - node table + resource view aggregation (agents heartbeat; the reply
    carries the cluster resource snapshot so agents can make hybrid
    scheduling/spillback decisions without a second round trip —
    equivalent of the reference's ray_syncer resource broadcast,
    src/ray/common/ray_syncer/ray_syncer.h:88)
  - internal KV (function table lives under "fn:" keys; reference:
    gcs_service.proto:522 InternalKVGcsService)
  - actor directory + lifecycle: creation scheduling, ALIVE publication,
    restart-on-death with max_restarts (reference:
    src/ray/gcs/gcs_server/gcs_actor_manager.h, gcs_actor_scheduler.h)
  - named actors (get_actor), job registration
  - health: connection-drop + heartbeat-age node failure detection
    (reference: gcs_health_check_manager.h:39)
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.profiling import IntrospectionRpcMixin, loop_lag_probe
from ray_tpu_torch._private.resources import NodeResources, ResourceSet
from ray_tpu_torch._private.rpc import (RpcClient, RpcHost, RpcServer, RpcError,
                                  is_loopback)
from ray_tpu_torch._private.scheduler import pick_node
from ray_tpu_torch._private.task_spec import (ACTOR_CREATION_TASK, ACTOR_TASK,
                                        NORMAL_TASK, TaskSpec)

# Actor states (reference: rpc::ActorTableData::ActorState)
PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"

# Placement group states (reference: gcs_placement_group_manager.h)
PG_PENDING, PG_CREATED, PG_REMOVED = "PENDING", "CREATED", "REMOVED"


class _PgEntry:
    __slots__ = ("pg_id", "bundles", "strategy", "state", "placements",
                 "name", "waiters", "failure", "opt_wait_used")

    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str, name: str):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.state = PG_PENDING
        self.placements: List[Optional[str]] = [None] * len(bundles)  # node ids
        self.name = name
        self.waiters: List[asyncio.Event] = []
        self.failure = ""
        # an optimistic (totals-based) reservation may head-of-line block
        # a node's lease queue for pg_reserve_wait_ms — each entry gets
        # exactly one such waited attempt; once it times out the
        # unavailability is genuine occupancy, not view staleness, and
        # retries must not keep stalling unrelated tasks
        self.opt_wait_used = False

    def info(self, nodes: Dict[str, "_NodeEntry"]) -> Dict[str, Any]:
        placements = []
        for nid in self.placements:
            node = nodes.get(nid) if nid else None
            placements.append(
                {"node_id": nid, "addr": [node.host, node.port]} if node else None)
        return {"pg_id": self.pg_id, "state": self.state,
                "strategy": self.strategy, "bundles": self.bundles,
                "placements": placements, "failure": self.failure}

    def wake(self):
        for ev in self.waiters:
            ev.set()
        self.waiters.clear()


class _ActorEntry:
    __slots__ = ("actor_id", "spec_wire", "state", "node_id", "worker_id",
                 "addr", "instance", "restarts_left", "name", "waiters",
                 "death_cause", "kill_requested", "sched_gen", "sched_node",
                 "sched_task", "method_num_returns")

    def __init__(self, actor_id: str, spec_wire: Dict[str, Any], name: str,
                 max_restarts: int):
        self.actor_id = actor_id
        self.spec_wire = spec_wire
        self.state = PENDING
        self.kill_requested = False
        self.node_id: str = ""
        self.worker_id: str = ""
        self.addr: Optional[Tuple[str, int]] = None
        self.instance = 0  # bumped on every (re)start
        self.restarts_left = max_restarts  # -1 = infinite
        self.name = name
        self.waiters: List[asyncio.Event] = []
        self.death_cause = ""
        # scheduling ownership: only the coroutine holding the current
        # generation may mutate this actor's state; sched_node/sched_task
        # let node-death tear down an in-flight creation push
        self.sched_gen = 0
        self.sched_node: str = ""
        self.sched_task: Optional[asyncio.Task] = None
        # @method(num_returns=...) annotations, served to get_actor so a
        # handle fetched by name streams the same as the creating handle
        self.method_num_returns: Dict[str, Any] = {}

    def info(self) -> Dict[str, Any]:
        return {
            "actor_id": self.actor_id,
            "state": self.state,
            "addr": list(self.addr) if self.addr else None,
            "worker_id": self.worker_id,
            "node_id": self.node_id,
            "instance": self.instance,
            "name": self.name,
            "death_cause": self.death_cause,
        }

    def wake(self):
        for ev in self.waiters:
            ev.set()
        self.waiters.clear()


class _NodeEntry:
    __slots__ = ("node_id", "host", "port", "arena_path", "resources",
                 "last_heartbeat", "client", "is_head_node",
                 "pending_demands", "labels", "xfer_port", "memory",
                 "draining", "pressure")

    def __init__(self, node_id: str, host: str, port: int, arena_path: str,
                 resources: NodeResources, is_head_node: bool,
                 labels: Optional[Dict[str, str]] = None,
                 xfer_port: int = 0):
        self.node_id = node_id
        self.host = host
        self.port = port
        self.arena_path = arena_path
        self.resources = resources
        self.last_heartbeat = time.monotonic()
        self.client: Optional[RpcClient] = None
        self.is_head_node = is_head_node
        # queued + infeasible lease demands, piggybacked on heartbeats —
        # the autoscaler's scale-up signal (reference: load_metrics.py)
        self.pending_demands: List[Dict[str, float]] = []
        # static key/value labels for NodeLabelSchedulingStrategy
        # (reference: common.proto NodeLabels)
        self.labels: Dict[str, str] = labels or {}
        # bulk object-transfer plane listener (object_transfer.py)
        self.xfer_port = xfer_port
        # latest store byte breakdown off this node's heartbeat — the
        # cheap (no fan-out) half of /api/memory and rtpu summary
        self.memory: Dict[str, Any] = {}
        # latest watchdog-sampled memory usage fraction (heartbeat);
        # rides the cluster view so pick_node demotes pressured nodes
        self.pressure: Optional[float] = None
        # graceful scale-down: a DRAINING node grants no new leases and
        # is excluded from every placement decision; the drain state
        # machine (HeadService._drain_task) owns the flag's lifecycle
        self.draining = False
        # NOTE: object locations live in HeadService.dir (the sharded
        # object directory), no longer per-node snapshot maps here

    def table_entry(self) -> Dict[str, Any]:
        return {
            "node_id": self.node_id,
            "addr": [self.host, self.port],
            "arena_path": self.arena_path,
            "resources": self.resources.to_dict(),
            "is_head_node": self.is_head_node,
            "labels": self.labels,
            "xfer_port": self.xfer_port,
            "draining": self.draining,
        }


class HeadService(IntrospectionRpcMixin, RpcHost):
    def __init__(self, state_path: str = ""):
        self.nodes: Dict[str, _NodeEntry] = {}
        self.kv: Dict[str, bytes] = {}
        self.actors: Dict[str, _ActorEntry] = {}
        self.named_actors: Dict[str, str] = {}  # name -> actor_id
        self.placement_groups: Dict[str, _PgEntry] = {}
        self._next_job_int = 1  # persisted; itertools.count has no peek
        self._server: Optional[RpcServer] = None
        self._health_task: Optional[asyncio.Task] = None
        self._persist_task: Optional[asyncio.Task] = None
        self._node_conns: Dict[Any, str] = {}  # conn -> node_id
        self._cluster_version = 0  # bumped on membership change
        # sharded object directory (object_directory.py): per-oid-hash
        # buckets, each with its own lock + version — heartbeat deltas,
        # location lookups, and mirror gossip on different buckets never
        # serialize on one structure.  The epoch token handshakes full
        # re-sends across head restarts.
        import os as _os

        from ray_tpu_torch._private.object_directory import ShardedObjectDirectory

        self.dir = ShardedObjectDirectory(
            int(config.object_directory_shards),
            epoch=_os.urandom(8).hex())
        self._shutdown = asyncio.Event()
        # general pub/sub: per-channel ring buffer + long-poll waiters
        # (reference: pubsub/publisher.h:307 — typed channels for node
        # events, actor state, errors; here any named channel works)
        self._pubsub: Dict[str, Any] = {}        # channel -> deque[(seq, payload)]
        self._pubsub_seq: Dict[str, int] = {}
        self._pubsub_waiters: Dict[str, List[asyncio.Event]] = {}
        # persistence (reference: gcs/store_client/redis_store_client.h —
        # GCS tables behind a store so the head survives restarts; we
        # snapshot to a local file, atomic tmp+rename)
        self._state_path = state_path
        self._dirty = False
        self.restarted = False  # loaded pre-existing state on boot
        # node types an autoscaler announced it can launch
        self._autoscaler_types: Dict[str, Dict[str, Any]] = {}
        # elastic autoscaling: per-node graceful-drain records
        # (node_id -> {state, phase, ...}; state=draining|drained|failed)
        # plus the autoscaler's latest status report — together they are
        # /api/autoscaler and the `rtpu status` autoscaler pane
        self._drains: Dict[str, Dict[str, Any]] = {}
        self._autoscaler_status: Dict[str, Any] = {}
        # control-plane ingest shards (head_shards.py): the task-event
        # plane owns the task-event store + trace store + sched-latency
        # feed; the telemetry plane owns heartbeat ingest + the time-
        # series ring.  Constructed in start() (the compat topology
        # wraps the running loop); head_ingest_shards=0 keeps every
        # plane on this loop.  The membership snapshot is the core ->
        # shard handshake: republished synchronously with every
        # cluster/chaos/quarantine mutation, read lock-free by the
        # telemetry plane when assembling heartbeat replies.
        from ray_tpu_torch._private.head_shards import VersionedSnapshot

        self.shards = None
        self._ev_plane = None
        self._telem = None
        self._core_queue = None
        self._membership = VersionedSnapshot(payload=None)
        self._core_inbox_gauge = None
        self._metrics_server = None
        self.metrics_port = 0
        # pending-PG replan wakeups: futures resolved whenever cluster
        # resources may have freed (heartbeat showing changed availability,
        # bundle return, node registration) — _schedule_pg waits on these
        # instead of polling with sleep backoff (reference:
        # gcs_placement_group_manager.cc SchedulePendingPlacementGroups,
        # fired on resource-change events from the syncer)
        self._pg_wake_waiters: List[asyncio.Future] = []
        # ditto for PENDING actors parked on "no feasible node": a node
        # registration wakes them immediately instead of them sleeping
        # out a backoff window — without this an autoscaled node can sit
        # idle past the drain timeout before the actor it was launched
        # for even retries (launch/drain churn)
        self._actor_wake_waiters: List[asyncio.Future] = []
        # dashboard sparkline ring: 2s samples, ~5 minutes of history
        from collections import deque as _deque

        self._dash_series = _deque(maxlen=150)
        self._dash_task: Optional[asyncio.Task] = None
        self._head_loop_lag = 0.0
        self._lag_task: Optional[asyncio.Task] = None
        # chaos fault-injection rules (fault_injection.py): the head is
        # the distribution point — rules install here, apply to the
        # head's own sites, and gossip to agents (push + heartbeat
        # catch-up, version-gated like the object directory)
        self._chaos_rules: List[Dict[str, Any]] = []
        self._chaos_version = 0
        # per-node chaos firing counts now live on the telemetry plane
        # (heartbeats land there); status aggregates them with the
        # head's own counts via _telem.chaos_fired_counts()
        # poison-task quarantine: fid -> {kills, history, until, name,
        # detail}.  Owners report each worker kill their class caused
        # (task_kill_report) and the first success after one
        # (task_ok_report, resetting the CONSECUTIVE count); at
        # poison_task_threshold kills the class quarantines for
        # poison_task_ttl_s — agents refuse its leases (gossiped on
        # heartbeat replies, version-gated like chaos rules) and owners
        # fail submissions fast with PoisonedTaskError.
        self._poison: Dict[str, Dict[str, Any]] = {}
        self._quarantine_version = 1
        # memory/object accounting (rtpu memory): registered driver
        # callback addresses by job id (bounded — oldest fall off), the
        # pooled clients to them, and the periodic leak-scan task that
        # feeds ray_tpu_object_leaked_bytes
        from collections import OrderedDict as _OrderedDict

        self.driver_addrs: Dict[str, Tuple[str, int]] = _OrderedDict()
        self._driver_clients: Dict[Tuple[str, int], RpcClient] = {}
        self._driver_join_gap = False
        # drivers whose callback is unreachable (loopback addr from a
        # remote peer): the join is gapped only while their connection
        # lives — a PERMANENT flag here would turn the dead-owner and
        # channel tripwires off forever on any multi-machine cluster
        self._gapped_driver_conns: set = set()
        # leak TTLs run from when an object was first seen UNCLAIMED
        # (complete scans only), not from creation: an old object whose
        # owner just exited gets a full TTL of grace for the in-flight
        # store_free instead of being flagged on the next scan
        self._unclaimed_since: Dict[str, float] = {}
        self._memory_task: Optional[asyncio.Task] = None
        self._last_memory_scan: Dict[str, Any] = {}
        self._memview_inflight: Dict[Tuple[int, int], asyncio.Future] = {}

    # ---- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        if self._state_path:
            self._load_state()
        # ingest shards before the server: routed ops (task_events,
        # heartbeat, ...) dispatch onto their loops from the very first
        # frame.  The cross-shard queue is the telemetry plane's only
        # write path into core state (_NodeEntry mutations), drained
        # once per core tick.
        from ray_tpu_torch._private.head_shards import (CrossShardQueue,
                                                  HeadShards,
                                                  TaskEventPlane,
                                                  TelemetryPlane)

        core_loop = asyncio.get_running_loop()
        self.shards = HeadShards(int(config.head_ingest_shards), core_loop)
        self._core_queue = CrossShardQueue(
            core_loop, self._apply_node_updates, name="telemetry")
        self._ev_plane = TaskEventPlane(self.shards.task_events)
        self._telem = TelemetryPlane(self.shards.telemetry, self.dir,
                                     self._membership, self._core_queue)
        self.rpc_op_loops = self.shards.op_loops()
        self.shards.start()
        self._publish_membership()
        self._server = RpcServer(self, host, port)
        p = await self._server.start()
        self._health_task = asyncio.ensure_future(self._health_loop())

        def _lag(sample: float) -> None:
            self._head_loop_lag = sample

        self._lag_task = asyncio.ensure_future(
            loop_lag_probe("head", on_sample=_lag))
        if self._state_path:
            self._persist_task = asyncio.ensure_future(self._persist_loop())
        if float(config.memory_scan_interval_s) > 0:
            self._memory_task = asyncio.ensure_future(
                self._memory_scan_loop())
        await self._start_metrics(host)
        # resume interrupted scheduling work from the restored tables
        for actor in self.actors.values():
            if actor.state in (PENDING, RESTARTING):
                self._spawn_scheduler(actor)
        for pg in self.placement_groups.values():
            if pg.state == PG_PENDING:
                asyncio.ensure_future(self._schedule_pg(pg))
        return p

    async def stop(self):
        if self._health_task:
            self._health_task.cancel()
        if self._lag_task:
            self._lag_task.cancel()
        if self._persist_task:
            self._persist_task.cancel()
        if self._dash_task:
            self._dash_task.cancel()
        if self._memory_task:
            self._memory_task.cancel()
        if self._state_path and self._dirty:
            self._save_state()
        # snapshot both tables: each close() yields, and a late register
        # or reap can resize the dict mid-iteration
        for n in list(self.nodes.values()):
            if n.client is not None:
                await n.client.close()
        for c in list(self._driver_clients.values()):
            await c.close()
        self._driver_clients.clear()
        if self._metrics_server is not None:
            self._metrics_server.close()
        if getattr(self, "_metrics_collector", None) is not None:
            from ray_tpu_torch._private.metrics import default_registry

            default_registry.remove_collector(self._metrics_collector)
            self._metrics_collector = None
        if self._server:
            await self._server.stop()
        if self.shards is not None:
            self.shards.stop()
        self._shutdown.set()

    # ---- persistence -------------------------------------------------------

    def mark_dirty(self) -> None:
        self._dirty = True

    async def _persist_loop(self):
        interval = config.gcs_persist_interval_ms / 1000.0
        while True:
            await asyncio.sleep(interval)
            if self._dirty:
                self._dirty = False
                try:
                    self._save_state()
                except Exception:
                    import traceback

                    traceback.print_exc()

    def _snapshot(self) -> Dict[str, Any]:
        return {
            "kv": dict(self.kv),
            "named_actors": dict(self.named_actors),
            "job_counter": self._next_job_int,
            # memory aggregator callbacks: without these a head restart
            # makes every live driver's objects look ownerless (and the
            # dead-owner tripwire would flag them after one TTL)
            "driver_addrs": {j: list(a)
                             for j, a in self.driver_addrs.items()},
            # conn-scoped gaps can't survive a restart (the conns are
            # gone but the drivers may live on) — fold them into the
            # permanent flag so the restarted head stays conservative
            "driver_join_gap": (self._driver_join_gap
                                or bool(self._gapped_driver_conns)),
            "cluster_version": self._cluster_version,
            "autoscaler_types": dict(self._autoscaler_types),
            "actors": [
                {"actor_id": a.actor_id, "spec_wire": a.spec_wire,
                 "state": a.state, "node_id": a.node_id,
                 "worker_id": a.worker_id,
                 "addr": list(a.addr) if a.addr else None,
                 "instance": a.instance, "restarts_left": a.restarts_left,
                 "name": a.name, "death_cause": a.death_cause,
                 "kill_requested": a.kill_requested,
                 "method_num_returns": a.method_num_returns}
                for a in self.actors.values()],
            "placement_groups": [
                {"pg_id": p.pg_id, "bundles": p.bundles,
                 "strategy": p.strategy, "state": p.state,
                 "placements": p.placements, "name": p.name,
                 "failure": p.failure}
                for p in self.placement_groups.values()],
            "nodes": [
                {"node_id": n.node_id, "host": n.host, "port": n.port,
                 "arena_path": n.arena_path, "is_head_node": n.is_head_node,
                 "total": n.resources.total.to_dict(),
                 "available": n.resources.available.to_dict(),
                 "xfer_port": n.xfer_port}
                for n in self.nodes.values()],
        }

    def _save_state(self) -> None:
        import os

        import msgpack

        blob = msgpack.packb(self._snapshot(), use_bin_type=True)
        tmp = self._state_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._state_path)

    def _load_state(self) -> None:
        import os

        import msgpack

        if not os.path.exists(self._state_path):
            return
        try:
            with open(self._state_path, "rb") as f:
                snap = msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False)
        except Exception as e:
            # a corrupt snapshot must not crash-loop the head: boot empty
            # (agents re-register via heartbeats) and keep the bad file
            # aside for diagnosis
            import sys

            sys.stderr.write(f"head state unreadable ({e}); starting fresh\n")
            try:
                os.replace(self._state_path, self._state_path + ".corrupt")
            except OSError:
                pass
            return
        self.kv = dict(snap.get("kv", {}))
        self.named_actors = dict(snap.get("named_actors", {}))
        self._next_job_int = int(snap.get("job_counter", 1))
        for j, a in (snap.get("driver_addrs") or {}).items():
            self.driver_addrs[j] = (a[0], a[1])
        self._driver_join_gap = bool(
            snap.get("driver_join_gap", False))
        self._cluster_version = int(snap.get("cluster_version", 0))
        self._autoscaler_types = dict(snap.get("autoscaler_types", {}))
        for a in snap.get("actors", []):
            entry = _ActorEntry(a["actor_id"], a["spec_wire"], a["name"], 0)
            entry.state = a["state"]
            entry.node_id = a["node_id"]
            entry.worker_id = a["worker_id"]
            entry.addr = tuple(a["addr"]) if a["addr"] else None
            entry.instance = a["instance"]
            entry.restarts_left = a["restarts_left"]
            entry.death_cause = a["death_cause"]
            entry.method_num_returns = dict(a.get("method_num_returns") or {})
            entry.kill_requested = a["kill_requested"]
            self.actors[entry.actor_id] = entry
        for p in snap.get("placement_groups", []):
            entry = _PgEntry(p["pg_id"], p["bundles"], p["strategy"],
                             p["name"])
            entry.state = p["state"]
            entry.placements = list(p["placements"])
            entry.failure = p["failure"]
            self.placement_groups[entry.pg_id] = entry
        # nodes are restored provisionally: agents keep running across a
        # head restart and re-register on the next heartbeat (reference:
        # node_manager.proto NotifyGCSRestart).  A restored node that
        # never reports in is reaped by the health loop.
        for nd in snap.get("nodes", []):
            entry = _NodeEntry(
                nd["node_id"], nd["host"], nd["port"], nd["arena_path"],
                NodeResources(ResourceSet(nd["total"])),
                nd["is_head_node"], xfer_port=nd.get("xfer_port", 0))
            entry.resources.available = ResourceSet(nd["available"])
            self.nodes[entry.node_id] = entry
        self.restarted = True

    async def wait_for_shutdown(self):
        await self._shutdown.wait()

    # ---- node table --------------------------------------------------------

    async def rpc_register_node(self, node_id: str, host: str, port: int,
                                arena_path: str, resources: Dict[str, float],
                                is_head_node: bool = False,
                                labels: Optional[Dict[str, str]] = None,
                                xfer_port: int = 0, _conn=None):
        entry = _NodeEntry(node_id, host, port, arena_path,
                           NodeResources(ResourceSet(resources)), is_head_node,
                           labels=labels or {}, xfer_port=xfer_port)
        self.nodes[node_id] = entry
        if _conn is not None:
            self._node_conns[_conn] = node_id
        self.publish("node_events", {"event": "registered",
                                     "node_id": node_id,
                                     "addr": [host, port],
                                     "is_head_node": is_head_node})
        self._cluster_version += 1
        self.mark_dirty()
        self._broadcast_cluster_view()
        # fresh capacity invalidates earlier "genuinely occupied"
        # conclusions: pending PGs may spend a new waited reservation
        for pg in self.placement_groups.values():
            pg.opt_wait_used = False
        self._wake_pending_pgs()
        self._wake_pending_actors()
        if self._chaos_version:
            # late joiners inherit the armed rule set immediately
            asyncio.get_running_loop().call_soon(self._broadcast_chaos)
        return {"ok": True, "cluster": self._cluster_view(),
                "version": self._cluster_version,
                "dir_epoch": self.dir.epoch,
                "dir": self.dir.updates_since(None)}

    def _publish_membership(self) -> None:
        """Publish the scheduling core's membership snapshot for the
        telemetry plane: node identity/addr/labels/totals/draining plus
        the version-gated gossip payloads (chaos, quarantine, scalable
        shapes).  Republished synchronously with EVERY mutation of that
        state, so the plane's heartbeat replies are stale by at most
        the in-flight beats of one publish — the DirectoryMirror
        version-handshake pattern, core->shard direction."""
        if self._membership is None:
            return
        nodes: Dict[str, Dict[str, Any]] = {}
        for nid, n in self.nodes.items():
            nodes[nid] = {"addr": [n.host, n.port], "labels": n.labels,
                          "xfer": n.xfer_port, "draining": n.draining,
                          "is_head": n.is_head_node,
                          "total": n.resources.total.to_dict(),
                          "available": n.resources.available.to_dict(),
                          "pressure": n.pressure}
        self._membership.publish({
            "nodes": nodes,
            "version": self._cluster_version,
            "scalable": self._scalable_shapes(),
            "chaos_version": self._chaos_version,
            "chaos_payload": self._chaos_payload(),
            "quarantine_version": self._quarantine_version,
            "quarantine_payload": self._quarantine_payload(),
        })

    def _apply_node_updates(self, items: List[Dict[str, Any]]) -> None:
        """Core-loop drain of the telemetry plane's cross-shard queue:
        fold heartbeat-derived per-node state into the scheduling
        core's _NodeEntry records (availability for placement, pending
        demand for the autoscaler, liveness for the health loop).  One
        callback per core tick regardless of how many beats landed."""
        woke = False
        for up in items:
            entry = self.nodes.get(up["node_id"])
            if entry is None:
                continue
            entry.last_heartbeat = up["hb_mono"]
            if up.get("memory"):
                entry.memory = up["memory"]
            if up.get("pressure") is not None:
                entry.pressure = float(up["pressure"])
            fresh = ResourceSet(up.get("available") or {})
            if fresh != entry.resources.available:
                woke = True
            entry.resources.available = fresh
            entry.pending_demands = up.get("pending") or []
        if woke:
            self._wake_pending_pgs()
        if self._core_inbox_gauge is None:
            from ray_tpu_torch._private.metrics import head_inbox_depth_gauge

            self._core_inbox_gauge = head_inbox_depth_gauge()
        self._core_inbox_gauge.set(self._core_queue.take_high_water(),
                                   tags={"shard": "telemetry"})

    def _broadcast_cluster_view(self):
        """Membership changed: push the fresh view to every agent so
        feasibility checks don't wait out a heartbeat period (equivalent
        of the reference's ray_syncer broadcast).  One task per peer so a
        wedged agent can't stall the others."""
        self._publish_membership()
        view = self._cluster_view()
        version = self._cluster_version
        scalable = self._scalable_shapes()

        async def _push_one(conn):
            try:
                await asyncio.wait_for(
                    conn.push("cluster_update",
                              {"cluster": view, "version": version,
                               "scalable": scalable}),
                    timeout=5.0)
            except Exception:
                pass

        for conn in list(self._node_conns):
            asyncio.ensure_future(_push_one(conn))

    async def rpc_heartbeat(self, node_id: str, available: Dict[str, float],
                            pending: Optional[List[Dict[str, float]]] = None,
                            objects_delta: Optional[Dict[str, Any]] = None,
                            dir_versions: Optional[List[int]] = None,
                            metrics: Optional[Dict[str, float]] = None,
                            memory: Optional[Dict[str, Any]] = None,
                            pressure: Optional[float] = None,
                            seen_chaos_version: int = 0,
                            seen_quarantine_version: int = 0,
                            chaos_fired: Optional[Dict[str, int]] = None):
        """Routed to the telemetry shard's loop (rpc_op_loops): the
        whole beat — directory delta application, gauge-summary ring
        append, reply assembly off the membership snapshot — runs off
        the scheduling loop.  Only the per-node core state (entry
        availability/liveness) crosses back, over the single-producer
        queue drained once per core tick (_apply_node_updates)."""
        return self._telem.heartbeat(
            node_id=node_id, available=available, pending=pending,
            objects_delta=objects_delta, dir_versions=dir_versions,
            metrics=metrics, memory=memory, pressure=pressure,
            seen_chaos_version=seen_chaos_version,
            seen_quarantine_version=seen_quarantine_version,
            chaos_fired=chaos_fired)

    async def rpc_object_locations(self, oids: List[str]):
        """Directory lookup: which nodes' stores hold each oid (per the
        latest heartbeat deltas).  Pullers use it to retry from an
        alternate holder when their recorded source died mid-transfer
        (reference: ObjectDirectory location subscriptions).  One shard
        lock per oid — no scan over every node's object map."""
        out: Dict[str, List[List[Any]]] = {}
        for oid in oids:
            holders = []
            for nid in self.dir.locations(oid):
                n = self.nodes.get(nid)
                if n is not None:
                    holders.append([n.host, n.port])
            if holders:
                out[oid] = holders
        return {"locations": out}

    async def rpc_node_table(self):
        return {nid: n.table_entry() for nid, n in self.nodes.items()}

    # ---- pub/sub -----------------------------------------------------------

    def publish(self, channel: str, payload: Any) -> int:
        """Append an event to a channel's ring buffer and wake pollers
        (reference: pubsub/publisher.h Publish)."""
        from collections import deque

        seq = self._pubsub_seq.get(channel, 0) + 1
        self._pubsub_seq[channel] = seq
        buf = self._pubsub.get(channel)
        if buf is None:
            buf = self._pubsub[channel] = deque(maxlen=1000)
        buf.append((seq, payload))
        for ev in self._pubsub_waiters.pop(channel, []):
            ev.set()
        return seq

    async def rpc_publish(self, channel: str, payload: Any):
        return {"seq": self.publish(channel, payload)}

    async def rpc_subscribe_poll(self, channel: str, after_seq: int = 0,
                                 timeout_ms: int = 0):
        """Long-poll: events with seq > after_seq, waiting up to
        timeout_ms when none are buffered yet (reference: the
        subscriber's long-poll loop in pubsub/subscriber.h)."""
        # 0 means "return immediately"; positive values are clamped
        timeout_ms = min(timeout_ms, config.pubsub_poll_timeout_ms) \
            if timeout_ms > 0 else 0

        def collect():
            buf = self._pubsub.get(channel) or ()
            return [{"seq": s, "payload": p} for s, p in buf if s > after_seq]

        events = collect()
        if not events and timeout_ms > 0:
            ev = asyncio.Event()
            self._pubsub_waiters.setdefault(channel, []).append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout_ms / 1000.0)
            except asyncio.TimeoutError:
                pass
            finally:
                waiters = self._pubsub_waiters.get(channel, [])
                if ev in waiters:
                    waiters.remove(ev)
            events = collect()
        return {"events": events,
                "latest_seq": self._pubsub_seq.get(channel, 0)}

    async def rpc_drain_node(self, node_id: str):
        """Immediate removal (reference: node_manager.proto DrainRaylet).
        The node is dropped from the tables at once — in-flight work
        dies and objects are NOT re-replicated.  The autoscaler's
        scale-down path uses rpc_drain_node_graceful instead; this stays
        as the forced/operator path."""
        await self._on_node_dead(node_id, "drained")
        return {"ok": True}

    async def rpc_drain_node_graceful(self, node_id: str):
        """Start the graceful drain state machine for one node
        (reference: DrainRaylet with a deadline + the autoscaler's
        drain-before-terminate protocol).  Returns immediately; poll
        rpc_drain_status.  Idempotent while a drain is in flight.

        Phases (see _drain_task): quiesce (no new leases, warm pools
        reclaimed) -> migrate_actors (__rt_save__ snapshot + restart
        elsewhere, no restart budget spent) -> quiesce_leases (in-flight
        work finishes) -> replicate_objects (sole primary copies pushed
        to live nodes over the bulk plane and promoted) -> terminate.
        A drain never proceeds past replicate_objects while a live
        object's last copy would die with the node."""
        entry = self.nodes.get(node_id)
        if entry is None:
            rec = self._drains.get(node_id)
            if rec is not None:
                return {"ok": True, "state": rec["state"]}
            return {"ok": False, "error": f"unknown node {node_id!r}"}
        if entry.is_head_node:
            return {"ok": False, "error": "refusing to drain the head node"}
        rec = self._drains.get(node_id)
        if rec is not None and rec["state"] == "draining":
            return {"ok": True, "state": "draining"}
        while len(self._drains) >= 32:  # bounded: drop oldest finished
            done = next((k for k, v in self._drains.items()
                         if v["state"] != "draining"), None)
            if done is None:
                break
            self._drains.pop(done)
        rec = self._drains[node_id] = {
            "node_id": node_id, "state": "draining", "phase": "quiesce",
            "started_ts": time.time(), "detail": "",
            "migrated_actors": 0, "replicated_objects": 0,
            "replicated_bytes": 0,
        }
        entry.draining = True
        self._cluster_version += 1
        self.mark_dirty()
        self._broadcast_cluster_view()
        self.publish("node_events", {"event": "draining",
                                     "node_id": node_id})
        asyncio.ensure_future(self._drain_task(entry, rec))
        return {"ok": True, "state": "draining"}

    async def rpc_drain_status(self, node_id: str):
        rec = self._drains.get(node_id)
        if rec is None:
            return {"state": "none"}
        return dict(rec)

    async def _drain_task(self, entry: _NodeEntry, rec: Dict[str, Any]):
        node_id = entry.node_id
        t0 = time.monotonic()
        deadline = t0 + float(config.drain_timeout_s)
        try:
            client = self._node_client(entry)
            # 1. the agent stops granting leases, cancels queued
            # waiters (owners re-route on the drained view) and pushes
            # an unbounded warm-lease reclaim to every owner
            await client.call("prepare_drain", timeout=10.0)
            # 2. restartable actors migrate off: snapshot via
            # __rt_save__ where supported, restart elsewhere without
            # spending the restart budget (a drain is not a failure)
            rec["phase"] = "migrate_actors"
            await self._drain_migrate_actors(entry, rec)
            # 3. wait out in-flight task leases — bounded by the grace
            # budget so one long-running task cannot wedge scale-down
            rec["phase"] = "quiesce_leases"
            grace_end = min(deadline,
                            t0 + float(config.drain_lease_grace_s))
            while time.monotonic() < grace_end:
                try:
                    info = await client.call("drain_info", timeout=10.0)
                except Exception:
                    break  # agent gone: node death path takes over
                if not info.get("leases"):
                    break
                await asyncio.sleep(0.2)
            # 4. no live object's last copy may die with the node
            rec["phase"] = "replicate_objects"
            await self._drain_replicate_objects(entry, rec, deadline)
            # 5. done: drop the node (actors/PGs left on it take the
            # normal death path — all migratable state is already off)
            rec["phase"] = "terminate"
            if node_id in self.nodes:
                try:
                    await client.oneway("shutdown_node")
                except Exception:
                    pass
                await self._on_node_dead(node_id, "drained")
            rec["state"] = "drained"
            rec["drain_s"] = round(time.monotonic() - t0, 3)
            from ray_tpu_torch._private.metrics import autoscaler_metrics

            # scale_events_total counts DECISIONS and comes solely from
            # the autoscaler's report deltas (counting here too would
            # double every drain); the head owns the duration histogram
            _g, _events_c, drain_h = autoscaler_metrics()
            drain_h.observe(time.monotonic() - t0)
        except Exception as e:
            # abandon, don't force: the node keeps running with its
            # data; the autoscaler sees "failed" and may retry later
            rec["state"] = "failed"
            rec["detail"] = f"{type(e).__name__}: {e}"[:300]
            cur = self.nodes.get(node_id)
            if cur is not None:
                cur.draining = False
                self._cluster_version += 1
                self._broadcast_cluster_view()
                try:
                    await self._node_client(cur).call("cancel_drain",
                                                      timeout=10.0)
                except Exception:
                    pass

    async def _drain_migrate_actors(self, entry: _NodeEntry,
                                    rec: Dict[str, Any]) -> int:
        """Move every migratable actor off the draining node.

        Migratable = has restart budget left, or persisted state via
        ``__rt_save__`` just now (a stateful actor with max_restarts=0
        still resumes with state intact — the drain is planned, not a
        crash).  Non-migratable actors are exited here too: that is the
        node's death brought forward, handled by the normal worker-death
        path (serve replicas get replaced by their controller)."""
        migrated = 0
        for actor in list(self.actors.values()):
            if actor.node_id != entry.node_id or actor.state != ALIVE:
                continue
            if actor.addr is None:
                continue
            c = RpcClient(actor.addr[0], actor.addr[1], label="drain-actor")
            saved = False
            try:
                try:
                    r = await c.call("persist_actor_state", timeout=30.0)
                    saved = bool(r.get("saved"))
                except Exception:
                    pass
                if actor.restarts_left != 0 or saved:
                    # RESTARTING set BEFORE the worker exits: the
                    # agent's worker-death report then finds a restart
                    # already in flight and spends no budget
                    actor.state = RESTARTING
                    self.mark_dirty()
                    self.publish("actor_events", {
                        "actor_id": actor.actor_id, "state": "RESTARTING",
                        "name": actor.name,
                        "cause": f"node {entry.node_id[:8]} draining"})
                    actor.wake()
                    migrated += 1
                try:
                    await c.oneway("exit_worker")
                except Exception:
                    pass
            finally:
                await c.close()
            if actor.state == RESTARTING:
                self._spawn_scheduler(actor)
        rec["migrated_actors"] = migrated
        return migrated

    async def _drain_replicate_objects(self, entry: _NodeEntry,
                                       rec: Dict[str, Any],
                                       deadline: float):
        """Re-replicate every sealed live primary copy the draining node
        holds whose LAST copy would otherwise die with it.

        The sharded object directory answers "who else holds this" (a
        secondary copy elsewhere is promoted instead of re-pulled);
        sole copies are pulled over the PR-4 bulk plane onto the target
        with the most free arena bytes (PR-9 heartbeat breakdowns are
        the bin-packing input).  Pulled/promoted copies become PRIMARY
        (eviction-exempt) and are injected into the directory under the
        target's node id, so owners whose recorded holder dies resolve
        the new location through the normal alt-source path."""
        client = self._node_client(entry)
        cap = int(config.memory_summary_max_objects)
        r = await client.call("list_objects", limit=cap, timeout=30.0)
        listing = r.get("objects", ())
        if len(listing) >= cap:
            # a truncated listing could hide a sole primary copy; the
            # invariant is absolute, so fail the drain safe (the node
            # returns to service) rather than guess
            raise RuntimeError(
                f"object listing truncated at {cap}; refusing to drain "
                f"a store this large")
        objs = [o for o in listing
                if o.get("sealed") and not o.get("freed")
                and not o.get("channel") and o.get("primary")]
        if not objs:
            return
        targets = [n for n in self.nodes.values()
                   if n.node_id != entry.node_id and not n.draining]
        if not targets:
            raise RuntimeError(
                f"no live node to take {len(objs)} primary copies")
        # bin-pack against real free-arena bytes from the heartbeat
        # byte breakdowns, tracking what this drain already planned in
        planned: Dict[str, int] = {n.node_id: 0 for n in targets}

        def headroom(n: _NodeEntry) -> float:
            free = (n.memory or {}).get("arena_free")
            if free is None:
                free = config.object_store_memory_bytes
            return free - planned[n.node_id]

        # one plan per target: an existing directory-recorded secondary
        # elsewhere picks that node (ensure_local is a no-op when the
        # copy still exists and re-pulls from the source if it was
        # evicted meanwhile — the same verified path either way);
        # everything else bin-packs onto the freest store
        by_target: Dict[str, List[Tuple[str, int]]] = {}
        for o in objs:
            oid, size = o["object_id"], int(o.get("size", 0))
            others = [nid for nid in self.dir.locations(oid)
                      if nid != entry.node_id and nid in self.nodes
                      and not self.nodes[nid].draining]
            if others:
                by_target.setdefault(others[0], []).append((oid, size))
                continue
            target = max(targets, key=headroom)
            planned[target.node_id] += size
            by_target.setdefault(target.node_id, []).append((oid, size))
        moved = moved_bytes = 0

        async def source_still_holds(oid: str) -> bool:
            # the owner may free an object mid-drain — only a copy the
            # source STILL holds blocks the hand-off
            try:
                return bool(await client.call("store_contains", oid=oid,
                                              timeout=10.0))
            except Exception:
                return True  # unknown: assume it blocks (fail safe)

        for nid, items in by_target.items():
            node = self.nodes.get(nid)
            if node is None:
                raise RuntimeError(f"target {nid[:12]} died mid-drain")
            tclient = self._node_client(node)
            budget = max(5.0, deadline - time.monotonic())
            res = await tclient.call(
                "ensure_local_batch",
                items=[[oid, [entry.host, entry.port]]
                       for oid, _sz in items],
                timeout=budget)
            held: List[Tuple[str, int]] = []
            for (oid, size), item_res in zip(items,
                                             res.get("results") or ()):
                if item_res.get("ok"):
                    held.append((oid, size))
                elif await source_still_holds(oid):
                    raise RuntimeError(
                        f"sole primary copy {oid[:12]} could not be "
                        f"re-replicated: {item_res.get('error')}")
            if not held:
                continue
            reply = await tclient.call(
                "store_promote", oids=[oid for oid, _sz in held],
                timeout=30.0)
            missing = set(reply.get("missing") or ())
            for oid in missing:
                # vanished between the pull and the promote: legal only
                # if the object was freed everywhere — a copy the source
                # still holds means the hand-off failed
                if await source_still_holds(oid):
                    raise RuntimeError(
                        f"target {nid[:12]} lost copy {oid[:12]} before "
                        f"promote; drain aborted")
            handed = [(oid, sz) for oid, sz in held if oid not in missing]
            if not handed:
                continue
            # findable by every puller: small objects never ride the
            # heartbeat summaries, so the head injects the new holder
            # into the directory itself
            self.dir.apply_delta(nid, [[oid, sz] for oid, sz in handed],
                                 ())
            moved += len(handed)
            moved_bytes += sum(sz for _oid, sz in handed)
        rec["replicated_objects"] = moved
        rec["replicated_bytes"] = moved_bytes

    # ---- chaos fault injection ---------------------------------------------

    async def rpc_chaos(self, op: str, rule: Optional[Dict[str, Any]] = None,
                        seed: int = 0, sites: Optional[List[str]] = None,
                        events_per_site: int = 3, span: int = 100):
        """Cluster-wide fault injection (see fault_injection.py):
        op=inject adds one rule, op=schedule compiles a seed into a
        deterministic per-site failure schedule, op=clear disarms the
        plane, op=status reports the live rule set.  Every mutation
        applies locally (head sites) and gossips the FULL rule set to
        agents — a push for the fast path, the heartbeat reply as the
        catch-up for agents that missed it."""
        from ray_tpu_torch._private import fault_injection

        if not config.chaos_enabled:
            raise RpcError("chaos fault injection is disabled "
                           "(chaos_enabled=False)")
        if op == "inject":
            if not rule:
                raise RpcError("chaos inject needs a rule")
            self._chaos_rules.append(
                fault_injection.ChaosRule.from_wire(rule).to_wire())
        elif op == "schedule":
            self._chaos_rules.extend(fault_injection.make_schedule(
                seed, sites or list(fault_injection.SITES),
                events_per_site=events_per_site, span=span))
        elif op == "clear":
            self._chaos_rules = []
        elif op != "status":
            raise RpcError(f"unknown chaos op {op!r}")
        if op != "status":
            self._chaos_version += 1
            # counts restart with the rule set
            self._telem.clear_chaos_fired()
            fault_injection.install(self._chaos_rules, self._chaos_version)
            self._broadcast_chaos()
            self._maybe_chaos_die()
        # aggregate cluster-wide firing counts: the head's own process
        # plus the latest per-agent heartbeat reports
        fired: Dict[str, int] = dict(fault_injection.fired_counts())
        for counts in self._telem.chaos_fired_counts().values():
            for rid, n in counts.items():
                fired[rid] = fired.get(rid, 0) + int(n)
        rules = [dict(r, fired=fired.get(r.get("rule_id", ""), 0))
                 for r in self._chaos_rules]
        return {"version": self._chaos_version, "rules": rules}

    def _maybe_chaos_die(self) -> None:
        """``head.kill`` chaos site (the agent.kill pattern applied to
        the head): SIGKILL this process after a short delay so the
        inject reply and the rule gossip flush first.  The cluster
        rides the existing GCS fault-tolerance paths — agents
        re-register on their next heartbeat against a restarted head,
        drivers retry inside gcs_reconnect_grace_s (test_gcs_ft.py)."""
        from ray_tpu_torch._private import fault_injection

        chaos = fault_injection.decide("head.kill", key="head")
        if chaos is None or chaos.action != "kill":
            return
        import os
        import signal

        delay = max(chaos.delay_s, 0.2)
        asyncio.get_running_loop().call_later(
            delay, lambda: os.kill(os.getpid(), signal.SIGKILL))

    # ---- poison-task quarantine --------------------------------------------

    def _prune_quarantine(self) -> None:
        """Drop expired quarantines (TTL) — their kill counts restart
        from zero, so a class that still OOMs re-trips after another
        full threshold's worth of kills, not instantly.  UNTRIPPED
        watch entries expire on the same TTL measured from their LAST
        kill: "consecutive" means within a window, not ever — rare
        input-dependent kills spread over days (from short-lived
        drivers whose successes never send ok-reports) must not
        accumulate into a quarantine, and the table stays bounded."""
        now = time.time()
        ttl = float(config.poison_task_ttl_s)
        expired = [k for k, ent in self._poison.items()
                   if (ent.get("until") and now >= ent["until"])
                   or (not ent.get("until")
                       and now - ent.get("last_kill", now) >= ttl)]
        for k in expired:
            self._poison.pop(k, None)
        if expired:
            self._quarantine_version += 1
            self._set_quarantine_gauge()
            self._publish_membership()

    def _set_quarantine_gauge(self) -> None:
        from ray_tpu_torch._private.metrics import memory_pressure_metrics

        memory_pressure_metrics()[2].set(
            sum(1 for e in self._poison.values() if e.get("until")))

    def _quarantine_payload(self) -> Dict[str, Any]:
        """The gossiped enforcement set: only TRIPPED entries (agents
        need nothing for classes still accumulating kills)."""
        return {"version": self._quarantine_version,
                "entries": {k: {"until": e["until"],
                                "detail": e["detail"],
                                "history": e["history"][-8:]}
                            for k, e in self._poison.items()
                            if e.get("until")}}

    def _quarantine_verdict(self, ent: Dict[str, Any]) -> Dict[str, Any]:
        return {"quarantined": bool(ent.get("until")),
                "until": ent.get("until", 0.0),
                "detail": ent.get("detail", ""),
                "history": ent.get("history", [])[-8:]}

    async def rpc_task_kill_report(self, key: str, kind: str = "crash",
                                   name: str = "", node_id: str = ""):
        """An owner's (or this head's, for actors) report that one
        execution of class `key` killed its worker.  Crossing
        ``poison_task_threshold`` consecutive kills trips the
        quarantine; the reply carries the verdict so the reporter can
        fail its next submissions fast without waiting for gossip."""
        self._prune_quarantine()
        ent = self._poison.get(key)
        if ent is None:
            ent = self._poison[key] = {"kills": 0, "history": [],
                                       "until": 0.0, "name": name,
                                       "detail": "", "last_kill": 0.0}
        if name:
            ent["name"] = name
        ent["kills"] += 1
        ent["last_kill"] = time.time()
        ent["history"].append(
            f"{kind} on node {node_id[:12] or '?'} at "
            f"{time.strftime('%H:%M:%S')}")
        del ent["history"][:-32]
        if not ent["until"] and ent["kills"] >= int(
                config.poison_task_threshold):
            ttl = float(config.poison_task_ttl_s)
            ent["until"] = time.time() + ttl
            ent["detail"] = (
                f"task class {ent['name'] or key[:12]!r} is quarantined: "
                f"its executions killed workers {ent['kills']} "
                f"consecutive times across the cluster "
                f"({'; '.join(ent['history'][-int(config.poison_task_threshold):])}); "
                f"expires in {ttl:.0f}s or `rtpu quarantine clear`")
            self._quarantine_version += 1
            self._set_quarantine_gauge()
            self._publish_membership()
            self.publish("error_info", {"kind": "task_quarantined",
                                        "key": key, "name": ent["name"],
                                        "detail": ent["detail"]})
        return self._quarantine_verdict(ent)

    async def rpc_task_ok_report(self, key: str):
        """A real completion of a class with kill history: the
        consecutive-kill count resets.  An ACTIVE quarantine is not
        lifted here (TTL/CLI only) — the success raced the trip."""
        ent = self._poison.get(key)
        if ent is not None and not ent.get("until"):
            self._poison.pop(key, None)
        return {"ok": True}

    async def rpc_quarantine(self, op: str = "list", key: str = ""):
        """`rtpu quarantine` backend: op=list dumps the table (tripped
        AND still-accumulating entries), op=clear lifts one key ("" =
        every tripped entry) immediately."""
        self._prune_quarantine()
        if op == "clear":
            cleared = []
            for k in ([key] if key else
                      [k for k, e in self._poison.items() if e["until"]]):
                if self._poison.pop(k, None) is not None:
                    cleared.append(k)
            if cleared:
                self._quarantine_version += 1
                self._set_quarantine_gauge()
                self._publish_membership()
            return {"cleared": cleared}
        if op != "list":
            raise RpcError(f"unknown quarantine op {op!r}")
        now = time.time()
        return {"entries": {
            k: {"name": e["name"], "kills": e["kills"],
                "quarantined": bool(e["until"]),
                "expires_in_s": round(max(0.0, e["until"] - now), 1)
                if e["until"] else 0.0,
                "history": e["history"][-8:]}
            for k, e in self._poison.items()}}

    def _chaos_payload(self) -> Dict[str, Any]:
        return {"rules": list(self._chaos_rules),
                "version": self._chaos_version}

    def _broadcast_chaos(self) -> None:
        # keep the telemetry plane's heartbeat catch-up in sync with
        # the push: the membership snapshot carries the chaos payload
        self._publish_membership()
        payload = self._chaos_payload()

        async def _push_one(conn):
            try:
                await asyncio.wait_for(conn.push("chaos_rules", payload),
                                       timeout=5.0)
            except Exception:
                pass

        for conn in list(self._node_conns):
            asyncio.ensure_future(_push_one(conn))

    def _cluster_view(self) -> Dict[str, Any]:
        """Per-node resources/labels.  Object locations ride the sharded
        directory's versioned shard updates, not this view.  Draining
        nodes are flagged so agent-side routing (spillback, pick_node)
        stops targeting them within one view push."""
        return {nid: {"addr": [n.host, n.port],
                      "res": n.resources.to_dict(),
                      "labels": n.labels, "xfer": n.xfer_port,
                      **({"draining": True} if n.draining else {}),
                      **({"pressure": n.pressure}
                         if n.pressure is not None else {})}
                for nid, n in self.nodes.items()}

    def on_peer_disconnect(self, conn) -> None:
        node_id = self._node_conns.pop(conn, None)
        if node_id is not None and node_id in self.nodes:
            asyncio.ensure_future(self._on_node_dead(node_id, "connection lost"))
        if conn in self._gapped_driver_conns:
            self._gapped_driver_conns.discard(conn)
            self.mark_dirty()

    async def _health_loop(self):
        period = config.gcs_health_check_period_ms / 1000.0
        threshold = config.gcs_health_check_failure_threshold * period
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for nid in list(self.nodes):
                n = self.nodes.get(nid)
                if n is not None and now - n.last_heartbeat > threshold:
                    await self._on_node_dead(nid, "heartbeat timeout")
            # quarantine TTL expiry used to ride the heartbeat path;
            # beats now land on the telemetry shard, which must not
            # mutate quarantine state — the core sweeps instead.
            # Agents enforce TTLs locally (_quarantined_entry), so the
            # one-period expiry-gossip latency is harmless.
            if self._poison:
                self._prune_quarantine()

    async def _on_node_dead(self, node_id: str, reason: str):
        entry = self.nodes.pop(node_id, None)
        if entry is None:
            return
        # dead node: drop its time series, chaos counts and telemetry
        self._telem.drop_node(node_id)
        self.dir.drop_node(node_id)  # its object copies died with it
        self._cluster_version += 1
        self.mark_dirty()
        self.publish("node_events", {"event": "dead", "node_id": node_id,
                                     "reason": reason})
        self._broadcast_cluster_view()
        if entry.client is not None:
            await entry.client.close()
        # restart or fail every actor that lived on that node
        for actor in list(self.actors.values()):
            if (actor.state in (PENDING, RESTARTING)
                    and actor.sched_node == node_id):
                # an in-flight creation push targets the dead node; the RPC
                # may hang forever (silent host death) — abort the attempt
                # and reschedule without spending the restart budget
                if actor.sched_task is not None:
                    actor.sched_task.cancel()
                self._spawn_scheduler(actor)
            elif actor.node_id == node_id and actor.state in (ALIVE, PENDING):
                await self._on_actor_worker_lost(
                    actor, f"node {node_id[:8]} died: {reason}")
        await self._on_pg_node_dead(node_id)

    # ---- internal KV (function table rides on this) ------------------------

    async def rpc_kv_put(self, key: str, value: bytes, overwrite: bool = True):
        if not overwrite and key in self.kv:
            return {"added": False}
        self.kv[key] = value
        self.mark_dirty()
        return {"added": True}

    async def rpc_kv_get(self, key: str):
        return {"value": self.kv.get(key)}

    async def rpc_kv_del(self, key: str):
        deleted = self.kv.pop(key, None) is not None
        if deleted:
            self.mark_dirty()
        return {"deleted": deleted}

    async def rpc_kv_keys(self, prefix: str = ""):
        return {"keys": [k for k in self.kv if k.startswith(prefix)]}

    # ---- jobs --------------------------------------------------------------

    async def rpc_register_job(self, driver_addr: Optional[List] = None,
                               _conn=None):
        jid = JobID.from_int(self._next_job_int)
        self._next_job_int += 1
        if driver_addr:
            # callback address for the memory aggregator (drivers own
            # most refs but are not pooled by any agent).  A loopback
            # callback registered from a REMOTE peer would have the head
            # dial its OWN loopback, not the driver: record nothing and
            # mark the join gapped, so the unreachable driver's refs are
            # a known gap rather than false dead_owner leaks.  Dead
            # drivers are pruned by the scan fan-out (_drop_driver); the
            # cap is a backstop against registration floods, and
            # evicting a possibly-LIVE driver poisons the ownership
            # join, so an eviction (pathological: >256 concurrent
            # drivers) likewise marks memory views partial from then on
            # — absence-of-owner can no longer be trusted as a death
            # signal.
            peer = (_conn.writer.get_extra_info("peername")
                    if _conn is not None else None)
            sock = (_conn.writer.get_extra_info("sockname")
                    if _conn is not None else None)
            # same-machine drivers CAN be dialed back on loopback even
            # when they reached the head via its LAN address — and a
            # local connection to the machine's own LAN IP bears that
            # IP on BOTH endpoints, so peer==sock host means local
            if (is_loopback(driver_addr[0]) and peer
                    and not is_loopback(peer[0])
                    and not (sock and peer[0] == sock[0])):
                # gap scoped to the driver's connection: cleared when it
                # disconnects (its refs die with it), so one remote
                # driver doesn't disable leak detection forever
                if _conn is not None:
                    self._gapped_driver_conns.add(_conn)
                else:
                    self._driver_join_gap = True
            else:
                self.driver_addrs[jid.hex()] = (driver_addr[0],
                                                driver_addr[1])
                while len(self.driver_addrs) > 256:
                    j, a = next(iter(self.driver_addrs.items()))
                    self._driver_join_gap = True
                    self._drop_driver(j, a)
        self.mark_dirty()
        return {"job_id": jid.hex()}

    # ---- actor manager -----------------------------------------------------

    async def rpc_create_actor(self, spec: Dict[str, Any], name: str = "",
                               method_num_returns: Optional[Dict] = None):
        ts = TaskSpec.from_wire(spec)
        existing = self.actors.get(ts.actor_id)
        if existing is not None:
            # duplicate submission (client retried across a dropped reply,
            # e.g. a head restart): the id is client-generated, so this is
            # the SAME actor — don't double-create
            return {"actor_id": ts.actor_id}
        if name:
            if self.named_actors.get(name) not in (None, ts.actor_id):
                raise RpcError(f"actor name {name!r} already taken")
            self.named_actors[name] = ts.actor_id
        entry = _ActorEntry(ts.actor_id, spec, name, ts.max_restarts)
        entry.method_num_returns = dict(method_num_returns or {})
        self.actors[ts.actor_id] = entry
        self.mark_dirty()
        self._spawn_scheduler(entry)
        return {"actor_id": ts.actor_id}

    async def rpc_get_actor_info(self, actor_id: str, wait: bool = False,
                                 known_instance: int = -1):
        """Resolve an actor's address; with wait=True, long-poll until the
        actor leaves PENDING/RESTARTING (or is a newer instance than the
        caller already knows about)."""
        entry = self.actors.get(actor_id)
        if entry is None:
            return {"state": DEAD, "death_cause": "no such actor"}
        deadline = time.monotonic() + config.pubsub_poll_timeout_ms / 1000.0
        while wait and time.monotonic() < deadline:
            if entry.state == DEAD:
                break
            if entry.state == ALIVE and entry.instance > known_instance:
                break
            ev = asyncio.Event()
            entry.waiters.append(ev)
            try:
                await asyncio.wait_for(ev.wait(), deadline - time.monotonic())
            except asyncio.TimeoutError:
                break
        return entry.info()

    async def rpc_get_named_actor(self, name: str):
        aid = self.named_actors.get(name)
        if aid is None:
            return {"found": False}
        entry = self.actors.get(aid)
        return {"found": True, "actor_id": aid,
                "method_num_returns":
                    entry.method_num_returns if entry else {}}

    async def rpc_list_actors(self):
        return {"actors": [a.info() for a in self.actors.values()]}

    async def rpc_kill_actor(self, actor_id: str, no_restart: bool = True):
        entry = self.actors.get(actor_id)
        if entry is None:
            return {"ok": False}
        self.mark_dirty()
        if no_restart:
            entry.restarts_left = 0
            entry.kill_requested = True
        if entry.state == ALIVE and entry.addr is not None:
            client = RpcClient(entry.addr[0], entry.addr[1], label="kill")
            try:
                await client.oneway("exit_worker")
            except Exception:
                pass
            finally:
                await client.close()
        elif entry.state in (PENDING, RESTARTING) and no_restart:
            # creation still in flight: _schedule_actor checks
            # kill_requested after the push and tears the instance down
            entry.state = DEAD
            entry.death_cause = "killed before creation completed"
            if entry.name:
                self.named_actors.pop(entry.name, None)
            entry.wake()
        return {"ok": True}

    async def rpc_worker_died(self, node_id: str, worker_id: str,
                              reason: str = "",
                              oom: Optional[Dict[str, Any]] = None):
        """Node agent reports a worker process death.  ``oom`` is the
        watchdog's kill receipt when the death was a deliberate
        memory-pressure kill: an OOM-killed ACTOR counts toward its
        class's poison quarantine here (normal tasks are counted by
        their owners, which know exactly which task was running)."""
        self.publish("error_info", {"kind": "worker_died",
                                    "node_id": node_id,
                                    "worker_id": worker_id, "reason": reason})
        for actor in list(self.actors.values()):
            if actor.worker_id == worker_id and actor.state in (ALIVE, PENDING):
                if oom is not None:
                    from ray_tpu_torch._private.memory_monitor import \
                        is_self_poisoning

                    # same self-poisoning gate the owners apply to task
                    # kills: aggregate-pressure victims don't count
                    fid = actor.spec_wire.get("fid", "")
                    if fid and is_self_poisoning(
                            int(oom.get("rss", 0)),
                            int(oom.get("limit", 0))):
                        await self.rpc_task_kill_report(
                            key=fid, kind="oom",
                            name=actor.spec_wire.get("name", ""),
                            node_id=node_id)
                await self._on_actor_worker_lost(
                    actor, reason or f"worker {worker_id[:8]} died")
        return {"ok": True}

    async def _on_actor_worker_lost(self, actor: _ActorEntry, cause: str):
        self.mark_dirty()
        if actor.state == RESTARTING:
            # a restart is already in flight (_schedule_actor retries node
            # failures itself); a second concurrent reschedule would double
            # -decrement restarts_left and leak a live instance on a lease
            return
        if actor.restarts_left == 0:
            actor.state = DEAD
            actor.death_cause = cause
            if actor.name:
                self.named_actors.pop(actor.name, None)
            self.publish("actor_events", {
                "actor_id": actor.actor_id, "state": "DEAD",
                "name": actor.name, "cause": cause})
            actor.wake()
            return
        if actor.restarts_left > 0:
            actor.restarts_left -= 1
        actor.state = RESTARTING
        from ray_tpu_torch._private.metrics import fault_tolerance_metrics

        fault_tolerance_metrics()[0].inc()
        self.publish("actor_events", {
            "actor_id": actor.actor_id, "state": "RESTARTING",
            "name": actor.name, "cause": cause})
        actor.wake()
        self._spawn_scheduler(actor)

    def _spawn_scheduler(self, actor: _ActorEntry):
        """Start a new scheduling attempt, invalidating any older one."""
        actor.sched_gen += 1
        actor.sched_node = ""
        asyncio.ensure_future(self._schedule_actor(actor, actor.sched_gen))

    async def _schedule_actor(self, actor: _ActorEntry, gen: int = 0):
        """Pick a node, lease a worker there, push the creation task.

        Only the coroutine holding the actor's current sched_gen may mutate
        its state — a newer attempt (spawned by worker/node death handlers)
        silently retires this one.

        Reference: gcs_actor_scheduler.h — GCS leases workers from raylets
        using the same protocol normal tasks do.
        """
        gen = gen or actor.sched_gen
        actor.sched_task = asyncio.current_task()
        ts = TaskSpec.from_wire(actor.spec_wire)
        demand = ts.resource_set()
        delay = 0.05
        if ts.placement_group_id:
            # waiting for the group to be placed must not consume the
            # creation retry budget — PGs may stay PENDING for a while
            while True:
                if (actor.kill_requested or actor.state == DEAD
                        or actor.sched_gen != gen):
                    return
                pg = self.placement_groups.get(ts.placement_group_id)
                if pg is None:
                    actor.state = DEAD
                    actor.death_cause = "placement group removed"
                    actor.wake()
                    return
                if max(ts.bundle_index, 0) >= len(pg.bundles):
                    actor.state = DEAD
                    actor.death_cause = (
                        f"bundle index {ts.bundle_index} out of range for "
                        f"{len(pg.bundles)}-bundle placement group")
                    actor.wake()
                    return
                if pg.state == PG_CREATED:
                    break
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)
        attempt = 0
        while attempt <= config.actor_creation_retries:
            attempt += 1
            if (actor.kill_requested or actor.state == DEAD
                    or actor.sched_gen != gen):
                return
            if ts.placement_group_id:
                pg = self.placement_groups.get(ts.placement_group_id)
                if pg is None or pg.state != PG_CREATED:
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 2.0)
                    continue
                nid = pg.placements[max(ts.bundle_index, 0)]
            else:
                # draining nodes accept no new actors — their leases are
                # being quiesced and the node is about to terminate
                cluster = {nid: n.resources for nid, n in self.nodes.items()
                           if not n.draining}
                nid = pick_node(
                    cluster, demand, local_node_id="",
                    strategy=ts.scheduling_strategy,
                    labels_by_node={nid: n.labels
                                    for nid, n in self.nodes.items()},
                    pressure_by_node={nid: n.pressure
                                      for nid, n in self.nodes.items()
                                      if n.pressure is not None},
                    pressure_threshold=float(config.memory_usage_threshold))
            if nid is None:
                from ray_tpu_torch._private.node_agent import _is_hard_strategy

                if (not _is_hard_strategy(ts.scheduling_strategy)
                        and any(ResourceSet(s).fits(demand)
                                for s in self._scalable_shapes())):
                    # an autoscaler can launch a node this actor fits:
                    # keep the actor PENDING (visible via autoscaler_state)
                    # without spending the creation budget (reference:
                    # pending actors resolve via the autoscaler demand
                    # loop).  Hard affinity/label strategies are exempt —
                    # scale-up can never mint the specific node they name,
                    # so they burn the budget and die.
                    attempt -= 1
                # woken early by a node registration (an autoscaled
                # node arriving for exactly this demand), else backoff
                await self._wait_actor_event(delay)
                delay = min(delay * 2, 2.0)
                continue
            node = self.nodes.get(nid)
            if node is None:
                continue
            # optimistic accounting: deduct the demand from the cached
            # availability view NOW (pick_node → acquire is atomic on
            # this loop), so concurrent creations — e.g. serve deploying
            # N replicas — see each other's placements.  Without it
            # SPREAD runs against identical stale views and packs every
            # replica onto one node, which defeats fault isolation.  The
            # next heartbeat restores ground truth either way; deduction
            # is skipped for PG-bundled actors (they draw from reserved
            # bundles, not the free pool).
            deducted = (not ts.placement_group_id
                        and node.resources.acquire(demand))
            from ray_tpu_torch._private import fault_injection

            chaos = fault_injection.decide("lease.grant",
                                           key=actor.actor_id)
            if chaos is not None and chaos.action == "delay":
                await fault_injection.sleep_async(chaos.delay_s)
            try:
                lease = await self._node_client(node).call(
                    "request_lease", spec=actor.spec_wire, grant_only=True,
                    timeout=config.worker_lease_timeout_ms / 1000.0)
            except Exception:
                if deducted:
                    node.resources.release(demand)
                await asyncio.sleep(delay)
                continue
            if "granted" not in lease:
                if deducted:
                    node.resources.release(demand)
                if lease.get("error") in ("runtime env setup failed",
                                          "poisoned"):
                    # deterministic failures: retrying other nodes cannot
                    # fix a missing env package or an actively-quarantined
                    # class — fail fast with the refusal's detail
                    actor.state = DEAD
                    actor.death_cause = lease.get(
                        "error_str", lease["error"])
                    if actor.name:
                        self.named_actors.pop(actor.name, None)
                    actor.wake()
                    return
                await asyncio.sleep(delay)
                continue
            g = lease["granted"]

            async def _drop_lease():
                try:
                    await self._node_client(node).call(
                        "return_lease", lease_id=g["lease_id"], kill_worker=True)
                except Exception:
                    pass

            # push the creation task directly to the leased worker; a
            # constructor may legitimately run for a long time (model
            # load), so use the task-push timeout, not the RPC default
            wclient = RpcClient(g["addr"][0], g["addr"][1], label="actor-create")
            actor.sched_node = nid
            try:
                reply = await wclient.call(
                    "push_task", spec=actor.spec_wire, instance=actor.instance + 1,
                    gpu_ids=g.get("gpu_ids"),
                    timeout=7 * 86400.0)
                if reply.get("error"):
                    raise RpcError(f"actor constructor failed: {reply['error_str']}")
            except asyncio.CancelledError:
                # a node-death handler aborted this attempt and respawned a
                # fresh one; the lease died with the node
                await wclient.close()
                return
            except RpcError as e:
                await wclient.close()
                await _drop_lease()
                if actor.sched_gen != gen:
                    return
                # constructor raised: do not retry onto other nodes
                actor.state = DEAD
                actor.death_cause = str(e)
                if actor.name:
                    self.named_actors.pop(actor.name, None)
                actor.wake()
                return
            except Exception:
                # transport failure: give the lease back before retrying
                await wclient.close()
                await _drop_lease()
                if actor.sched_gen != gen:
                    return
                await asyncio.sleep(delay)
                continue
            finally:
                if actor.sched_gen == gen:
                    # only the owning generation may clear the in-flight
                    # marker — a retired one would clobber the live attempt
                    actor.sched_node = ""
            await wclient.close()
            if actor.sched_gen != gen:
                # a newer scheduling attempt owns this actor now; this
                # instance is orphaned — tear it down
                await _drop_lease()
                return
            if actor.kill_requested:
                # killed while the constructor ran: tear the instance down
                actor.state = DEAD
                actor.death_cause = actor.death_cause or "killed during creation"
                if actor.name:
                    self.named_actors.pop(actor.name, None)
                actor.wake()
                await _drop_lease()
                return
            actor.state = ALIVE
            actor.instance += 1
            actor.node_id = nid
            actor.worker_id = g["worker_id"]
            actor.addr = (g["addr"][0], g["addr"][1])
            self.mark_dirty()
            self.publish("actor_events", {
                "actor_id": actor.actor_id, "state": "ALIVE",
                "name": actor.name, "node_id": nid})
            actor.wake()
            return
        actor.state = DEAD
        actor.death_cause = "actor creation failed: no feasible node"
        self.mark_dirty()
        if actor.name:
            self.named_actors.pop(actor.name, None)
        actor.wake()

    def _node_client(self, node: _NodeEntry) -> RpcClient:
        if node.client is None or node.client.dead:
            node.client = RpcClient(node.host, node.port, label=f"agent-{node.node_id[:8]}")
        return node.client

    # ---- placement groups --------------------------------------------------

    async def rpc_create_placement_group(self, bundles: List[Dict[str, float]],
                                         strategy: str = "PACK",
                                         name: str = "", pg_id: str = ""):
        from ray_tpu_torch._private.ids import PlacementGroupID

        if pg_id and pg_id in self.placement_groups:
            # duplicate submission (client retried across a dropped
            # reply): ids are client-generated, dedup instead of leaking
            # a second group holding bundles forever
            return {"pg_id": pg_id}
        pg_id = pg_id or PlacementGroupID.from_random().hex()
        entry = _PgEntry(pg_id, bundles, strategy, name)
        self.placement_groups[pg_id] = entry
        self.mark_dirty()
        # one inline scheduling pass before replying: for the common
        # create-then-ready pattern the follow-up get_placement_group
        # then answers CREATED immediately with no waiter park/wake
        # cycle (PG churn is a benchmarked hot path); a group that
        # doesn't fit right now falls back to the event-driven loop.
        # inline=True: this pass must not block the create reply behind
        # a reservation queue wait on a saturated cluster
        await self._schedule_pg(entry, max_attempts=1, inline=True)
        if entry.state == PG_PENDING:
            asyncio.ensure_future(self._schedule_pg(entry))
        # the reply carries the full info when the inline pass already
        # committed the group: the client's ready()/wait() then answers
        # from this snapshot with ZERO further round trips — on the PG
        # churn path that removes one of the three driver RPCs
        return {"pg_id": pg_id, "info": entry.info(self.nodes)}

    async def rpc_get_placement_group(self, pg_id: str, wait: bool = False,
                                      wait_s: Optional[float] = None):
        entry = self.placement_groups.get(pg_id)
        if entry is None:
            return {"state": PG_REMOVED, "failure": "no such placement group"}
        poll = min(wait_s if wait_s is not None else 1e9,
                   config.pubsub_poll_timeout_ms / 1000.0)
        deadline = time.monotonic() + poll
        while wait and entry.state == PG_PENDING and time.monotonic() < deadline:
            ev = asyncio.Event()
            entry.waiters.append(ev)
            try:
                await asyncio.wait_for(ev.wait(), deadline - time.monotonic())
            except asyncio.TimeoutError:
                break
            finally:
                if ev in entry.waiters:  # drop unfired waiters (leak guard)
                    entry.waiters.remove(ev)
        return entry.info(self.nodes)

    async def rpc_remove_placement_group(self, pg_id: str):
        entry = self.placement_groups.pop(pg_id, None)
        if entry is None:
            return {"ok": False}
        entry.state = PG_REMOVED
        self.mark_dirty()
        entry.wake()
        # one return_bundles frame per node instead of one RPC per
        # bundle (the release half of the batched PG commit path)
        by_node: Dict[str, List[int]] = {}
        for idx, nid in enumerate(entry.placements):
            if nid is not None:
                by_node.setdefault(nid, []).append(idx)
        for nid, idxs in by_node.items():
            node = self.nodes.get(nid)
            if node is None:
                continue
            try:
                await self._node_client(node).call(
                    "return_bundles", pg_id=pg_id, indices=idxs)
            except Exception:
                pass
            # update the cached view immediately — the next PG create
            # must not wait out a heartbeat period to see the freed
            # capacity (heartbeats remain authoritative and overwrite)
            for idx in idxs:
                node.resources.release(ResourceSet(entry.bundles[idx]))
        self._wake_pending_pgs()
        return {"ok": True}

    async def rpc_list_placement_groups(self):
        return {"placement_groups": [
            e.info(self.nodes) for e in self.placement_groups.values()]}

    def _plan_pg(self, entry: _PgEntry,
                 optimistic: bool = False) -> Optional[List[str]]:
        """Choose a node per bundle per strategy, against a scratch copy of
        the cluster view (all-or-nothing; reference:
        bundle_scheduling_policy.h pack/spread/strict variants).

        ``optimistic`` plans against node totals *minus committed PG
        bundles* instead of the cached availability view: the view lags
        reality by up to a heartbeat period (freed task leases, returned
        bundles), so when no node looks available the head still targets
        a feasible node and lets the agent-side queued reservation
        (rpc_reserve_bundle wait_ms) wait out the staleness.  Committed
        bundles are permanent carve-outs, never staleness — ignoring
        them would queue unsatisfiable reservations that head-of-line
        block the node's lease queue."""
        scratch: Dict[str, NodeResources] = {
            nid: (NodeResources(n.resources.total) if optimistic
                  else NodeResources.from_dict(
                      {"total": n.resources.total.to_dict(),
                       "available": n.resources.available.to_dict()}))
            for nid, n in self.nodes.items() if not n.draining
        }
        if optimistic:
            for pg in self.placement_groups.values():
                for idx, nid in enumerate(pg.placements):
                    if nid is not None and nid in scratch:
                        scratch[nid].acquire(ResourceSet(pg.bundles[idx]))
        plan: List[Optional[str]] = []
        used_nodes: List[str] = []
        for idx, bundle in enumerate(entry.bundles):
            existing = entry.placements[idx]
            if existing is not None and existing in scratch:
                # bundle already reserved there (rescheduling after a node
                # death replaces only the lost bundles)
                plan.append(existing)
                used_nodes.append(existing)
                continue
            demand = ResourceSet(bundle)
            candidates = [(nid, nr) for nid, nr in scratch.items()
                          if nr.can_fit(demand)]
            if entry.strategy in ("STRICT_SPREAD",):
                candidates = [(nid, nr) for nid, nr in candidates
                              if nid not in used_nodes]
            if not candidates:
                return None
            if entry.strategy in ("PACK", "STRICT_PACK") and used_nodes:
                packed = [c for c in candidates if c[0] == used_nodes[-1]]
                if packed:
                    candidates = packed
                elif entry.strategy == "STRICT_PACK":
                    return None
            if entry.strategy == "SPREAD":
                # prefer nodes not already used, then least utilized
                candidates.sort(key=lambda kv: (kv[0] in used_nodes,
                                                kv[1].utilization()))
            else:
                candidates.sort(key=lambda kv: kv[1].utilization())
            nid, nr = candidates[0]
            nr.acquire(demand)
            plan.append(nid)
            used_nodes.append(nid)
        return plan

    def _wake_pending_pgs(self) -> None:
        """Resources may have freed: replan every waiting PG right now."""
        if not self._pg_wake_waiters:
            return
        waiters, self._pg_wake_waiters = self._pg_wake_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(True)

    def _wake_pending_actors(self) -> None:
        """Fresh capacity registered: parked actor schedulers retry now."""
        if not self._actor_wake_waiters:
            return
        waiters, self._actor_wake_waiters = self._actor_wake_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(True)

    async def _wait_actor_event(self, timeout: float) -> None:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._actor_wake_waiters.append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            if fut in self._actor_wake_waiters:
                self._actor_wake_waiters.remove(fut)

    async def _wait_pg_event(self, timeout: float) -> bool:
        """Wait for a resource-release wake, or timeout. True if woken."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pg_wake_waiters.append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            if fut in self._pg_wake_waiters:
                self._pg_wake_waiters.remove(fut)

    async def _schedule_pg(self, entry: _PgEntry, max_attempts: int = 0,
                           inline: bool = False):
        """Keep trying until reserved or removed.  Like the reference, a
        group that doesn't currently fit stays PENDING indefinitely (the
        autoscaler is what resolves persistent infeasibility).

        Retries are event-driven: a failed attempt parks on
        _wait_pg_event and is woken by heartbeats/bundle returns/node
        registrations, with sleep backoff only as the fallback.
        ``max_attempts`` > 0 bounds the passes; ``inline`` marks the
        fast path inside create, which must never block the reply — it
        reserves with no queue wait and leaves the one-shot optimistic
        full-wait budget to the event-driven loop."""
        delay = 0.05
        attempts = 0
        while entry.state == PG_PENDING \
                and self.placement_groups.get(entry.pg_id) is entry:
            attempts += 1
            plan = self._plan_pg(entry)
            # an availability-backed plan always reserves with a wait:
            # the view can be stale the other way (shows available, node
            # briefly isn't — lingering leases), and a queued reservation
            # grants the moment the agent reclaims them
            wait_ms = 0 if inline else int(config.pg_reserve_wait_ms)
            if plan is None:
                # the availability view may simply be stale (lingering
                # leases just returned, heartbeat not in yet): target
                # feasible nodes and let the reservation queue there —
                # but a totals-based plan can also target genuinely
                # occupied capacity, so only the FIRST such attempt may
                # block the node's lease queue for the full wait
                plan = self._plan_pg(entry, optimistic=True)
                if inline or entry.opt_wait_used:
                    wait_ms = 0
                elif plan is not None:
                    entry.opt_wait_used = True
            ok = False
            if plan is not None:
                ok, newly = await self._reserve_pg(entry, plan, wait_ms)
                if ok:
                    removed = entry.state != PG_PENDING
                    # a plan node may have died between the last reserve
                    # RPC and now — committing CREATED then would strand
                    # the group (the death event is already consumed)
                    lost_node = any(nid not in self.nodes for nid in plan)
                    if removed or lost_node:
                        for idx, nid in enumerate(plan):
                            node = self.nodes.get(nid)
                            if node is not None:
                                try:
                                    await self._node_client(node).call(
                                        "return_bundle", pg_id=entry.pg_id,
                                        bundle_index=idx)
                                except Exception:
                                    pass
                        if removed:
                            return
                        entry.placements = [None] * len(entry.bundles)
                        continue  # replan from scratch
                    # reflect the reservation in the cached view at once
                    # (heartbeats remain authoritative and overwrite);
                    # only bundles reserved by THIS attempt — pre-existing
                    # ones were accounted when first committed
                    for idx in newly:
                        node = self.nodes.get(plan[idx])
                        if node is not None:
                            node.resources.acquire(
                                ResourceSet(entry.bundles[idx]))
                    entry.placements = plan
                    entry.state = PG_CREATED
                    self.mark_dirty()
                    entry.wake()
                    return
            if max_attempts and attempts >= max_attempts:
                return
            woke = await self._wait_pg_event(delay)
            delay = 0.05 if woke else min(delay * 2, 1.0)

    async def _reserve_pg(self, entry: _PgEntry, plan: List[str],
                          wait_ms: int = 0):
        """Reserve every bundle; roll back on any failure (all-or-nothing —
        the TPU-slice gang atomicity guarantee).  Returns
        (ok, newly_reserved_bundle_indices).

        All of a node's bundles ride ONE reserve_bundles frame: an
        N-host slice costs O(nodes) commit round trips, not O(bundles)
        (ISSUE 8 satellite — PG commits batch along the lease-frame
        path)."""
        newly_reserved: List[int] = []
        ok = True
        by_node: List[Tuple[str, List[int]]] = []
        for idx, nid in enumerate(plan):
            if by_node and by_node[-1][0] == nid:
                by_node[-1][1].append(idx)
            else:
                by_node.append((nid, [idx]))
        for nid, idxs in by_node:
            if not ok:
                break
            node = self.nodes.get(nid)
            if node is None:
                ok = False
                break
            try:
                r = await self._node_client(node).call(
                    "reserve_bundles", pg_id=entry.pg_id,
                    items=[[i, entry.bundles[i]] for i in idxs],
                    wait_ms=wait_ms)
                results = list(r.get("results") or [])
            except Exception:
                results = []
                # the RPC failed on OUR side (connection drop) but the
                # agent-side handler may still be waiting — or may grant
                # later; make sure nothing stays carved out for an
                # attempt we are abandoning (best-effort: the agent also
                # rolls back grants whose caller connection closed)
                for i in idxs:
                    asyncio.ensure_future(self._abort_bundle_reservation(
                        nid, entry.pg_id, i))
            results += [{"ok": False}] * (len(idxs) - len(results))
            for i, rr in zip(idxs, results):
                if not rr.get("ok"):
                    ok = False
                    break
                if not rr.get("already"):
                    # only bundles reserved by THIS attempt may be rolled
                    # back; pre-existing ones carry live workloads
                    newly_reserved.append(i)
        if ok:
            return True, newly_reserved
        rollback: Dict[str, List[int]] = {}
        for idx in newly_reserved:
            rollback.setdefault(plan[idx], []).append(idx)
        for nid, idxs in rollback.items():
            node = self.nodes.get(nid)
            if node is not None:
                try:
                    await self._node_client(node).call(
                        "return_bundles", pg_id=entry.pg_id, indices=idxs)
                except Exception:
                    pass
        return False, []

    async def _abort_bundle_reservation(self, nid: str, pg_id: str,
                                        bundle_index: int):
        node = self.nodes.get(nid)
        if node is None:
            return
        try:
            await self._node_client(node).call(
                "cancel_bundle_reservation", pg_id=pg_id,
                bundle_index=bundle_index)
        except Exception:
            pass

    async def _on_pg_node_dead(self, node_id: str):
        """Bundles on a dead node are re-reserved elsewhere (non-strict) or
        the whole group goes back to PENDING."""
        for entry in self.placement_groups.values():
            if entry.state == PG_CREATED and node_id in entry.placements:
                entry.state = PG_PENDING
                self.mark_dirty()
                for idx, nid in enumerate(entry.placements):
                    if nid == node_id:
                        entry.placements[idx] = None
                asyncio.ensure_future(self._schedule_pg(entry))

    # ---- metrics + task events (observability plane) -----------------------

    async def _start_metrics(self, host: str) -> None:
        """Prometheus endpoint with control-plane gauges
        (reference: stats/metric_defs.cc via the reporter agent)."""
        from ray_tpu_torch._private.metrics import (Gauge, Histogram,
                                              default_registry,
                                              start_metrics_http_server)

        nodes_g = Gauge("rt_head_nodes", "live nodes in the cluster")
        actors_g = Gauge("rt_head_actors", "actors by state")
        pgs_g = Gauge("rt_head_placement_groups", "placement groups by state")
        tasks_g = Gauge("rt_head_task_events", "task event records held")
        traces_g = Gauge("rt_head_traces", "traces held in the trace store")
        # per-phase task latency derived from the task-event timestamps:
        # queued (submitted→leased), leased (leased→running, i.e. the
        # push/dispatch leg), running (running→finished) — the breakdown
        # the MPMD-pipeline papers need for diagnosing stage stalls
        self._sched_hist = Histogram(
            "ray_tpu_task_sched_latency_seconds",
            "task scheduling latency by phase",
            boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1,
                        5, 30])
        # fed by the task-event plane on its own loop (Histogram is
        # internally locked, so cross-thread observes are safe)
        self._ev_plane.sched_hist = self._sched_hist

        from ray_tpu_torch._private.metrics import autoscaler_metrics

        as_nodes_g, _as_events, _as_drain = autoscaler_metrics()

        def collect():
            nodes_g.set(len(self.nodes))
            draining = sum(1 for n in self.nodes.values() if n.draining)
            as_nodes_g.set(len(self.nodes) - draining,
                           tags={"state": "running"})
            as_nodes_g.set(draining, tags={"state": "draining"})
            as_nodes_g.set(
                float(self._autoscaler_status.get("pending_launches", 0)),
                tags={"state": "pending_launch"})
            # seed every state with 0 so a series whose count drops to
            # zero reports 0 instead of its stale last value
            states = {s: 0 for s in (PENDING, ALIVE, RESTARTING, DEAD)}
            for a in self.actors.values():
                states[a.state] = states.get(a.state, 0) + 1
            for s, n in states.items():
                actors_g.set(n, tags={"state": s})
            pstates = {s: 0 for s in (PG_PENDING, PG_CREATED, PG_REMOVED)}
            for p in self.placement_groups.values():
                pstates[p.state] = pstates.get(p.state, 0) + 1
            for s, n in pstates.items():
                pgs_g.set(n, tags={"state": s})
            ev = self._ev_plane.stats.payload
            tasks_g.set(ev["num_events"])
            traces_g.set(ev["num_traces"])

        # keep the handle so stop() can deregister: the closure pins the
        # whole head in the process-lifetime registry otherwise (the
        # in-process test harnesses would leak every head ever started)
        self._metrics_collector = collect
        default_registry.add_collector(collect)
        try:
            from ray_tpu_torch._private import dashboard as _dash

            # /api/stack and /api/profile fan out over RPC: async route
            # handlers awaited by the server, with the query string
            # passed through (wants_query)
            def stack_route(query: str = ""):
                return self._http_stack(query)

            stack_route.wants_query = True

            def profile_route(query: str = ""):
                return self._http_profile(query)

            profile_route.wants_query = True

            def memory_route(query: str = ""):
                return self._http_memory(query)

            memory_route.wants_query = True
            self._metrics_server, self.metrics_port = \
                await start_metrics_http_server(
                    default_registry, host,
                    extra_routes={
                        "/": lambda: ("text/html",
                                      _dash.APP_HTML.encode()),
                        "/app.js": lambda: ("application/javascript",
                                            _dash.APP_JS.encode()),
                        "/api/state": self._render_state_json,
                        "/api/snapshot": self._render_snapshot_json,
                        "/api/timeline": self._render_timeline_json,
                        "/api/traces": self._render_traces_json,
                        # trailing slash = prefix route: the suffix is
                        # passed in (/api/traces/<trace_id>)
                        "/api/traces/": self._render_one_trace_json,
                        "/api/timeseries": self._render_timeseries_json,
                        "/api/stack": stack_route,
                        "/api/profile": profile_route,
                        "/api/memory": memory_route,
                        "/api/summary": self._render_summary_json,
                        "/api/autoscaler": self._render_autoscaler_json,
                    })
            self._dash_task = asyncio.ensure_future(self._dash_sample_loop())
        except Exception:
            self.metrics_port = 0  # observability must never block boot

    def _state_snapshot(self) -> Dict[str, Any]:
        actors = {}
        for a in self.actors.values():
            actors[a.state] = actors.get(a.state, 0) + 1
        return {
            "nodes": [n.table_entry() for n in self.nodes.values()],
            "actors_by_state": actors,
            "num_placement_groups": len(self.placement_groups),
            "num_task_events": self._ev_plane.stats.payload["num_events"],
            "kv_keys": len(self.kv),
        }

    def _render_state_json(self):
        import json as _json

        return "application/json", _json.dumps(self._state_snapshot(),
                                               default=str).encode()

    # ---- dashboard SPA data plane (reference: dashboard/ API routes
    # consumed by the React client; here /api/snapshot feeds the
    # single-file app in _private/dashboard.py) ---------------------------

    def _cpu_totals(self) -> Tuple[float, float]:
        avail = total = 0.0
        for n in self.nodes.values():
            total += n.resources.total.get("CPU")
            avail += n.resources.available.get("CPU")
        return avail, total

    def _tasks_finished_total(self) -> int:
        # monotonic terminal-transition count published by the task-
        # event plane — unlike the old store walk it cannot dip when
        # old records roll off the cap
        return int(self._ev_plane.stats.payload["finished_total"])

    async def _dash_sample_loop(self):
        """Every 2s append one sample to the sparkline ring (~5 min),
        and fold the head's own gauges into the time-series store next
        to the per-agent heartbeat summaries."""
        last_finished = self._tasks_finished_total()
        while True:
            await asyncio.sleep(2.0)
            try:
                avail, total = self._cpu_totals()
                finished = self._tasks_finished_total()
                task_rate = max(0, finished - last_finished)
                self._dash_series.append({
                    "ts": time.time(),
                    "nodes": len(self.nodes),
                    "cpus_avail": avail,
                    "actors_alive": sum(1 for a in self.actors.values()
                                        if a.state == ALIVE),
                    "task_rate": task_rate,
                })
                last_finished = finished
                now = time.time()
                ts = self._telem.ts_record
                ts("head", "loop_lag_seconds", self._head_loop_lag, now)
                ts("head", "nodes", len(self.nodes), now)
                ts("head", "cpus_avail", avail, now)
                ts("head", "task_rate", task_rate, now)
                if self.shards is not None and self.shards.sharded:
                    # per-shard ingest-loop lag beside the head's own:
                    # `rtpu status --watch` sparklines show which plane
                    # is hot without a metrics scrape
                    ts("head", "shard_lag_task_events",
                       self.shards.task_events.loop_lag, now)
                    ts("head", "shard_lag_telemetry",
                       self.shards.telemetry.loop_lag, now)
            except Exception:
                pass

    async def _render_snapshot_json(self):
        import json as _json

        # record/trace copies are made ON the task-event plane's loop
        # (run_sync) — its merge mutates records in place, so reading
        # live dicts from this loop could tear mid-serialization
        recent, traces = await self.shards.task_events.run_sync(
            lambda: (self._ev_plane.recent_records(200),
                     self._ev_plane.trace_store.summaries(50)))
        jobs = []
        try:
            idx = self.kv.get("job:index")
            for job_id in _json.loads(idx) if idx else []:
                raw = self.kv.get(f"job:{job_id}:status")
                if raw:
                    jobs.append(_json.loads(raw))
        except Exception:
            pass
        avail, total = self._cpu_totals()
        snap = {
            "nodes": [n.table_entry() for n in self.nodes.values()],
            "actors": [a.info() for a in self.actors.values()],
            "tasks": recent,
            "placement_groups": [p.info(self.nodes)
                                 for p in self.placement_groups.values()],
            "jobs": jobs,
            "traces": traces,
            "series": list(self._dash_series),
            "autoscaler": self._autoscaler_view(),
            "shards": self._shard_info(),
            "summary": {
                "cpus_avail": round(avail, 2), "cpus_total": round(total, 2),
                "actors_alive": sum(1 for a in self.actors.values()
                                    if a.state == ALIVE),
                "task_rate": (self._dash_series[-1]["task_rate"]
                              if self._dash_series else 0),
            },
        }
        return "application/json", _json.dumps(snap, default=str).encode()

    def _shard_info(self) -> Dict[str, Any]:
        """Shard topology + per-loop lag for the dashboard and `rtpu
        status`: which ingest planes exist, whether they run on their
        own threads, and how laggy each loop currently is."""
        if self.shards is None:
            return {"count": 0, "planes": {}}
        ev = self._ev_plane.stats.payload
        return {
            "count": self.shards.count,
            "planes": {
                "task_events": {
                    "own_thread": self.shards.task_events.own_thread,
                    "lag_s": round(self.shards.task_events.loop_lag, 4),
                    "events": ev["num_events"],
                    "dropped": ev["dropped_total"],
                },
                "telemetry": {
                    "own_thread": self.shards.telemetry.own_thread,
                    "lag_s": round(self.shards.telemetry.loop_lag, 4),
                    "dir_version_total": self.dir.version_total(),
                },
            },
        }

    async def _render_timeline_json(self):
        """Chrome-trace events straight off the task-event store (same
        shape as util.state.timeline / `rtpu timeline`): duration
        slices, submit→execute flow arrows, and instant events for
        queue-time failures."""
        import json as _json

        from ray_tpu_torch.util.state.api import task_timeline_events

        records = await self.shards.task_events.run_sync(
            self._ev_plane.all_records)
        events = task_timeline_events(records)
        return "application/json", _json.dumps(events).encode()

    async def rpc_task_events(self, events: List[Dict[str, Any]]):
        """Workers flush task state transitions here in batches
        (reference: task_event_buffer.h -> gcs_task_manager.h).

        Routed to the task-event shard's loop (rpc_op_loops): frames
        land in the plane's inbox and merge ONCE per loop tick — with
        many clients flushing a burst simultaneously, the merge +
        cap-trim + latency-histogram pass runs over all of them
        together, and none of it touches the scheduling loop."""
        self._ev_plane.ingest(events)
        return {"ok": True}

    async def rpc_list_tasks(self, state: str = "", name: str = "",
                             limit: int = 1000):
        # routed to the task-event shard: reads see a store no merge is
        # concurrently mutating, and the walk costs the scheduling loop
        # nothing
        return {"tasks": self._ev_plane.list_tasks(state, name, limit)}

    # ---- distributed-trace store (see tracing.TraceStore, owned by the
    # task-event plane; reference: ray.util.tracing exports spans to an
    # external collector — here a bounded in-head store queryable via
    # RPC, HTTP and CLI) ---------------------------------------------------

    async def rpc_trace_spans(self, spans: List[Dict[str, Any]]):
        """Workers flush finished spans here alongside task events
        (routed to the same shard loop, so span ingest and event merge
        never interleave mid-structure)."""
        self._ev_plane.ingest_spans(spans)
        return {"ok": True}

    async def rpc_list_traces(self, limit: int = 100):
        store = self._ev_plane.trace_store
        return {"traces": store.summaries(limit),
                "spans_dropped": store.spans_dropped}

    async def rpc_get_trace(self, trace_id: str):
        trace = self._ev_plane.trace_store.detail(trace_id)
        if trace is None:
            return {"found": False}
        return {"found": True, "trace": trace}

    async def _render_traces_json(self):
        import json as _json

        traces = await self.shards.task_events.run_sync(
            lambda: self._ev_plane.trace_store.summaries(100))
        return "application/json", _json.dumps(
            traces, default=str).encode()

    async def _render_one_trace_json(self, trace_id: str = ""):
        import json as _json

        tid = trace_id.strip("/")
        trace = await self.shards.task_events.run_sync(
            lambda: self._ev_plane.trace_store.detail(tid))
        if trace is None:
            body = _json.dumps({"error": f"no trace {trace_id!r}"})
            return "application/json", body.encode()
        return "application/json", _json.dumps(trace, default=str).encode()

    # ---- live introspection (see _private/profiling.py): cluster-wide
    # stack dumps, routed sampling profiles, and the head time-series
    # ring behind /api/timeseries (reference roles: `ray stack`,
    # profile_manager.py, and the dashboard's node-stats timeline) ---------

    # (the time-series ring lives on the telemetry plane — see
    # head_shards.TelemetryPlane.ts_record/ts_tail/timeseries_payload;
    # rpc_timeseries is routed to that plane's loop)

    async def rpc_timeseries(self):
        return self._telem.timeseries_payload()

    def _render_timeseries_json(self):
        import json as _json

        # the ring is internally locked: safe to render from this loop
        return "application/json", _json.dumps(
            self._telem.timeseries_payload()).encode()

    async def rpc_cluster_stack(self, target: str = "",
                                timeout_s: float = 5.0):
        """Live stack dumps across the cluster: the head process plus
        every agent's node_stacks fan-out (agent + its pooled workers).
        ``target`` filters to one node by id prefix, or to "head"."""
        from ray_tpu_torch._private.profiling import proc_stack_payload

        out: Dict[str, Any] = {"nodes": {}}
        if not target or target == "head":
            out["head"] = proc_stack_payload()
        if target == "head":
            return out

        async def one(node: _NodeEntry):
            try:
                out["nodes"][node.node_id] = await self._node_client(
                    node).call("node_stacks", timeout_s=timeout_s,
                               timeout=timeout_s + 5.0)
            except Exception as e:
                out["nodes"][node.node_id] = {
                    "error": f"{type(e).__name__}: {e}"}

        nodes = list(self.nodes.values())
        if target:
            matched = [n for n in nodes if n.node_id.startswith(target)]
            # a worker-id target matches no node: fan out everywhere and
            # let the caller filter its workers by id prefix
            nodes = matched or nodes
        await asyncio.gather(*(one(n) for n in nodes))
        return out

    async def rpc_profile_target(self, target: str = "head", hz: float = 0,
                                 duration_s: float = 2.0,
                                 fmt: str = "collapsed"):
        """Route a sampling-profiler run to a process: "head", a node id
        prefix (profiles that node's agent), or a worker id prefix
        (proxied by the agent that pools it).  Blocks for the duration
        and returns the collapsed/speedscope output."""
        duration_s = min(float(duration_s),
                         float(config.profiler_max_duration_s))
        if not target or target == "head":
            return await self.rpc_profile(op="run", hz=hz,
                                          duration_s=duration_s, fmt=fmt)
        node = next((n for n in self.nodes.values()
                     if n.node_id.startswith(target)), None)
        if node is not None:
            return await self._node_client(node).call(
                "profile", op="run", hz=hz, duration_s=duration_s, fmt=fmt,
                timeout=duration_s + 30.0)
        for n in list(self.nodes.values()):
            try:
                reply = await self._node_client(n).call(
                    "profile_worker", worker=target, hz=hz,
                    duration_s=duration_s, fmt=fmt,
                    timeout=duration_s + 35.0)
            except Exception:
                continue
            if reply.get("found"):
                reply["node_id"] = n.node_id
                return reply
        return {"ok": False,
                "error": f"no process matches target {target!r} "
                         f"(expected \"head\", a node id prefix, or a "
                         f"worker id prefix)"}

    @staticmethod
    def _query_params(query: str) -> Dict[str, str]:
        from urllib.parse import parse_qs

        return {k: v[-1] for k, v in parse_qs(query or "").items()}

    async def _http_stack(self, query: str = ""):
        import json as _json

        p = self._query_params(query)
        out = await self.rpc_cluster_stack(target=p.get("target", ""))
        return "application/json", _json.dumps(out, default=str).encode()

    async def _http_profile(self, query: str = ""):
        import json as _json

        p = self._query_params(query)
        fmt = p.get("format", "speedscope")
        out = await self.rpc_profile_target(
            target=p.get("target", "head"),
            hz=float(p.get("hz", 0) or 0),
            duration_s=float(p.get("duration", 2.0)),
            fmt=fmt)
        if out.get("ok") and fmt == "speedscope":
            # the profile field already IS speedscope JSON: serve it
            # directly so a browser download opens in speedscope.app
            return "application/json", out["profile"].encode()
        return "application/json", _json.dumps(out, default=str).encode()

    async def rpc_metrics_port(self):
        return {"port": self.metrics_port}

    async def rpc_list_objects(self, limit: int = 1000):
        """Fan out to every agent's plasma store (reference:
        state_aggregator.py querying raylets via GetObjectsInfo)."""
        async def one(node):
            try:
                r = await self._node_client(node).call(
                    "list_objects", limit=limit, timeout=10.0)
            except Exception:
                return []
            objs = r.get("objects", [])
            for o in objs:
                o["node_id"] = node.node_id
            return objs

        # concurrent fan-out: one slow/unreachable agent bounds latency,
        # it doesn't sum across nodes
        results = await asyncio.gather(
            *(one(n) for n in list(self.nodes.values())))
        out: List[Dict[str, Any]] = [o for objs in results for o in objs]
        return {"objects": out[:limit]}

    # ---- memory & object accounting (rtpu memory / rtpu summary;
    # reference: `ray memory` + `ray summary` — state_aggregator.py
    # joining per-worker ownership dumps with per-raylet store stats) -------

    def _driver_client(self, addr: Tuple[str, int]) -> RpcClient:
        addr = (addr[0], addr[1])
        c = self._driver_clients.get(addr)
        if c is None or c.dead:
            if c is not None:
                asyncio.ensure_future(c.close())
            c = RpcClient(addr[0], addr[1], label=f"driver-{addr[1]}")
            self._driver_clients[addr] = c
        return c

    def _drop_driver(self, jid: str, addr: Tuple[str, int]) -> None:
        """Forget a driver whose process is gone: its callback address
        and pooled client.  Its still-pinned primary bytes now have no
        claiming owner — the dead-owner tripwire's job."""
        self.driver_addrs.pop(jid, None)
        c = self._driver_clients.pop((addr[0], addr[1]), None)
        if c is not None:
            asyncio.ensure_future(c.close())

    async def _memory_view(self, top_n: int = 0,
                           limit: int = 0) -> Dict[str, Any]:
        """Single-flight wrapper over the cluster fan-out: the 5s scan
        loop, dashboard viewers and CLI/state callers all want the same
        join — concurrent requests with the same bounds share ONE
        in-flight fan-out instead of each dialing every agent, worker
        and driver (callers treat the returned view as read-only)."""
        key = (int(top_n), int(limit))
        fut = self._memview_inflight.get(key)
        if fut is None:
            fut = asyncio.ensure_future(
                self._memory_view_fanout(top_n=top_n, limit=limit))
            self._memview_inflight[key] = fut
            fut.add_done_callback(
                lambda _f, k=key: self._memview_inflight.pop(k, None))
        return await asyncio.shield(fut)

    async def _memory_view_fanout(self, top_n: int = 0,
                                  limit: int = 0) -> Dict[str, Any]:
        """Join the cluster's memory accounting into one view: per-node
        store byte breakdowns + object tables (agent fan-out, each agent
        adding its pooled workers' reference summaries) + registered
        drivers' reference summaries, then run the leak tripwires over
        the join.  Bounded everywhere: `limit` refs per owner, `top_n`
        objects in the joined table."""
        top_n = int(top_n) or int(config.memory_view_top_n)
        limit = int(limit) or int(config.memory_summary_max_refs)
        ttl = float(config.object_leak_ttl_s)
        node_payloads: Dict[str, Dict[str, Any]] = {}
        owner_summaries: List[Dict[str, Any]] = []
        fanout_errors: List[str] = []

        async def one_node(node: _NodeEntry):
            try:
                node_payloads[node.node_id] = await self._node_client(
                    node).call("node_memory", limit=limit, timeout=15.0)
            except Exception as e:
                fanout_errors.append(f"node {node.node_id[:12]}: {e}")

        from ray_tpu_torch._private.rpc import ConnectionLost

        async def one_driver(jid: str, addr: Tuple[str, int]):
            try:
                try:
                    s = await self._driver_client(addr).call(
                        "memory_summary", limit=limit, timeout=5.0)
                except ConnectionLost:
                    # the POOLED connection died — which also happens
                    # when a transient reset severs a socket under a
                    # live driver.  Verify death with one fresh dial
                    # before trusting it as a death signal.
                    old = self._driver_clients.pop((addr[0], addr[1]),
                                                   None)
                    if old is not None:
                        asyncio.ensure_future(old.close())
                    s = await self._driver_client(addr).call(
                        "memory_summary", limit=limit, timeout=5.0)
                s["job_id"] = jid
                owner_summaries.append(s)
            except asyncio.TimeoutError:
                # a TIMEOUT is a busy driver, not a death signal — and on
                # 3.11+ TimeoutError subclasses OSError, so it must be
                # caught BEFORE the process-GONE branch below or a slow
                # driver gets permanently dropped and its objects flagged
                fanout_errors.append(f"driver {jid[:12]}: timeout")
            except (ConnectionLost, ConnectionRefusedError):
                # process GONE — a refused or severed FRESH dial is
                # real death evidence: its owned objects now have no
                # live owner, exactly what the dead-owner tripwire
                # flags.  Drop it so churned drivers don't accumulate.
                self._drop_driver(jid, addr)
            except OSError as e:
                # any other OSError is a LOCAL dial failure (fd
                # pressure, ENOBUFS) and says nothing about the driver:
                # a gap, never a death signal
                fanout_errors.append(f"driver {jid[:12]}: {e!r:.60}")
            except Exception as e:
                # alive but not answering (busy loop, slow box): its
                # refs are a GAP, not a death signal — the join is
                # partial and absence-of-owner must not be trusted
                fanout_errors.append(f"driver {jid[:12]}: {e!r:.60}")

        await asyncio.gather(
            *(one_node(n) for n in list(self.nodes.values())),
            *(one_driver(j, a) for j, a in list(self.driver_addrs.items())))
        for p in node_payloads.values():
            for wid, s in (p.get("workers") or {}).items():
                if isinstance(s, dict) and not s.get("error"):
                    owner_summaries.append(s)
                else:
                    fanout_errors.append(f"worker {wid[:12]}")

        # owner join: oid -> owning worker + call-site.  `complete` means
        # every reachable owner reported an untruncated table, every
        # node reported its full object list, and no agent/worker/driver
        # fan-out failed — only then can "no owner claims this object"
        # be trusted as a death signal rather than a gap.
        if self._gapped_driver_conns:
            fanout_errors.append(
                f"{len(self._gapped_driver_conns)} driver(s) with "
                f"unreachable loopback callback")
        complete = not fanout_errors and not self._driver_join_gap
        for nid, p in node_payloads.items():
            total = (p.get("breakdown") or {}).get("num_objects", 0)
            if total > len(p.get("objects") or ()):
                complete = False
                fanout_errors.append(
                    f"node {nid[:12]}: object list truncated "
                    f"({len(p['objects'])}/{total})")
        owned_by_oid: Dict[str, Dict[str, Any]] = {}
        live_channels: set = set()
        for s in owner_summaries:
            if s.get("truncated"):
                complete = False
            for r in s.get("owned") or ():
                owned_by_oid[r["oid"]] = {
                    "worker_id": s.get("worker_id", ""),
                    "kind": s.get("kind", ""),
                    "call_site": r.get("call_site", ""),
                    "name": r.get("name", ""),
                    "size": r.get("size", 0),
                }
            live_channels.update(s.get("channels") or ())

        objects: List[Dict[str, Any]] = []
        leaks: Dict[str, Any] = {"dead_owner": [], "borrowed_ttl": [],
                                 "channel_slots": [],
                                 "partial": not complete,
                                 "ttl_s": ttl}
        store_object_bytes = attributed_bytes = 0
        size_by_oid: Dict[str, int] = {}
        # TTL clocks run from first-seen-unclaimed, tracked only across
        # COMPLETE scans (absence-of-owner means nothing on a partial
        # one, and a partial blip must not reset a running clock)
        now = time.time()
        seen_unclaimed: set = set()

        def unclaimed_past_ttl(oid: str) -> Tuple[bool, float]:
            t0 = self._unclaimed_since.setdefault(oid, now)
            seen_unclaimed.add(oid)
            return now - t0 > ttl, now - t0

        for nid, p in node_payloads.items():
            for o in p.get("objects") or ():
                o = dict(o)
                o["node_id"] = nid
                size_by_oid[o["object_id"]] = o.get("size", 0)
                own = owned_by_oid.get(o["object_id"])
                if own is not None:
                    o["owner"] = {k: own[k] for k in
                                  ("worker_id", "kind", "call_site", "name")}
                objects.append(o)
                if o.get("freed") or not o.get("sealed"):
                    continue
                if o.get("channel"):
                    if complete and o["object_id"] not in live_channels:
                        past, unclaimed_s = unclaimed_past_ttl(
                            o["object_id"])
                        if past:
                            leaks["channel_slots"].append({
                                "object_id": o["object_id"],
                                "node_id": nid, "size": o["size"],
                                "age_s": o["age_s"],
                                "unclaimed_s": round(unclaimed_s, 1)})
                    continue
                store_object_bytes += o["size"]
                if own is not None:
                    attributed_bytes += o["size"]
                elif complete and o.get("primary"):
                    # primary bytes no live owner claims: nobody will
                    # ever send the store_free for them
                    past, unclaimed_s = unclaimed_past_ttl(o["object_id"])
                    if past:
                        leaks["dead_owner"].append({
                            "object_id": o["object_id"], "node_id": nid,
                            "size": o["size"], "age_s": o["age_s"],
                            "unclaimed_s": round(unclaimed_s, 1),
                            "pins": o.get("pins", 0)})
        if complete:
            # an oid freed or claimed again resets its clock; pruning
            # only on complete scans keeps the map bounded by the live
            # unclaimed population
            self._unclaimed_since = {
                k: v for k, v in self._unclaimed_since.items()
                if k in seen_unclaimed}
        for s in owner_summaries:
            for r in s.get("borrowed") or ():
                if r.get("age_s", 0) > ttl:
                    own = owned_by_oid.get(r["oid"])
                    # borrowers don't know sizes — backfill from the
                    # store entry or the owner's own table
                    size = (r.get("size") or size_by_oid.get(r["oid"])
                            or (own or {}).get("size", 0))
                    leaks["borrowed_ttl"].append({
                        "object_id": r["oid"],
                        "worker_id": s.get("worker_id", ""),
                        "size": size, "age_s": r["age_s"],
                        "owner_known": own is not None})
        # an object can trip more than one wire (dead owner AND a stale
        # borrow) — count its bytes once
        leaked_by_oid: Dict[str, int] = {}
        for kind in ("dead_owner", "borrowed_ttl", "channel_slots"):
            for e in leaks[kind]:
                leaked_by_oid[e["object_id"]] = max(
                    leaked_by_oid.get(e["object_id"], 0), e["size"])
        leaks["leaked_bytes"] = sum(leaked_by_oid.values())
        objects.sort(key=lambda o: -o.get("size", 0))
        owners = [{"worker_id": s.get("worker_id", ""),
                   "kind": s.get("kind", ""),
                   "node_id": s.get("node_id", ""),
                   "job_id": s.get("job_id", ""),
                   "num_owned": s.get("num_owned", 0),
                   "num_borrowed": s.get("num_borrowed", 0),
                   "owned_bytes": s.get("owned_bytes", 0)}
                  for s in owner_summaries]
        return {
            "nodes": {nid: p.get("breakdown", {})
                      for nid, p in node_payloads.items()},
            "objects": objects[:top_n],
            "num_objects": len(objects),
            "store_object_bytes": store_object_bytes,
            "attributed_bytes": attributed_bytes,
            "owners": owners,
            "leaks": leaks,
            "errors": fanout_errors,
            "ts": time.time(),
        }

    async def rpc_memory_view(self, top_n: int = 0, limit: int = 0):
        return await self._memory_view(top_n=top_n, limit=limit)

    async def _memory_scan_loop(self):
        """Leak tripwire: periodically run the joined memory view and
        publish per-kind leaked bytes as ray_tpu_object_leaked_bytes.
        The gauge is re-set every scan, so cleaned-up leaks drop it back
        to 0 within one interval."""
        from ray_tpu_torch._private.metrics import (memory_scan_partial_gauge,
                                              object_leaked_bytes_gauge)

        gauge = object_leaked_bytes_gauge()
        partial_gauge = memory_scan_partial_gauge()
        kinds = {"dead_owner": "dead_owner", "borrowed_ttl": "borrowed_ttl",
                 "channel_slots": "channel_slot"}
        while True:
            await asyncio.sleep(
                max(0.1, float(config.memory_scan_interval_s)))
            try:
                view = await self._memory_view()
            except Exception:
                continue
            leaks = view.get("leaks") or {}
            partial = bool(leaks.get("partial"))
            # partialness is its own signal: while 1, leak detection is
            # suspended and the held leak values below are stale
            partial_gauge.set(1.0 if partial else 0.0)
            # EVERY kind can false-all-clear on a partial join:
            # dead_owner/channel_slots are emptied by the complete-gate,
            # and an unreachable BORROWER empties its borrowed_ttl
            # records — hold the last COMPLETE values (gauge and
            # summary banner alike) rather than dropping a live alert
            # to 0
            if partial:
                prev = self._last_memory_scan
                self._last_memory_scan = {
                    "ts": view.get("ts"), "partial": True,
                    "leaked_bytes": prev.get("leaked_bytes", 0),
                    "counts": prev.get("counts",
                                       {k: 0 for k in kinds}),
                }
                continue
            for key, label in kinds.items():
                gauge.set(
                    sum(e.get("size", 0) for e in leaks.get(key, ())),
                    tags={"kind": label})
            self._last_memory_scan = {
                "ts": view.get("ts"),
                "partial": False,
                "leaked_bytes": leaks.get("leaked_bytes", 0),
                "counts": {k: len(leaks.get(k, ())) for k in kinds},
            }

    @staticmethod
    def _percentiles(vals: List[float]) -> Optional[Dict[str, Any]]:
        if not vals:
            return None
        s = sorted(vals)
        n = len(s)
        return {"count": n,
                "p50_ms": round(s[n // 2] * 1000, 3),
                "p99_ms": round(s[min(n - 1, int(n * 0.99))] * 1000, 3),
                "mean_ms": round(sum(s) / n * 1000, 3),
                "max_ms": round(s[-1] * 1000, 3)}

    async def _cluster_summary(self) -> Dict[str, Any]:
        """`rtpu summary`: per-function task aggregates (state counts +
        queued/running percentiles, computed by the task-event plane on
        its own loop), actor counts + per-method call counts, and the
        per-node object-store rollup from heartbeat breakdowns.  No
        cluster fan-out — cheap enough to poll."""
        tasks, methods = await self.shards.task_events.run_sync(
            self._ev_plane.summarize_tasks)
        kind_names = {NORMAL_TASK: "task", ACTOR_CREATION_TASK:
                      "actor_creation", ACTOR_TASK: "actor_method"}
        out_tasks = {
            name: {"kind": kind_names.get(row["kind"], str(row["kind"])),
                   "states": row["states"],
                   "queued": self._percentiles(row["queued_s"]),
                   "running": self._percentiles(row["running_s"])}
            for name, row in tasks.items()}
        actor_states: Dict[str, int] = {}
        for a in self.actors.values():
            actor_states[a.state] = actor_states.get(a.state, 0) + 1
        node_mem = {nid: dict(n.memory) for nid, n in self.nodes.items()
                    if n.memory}
        objects = {
            "nodes": node_mem,
            "total_arena_used": sum(m.get("arena_used", 0)
                                    for m in node_mem.values()),
            "total_pinned_bytes": sum(m.get("pinned_bytes", 0)
                                      for m in node_mem.values()),
            "total_spilled_bytes": sum(m.get("spilled_bytes", 0)
                                       for m in node_mem.values()),
            "total_channel_bytes": sum(m.get("channel_bytes", 0)
                                       for m in node_mem.values()),
            "total_objects": sum(m.get("num_objects", 0)
                                 for m in node_mem.values()),
        }
        return {"tasks": out_tasks,
                "actors": {"by_state": actor_states,
                           "num_actors": len(self.actors),
                           "methods": methods},
                "objects": objects,
                "last_leak_scan": dict(self._last_memory_scan),
                "ts": time.time()}

    async def rpc_cluster_summary(self):
        return await self._cluster_summary()

    async def _http_memory(self, query: str = ""):
        import json as _json

        p = self._query_params(query)
        out = await self._memory_view(top_n=int(p.get("top", 0) or 0))
        return "application/json", _json.dumps(out, default=str).encode()

    async def _render_summary_json(self):
        import json as _json

        return "application/json", _json.dumps(
            await self._cluster_summary(), default=str).encode()

    # ---- autoscaler --------------------------------------------------------

    def _scalable_shapes(self) -> List[Dict[str, float]]:
        """Resource totals of node types the autoscaler can still launch
        (lets agents park infeasible-but-scalable demands instead of
        failing them; reference: autoscaler hints in load_metrics)."""
        shapes: List[Dict[str, float]] = []
        for t in self._autoscaler_types.values():
            shapes.append(dict(t.get("resources", {})))
        return shapes

    async def rpc_register_autoscaler(self, node_types: Dict[str, Any]):
        """An autoscaler announces the node types it can launch
        (reference: monitor.py registering with GCS).  Idempotent — the
        autoscaler re-registers every pass, so a restarted head relearns
        the types within one update period."""
        if dict(node_types) == self._autoscaler_types:
            return {"ok": True, "epoch": self.dir.epoch}
        self._autoscaler_types = dict(node_types)
        self._cluster_version += 1
        self.mark_dirty()
        self._broadcast_cluster_view()
        return {"ok": True, "epoch": self.dir.epoch}

    async def rpc_autoscaler_state(self):
        """Aggregate demand + supply snapshot for the autoscaler loop
        (reference: gcs_autoscaler_state_manager.h GetClusterResourceState)."""
        pending_pg_bundles: List[Dict[str, Any]] = []
        for pg in self.placement_groups.values():
            if pg.state == PG_PENDING:
                for idx, nid in enumerate(pg.placements):
                    if nid is None:
                        pending_pg_bundles.append(
                            {"pg_id": pg.pg_id, "strategy": pg.strategy,
                             "resources": pg.bundles[idx]})
        pending_actors: List[Dict[str, float]] = []
        for actor in self.actors.values():
            if actor.state in (PENDING, RESTARTING):
                try:
                    ts = TaskSpec.from_wire(actor.spec_wire)
                    pending_actors.append(ts.resource_set().to_dict())
                except Exception:
                    pass
        return {
            "nodes": [
                {"node_id": n.node_id, "is_head_node": n.is_head_node,
                 "total": n.resources.total.to_dict(),
                 "available": n.resources.available.to_dict(),
                 "pending": n.pending_demands,
                 "draining": n.draining,
                 "heartbeat_age_s": time.monotonic() - n.last_heartbeat}
                for n in self.nodes.values()],
            "pending_pg_bundles": pending_pg_bundles,
            "pending_actors": pending_actors,
        }

    async def rpc_autoscaler_snapshot(self):
        """The v2 autoscaler input: the v1 demand/supply state plus the
        signals prior subsystems built — lease-queue-depth trends from
        the PR-6 time-series ring (hysteresis input), scheduler-latency
        p99 from the task-event store (SLO pressure), per-node store
        byte breakdowns from PR-9 memory accounting (drain-victim
        bin-packing), Serve/LLM queue pressure from the heartbeat gauge
        summaries, and live drain records.  ``epoch`` is the head's
        boot token: a change tells the autoscaler to re-register its
        node types (the DeltaReporter epoch-handshake pattern).

        Assembled from shard-published state: demand/supply from the
        scheduling core's OWN tables (this loop owns them), the SLO p99
        from the task-event plane's versioned stats snapshot, and ring
        trends through the telemetry plane's locked ts_tail — the old
        walk over the live task-event store from this loop is gone."""
        snap = await self.rpc_autoscaler_state()
        by_id = {n.node_id: n for n in self.nodes.values()}
        for n_out in snap["nodes"]:
            n = by_id.get(n_out["node_id"])
            if n is not None:
                mem = n.memory or {}
                n_out["memory"] = {
                    "arena_used": mem.get("arena_used", 0),
                    "arena_free": mem.get("arena_free", 0),
                    "num_objects": mem.get("num_objects", 0),
                }
        snap["epoch"] = self.dir.epoch
        ev_version, ev_stats = self._ev_plane.stats.read()
        ts_tail = self._telem.ts_tail
        snap["signals"] = {
            "lease_queue_depth": ts_tail("lease_queue_depth"),
            "sched_queued_p99_ms": ev_stats["queued_p99_ms"],
            "task_events_version": ev_version,
            "tasks_finished_total": ev_stats["finished_total"],
            "serve": {
                "llm_queue_depth": ts_tail("llm_queue_depth", k=5),
                "llm_tokens_per_step": ts_tail("llm_tokens_per_step",
                                               k=5),
            },
        }
        snap["shards"] = self._shard_info()
        snap["drains"] = {nid: dict(rec)
                          for nid, rec in self._drains.items()}
        return snap

    async def rpc_autoscaler_report(self, status: Optional[Dict[str, Any]]
                                    = None):
        """The autoscaler's per-pass status push: pending launches,
        nodes it is draining, the last decision and why — stored for
        /api/autoscaler and `rtpu status`, with scale-event deltas
        folded into ray_tpu_autoscaler_scale_events_total."""
        st = dict(status or {})
        st["ts"] = time.time()
        deltas = st.pop("events_delta", None) or {}
        try:
            from ray_tpu_torch._private.metrics import autoscaler_metrics

            _g, events_c, _h = autoscaler_metrics()
            for kind in ("up", "down"):
                n = int(deltas.get(kind, 0))
                if n > 0:
                    events_c.inc(n, tags={"kind": kind})
        except Exception:
            pass
        self._autoscaler_status = st
        return {"ok": True, "epoch": self.dir.epoch}

    def _autoscaler_view(self) -> Dict[str, Any]:
        """Shared payload behind rpc_autoscaler_status, /api/autoscaler
        and the `rtpu status` pane — the debuggability surface for
        scale events."""
        return {
            "report": dict(self._autoscaler_status),
            "registered_types": {k: dict(v) for k, v
                                 in self._autoscaler_types.items()},
            "draining": [n.node_id for n in self.nodes.values()
                         if n.draining],
            "drains": {nid: dict(rec)
                       for nid, rec in self._drains.items()},
            "ts": time.time(),
        }

    async def rpc_autoscaler_status(self):
        return self._autoscaler_view()

    def _render_autoscaler_json(self):
        import json as _json

        return "application/json", _json.dumps(
            self._autoscaler_view(), default=str).encode()

    # ---- misc --------------------------------------------------------------

    async def rpc_ping(self):
        return {"pong": True, "time": time.time()}

    async def rpc_cluster_resources(self):
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for n in self.nodes.values():
            for k, v in n.resources.total.to_dict().items():
                total[k] = total.get(k, 0) + v
            for k, v in n.resources.available.to_dict().items():
                avail[k] = avail.get(k, 0) + v
        return {"total": total, "available": avail}

    async def rpc_shutdown_cluster(self):
        async def _bye():
            for n in list(self.nodes.values()):
                try:
                    await self._node_client(n).oneway("shutdown_node")
                except Exception:
                    pass
            await asyncio.sleep(0.05)
            self._shutdown.set()

        asyncio.ensure_future(_bye())
        return {"ok": True}


def main():
    """Entry point: `python -m ray_tpu_torch._private.head --port-file PATH`."""
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default="")
    ap.add_argument("--state-path", default="",
                    help="persist head tables here; reloaded on restart")
    args = ap.parse_args()

    async def run():
        svc = HeadService(state_path=args.state_path)
        port = await svc.start(args.host, args.port)
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            import os
            os.replace(tmp, args.port_file)
        sys.stdout.write(f"ray_tpu head listening on {args.host}:{port}\n")
        sys.stdout.flush()
        await svc.wait_for_shutdown()
        await svc.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
