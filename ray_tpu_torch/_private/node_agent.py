"""Node agent: the per-node daemon (raylet equivalent).

Ported from ray_tpu's node agent: the concrete accelerators behind the
fungible count are GPUs (``gpu_ids``, entries of the agent's own
CUDA_VISIBLE_DEVICES list) instead of TPU chips, and a fractional GPU
demand takes a share of one card (:class:`GpuShares`).

Equivalent role to the reference's raylet
(reference: src/ray/raylet/node_manager.h:125, worker_pool.h:104,
local_object_manager.cc) plus the plasma store process (the StoreCore
runs inside this agent's event loop — one fewer process hop than the
reference, same shared-memory data path).

Responsibilities:
  - hosts the shared-memory object store (store_* RPCs serve the
    PlasmaClient protocol in object_store.py)
  - worker pool: forks `worker_main` processes, tracks registration,
    reaps deaths and reports them to the head
    (reference: worker_pool.h PopWorker / StartWorkerProcess)
  - lease protocol: request_lease grants a worker + resources, queues
    FIFO-with-resources when full, spills back to other nodes per the
    hybrid policy (reference: node_manager.h:520 HandleRequestWorkerLease,
    scheduling/policy/hybrid_scheduling_policy.h)
  - object transfer: pull-based chunked fetch from peer agents
    (reference: object_manager.h pull/push managers)
  - heartbeats resource availability to the head; the reply carries the
    cluster view used for spillback decisions (reference: ray_syncer)
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import fault_injection, memory_monitor
from ray_tpu_torch._private.accelerators import (GPU_RESOURCE,
                                               visible_devices)
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.errors import RuntimeEnvSetupError
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.log_monitor import LogMonitor
from ray_tpu_torch._private.object_store import StoreCore
from ray_tpu_torch._private.profiling import IntrospectionRpcMixin, loop_lag_probe
from ray_tpu_torch._private.object_transfer import (ObjectTransferClient,
                                              ObjectTransferServer,
                                              TransferError, dest_view)
from ray_tpu_torch._private.resources import NodeResources, ResourceSet
from ray_tpu_torch._private.rpc import RpcClient, RpcHost, RpcServer
from ray_tpu_torch._private.scheduler import LocalScheduler, pick_node
from ray_tpu_torch._private.task_spec import NORMAL_TASK, TaskSpec


class _Worker:
    __slots__ = ("worker_id", "pid", "proc", "port", "ready", "lease_id",
                 "started_at", "env_key", "idle_since", "iclient",
                 "pinned", "saving")

    def __init__(self, worker_id: str, proc: subprocess.Popen,
                 env_key: str = ""):
        self.worker_id = worker_id
        self.proc = proc
        self.pid = proc.pid
        self.port: int = 0
        self.ready = asyncio.Event()
        self.lease_id: Optional[str] = None
        self.started_at = time.monotonic()
        # OOM victim-policy flags, pushed by the worker itself
        # (worker_flags oneway): running a pinned __rt_dag_* loop /
        # mid-__rt_save__ snapshot — both are last-resort victims
        self.pinned = False
        self.saving = False
        # pooled introspection client (stacks/profile/memory fan-outs):
        # the periodic memory scan would otherwise dial a fresh TCP
        # connection per worker per scan, forever
        self.iclient: Optional["RpcClient"] = None
        # workers are pooled per runtime-env identity: an env-X lease
        # never reuses an env-Y worker (reference: worker_pool.h keys
        # idle workers by runtime env hash)
        self.env_key = env_key
        self.idle_since = time.monotonic()


def _is_hard_strategy(strategy: Dict[str, Any]) -> bool:
    """Strategies pinned to specific existing nodes — unsatisfiable by
    scale-up, so infeasibility is terminal (never parked)."""
    stype = (strategy or {}).get("type", "")
    return (stype == "node_label"
            or (stype == "node_affinity" and not strategy.get("soft")))


class GpuShares:
    """The free share of each card behind the fungible "GPU" count, as
    upstream Ray's GPU instance accounting keeps it (in 1/10000ths of a
    card, so shares add up exactly).

    A demand ``n`` takes ``int(n)`` whole free cards, lowest index
    first, and its remainder ``n - int(n)``, if any, as a share of the
    lowest-indexed card with that much left: ``num_gpus=0.5`` twice
    puts both leases on card 0, and both see it.  So a non-integer
    demand above 1, say 1.5, takes one whole card and half of another,
    and the shares taken always sum to the demand the scheduler counted.
    Demands the fungible count admits normally fit; only mixed
    fractions can leave every card short of a remainder (0.6 and 0.6 on
    two cards, then 0.8), and then it takes the card with the most
    share left, which is over-committed until a share comes back.  The
    shares go back with the lease."""

    UNITS = 10000

    def __init__(self, card_ids: List[str]):
        self._free: Dict[str, int] = {c: self.UNITS for c in card_ids}

    def take(self, n: float) -> Dict[str, int]:
        """Claim ``n`` cards' worth; returns {card id: units}, in card
        order."""
        units = int(round(float(n) * self.UNITS))
        whole, rest = divmod(max(units, 0), self.UNITS)
        taken: Dict[str, int] = {}
        for card, free in self._free.items():
            if len(taken) == whole:
                break
            if free == self.UNITS:
                taken[card] = self.UNITS
        if rest:
            left = [c for c in self._free if c not in taken]
            fits = [c for c in left if self._free[c] >= rest]
            if fits or left:
                card = fits[0] if fits else max(
                    left, key=lambda c: self._free[c])
                taken[card] = rest
        for card, amount in taken.items():
            self._free[card] -= amount
        return {c: taken[c] for c in self._free if c in taken}

    def give_back(self, taken: Dict[str, int]) -> None:
        for card, amount in taken.items():
            if card in self._free:
                self._free[card] = min(self.UNITS,
                                       self._free[card] + amount)


class _Lease:
    __slots__ = ("lease_id", "worker", "resources", "bundle_key", "seq",
                 "gpu_ids", "gpu_shares", "blocked", "donated",
                 "owner_conn",
                 "owner_id", "owner_addr", "retriable", "fid", "task_name")

    def __init__(self, lease_id: str, worker: _Worker, resources: ResourceSet,
                 bundle_key: str = "", seq: int = 0, owner_conn=None,
                 owner_id: str = "", owner_addr=None, retriable: bool = True,
                 fid: str = "", task_name: str = ""):
        self.lease_id = lease_id
        self.worker = worker
        self.resources = resources
        self.bundle_key = bundle_key
        self.seq = seq  # grant order; the OOM policy kills newest first
        # CUDA_VISIBLE_DEVICES entries assigned to this lease, and the
        # share of each it holds (GpuShares units)
        self.gpu_ids: List[str] = []
        self.gpu_shares: Dict[str, int] = {}
        # the connection the grant went out on — lets the agent push a
        # reclaim request to the owner when new demand queues behind
        # idle-lingering leases (reference: the raylet's lease revocation
        # via ReleaseUnusedWorkers)
        self.owner_conn = owner_conn
        # the granting spec's caller_id: a reconnected owner's next
        # lease request re-binds its surviving leases to the new
        # connection before the orphan-reap grace expires
        self.owner_id = owner_id
        # the owner's own RPC server address (spec.owner_addr): the
        # orphan reap pings it before killing anything, so a transient
        # control-connection drop from a LIVE owner never costs workers
        self.owner_addr = tuple(owner_addr) if owner_addr else None
        # True while the leased worker is blocked in a get(): its
        # fungible resources are returned to the pool so nested tasks
        # can run (reference: node_manager HandleWorkerBlocked/Unblocked
        # — CPU only; accelerators stay bound to their card assignment)
        self.blocked = False
        self.donated: Optional[ResourceSet] = None  # what blocking released
        # OOM victim policy inputs, from the granting spec: whether the
        # class's tasks are retriable (an adopted same-shape class can
        # differ per task — the granting spec is the agent's best view),
        # and the function/class id + name for the kill receipt and the
        # head's poison-task accounting
        self.retriable = retriable
        self.fid = fid
        self.task_name = task_name


class NodeAgent(IntrospectionRpcMixin, RpcHost):
    def __init__(self, head_addr: Tuple[str, int], session_dir: str,
                 resources: Dict[str, float], arena_path: str = "",
                 capacity: int = 0, is_head_node: bool = False,
                 node_id: str = "", labels: Optional[Dict[str, str]] = None):
        self.node_id = node_id or NodeID.from_random().hex()
        self.head_addr = head_addr
        self.session_dir = session_dir
        self.is_head_node = is_head_node
        self.labels: Dict[str, str] = labels or {}
        self.arena_path = arena_path or os.path.join(
            "/dev/shm", f"rt-arena-{self.node_id[:12]}")
        self.capacity = capacity or config.object_store_memory_bytes
        spill_dir = os.path.join(session_dir, f"spill-{self.node_id[:12]}")
        self.store = StoreCore(self.arena_path, self.capacity, spill_dir)
        # implicit per-node resource for node-affine placement (per-node
        # serve proxies, node-pinned actors; reference: the "node:<ip>"
        # implicit resource in common/scheduling)
        resources = dict(resources)
        resources.setdefault(f"node:{self.node_id[:12]}", 1.0)
        # real memory bin-packing: tasks declaring `memory=` in
        # .options() reserve bytes against this node total — the virtual
        # watchdog envelope when set, else the host's MemTotal
        # (reference: the "memory" resource in ray_constants/_raylet)
        mem_total = int(config.memory_monitor_node_total_bytes)
        if mem_total <= 0:
            try:
                with open("/proc/meminfo") as f:
                    for line in f:
                        if line.startswith("MemTotal"):
                            mem_total = int(line.split()[1]) * 1024
                            break
            except OSError:
                pass
        # the node's memory budget in bytes (virtual envelope or
        # MemTotal): the `memory` resource total for bin-packing, and
        # the denominator behind the kill receipts' self-poisoning
        # discriminator (a victim whose OWN RSS exceeds
        # threshold*total can never fit, even alone)
        self._mem_total_bytes = max(0, mem_total)
        if "memory" not in resources and mem_total > 0:
            resources["memory"] = float(mem_total)
        self.resources = NodeResources(ResourceSet(resources))
        # concrete cards behind the fungible "GPU" count: leases holding
        # GPU resources get specific cards, exported to the task as
        # CUDA_VISIBLE_DEVICES (reference: accelerators/nvidia_gpu.py
        # set_current_process_visible_accelerator_ids).  An index is a
        # position in this agent's own visible list: a lease's first
        # card is the agent's first visible entry, which need not be
        # physical card 0.
        visible = visible_devices() or []
        self._gpu_shares = GpuShares([
            visible[i] if i < len(visible) else str(i)
            for i in range(int(resources.get(GPU_RESOURCE, 0)))])
        self.local = LocalScheduler(self.resources)
        # placement-group bundles reserved on this node: "pgid:idx" ->
        # LocalScheduler over the reserved resources (reference:
        # src/ray/raylet/placement_group_resource_manager.h)
        self._bundles: Dict[str, LocalScheduler] = {}
        self.cluster_view: Dict[str, Any] = {}
        self._cluster_view_version = -1
        # sharded-object-directory replica (object_directory.py): shard
        # updates past our seen versions ride heartbeat replies; local
        # store reports go up as deltas built by the reporter, with the
        # head's boot epoch handshaking full re-sends
        from ray_tpu_torch._private.object_directory import (DeltaReporter,
                                                       DirectoryMirror)

        self._dir_mirror = DirectoryMirror(int(config.object_directory_shards))
        self._dir_reporter = DeltaReporter()
        self._head_dir_epoch: Optional[str] = None
        # gauge summary the head has ACKED: heartbeats carry only the
        # keys that changed since (None retires a vanished gauge); reset
        # to {} to force a full re-send (head restart / need_metrics)
        self._metrics_sent: Dict[str, float] = {}
        self._server: Optional[RpcServer] = None
        self.port = 0
        self.host = "127.0.0.1"
        self._head: Optional[RpcClient] = None
        self._peers: Dict[Tuple[str, int], RpcClient] = {}
        # bulk object-transfer plane (object_transfer.py): own listener +
        # pooled raw streams per peer; control RPC stays on self._peers
        self._xfer = ObjectTransferServer(self.store)
        self.xfer_port = 0
        self._xfer_clients: Dict[Tuple[str, int], ObjectTransferClient] = {}
        # observability for pulls (also surfaced via rpc_node_info)
        self.xfer_stats: Dict[str, int] = {
            "pulls": 0, "bulk_pulls": 0, "rpc_pulls": 0, "bytes_in": 0,
            "prefetch_started": 0, "alt_source_retries": 0,
            "bulk_fallbacks": 0, "checksum_failures": 0}
        # worker pool
        self._workers: Dict[str, _Worker] = {}   # worker_id -> worker
        self._idle: List[_Worker] = []
        self._starting = 0
        # bounds concurrent worker spawns (worker_startup_parallelism);
        # created lazily so __init__ needs no running loop
        self._spawn_sem: Optional[asyncio.Semaphore] = None
        # (ts, breakdown) reused by heartbeats — see _memory_breakdown
        self._breakdown_cache: Optional[Tuple[float, Dict[str, Any]]] = None
        self._leases: Dict[str, _Lease] = {}
        self._lease_counter = 0
        self._lease_waiters: Dict[object, asyncio.Future] = {}
        # in-flight pulls: oid -> future
        self._pulls: Dict[str, asyncio.Future] = {}
        self._tasks: List[asyncio.Task] = []
        self._shutdown = asyncio.Event()
        # infeasible-but-scalable lease demands, parked while the
        # autoscaler grows the cluster: key -> (demand dict, expiry)
        self._infeasible: Dict[str, Tuple[Dict[str, float], float]] = {}
        self.scalable_shapes: List[ResourceSet] = []
        # blocked leases whose unblock re-acquire is waiting on capacity
        self._unblock_pending: Set[str] = set()
        # set whenever resources free up: triggers an immediate (coalesced)
        # heartbeat so the head's availability view refreshes in ~ms, not a
        # full heartbeat period — pending placement groups replan on it
        # (reference: gcs_placement_group_manager.cc retries pending groups
        # on resource-change notifications from the syncer)
        self._hb_wake = asyncio.Event()
        self._last_reclaim = 0.0  # rate limit for _reclaim_idle_leases
        self._reclaim_followup = False  # trailing-edge push scheduled
        # queued lease requests by client request id, so owners can
        # cancel requests whose demand drained before a grant
        # (reference: node_manager.proto CancelWorkerLease)
        self._lease_req_tokens: Dict[str, Tuple[object, LocalScheduler]] = {}
        # queued bundle reservations by bundle key, so the head can
        # cancel a waited reservation whose RPC failed on its side
        self._reserve_tokens: Dict[str, Tuple[object, LocalScheduler]] = {}
        # live introspection: worker-log tailing for subscribed drivers
        # (log_monitor.py) + the latest loop-lag probe sample, folded
        # into heartbeat metric summaries for the head time-series ring
        self._log = LogMonitor(self.node_id)
        self._last_loop_lag = 0.0
        # chaos gossip state: last rule-set version applied from the head
        self._seen_chaos_version = 0
        # memory watchdog state: last sampled node pressure (rides
        # heartbeats into the cluster view for pressure-aware
        # scheduling), receipts for kills awaiting the head report, and
        # the head-gossiped poison-task quarantine (fid -> detail dict)
        self._last_pressure: Optional[float] = None
        self._oom_reported: Dict[str, Dict[str, Any]] = {}
        self._quarantine: Dict[str, Dict[str, Any]] = {}
        self._seen_quarantine_version = 0
        # graceful scale-down: while draining this agent grants no new
        # leases (owners re-route on the head's drained cluster view),
        # advertises no pending demand, and has its warm leases reclaimed
        self._draining = False
        # set by stop(): loops that might swallow their cancellation
        # (wait_for racing a wake event) exit on it instead
        self._stopping = False

    # ---- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self.host = host
        self._server = RpcServer(self, host, port)
        self.port = await self._server.start()
        self.xfer_port = await self._xfer.start(host)
        self._head = RpcClient(self.head_addr[0], self.head_addr[1], label="head",
                               on_push=self._on_head_push)
        reply = await self._head.call(
            "register_node", node_id=self.node_id, host=self.host,
            port=self.port, arena_path=self.arena_path,
            resources=self.resources.total.to_dict(),
            is_head_node=self.is_head_node, labels=self.labels,
            xfer_port=self.xfer_port)
        self._apply_cluster_view(reply.get("cluster"), reply.get("version"))
        self._apply_dir_reply(reply)
        self._tasks.append(asyncio.ensure_future(self._heartbeat_loop()))
        self._tasks.append(asyncio.ensure_future(self._reap_loop()))

        def _lag(sample: float) -> None:
            self._last_loop_lag = sample

        self._tasks.append(asyncio.ensure_future(
            loop_lag_probe("agent", on_sample=_lag)))
        if config.memory_monitor_refresh_ms > 0:
            self._tasks.append(
                asyncio.ensure_future(self._memory_monitor_loop()))
        await self._start_metrics(host)
        for _ in range(config.worker_pool_prestart_workers):
            self._spawn_worker()
        return self.port

    async def _start_metrics(self, host: str) -> None:
        """Per-node Prometheus endpoint: agent gauges + re-exported
        worker snapshots (reference: reporter_agent.py — one scrape
        target per node)."""
        from ray_tpu_torch._private.metrics import (Gauge, default_registry,
                                              start_metrics_http_server)

        default_registry.default_tags = {"node_id": self.node_id[:12]}
        store_bytes = Gauge("rt_object_store_bytes", "plasma bytes in use")
        store_objs = Gauge("rt_object_store_objects", "objects in plasma")
        store_cap = Gauge("rt_object_store_capacity_bytes", "plasma capacity")
        workers_g = Gauge("rt_worker_pool_size", "worker processes alive")
        leases_g = Gauge("rt_leases_active", "granted worker leases")
        queued_g = Gauge("rt_lease_queue_depth", "lease requests queued")

        from ray_tpu_torch._private.metrics import object_store_breakdown_gauge

        breakdown_g = object_store_breakdown_gauge()

        def collect():
            try:
                u = self.store.usage()
                store_bytes.set(u.get("allocated", 0))
                store_objs.set(u.get("num_objects", 0))
                store_cap.set(u.get("capacity", 0))
                b = self._memory_breakdown(max_age_s=5.0)
                for kind, key in (("arena_used", "arena_used"),
                                  ("arena_free", "arena_free"),
                                  ("pinned", "pinned_bytes"),
                                  ("spilled", "spilled_bytes"),
                                  ("channel", "channel_bytes"),
                                  ("mmap_cache", "mmap_cache_bytes")):
                    breakdown_g.set(b.get(key, 0), tags={"kind": kind})
            except Exception:
                pass
            workers_g.set(len(self._workers))
            leases_g.set(len(self._leases))
            queued_g.set(len(self._lease_waiters))

        # keep the handle: the registry is a process-lifetime singleton,
        # and the closure captures the whole agent — stop() must remove
        # it or every in-process agent (tests) stays pinned forever
        self._metrics_collector = collect
        default_registry.add_collector(collect)
        try:
            self._metrics_server, self.metrics_port = \
                await start_metrics_http_server(default_registry, host)
        except Exception:
            self.metrics_port = 0

    async def rpc_report_metrics(self, source: str, text: bytes):
        """A worker pushes its rendered metrics snapshot for re-export."""
        from ray_tpu_torch._private.metrics import default_registry

        default_registry.ingest_foreign(
            source, text.decode() if isinstance(text, bytes) else text)

    async def rpc_metrics_port(self):
        return {"port": self.metrics_port}

    async def rpc_list_objects(self, limit: int = 1000):
        """Object summaries for the state API (reference:
        node_manager.proto:405 GetObjectsInfo)."""
        return {"objects": self.store.list_objects(limit)}

    def _memory_breakdown(self, max_age_s: float = 0.0) -> Dict[str, Any]:
        """Store byte breakdown plus the agent-side caches the store
        can't see: the transfer plane's cross-pull mmap cache and pulls
        in flight right now.  byte_breakdown() walks every store entry,
        so periodic callers (heartbeats) pass max_age_s to reuse a
        recent snapshot instead of re-walking a large store each beat;
        the memory view's fan-out always computes fresh."""
        now = time.monotonic()
        if (max_age_s > 0.0 and self._breakdown_cache is not None
                and now - self._breakdown_cache[0] <= max_age_s):
            return self._breakdown_cache[1]
        b = self.store.byte_breakdown()
        cache = self._xfer.cache_stats()
        b["mmap_cache_bytes"] = cache["bytes"]
        b["mmap_cache_files"] = cache["files"]
        b["inflight_pulls"] = len(self._pulls)
        self._breakdown_cache = (now, b)
        return b

    async def rpc_node_memory(self, limit: int = 0,
                              include_workers: bool = True,
                              timeout_s: float = 5.0):
        """The node's full memory/object accounting payload for the
        head aggregator: byte breakdown, per-object store entries, and
        (fan-out, like node_stacks) every pooled worker's reference
        summary."""
        limit = int(limit) or int(config.memory_summary_max_refs)
        result: Dict[str, Any] = {
            "node_id": self.node_id,
            "breakdown": self._memory_breakdown(),
            # `limit` caps refs per WORKER summary; the store listing has
            # its own, much higher cap — truncating it marks the whole
            # view partial and turns the leak tripwires off
            "objects": self.store.list_objects(
                int(config.memory_summary_max_objects)),
            "workers": {},
        }

        async def one(w: _Worker):
            try:
                result["workers"][w.worker_id] = await asyncio.wait_for(
                    self._call_worker(w, "memory_summary", timeout_s,
                                      limit=limit),
                    timeout_s + 1.0)
            except Exception as e:
                result["workers"][w.worker_id] = {
                    "error": f"{type(e).__name__}: {e}"}

        if include_workers:
            await asyncio.gather(
                *(one(w) for w in list(self._workers.values())
                  if w.ready.is_set() and w.port and w.proc.poll() is None))
        return result

    async def stop(self):
        # belt for a 3.10 wait_for edge: a cancel landing exactly as
        # _hb_wake fires can be swallowed by the wait (bpo-42130 family),
        # leaving the heartbeat loop alive against a closed head forever
        # — the flag makes the next iteration exit regardless
        self._stopping = True
        self._log.stop()
        for t in self._tasks:
            t.cancel()
        for w in list(self._workers.values()):
            try:
                w.proc.terminate()
            except Exception:
                pass
        for w in list(self._workers.values()):
            try:
                w.proc.wait(timeout=2)
            except Exception:
                try:
                    w.proc.kill()
                except Exception:
                    pass
        for w in list(self._workers.values()):
            if w.iclient is not None:
                await w.iclient.close()
                w.iclient = None
        if self._head:
            await self._head.close()
        for c in self._peers.values():
            await c.close()
        self._peers.clear()
        for xc in self._xfer_clients.values():
            xc.close()
        self._xfer_clients.clear()
        await self._xfer.stop()
        if getattr(self, "_metrics_server", None) is not None:
            self._metrics_server.close()
        if getattr(self, "_metrics_collector", None) is not None:
            from ray_tpu_torch._private.metrics import default_registry

            default_registry.remove_collector(self._metrics_collector)
            self._metrics_collector = None
        if self._server:
            await self._server.stop()
        self.store.close(unlink=True)
        self._shutdown.set()

    async def wait_for_shutdown(self):
        await self._shutdown.wait()

    def _apply_cluster_view(self, view, version, scalable=None) -> None:
        """Last-write-wins would let an older RPC-reply snapshot clobber a
        fresher pushed view; only apply monotonically newer versions.
        (Object locations no longer ride the cluster view — the sharded
        directory mirror carries them, refreshed per shard version.)"""
        if scalable is not None:
            self.scalable_shapes = [ResourceSet(s) for s in scalable]
        if view is None:
            return
        if version is None:
            version = self._cluster_view_version  # legacy: accept equal
        if version >= self._cluster_view_version:
            self.cluster_view = view
            self._cluster_view_version = version

    def _apply_dir_reply(self, reply: Dict[str, Any]) -> None:
        """Fold a head reply's directory piece into the mirror and track
        the head's boot epoch.  An epoch change means a NEW directory
        whose shard versions restarted at 0: reset the mirror (stale
        high seen-versions would suppress every update and pin dead
        holders forever) — the re-send of our own objects is handled by
        the reporter's epoch handshake."""
        epoch = reply.get("dir_epoch")
        if epoch is not None and epoch != self._head_dir_epoch:
            if self._head_dir_epoch is not None:
                self._dir_mirror.reset()
            self._head_dir_epoch = epoch
        self._dir_mirror.apply_updates(reply.get("dir"))

    def _on_head_push(self, method: str, payload):
        if method == "cluster_update":
            self._apply_cluster_view(payload.get("cluster"),
                                     payload.get("version"),
                                     payload.get("scalable"))
        elif method == "chaos_rules":
            self._apply_chaos(payload)

    def _apply_chaos(self, payload: Optional[Dict[str, Any]]) -> None:
        """Install a gossiped chaos rule set (idempotent by version) and
        execute the imperative rules the agent owns: ``agent.kill``
        (SIGKILL myself — the real agent-death signal, PDEATHSIG takes
        my workers down with me) and ``worker.kill`` (SIGKILL matching
        worker processes).  Everything else fires inline at its site."""
        if not payload:
            return
        version = payload.get("version", 0)
        if version == self._seen_chaos_version:
            return
        # acknowledge the version even when opted out (chaos_enabled=
        # False), or the head re-ships the full rule set in every
        # heartbeat reply for the life of the session
        self._seen_chaos_version = version
        if not config.chaos_enabled:
            return
        fault_injection.install(payload.get("rules", []), version)
        self._run_chaos_kills()
        self._forward_chaos_to_workers(payload)

    def _forward_chaos_to_workers(self, payload: Dict[str, Any]) -> None:
        """Worker-side chaos sites (worker.oom, rpc.*) need the rules in
        the WORKER processes: newborns get them via the spawn env
        (RT_CHAOS_RULES); already-running pooled workers get this
        best-effort push over the introspection client."""

        async def _one(w: _Worker):
            try:
                await self._call_worker(w, "chaos_rules", timeout=5.0,
                                        rules=payload.get("rules", []),
                                        version=payload.get("version"))
            except Exception:
                pass

        for w in list(self._workers.values()):
            if w.ready.is_set() and w.proc.poll() is None:
                asyncio.ensure_future(_one(w))

    def _apply_quarantine(self, payload: Optional[Dict[str, Any]]) -> None:
        """Install the head-gossiped poison-task quarantine set (full
        replacement, idempotent by version): lease requests for a
        quarantined function/class id are refused with a typed
        "poisoned" error so enforcement is cluster-wide within one
        heartbeat of the quarantine tripping."""
        if not payload:
            return
        version = payload.get("version", 0)
        if version == self._seen_quarantine_version:
            return
        self._seen_quarantine_version = version
        self._quarantine = dict(payload.get("entries") or {})

    def _quarantined_entry(self, fid: str) -> Optional[Dict[str, Any]]:
        """The live quarantine record for fid, or None.  TTL expiry is
        enforced here too (belt and braces — the head also prunes), so
        a stale gossiped entry can never outlive its window."""
        ent = self._quarantine.get(fid)
        if ent is None:
            return None
        until = float(ent.get("until", 0.0))
        if until and time.time() >= until:
            self._quarantine.pop(fid, None)
            return None
        return ent

    def _run_chaos_kills(self) -> None:
        chaos = fault_injection.decide("agent.kill", key=self.node_id)
        if chaos is not None and chaos.action == "kill":
            delay = chaos.delay_s if chaos.delay_s > 0 else 0.0

            def _die():
                os.kill(os.getpid(), signal.SIGKILL)

            asyncio.get_running_loop().call_later(delay, _die)
            return
        for wid, w in list(self._workers.items()):
            self._maybe_chaos_kill_worker(wid, w)
            self._maybe_chaos_stall_worker(wid, w)

    def _maybe_chaos_kill_worker(self, worker_id: str, w: "_Worker") -> None:
        chaos = fault_injection.decide("worker.kill", key=worker_id)
        if chaos is None or chaos.action != "kill":
            return
        try:
            w.proc.kill()
        except Exception:
            pass
        # the reap loop notices the death within its 0.2s poll and runs
        # the normal worker-death path (lease release, head report)

    def _maybe_chaos_stall_worker(self, worker_id: str,
                                  w: "_Worker") -> None:
        """``worker.stall``: the gray-failure site.  The worker is told
        to busy-hang its RPC IO loop for the rule's delay_s — it stays
        ALIVE (process up, heartbeats fine) but every push, reply, and
        stream item stalls, which is exactly what a replica wedged in
        GC / a stalled decode loop looks like from outside.  Distinct
        from worker.kill: nothing crashes, nothing restarts — only
        deadline/hedging/circuit-breaker layers can route around it."""
        chaos = fault_injection.decide("worker.stall", key=worker_id)
        if chaos is None or chaos.action != "stall":
            return

        async def _stall():
            try:
                if not w.ready.is_set() or not w.port:
                    await asyncio.wait_for(w.ready.wait(), timeout=30)
                c = RpcClient("127.0.0.1", w.port,
                              label=f"stall-{worker_id[:8]}")
                # oneway: the stalled loop cannot reply until it wakes
                await c.oneway("chaos_stall", duration_s=chaos.delay_s)
                await c.close()
            except Exception:
                pass  # worker died first: nothing to stall

        asyncio.ensure_future(_stall())

    def _metric_summary(self) -> Dict[str, float]:
        """Small per-node gauge snapshot piggybacked on every heartbeat;
        the head folds it into the bounded time-series ring behind
        /api/timeseries and `rtpu status --watch` (reference role: the
        reporter agent's periodic node stats push)."""
        out = {
            "loop_lag_seconds": round(self._last_loop_lag, 6),
            "workers": float(len(self._workers)),
            "leases": float(len(self._leases)),
            "lease_queue_depth": float(len(self._lease_waiters)),
        }
        try:
            u = self.store.usage()
            out["object_store_bytes"] = float(u.get("allocated", 0))
        except Exception:
            pass
        # LLM serving pressure: replica engines on this node push these
        # gauges with their worker metric snapshots; summing them here
        # puts queue depth / tokens-per-step into the head time-series
        # ring so `rtpu status --watch` shows serving load per node
        from ray_tpu_torch._private.metrics import default_registry

        for key, family in (("llm_queue_depth", "ray_tpu_llm_queue_depth"),
                            ("llm_tokens_per_step",
                             "ray_tpu_llm_tokens_per_step")):
            try:
                v = default_registry.foreign_sample_sum(family)
            except Exception:
                v = None
            if v is not None:
                out[key] = float(v)
        return out

    def _pending_for_heartbeat(self) -> List[Dict[str, float]]:
        """Queued lease demands plus parked infeasible-but-scalable
        demands (the autoscaler's input; reference: load_metrics.py)."""
        if self._draining:
            # a draining node's backlog must not read as scale-up demand
            return []
        now = time.monotonic()
        self._infeasible = {k: v for k, v in self._infeasible.items()
                            if v[1] > now}
        return (self.local.pending_demands()
                + [dict(d) for d, _ in self._infeasible.values()])

    async def _heartbeat_loop(self):
        period = config.gcs_health_check_period_ms / 1000.0
        while not self._stopping:
            try:
                # object report as a DELTA vs what the head last acked:
                # a steady-state beat costs O(1) directory bytes no
                # matter how many objects this node holds
                delta = self._dir_reporter.build(
                    self.store.object_summary(
                        int(config.locality_min_bytes),
                        int(config.object_directory_max_entries)),
                    self._head_dir_epoch)
                # gauge summary as a DELTA vs what the head last acked
                # (same version-gating idea as the directory delta): a
                # steady-state beat re-serializes nothing
                summary = self._metric_summary()
                metrics_delta: Dict[str, Optional[float]] = {
                    k: v for k, v in summary.items()
                    if self._metrics_sent.get(k) != v}
                for gone in self._metrics_sent.keys() - summary.keys():
                    metrics_delta[gone] = None  # retire vanished gauge
                reply = await self._head.call(
                    "heartbeat", node_id=self.node_id,
                    available=self.resources.available.to_dict(),
                    pending=self._pending_for_heartbeat(),
                    objects_delta=delta,
                    dir_versions=self._dir_mirror.seen_versions(),
                    metrics=metrics_delta or None,
                    memory=self._memory_breakdown(max_age_s=5.0),
                    pressure=self._last_pressure,
                    seen_chaos_version=self._seen_chaos_version,
                    seen_quarantine_version=self._seen_quarantine_version,
                    chaos_fired=fault_injection.fired_counts() or None)
                if reply.get("unknown_node") or reply.get("need_metrics"):
                    # the head restarted with no gauge cache for us (or
                    # discarded this beat entirely): clear so the NEXT
                    # beat re-sends the full summary — bounded one-beat
                    # staleness, same handshake as the dir epoch reset
                    self._metrics_sent = {}
                else:
                    # the head folded this delta: commit the acked state
                    self._metrics_sent = dict(summary)
                self._apply_chaos(reply.get("chaos"))
                self._apply_quarantine(reply.get("quarantine"))
                if reply.get("unknown_node"):
                    # the head restarted without our entry (or reaped us
                    # during its downtime): re-register under the SAME
                    # node id so live actor/PG records stay valid
                    # (reference: node_manager.proto:352 NotifyGCSRestart
                    # — raylets resync after a GCS restart).  The reaped
                    # head dropped our directory entries too: reset the
                    # reporter so the next beat re-sends everything.
                    from ray_tpu_torch._private.object_directory import \
                        DeltaReporter

                    self._dir_reporter = DeltaReporter()
                    reply = await self._head.call(
                        "register_node", node_id=self.node_id,
                        host=self.host, port=self.port,
                        arena_path=self.arena_path,
                        resources=self.resources.total.to_dict(),
                        is_head_node=self.is_head_node, labels=self.labels,
                        xfer_port=self.xfer_port)
                else:
                    self._dir_reporter.ack()
                self._apply_cluster_view(reply.get("cluster"),
                                         reply.get("version"),
                                         reply.get("scalable"))
                self._apply_dir_reply(reply)
            except Exception:
                pass  # head unreachable (possibly restarting) — keep trying
            try:
                await asyncio.wait_for(self._hb_wake.wait(), period)
            except asyncio.TimeoutError:
                continue
            # resources freed: coalesce a burst of releases into one
            # off-cycle heartbeat, capping the extra rate at ~20/s
            await asyncio.sleep(0.05)
            self._hb_wake.clear()

    # ---- object store RPCs (PlasmaClient protocol) -------------------------

    async def rpc_store_create(self, oid: str, size: int, primary: bool = True,
                               wait_s: float = 0.0):
        if wait_s > 0:
            return await self.store.create_with_backpressure(
                oid, size, primary=primary, wait_s=float(wait_s))
        return self.store.create(oid, size, primary=primary)

    async def rpc_store_seal(self, oid: str):
        self.store.seal(oid)
        entry = self.store.objects.get(oid)
        if entry is not None and self._directory_worthy(entry.size):
            # a directory-worthy object appeared: refresh the head's
            # object directory now, not a full heartbeat period later —
            # locality scheduling and multi-source retry see it in ~ms
            self._hb_wake.set()
        return {"ok": True}

    @staticmethod
    def _directory_worthy(size: int) -> bool:
        min_bytes = int(config.locality_min_bytes)
        return min_bytes > 0 and size >= min_bytes

    async def rpc_store_abort(self, oid: str):
        self.store.abort(oid)
        return {"ok": True}

    async def rpc_store_get(self, oids: List[str], client_id: str,
                            wait_timeout: Optional[float] = None):
        return await self.store.get(oids, client_id, wait_timeout=wait_timeout)

    async def rpc_store_release(self, oid: str, client_id: str):
        self.store.release(oid, client_id)

    async def rpc_store_free(self, oids: List[str]):
        self.store.free(oids)
        return {"ok": True}

    async def rpc_store_contains(self, oid: str):
        return self.store.contains(oid)

    async def rpc_store_write(self, oid: str, offset: int, data: bytes):
        """Write into an unsealed object on behalf of a client-mode
        driver that has no arena mmap (reference: ray client proxies
        puts through the cluster; util/client/server/server.py)."""
        entry = self.store.objects.get(oid)
        if entry is None or entry.sealed:
            return {"ok": False, "error": "object missing or sealed"}
        if offset < 0 or offset + len(data) > entry.size:
            # a bad offset must never scribble over neighboring objects
            # in the shared arena
            return {"ok": False,
                    "error": f"write [{offset}, {offset + len(data)}) outside "
                             f"object of size {entry.size}"}
        if entry.location == "shm":
            self.store.arena.view[
                entry.offset + offset: entry.offset + offset + len(data)] = data
        else:
            with open(entry.path, "r+b") as f:
                f.seek(offset)
                f.write(data)
        return {"ok": True}

    async def rpc_store_usage(self):
        return self.store.usage()

    async def rpc_store_promote(self, oids: List[str]):
        """Drain hand-off: copies this node pulled become PRIMARY so
        eviction can't discard them once the original holder is gone.
        ``missing`` names oids with no sealed local copy — the caller
        must not count those as handed off."""
        promoted, missing = self.store.promote(list(oids or ()))
        return {"promoted": promoted, "missing": missing}

    # ---- graceful drain participation (head drain state machine) -----------

    async def rpc_prepare_drain(self):
        """Enter drain mode: refuse new leases, cancel queued lease
        waiters so their owners re-route (the head's drained view no
        longer targets us), and push an UNBOUNDED warm-lease reclaim
        (need={}) to every lease owner — the whole warm pool on this
        node returns instead of waiting out its TTL."""
        self._draining = True
        # queued waiters: wake with "canceled" — the owner's pump
        # retries the demand and the fresh view routes it elsewhere
        for token in list(self._lease_waiters):
            entry = self._lease_waiters.pop(token, None)
            if entry is None:
                continue
            fut, _demand, sched = entry
            _found, granted = sched.cancel(token)
            for tok in granted:
                self._grant_token(tok)
            if not fut.done():
                fut.set_result("canceled")
        payload = {"agent": [self.host, self.port], "need": {}}
        conns = {id(l.owner_conn): l.owner_conn
                 for l in self._leases.values()
                 if l.owner_conn is not None}

        async def _push(conn):
            try:
                await conn.push("reclaim_idle_leases", payload)
            except Exception:
                pass

        for conn in conns.values():
            asyncio.ensure_future(_push(conn))
        self._hb_wake.set()
        return {"ok": True, "leases": len(self._leases)}

    async def rpc_cancel_drain(self):
        """Drain abandoned (head-side failure/timeout): resume granting."""
        self._draining = False
        return {"ok": True}

    async def rpc_drain_info(self):
        """Drain progress the head polls: remaining leases are the
        quiesce gate (idle pooled workers don't block a drain)."""
        return {"draining": self._draining,
                "leases": len(self._leases),
                "workers": len(self._workers),
                "queued": len(self._lease_waiters)}

    # ---- compiled-DAG channels (see dag/channel.py) ------------------------
    # A channel slot is a reusable pinned shm allocation: the writer-node
    # slot plus one mirror per remote reader node, all under the same
    # oid.  Version bytes normally arrive over the bulk transfer plane
    # (write-flagged range requests straight into the arena); the
    # channel_write/channel_read RPCs are the compat path for peers
    # without a reachable transfer listener.

    def _channel_entry(self, oid: str):
        entry = self.store.objects.get(oid)
        if entry is None or not entry.channel:
            return None
        return entry

    async def rpc_channel_create(self, oid: str, size: int,
                                 header: Dict[str, Any]):
        from ray_tpu_torch.dag import channel as chmod

        loc = self.store.create_channel(oid, size)
        view = self.store.arena.view[loc["offset"]:loc["offset"] + size]
        if int.from_bytes(view[0:8], "little") != chmod.MAGIC:
            chmod.init_view(view, header)
        return {"ok": True, "offset": loc["offset"], "size": size}

    async def rpc_channel_destroy(self, oid: str):
        self.store.destroy_channel(oid)
        return {"ok": True}

    async def rpc_channel_map(self, oid: str):
        """Local attach: a driver/worker on this node maps the slot
        zero-copy out of the arena it already has mmap'd."""
        entry = self._channel_entry(oid)
        if entry is None:
            return {"found": False}
        return {"found": True, "offset": entry.offset, "size": entry.size}

    async def rpc_channel_write(self, oid: str, offset: int, data: bytes):
        """Compat push path: version bytes over control RPC when the
        bulk plane cannot reach this node."""
        entry = self._channel_entry(oid)
        if entry is None:
            return {"ok": False, "error": f"no channel {oid[:16]} here"}
        if offset < 0 or offset + len(data) > entry.size:
            return {"ok": False, "error": "write outside channel slot"}
        base = entry.offset
        self.store.arena.view[base + offset:base + offset + len(data)] = data
        return {"ok": True}

    async def rpc_channel_read(self, oid: str, offset: int, length: int):
        entry = self._channel_entry(oid)
        if entry is None:
            return {"ok": False, "error": f"no channel {oid[:16]} here"}
        if offset < 0 or length < 0 or offset + length > entry.size:
            return {"ok": False, "error": "read outside channel slot"}
        base = entry.offset
        return {"ok": True,
                "data": bytes(self.store.arena.view[base + offset:
                                                    base + offset + length])}

    async def rpc_channel_poison(self, oid: str, error: bytes = b"",
                                 close_only: bool = False):
        """Poison (actor death) or close (teardown) the local copy of a
        channel, waking every blocked reader/writer on this node."""
        from ray_tpu_torch.dag import channel as chmod

        entry = self._channel_entry(oid)
        if entry is None:
            return {"ok": False}
        view = self.store.arena.view[entry.offset:entry.offset + entry.size]
        if close_only:
            chmod.close_view(view)
        else:
            chmod.poison_view(view, error)
        return {"ok": True}

    # ---- object transfer (pull-based) --------------------------------------
    # Control (size lookup, pin/unpin) rides the msgpack RPC connection;
    # bytes ride the bulk plane (object_transfer.py) — a dedicated raw
    # stream pool on its own listener — with the chunked obj_chunk RPC
    # kept as the compat/fallback path (and the bench baseline).

    async def rpc_obj_info(self, oid: str, pin_for: str = ""):
        """Peer asks for size before pulling; pins so chunks stay valid.
        Carries the seal-fixed CRC32 so the puller can verify the
        payload it assembles (checksummed transfers).  A first-export
        hash runs on an executor thread — the entry is pinned (above)
        and sealed bytes are immutable, and a multi-GB crc32 must not
        stall the control loop."""
        locs = await self.store.get([oid], pin_for or "xfer", wait_timeout=0.0)
        loc = locs[0]
        if loc is None or loc.get("deleted"):
            return {"found": False}
        crc = await asyncio.get_running_loop().run_in_executor(
            None, self.store.checksum, oid)
        return {"found": True, "size": loc["size"],
                "xfer_port": self.xfer_port, "crc": crc}

    async def rpc_obj_corrupt(self, oid: str, reporter: str = ""):
        """A puller's payload from US failed checksum verification:
        re-hash our own copy against its seal-time CRC.  A genuinely
        corrupt SECONDARY copy is dropped (the directory stops
        advertising it within a beat; primaries stay — dropping the
        only durable copy converts detected corruption into data loss,
        and lineage reconstruction is the owner's call).  An intact
        copy means the corruption was in transit — nothing to do, the
        puller's alternate-holder retry (or a fresh stream) covers it."""
        verdict = await asyncio.get_running_loop().run_in_executor(
            None, self.store.verify_crc, oid)
        if verdict is False:
            entry = self.store.objects.get(oid)
            if entry is not None and not entry.primary:
                # evict the copy only — free() would mark the oid
                # owner-deleted here and fail local getters with
                # "freed" though the owner never freed it
                dropped = self.store.drop_copy(oid)
                if dropped:
                    self._hb_wake.set()  # directory: this holder is gone
                return {"dropped": dropped}
            return {"dropped": False, "corrupt_primary": True}
        return {"dropped": False, "intact": verdict is True}

    async def rpc_obj_chunk(self, oid: str, offset: int, length: int):
        # memoryview reply: msgpack serializes buffer-protocol objects
        # directly, so the chunk is copied once into the reply frame
        # instead of bytes()-copied first; disk-fallback objects come
        # from the transfer server's mmap cache (held across the pull,
        # not reopened per chunk)
        view = self._xfer.object_view(oid, offset, length)
        if view is None:
            return {"found": False}
        return {"found": True, "data": view}

    async def rpc_obj_unpin(self, oid: str, pin_for: str = ""):
        self.store.release(oid, pin_for or "xfer")
        self._xfer.release(oid)  # drop mappings held across the pull
        return {"ok": True}

    async def rpc_ensure_local(self, oid: str, src: Optional[List] = None):
        """Pull oid into the local store from the node at `src` (host,port).

        Concurrent pulls of the same oid are deduplicated
        (reference: pull_manager.h).  A pull whose source fails mid-way
        re-resolves holders from the head's object directory and retries
        once from an alternate before erroring.
        """
        if self.store.contains(oid):
            return {"ok": True, "local": True}
        if not src or (src[0] == self.host and src[1] == self.port):
            # no usable source given: the head's directory may know one
            alts = await self._alt_sources(oid)
            if not alts:
                return {"ok": False, "error": "object not local and no source"}
            src = alts[0]
        try:
            await self._ensure_pull(oid, (src[0], src[1]))
            return {"ok": True}
        except Exception as e:
            return {"ok": False, "error": str(e)}

    async def rpc_ensure_local_batch(self, items: List[List[Any]]):
        """Vectorized ensure_local: one frame carries every (oid, src)
        pair of a driver's get() round; pulls run concurrently, deduped
        against in-flight pulls, and the reply is per-item — localizing
        N objects costs one RPC round, not N (round-5 verdict item)."""
        results = await asyncio.gather(
            *[self.rpc_ensure_local(oid, src=src) for oid, src in items])
        return {"results": list(results)}

    def _ensure_pull(self, oid: str, src: Tuple[str, int]):
        """The deduplicated pull future for oid (shared by ensure_local
        and prefetch-on-lease); shielded so one cancelled waiter cannot
        kill the transfer for the others."""
        fut = self._pulls.get(oid)
        if fut is None:
            fut = asyncio.ensure_future(self._pull_with_retry(oid, src))
            self._pulls[oid] = fut
            fut.add_done_callback(lambda _: self._pulls.pop(oid, None))
        return asyncio.shield(fut)

    async def _pull_with_retry(self, oid: str, src: Tuple[str, int]):
        try:
            return await self._pull(oid, src)
        except Exception:
            # the source may have died mid-pull: ask the head who else
            # holds a copy and retry once from an alternate
            alts = await self._alt_sources(oid, exclude={tuple(src)})
            if not alts:
                raise
            self.xfer_stats["alt_source_retries"] += 1
            return await self._pull(oid, alts[0])

    async def _alt_sources(self, oid: str,
                           exclude=frozenset()) -> List[Tuple[str, int]]:
        if self._head is None:
            return []
        try:
            r = await self._head.call("object_locations", oids=[oid])
        except Exception:
            return []
        out = []
        for host, port in r.get("locations", {}).get(oid, []):
            addr = (host, port)
            if addr not in exclude and addr != (self.host, self.port):
                out.append(addr)
        return out

    async def _pull(self, oid: str, src: Tuple[str, int]):
        from ray_tpu_torch._private.metrics import object_transfer_metrics

        peer = self._peer(src)
        pin_id = f"xfer:{self.node_id[:12]}"
        info = await peer.call("obj_info", oid=oid, pin_for=pin_id)
        if not info.get("found"):
            raise KeyError(f"object {oid} not found at {src}")
        size = info["size"]
        xfer_port = info.get("xfer_port", 0)
        use_bulk = bool(xfer_port) and bool(config.object_transfer_enabled)
        t0 = time.monotonic()
        try:
            loc = self.store.create(oid, size, primary=False)
            try:
                if use_bulk:
                    try:
                        client = self._xfer_client((src[0], xfer_port))
                        view, mapped = dest_view(self.store, loc)
                        try:
                            await client.fetch_into(oid, view)
                        finally:
                            if mapped is not None:
                                mapped.close()
                    except (TransferError, OSError):
                        # transfer listener unreachable (filtered port,
                        # dead thread) while the control RPC to this
                        # peer demonstrably works — the chunk path must
                        # still serve the bytes (refetch is idempotent)
                        use_bulk = False
                        self.xfer_stats["bulk_fallbacks"] += 1
                        await self._pull_chunks_rpc(peer, oid, size, loc)
                else:
                    await self._pull_chunks_rpc(peer, oid, size, loc)
                # verify OUTSIDE the bulk-fallback try: a checksum
                # mismatch must go to an ALTERNATE holder (the retry in
                # _pull_with_retry), never refetch the same corrupt
                # source over a different plane
                await self._verify_pull(oid, loc, info.get("crc"), peer)
                self.store.seal(oid)
            except BaseException:
                self.store.abort(oid)
                raise
        finally:
            try:
                await peer.oneway("obj_unpin", oid=oid, pin_for=pin_id)
            except Exception:
                pass
        plane = "bulk" if use_bulk else "rpc"
        bytes_total, seconds = object_transfer_metrics()
        bytes_total.inc(size, tags={"plane": plane, "direction": "in"})
        seconds.observe(time.monotonic() - t0,
                        tags={"plane": plane, "direction": "in"})
        self.xfer_stats["pulls"] += 1
        self.xfer_stats[f"{plane}_pulls"] += 1
        self.xfer_stats["bytes_in"] += size
        if self._directory_worthy(size):
            self._hb_wake.set()  # new holder: refresh the directory fast

    async def _verify_pull(self, oid: str, loc: Dict[str, Any],
                           expected_crc, peer: RpcClient) -> None:
        """Checksum the just-assembled pull payload against the
        holder's seal-time CRC32.  A mismatch counts in
        ray_tpu_object_checksum_failures_total, tells the holder to
        re-verify (it drops a genuinely-corrupt secondary — the
        quarantined copy), and raises TransferError so the pull retries
        from an alternate holder via the existing alt-source path —
        the xfer.corrupt chaos site becomes detectable end to end
        instead of silent pickle roulette."""
        if expected_crc is None or not config.object_checksums:
            return
        entry = self.store.objects.get(oid)
        if entry is None:
            return  # aborted underneath us: nothing to verify
        # executor thread: a multi-GB hash must not stall the agent
        # control loop (heartbeats, lease grants, watchdog ticks) — the
        # unsealed allocation is exclusively ours until seal, so the
        # entry's bytes are stable off-loop.  compute_crc handles the
        # shm/disk location split in ONE place
        actual = await asyncio.get_running_loop().run_in_executor(
            None, self.store.compute_crc, entry)
        if actual is None:
            return  # bytes unreadable: cannot verify, let the seal land
        if actual == int(expected_crc):
            entry.crc = int(expected_crc)  # verified: no later re-hash
            return
        from ray_tpu_torch._private.metrics import \
            object_checksum_failures_counter

        object_checksum_failures_counter().inc()
        self.xfer_stats["checksum_failures"] = \
            self.xfer_stats.get("checksum_failures", 0) + 1
        try:
            await peer.oneway("obj_corrupt", oid=oid,
                              reporter=self.node_id)
        except Exception:
            pass
        raise TransferError(
            f"checksum mismatch pulling {oid[:16]}: payload crc "
            f"{actual:#010x} != sealed crc {int(expected_crc):#010x} "
            f"(copy reported to holder; retrying from an alternate)")

    async def _pull_chunks_rpc(self, peer: RpcClient, oid: str, size: int,
                               loc: Dict[str, Any]):
        """Legacy stop-and-wait chunk pull over the control RPC (used
        against agents without a transfer plane, and as the bench
        baseline for the bulk plane)."""
        chunk = config.object_transfer_chunk_bytes
        pos = 0
        while pos < size:
            n = min(chunk, size - pos)
            r = await peer.call("obj_chunk", oid=oid, offset=pos, length=n)
            if not r.get("found"):
                raise KeyError(f"object {oid} vanished mid-pull")
            data = r["data"]
            if loc["location"] == "shm":
                self.store.arena.view[
                    loc["offset"] + pos: loc["offset"] + pos + len(data)] = data
            else:
                with open(loc["path"], "r+b") as f:
                    f.seek(pos)
                    f.write(data)
            pos += len(data)

    def _peer(self, addr: Tuple[str, int]) -> RpcClient:
        addr = (addr[0], addr[1])
        client = self._peers.get(addr)
        if client is None or client.dead:
            if client is not None:
                # close the replaced dead client: dropping it on the
                # floor leaks its fd and read task until process exit
                asyncio.ensure_future(client.close())
            client = RpcClient(addr[0], addr[1], label=f"peer-{addr[1]}")
            self._peers[addr] = client
        return client

    def _xfer_client(self, addr: Tuple[str, int]) -> ObjectTransferClient:
        addr = (addr[0], addr[1])
        client = self._xfer_clients.get(addr)
        if client is None or client.closed:
            client = ObjectTransferClient(addr[0], addr[1])
            self._xfer_clients[addr] = client
        return client

    # ---- locality + prefetch -----------------------------------------------

    def _arg_bytes_by_node(self, ts: TaskSpec) -> Dict[str, float]:
        """Argument bytes already resident per node, from the spec's
        owner-stamped hints plus the sharded-directory mirror (which
        also sees secondary copies made by earlier prefetches) plus our
        own store.  Mirror lookups are O(1) per argument — the old
        per-node object maps made this O(nodes) per argument."""
        out: Dict[str, float] = {}
        addr_to_node = {tuple(v["addr"]): nid
                        for nid, v in self.cluster_view.items()}
        addr_to_node[(self.host, self.port)] = self.node_id
        for arg in ts.args:
            oid = arg.object_id
            if oid is None or not arg.size:
                continue
            holders = set(self._dir_mirror.holders(oid))
            if arg.loc:
                nid = addr_to_node.get(tuple(arg.loc))
                if nid is not None:
                    holders.add(nid)
            if self.store.contains(oid):
                holders.add(self.node_id)
            for nid in holders:
                out[nid] = out.get(nid, 0.0) + arg.size
        return out

    def _prefetch_args(self, ts: TaskSpec) -> None:
        """The lease will be serviced here: start pulling hinted remote
        args NOW, in one gather deduped against in-flight pulls, so the
        transfer overlaps queue wait and worker startup instead of
        serializing in front of execution (reference: the raylet's pull
        manager fetching task dependencies while the lease queues)."""
        pulls: Dict[str, Tuple[str, int]] = {}
        for arg in ts.args:
            oid = arg.object_id
            if oid is None or not arg.loc or oid in pulls:
                continue
            src = (arg.loc[0], arg.loc[1])
            if src == (self.host, self.port) or self.store.contains(oid) \
                    or oid in self._pulls:
                continue
            pulls[oid] = src
        if not pulls:
            return
        self.xfer_stats["prefetch_started"] += len(pulls)

        async def _gather():
            await asyncio.gather(
                *[self._ensure_pull(oid, src) for oid, src in pulls.items()],
                return_exceptions=True)  # the worker's get() retries/errors

        asyncio.ensure_future(_gather())

    # ---- worker pool -------------------------------------------------------

    def _spawn_worker(self, env_key: str = "",
                      extra_env: Optional[Dict[str, str]] = None,
                      working_dir: Optional[str] = None,
                      path_dirs: Optional[List[str]] = None) -> _Worker:
        worker_id = WorkerID.from_random().hex()
        env = dict(os.environ)
        # user env_vars first: the runtime-env control vars below must win
        if extra_env:
            env.update(extra_env)
        env.update({
            "RT_HEAD_HOST": self.head_addr[0],
            "RT_HEAD_PORT": str(self.head_addr[1]),
            "RT_AGENT_HOST": self.host,
            "RT_AGENT_PORT": str(self.port),
            "RT_ARENA_PATH": self.arena_path,
            "RT_NODE_ID": self.node_id,
            "RT_WORKER_ID": worker_id,
            "RT_SESSION_DIR": self.session_dir,
            # unbuffered stdout: a task's print() reaches the log file
            # (and any subscribed driver) immediately, not at the next
            # 8KB block flush
            "PYTHONUNBUFFERED": "1",
        })
        chaos_state = fault_injection.status()
        if chaos_state.get("rules"):
            # worker-side chaos sites (worker.oom, rpc.*) fire in the
            # worker process: ship the live rule set with the spawn
            import json as _json

            env["RT_CHAOS_RULES"] = _json.dumps(chaos_state)
        if working_dir:
            env["RT_WORKING_DIR"] = working_dir
        if path_dirs:
            env["RT_PY_MODULES"] = os.pathsep.join(path_dirs)
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{worker_id[:12]}.log")
        out = open(log_path, "ab")
        from ray_tpu_torch._private.spawn import fast_python_cmd, set_pdeathsig

        cmd, env_up = fast_python_cmd("ray_tpu_torch._private.worker_main")
        env.update(env_up)
        proc = subprocess.Popen(
            cmd, env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True, preexec_fn=set_pdeathsig)
        out.close()
        # stream THIS agent's worker logs only (the session logs dir may
        # be shared by several agents) — each line reaches a subscribed
        # driver exactly once
        self._log.add_file(log_path, proc.pid, worker_id)
        w = _Worker(worker_id, proc, env_key=env_key)
        self._workers[worker_id] = w
        self._starting += 1
        return w

    async def rpc_worker_ready(self, worker_id: str, port: int):
        w = self._workers.get(worker_id)
        if w is None:
            return {"ok": False}
        # armed worker.kill / worker.stall rules also catch workers
        # born after them
        self._maybe_chaos_kill_worker(worker_id, w)
        w.port = port
        self._maybe_chaos_stall_worker(worker_id, w)
        self._starting = max(0, self._starting - 1)
        if not w.ready.is_set():
            w.ready.set()
            w.idle_since = time.monotonic()
            self._idle.append(w)
        self._drain_lease_queue()
        return {"ok": True, "node_id": self.node_id}

    async def _reap_loop(self):
        """Poll child processes for deaths (reference: raylet SIGCHLD),
        and retire idle runtime-env workers: env-keyed workers can only
        serve their own env, so without a timeout every distinct env
        would permanently leak one process (reference: worker_pool.h
        kill_idle_workers / idle_worker_killing_time_threshold)."""
        while True:
            await asyncio.sleep(0.2)
            for wid, w in list(self._workers.items()):
                if w.proc.poll() is not None:
                    self._on_worker_dead(wid, f"exit code {w.proc.returncode}")
            cutoff = time.monotonic() - config.worker_idle_timeout_ms / 1000.0
            for w in [w for w in self._idle
                      if w.env_key and w.idle_since < cutoff]:
                try:
                    w.proc.kill()
                except Exception:
                    pass
                self._on_worker_dead(w.worker_id, "idle env worker retired")

    def _on_worker_dead(self, worker_id: str, reason: str):
        w = self._workers.pop(worker_id, None)
        if w is None:
            return
        # log monitor drains the file once more, then evicts it
        self._log.mark_dead(worker_id)
        if w.iclient is not None:
            asyncio.ensure_future(w.iclient.close())
            w.iclient = None
        if w in self._idle:
            self._idle.remove(w)
        if not w.ready.is_set():
            self._starting = max(0, self._starting - 1)
            w.ready.set()  # wake lease grant path; it will re-check
        if w.lease_id is not None:
            lease = self._leases.pop(w.lease_id, None)
            if lease is not None:
                self._gpu_shares.give_back(lease.gpu_shares)
                self._release_lease_resources(lease)
        self.store.release_client(worker_id)
        if self._head is not None:
            asyncio.ensure_future(self._report_worker_death(worker_id, reason))
        self._drain_lease_queue()

    # ---- memory monitor ----------------------------------------------------

    def _worker_samples(self) -> List[memory_monitor.WorkerSample]:
        """Per-LEASED-worker RSS + policy flags for this tick.  Only
        leased workers are candidates — an idle pooled worker holds no
        task to retry and its memory is the interpreter baseline."""
        out: List[memory_monitor.WorkerSample] = []
        for lease in self._leases.values():
            w = lease.worker
            if w.proc.poll() is not None:
                continue
            rss = memory_monitor.read_rss_bytes(w.pid)
            if rss is None:
                continue
            out.append(memory_monitor.WorkerSample(
                worker_id=w.worker_id, rss=rss, lease_seq=lease.seq,
                retriable=lease.retriable, pinned=w.pinned,
                saving=w.saving, fid=lease.fid, name=lease.task_name))
        return out

    def _memory_usage_fraction(
            self, samples: Optional[List] = None) -> Optional[float]:
        """Node memory pressure in [0, 1]; None if unreadable.  Sources
        (memory_monitor.usage_fraction): the test hook file, the virtual
        per-agent envelope (memory_monitor_node_total_bytes), or
        /proc/meminfo."""
        virtual = int(config.memory_monitor_node_total_bytes)
        rss_sum = 0
        if virtual > 0:
            if samples is None:
                samples = self._worker_samples()
            rss_sum = sum(s.rss for s in samples)
        return memory_monitor.usage_fraction(
            config.memory_monitor_test_usage_file, virtual, rss_sum)

    def _oom_receipt(self, victim, usage: float,
                     samples: List) -> Dict[str, Any]:
        """The typed-kill payload: everything the owner needs to turn a
        worker death into a retriable OutOfMemoryError with evidence."""
        return {
            "worker_id": victim.worker_id,
            "node_id": self.node_id,
            "rss": victim.rss,
            "usage": usage,
            "threshold": float(config.memory_usage_threshold),
            # the node's kill ceiling in bytes: victims whose own RSS
            # approaches it are SELF-poisoning — the poison-quarantine
            # counter only counts those, so contention victims of
            # aggregate pressure retry without building a poison record.
            # 0 (= count every kill) when the test usage-file hook
            # drives pressure: synthetic usage says nothing about RSS
            "limit": 0 if config.memory_monitor_test_usage_file
            else int(self._mem_total_bytes
                     * float(config.memory_usage_threshold)),
            "fid": victim.fid,
            "name": victim.name,
            "breakdown": {
                "workers": [[s.worker_id[:12], s.rss] for s in samples],
                "store": {k: v for k, v in self.store.usage().items()
                          if isinstance(v, (int, float))},
            },
        }

    async def _memory_monitor_loop(self):
        """The node OOM watchdog (reference: memory_monitor.h:52):
        sample usage + per-worker RSS each period; past the threshold,
        kill the policy's victim (highest-RSS retriable task first,
        pinned/saving workers last resort — memory_monitor.pick_victim)
        and reply to the owner with a typed receipt BEFORE the SIGKILL,
        so the owner's worker-death accounting draws from the separate
        OOM retry budget instead of max_retries."""
        from ray_tpu_torch._private.metrics import memory_pressure_metrics

        period = config.memory_monitor_refresh_ms / 1000.0
        watchdog = memory_monitor.OomWatchdog(
            threshold=float(config.memory_usage_threshold),
            min_kill_gap_s=config.memory_monitor_min_kill_interval_ms
            / 1000.0)
        oom_kills, pressure_gauge, _ = memory_pressure_metrics()
        while True:
            await asyncio.sleep(period)
            try:
                samples = self._worker_samples()
                usage = self._memory_usage_fraction(samples)
                if usage is not None:
                    self._last_pressure = usage
                    pressure_gauge.set(usage)
                victim = watchdog.tick(usage, samples)
                if victim is None:
                    continue
                oom_kills.inc(tags={"reason": "node_pressure"})
                await self._oom_kill(victim, usage, samples)
            except Exception:
                pass  # the watchdog must survive any single bad tick

    async def _oom_kill(self, victim, usage: float, samples: List) -> None:
        """Execute one watchdog kill: receipt to the owner first (its
        own connection — best-effort, ordered ahead of the worker-socket
        reset it is about to observe), then SIGKILL, then the normal
        death bookkeeping (which reports to the head with the receipt
        attached for poison-task accounting)."""
        w = self._workers.get(victim.worker_id)
        if w is None or w.proc.poll() is not None:
            return
        receipt = self._oom_receipt(victim, usage, samples)
        lease = self._leases.get(w.lease_id) if w.lease_id else None
        if lease is not None and lease.owner_conn is not None \
                and not lease.owner_conn.writer.is_closing():
            try:
                await lease.owner_conn.push("oom_kill", receipt)
            except Exception:
                pass  # owner gone: the generic death path still covers it
        reason = (f"OOM-killed by the memory monitor: node memory "
                  f"{usage:.0%} >= threshold {receipt['threshold']:.0%}, "
                  f"worker RSS {victim.rss >> 20} MiB "
                  f"(victim policy: highest-RSS retriable task)")
        self._oom_reported[victim.worker_id] = receipt
        try:
            w.proc.kill()
        except Exception:
            pass
        self._on_worker_dead(victim.worker_id, reason)

    async def rpc_worker_flags(self, worker_id: str,
                               pinned: Optional[bool] = None,
                               saving: Optional[bool] = None):
        """Worker-pushed OOM-policy flags: entering/leaving a pinned
        __rt_dag_* loop, and the __rt_save__ critical section."""
        w = self._workers.get(worker_id)
        if w is not None:
            if pinned is not None:
                w.pinned = bool(pinned)
            if saving is not None:
                w.saving = bool(saving)
        return {"ok": True}

    async def _report_worker_death(self, worker_id: str, reason: str):
        oom = self._oom_reported.pop(worker_id, None)
        try:
            await self._head.call("worker_died", node_id=self.node_id,
                                  worker_id=worker_id, reason=reason,
                                  oom=oom)
        except Exception:
            pass

    # ---- placement group bundles -------------------------------------------

    async def rpc_reserve_bundle(self, pg_id: str, bundle_index: int,
                                 resources: Dict[str, float],
                                 wait_ms: int = 0, _conn=None):
        """Atomically carve a bundle's resources out of the node pool
        (reference: node_manager.proto PrepareBundleResources).

        With ``wait_ms`` > 0 a reservation that cannot be satisfied right
        now joins the FIFO lease queue instead of failing: the moment a
        warm-pooled task lease returns (worker.py _WARM_LEASE_TTL_S, or
        sooner via the demand-aware reclaim push) the freed capacity
        grants the reservation — placement groups preempt the warm pool
        event-driven rather than the head polling."""
        key = f"{pg_id}:{bundle_index}"
        if key in self._bundles:
            return {"ok": True, "already": True}
        demand = ResourceSet(resources)
        if self.local.try_acquire(demand):
            self._bundles[key] = LocalScheduler(NodeResources(demand))
            return {"ok": True}
        if wait_ms <= 0 or not self.resources.is_feasible(demand):
            return {"ok": False, "error": "insufficient resources"}
        status = await self._queue_for_resources(
            self.local, demand, wait_ms / 1000.0,
            cancel_key=key, registry=self._reserve_tokens)
        if status != "granted":
            return {"ok": False, "error": "insufficient resources"
                    if status == "timeout" else "canceled"}
        if _conn is not None and _conn.writer.is_closing():
            # the head that asked is gone and cannot learn of this grant;
            # its rollback only covers acknowledged reservations — give
            # the capacity back instead of leaking a phantom carve-out
            for tok in self.local.release(demand):
                self._grant_token(tok)
            return {"ok": False, "error": "caller disconnected"}
        self._bundles[key] = LocalScheduler(NodeResources(demand))
        return {"ok": True}

    async def rpc_reserve_bundles(self, pg_id: str, items: List[List[Any]],
                                  wait_ms: int = 0, _conn=None):
        """Batched bundle reservation: every bundle this node hosts for
        one placement group rides a single frame (the PG-commit half of
        the lease-frame batching).  Items reserve in order; the first
        failure stops the pass — the head rolls back what this reply
        reports reserved, so later items must not burn queue waits."""
        out: List[Dict[str, Any]] = []
        for bundle_index, resources in items:
            r = await self.rpc_reserve_bundle(pg_id, int(bundle_index),
                                              resources, wait_ms=wait_ms,
                                              _conn=_conn)
            out.append(r)
            if not r.get("ok"):
                break
        return {"results": out}

    async def rpc_return_bundles(self, pg_id: str, indices: List[int]):
        """Batched bundle return (remove/rollback path)."""
        return {"results": [await self.rpc_return_bundle(pg_id, int(i))
                            for i in indices]}

    async def rpc_cancel_bundle_reservation(self, pg_id: str,
                                            bundle_index: int):
        """Head-side reserve RPC failed (connection drop mid-wait): drop
        the queued reservation, or return the bundle if it already
        granted — either way no capacity stays carved out for a
        reservation the head gave up on."""
        key = f"{pg_id}:{bundle_index}"
        entry = self._reserve_tokens.get(key)
        if entry is not None:
            token, sched = entry
            waiter = self._lease_waiters.pop(token, None)
            if waiter is not None:
                fut = waiter[0]
                _found, granted = sched.cancel(token)
                for tok in granted:
                    self._grant_token(tok)
                if not fut.done():
                    fut.set_result("canceled")
                return {"ok": True}
        if key in self._bundles:
            return await self.rpc_return_bundle(pg_id, bundle_index)
        return {"ok": False}

    async def rpc_return_bundle(self, pg_id: str, bundle_index: int):
        key = f"{pg_id}:{bundle_index}"
        sched = self._bundles.pop(key, None)
        if sched is None:
            return {"ok": False}
        # wake queued lease requests; they re-check and see the bundle gone
        for token in sched.cancel_all():
            self._grant_token(token)
        # kill leases still running against the bundle (reference: PG
        # removal kills its tasks/actors)
        for lease_id, lease in list(self._leases.items()):
            if lease.bundle_key == key:
                self._leases.pop(lease_id, None)
                lease.worker.lease_id = None
                try:
                    lease.worker.proc.terminate()
                except Exception:
                    pass
        for tok in self.local.release(sched.resources.total):
            self._grant_token(tok)
        self._hb_wake.set()
        return {"ok": True}

    def _sched_for(self, ts: TaskSpec):
        """(scheduler, bundle_key) for a task; bundle-targeted tasks draw
        from their reserved bundle, not the free node pool."""
        if ts.placement_group_id:
            key = f"{ts.placement_group_id}:{max(ts.bundle_index, 0)}"
            return self._bundles.get(key), key
        return self.local, ""

    # ---- lease protocol ----------------------------------------------------

    async def rpc_request_lease(self, spec: Dict[str, Any],
                                grant_only: bool = False, req_id: str = "",
                                _conn=None):
        """Grant a worker lease for the task's resource shape.

        Replies: {"granted": {...}} | {"spillback": {...}} | {"error": ...}
        (reference: node_manager.h:520 HandleRequestWorkerLease — the
        spillback reply mirrors the reference's retry_at_raylet_address).
        """
        ts = TaskSpec.from_wire(spec)
        demand = ts.resource_set()
        poisoned = self._quarantined_entry(ts.function_id)
        if poisoned is not None:
            # fail fast BEFORE spending a worker: the class already
            # killed workers poison_task_threshold consecutive times
            return {"error": "poisoned",
                    "error_str": poisoned.get("detail", "quarantined"),
                    "history": poisoned.get("history", [])}
        if self._draining:
            # owners treat this as a retriable lease timeout; by their
            # next ask the drained cluster view routes them elsewhere
            await asyncio.sleep(0.2)  # pace retries against a drainer
            return {"error": "lease timeout", "error_str": "node draining"}
        if not grant_only:
            self._rebind_owner_leases(ts.caller_id, _conn)
        chaos = fault_injection.decide("lease.grant",
                                       key=ts.actor_id or ts.function_id)
        if chaos is not None and chaos.action == "delay":
            await fault_injection.sleep_async(chaos.delay_s)
        if ts.placement_group_id:
            # same grant_only exemption as below: PG-placed ACTORS are
            # head-created, and their leases must never die with a head
            # connection blip
            return await self._request_bundle_lease(
                ts, demand, None if grant_only else _conn, req_id)
        if not grant_only:
            routed = await self._route_lease(ts, demand)
            if routed is not None:
                return routed
        if not self.resources.is_feasible(demand):
            return {"error": "infeasible",
                    "error_str": f"node cannot satisfy {demand.to_dict()}"}
        # the task will run here (or queue here): overlap its argument
        # transfers with the queue wait / worker startup.  grant_only
        # requests come from the head (actor creation): their leases'
        # lifetimes are head-managed, not connection-scoped
        self._prefetch_args(ts)
        return await self._acquire_and_grant(
            self.local, demand, "", ts, None if grant_only else _conn,
            req_id)

    async def _route_lease(self, ts: TaskSpec, demand: ResourceSet):
        """Cluster-policy half of a lease request: None when the task
        should be serviced locally, else the spillback/error reply."""
        cluster = {
            nid: NodeResources.from_dict(
                {"total": v["res"]["total"], "available": v["res"]["available"]})
            for nid, v in self.cluster_view.items()
            # draining nodes accept no new work — never spill back there
            if not v.get("draining")
        }
        # our own view is fresher than the gossiped one
        if not self._draining:
            cluster[self.node_id] = self.resources
        labels = {nid: v.get("labels", {})
                  for nid, v in self.cluster_view.items()}
        labels[self.node_id] = self.labels
        # pressure-aware demotion: nodes past the watchdog threshold
        # (gossiped gauge; our own sample is fresher) rank behind
        # healthy ones, so new work stops piling onto a node whose
        # watchdog is about to start killing
        pressure = {nid: float(v["pressure"])
                    for nid, v in self.cluster_view.items()
                    if v.get("pressure") is not None}
        if self._last_pressure is not None:
            pressure[self.node_id] = self._last_pressure
        target = pick_node(
            cluster, demand, self.node_id,
            spread_threshold=config.scheduler_spread_threshold,
            top_k_fraction=config.scheduler_top_k_fraction,
            top_k_absolute=config.scheduler_top_k_absolute,
            strategy=ts.scheduling_strategy, labels_by_node=labels,
            arg_bytes_by_node=self._arg_bytes_by_node(ts),
            locality_min_bytes=int(config.locality_min_bytes),
            pressure_by_node=pressure,
            pressure_threshold=float(config.memory_usage_threshold))
        if target is None:
            # hard affinity/label constraints name specific nodes;
            # autoscaled capacity can never satisfy them, so they
            # fail now instead of parking forever
            if self._demand_is_scalable(demand) \
                    and not _is_hard_strategy(ts.scheduling_strategy):
                # an autoscaler can launch a node this fits: park the
                # demand (visible to the scale-up loop via heartbeat)
                # and tell the submitter to keep waiting — mirrors the
                # reference, where infeasible tasks pend until the
                # autoscaler resolves them (autoscaler.py demand loop)
                key = repr(sorted(demand.to_dict().items()))
                self._infeasible[key] = (demand.to_dict(),
                                         time.monotonic() + 30.0)
                await asyncio.sleep(1.0)  # pace the submitter's retries
                return {"error": "lease timeout",
                        "error_str": "waiting for cluster scale-up"}
            return {"error": "infeasible",
                    "error_str": f"no node can ever satisfy {demand.to_dict()}"}
        if target != self.node_id:
            view = self.cluster_view.get(target)
            if view is not None:
                return {"spillback": {"node_id": target, "addr": view["addr"]}}
        return None

    async def rpc_request_leases(self, spec: Dict[str, Any], count: int = 1,
                                 req_id: str = "", _conn=None):
        """Batched lease grant: one frame asks for up to `count` workers
        of one resource shape; the reply carries every lease grantable
        RIGHT NOW ({"granted_list": [...]}) so a submission burst costs
        O(1) lease RPC rounds instead of one round (and one agent-FIFO
        slot) per missing lease.

        When nothing is grantable immediately the request degrades to
        the classic single-lease queued wait — capacity freed mid-burst
        still turns into exactly one grant, FIFO-fairly, and the owner's
        post-reply pump re-asks for the rest."""
        ts = TaskSpec.from_wire(spec)
        demand = ts.resource_set()
        poisoned = self._quarantined_entry(ts.function_id)
        if poisoned is not None:
            return {"error": "poisoned",
                    "error_str": poisoned.get("detail", "quarantined"),
                    "history": poisoned.get("history", [])}
        if self._draining:
            await asyncio.sleep(0.2)
            return {"error": "lease timeout", "error_str": "node draining"}
        self._rebind_owner_leases(ts.caller_id, _conn)
        chaos = fault_injection.decide("lease.grant",
                                       key=ts.actor_id or ts.function_id)
        if chaos is not None and chaos.action == "delay":
            await fault_injection.sleep_async(chaos.delay_s)
        count = max(1, min(int(count), int(config.lease_request_batch_max)))
        if ts.placement_group_id:
            sched, key = self._sched_for(ts)
            if sched is None:
                return {"error": "bundle not reserved",
                        "error_str": f"bundle {key} is not on node "
                                     f"{self.node_id[:12]}"}
            if not sched.resources.is_feasible(demand):
                return {"error": "infeasible",
                        "error_str": f"demand {demand.to_dict()} exceeds "
                                     f"bundle {key} capacity"}
            self._prefetch_args(ts)
            return await self._grant_many(sched, demand, count, key, ts,
                                          _conn, req_id)
        routed = await self._route_lease(ts, demand)
        if routed is not None:
            return routed
        if not self.resources.is_feasible(demand):
            return {"error": "infeasible",
                    "error_str": f"node cannot satisfy {demand.to_dict()}"}
        self._prefetch_args(ts)
        return await self._grant_many(self.local, demand, count, "", ts,
                                      _conn, req_id)

    async def _grant_many(self, sched: LocalScheduler, demand: ResourceSet,
                          count: int, bundle_key: str, ts: TaskSpec,
                          conn=None, req_id: str = ""):
        n = sched.acquire_many(demand, count)
        if n == 0:
            # nothing free right now: fall back to ONE queued request so
            # the frame still resolves the moment capacity frees
            r = await self._acquire_and_grant(sched, demand, bundle_key,
                                              ts, conn, req_id)
            return self._as_grant_list(r)
        # the reply ships at FIRST worker ready (plus a short straggler
        # window), not when the slowest of n spawns registers — a cold
        # burst must start executing at first-worker-ready, exactly like
        # the old serial per-lease requests did.  Late-materializing
        # grants park into the idle pool; the owner's follow-up ask
        # (its deficit persists) pops them with no spawn cost.
        futs = [asyncio.ensure_future(
            self._grant_safe(sched, demand, bundle_key, ts, conn))
            for _ in range(n)]
        done, pending = await asyncio.wait(
            futs, return_when=asyncio.FIRST_COMPLETED)
        if pending:
            done2, pending = await asyncio.wait(pending, timeout=0.05)
            done |= done2
        for f in pending:
            f.add_done_callback(self._park_late_grant)
        granted = [f.result()["granted"] for f in done
                   if "granted" in f.result()]
        if granted:
            return {"granted_list": granted}
        if pending:
            # every completed attempt failed but workers are still
            # starting: tell the owner to re-ask, not to error out
            return {"error": "lease timeout",
                    "error_str": "workers still starting"}
        return self._as_grant_list(next(iter(done)).result())

    def _park_late_grant(self, fut) -> None:
        """A grant completed after its request_leases frame shipped: the
        owner never heard of this lease, so hand it straight back — the
        worker idles in the pool and the resources free for the owner's
        follow-up ask."""
        try:
            r = fut.result()
        except Exception:
            return
        g = r.get("granted")
        if g:
            asyncio.ensure_future(
                self.rpc_return_lease(g["lease_id"], kill_worker=False))

    @staticmethod
    def _as_grant_list(reply: Dict[str, Any]) -> Dict[str, Any]:
        if "granted" in reply:
            return {"granted_list": [reply["granted"]]}
        return reply

    def _demand_is_scalable(self, demand: ResourceSet) -> bool:
        """True if some autoscaler-launchable node type could fit this."""
        return any(shape.fits(demand) for shape in self.scalable_shapes)

    async def _request_bundle_lease(self, ts: TaskSpec, demand: ResourceSet,
                                    conn=None, req_id: str = ""):
        sched, key = self._sched_for(ts)
        if sched is None:
            return {"error": "bundle not reserved",
                    "error_str": f"bundle {key} is not on node "
                                 f"{self.node_id[:12]}"}
        if not sched.resources.is_feasible(demand):
            return {"error": "infeasible",
                    "error_str": f"demand {demand.to_dict()} exceeds bundle "
                                 f"{key} capacity"}
        self._prefetch_args(ts)
        return await self._acquire_and_grant(sched, demand, key, ts, conn,
                                             req_id)

    async def _queue_for_resources(self, sched: LocalScheduler,
                                   demand: ResourceSet, wait_s: float,
                                   cancel_key: Optional[str] = None,
                                   registry: Optional[Dict] = None) -> str:
        """Enqueue demand on a scheduler's FIFO and wait for it.

        Returns "granted" (the demand's resources are acquired — note a
        bundle-removal wake also reports granted; callers re-check their
        bundle), "canceled" (dropped via cancel_key, nothing acquired),
        or "timeout" (nothing acquired).  Handles the
        granted-between-timeout-and-cancel race in one place for lease
        requests and bundle reservations alike."""
        token = object()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._lease_waiters[token] = (fut, demand, sched)
        if registry is not None and cancel_key is not None:
            registry[cancel_key] = (token, sched)
        sched.enqueue(token, demand)
        if sched is self.local:
            # only node-pool demand benefits from reclaiming lingering
            # leases; bundle-internal queues resolve within the bundle
            self._reclaim_idle_leases()
        try:
            res = await asyncio.wait_for(fut, wait_s)
        except asyncio.TimeoutError:
            found, granted = sched.cancel(token)
            self._lease_waiters.pop(token, None)
            for tok in granted:
                self._grant_token(tok)
            if not found and fut.done() and not fut.cancelled() \
                    and fut.result() != "canceled":
                return "granted"  # won the race; resources are ours
            # if fut is cancelled, _grant_token already gave the
            # acquired resources back — nothing more to do here
            return "timeout"
        finally:
            if registry is not None and cancel_key is not None:
                registry.pop(cancel_key, None)
        return "canceled" if res == "canceled" else "granted"

    async def _acquire_and_grant(self, sched: LocalScheduler,
                                 demand: ResourceSet, bundle_key: str,
                                 ts: Optional[TaskSpec] = None, conn=None,
                                 req_id: str = ""):
        if sched.try_acquire(demand):
            return await self._grant_safe(sched, demand, bundle_key, ts, conn)
        # a deadlined spec queues only for its remaining budget: a lease
        # request whose task can no longer finish in time is dropped
        # from the FIFO and the owner notified (it fails the expired
        # tasks fast instead of letting them camp on this agent's queue)
        wait_s = config.worker_lease_timeout_ms / 1000.0
        dl = ts.deadline if ts is not None else 0.0
        if dl:
            rem = dl - time.time()
            if rem <= 0:
                return {"error": "deadline exceeded",
                        "error_str": "task deadline expired before a "
                                     "worker lease was available"}
            wait_s = min(wait_s, rem)
        status = await self._queue_for_resources(
            sched, demand, wait_s,
            cancel_key=req_id or None, registry=self._lease_req_tokens)
        if status == "canceled":
            # owner's demand drained before a grant; nothing was acquired
            return {"error": "canceled",
                    "error_str": "lease request canceled by owner"}
        if status == "timeout":
            if dl and time.time() >= dl:
                return {"error": "deadline exceeded",
                        "error_str": "task deadline expired while queued "
                                     "for a worker lease"}
            return {"error": "lease timeout",
                    "error_str": "timed out waiting for resources"}
        if bundle_key and bundle_key not in self._bundles:
            # woken because the bundle was removed, not granted
            return {"error": "bundle not reserved",
                    "error_str": "placement group removed while queued"}
        return await self._grant_safe(sched, demand, bundle_key, ts, conn)

    async def rpc_cancel_lease_request(self, req_id: str):
        """Owner-side demand for a queued lease request drained: drop it
        from the FIFO so it is never granted into an idle linger
        (reference: node_manager.proto CancelWorkerLease)."""
        entry = self._lease_req_tokens.pop(req_id, None)
        if entry is None:
            return {"ok": False}  # unknown, or already granted
        token, sched = entry
        waiter = self._lease_waiters.pop(token, None)
        if waiter is None:
            return {"ok": False}  # granted in the meantime
        fut = waiter[0]
        _found, granted = sched.cancel(token)
        for tok in granted:
            self._grant_token(tok)
        if not fut.done():
            fut.set_result("canceled")
        return {"ok": True}

    def _reclaim_idle_leases(self) -> None:
        """Demand just queued behind granted leases: ask every lease's
        owner to hand back warm-pooled leases RIGHT NOW instead of
        letting them sit out the owner-side warm-lease TTL (worker.py
        _WARM_LEASE_TTL_S).  The push carries the aggregate queued
        demand so owners return only enough capacity to cover it and
        keep the rest of their pool warm.  Best-effort oneway pushes; an
        owner that just assigned a task simply ignores the request.
        This is what keeps placement-group reservation latency flat
        right after a task burst (reference: the raylet revoking unused
        workers via ReleaseUnusedWorkers when demand arrives)."""
        now = time.monotonic()
        if now - self._last_reclaim < 0.05:  # coalesce bursts of queuers
            # trailing edge: a waiter that queued just after the last
            # push still gets its demand to owners once the window ends
            # (the need snapshot below is recomputed at fire time), so
            # owners' need-bounded covered() check can't strand it until
            # the warm-lease TTL sweep
            if not self._reclaim_followup:
                self._reclaim_followup = True

                def _fire():
                    self._reclaim_followup = False
                    # only node-pool waiters count — they are what the
                    # need snapshot aggregates; a push for a purely
                    # bundle-internal queue would carry need={}, which
                    # owners read as unbounded and answer by evicting
                    # their whole warm pool
                    if any(sched is self.local for _, _, sched
                           in self._lease_waiters.values()):
                        self._reclaim_idle_leases()

                asyncio.get_running_loop().call_later(
                    0.05 - (now - self._last_reclaim), _fire)
            return
        self._last_reclaim = now
        conns = {id(l.owner_conn): l.owner_conn
                 for l in self._leases.values()
                 if l.owner_conn is not None}

        # aggregate node-pool demand currently queued (bundle-internal
        # queues resolve within their bundle and are excluded)
        need: Dict[str, float] = {}
        for fut, demand, sched in self._lease_waiters.values():
            if sched is not self.local:
                continue
            for k, v in demand.to_dict().items():
                need[k] = need.get(k, 0.0) + v

        payload = {"agent": [self.host, self.port], "need": need}

        async def _push(conn):
            try:
                await conn.push("reclaim_idle_leases", payload)
            except Exception:
                pass

        for conn in conns.values():
            asyncio.ensure_future(_push(conn))

    def _grant_token(self, token: object):
        entry = self._lease_waiters.pop(token, None)
        if entry is None:
            return
        fut, demand, sched = entry
        if not fut.done():
            fut.set_result(True)
        else:
            # waiter gave up after the queue acquired on its behalf
            for tok in sched.release(demand):
                self._grant_token(tok)

    def _drain_lease_queue(self):
        # unblocked-but-unreacquired leases first: they represent work
        # ALREADY running oversubscribed, ahead of queued new work
        self._retry_unblocks()
        for sched in [self.local, *self._bundles.values()]:
            for tok in sched.drain():
                self._grant_token(tok)

    async def _grant_safe(self, sched: LocalScheduler, demand: ResourceSet,
                          bundle_key: str = "",
                          ts: Optional[TaskSpec] = None, conn=None):
        """_grant, releasing the already-acquired resources if it raises
        unexpectedly — a grant-path bug must not leak node capacity."""
        try:
            return await self._grant(sched, demand, bundle_key, ts, conn)
        except Exception as exc:
            for tok in sched.release(demand):
                self._grant_token(tok)
            return {"error": "grant failed",
                    "error_str": f"{type(exc).__name__}: {exc}"}

    async def _grant(self, sched: LocalScheduler, demand: ResourceSet,
                     bundle_key: str = "", ts: Optional[TaskSpec] = None,
                     conn=None):
        # `demand` resources are already acquired from `sched`
        renv = ts.runtime_env if ts is not None else {}
        try:
            worker = await self._pop_worker(renv)
        except RuntimeEnvSetupError as exc:
            worker = None
            for tok in sched.release(demand):
                self._grant_token(tok)
            return {"error": "runtime env setup failed",
                    "error_str": str(exc)}
        if worker is None:
            for tok in sched.release(demand):
                self._grant_token(tok)
            return {"error": "worker spawn failed",
                    "error_str": "could not start a worker process"}
        self._lease_counter += 1
        lease_id = f"{self.node_id[:12]}-{self._lease_counter}"
        lease = _Lease(lease_id, worker, demand, bundle_key,
                       seq=self._lease_counter, owner_conn=conn,
                       owner_id=ts.caller_id if ts is not None else "",
                       owner_addr=ts.owner_addr if ts is not None else None,
                       # actors hold their lease for life: killing one is
                       # an actor death, never a transparent task retry.
                       # Normal tasks are ALWAYS OOM-retriable — even
                       # max_retries=0 ones, since watchdog kills draw
                       # from the separate task_oom_retries budget
                       retriable=(ts is not None
                                  and ts.kind == NORMAL_TASK),
                       fid=ts.function_id if ts is not None else "",
                       task_name=(ts.name or ts.method_name)
                       if ts is not None else "")
        n_gpu = demand.to_dict().get(GPU_RESOURCE, 0)
        if n_gpu > 0:
            lease.gpu_shares = self._gpu_shares.take(n_gpu)
            lease.gpu_ids = list(lease.gpu_shares)
        worker.lease_id = lease_id
        self._leases[lease_id] = lease
        if conn is not None and conn.writer.is_closing():
            # the owner's connection died while the worker spawned: the
            # reply goes nowhere and on_peer_disconnect scanned BEFORE
            # this lease existed — hand it straight back (worker idles
            # for reuse) instead of leaking it forever
            asyncio.ensure_future(
                self.rpc_return_lease(lease_id, kill_worker=False))
            return {"error": "caller disconnected",
                    "error_str": "owner connection closed mid-grant"}
        return {"granted": {
            "lease_id": lease_id,
            "worker_id": worker.worker_id,
            "addr": [self.host, worker.port],
            "node_id": self.node_id,
            "gpu_ids": lease.gpu_ids,
        }}

    def _spawn_gate(self) -> asyncio.Semaphore:
        if self._spawn_sem is None:
            self._spawn_sem = asyncio.Semaphore(
                max(1, int(config.worker_startup_parallelism)))
        return self._spawn_sem

    async def _pop_worker(self, renv: Optional[Dict[str, Any]] = None
                          ) -> Optional[_Worker]:
        from ray_tpu_torch._private.runtime_env import env_key as _env_key

        renv = renv or {}
        key = _env_key(renv)
        spawn_kwargs: Dict[str, Any] = {}
        if renv:
            # materialize BEFORE spawning: fetch/extract packages once
            # per content hash (cached under session_dir/runtime_envs)
            from ray_tpu_torch._private import runtime_env as renv_mod

            try:
                env_vars, working_dir, path_dirs = await renv_mod.materialize(
                    renv, self.session_dir, self._head)
            except Exception as exc:
                raise RuntimeEnvSetupError(
                    f"runtime env materialization failed: {exc}") from exc
            spawn_kwargs = {"env_key": key, "extra_env": env_vars,
                            "working_dir": working_dir,
                            "path_dirs": path_dirs}
        def pop_idle() -> Optional[_Worker]:
            for i in range(len(self._idle) - 1, -1, -1):
                w = self._idle[i]
                if w.env_key != key:
                    continue
                del self._idle[i]
                if w.proc.poll() is None:
                    return w
                self._on_worker_dead(w.worker_id, "dead on pop")
            return None

        for _attempt in range(3):
            w = pop_idle()
            if w is not None:
                return w
            # spawn throttle: N concurrent lease grants must not fork N
            # interpreters at once — an unbounded spawn storm (200 actor
            # creations) starves every child of CPU until ALL of them
            # miss the register timeout and the whole batch dies.  The
            # gate bounds concurrent starting workers to
            # worker_startup_parallelism; the register-timeout clock only
            # starts once the spawn actually begins.
            async with self._spawn_gate():
                w = pop_idle()  # freed while queued at the gate
                if w is not None:
                    return w
                w = self._spawn_worker(**spawn_kwargs)
                try:
                    await asyncio.wait_for(w.ready.wait(),
                                           config.worker_register_timeout_s)
                except asyncio.TimeoutError:
                    try:
                        w.proc.kill()
                    except Exception:
                        pass
                    self._on_worker_dead(w.worker_id, "startup timeout")
                    return None
            if w.worker_id not in self._workers:  # died during startup
                return None
            if w.lease_id is not None:
                # a queued lease drained on worker_ready and claimed this
                # worker before our wait resumed — start over
                continue
            if w in self._idle:
                self._idle.remove(w)
            return w
        return None

    def _lease_sched(self, lease: _Lease) -> LocalScheduler:
        if lease.bundle_key:
            sched = self._bundles.get(lease.bundle_key)
            if sched is not None:
                return sched
            # bundle already returned: its resources went back to the
            # node pool wholesale; nothing further to release
            return LocalScheduler(NodeResources(lease.resources))
        return self.local

    async def rpc_return_lease(self, lease_id: str, kill_worker: bool = False):
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return {"ok": False}
        self._gpu_shares.give_back(lease.gpu_shares)
        w = lease.worker
        w.lease_id = None
        if kill_worker or w.proc.poll() is not None:
            try:
                w.proc.terminate()
            except Exception:
                pass
        else:
            w.idle_since = time.monotonic()
            self._idle.append(w)
        self._release_lease_resources(lease)
        return {"ok": True}

    def _release_lease_resources(self, lease: _Lease) -> None:
        """Return a finished lease's still-held resources to the pool —
        the full set normally, or only the undonated (accelerator)
        remainder when the lease died/returned while blocked."""
        if lease.blocked and lease.donated is not None:
            donated_keys = set(lease.donated.to_dict())
            held = ResourceSet({k: v for k, v in
                                lease.resources.to_dict().items()
                                if k not in donated_keys})
        else:
            held = lease.resources
        sched = self._lease_sched(lease)
        sched.resources.release(held)
        # already-running oversubscribed work re-acquires BEFORE queued
        # new work gets the freed capacity
        self._retry_unblocks()
        for tok in sched.drain():
            self._grant_token(tok)
        self._hb_wake.set()

    # ---- blocked-worker resource release -----------------------------------
    # A worker blocked in get() inside a task hands its lease's resources
    # back so nested tasks can schedule — without this, N-deep task
    # nesting deadlocks once depth exceeds the node's CPU count
    # (reference: node_manager.cc HandleWorkerBlocked: "the worker is
    # blocked waiting for objects; release its CPU resources").

    def _lease_of_worker(self, worker_id: str) -> Optional[_Lease]:
        w = self._workers.get(worker_id)
        if w is None or w.lease_id is None:
            return None
        return self._leases.get(w.lease_id)

    async def rpc_worker_blocked(self, worker_id: str):
        lease = self._lease_of_worker(worker_id)
        if lease is not None:
            # a worker re-blocking must cancel any stale pending
            # re-acquire — retrying it would hand CPU to a worker that is
            # genuinely blocked, starving the nested task it waits on
            self._unblock_pending.discard(lease.lease_id)
        if lease is not None and not lease.blocked:
            # CPU only, exactly the reference's HandleWorkerBlocked:
            # accelerator counts map to concrete cards the lease keeps,
            # gang-anchor resources (node:<id>) must not
            # double-place while their holder merely waits on objects
            cpu = lease.resources.to_dict().get("CPU", 0.0)
            if cpu > 0:
                donated = ResourceSet({"CPU": cpu})
                lease.blocked = True
                lease.donated = donated
                for tok in self._lease_sched(lease).release(donated):
                    self._grant_token(tok)
        return {"ok": True}

    async def rpc_worker_unblocked(self, worker_id: str):
        lease = self._lease_of_worker(worker_id)
        if lease is not None and lease.blocked:
            self._try_reacquire(lease)
            if lease.blocked:
                # pool busy right now: _drain_lease_queue retries on
                # every release, so the oversubscription window closes
                # as soon as capacity frees
                self._unblock_pending.add(lease.lease_id)
        return {"ok": True}

    def _try_reacquire(self, lease: _Lease) -> None:
        """Direct re-acquire, bypassing the FIFO queue: the task is
        already running and must not stall behind queued leases."""
        if self._lease_sched(lease).resources.acquire(lease.donated):
            lease.blocked = False
            lease.donated = None
            self._unblock_pending.discard(lease.lease_id)

    def _retry_unblocks(self) -> None:
        for lease_id in list(self._unblock_pending):
            lease = self._leases.get(lease_id)
            if lease is None or not lease.blocked:
                self._unblock_pending.discard(lease_id)
                continue
            self._try_reacquire(lease)

    # ---- live introspection (profiling.py + log_monitor.py) ----------------

    def on_peer_disconnect(self, conn) -> None:
        self._log.unsubscribe(conn)
        # leases granted over this connection die with it: an owner that
        # exited without returning its leases (driver crash, or a clean
        # shutdown racing the warm-pool TTL sweep) would otherwise pin
        # node capacity forever — with batched grants a single dead
        # owner could hold EVERY cpu (reference: raylet DisconnectClient
        # destroying the client's leased workers).  Head-granted actor
        # leases carry owner_conn=None (grant_only) and are exempt: a
        # head connection blip must never kill live actors.  The reap
        # waits out a grace window first: a TRANSIENT drop from a live
        # owner is survivable — its next lease request (reconnect-on-
        # demand) re-binds the leases to the new connection.
        orphaned = [lid for lid, lease in self._leases.items()
                    if lease.owner_conn is conn]
        if orphaned:
            asyncio.get_running_loop().call_later(
                float(config.lease_orphan_grace_s),
                self._reap_orphans, conn, orphaned)

    def _reap_orphans(self, conn, lease_ids: List[str]) -> None:
        asyncio.ensure_future(self._reap_orphans_async(conn, lease_ids))

    async def _reap_orphans_async(self, conn, lease_ids: List[str]) -> None:
        leases = [l for l in (self._leases.get(lid) for lid in lease_ids)
                  if l is not None and l.owner_conn is conn]
        if not leases:
            return  # returned, or re-bound by a reconnected owner
        owner_addr = next((l.owner_addr for l in leases if l.owner_addr),
                          None)
        if owner_addr is not None:
            # the control connection dropped but the owner may be alive
            # (transient network blip, long-running tasks needing no new
            # leases): ping its own RPC server before killing anything.
            # A live owner keeps its leases — it returns them itself
            # (warm-pool TTL sweep / explicit returns, both of which
            # work over a fresh connection).
            probe = RpcClient(owner_addr[0], owner_addr[1],
                              label="owner-probe")
            try:
                await probe.call("ping", timeout=3.0)
                return  # owner alive
            except Exception:
                pass  # unreachable: genuinely dead — reclaim
            finally:
                await probe.close()
        for lease in leases:
            if lease.owner_conn is conn:  # still unclaimed
                await self.rpc_return_lease(lease.lease_id,
                                            kill_worker=True)

    def _rebind_owner_leases(self, caller_id: str, conn) -> None:
        """An owner is talking to us on `conn`: any lease it holds whose
        recorded connection has died (transient drop, since replaced)
        re-binds here, cancelling the pending orphan reap for it."""
        if not caller_id or conn is None:
            return
        for lease in self._leases.values():
            if (lease.owner_id == caller_id
                    and lease.owner_conn is not None
                    and lease.owner_conn is not conn
                    and lease.owner_conn.writer.is_closing()):
                lease.owner_conn = conn

    async def rpc_subscribe_logs(self, tail: int = 0, _conn=None):
        """Stream this node's worker-log increments to the caller as
        ``log_lines`` oneway pushes on this connection (reference:
        _private/log_monitor.py:103 — the driver-side `(pid=, node=)`
        log streaming).  Returns up to ``tail`` backlog lines/file."""
        if _conn is None:
            return {"ok": False, "error": "no connection"}
        backlog = self._log.subscribe(_conn, tail=int(tail))
        return {"ok": True, "node_id": self.node_id, "backlog": backlog}

    async def rpc_unsubscribe_logs(self, _conn=None):
        if _conn is not None:
            self._log.unsubscribe(_conn)
        return {"ok": True}

    async def rpc_tail_logs(self, lines: int = 100):
        """One-shot: last N lines of every worker log this agent owns."""
        return {"ok": True, "node_id": self.node_id,
                "batch": self._log.tail(int(lines))}

    async def _call_worker(self, w: _Worker, method: str, timeout: float,
                           **payload):
        """Introspection RPC to a pooled worker's server over a pooled
        per-worker client (reconnect-on-demand): the 5s memory scan
        fans out to every worker, so a transient connection per call
        would be N dial/close cycles per scan, forever.  Closed by
        _on_worker_dead / stop()."""
        if w.iclient is None:
            w.iclient = RpcClient("127.0.0.1", w.port,
                                  label=f"introspect-{w.pid}")
        return await w.iclient.call(method, timeout=timeout, **payload)

    async def rpc_node_stacks(self, timeout_s: float = 5.0):
        """Aggregate live stack dumps: this agent process plus every
        ready worker it pools (the `rtpu stack <node>` payload)."""
        from ray_tpu_torch._private.profiling import proc_stack_payload

        result: Dict[str, Any] = {"node_id": self.node_id,
                                  "agent": proc_stack_payload(),
                                  "workers": {}}

        async def one(w: _Worker):
            try:
                result["workers"][w.worker_id] = await asyncio.wait_for(
                    self._call_worker(w, "proc_stack", timeout_s),
                    timeout_s + 1.0)
            except Exception as e:
                result["workers"][w.worker_id] = {
                    "pid": w.pid, "error": f"{type(e).__name__}: {e}"}

        await asyncio.gather(*(one(w) for w in list(self._workers.values())
                               if w.ready.is_set() and w.port
                               and w.proc.poll() is None))
        return result

    async def rpc_profile_worker(self, worker: str, hz: float = 0,
                                 duration_s: float = 2.0,
                                 fmt: str = "collapsed"):
        """Proxy a sampling-profiler run to one of this node's workers
        (matched by worker-id prefix).  Blocks for the duration."""
        target = next((w for wid, w in self._workers.items()
                       if wid.startswith(worker) and w.ready.is_set()
                       and w.port and w.proc.poll() is None), None)
        if target is None:
            return {"found": False}
        reply = await self._call_worker(
            target, "profile", float(duration_s) + 30.0, op="run", hz=hz,
            duration_s=duration_s, fmt=fmt)
        reply["found"] = True
        reply["worker_id"] = target.worker_id
        return reply

    # ---- misc --------------------------------------------------------------

    async def rpc_node_info(self):
        return {
            "node_id": self.node_id,
            "addr": [self.host, self.port],
            "arena_path": self.arena_path,
            "resources": self.resources.to_dict(),
            "num_workers": len(self._workers),
            "num_idle": len(self._idle),
            "num_leases": len(self._leases),
            "draining": self._draining,
            "store": self.store.usage(),
            "xfer_port": self.xfer_port,
            "xfer_stats": dict(self.xfer_stats),
        }

    async def rpc_ping(self):
        return {"pong": True}

    async def rpc_shutdown_node(self):
        self._shutdown.set()


def main():
    """Entry: `python -m ray_tpu_torch._private.node_agent ...`."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--head-host", required=True)
    ap.add_argument("--head-port", type=int, required=True)
    ap.add_argument("--session-dir", required=True)
    ap.add_argument("--resources", default="{}")  # JSON dict
    ap.add_argument("--capacity", type=int, default=0)
    ap.add_argument("--is-head-node", action="store_true")
    ap.add_argument("--port-file", default="")
    ap.add_argument("--node-id", default="")
    ap.add_argument("--labels", default="{}")  # JSON dict
    args = ap.parse_args()

    async def run():
        agent = NodeAgent(
            (args.head_host, args.head_port), args.session_dir,
            json.loads(args.resources), capacity=args.capacity,
            is_head_node=args.is_head_node, node_id=args.node_id,
            labels=json.loads(args.labels))
        port = await agent.start()
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{port}\n{agent.node_id}\n{agent.arena_path}")
            os.replace(tmp, args.port_file)
        sys.stdout.write(f"ray_tpu node agent {agent.node_id[:12]} on port {port}\n")
        sys.stdout.flush()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, agent._shutdown.set)
        await agent.wait_for_shutdown()
        await agent.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
