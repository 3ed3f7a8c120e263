"""CoreWorker: the in-process runtime of every driver and worker.

Ported from ray_tpu's CoreWorker: a lease's ``gpu_ids`` become the
executing worker's CUDA_VISIBLE_DEVICES (``_apply_gpu_env``), and the
value the process started with stays readable
(``SPAWN_VISIBLE_DEVICES``).

Equivalent of the reference's CoreWorker
(reference: src/ray/core_worker/core_worker.h:291 — SubmitTask :910,
SubmitActorTask :986, Put :584, Get :739; transport in
src/ray/core_worker/transport/direct_task_transport.h:79 and
direct_actor_task_submitter.h).

Threading model (reference: core_worker_process.h io_service):
  - the user's thread calls the public API (submit/get/put/wait)
  - all RPC (one server + pooled clients) runs on one EventLoopThread
  - worker mode executes tasks on the process main thread, fed by a
    thread-safe queue from the RPC loop

Task path (reference call stack SURVEY §3.2): submit → owner-side
dependency resolution (inline promotion) → worker lease from the node
agent (hybrid policy, spillback) → direct push_task RPC to the leased
worker → returns inlined in the reply (< max_direct_call_object_size)
or sealed into the worker-node's shared-memory store.

Ownership (reference: reference_count.h): the submitter owns task
returns and its own puts.  Borrows are registered race-free by
piggybacking on the task reply ("borrows": arg refs the worker kept;
"nested": refs embedded in returns, acked before the worker drops its
pins).
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import os
import queue
import random
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import cloudpickle
from concurrent.futures import CancelledError as _futures_cancelled

from ray_tpu_torch._private import deadlines, serialization
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.errors import (TaskCancelledError,
                                     ActorDiedError, DeadlineExceededError,
                                     GetTimeoutError,
                                     ObjectFreedError, ObjectLostError,
                                     OutOfMemoryError, PoisonedTaskError,
                                     RayTaskError, RayWorkerError,
                                     RuntimeEnvSetupError, SchedulingError)
from ray_tpu_torch._private.function_manager import FunctionManager
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef, SerializationContext
from ray_tpu_torch._private.object_store import PlasmaClient
from ray_tpu_torch._private.profiling import IntrospectionRpcMixin, loop_lag_probe
from ray_tpu_torch._private.reference_count import ReferenceCounter
from ray_tpu_torch._private.streaming import (STREAMING, ObjectRefGenerator,
                                        StreamState)
from ray_tpu_torch._private import tracing
from ray_tpu_torch._private.rpc import (ConnectionLost, EventLoopThread, RpcClient,
                                  RpcError, RpcHost, RpcServer, SyncRpcClient,
                                  is_loopback)
from ray_tpu_torch._private.task_spec import (ACTOR_CREATION_TASK, ACTOR_TASK,
                                        NORMAL_TASK, TaskSpec, WireArg)

MODE_DRIVER = "driver"
MODE_WORKER = "worker"

# owner-local poison-quarantine cache window: fail-fast verdicts learned
# from kill reports / refused leases are honored at most this long
# before the next submission re-validates through the lease layer — a
# `rtpu quarantine clear` becomes effective cluster-wide within one
# window + a heartbeat, while the fail-fast still never churns workers
# (the lease refusal is a cheap RPC, not a spawn)
_POISON_CACHE_S = 5.0

# MPMD pipeline-stage system methods (train/pipeline.py): named with the
# "__rt_dag_" prefix so they ride the compiled-DAG dispatch branch in
# _execute_inner (pinned exec loop, exempt from per-method state autosave,
# never shadowed by ActorHandle attribute lookup)
PIPELINE_EXEC_METHOD = "__rt_dag_pipeline_loop__"
PIPELINE_CTL_METHOD = "__rt_dag_pipeline_ctl__"
# LLM serving decode loop (serve/llm.py): same pinned-loop contract —
# the serve controller installs one per llm_deployment replica
LLM_EXEC_METHOD = "__rt_dag_llm_loop__"

_TASK_PUSH_TIMEOUT = 7 * 86400.0  # tasks may legitimately run for days
_WARM_LEASE_TTL_S = 0.2  # idle leases stay pooled this long before return
_LOCALITY_DEFER_S = 1.0  # max time the pump holds a task back waiting
# for a lease on the node that already holds its argument bytes
_PIPELINE_DEPTH_MAX = 24  # cap on tasks in flight per leased worker
_PIPELINE_BUDGET_S = 0.024  # per-lease pipeline covers this much work:
# depth = budget / measured per-task EXECUTION time, so sub-ms tasks
# pipeline at _PIPELINE_DEPTH_MAX while 24ms+ tasks dispatch one at a
# time (spread across workers) — a continuous curve, not a cliff
_SERVICE_WINDOW_S = 2.0  # service-time samples decay on this horizon
_MAX_RECONSTRUCTION_ROUNDS = 10  # get() retry rounds across object losses
_MAX_LEASES_PER_CLASS = 16
_MAX_ACTOR_INFLIGHT = 1000

_global_worker: Optional["CoreWorker"] = None
_global_lock = threading.Lock()

# CUDA_VISIBLE_DEVICES as this process started with it: a worker's is
# its node agent's, or None when the agent had none (every card of the
# node).  _apply_gpu_env changes the live variable per lease; this stays.
SPAWN_VISIBLE_DEVICES = os.environ.get("CUDA_VISIBLE_DEVICES")

# root of the ray_tpu package: frames under it are framework internals,
# the first frame OUTSIDE it is the user call-site recorded per ref
# (trailing separator so a sibling dir sharing the prefix doesn't match)
_PKG_DIR = os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))) + os.sep


def _user_call_site() -> str:
    """file:line:function of the first non-framework frame on this
    thread's stack — the `rtpu memory` attribution for a put()/.remote()
    minted ref.  A bounded frame walk (~1µs), gated by
    memory_record_call_sites for hot paths that can't spare it."""
    if not config.memory_record_call_sites:
        return ""
    try:
        f = sys._getframe(2)
        for _ in range(32):
            if f is None:
                return ""
            fn = f.f_code.co_filename
            if not fn.startswith(_PKG_DIR):
                return (f"{os.path.basename(fn)}:{f.f_lineno}:"
                        f"{f.f_code.co_name}")
            f = f.f_back
    except Exception:
        pass
    return ""


def _live_channel_oids() -> List[str]:
    """Channel-slot oids claimed by live compiled graphs in THIS process
    (empty when the dag subsystem was never imported) — reported in the
    memory summary so the head's channel-leak tripwire knows which store
    slots are still legitimately owned."""
    mod = sys.modules.get("ray_tpu_torch.dag.execution")
    if mod is None:
        return []
    try:
        return list(mod.live_channel_oids())
    except Exception:
        return []


def global_worker_or_none() -> Optional["CoreWorker"]:
    return _global_worker


def set_global_worker(w: Optional["CoreWorker"]) -> None:
    global _global_worker
    with _global_lock:
        _global_worker = w


class _ExecState(threading.local):
    task_id: str = ""
    job_id: str = ""
    num_returns: int = 0


class _ExecShadow:
    """Per-coroutine snapshot of _ExecState: async task bodies run on
    the shared loop thread where the exec thread's threading.local is
    invisible; a contextvar carries this shadow instead (isolated per
    asyncio.Task, so interleaved coroutines can't see each other's)."""

    __slots__ = ("task_id", "job_id", "num_returns")

    def __init__(self, src: "_ExecState"):
        self.task_id = src.task_id
        self.job_id = src.job_id
        self.num_returns = src.num_returns


_exec_ctx = contextvars.ContextVar("rt_exec_shadow", default=None)


class _TaskState:
    __slots__ = ("spec", "contained_refs", "retries_left", "sched_key",
                 "return_oids", "deps_ready", "cancelled", "defer_deadline",
                 "oom_retries_left", "oom_attempt", "oom_delay")

    def __init__(self, spec: TaskSpec, contained_refs: List[ObjectRef]):
        self.spec = spec
        self.contained_refs = contained_refs
        self.retries_left = spec.max_retries
        # watchdog OOM kills draw from their own budget — they must
        # never silently consume max_retries (the kill was the system's
        # choice, not the task's fault), and the jittered exponential
        # backoff below gives pressure time to clear between attempts
        self.oom_retries_left = int(config.task_oom_retries)
        self.oom_attempt = 0
        self.oom_delay = 0.0  # next requeue delay, consumed by the pusher
        self.sched_key = spec.scheduling_class()
        self.deps_ready = True
        self.cancelled = False  # ray_tpu_torch.cancel hit it mid-resolution
        # locality dispatch: how long the pump may hold this task back
        # waiting for a lease on its argument-holding node (0 = not yet
        # deferred; set on first deferral, cleared never — bounded wait)
        self.defer_deadline = 0.0
        self.return_oids = [
            ObjectID.from_index(TaskID.from_hex(spec.task_id), i + 1).hex()
            for i in range(spec.num_returns)
        ]


class _LineageEntry:
    __slots__ = ("spec", "live", "attempts_left", "arg_pins")

    def __init__(self, spec: TaskSpec, arg_pins: List[ObjectRef]):
        self.spec = spec
        self.live: Set[str] = set()   # plasma return oids with live refs
        # reconstruction budget rides the task's retry budget (-1 = infinite,
        # matching _push's retries_left semantics)
        self.attempts_left = spec.max_retries
        self.arg_pins = arg_pins      # holding the refs pins the arg values


class _Lease:
    __slots__ = ("lease_id", "worker_id", "addr", "agent_addr", "inflight",
                 "dead", "failed_head", "gpu_ids", "in_bundle",
                 "pool_key", "resources", "warm_since")

    def __init__(self, lease_id: str, worker_id: str, addr: Tuple[str, int],
                 agent_addr: Tuple[str, int],
                 gpu_ids: Optional[List[str]] = None,
                 in_bundle: bool = False, pool_key: tuple = (),
                 resources: Optional[Dict[str, float]] = None):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.addr = addr
        self.agent_addr = agent_addr
        # concrete cards the lease's node agent assigned; exported to
        # the executing worker as CUDA_VISIBLE_DEVICES
        self.gpu_ids = gpu_ids or []
        # tasks pushed but not yet replied, in push order (the worker
        # executes FIFO, so inflight[0] is the one actually running);
        # pipelining > 1 deep hides the push RPC round-trip (reference:
        # direct_task_transport.h pipelines lease requests + pushes)
        self.inflight: deque = deque()
        self.dead = False
        # snapshotted at death: the one task that was actually executing
        self.failed_head: Optional[_TaskState] = None
        # granted out of a PG bundle's reserved capacity: returning it
        # frees bundle-internal capacity only, so node-pool reclaim
        # pushes must not evict it
        self.in_bundle = in_bundle
        # warm-pool identity: (resource shape, pg/bundle, env, strategy)
        # — everything in the scheduling class EXCEPT the function, so an
        # idle lease outlives its class and any same-shape class adopts
        # it without an agent round trip (see CoreWorker._park_lease)
        self.pool_key = pool_key
        self.resources = resources or {}
        self.warm_since = 0.0


class _ServiceStats:
    """Windowed, time-decayed estimate of a scheduling class's per-task
    *execution* time, used to pick the pipeline depth for its leases.

    Samples are the worker-reported execution wall time carried in every
    result frame ("exec_s"), NOT the owner-observed push round-trip: a
    sync burst's round trip includes the caller's blocking get and the
    whole owner-side turnaround, and an estimator trained on that can
    serialize dispatch for a class whose tasks are actually sub-ms
    (round-5 verdict: 2000 sync tasks collapsed subsequent async
    throughput ~3x).  Execution time is burst-shape-independent.

    Decay is time-based (two rotating windows of _SERVICE_WINDOW_S), so
    a historical burst stops influencing depth within ~2 windows even
    with no new samples — the estimator can never be "stuck" by history.
    """

    __slots__ = ("cur_sum", "cur_n", "prev_mean", "prev_n", "rotated_at")

    def __init__(self):
        self.cur_sum = 0.0
        self.cur_n = 0
        self.prev_mean = 0.0
        self.prev_n = 0
        self.rotated_at = time.monotonic()

    def _rotate(self, now: float) -> None:
        age = now - self.rotated_at
        if age < _SERVICE_WINDOW_S:
            return
        if age < 2 * _SERVICE_WINDOW_S and self.cur_n:
            self.prev_mean = self.cur_sum / self.cur_n
            self.prev_n = self.cur_n
        else:  # idle ≥ 2 windows: everything measured is stale
            self.prev_mean = 0.0
            self.prev_n = 0
        self.cur_sum = 0.0
        self.cur_n = 0
        self.rotated_at = now

    def observe(self, exec_s: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._rotate(now)
        self.cur_sum += max(0.0, exec_s)
        self.cur_n += 1

    def samples(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        self._rotate(now)
        return self.cur_n + self.prev_n

    def mean(self, now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        self._rotate(now)
        # the previous window contributes at most as much weight as a
        # window's worth of fresh samples, so a regime change (fast →
        # slow tasks under one function) wins within one window
        prev_n = min(self.prev_n, max(self.cur_n, 8))
        n = self.cur_n + prev_n
        if n == 0:
            return None
        return (self.cur_sum + self.prev_mean * prev_n) / n

    def depth(self, now: Optional[float] = None) -> int:
        """Continuous pipeline depth: enough tasks in flight per lease to
        cover _PIPELINE_BUDGET_S of work at the measured service time.
        Unmeasured classes spread depth-1 across workers (probe first)."""
        svc = self.mean(now)
        if svc is None:
            return 1
        if svc <= _PIPELINE_BUDGET_S / _PIPELINE_DEPTH_MAX:
            return _PIPELINE_DEPTH_MAX
        return max(1, min(_PIPELINE_DEPTH_MAX, int(_PIPELINE_BUDGET_S / svc)))


class _SchedState:
    __slots__ = ("key", "pending", "staged", "lock", "leases",
                 "inflight_requests", "stats", "request_agents",
                 "req_counter", "pump_queued", "defer_timer", "req_rr",
                 "has_deadlines")

    def __init__(self, key: tuple = ()):
        self.key = key
        self.pending: deque = deque()
        # cross-thread submission staging: the caller thread appends
        # here under this class's OWN lock (not a process-global one),
        # so submitters of different scheduling classes, the reply path,
        # and the event-flush path never contend on one lock.  The pump
        # drains staged -> pending in one pass on the IO loop.
        self.staged: deque = deque()
        self.lock = threading.Lock()
        self.leases: List[_Lease] = []
        self.inflight_requests = 0
        # True while a deferred-locality re-pump timer is scheduled
        self.defer_timer = False
        # rotates which pending task's spec rides the next lease request
        self.req_rr = 0
        # windowed execution-time stats driving the pipeline depth curve
        self.stats = _ServiceStats()
        # outstanding lease requests: req_id -> agent addr currently asked.
        # When pending drains, the owner cancels these so stale queued
        # requests don't hold the agent's FIFO — each would otherwise be
        # granted, linger idle, and stall queued demand behind it
        # (reference: CancelWorkerLease in node_manager.proto)
        self.request_agents: Dict[str, Tuple[str, int]] = {}
        self.req_counter = 0
        # True while a coalesced pump wakeup is queued on the loop:
        # rapid-fire submissions accumulate in staged and get assigned
        # in ONE pump (forming real push_tasks batches) instead of one
        # pump per submission; guarded by `lock`
        self.pump_queued = False
        # sticky: this class has seen a deadlined task, so the pump
        # pays the pre-dispatch expiry scan (undeadlined classes never
        # do — the scan would be O(pending) on the burst hot path)
        self.has_deadlines = False


class _ActorState:
    __slots__ = ("actor_id", "addr", "instance", "pending", "inflight",
                 "pumping", "recovering", "dead", "death_cause", "seq",
                 "resolving", "pump_queued")

    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self.addr: Optional[Tuple[str, int]] = None
        self.instance = -1
        self.pending: deque = deque()
        self.inflight: Dict[int, _TaskState] = {}
        self.pumping = False
        self.recovering = False
        self.dead = False
        self.death_cause = ""
        self.seq = 0
        self.resolving = None  # in-flight resolve future (coalesced)
        self.pump_queued = False  # coalesced-pump callback scheduled


class CoreWorker(IntrospectionRpcMixin, RpcHost):
    def __init__(self, mode: str, head_addr: Tuple[str, int],
                 agent_addr: Tuple[str, int], arena_path: str,
                 node_id: str, worker_id: str = "", job_id: str = "",
                 log_to_driver: Optional[bool] = None):
        self.mode = mode
        self.node_id = node_id
        self.worker_id = worker_id or WorkerID.from_random().hex()
        self.head_addr = head_addr
        self.agent_addr = tuple(agent_addr)
        self._io = EventLoopThread(name=f"rt-io-{mode}")
        # pooled workers always co-locate with their agent, so loopback
        # is the right bind for them — but a DRIVER under a REMOTE head
        # must be dialable back (the head's memory aggregator joins its
        # reference table, and borrowers dial owner_addr), so advertise
        # the interface this machine routes to the head through
        bind_host = "127.0.0.1"
        if mode == MODE_DRIVER and not is_loopback(head_addr[0]):
            import socket as _socket

            try:
                probe = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
                try:
                    probe.connect((head_addr[0], head_addr[1] or 1))
                    bind_host = probe.getsockname()[0]
                finally:
                    probe.close()
            except OSError:
                pass  # loopback + the head-side gap handling backstop
        self._server = RpcServer(self, bind_host, 0)
        port = self._io.run(self._server.start())
        self.address: Tuple[str, int] = (bind_host, port)
        self.head = SyncRpcClient(head_addr[0], head_addr[1], self._io,
                                  label="head",
                                  retry_lost_s=config.gcs_reconnect_grace_s)
        self.agent = SyncRpcClient(agent_addr[0], agent_addr[1], self._io, label="agent")
        if not job_id:
            # driver_addr lets the head's memory aggregator call back
            # into this driver's reference table (rtpu memory)
            job_id = self.head.call(
                "register_job", driver_addr=list(self.address))["job_id"]
        self.job_id = job_id
        if arena_path:
            self.plasma = PlasmaClient(arena_path, self.agent,
                                       client_id=self.worker_id)
        else:
            # client mode: no local arena mmap — data rides the RPC
            # (reference: ray client, util/client/)
            from ray_tpu_torch._private.object_store import RpcPlasmaClient

            self.plasma = RpcPlasmaClient(self.agent, client_id=self.worker_id)
        self.memory = MemoryStore()
        self.rc = ReferenceCounter(self._free_object)
        self.functions = FunctionManager(self.head)
        self.job_runtime_env: Dict[str, Any] = {}  # init(runtime_env=...)
        self._locations: Dict[str, Tuple[str, int]] = {}  # owned oid -> node
        # owned oid -> plasma size: with _locations this is the owner's
        # reference table half of locality scheduling — submissions stamp
        # (loc, size) hints onto WireArgs so pick_node can score nodes by
        # argument bytes already local and agents can prefetch
        self._obj_sizes: Dict[str, int] = {}
        self._containers: Dict[str, List[ObjectRef]] = {}  # outer -> inner pins
        # lineage reconstruction (reference: object_recovery_manager.cc +
        # task_manager.h resubmit): while a plasma-stored return of an owned
        # normal task has live refs, keep its TaskSpec (and pin its arg
        # refs) so a lost primary copy can be recomputed
        self._lineage_lock = threading.Lock()
        self._lineage: Dict[str, _LineageEntry] = {}      # task_id -> entry
        self._lineage_by_oid: Dict[str, str] = {}         # oid -> task_id
        self._reconstructing: Set[str] = set()            # task_ids in flight
        self._sched: Dict[tuple, _SchedState] = {}
        # warm-lease pool (replaces per-lease linger timers): idle leases
        # parked here by pool_key, adopted by ANY scheduling class of the
        # same shape, swept back to their agents after _WARM_LEASE_TTL_S
        # by one pool-level timer, and returned early when an agent
        # reports queued demand (reclaim_idle_leases push)
        self._warm_leases: Dict[tuple, List[_Lease]] = {}
        self._warm_sweep_handle = None
        self._warm_adopted = 0   # observability/tests: pool hits
        self._warm_returned = 0  # leases returned by TTL sweep/reclaim
        self._pg_cache: Dict[str, Any] = {}
        self._actors: Dict[str, _ActorState] = {}
        self._agent_clients: Dict[Tuple[str, int], RpcClient] = {}
        self._worker_clients: Dict[Tuple[str, int], RpcClient] = {}
        self._exec_tls = _ExecState()
        self._exec.job_id = job_id
        self._exec.task_id = TaskID.for_driver(JobID.from_hex(job_id)).hex()
        self._put_counter = 0
        self._put_lock = threading.Lock()
        self._block_depth = 0  # nested blocking gets (see _notify_blocked)
        self._block_lock = threading.Lock()
        self._shutdown = False
        # observability: task-event buffer flushed to the head in batches
        # (reference: task_event_buffer.h:206) + process metrics pushed
        # to the node agent for re-export on its Prometheus endpoint
        self._task_events: List[Dict[str, Any]] = []
        self._task_events_lock = threading.Lock()
        self._flush_soon = False  # completion-flush scheduled (under lock)
        self._ev_dropped_counter = None  # lazy overflow counter
        self._metrics_collector = None  # set by _observability_loop
        self._io.spawn(self._observability_loop())
        # live introspection: loop-lag health probe on the IO loop, and
        # (drivers) worker-log streaming — every agent's log monitor
        # pushes its workers' stdout/stderr lines here, printed with
        # (pid=..., node=...) prefixes (reference: log_to_driver)
        self._io.spawn(loop_lag_probe(
            "driver" if mode == MODE_DRIVER else "worker"))
        if log_to_driver is None:
            log_to_driver = bool(config.log_to_driver)
        # agent addrs with an active log subscription: _aclient_agent
        # re-subscribes on any replacement connection (subscriptions are
        # per-connection server-side, so a silent drop would otherwise
        # end streaming for the driver's whole lifetime)
        self._log_subscribed: Set[Tuple[str, int]] = set()
        if mode == MODE_DRIVER and log_to_driver:
            self._io.spawn(self._subscribe_worker_logs())
        # streaming generator tasks we own: task_id -> StreamState
        # (reference: _raylet.pyx ObjectRefGenerator machinery)
        self._streams: Dict[str, StreamState] = {}
        # executor-side per-connection stream-item coalescing: many
        # concurrent generator tasks (the LLM serving tier runs 64+
        # token streams per replica) push items over ONE owner
        # connection — batching them into one "stream_items" frame per
        # flush tick replaces an RPC frame per token item (PR-8's
        # frame-batching philosophy applied to the streaming path)
        self._stream_out_lock = threading.Lock()
        self._stream_out_bufs: Dict[int, Tuple[Any, List[Dict]]] = {}
        # in-flight batched pushes awaiting per-task "batch_result"
        # pushes: task_id -> completion context (loop-confined; popped
        # synchronously in the push handler so the batch's failure path
        # can tell processed from unprocessed tasks)
        self._batch_pending: Dict[str, tuple] = {}
        # normal tasks whose ref args are still resolving (not yet in any
        # pending queue) — cancellable through here
        self._resolving_tasks: Dict[str, _TaskState] = {}
        # memory-pressure resilience (memory_monitor.py + head.py
        # quarantine): watchdog kill receipts pushed by agents keyed by
        # the killed worker_id (consulted when the worker connection's
        # death surfaces — a receipt turns a generic RayWorkerError into
        # a typed, separately-budgeted OutOfMemoryError); the local
        # poison-quarantine cache (fid -> (until, detail, history))
        # learned from kill-report replies / poisoned lease refusals;
        # and the fids this owner has reported kills for (their first
        # later success sends the ok-report that resets the head's
        # consecutive-kill count)
        self._oom_receipts: Dict[str, Dict[str, Any]] = {}
        self._quarantined: Dict[str, tuple] = {}
        self._kill_history: Set[str] = set()
        # end-to-end deadlines (_private/deadlines.py): the sweep timer
        # runs only while deadlined tasks exist (armed at submit, self-
        # re-arming while it finds any); _deadline_resolved marks tasks
        # the sweep already failed owner-side so the worker's eventual
        # reply (value, or the cancel-induced error) is discarded
        # instead of overwriting the DeadlineExceededError — and so the
        # next sweep tick doesn't re-fail/re-cancel them
        self._deadline_sweep_handle = None
        self._deadline_resolved: Set[str] = set()
        # cancellation (reference: core_worker CancelTask):
        # owner side — task_ids we force-cancelled (their worker death
        # must surface TaskCancelledError, never a retry)
        self._cancelled_tasks: Set[str] = set()
        # executor side — cancel-before-start marks, and live execution
        # handles so a cancel RPC can interrupt the running body
        self._cancelled_exec: Set[str] = set()
        # task_ids accepted by rpc_push_task and not yet finished — a
        # cancel for anything else is a no-op (keeps the mark set from
        # accumulating entries for already-finished tasks)
        self._exec_pending: Set[str] = set()
        self._sync_running: Dict[str, int] = {}   # task_id -> thread ident
        self._async_running: Dict[str, Any] = {}  # task_id -> conc. future
        # executor-side coalescing buffer for batched-push results:
        # id(conn) -> (conn, [result items]) flushed once per loop tick
        self._result_bufs: Dict[int, Tuple[Any, List[Dict[str, Any]]]] = {}
        # coalesced cross-thread posts to the IO loop (see _post_to_loop)
        self._post_lock = threading.Lock()
        self._post_buf: deque = deque()
        self._post_scheduled = False
        # worker-mode execution state
        self._task_queue: "queue.Queue" = queue.Queue()
        self._actor_instance: Any = None
        self._actor_creation_spec: Optional[TaskSpec] = None
        # stateful actor restarts (__rt_save__/__rt_restore__ hooks):
        # snapshot store handle + save cadence, guarded by a lock because
        # max_concurrency > 1 actors finish methods on several exec
        # threads (see _maybe_save_actor_state)
        self._actor_state_ckpt: Any = None
        self._actor_state_lock = threading.Lock()       # cadence counter
        self._actor_state_save_lock = threading.Lock()  # pickle + write
        self._actor_calls_since_save = 0
        self._pending_acks: Dict[str, Any] = {}  # task_id -> held values
        self._exec_threads: List[threading.Thread] = []

    @property
    def _exec(self):
        """Execution context: the per-coroutine shadow when running an
        async task body on the shared loop thread, else the exec
        thread's threading.local."""
        shadow = _exec_ctx.get()
        return shadow if shadow is not None else self._exec_tls

    # ------------------------------------------------------- observability

    def record_task_event(self, task_id: str, state: str,
                          _executor: Optional[bool] = None,
                          **fields) -> None:
        """Buffer a task state transition; flushed to the head in batches
        (reference: task_event_buffer.h FlushEvents).

        `_executor` overrides the by-state attribution guess — the
        owner records FAILED too (see _fail_task), and must not claim
        the record's worker/node with its own identity."""
        ev = {"task_id": task_id, "state": state,
              f"{state.lower()}_ts": time.time()}
        if _executor is None:
            _executor = state in ("RUNNING", "FINISHED", "FAILED")
        if _executor:
            # executor-side states claim the record's worker/node; the
            # submitter's identity rides dedicated caller_* keys so a
            # late-flushed owner event can't clobber the executor
            # attribution (timeline tracks key off worker_id/node_id)
            ev["worker_id"] = self.worker_id
            ev["node_id"] = self.node_id
        else:
            ev["caller_worker_id"] = self.worker_id
            ev["caller_node_id"] = self.node_id
        sub = os.environ.get("RT_JOB_ID")
        if sub:
            # correlate this driver's tasks with its job submission id
            ev["submission_id"] = sub
        ev.update(fields)
        dropped = 0
        with self._task_events_lock:
            self._task_events.append(ev)
            if len(self._task_events) > config.task_events_buffer_size:
                dropped = len(self._task_events) // 2
                del self._task_events[:dropped]
            schedule = (state in ("FINISHED", "FAILED")
                        and not self._flush_soon and not self._shutdown)
            if schedule:
                self._flush_soon = True
        if dropped:
            # overflow is deliberate (events must never backpressure the
            # submit hot path) but no longer silent:
            # ray_tpu_task_events_dropped_total counts the loss
            if self._ev_dropped_counter is None:
                from ray_tpu_torch._private.metrics import \
                    task_events_dropped_counter

                self._ev_dropped_counter = task_events_dropped_counter()
            self._ev_dropped_counter.inc(dropped, tags={"shard": "owner"})
        if schedule:
            # completion events flush on a short coalescing delay instead
            # of waiting out the periodic interval: a snapshot taken right
            # after get() returns must already see the task FINISHED, and
            # the delay batches a burst's events into one frame
            try:
                self._loop().call_soon_threadsafe(self._schedule_event_flush)
            except RuntimeError:
                with self._task_events_lock:
                    self._flush_soon = False

    def _schedule_event_flush(self) -> None:
        self._loop().call_later(
            0.005, lambda: self._spawn(self._flush_task_events()))

    async def _flush_task_events(self):
        with self._task_events_lock:
            self._flush_soon = False
            batch, self._task_events = self._task_events, []
        if batch:
            try:
                await self.head.aio.oneway("task_events", events=batch)
            except Exception:
                pass
        # trace spans ride the same flush cadence (worker → head)
        spans = tracing.drain()
        if spans:
            for s in spans:
                s.setdefault("worker_id", self.worker_id)
                s.setdefault("node_id", self.node_id)
            try:
                await self.head.aio.oneway("trace_spans", spans=spans)
                tracing.count_flush()
            except Exception:
                tracing.count_dropped(len(spans))

    async def _observability_loop(self):
        import asyncio

        from ray_tpu_torch._private.metrics import (default_registry,
                                              dispatch_pump_depth_gauge)

        default_registry.default_tags.setdefault(
            "worker_id", self.worker_id[:12])
        pump_depth = dispatch_pump_depth_gauge()

        def collect():
            # owner-side queued work not yet pushed to a lease: the
            # "is dispatch the bottleneck" gauge (sampled at render,
            # zero hot-path cost; dict snapshots tolerate cross-thread
            # mutation)
            depth = sum(len(s.pending) for s in list(self._sched.values()))
            depth += sum(len(a.pending) for a in list(self._actors.values()))
            pump_depth.set(depth)

        self._metrics_collector = collect  # removed again in shutdown()
        default_registry.add_collector(collect)
        interval = max(0.2, config.metrics_report_interval_ms / 1000.0 / 5)
        while not self._shutdown:
            await asyncio.sleep(interval)
            await self._flush_task_events()
            try:
                # push whenever this process has registered any metric —
                # user metrics in a driver count too
                if default_registry.has_samples():
                    text = default_registry.render()
                    await (await self._aclient_agent(self.agent_addr)).oneway(
                        "report_metrics", source=self.worker_id,
                        text=text.encode())
            except Exception:
                pass

    # ------------------------------------------------------------------ utils

    def _loop(self):
        return self._io.loop

    def _post_to_loop(self, fn, *args) -> None:
        """call_soon_threadsafe with wakeup coalescing.  Every
        call_soon_threadsafe writes a byte to the loop's self-pipe — a
        SYSCALL per call, ~1 ms on syscall-throttled boxes, paid on the
        submission hot path (one per .remote(), one per exec reply).
        Here the wakeup is written only on the buffer's empty→nonempty
        edge; a burst of N submissions pays ONE syscall and the drain
        callback runs them FIFO (submission order — the actor seqno
        contract — is preserved).  Raises RuntimeError like
        call_soon_threadsafe when the loop is shut down."""
        with self._post_lock:
            self._post_buf.append((fn, args))
            if self._post_scheduled:
                return
            self._post_scheduled = True
        try:
            self._loop().call_soon_threadsafe(self._drain_posts)
        except RuntimeError:
            with self._post_lock:
                self._post_scheduled = False
            raise

    def _drain_posts(self) -> None:
        while True:
            with self._post_lock:
                if not self._post_buf:
                    self._post_scheduled = False
                    return
                items = list(self._post_buf)
                self._post_buf.clear()
            for fn, args in items:
                try:
                    fn(*args)
                except Exception:
                    # one bad callback must not drop the rest, but keep
                    # the diagnostics call_soon_threadsafe used to give
                    import sys

                    print(f"[ray_tpu] exception in posted callback "
                          f"{getattr(fn, '__name__', fn)!r}:",
                          file=sys.stderr)
                    traceback.print_exc()

    def _spawn(self, coro):
        """Fire-and-forget a coroutine on the IO loop from any thread."""
        if self._shutdown:
            coro.close()
            return
        try:
            self._io.spawn(coro)
        except RuntimeError:
            coro.close()

    async def _aclient_worker(self, addr: Tuple[str, int]) -> RpcClient:
        addr = (addr[0], addr[1])
        c = self._worker_clients.get(addr)
        if c is None or c.dead:
            c = RpcClient(addr[0], addr[1], label=f"worker-{addr[1]}",
                          on_push=self._on_exec_worker_push)
            self._worker_clients[addr] = c
        return c

    def _on_exec_worker_push(self, method: str, payload: Dict[str, Any]):
        """Oneway pushes from a worker executing our task (IO loop).

        "stream_item": one yielded value of a streaming generator task
        (reference: core_worker.proto ReportGeneratorItemReturns).  The
        item lands exactly like a completed return value — inline bytes
        in the memory store or a recorded plasma location — so the
        consumer-facing ObjectRef resolves through the normal get path.
        """
        if method == "batch_results":
            # pop registrations AND remove from inflight synchronously:
            # the batch failure path snapshots failed_head from
            # inflight[0], which must never point at a task whose result
            # already arrived.  Then process the whole frame in ONE
            # coroutine — a Task per result would dominate small-task
            # throughput.
            work = []
            for item in payload.get("items") or []:
                entry = self._batch_pending.pop(item.get("tid", ""), None)
                if entry is None:
                    continue
                if entry[0] == "task":
                    lease, task = entry[2], entry[3]
                    try:
                        lease.inflight.remove(task)
                    except ValueError:
                        pass
                else:
                    entry[1].inflight.pop(entry[2].spec.seqno, None)
                work.append((entry, item.get("reply")))
            if work:
                asyncio.ensure_future(self._finish_batch_items(work))
            return
        if method == "stream_items":
            # coalesced frame: many items, possibly for many streams;
            # apply all, then wake each touched stream once
            touched = set()
            for one in payload.get("items") or []:
                s = self._apply_stream_item(one)
                if s is not None:
                    touched.add(s)
            for s in touched:
                s.wake()
            return
        if method != "stream_item":
            return
        s = self._apply_stream_item(payload)
        if s is not None:
            s.wake()

    def _apply_stream_item(self, payload) -> Optional[StreamState]:
        tid = payload["task_id"]
        s = self._streams.get(tid)
        if s is None:
            return None  # generator abandoned; drop late items
        idx = payload["index"]
        oid = ObjectID.from_index(TaskID.from_hex(tid), idx + 1).hex()
        item = payload["item"]
        if "v" in item:
            self.memory.set_raw(oid, item["v"])
        elif "stored" in item:
            node = tuple(item["stored"]["node"])
            self._locations[oid] = node
            if item["stored"].get("size"):
                self._obj_sizes[oid] = item["stored"]["size"]
            self.memory.set_in_plasma(oid, node)
        else:
            return None  # malformed item
        s.arrived = max(s.arrived, idx + 1)
        return s

    async def _aclient_agent(self, addr: Tuple[str, int]) -> RpcClient:
        addr = (addr[0], addr[1])
        c = self._agent_clients.get(addr)
        if c is None or c.dead:
            resubscribe = c is not None and addr in self._log_subscribed
            c = RpcClient(addr[0], addr[1], label=f"agent-{addr[1]}",
                          on_push=self._on_agent_push)
            self._agent_clients[addr] = c
            if resubscribe:
                # the old connection carried our log subscription (per-
                # connection server-side): renew it on the replacement
                # so streaming survives agent reconnects
                async def _resub(client=c):
                    try:
                        await client.call("subscribe_logs", tail=0)
                    except Exception:
                        pass

                self._spawn(_resub())
        return c

    async def _subscribe_worker_logs(self):
        """Driver mode: subscribe to every node agent's log monitor so
        worker stdout/stderr streams to this driver's console
        (reference: _private/log_monitor.py + worker.py print_logs).
        Agents joining later are not auto-subscribed — `rtpu logs
        --follow` covers operator use on growing clusters."""
        try:
            table = await self.head.aio.call("node_table")
        except Exception:
            table = {self.node_id: {"addr": list(self.agent_addr)}}
        for entry in table.values():
            addr = entry.get("addr")
            if not addr:
                continue
            try:
                client = await self._aclient_agent((addr[0], addr[1]))
                await client.call("subscribe_logs", tail=0)
                self._log_subscribed.add((addr[0], addr[1]))
            except Exception:
                pass  # an unreachable agent must not fail driver init

    def _print_log_lines(self, payload: Dict[str, Any]) -> None:
        """Render a log_lines push: one prefixed line per worker line,
        mirroring the reference's `(pid=..., ip=...)` driver output."""
        import sys

        node = (payload.get("node_id") or "")[:12]
        out = []
        for ent in payload.get("batch") or []:
            prefix = f"(pid={ent.get('pid')}, node={node}) "
            out.extend(prefix + line for line in ent.get("lines") or [])
        if out:
            print("\n".join(out), file=sys.stdout, flush=True)

    def _on_agent_push(self, method: str, payload: Dict[str, Any]):
        """Oneway pushes from a node agent (runs on the IO loop)."""
        if method == "log_lines":
            self._print_log_lines(payload)
            return
        if method == "oom_kill":
            # watchdog kill receipt, sent just BEFORE the SIGKILL: when
            # the worker connection's death surfaces in the push path,
            # the receipt reclassifies it as an OOM kill (typed error,
            # separate retry budget).  Bounded: receipts are consumed on
            # the death they explain; prune oldest if one never is
            # (owner_conn raced a reconnect and the death was seen by a
            # different owner object)
            wid = payload.get("worker_id", "")
            if wid:
                self._oom_receipts[wid] = payload
                while len(self._oom_receipts) > 256:
                    self._oom_receipts.pop(next(iter(self._oom_receipts)))
            return
        if method == "reclaim_idle_leases":
            # demand queued behind our leases on THAT agent: hand back
            # warm-pool leases NOW instead of after the TTL sweep.  The
            # push carries the agent's aggregate queued demand ("need"),
            # so we return only enough capacity to cover it and keep the
            # rest of the pool warm — a lease we just assigned work to
            # has inflight tasks and is skipped (no correctness race).
            agent = tuple(payload.get("agent") or ())
            need: Dict[str, float] = dict(payload.get("need") or {})

            def covered() -> bool:
                return bool(need) and all(v <= 0 for v in need.values())

            def consume(res: Dict[str, float]) -> None:
                for k, v in res.items():
                    if k in need:
                        need[k] -= v

            for pool in list(self._warm_leases.values()):
                for lease in list(pool):
                    if covered():
                        return
                    if lease.dead or lease.in_bundle:
                        continue
                    if agent and tuple(lease.agent_addr) != agent:
                        continue
                    pool.remove(lease)
                    consume(lease.resources)
                    self._warm_returned += 1
                    self._spawn(self._return_pooled(lease))
            # leases momentarily idle inside a class (between a reply and
            # its pump) are fair game too once the pool is exhausted.
            # list(): caller threads insert new classes concurrently
            # (_sched_state via staged submission)
            for state in list(self._sched.values()):
                for lease in list(state.leases):
                    if covered():
                        return
                    if lease.inflight or lease.dead or lease.in_bundle:
                        continue
                    if agent and tuple(lease.agent_addr) != agent:
                        continue
                    consume(lease.resources)
                    self._spawn(self._return_lease(state, lease))

    def shutdown(self):
        # deregister our pump-depth collector from the process-singleton
        # registry: a leaked closure would pin this whole worker graph
        # across init/shutdown cycles (and keep sampling dead state)
        if self._metrics_collector is not None:
            from ray_tpu_torch._private.metrics import default_registry

            default_registry.remove_collector(self._metrics_collector)
            self._metrics_collector = None
        # flush buffered task events before tearing the IO plane down —
        # a short-lived driver's SUBMITTED events live in the last
        # interval of the observability loop
        with self._task_events_lock:
            batch, self._task_events = self._task_events, []
        if batch:
            try:
                self._io.run(
                    self.head.aio.oneway("task_events", events=batch),
                    timeout=2.0)
            except Exception:
                pass
        spans = tracing.drain()
        if spans:
            for s in spans:
                s.setdefault("worker_id", self.worker_id)
                s.setdefault("node_id", self.node_id)
            try:
                self._io.run(
                    self.head.aio.oneway("trace_spans", spans=spans),
                    timeout=2.0)
            except Exception:
                pass
        self._shutdown = True
        # wake every blocked waiter (gets, dep-resolution executor
        # threads): their objects can no longer arrive, and a thread
        # parked on an entry event would hang interpreter exit
        try:
            self.memory.fail_pending(RayWorkerError("ray_tpu_torch.shutdown()"))
        except Exception:
            pass
        try:
            self.plasma.close()
        except Exception:
            pass
        for c in (self.head, self.agent):
            try:
                c.close()
            except Exception:
                pass

        async def _close_all():
            for c in list(self._agent_clients.values()) + list(self._worker_clients.values()):
                await c.close()
            await self._server.stop()

        try:
            self._io.run(_close_all(), timeout=5)
        except Exception:
            pass
        self._io.stop()

    # ---------------------------------------------------------- ref plumbing

    def register_local_ref(self, ref: ObjectRef) -> None:
        if self._shutdown:
            return
        owned = ref.owner_addr is None or tuple(ref.owner_addr) == self.address
        self.rc.add_local(ref.oid, owned)

    def unregister_local_ref(self, ref: ObjectRef) -> None:
        if self._shutdown:
            return
        borrowed_done = self.rc.remove_local(ref.oid)
        if borrowed_done and ref.owner_addr is not None:
            # drop the cached inline value too: borrowed entries are only
            # evicted here (owner-side eviction runs in _free_object), so
            # keeping them would leak every borrowed small object
            self.memory.evict(ref.oid)
            self._spawn(self._send_remove_borrow(tuple(ref.owner_addr), ref.oid))

    async def _send_remove_borrow(self, owner: Tuple[str, int], oid: str):
        try:
            c = await self._aclient_worker(owner)
            await c.oneway("remove_borrow", oid=oid, borrower=list(self.address))
        except Exception:
            pass

    def _free_object(self, oid: str) -> None:
        """Owned object's refcount hit zero: drop the value everywhere."""
        if self._shutdown:
            return
        self._drop_lineage(oid)
        self.memory.evict(oid)
        self._containers.pop(oid, None)  # releases nested pins via GC
        self._obj_sizes.pop(oid, None)
        loc = self._locations.pop(oid, None)
        if loc is not None:
            self._spawn(self._send_free(loc, oid))

    async def _send_free(self, node: Tuple[str, int], oid: str):
        try:
            c = await self._aclient_agent(node)
            await c.call("store_free", oids=[oid])
        except Exception:
            # recorded holder unreachable — the copy may have migrated
            # off a drained node; free wherever the head's directory
            # says it lives now, so a scale-down can't strand bytes
            try:
                r = await self.head.aio.call("object_locations",
                                             oids=[oid])
                for host, port in r.get("locations", {}).get(oid, []):
                    try:
                        c = await self._aclient_agent((host, port))
                        await c.call("store_free", oids=[oid])
                    except Exception:
                        pass
            except Exception:
                pass

    # ---- borrower/owner RPCs ----

    async def rpc_add_borrow(self, oid: str, borrower: List):
        self.rc.add_borrower(oid, (borrower[0], borrower[1]))
        return {"ok": True}

    async def rpc_remove_borrow(self, oid: str, borrower: List):
        self.rc.remove_borrower(oid, (borrower[0], borrower[1]))

    async def rpc_fetch_object(self, oid: str, wait: float = 0.0,
                               lost_at=None):
        """Owner-side object resolution for borrowers
        (reference: ownership-based object directory).

        `lost_at` is a borrower's report that the node we pointed it at
        could not serve the object; if it matches our recorded location,
        drop it and kick lineage reconstruction."""
        if lost_at is not None:
            loc = self._locations.get(oid)
            ent = self.memory.peek(oid)
            cur = loc or (ent.node_addr if ent is not None and ent.in_plasma
                          else None)
            if cur is not None and tuple(lost_at) == tuple(cur):
                # _maybe_reconstruct clears locations + resolutions for
                # every return of the producing task before resubmitting
                if not self._maybe_reconstruct(oid):
                    return {"unknown": True}
                return {"pending": True}
        entry = self.memory.peek(oid)
        if entry is None and wait > 0 and self.memory.known(oid):
            # event-driven long-poll: a memory-store waiter wakes this
            # coroutine on resolution — no executor thread parked per
            # in-flight poll (a borrower fleet would exhaust the pool)
            loop = self._loop()
            fut = loop.create_future()

            def _wake():
                loop.call_soon_threadsafe(
                    lambda: fut.done() or fut.set_result(None))

            token = self.memory.add_waiter(oid, _wake)
            if token is not None:
                try:
                    await asyncio.wait_for(fut, timeout=min(wait, 10.0))
                except asyncio.TimeoutError:
                    pass
                finally:
                    self.memory.remove_waiter(oid, token)
            entry = self.memory.peek(oid)
        if entry is not None:
            if entry.error is not None:
                return {"error": cloudpickle.dumps(entry.error)}
            if entry.in_plasma:
                return {"plasma": list(entry.node_addr)}
            if entry.raw is not None:
                return {"inline": entry.raw}
            return {"inline": serialization.serialize_to_bytes(entry.value)}
        loc = self._locations.get(oid)
        if loc is not None:
            return {"plasma": list(loc)}
        if self.rc.is_freed(oid):
            return {"freed": True}
        if self.memory.known(oid):
            return {"pending": True}
        return {"unknown": True}

    async def rpc_fetch_objects(self, oids: List[str], wait: float = 0.0):
        """Vectorized owner-side resolution: one frame resolves a whole
        batch of this owner's objects (concurrent long-polls share the
        wall-clock wait).  Per-oid results keyed by oid, each shaped
        exactly like a fetch_object reply."""
        results = await asyncio.gather(
            *[self.rpc_fetch_object(oid, wait=wait) for oid in oids])
        return {"results": dict(zip(oids, results))}

    def memory_summary(self, limit: int = 0) -> Dict[str, Any]:
        """This process's half of the cluster memory view: every live
        owned/borrowed ref with pin state, borrower count, size, store
        location, and creation call-site (reference: the per-worker
        `GetCoreWorkerStats` dump behind `ray memory`).  Bounded: owned
        refs sort largest-first and both lists cap at `limit`."""
        limit = int(limit) or int(config.memory_summary_max_refs)
        owned: List[Dict[str, Any]] = []
        borrowed: List[Dict[str, Any]] = []
        for r in self.rc.summary():
            oid = r["oid"]
            size = self._obj_sizes.get(oid, 0)
            if oid in self._locations:
                store = "plasma"
            else:
                e = self.memory.peek(oid)
                if e is not None:
                    if e.in_plasma:
                        store = "plasma"
                    elif e.error is not None:
                        store = "error"
                    else:
                        store = "inline"
                        if not size and e.raw is not None:
                            size = len(e.raw)
                elif self.memory.known(oid):
                    store = "pending"
                else:
                    store = "remote"
            r["size"] = size
            r["store"] = store
            (owned if r.pop("owned") else borrowed).append(r)
        owned.sort(key=lambda x: -x["size"])
        return {
            "worker_id": self.worker_id, "node_id": self.node_id,
            "kind": self.mode, "addr": list(self.address),
            "num_owned": len(owned), "num_borrowed": len(borrowed),
            "owned_bytes": sum(x["size"] for x in owned),
            "truncated": max(0, len(owned) - limit)
            + max(0, len(borrowed) - limit),
            "owned": owned[:limit], "borrowed": borrowed[:limit],
            "channels": _live_channel_oids(),
        }

    async def rpc_memory_summary(self, limit: int = 0):
        return self.memory_summary(limit)

    async def rpc_task_ack(self, task_id: str):
        self._pending_acks.pop(task_id, None)

    async def rpc_ping(self):
        return {"pong": True, "mode": self.mode}

    # ---- host-collective plane (ray_tpu_torch.util.collective) ----

    async def rpc_coll_push(self, group: str, seq: int, src: int,
                            payload: bytes, chan: str = "op"):
        from ray_tpu_torch.util import collective

        collective._deliver_push(group, chan, seq, src, payload)

    async def _acoll_send(self, addr, group: str, chan: str, seq: int,
                          src: int, payload: bytes):
        try:
            c = await self._aclient_worker(tuple(addr))
            await c.oneway("coll_push", group=group, chan=chan, seq=seq,
                           src=src, payload=payload)
        except Exception as e:
            import sys

            print(f"[ray_tpu_torch.collective] send {group}/{chan}#{seq} "
                  f"rank {src} -> {addr} failed: {e}", file=sys.stderr)

    # ------------------------------------------------------------------- put

    def _next_put_oid(self) -> str:
        with self._put_lock:
            self._put_counter += 1
            # put indices live in the top half of the 32-bit index space;
            # return indices (including unbounded streaming-generator
            # items, which count up from 1) own the bottom half — a fixed
            # partition, because both counters are unbounded and any
            # additive offset scheme could collide
            idx = 0x8000_0000 + self._put_counter
        tid = TaskID.from_hex(self._exec.task_id or
                              TaskID.for_driver(JobID.from_hex(self.job_id)).hex())
        return ObjectID.from_index(tid, idx).hex()

    def put(self, value: Any) -> ObjectRef:
        oid = self._next_put_oid()
        with SerializationContext() as ctx:
            frames, size = serialization.serialize(value)
        if size <= config.max_direct_call_object_size:
            # small values stay in the owner's in-process store, skipping
            # two plasma RPC round-trips (reference: memory_store.cc —
            # ray.put below the direct-call threshold avoids plasma).
            # Borrowers resolve inline via fetch_object; task args inline
            # through _resolve_deps; the existing machinery covers both.
            buf = bytearray(size)
            serialization.pack_into(frames, memoryview(buf))
            self.memory.set_raw(oid, bytes(buf))
            node_addr = None
        else:
            # backpressure: a put the arena cannot take right now blocks
            # (bounded by the ambient deadline and put_backpressure_max_s)
            # for pinned bytes to release instead of silently flooding
            # the disk-fallback path; a truly unspillable arena still
            # falls through to the store's normal create semantics
            wait_s = float(config.put_backpressure_max_s)
            remaining = deadlines.remaining(deadlines.current_deadline())
            if remaining is not None:
                wait_s = min(wait_s, max(0.0, remaining))
            self.plasma.put_serialized(oid, frames, size, primary=True,
                                       wait_s=wait_s)
            self._locations[oid] = self.agent_addr
            self._obj_sizes[oid] = size
            node_addr = self.agent_addr
        if ctx.refs:
            # the stored value embeds refs: pin them for the outer's lifetime
            self._containers[oid] = list(ctx.refs)
        ref = ObjectRef(oid, owner_addr=self.address, node_addr=node_addr)
        self.rc.set_meta(oid, call_site=_user_call_site(), name="put")
        return ref

    # ------------------------------------------------------------------- get

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        # a worker blocking inside a task donates its lease's resources
        # so nested tasks can schedule (reference: HandleWorkerBlocked) —
        # without this, task nesting deeper than the node's CPU count
        # deadlocks.  Fast path (everything already resolved) skips the
        # agent round-trip entirely.
        # the ambient request deadline caps the budget: a get() inside a
        # deadlined task (or a Serve request) spends only what remains,
        # and its expiry surfaces as the typed DeadlineExceededError
        ambient = deadlines.remaining()
        deadline_bound = ambient is not None and (timeout is None
                                                  or ambient < timeout)
        if deadline_bound:
            timeout = ambient
        # the deadline starts NOW — the blocked-notification RPC below
        # must not eat into the caller's budget
        deadline = None if timeout is None else time.monotonic() + timeout
        # NOTE: plasma-stored objects (even locally present ones) also
        # trigger the notification — the worker has no local index of
        # plasma contents, and a blocking get's latency dwarfs the
        # round-trip anyway
        notify = (self.mode == MODE_WORKER and self._exec.task_id
                  and not all(self.memory.ready(r.oid) for r in refs))
        if notify:
            self._notify_blocked(True)
        try:
            return self._get_inner(refs, deadline)
        except GetTimeoutError as e:
            if deadline_bound:
                deadlines.count_exceeded("get")
                raise DeadlineExceededError(
                    f"request deadline expired while waiting: {e}",
                    where="get") from e
            raise
        finally:
            if notify:
                self._notify_blocked(False)

    def _notify_blocked(self, blocked: bool) -> None:
        # the RPC stays INSIDE the lock: edge detection and delivery must
        # serialize, or two exec threads crossing (one leaving get as
        # another enters) could deliver blocked/unblocked inverted and
        # wedge the lease's donation state
        with self._block_lock:
            self._block_depth += 1 if blocked else -1
            edge = (self._block_depth == 1) if blocked \
                else (self._block_depth == 0)
            if not edge:
                return
            try:
                self.agent.call(
                    "worker_blocked" if blocked else "worker_unblocked",
                    worker_id=self.worker_id, timeout=2.0)
            except Exception:
                pass  # agent briefly unreachable: accounting-only feature

    def _reconstruction_outcome(self, oids, ok: bool) -> None:
        """Count lineage-reconstruction outcomes
        (ray_tpu_object_reconstructions_total{outcome=ok|failed})."""
        if not oids:
            return
        from ray_tpu_torch._private.metrics import fault_tolerance_metrics

        fault_tolerance_metrics()[1].inc(
            len(oids), tags={"outcome": "ok" if ok else "failed"})

    def _lost_detail(self, refs: Sequence[ObjectRef]) -> str:
        """Human-actionable loss report: each unrecoverable object id
        WITH the task that produced it, so operators can tell what was
        lost instead of just that something was."""
        with self._lineage_lock:
            parts = [
                f"{ref.oid[:16]} (produced by task "
                f"{(self._lineage_by_oid.get(ref.oid) or 'unknown')[:16]})"
                for ref in refs[:8]]
        more = f" … and {len(refs) - 8} more" if len(refs) > 8 else ""
        return ", ".join(parts) + more

    def _get_inner(self, refs: Sequence[ObjectRef],
                   deadline: Optional[float] = None) -> List[Any]:
        out: List[Any] = [None] * len(refs)
        pending: List[Tuple[int, ObjectRef]] = list(enumerate(refs))
        reconstructed: Set[str] = set()  # oids routed through lineage replay
        for _round in range(_MAX_RECONSTRUCTION_ROUNDS):
            plasma_fetch: List[Tuple[int, ObjectRef, Tuple[str, int]]] = []
            carry: List[Tuple[int, ObjectRef]] = []  # raced-clear retries
            # borrowed refs whose location the owner must resolve,
            # grouped so each owner gets ONE fetch_objects frame per
            # wait round instead of one serial RPC per ref (10k small
            # refs -> O(owners) round trips, not O(refs))
            by_owner: Dict[Tuple[str, int],
                           List[Tuple[int, ObjectRef]]] = {}
            for i, ref in pending:
                oid = ref.oid
                if self.memory.known(oid):
                    remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                    entry = self.memory.wait_ready(oid, remaining)
                    if entry is None:
                        raise GetTimeoutError(f"timed out waiting for {oid[:16]}")
                    if entry.error is not None:
                        raise entry.error
                    if entry.in_plasma:
                        plasma_fetch.append((i, ref, entry.node_addr))
                    else:
                        # snapshot: clear_resolution may race this read
                        value, raw = entry.value, entry.raw
                        if value is None and raw is None:
                            # raced clear (reconstruction started between
                            # wait_ready and this read): go around
                            carry.append((i, ref))
                            continue
                        if value is None:
                            with SerializationContext() as dctx:
                                value = serialization.deserialize(raw)
                                entry.value = value
                            # nested refs inside an inline value are live
                            # borrows — register them with their owners,
                            # exactly as the plasma fetch path does
                            self._register_foreign_refs(dctx.refs)
                        out[i] = value
                elif self.rc.is_freed(oid):
                    raise ObjectFreedError(f"object {oid[:16]} was freed by its owner")
                else:
                    node = ref.node_addr if _round == 0 else None
                    if node is None and ref.owner_addr is not None \
                            and tuple(ref.owner_addr) != self.address:
                        by_owner.setdefault(
                            tuple(ref.owner_addr), []).append((i, ref))
                        continue
                    if node is None:
                        node = self._locations.get(oid, self.agent_addr)
                    plasma_fetch.append((i, ref, node))
            for owner, items in by_owner.items():
                resolved_carry, resolved_plasma = \
                    self._resolve_owner_batch(owner, items, deadline)
                # inline values landed in the MEMORY STORE; revisit next
                # round to read them into out (the memory.known branch)
                carry.extend(resolved_carry)
                plasma_fetch.extend(resolved_plasma)
            if not plasma_fetch:
                if not carry:
                    self._reconstruction_outcome(reconstructed, ok=True)
                    return out
                pending = carry
                continue
            failures = self._fetch_plasma(plasma_fetch, out, deadline)
            if not failures and not carry:
                self._reconstruction_outcome(reconstructed, ok=True)
                return out
            # some plasma primaries are gone: reconstruct what we own,
            # report borrower-visible losses to their owners, retry
            pending = carry
            for i, ref, node, err in failures:
                if self._maybe_reconstruct(ref.oid):
                    reconstructed.add(ref.oid)
                    pending.append((i, ref))
                elif ref.owner_addr is not None \
                        and tuple(ref.owner_addr) != self.address \
                        and self._report_lost_to_owner(ref, node, deadline):
                    pending.append((i, ref))
                else:
                    self._reconstruction_outcome({ref.oid}, ok=False)
                    raise ObjectLostError(
                        f"object {self._lost_detail([ref])} was lost "
                        f"({err}) and cannot be reconstructed")
        lost_refs = [ref for _i, ref in pending]
        self._reconstruction_outcome({r.oid for r in lost_refs}, ok=False)
        raise ObjectLostError(
            f"gave up reconstructing after {_MAX_RECONSTRUCTION_ROUNDS} "
            f"rounds; unrecoverable objects: {self._lost_detail(lost_refs)}")

    def _resolve_owner_batch(self, owner: Tuple[str, int],
                             items: List[Tuple[int, ObjectRef]], deadline
                             ) -> Tuple[List[Tuple[int, ObjectRef]],
                                        List[Tuple[int, ObjectRef,
                                                   Tuple[str, int]]]]:
        """Resolve a group of refs against their common owner: one
        fetch_objects frame per long-poll round carries EVERY still-
        pending oid (round-5 verdict: resolving many small borrowed refs
        did one RPC round per ref).  Returns (carry, plasma): carry refs
        resolved inline into the memory store (read next round), plasma
        refs with the node address to pull from."""
        pending = items
        carry: List[Tuple[int, ObjectRef]] = []
        plasma: List[Tuple[int, ObjectRef, Tuple[str, int]]] = []
        while pending:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise GetTimeoutError(
                    f"timed out resolving {pending[0][1].oid[:16]} "
                    f"(+{len(pending) - 1} more)")
            wait = 10.0 if remaining is None else min(10.0, remaining)
            try:
                results = self._io.run(
                    self._afetch_many_from_owner(
                        owner, [ref.oid for _i, ref in pending], wait),
                    timeout=wait + 30.0)
            except ConnectionLost:
                raise ObjectLostError(
                    f"owner of {pending[0][1].oid[:16]} at {owner} "
                    f"is unreachable")
            nxt: List[Tuple[int, ObjectRef]] = []
            for i, ref in pending:
                r = results.get(ref.oid) or {"unknown": True}
                if r.get("pending"):
                    nxt.append((i, ref))
                elif r.get("freed"):
                    raise ObjectFreedError(
                        f"object {ref.oid[:16]} was freed by its owner")
                elif r.get("unknown"):
                    raise ObjectLostError(
                        f"owner does not know object {ref.oid[:16]}")
                elif "error" in r:
                    raise cloudpickle.loads(r["error"])
                elif "inline" in r:
                    self.memory.set_raw(ref.oid, r["inline"])
                    carry.append((i, ref))
                else:
                    plasma.append((i, ref, (r["plasma"][0], r["plasma"][1])))
            pending = nxt
        return carry, plasma

    async def _afetch_many_from_owner(self, owner, oids: List[str],
                                      wait: float) -> Dict[str, Any]:
        c = await self._aclient_worker(owner)
        r = await c.call("fetch_objects", oids=oids, wait=wait,
                         timeout=wait + 20.0)
        return r.get("results") or {}

    async def _afetch_from_owner(self, owner, oid: str, wait: float,
                                 lost_at=None):
        c = await self._aclient_worker(owner)
        return await c.call("fetch_object", oid=oid, wait=wait,
                            lost_at=list(lost_at) if lost_at else None,
                            timeout=wait + 20.0)

    def _report_lost_to_owner(self, ref: ObjectRef, node, deadline) -> bool:
        """Tell the owner its recorded location failed to serve the object.
        Returns True if the owner is handling it (reconstruction underway
        or a different location exists) — the caller then re-resolves."""
        owner = tuple(ref.owner_addr)
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            raise GetTimeoutError(
                f"timed out while recovering {ref.oid[:16]}")
        budget = 30.0 if remaining is None else min(30.0, remaining)
        try:
            r = self._io.run(
                self._afetch_from_owner(owner, ref.oid, 0.0, lost_at=node),
                timeout=budget)
        except Exception:
            return False
        return not (r.get("unknown") or r.get("freed") or "error" in r)

    def _fetch_plasma(self, items, out: List[Any], deadline) -> list:
        """Localize + read plasma objects; fills `out` for successes and
        returns [(i, ref, node, err)] for objects that could not be
        localized (lost primaries — reconstruction candidates)."""
        # 1. make everything local: ONE ensure_local_batch frame to our
        # agent carries every (oid, source) pair — the agent pulls them
        # concurrently (deduped against in-flight pulls) and replies
        # per-oid, so localizing N objects costs one RPC round, not N
        async def _ensure_all():
            r = await self.agent.aio.call(
                "ensure_local_batch",
                items=[[ref.oid, list(node) if node else None]
                       for _i, ref, node in items],
                timeout=config.rpc_call_timeout_s)
            return r.get("results") or []

        try:
            replies = self._io.run(_ensure_all(),
                                   timeout=config.rpc_call_timeout_s + 30)
        except Exception as e:
            # transient transport trouble with our own agent is NOT
            # evidence the primaries are lost — don't trigger duplicate
            # re-executions for it
            raise ObjectLostError(
                f"could not localize {items[0][1].oid[:16]} "
                f"(+{len(items) - 1} more): {e}") from e
        failures: List[Tuple[int, ObjectRef, Tuple[str, int], str]] = []
        localized = []
        for (i, ref, node), r in zip(
                items, list(replies) + [{"ok": False, "error": "no reply"}]
                * max(0, len(items) - len(replies))):
            if not r.get("ok"):
                failures.append((i, ref, node, str(r.get("error"))))
            else:
                localized.append((i, ref))
        if not localized:
            return failures
        # 2. read them zero-copy from the local store
        remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
        oids = [ref.oid for _, ref in localized]
        with SerializationContext() as ctx:
            try:
                values = self.plasma.get_values(oids, timeout=remaining)
            except KeyError as e:
                if "freed" in str(e):
                    raise ObjectFreedError(str(e)) from e
                raise ObjectLostError(str(e)) from e
        self._register_foreign_refs(ctx.refs)
        for (i, _), v in zip(localized, values):
            out[i] = v
        return failures

    def _register_foreign_refs(self, refs: List[ObjectRef]) -> None:
        """Register borrows for refs materialized out of fetched values."""
        seen: Set[str] = set()
        for r in refs:
            if r.owner_addr is not None and tuple(r.owner_addr) != self.address \
                    and r.oid not in seen:
                seen.add(r.oid)
                self._spawn(self._send_add_borrow(tuple(r.owner_addr), r.oid))

    async def _send_add_borrow(self, owner: Tuple[str, int], oid: str):
        try:
            c = await self._aclient_worker(owner)
            await c.call("add_borrow", oid=oid, borrower=list(self.address))
        except Exception:
            pass

    # ------------------------------------------------------------- get_async

    async def get_async(self, refs: Sequence[ObjectRef],
                        timeout: Optional[float] = None) -> List[Any]:
        """Awaitable get: completion futures on the CALLING event loop,
        fed by memory-store waiters — a caller can await thousands of
        in-flight refs without parking a thread per ref (the async Serve
        ingress rides this).  Loop-agnostic: usable from any event loop,
        not just the worker's IO loop.

        Hot path (owned refs resolving to inline values — every serve
        reply under max_direct_call_object_size) completes entirely on
        the loop.  Plasma-stored or borrowed values fall back to one
        executor-thread blocking get for just those refs — the slow path
        is already dominated by the transfer, and reconstruction/
        recovery semantics stay identical to get()."""
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else time.monotonic() + timeout
        waits: List[Any] = []
        cleanups: List[Tuple[str, int]] = []

        def _waker(fut):
            return lambda: loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None))

        for ref in refs:
            oid = ref.oid
            if not self.memory.known(oid):
                # no memory entry to await (a local plasma put, or a
                # borrowed ref whose owner lives elsewhere): resolved by
                # the blocking fallback below, which long-polls/fetches
                # with the same deadline
                continue
            if self.memory.ready(oid):
                continue
            fut = loop.create_future()
            token = self.memory.add_waiter(oid, _waker(fut))
            if token is not None:
                waits.append(fut)
                cleanups.append((oid, token))
        try:
            if waits:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                try:
                    await asyncio.wait_for(
                        asyncio.gather(*waits), timeout=remaining)
                except asyncio.TimeoutError:
                    raise GetTimeoutError(
                        f"timed out awaiting {len(waits)} of "
                        f"{len(refs)} objects") from None
        finally:
            for oid, token in cleanups:
                self.memory.remove_waiter(oid, token)
        out: List[Any] = [None] * len(refs)
        slow: List[Tuple[int, ObjectRef]] = []
        for i, ref in enumerate(refs):
            entry = self.memory.peek(ref.oid)
            if entry is None or entry.in_plasma:
                slow.append((i, ref))
                continue
            if entry.error is not None:
                raise entry.error
            value, raw = entry.value, entry.raw
            if value is None and raw is None:
                # raced clear (reconstruction): take the blocking path
                slow.append((i, ref))
                continue
            if value is None:
                with SerializationContext() as dctx:
                    value = serialization.deserialize(raw)
                    entry.value = value
                self._register_foreign_refs(dctx.refs)
            out[i] = value
        if slow:
            # the ABSOLUTE deadline rides into the executor job: deriving
            # it at job start would let executor queue wait silently
            # extend the caller's timeout
            slow_refs = [r for _, r in slow]
            values = await loop.run_in_executor(
                None, lambda: self._get_inner(slow_refs, deadline))
            for (i, _), v in zip(slow, values):
                out[i] = v
        return out

    # ------------------------------------------------------------------ wait

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """Event-driven wait (no polling; reference: src/ray/raylet/
        wait_manager.h).  Locally-owned refs register memory-store waiter
        callbacks fired by the IO thread on resolution; borrowed refs run
        ONE long-poll probe each against their owner (the owner blocks
        server-side until the object resolves), instead of a 5 ms
        check-everything loop with a sync RPC per ref per iteration."""
        deadline = None if timeout is None else time.monotonic() + timeout
        cond = threading.Condition()
        ready_idx: Set[int] = set()
        removals: List[Tuple[str, int]] = []  # (oid, token) to clean up
        probes: List[Any] = []  # concurrent futures wrapping probe tasks

        def mark(idx: int) -> None:
            with cond:
                ready_idx.add(idx)
                cond.notify_all()

        for idx, ref in enumerate(refs):
            oid = ref.oid
            if self.memory.ready(oid):
                ready_idx.add(idx)
            elif self.memory.known(oid):
                token = self.memory.add_waiter(oid, lambda i=idx: mark(i))
                if token is None:  # resolved between the two checks
                    ready_idx.add(idx)
                else:
                    removals.append((oid, token))
            else:
                coro = self._aprobe_ready(ref, idx, mark, deadline)
                if self._shutdown:
                    coro.close()
                    continue
                try:
                    probes.append(self._io.spawn(coro))
                except RuntimeError:
                    coro.close()

        try:
            with cond:
                while len(ready_idx) < min(num_returns, len(refs)):
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        break
                    cond.wait(remaining)
        finally:
            # cancel probes NOW — a probe parked in a 10 s owner-side
            # long-poll must not outlive the wait that spawned it (the
            # poll-loop pattern `while pending: ray.wait(pending, 0.5)`
            # would otherwise pile up ~N*(10s/timeout) live probes)
            for f in probes:
                f.cancel()
            for oid, token in removals:
                self.memory.remove_waiter(oid, token)
        with cond:
            snapshot = set(ready_idx)
        ready = [r for i, r in enumerate(refs) if i in snapshot]
        pending = [r for i, r in enumerate(refs) if i not in snapshot]
        return ready, pending

    async def _aprobe_ready(self, ref: ObjectRef, idx: int, mark,
                            deadline) -> None:
        """Readiness probe for refs this process doesn't own: the local
        plasma store first, then a server-side long-poll on the owner
        (covers values inlined in the owner's memory store, which never
        touch plasma).  Ended by cancellation from wait()'s finally."""
        import asyncio

        while True:
            try:
                if self.plasma.contains(ref.oid):
                    mark(idx)
                    return
            except Exception:
                pass
            owner = ref.owner_addr
            if owner is None or tuple(owner) == self.address:
                return  # nothing that could ever resolve it
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return
            poll = 10.0 if remaining is None else min(10.0, remaining)
            t0 = time.monotonic()
            try:
                r = await self._afetch_from_owner(tuple(owner), ref.oid, poll)
            except Exception:
                await asyncio.sleep(0.2)
                continue
            if any(k in r for k in ("inline", "plasma", "error", "freed")):
                mark(idx)
                return
            if time.monotonic() - t0 < 0.5:
                # the owner answered without long-polling (e.g. "unknown"
                # for an evicted entry): pace the loop or it spins RPCs
                # at round-trip rate until the wait deadline
                await asyncio.sleep(0.5)

    # ---------------------------------------------------------- task submit

    def _serialize_args(self, args: tuple, kwargs: dict) -> Tuple[List[WireArg], List[ObjectRef]]:
        wire: List[WireArg] = []
        contained: List[ObjectRef] = []
        items = [(None, a) for a in args] + list(kwargs.items())
        for kw, a in items:
            if isinstance(a, ObjectRef):
                contained.append(a)
                wire.append(WireArg(object_id=a.oid,
                                    owner_addr=a.owner_addr or self.address,
                                    kw=kw, **self._arg_hints(a)))
                continue
            with SerializationContext() as ctx:
                blob = serialization.serialize_to_bytes(a)
            contained.extend(ctx.refs)
            if len(blob) > config.max_direct_call_object_size:
                # big literal arg: put once, pass by ref
                ref = self.put(a)
                contained.append(ref)
                wire.append(WireArg(object_id=ref.oid, owner_addr=self.address,
                                    kw=kw, **self._arg_hints(ref)))
            else:
                wire.append(WireArg(value=blob, kw=kw))
        return wire, contained

    def _arg_hints(self, ref: ObjectRef) -> Dict[str, Any]:
        """Locality hints for a ref argument: (holder node addr, size)
        from the owner's reference table, falling back to the ref's own
        recorded plasma location for borrowed refs.  pick_node scores
        nodes by these bytes; the granting agent prefetches them."""
        loc = self._locations.get(ref.oid) \
            or (tuple(ref.node_addr) if ref.node_addr else None)
        if loc is None:
            return {}
        return {"loc": loc, "size": self._obj_sizes.get(ref.oid, 0)}

    def submit_task(self, function_id: str, args: tuple, kwargs: dict,
                    num_returns: int = 1, resources: Optional[Dict[str, float]] = None,
                    max_retries: int = 3, name: str = "",
                    runtime_env: Optional[Dict[str, Any]] = None,
                    scheduling_strategy: Optional[Dict[str, Any]] = None,
                    placement_group_id: str = "",
                    bundle_index: int = -1,
                    timeout_s: Optional[float] = None) -> List[ObjectRef]:
        from ray_tpu_torch._private.runtime_env import merge as _renv_merge

        if num_returns == "streaming":
            num_returns = STREAMING
        tid = TaskID.for_normal_task(JobID.from_hex(self.job_id))
        wire_args, contained = self._serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=tid.hex(), job_id=self.job_id, kind=NORMAL_TASK,
            function_id=function_id, args=wire_args, num_returns=num_returns,
            resources=resources or {"CPU": 1}, max_retries=max_retries,
            name=name, owner_addr=self.address, caller_id=self.worker_id,
            runtime_env=_renv_merge(self.job_runtime_env, runtime_env or {}),
            scheduling_strategy=scheduling_strategy or {},
            placement_group_id=placement_group_id,
            bundle_index=max(bundle_index, 0) if placement_group_id else -1,
            deadline=deadlines.effective_deadline(timeout_s) or 0.0)
        task = _TaskState(spec, contained)
        # submit span: child of whatever span this thread/coroutine is
        # running under (an executing task's span for nested submits, a
        # Serve ingress span, …) or a fresh sampled root.  The worker's
        # execute span parents to it via spec.trace_ctx; an unsampled
        # decision propagates too so the subtree doesn't re-roll.
        span, spec.trace_ctx = tracing.begin_submit(
            "submit " + (name or function_id[:8]))
        if span is not None:
            span.set_attribute("task_id", spec.task_id)
        refs: List[Any] = []
        if num_returns == STREAMING:
            # yields arrive incrementally; no automatic retries (a
            # consumed prefix cannot be replayed) — see streaming.py
            task.retries_left = 0
            self._streams[spec.task_id] = StreamState()
            refs.append(ObjectRefGenerator(self, spec.task_id))
        call_site = _user_call_site()
        for oid in task.return_oids:
            self.memory.ensure(oid)
            refs.append(ObjectRef(oid, owner_addr=self.address))
            self.rc.set_meta(oid, call_site=call_site,
                             name=name or function_id[:8])
        self.record_task_event(
            spec.task_id, "SUBMITTED",
            name=name or function_id[:8], kind=NORMAL_TASK,
            job_id=self.job_id)
        if any(a.object_id is not None for a in spec.args):
            self._spawn(self._submit(task))
        else:
            # no ref args: nothing to resolve — stage straight into the
            # class's partitioned queue.  The caller thread takes only
            # this class's lock and pays ONE loop wakeup per burst (the
            # pump_queued edge); the coalesced pump forms real
            # push_tasks batches out of whatever accumulated.
            self._stage_ready(task)
        if spec.deadline:
            # AFTER the enqueue: arming first would let a concurrent
            # sweep tick scan-and-disarm in the gap and never see this
            # task (the arm's racy handle read would then skip re-arming)
            self._arm_deadline_sweep()
        if span is not None:
            span.end()
        return refs

    def _sched_state(self, key: tuple) -> _SchedState:
        # called from caller threads too (staged submission): setdefault
        # keeps concurrent first-submissions of one class to one state
        state = self._sched.get(key)
        if state is None:
            state = self._sched.setdefault(key, _SchedState(key))
        return state

    def _stage_ready(self, task: _TaskState) -> None:
        state = self._sched_state(task.sched_key)
        with state.lock:
            if task.spec.deadline:
                state.has_deadlines = True
            state.staged.append(task)
            if state.pump_queued:
                return
            state.pump_queued = True
        try:
            self._loop().call_soon_threadsafe(self._coalesced_pump, state)
        except RuntimeError:
            with state.lock:
                state.pump_queued = False  # loop shut down

    def _coalesced_pump(self, state: _SchedState) -> None:
        with state.lock:
            state.pump_queued = False
        self._pump(state)

    def _fail_poisoned(self, state: _SchedState, spec: TaskSpec,
                       reply: Dict[str, Any]) -> None:
        """An agent refused this class's lease because the head
        quarantined it as poison: cache the verdict locally (later
        submissions fail before any RPC) and fail every pending task in
        the class fast with the typed error + kill history."""
        detail = reply.get("error_str", "task class is quarantined")
        history = list(reply.get("history", []))
        until = time.time() + _POISON_CACHE_S
        if spec.function_id:
            self._quarantined[spec.function_id] = (until, detail, history)
        err = PoisonedTaskError(detail, key=spec.function_id,
                                history=history)
        while state.pending:
            self._fail_task(state.pending.popleft(), err)

    async def _submit(self, task: _TaskState):
        q = self._fid_quarantined(task.spec.function_id)
        if q is not None:
            # fail fast at submission: the class is quarantined as
            # poison (this owner learned it from a kill report or a
            # refused lease); dispatching would only be refused again
            self._fail_task(task, PoisonedTaskError(
                q[1], key=task.spec.function_id, history=q[2]))
            return
        # owner-side dependency resolution (reference: dependency_resolver.h)
        # — registered so ray_tpu_torch.cancel can reach a task whose args are
        # still resolving (it is in no pending queue yet)
        self._resolving_tasks[task.spec.task_id] = task
        try:
            ok = await self._resolve_deps(task)
        finally:
            self._resolving_tasks.pop(task.spec.task_id, None)
        if not ok or task.cancelled:
            return
        state = self._sched_state(task.sched_key)
        if task.spec.deadline:
            state.has_deadlines = True
        state.pending.append(task)
        self._pump(state)

    async def _resolve_deps(self, task: _TaskState) -> bool:
        for arg in task.spec.args:
            if arg.object_id is None:
                continue
            oid = arg.object_id
            if not self.memory.known(oid):
                continue  # plasma object or foreign ref: worker will fetch
            e = self.memory._entry(oid)
            if not e.event.is_set():
                await self._loop().run_in_executor(None, e.event.wait)
            if e.error is not None:
                self._fail_task(task, e.error)
                return False
            if e.in_plasma:
                arg.owner_addr = self.address
            elif e.raw is not None:
                arg.value = e.raw
                arg.object_id = None
            else:
                arg.value = serialization.serialize_to_bytes(e.value)
                arg.object_id = None
        for arg in task.spec.args:
            # refs that were still pending when _serialize_args stamped
            # hints have resolved locations now: fill them in so the
            # lease request can score locality / prefetch
            if arg.object_id is not None and arg.loc is None:
                loc = self._locations.get(arg.object_id)
                if loc is not None:
                    arg.loc = loc
                    arg.size = self._obj_sizes.get(arg.object_id, 0)
        return True

    # ---------------------------------------------------------- cancellation

    def cancel(self, target, force: bool = False) -> None:
        """Cancel a task by any of its return refs or its generator
        (reference: python/ray/_private/worker.py:2942 ray.cancel).
        No-op if the task already finished."""
        if isinstance(target, ObjectRefGenerator):
            task_id = target.task_id
        else:
            task_id = ObjectID(bytes.fromhex(target.oid)).task_id().hex()
        self._io.run(self._cancel_async(task_id, force), timeout=30.0)

    async def _cancel_async(self, task_id: str, force: bool):
        err = TaskCancelledError(f"task {task_id[:12]} was cancelled")
        # 0. args still resolving (not yet in any queue): fail it now and
        # tell _submit to drop it when resolution finishes
        task = self._resolving_tasks.get(task_id)
        if task is not None:
            task.cancelled = True
            self._fail_task(task, err)
            return
        # 1. still pending owner-side (never pushed): fail it locally.
        # list(): caller threads insert new classes concurrently
        for state in list(self._sched.values()):
            # staged = submitted but not yet drained by a pump pass
            with state.lock:
                staged_hit = next((t for t in state.staged
                                   if t.spec.task_id == task_id), None)
                if staged_hit is not None:
                    state.staged.remove(staged_hit)
            if staged_hit is not None:
                self._fail_task(staged_hit, err)
                return
            for task in list(state.pending):
                if task.spec.task_id == task_id:
                    state.pending.remove(task)
                    self._fail_task(task, err)
                    return
            # 2. pushed to a leased worker: interrupt it there
            for lease in state.leases:
                for task in list(lease.inflight):
                    if task.spec.task_id == task_id:
                        await self._cancel_on_worker(
                            task, lease.addr, force)
                        return
        for astate in list(self._actors.values()):
            for task in list(astate.pending):
                if task.spec.task_id == task_id:
                    astate.pending.remove(task)
                    self._fail_task(task, err)
                    return
            for task in list(astate.inflight.values()):
                if task.spec.task_id != task_id:
                    continue
                if astate.addr:
                    await self._cancel_on_worker(task, astate.addr, force)
                else:
                    # actor mid-recovery: no live worker to interrupt.
                    # Mark the task so the recovery requeue resolves it
                    # with TaskCancelledError instead of silently
                    # re-running it on the restarted actor.
                    task.retries_left = 0
                    task.cancelled = True
                    self._cancelled_tasks.add(task_id)
                return
        # already finished (or unknown): no-op, like the reference

    def _take_cancelled(self, task: _TaskState) -> bool:
        """If this task was force-cancelled, consume the mark and resolve
        it as cancelled.  Used by the connection-failure handlers: the
        worker's death IS the cancellation outcome, never a retryable
        fault."""
        if task.spec.task_id in self._deadline_resolved:
            # the deadline sweep already resolved this task with
            # DeadlineExceededError — consume every mark and report
            # "handled" so no path overwrites or retries it
            self._deadline_resolved.discard(task.spec.task_id)
            self._cancelled_tasks.discard(task.spec.task_id)
            return True
        if task.spec.task_id not in self._cancelled_tasks:
            return False
        self._cancelled_tasks.discard(task.spec.task_id)
        self._fail_task(task, TaskCancelledError(
            f"task {task.spec.task_id[:12]} was cancelled (force=True)"))
        return True

    async def _cancel_on_worker(self, task: _TaskState,
                                addr: Tuple[str, int], force: bool):
        task.retries_left = 0
        if force:
            # the worker will exit; the push failure must read as
            # cancellation, not a worker fault to retry
            self._cancelled_tasks.add(task.spec.task_id)
        try:
            c = await self._aclient_worker(addr)
            await c.call("cancel_task", task_id=task.spec.task_id,
                         force=force, timeout=10.0)
        except Exception:
            pass  # worker already gone: the push path resolves the task

    def _fail_task(self, task: _TaskState, error: BaseException):
        # owner-side failures (cancelled while queued, worker death with
        # no retries left, scheduling errors) never reach an executor —
        # record FAILED here or the task-event store would show the task
        # SUBMITTED forever and the timeline would silently drop it.
        # _executor=False: if the task DID run (worker died mid-task),
        # the executor's RUNNING event already attributed the record and
        # this event must not re-stamp it with the owner's identity
        self.record_task_event(task.spec.task_id, "FAILED",
                               _executor=False, error=str(error)[:200])
        for oid in task.return_oids:
            self.memory.set_error(oid, error)
        if task.spec.num_returns == STREAMING:
            s = self._streams.get(task.spec.task_id)
            if s is not None and s.error is None:
                s.error = error
                s.wake()
        with self._lineage_lock:
            self._reconstructing.discard(task.spec.task_id)
        task.contained_refs = []

    # ------------------------------------------------------ deadline sweep

    def _arm_deadline_sweep(self) -> None:
        """Called from submit paths (any thread) when a deadlined task
        enters the system: make sure the owner-side sweep timer is
        running.  The sweep self-re-arms while any deadlined work
        exists and dies when none does, so undeadlined workloads never
        pay for it."""
        if self._deadline_sweep_handle is not None or self._shutdown:
            return  # racy read is fine: the loop-side ensure re-checks
        try:
            self._loop().call_soon_threadsafe(self._ensure_deadline_sweep)
        except RuntimeError:
            pass  # loop shut down

    def _ensure_deadline_sweep(self) -> None:
        if self._deadline_sweep_handle is None and not self._shutdown:
            self._deadline_sweep_handle = self._loop().call_later(
                config.deadline_check_interval_ms / 1000.0,
                self._deadline_sweep_tick)

    def _fail_deadline(self, task: _TaskState, where: str) -> None:
        """Resolve a task as deadline-exceeded owner-side.  For tasks
        still queued this IS fail-fast (never dispatched — no reply
        will ever come, so nothing to track); for running tasks the
        caller additionally fires the cancel path and the late worker
        reply is discarded via _deadline_resolved (tracking queued
        expiries there would grow the set forever)."""
        task.retries_left = 0
        task.cancelled = True
        if where == "running":
            self._deadline_resolved.add(task.spec.task_id)
        deadlines.count_exceeded(where)
        self._fail_task(task, DeadlineExceededError(
            f"task {task.spec.name or task.spec.method_name or task.spec.task_id[:12]} "
            f"exceeded its deadline while {where}", where=where))

    def _deadline_sweep_tick(self) -> None:
        """One sweep over every owner-side queue and in-flight set:
        expired queued tasks fail fast without dispatching; expired
        running tasks are resolved NOW (the caller's get() unblocks at
        the deadline, not at cancel completion) and cancelled on their
        worker — cooperative first, the existing force path after
        deadline_force_cancel_grace_s."""
        self._deadline_sweep_handle = None
        now = time.time()
        live = False
        resolved = self._deadline_resolved
        # 0. args still resolving (in no queue yet)
        for task in list(self._resolving_tasks.values()):
            dl = task.spec.deadline
            if not dl or task.spec.task_id in resolved:
                continue
            if now >= dl:
                self._fail_deadline(task, "queued")
            else:
                live = True
        # 1. normal-task classes: staged, pending, leased-and-inflight
        for state in list(self._sched.values()):
            expired: List[_TaskState] = []
            with state.lock:
                for t in list(state.staged):
                    if t.spec.deadline and now >= t.spec.deadline:
                        state.staged.remove(t)
                        expired.append(t)
                    elif t.spec.deadline:
                        live = True
            for t in list(state.pending):
                if t.spec.deadline and now >= t.spec.deadline:
                    state.pending.remove(t)
                    expired.append(t)
                elif t.spec.deadline:
                    live = True
            for t in expired:
                self._fail_deadline(t, "queued")
            for lease in list(state.leases):
                for t in list(lease.inflight):
                    dl = t.spec.deadline
                    if not dl or t.spec.task_id in resolved:
                        continue
                    if now >= dl:
                        self._fail_deadline(t, "running")
                        self._spawn(self._deadline_cancel(t, lease.addr))
                    else:
                        live = True
        # 2. actor calls: pending + inflight
        for astate in list(self._actors.values()):
            for t in list(astate.pending):
                if t.spec.deadline and now >= t.spec.deadline:
                    try:
                        astate.pending.remove(t)
                    except ValueError:
                        continue
                    self._fail_deadline(t, "queued")
                elif t.spec.deadline:
                    live = True
            for t in list(astate.inflight.values()):
                dl = t.spec.deadline
                if not dl or t.spec.task_id in resolved:
                    continue
                if now >= dl:
                    self._fail_deadline(t, "running")
                    if astate.addr:
                        self._spawn(self._deadline_cancel(t, astate.addr))
                else:
                    live = True
        if live:
            self._ensure_deadline_sweep()

    async def _deadline_cancel(self, task: _TaskState,
                               addr: Tuple[str, int]):
        """Cancel a deadline-expired RUNNING task on its worker: the
        cooperative interrupt first (async-exc / coroutine cancel at
        the next bytecode), then — if it is STILL running after the
        grace — the existing force path (worker exit; queued tasks
        behind it requeue for free via _account_push_death)."""
        tid = task.spec.task_id
        try:
            c = await self._aclient_worker(addr)
            await c.call("cancel_task", task_id=tid, force=False,
                         timeout=10.0)
        except ConnectionLost:
            return  # worker gone: the push failure path resolves it
        except Exception:
            # a TIMEOUT here is the gray case the force path exists
            # for (a worker wedged in native code / chaos-stalled never
            # answers the cooperative RPC) — fall through to force
            pass
        grace = float(config.deadline_force_cancel_grace_s)
        if grace > 0:
            await self._sleep(grace)
        self._cancelled_tasks.add(tid)
        try:
            c = await self._aclient_worker(addr)
            r = await c.call("cancel_task", task_id=tid, force=True,
                             timeout=10.0)
            if not r.get("ok"):
                self._cancelled_tasks.discard(tid)  # already finished
        except Exception:
            self._cancelled_tasks.discard(tid)

    @staticmethod
    def _pool_key_of(sched_key: tuple) -> tuple:
        # scheduling_class() = (resources, kind, function_id, pg_id,
        # bundle_index, env_key, strategy): the pool key drops kind and
        # function_id — any function of the same shape can reuse the
        # leased worker, which is what makes throughput independent of
        # WHICH function a previous burst ran
        return sched_key[:1] + sched_key[3:]

    def _park_lease(self, state: _SchedState, lease: _Lease) -> None:
        """Idle lease → warm pool (replaces the per-lease linger timer).
        Parked leases keep their agent-side grant; the pool-level sweep
        returns them after _WARM_LEASE_TTL_S of disuse."""
        if lease.dead:
            return
        if lease in state.leases:
            state.leases.remove(lease)
        lease.warm_since = time.monotonic()
        self._warm_leases.setdefault(lease.pool_key, []).append(lease)
        self._ensure_warm_sweep()

    def _adopt_warm_lease(self, state: _SchedState) -> Optional[_Lease]:
        pool = self._warm_leases.get(self._pool_key_of(state.key))
        while pool:
            lease = pool.pop()  # LIFO: hottest worker first
            if lease.dead:
                continue
            self._warm_adopted += 1
            state.leases.append(lease)
            return lease
        return None

    def _ensure_warm_sweep(self) -> None:
        if self._warm_sweep_handle is None and not self._shutdown:
            self._warm_sweep_handle = self._loop().call_later(
                _WARM_LEASE_TTL_S / 2, self._sweep_warm_leases)

    def _sweep_warm_leases(self) -> None:
        self._warm_sweep_handle = None
        now = time.monotonic()
        any_left = False
        for key, pool in list(self._warm_leases.items()):
            keep = []
            for lease in pool:
                if lease.dead:
                    continue
                if now - lease.warm_since >= _WARM_LEASE_TTL_S:
                    self._warm_returned += 1
                    self._spawn(self._return_pooled(lease))
                else:
                    keep.append(lease)
            if keep:
                self._warm_leases[key] = keep
                any_left = True
            else:
                self._warm_leases.pop(key, None)
        if any_left:
            self._ensure_warm_sweep()

    async def _return_pooled(self, lease: _Lease, kill: bool = False):
        if lease.dead:
            return
        lease.dead = True
        await self._notify_drop(lease, kill)

    @staticmethod
    def _locality_pref_addr(spec: TaskSpec) -> Optional[Tuple[str, int]]:
        """Agent addr holding this task's biggest hinted argument (past
        the locality threshold), or None.  The pump prefers a lease on
        that node so class-sharing pipelines don't undo the cluster
        policy's locality routing."""
        totals: Dict[Tuple[str, int], int] = {}
        for a in spec.args:
            if a.object_id is not None and a.loc and a.size:
                key = (a.loc[0], a.loc[1])
                totals[key] = totals.get(key, 0) + a.size
        if not totals:
            return None  # common case: config never consulted
        # sum per node, mirroring pick_node's arg_bytes_by_node scoring
        # (a node holding two medium args beats one holding a single
        # larger arg); stable tie-break on the addr
        best, best_size = max(totals.items(), key=lambda kv: (kv[1], kv[0]))
        min_bytes = int(config.locality_min_bytes)
        if min_bytes <= 0 or best_size < min_bytes:
            return None
        return best

    def _pump(self, state: _SchedState):
        # drain the cross-thread staged queue first: one pass moves a
        # whole submission burst into pending (partitioned handoff —
        # only this class's lock, never a process-global one)
        if state.staged:
            with state.lock:
                state.pending.extend(state.staged)
                state.staged.clear()
        if state.has_deadlines and state.pending:
            # fail-fast BEFORE dispatch: an expired task must never
            # consume a lease slot (the sweep covers idle periods; this
            # covers the moment of assignment)
            now_w = time.time()
            doomed = [t for t in state.pending
                      if t.spec.deadline and now_w >= t.spec.deadline
                      and t.spec.task_id not in self._deadline_resolved]
            for t in doomed:
                state.pending.remove(t)
                self._fail_deadline(t, "queued")
        # hand pending tasks to leases at the depth the service-time
        # curve allows; adopt warm-pool leases before breaking — a
        # pooled worker beats both a deeper pipeline and a fresh lease
        # request
        live = [l for l in state.leases if not l.dead]
        depth = state.stats.depth()
        # group this tick's assignments per lease, filling each chosen
        # lease's pipeline with a CHUNK of consecutive tasks: N tasks to
        # one worker ride ONE push_tasks frame instead of N push RPCs.
        # Assigning one task at a time to the min-inflight lease (the
        # old policy) fragmented a burst into batches of 1-2 spread
        # round-robin across leases — frames, not payload bytes, are
        # what cap small-task throughput, so the fragmentation was the
        # tasks/s ceiling (round-6 profile: 340 single-task frames for
        # a 1000-task burst).
        batches: Dict[int, Tuple[_Lease, List[_TaskState]]] = {}
        deferred: List[_TaskState] = []
        now = time.monotonic()
        while state.pending:
            candidates = [l for l in live if len(l.inflight) < depth]
            if not candidates:
                adopted = (self._adopt_warm_lease(state)
                           if len(state.leases) < _MAX_LEASES_PER_CLASS
                           else None)
                if adopted is None:
                    break  # every lease at depth, nothing warm to adopt
                live.append(adopted)
                continue
            head = state.pending[0]
            # a lease on the node already holding the task's argument
            # bytes beats the shallowest pipeline: the task skips the
            # transfer entirely (cluster-level locality routing decided
            # node choice; this is its per-task dispatch counterpart)
            lease = None
            pref = self._locality_pref_addr(head.spec)
            if pref is not None:
                for cand in candidates:
                    if tuple(cand.agent_addr) == pref:
                        lease = cand
                        break
                if lease is None:
                    # no lease on the holder: hold the task back rather
                    # than binding it to the wrong node.  First
                    # encounter defers unconditionally — requeueing
                    # makes the deficit loop below fire a lease request
                    # whose locality routing targets the holder (an
                    # existing warm lease elsewhere must not swallow
                    # the task before pick_node ever sees it).  After
                    # that, keep deferring only while requests are in
                    # flight, within the deadline — bounded, so a
                    # saturated holder can only delay it, never strand
                    # it
                    state.pending.popleft()
                    first = head.defer_deadline == 0.0
                    if first:
                        head.defer_deadline = now + _LOCALITY_DEFER_S
                    if now < head.defer_deadline \
                            and (first or state.inflight_requests > 0):
                        deferred.append(head)
                        continue
                    # deferral bound passed: dispatch off-holder rather
                    # than strand the task
                    lease = min(candidates, key=lambda l: len(l.inflight))
                    lease.inflight.append(head)
                    batches.setdefault(id(lease), (lease, []))[1].append(head)
                    continue
            if lease is None:
                lease = min(candidates, key=lambda l: len(l.inflight))
            # fill the chosen lease's pipeline with consecutive
            # compatible tasks — a task whose locality pref names a
            # DIFFERENT node breaks the chunk and gets its own pass
            chunk = batches.setdefault(id(lease), (lease, []))[1]
            lease_addr = tuple(lease.agent_addr)
            while len(lease.inflight) < depth and state.pending:
                nxt = state.pending[0]
                npref = (pref if nxt is head
                         else self._locality_pref_addr(nxt.spec))
                if npref is not None and lease_addr != npref:
                    break
                state.pending.popleft()
                lease.inflight.append(nxt)
                chunk.append(nxt)
        if deferred:
            state.pending.extendleft(reversed(deferred))
            if not state.defer_timer:
                # deadline-driven re-pump: without it a request queued
                # 30s at a busy holder would strand deferred tasks past
                # their bound until the next unrelated pump event
                state.defer_timer = True
                wake = min(t.defer_deadline for t in deferred)

                def _expire():
                    state.defer_timer = False
                    self._pump(state)

                self._loop().call_later(max(0.0, wake - now) + 0.01, _expire)
        for lease, tasks in batches.values():
            if not tasks:
                continue
            self._observe_batch_size(len(tasks))
            if len(tasks) == 1:
                self._spawn(self._push(state, lease, tasks[0]))
            else:
                self._spawn(self._push_batch(state, lease, tasks))
        if not state.pending:
            # no demand: cancel outstanding lease requests — a stale
            # queued request would be granted later, sit idle, and
            # stall demand queued behind it on the agent (reference:
            # CancelWorkerLease on lease_policy mismatch/drain)
            if state.request_agents:
                cancels, state.request_agents = state.request_agents, {}
                for rid, addr in cancels.items():
                    self._spawn(self._cancel_lease_request(rid, addr))
            # park every idle lease in the warm pool (a lease granted
            # after the queue drained would otherwise pin resources
            # forever, and the NEXT burst — any function — adopts it)
            for lease in list(state.leases):
                if not lease.inflight and not lease.dead:
                    self._park_lease(state, lease)
            return
        # request more leases if there is unmet demand.  The ask is
        # sized to the pipeline capacity still uncovered — pending /
        # depth workers — not to raw pending count (the old policy
        # over-requested 16 leases for a sub-ms burst one worker could
        # drain, churning worker spawns + queued-request cancels).
        # every live lease is already pipeline-saturated here (the
        # assignment loop only leaves pending tasks when no lease is
        # below depth), so the uncovered demand is pending alone —
        # subtracting live leases again would starve small bursts that
        # spill just past one lease's depth
        need = -(-len(state.pending) // max(1, depth))  # ceil
        deficit = need - state.inflight_requests
        capacity = (_MAX_LEASES_PER_CLASS - len(state.leases)
                    - state.inflight_requests)
        want = max(0, min(deficit, capacity,
                          int(config.lease_request_batch_max)))
        if want <= 0:
            return
        head_spec = state.pending[0].spec
        if deferred or head_spec.placement_group_id:
            # locality-deferred tasks (or bundle-targeted specs) need
            # each request to carry a DISTINCT pending task's spec so
            # hints route leases to each task's holder — keep the
            # per-spec single-request path for them
            for _ in range(want):
                state.inflight_requests += 1
                spec = state.pending[state.req_rr % len(state.pending)].spec
                state.req_rr += 1
                self._spawn(self._request_lease(state, spec))
        else:
            # homogeneous demand: ONE request_leases frame asks the
            # agent for every missing lease at once — a 2k-task burst
            # costs O(1) lease RPC rounds, not O(missing leases)
            state.inflight_requests += want
            self._spawn(self._request_leases(state, head_spec, want))

    _batch_hist = None

    def _observe_batch_size(self, n: int) -> None:
        if self._batch_hist is None:
            from ray_tpu_torch._private.metrics import dispatch_batch_size_histogram

            self._batch_hist = dispatch_batch_size_histogram()
        self._batch_hist.observe(n)

    async def _cancel_lease_request(self, rid: str, addr: Tuple[str, int]):
        try:
            c = await self._aclient_agent(addr)
            await c.oneway("cancel_lease_request", req_id=rid)
        except Exception:
            pass

    async def _pg_bundle_addr(self, pg_id: str, bundle_index: int,
                              refresh: bool = False):
        """Resolve (and cache) the agent address hosting a PG bundle.

        Returns (status, addr): status in {"ok", "pending", "gone"}.
        """
        info = None if refresh else self._pg_cache.get(pg_id)
        if info is None or info.get("state") != "CREATED":
            info = await self.head.aio.call(
                "get_placement_group", pg_id=pg_id, wait=True,
                timeout=config.pubsub_poll_timeout_ms / 1000.0 + 10.0)
            self._pg_cache[pg_id] = info
        placements = info.get("placements") or []
        if info.get("state") == "PENDING":
            return "pending", None
        if info.get("state") != "CREATED" or bundle_index >= len(placements):
            return "gone", None
        p = placements[bundle_index]
        if p is None:
            return "pending", None  # bundle being re-reserved after node death
        return "ok", (p["addr"][0], p["addr"][1])

    async def _request_lease(self, state: _SchedState, spec: TaskSpec):
        rid = ""
        try:
            if spec.placement_group_id:
                await self._request_pg_lease(state, spec)
                return
            state.req_counter += 1
            rid = f"{self.worker_id[:12]}-{state.req_counter}"
            agent_addr = self.agent_addr
            for _hop in range(8):
                state.request_agents[rid] = agent_addr
                try:
                    c = await self._aclient_agent(agent_addr)
                    reply = await c.call(
                        "request_lease", spec=spec.to_wire(), req_id=rid,
                        timeout=config.worker_lease_timeout_ms / 1000.0 + 10.0)
                except (ConnectionLost, RpcError):
                    if agent_addr == self.agent_addr:
                        raise
                    agent_addr = self.agent_addr  # spillback target died: retry home
                    continue
                if "spillback" in reply:
                    agent_addr = tuple(reply["spillback"]["addr"])
                    continue
                if "granted" in reply:
                    g = reply["granted"]
                    lease = _Lease(g["lease_id"], g["worker_id"],
                                   (g["addr"][0], g["addr"][1]), agent_addr,
                                   gpu_ids=g.get("gpu_ids"),
                                   pool_key=self._pool_key_of(state.key),
                                   resources=dict(spec.resources))
                    state.leases.append(lease)
                    return
                if reply.get("error") == "infeasible":
                    err = SchedulingError(reply.get("error_str", "infeasible"))
                    while state.pending:
                        self._fail_task(state.pending.popleft(), err)
                    return
                if reply.get("error") == "poisoned":
                    self._fail_poisoned(state, spec, reply)
                    return
                if reply.get("error") == "runtime env setup failed":
                    err = RuntimeEnvSetupError(
                        reply.get("error_str", "runtime env setup failed"))
                    while state.pending:
                        self._fail_task(state.pending.popleft(), err)
                    return
                if reply.get("error") == "canceled":
                    return  # we canceled it: demand drained
                if reply.get("error") == "deadline exceeded":
                    # the agent dropped our queued lease request because
                    # the spec's deadline passed: the finally's pump
                    # fails the expired tasks fast and re-requests for
                    # whatever demand remains
                    return
                # lease timeout: retry while there is still demand
                if not state.pending:
                    return
        finally:
            if rid:
                state.request_agents.pop(rid, None)
            state.inflight_requests -= 1
            self._pump(state)

    async def _request_leases(self, state: _SchedState, spec: TaskSpec,
                              count: int):
        """Batched lease acquisition: ONE request_leases frame asks an
        agent for up to `count` workers of this spec's shape; the agent
        grants what fits now in one reply (node_agent.rpc_request_leases).
        A partial grant returns immediately — the post-reply pump
        recomputes the deficit and re-asks, which converges in at most
        one extra frame while never camping on a saturated agent's FIFO
        with a multi-lease request."""
        rid = ""
        try:
            state.req_counter += 1
            rid = f"{self.worker_id[:12]}-{state.req_counter}"
            agent_addr = self.agent_addr
            for _hop in range(8):
                state.request_agents[rid] = agent_addr
                try:
                    c = await self._aclient_agent(agent_addr)
                    reply = await c.call(
                        "request_leases", spec=spec.to_wire(), count=count,
                        req_id=rid,
                        timeout=config.worker_lease_timeout_ms / 1000.0 + 10.0)
                except (ConnectionLost, RpcError):
                    if agent_addr == self.agent_addr:
                        raise
                    agent_addr = self.agent_addr  # spillback target died
                    continue
                if "spillback" in reply:
                    agent_addr = tuple(reply["spillback"]["addr"])
                    continue
                grants = reply.get("granted_list") or ()
                for g in grants:
                    state.leases.append(_Lease(
                        g["lease_id"], g["worker_id"],
                        (g["addr"][0], g["addr"][1]), agent_addr,
                        gpu_ids=g.get("gpu_ids"),
                        pool_key=self._pool_key_of(state.key),
                        resources=dict(spec.resources)))
                if grants:
                    return
                if reply.get("error") == "infeasible":
                    err = SchedulingError(reply.get("error_str", "infeasible"))
                    while state.pending:
                        self._fail_task(state.pending.popleft(), err)
                    return
                if reply.get("error") == "poisoned":
                    self._fail_poisoned(state, spec, reply)
                    return
                if reply.get("error") == "runtime env setup failed":
                    err = RuntimeEnvSetupError(
                        reply.get("error_str", "runtime env setup failed"))
                    while state.pending:
                        self._fail_task(state.pending.popleft(), err)
                    return
                if reply.get("error") == "canceled":
                    return  # we canceled it: demand drained
                if reply.get("error") == "deadline exceeded":
                    return  # expired spec: the finally's pump fails it
                if not state.pending:
                    return  # lease timeout with no demand left
        finally:
            if rid:
                state.request_agents.pop(rid, None)
            state.inflight_requests -= count
            self._pump(state)

    async def _request_pg_lease(self, state: _SchedState, spec: TaskSpec):
        """Leases for bundle-targeted tasks go straight to the node that
        reserved the bundle (no hybrid policy / spillback)."""
        idx = max(spec.bundle_index, 0)
        attempt = 0
        while True:
            status, addr = await self._pg_bundle_addr(
                spec.placement_group_id, idx, refresh=attempt > 0)
            if status == "pending":
                # the group (or this bundle) isn't placed yet: the head
                # keeps scheduling it; waiting must not consume attempts
                attempt = max(attempt, 1)
                continue
            if status == "gone" or attempt >= 4:
                err = SchedulingError(
                    f"placement group {spec.placement_group_id[:12]} bundle "
                    f"{idx} is not available")
                while state.pending:
                    self._fail_task(state.pending.popleft(), err)
                return
            attempt += 1
            try:
                c = await self._aclient_agent(addr)
                reply = await c.call(
                    "request_lease", spec=spec.to_wire(),
                    timeout=config.worker_lease_timeout_ms / 1000.0 + 10.0)
            except (ConnectionLost, RpcError):
                continue  # bundle node died: refresh placement and retry
            if "granted" in reply:
                g = reply["granted"]
                lease = _Lease(g["lease_id"], g["worker_id"],
                               (g["addr"][0], g["addr"][1]), addr,
                               gpu_ids=g.get("gpu_ids"), in_bundle=True,
                               pool_key=self._pool_key_of(state.key),
                               resources=dict(spec.resources))
                state.leases.append(lease)
                return
            if reply.get("error") == "bundle not reserved":
                continue  # rescheduled elsewhere: refresh and retry
            if reply.get("error") == "infeasible":
                err = SchedulingError(reply.get("error_str", "infeasible"))
                while state.pending:
                    self._fail_task(state.pending.popleft(), err)
                return
            if reply.get("error") == "poisoned":
                self._fail_poisoned(state, spec, reply)
                return
            if not state.pending:
                return

    def _observe_exec(self, state: _SchedState, reply: Dict[str, Any]) -> None:
        """Feed the worker-reported execution time from a result frame
        into the class's windowed service estimator."""
        exec_s = reply.get("exec_s")
        if isinstance(exec_s, (int, float)):
            state.stats.observe(float(exec_s))

    def _reply_disposition(self, task: _TaskState,
                           reply: Dict[str, Any]) -> str:
        """How to resolve a completed push: "resolve" (normal reply
        processing), "retry" (worker flagged a retryable fault, e.g. a
        stale cancellation interrupt hit the wrong task — requeue without
        surfacing the error), or "cancelled" (already resolved here)."""
        if not reply.get("retryable"):
            return "resolve"
        if self._take_cancelled(task):
            return "cancelled"
        if task.retries_left == 0:
            return "resolve"  # out of retries: surface the reply's error
        if task.retries_left > 0:
            task.retries_left -= 1
        return "retry"

    async def _push(self, state: _SchedState, lease: _Lease, task: _TaskState):
        # LEASED marks dispatch to a leased worker; the head derives the
        # queued (submitted→leased) and leased (leased→running) phases of
        # ray_tpu_task_sched_latency_seconds from it
        self.record_task_event(task.spec.task_id, "LEASED")
        try:
            c = await self._aclient_worker(lease.addr)
            reply = await c.call("push_task", spec=task.spec.to_wire(),
                                 gpu_ids=lease.gpu_ids,
                                 timeout=_TASK_PUSH_TIMEOUT)
        except (ConnectionLost, RpcError, Exception) as e:
            self._drop_lease(state, lease, kill=True)
            # a watchdog kill's receipt rides the agent connection, the
            # death itself the worker connection: one beat lets an
            # in-flight receipt land before the death is classified
            await self._sleep(0.05)
            if self._account_push_death(lease, task, e):
                await self._sleep(self._death_retry_delay([task]))
                state.pending.appendleft(task)
            self._pump(state)
            return
        self._observe_exec(state, reply)
        try:
            lease.inflight.remove(task)
        except ValueError:
            pass
        d = self._reply_disposition(task, reply)
        if d == "retry":
            state.pending.appendleft(task)
        elif d == "resolve":
            await self._process_reply(task, reply, lease.addr)
        self._pump(state)

    def _account_push_death(self, lease: _Lease, task: _TaskState,
                            error: Exception) -> bool:
        """Worker-death policy for one pushed task (shared by single and
        batched pushes): only the task actually running (oldest in the
        worker's FIFO when it died) is charged a retry; tasks merely
        queued behind it were never started and requeue for free.
        A watchdog OOM receipt for the dead worker reroutes the charge
        to the separate OOM budget (typed error when exhausted).
        Returns True if the task should be requeued, False if it was
        resolved (cancelled or failed)."""
        started = lease.failed_head is task
        try:
            lease.inflight.remove(task)
        except ValueError:
            pass
        if self._take_cancelled(task):
            return False
        if started:
            receipt = self._oom_receipts.pop(lease.worker_id, None)
            if receipt is not None:
                return self._account_oom_death(task, receipt)
        if not started or task.retries_left != 0:
            if started and task.retries_left > 0:
                task.retries_left -= 1
            return True
        # TERMINAL crash (whole retry budget burned on worker deaths):
        # feed the head's poison accounting — classes that reliably
        # crash workers quarantine like OOM loops do.  Deliberately NOT
        # counted per-kill: one dead NODE takes every same-class lease
        # on it at once, and a class that recovers on retry elsewhere
        # must never read as poison
        self._report_task_kill(task.spec, "crash")
        self._fail_task(task, RayWorkerError(
            f"worker {lease.worker_id[:8]} died running "
            f"{task.spec.name or task.spec.function_id[:8]}: {error}"))
        return False

    def _account_oom_death(self, task: _TaskState,
                           receipt: Dict[str, Any]) -> bool:
        """Charge one watchdog kill against the task's OOM budget.
        Never touches max_retries.  Exhausted budget (or an already-
        quarantined class) resolves the task with the typed error built
        from the receipt; otherwise the task requeues after a jittered
        exponential backoff (the rpc.backoff_delays shape) bounded by
        the spec's remaining deadline."""
        from ray_tpu_torch._private.memory_monitor import is_self_poisoning

        spec = task.spec
        if is_self_poisoning(int(receipt.get("rss", 0)),
                             int(receipt.get("limit", 0))):
            self._report_task_kill(spec, "oom")
        q = self._fid_quarantined(spec.function_id)
        if q is not None:
            self._fail_task(task, PoisonedTaskError(
                q[1], key=spec.function_id, history=q[2]))
            return False
        if task.oom_retries_left == 0:
            self._fail_task(task, self._oom_error(spec, receipt))
            return False
        if task.oom_retries_left > 0:
            task.oom_retries_left -= 1
        task.oom_attempt += 1
        base = config.task_retry_delay_ms / 1000.0
        cap = config.task_oom_retry_max_backoff_ms / 1000.0
        ceiling = min(max(base, 1e-3) * (2.0 ** task.oom_attempt), cap)
        delay = random.uniform(ceiling / 2.0, ceiling)
        if spec.deadline:
            remaining = spec.deadline - time.time()
            if remaining <= 0:
                self._fail_deadline(task, "queued")
                return False
            delay = min(delay, remaining)
        task.oom_delay = delay
        return True

    @staticmethod
    def _oom_error(spec: TaskSpec, receipt: Dict[str, Any]) -> Exception:
        name = spec.name or spec.method_name or spec.function_id[:8]
        return OutOfMemoryError(
            f"task {name!r} was OOM-killed by the memory watchdog on "
            f"node {receipt.get('node_id', '')[:12]} (worker RSS "
            f"{int(receipt.get('rss', 0)) >> 20} MiB, node usage "
            f"{receipt.get('usage', 0.0):.0%} >= threshold "
            f"{receipt.get('threshold', 0.0):.0%}) and its "
            f"task_oom_retries budget is exhausted",
            rss_bytes=int(receipt.get("rss", 0)),
            node_usage=float(receipt.get("usage", 0.0)),
            node_id=receipt.get("node_id", ""),
            worker_id=receipt.get("worker_id", ""),
            breakdown=receipt.get("breakdown") or {})

    def _fid_quarantined(self, fid: str) -> Optional[tuple]:
        """The live local-quarantine record for fid, TTL-pruned."""
        q = self._quarantined.get(fid)
        if q is None:
            return None
        if q[0] and time.time() >= q[0]:
            self._quarantined.pop(fid, None)
            return None
        return q

    def _report_task_kill(self, spec: TaskSpec, kind: str) -> None:
        """Tell the head this class's execution killed a worker (fire-
        and-forget from the IO loop); the reply carries the class's
        quarantine verdict, cached locally so the NEXT submission fails
        fast without waiting for lease-layer gossip."""
        fid = spec.function_id
        if not fid:
            return
        self._kill_history.add(fid)
        name = spec.name or spec.method_name or fid[:8]

        async def _report():
            try:
                r = await self.head.aio.call(
                    "task_kill_report", key=fid, kind=kind, name=name,
                    node_id=self.node_id)
            except Exception:
                return
            if r.get("quarantined"):
                until = min(float(r.get("until", 0.0)) or
                            (time.time() + _POISON_CACHE_S),
                            time.time() + _POISON_CACHE_S)
                self._quarantined[fid] = (
                    until,
                    r.get("detail", f"task class {name!r} is quarantined"),
                    list(r.get("history", [])))

        self._spawn(_report())

    def _report_task_ok(self, spec: TaskSpec) -> None:
        """First success of a class with local kill history: reset the
        head's consecutive-kill count (fire-and-forget)."""
        fid = spec.function_id
        if fid not in self._kill_history:
            return
        self._kill_history.discard(fid)

        async def _report():
            try:
                await self.head.aio.call("task_ok_report", key=fid)
            except Exception:
                pass

        self._spawn(_report())

    @staticmethod
    def _death_retry_delay(tasks: List[_TaskState]) -> float:
        """The pre-requeue sleep for a batch of death-requeued tasks:
        the plain worker-death delay, or the longest OOM backoff any of
        them was charged (consumed so a later, non-OOM requeue of the
        same task sleeps normally)."""
        delay = config.task_retry_delay_ms / 1000.0
        for t in tasks:
            if t.oom_delay > 0:
                delay = max(delay, t.oom_delay)
                t.oom_delay = 0.0
        return delay

    async def _push_batch(self, state: _SchedState, lease: _Lease,
                          tasks: List[_TaskState]):
        """One push_tasks frame carrying N specs (this tick's assignments
        to one lease).  The worker executes FIFO and pushes each result
        back the moment it completes ("batch_result" — handled in
        _on_exec_worker_push, which removes the task from inflight), so
        failure semantics stay identical to per-task _push: on worker
        death, results that arrived were already processed, the task at
        inflight[0] is the one actually running, and only it is charged
        a retry."""
        for task in tasks:
            self._batch_pending[task.spec.task_id] = (
                "task", state, lease, task)
            self.record_task_event(task.spec.task_id, "LEASED")
        try:
            c = await self._aclient_worker(lease.addr)
            await c.call(
                "push_tasks", specs=[t.spec.to_wire() for t in tasks],
                gpu_ids=lease.gpu_ids, timeout=_TASK_PUSH_TIMEOUT)
        except (ConnectionLost, RpcError, Exception) as e:
            self._drop_lease(state, lease, kill=True)
            await self._sleep(0.05)  # let an in-flight OOM receipt land
            requeue = [task for task in tasks
                       if self._batch_pending.pop(task.spec.task_id, None)
                       is not None  # else: result arrived before death
                       and self._account_push_death(lease, task, e)]
            if requeue:
                await self._sleep(self._death_retry_delay(requeue))
                state.pending.extendleft(reversed(requeue))
            self._pump(state)
            return
        # ordered connection: every batch_result was dispatched (and its
        # registration popped) before this reply resolved — nothing to do
        self._pump(state)

    async def _finish_batch_items(self, work: List[tuple]):
        """Process a frame's worth of batched-push results (inflight
        bookkeeping already done synchronously in the push handler);
        pump each touched scheduling state / actor once at the end."""
        states = {}
        astates = {}
        for entry, reply in work:
            if entry[0] == "task":
                _, state, lease, task = entry
                self._observe_exec(state, reply)
                d = self._reply_disposition(task, reply)
                if d == "retry":
                    state.pending.appendleft(task)
                elif d == "resolve":
                    await self._process_reply(task, reply, lease.addr)
                states[id(state)] = state
            else:  # actor
                _, astate, task, addr = entry
                d = self._reply_disposition(task, reply)
                if d == "retry":
                    self._actor_requeue(astate, task)
                elif d == "resolve":
                    await self._process_reply(task, reply, addr)
                astates[id(astate)] = astate
        for state in states.values():
            self._pump(state)
        for astate in astates.values():
            await self._actor_pump(astate)

    async def _sleep(self, s: float):
        import asyncio
        await asyncio.sleep(s)

    async def _return_lease(self, state: _SchedState, lease: _Lease, kill=False):
        if lease.inflight or lease.dead:
            return
        lease.dead = True
        if lease in state.leases:
            state.leases.remove(lease)
        try:
            c = await self._aclient_agent(lease.agent_addr)
            await c.call("return_lease", lease_id=lease.lease_id, kill_worker=kill)
        except Exception:
            pass

    def _drop_lease(self, state: _SchedState, lease: _Lease, kill: bool):
        if lease.dead:
            return  # several pipelined pushes may fail on the same lease
        lease.dead = True
        # snapshot which task was executing when the worker died — each
        # failing _push compares against this, not the shifting deque head
        lease.failed_head = lease.inflight[0] if lease.inflight else None
        if lease in state.leases:
            state.leases.remove(lease)
        self._spawn(self._notify_drop(lease, kill))

    async def _notify_drop(self, lease: _Lease, kill: bool):
        try:
            c = await self._aclient_agent(lease.agent_addr)
            await c.call("return_lease", lease_id=lease.lease_id, kill_worker=kill)
        except Exception:
            pass

    async def _process_reply(self, task: _TaskState, reply: Dict[str, Any],
                             worker_addr: Tuple[str, int]):
        if task.spec.task_id in self._deadline_resolved:
            # the deadline sweep resolved this task while it ran; the
            # late reply (a value, or the cancel-induced error) must
            # not overwrite the DeadlineExceededError the caller saw.
            # Still ack held values so the worker's pin set drains.
            self._deadline_resolved.discard(task.spec.task_id)
            self._cancelled_tasks.discard(task.spec.task_id)
            if reply.get("needs_ack"):
                try:
                    c = await self._aclient_worker(worker_addr)
                    await c.oneway("task_ack", task_id=task.spec.task_id)
                except Exception:
                    pass
            with self._lineage_lock:
                self._reconstructing.discard(task.spec.task_id)
            task.contained_refs = []
            return
        if task.spec.num_returns == STREAMING:
            # every stream_item push was dispatched before this reply
            # (same ordered connection), so arrived is final here
            s = self._streams.get(task.spec.task_id)
            if s is not None:
                if reply.get("error"):
                    results = reply.get("results") or []
                    try:
                        s.error = cloudpickle.loads(results[0]["err"])
                    except Exception:
                        s.error = RayTaskError(
                            task.spec.name or "stream",
                            reply.get("error_str", "<unpicklable error>"))
                else:
                    s.total = int(reply.get("stream_len", s.arrived))
                s.wake()
        results = reply.get("results", [])
        nested_all: Dict[str, List] = reply.get("nested") or {}
        for i, oid in enumerate(task.return_oids):
            r = results[i] if i < len(results) else {"err": cloudpickle.dumps(
                RayWorkerError("missing return value"))}
            nested = nested_all.get(oid) or []
            if nested:
                inner_refs = []
                for n_oid, n_owner, n_node in nested:
                    ref = ObjectRef(n_oid,
                                    owner_addr=tuple(n_owner) if n_owner else None,
                                    node_addr=tuple(n_node) if n_node else None)
                    inner_refs.append(ref)
                    if ref.owner_addr is not None and tuple(ref.owner_addr) != self.address:
                        await self._send_add_borrow(tuple(ref.owner_addr), n_oid)
                self._containers[oid] = inner_refs
            if "err" in r:
                try:
                    exc = cloudpickle.loads(r["err"])
                except Exception:
                    exc = RayTaskError(task.spec.name or "task", "<unpicklable error>")
                self.memory.set_error(oid, exc)
            elif "v" in r:
                self.memory.set_raw(oid, r["v"])
            elif "stored" in r:
                node = tuple(r["stored"]["node"])
                self._locations[oid] = node
                if r["stored"].get("size"):
                    self._obj_sizes[oid] = r["stored"]["size"]
                if task.spec.kind == NORMAL_TASK:
                    self._record_lineage(task, oid)
                self.memory.set_in_plasma(oid, node)
        # the worker replied normally (e.g. a force-cancel caught the task
        # still queued): the force-death mapping entry is no longer needed
        self._cancelled_tasks.discard(task.spec.task_id)
        if not reply.get("error"):
            # a real completion of a class this owner reported kills
            # for: reset the head's consecutive-kill count (the poison
            # quarantine counts CONSECUTIVE kills by design)
            self._report_task_ok(task.spec)
        for b_oid in reply.get("borrows") or []:
            self.rc.add_borrower(b_oid, worker_addr)
        if reply.get("needs_ack"):
            try:
                c = await self._aclient_worker(worker_addr)
                await c.oneway("task_ack", task_id=task.spec.task_id)
            except Exception:
                pass
        with self._lineage_lock:
            self._reconstructing.discard(task.spec.task_id)
        task.contained_refs = []  # release submission pins

    # ------------------------------------------------- lineage reconstruction

    def _record_lineage(self, task: _TaskState, oid: str) -> None:
        with self._lineage_lock:
            entry = self._lineage.get(task.spec.task_id)
            if entry is None:
                entry = _LineageEntry(task.spec, list(task.contained_refs))
                self._lineage[task.spec.task_id] = entry
            entry.live.add(oid)
            self._lineage_by_oid[oid] = task.spec.task_id

    def _drop_lineage(self, oid: str) -> None:
        with self._lineage_lock:
            tid = self._lineage_by_oid.pop(oid, None)
            if tid is None:
                return
            entry = self._lineage.get(tid)
            if entry is not None:
                entry.live.discard(oid)
                if not entry.live:
                    self._lineage.pop(tid, None)  # arg pins released via GC

    def _maybe_reconstruct(self, oid: str) -> bool:
        """Resubmit the task that produced a lost plasma return.

        Returns True if a reconstruction is (already) underway — callers
        then re-wait on the object.  Reference:
        src/ray/core_worker/object_recovery_manager.cc (recover via
        TaskManager resubmit, bounded by the retry budget).
        """
        with self._lineage_lock:
            tid = self._lineage_by_oid.get(oid)
            if tid is None:
                return False
            entry = self._lineage.get(tid)
            if entry is None:
                return False
            if tid in self._reconstructing:
                return True
            if entry.attempts_left == 0:
                return False
            if entry.attempts_left > 0:
                entry.attempts_left -= 1
            self._reconstructing.add(tid)
            spec = entry.spec
        task = _TaskState(spec, list(entry.arg_pins))
        for roid in task.return_oids:
            self._locations.pop(roid, None)
            self.memory.clear_resolution(roid)
        self._spawn(self._submit(task))
        return True

    # ---------------------------------------------------------- actor submit

    def create_actor(self, class_id: str, args: tuple, kwargs: dict,
                     resources: Optional[Dict[str, float]] = None,
                     max_restarts: int = 0, max_task_retries: int = 0,
                     max_concurrency: int = 1, name: str = "",
                     runtime_env: Optional[Dict[str, Any]] = None,
                     scheduling_strategy: Optional[Dict[str, Any]] = None,
                     placement_group_id: str = "",
                     bundle_index: int = -1,
                     method_num_returns: Optional[Dict[str, Any]] = None
                     ) -> str:
        from ray_tpu_torch._private.runtime_env import merge as _renv_merge

        aid = ActorID.of(JobID.from_hex(self.job_id))
        tid = TaskID.for_actor_creation(aid)
        wire_args, contained = self._serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=tid.hex(), job_id=self.job_id, kind=ACTOR_CREATION_TASK,
            function_id=class_id, args=wire_args, num_returns=0,
            resources=resources or {"CPU": 1}, actor_id=aid.hex(),
            max_restarts=max_restarts, max_concurrency=max_concurrency,
            max_retries=max_task_retries, name=name,
            owner_addr=self.address, caller_id=self.worker_id,
            runtime_env=_renv_merge(self.job_runtime_env, runtime_env or {}),
            scheduling_strategy=scheduling_strategy or {},
            placement_group_id=placement_group_id,
            bundle_index=max(bundle_index, 0) if placement_group_id else -1)
        span, spec.trace_ctx = tracing.begin_submit(
            "create_actor " + (name or class_id[:8]))
        if span is not None:
            span.set_attribute("actor_id", aid.hex())
        self.head.call("create_actor", spec=spec.to_wire(), name=name,
                       method_num_returns=method_num_returns or {})
        if span is not None:
            span.end()
        # hold arg refs until the actor is alive; the head owns creation
        astate = _ActorState(aid.hex())
        self._actors[aid.hex()] = astate
        # keep contained refs pinned for the actor's lifetime (v1: simple)
        self._containers[f"actor:{aid.hex()}"] = contained
        return aid.hex()

    def submit_actor_task(self, actor_id: str, method_name: str, args: tuple,
                          kwargs: dict, num_returns: int = 1,
                          max_retries: int = 0,
                          timeout_s: Optional[float] = None
                          ) -> List[ObjectRef]:
        if num_returns == "streaming":
            num_returns = STREAMING
        astate = self._actors.get(actor_id)
        if astate is None:
            astate = self._actors.setdefault(actor_id, _ActorState(actor_id))
        tid = TaskID.for_actor_task(ActorID.from_hex(actor_id))
        wire_args, contained = self._serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=tid.hex(), job_id=self.job_id, kind=ACTOR_TASK,
            args=wire_args, num_returns=num_returns, resources={},
            max_retries=max_retries, actor_id=actor_id,
            method_name=method_name, caller_id=self.worker_id,
            owner_addr=self.address,
            deadline=deadlines.effective_deadline(timeout_s) or 0.0)
        span, spec.trace_ctx = tracing.begin_submit("submit " + method_name)
        if span is not None:
            span.set_attribute("task_id", spec.task_id)
            span.set_attribute("actor_id", actor_id)
            span.end()
        task = _TaskState(spec, contained)
        refs: List[Any] = []
        if num_returns == STREAMING:
            task.retries_left = 0
            self._streams[spec.task_id] = StreamState()
            refs.append(ObjectRefGenerator(self, spec.task_id))
        call_site = _user_call_site()
        for oid in task.return_oids:
            self.memory.ensure(oid)
            refs.append(ObjectRef(oid, owner_addr=self.address))
            self.rc.set_meta(oid, call_site=call_site, name=method_name)
        try:
            self._post_to_loop(self._actor_enqueue, astate, task)
        except RuntimeError:
            pass  # loop shut down
        if spec.deadline:
            # after the enqueue post (see submit_task): a sweep tick
            # between arm and enqueue could otherwise disarm for good
            self._arm_deadline_sweep()
        return refs

    def _actor_enqueue(self, astate: _ActorState, task: _TaskState) -> None:
        """Loop-side enqueue: assigns the seqno (in submission order —
        call_soon_threadsafe preserves caller order) and either marks the
        call ready or spawns dependency resolution.  Pumping is coalesced
        so rapid-fire calls form push_tasks batches (reference:
        direct_actor_task_submitter.h sequence numbers)."""
        if astate.dead:
            self._fail_task(task, ActorDiedError(
                astate.death_cause or "actor is dead"))
            return
        task.spec.seqno = astate.seq
        astate.seq += 1
        # enqueue BEFORE resolving deps so per-handle submission order is
        # preserved even when an earlier call waits on a pending ref
        if any(a.object_id is not None for a in task.spec.args):
            task.deps_ready = False
            astate.pending.append(task)
            self._spawn(self._actor_resolve_then_pump(astate, task))
        else:
            astate.pending.append(task)
            if not astate.pump_queued:
                astate.pump_queued = True
                self._loop().call_soon(self._actor_coalesced_pump, astate)

    def _actor_coalesced_pump(self, astate: _ActorState) -> None:
        astate.pump_queued = False
        self._spawn(self._actor_pump(astate))

    async def _actor_resolve_then_pump(self, astate: _ActorState,
                                       task: _TaskState):
        ok = await self._resolve_deps(task)
        if not ok:
            try:
                astate.pending.remove(task)
            except ValueError:
                pass
            await self._actor_pump(astate)  # unblock the queue behind it
            return
        task.deps_ready = True
        await self._actor_pump(astate)

    async def _actor_pump(self, astate: _ActorState):
        if astate.recovering or astate.dead:
            return
        while astate.addr is None:
            # keep long-polling until the actor lands somewhere: slow
            # constructors (first jax import in a fresh worker) can
            # outlast one poll window, and pushing with addr=None would
            # misclassify every queued task as a worker death.  One
            # coroutine polls per actor; concurrent pumps await it
            # instead of multiplying head long-polls.
            import asyncio

            if astate.resolving is not None:
                await astate.resolving
            else:
                astate.resolving = asyncio.get_running_loop().create_future()
                try:
                    await self._actor_resolve(astate)
                finally:
                    fut, astate.resolving = astate.resolving, None
                    fut.set_result(None)
            if astate.dead or astate.recovering:
                return
        batch: List[_TaskState] = []
        while astate.pending and astate.pending[0].deps_ready \
                and len(astate.inflight) < _MAX_ACTOR_INFLIGHT:
            task = astate.pending.popleft()
            astate.inflight[task.spec.seqno] = task
            batch.append(task)
        if len(batch) == 1:
            self._spawn(self._actor_push(astate, batch[0], astate.instance))
        elif batch:
            # one push_tasks frame for this tick's ready calls — the
            # worker executes FIFO so seqno order is preserved
            self._spawn(self._actor_push_batch(astate, batch,
                                               astate.instance))

    async def _actor_resolve(self, astate: _ActorState, known_instance: int = -1):
        try:
            info = await self.head.aio.call(
                "get_actor_info", actor_id=astate.actor_id, wait=True,
                known_instance=known_instance,
                timeout=config.pubsub_poll_timeout_ms / 1000.0 + 10.0)
        except Exception as e:
            astate.dead = True
            astate.death_cause = f"cannot reach head service: {e}"
            self._actor_fail_all(astate)
            return
        if info["state"] == "ALIVE":
            astate.addr = tuple(info["addr"])
            astate.instance = info["instance"]
        elif info["state"] == "DEAD":
            astate.dead = True
            astate.death_cause = info.get("death_cause", "actor died")
            self._actor_fail_all(astate)
        # PENDING/RESTARTING after long-poll timeout: stay unresolved; the
        # next pump retries

    def _actor_fail_all(self, astate: _ActorState):
        err = ActorDiedError(astate.death_cause or "actor died")
        for task in list(astate.inflight.values()):
            self._fail_task(task, err)
        astate.inflight.clear()
        while astate.pending:
            self._fail_task(astate.pending.popleft(), err)

    async def _actor_push(self, astate: _ActorState, task: _TaskState, instance: int):
        addr = astate.addr
        if addr is None:
            # a concurrent recovery cleared the address between pump and
            # push: this task was never sent — requeue it for free (it
            # must NOT be charged a retry or misreported as a death)
            astate.inflight.pop(task.spec.seqno, None)
            self._actor_requeue(astate, task)
            await self._actor_pump(astate)
            return
        try:
            c = await self._aclient_worker(addr)
            reply = await c.call("push_task", spec=task.spec.to_wire(),
                                 timeout=_TASK_PUSH_TIMEOUT)
        except (ConnectionLost, Exception) as e:
            await self._actor_recover(astate, [task], instance, e)
            return
        astate.inflight.pop(task.spec.seqno, None)
        d = self._reply_disposition(task, reply)
        if d == "retry":
            self._actor_requeue(astate, task)
        elif d == "resolve":
            # the snapshot, NOT astate.addr: a concurrent recovery may
            # have cleared/re-pointed the live field while we awaited the
            # reply, and borrows/acks must go to the executing worker
            await self._process_reply(task, reply, addr)
        await self._actor_pump(astate)

    async def _actor_push_batch(self, astate: _ActorState,
                                tasks: List[_TaskState], instance: int):
        """Batched actor push: one push_tasks frame for this tick's ready
        calls (FIFO on the worker preserves seqno order).  Per-task
        results arrive as "batch_result" pushes, so calls that completed
        before an actor death are never re-executed."""
        addr = astate.addr
        if addr is None:
            for task in tasks:
                astate.inflight.pop(task.spec.seqno, None)
                self._actor_requeue(astate, task)
            await self._actor_pump(astate)
            return
        for task in tasks:
            self._batch_pending[task.spec.task_id] = (
                "actor", astate, task, addr)
        try:
            c = await self._aclient_worker(addr)
            await c.call("push_tasks",
                         specs=[t.spec.to_wire() for t in tasks],
                         timeout=_TASK_PUSH_TIMEOUT)
        except (ConnectionLost, Exception) as e:
            unfinished = [t for t in tasks
                          if self._batch_pending.pop(t.spec.task_id, None)
                          is not None]
            await self._actor_recover(astate, unfinished, instance, e)
            return
        await self._actor_pump(astate)

    def _actor_requeue(self, astate: _ActorState, task: _TaskState) -> None:
        """Requeue preserving seqno order: concurrent pushes may requeue
        out of pop order, and the worker executes in arrival order.
        A task requeued after the actor died would sit in the dead
        actor's deque forever (pump no-ops on dead), pinning its arg
        refs — fail it instead."""
        if astate.dead:
            self._fail_task(task, ActorDiedError(
                astate.death_cause or "actor is dead"))
            return
        astate.pending.append(task)
        if len(astate.pending) > 1:
            astate.pending = deque(
                sorted(astate.pending, key=lambda t: t.spec.seqno))

    async def _actor_recover(self, astate: _ActorState,
                             tasks: List[_TaskState],
                             instance: int, error: Exception):
        """Connection to the actor failed mid-call."""
        for task in tasks:
            astate.inflight.pop(task.spec.seqno, None)
            if self._take_cancelled(task):
                continue
            if task.retries_left != 0:
                if task.retries_left > 0:
                    task.retries_left -= 1
                # retryable: requeued, re-sent after re-resolve
                self._actor_requeue(astate, task)
            else:
                self._fail_task(task, ActorDiedError(
                    f"actor task {task.spec.method_name} failed: "
                    f"worker died ({error})"))
        if astate.recovering or astate.dead:
            return
        astate.recovering = True
        try:
            if astate.instance == instance:  # nobody re-resolved yet
                astate.addr = None
                await self._actor_resolve(astate, known_instance=instance)
        finally:
            astate.recovering = False
        await self._actor_pump(astate)

    def kill_actor_async(self, actor_id: str):
        """Non-blocking kill, safe from __del__/GC contexts."""
        async def _kill():
            try:
                await self.head.aio.call("kill_actor", actor_id=actor_id,
                                         no_restart=True)
            except Exception:
                pass

        self._spawn(_kill())

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        self.head.call("kill_actor", actor_id=actor_id, no_restart=no_restart)
        astate = self._actors.get(actor_id)
        if astate is not None:
            astate.dead = True
            astate.death_cause = "killed via ray_tpu_torch.kill"
        self._containers.pop(f"actor:{actor_id}", None)

    # ------------------------------------------------------- task execution

    def _apply_gpu_env(self, gpu_ids: Optional[List[str]]) -> None:
        """Export the lease's cards as CUDA_VISIBLE_DEVICES (reference:
        accelerators/nvidia_gpu.py set_current_process_visible_accelerator_ids).

        CUDA reads the variable ONCE, at the first CUDA call in the
        process: a reused worker that has already initialised CUDA keeps
        the cards it saw then, whatever a later lease assigns — as the
        TPU plugin reads TPU_VISIBLE_CHIPS once in ray_tpu.  Tasks that
        touch CUDA should hold their GPU lease from the worker's first
        task on (actors do: they hold their lease for life)."""
        if gpu_ids:
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(gpu_ids)
        elif gpu_ids is not None:
            # an explicit empty assignment (a CPU-task lease on a reused
            # worker) must not leak the previous lease's cards: an empty
            # variable hides every card (an unset one would show them
            # all).  None — actor METHOD pushes — leaves the
            # constructor's assignment intact for the actor's lifetime.
            os.environ["CUDA_VISIBLE_DEVICES"] = ""

    def _enqueue_exec(self, spec: Dict[str, Any], conn) -> "asyncio.Future":
        fut = self._loop().create_future()
        self._exec_pending.add(spec.get("tid", ""))
        self._task_queue.put((spec, fut, conn))
        return fut

    async def rpc_push_task(self, spec: Dict[str, Any], instance: int = 0,
                            gpu_ids: Optional[List[str]] = None,
                            _conn=None):
        """Execute a pushed task (worker mode). Runs user code on the exec
        thread; this handler awaits completion and carries the results back
        in the reply (reference: core_worker.proto PushTask)."""
        self._apply_gpu_env(gpu_ids)
        return await self._enqueue_exec(spec, _conn)

    async def rpc_push_tasks(self, specs: List[Dict[str, Any]],
                             instance: int = 0,
                             gpu_ids: Optional[List[str]] = None,
                             _conn=None):
        """Batched push: N specs in one frame, executed FIFO (reference:
        the lease connection batching in direct_task_transport).

        Each task's result is pushed back ("batch_result" oneway) the
        moment it completes — NOT withheld until the whole batch is done —
        so the owner's failure accounting behaves exactly like per-task
        pushes: on a mid-batch worker death, finished results were
        already delivered and only the actually-running task is charged
        a retry.  The final reply is a bare completion marker."""
        import asyncio as _aio

        self._apply_gpu_env(gpu_ids)
        futs = []
        for spec in specs:
            fut = self._enqueue_exec(spec, _conn)
            if _conn is not None:
                def _send(f, tid=spec.get("tid", "")):
                    self._queue_batch_result(_conn, tid, f.result())
                fut.add_done_callback(_send)
            futs.append(fut)
        await _aio.gather(*futs)
        if _conn is not None:
            # anything still buffered goes out BEFORE the completion
            # reply — the owner may treat the reply as "all results in"
            await self._drain_batch_results(_conn)
        return {"done": len(specs)}

    def _queue_batch_result(self, conn, tid: str, reply: Dict[str, Any]):
        """Micro-batch per-task results: flush when
        dispatch_result_batch_max are buffered or
        dispatch_result_flush_ms after the first, whichever comes first.
        Trivial-task bursts coalesce many results per frame (frames, not
        payload bytes, are what cap small-task throughput); the ms
        ceiling is noise next to any non-trivial task's runtime."""
        key = id(conn)
        ent = self._result_bufs.get(key)
        if ent is None:
            self._result_bufs[key] = (conn, [{"tid": tid, "reply": reply}])
            self._loop().call_later(
                config.dispatch_result_flush_ms / 1000.0,
                self._flush_batch_results, key)
        else:
            ent[1].append({"tid": tid, "reply": reply})
            if len(ent[1]) >= int(config.dispatch_result_batch_max):
                self._flush_batch_results(key)

    def _flush_batch_results(self, key: int) -> None:
        import asyncio as _aio

        ent = self._result_bufs.pop(key, None)
        if ent is None:
            return
        conn, items = ent
        _aio.ensure_future(conn.push("batch_results", {"items": items}))

    async def _drain_batch_results(self, conn) -> None:
        ent = self._result_bufs.pop(id(conn), None)
        if ent is not None:
            try:
                await conn.push("batch_results", {"items": ent[1]})
            except Exception:
                pass

    async def rpc_cancel_task(self, task_id: str, force: bool = False):
        """Owner requests cancellation of a task pushed to this worker
        (reference: core_worker.proto CancelTask; _raylet.pyx raises
        TaskCancelledError in the executing thread).

        Queued-but-unstarted: marked, skipped at dequeue.  Running async
        body: the asyncio task is cancelled.  Running sync body: a
        TaskCancelledError is raised in the exec thread at its next
        bytecode boundary (a body blocked in native code is only
        interruptible with force).  force=True: the whole worker process
        exits — the owner observes the connection drop and maps it to
        TaskCancelledError via its cancelled-task set."""
        if task_id not in self._exec_pending:
            return {"ok": False}  # finished or never here: no-op
        self._cancelled_exec.add(task_id)
        if force and (task_id in self._sync_running
                      or task_id in self._async_running):
            loop = self._loop()
            loop.call_later(0.05, os._exit, 1)  # let the reply flush
            return {"ok": True, "killing": True}
        fut = self._async_running.get(task_id)
        if fut is not None:
            fut.cancel()
            return {"ok": True}
        ident = self._sync_running.get(task_id)
        if ident is not None:
            import ctypes

            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(ident), ctypes.py_object(TaskCancelledError))
        return {"ok": True}

    def _maybe_chaos_oom(self, spec: TaskSpec) -> None:
        """Chaos ``worker.oom`` site (fault_injection.py): an allocation
        bomb in the EXECUTING worker — real touched pages, so the
        watchdog's RSS sampling, victim selection, typed receipt, and
        the owner's OOM-budget retry all exercise end to end.  Growth is
        stepped so the watchdog (or, unvirtualized, the host's real
        threshold) catches it mid-climb; the safety valve raises
        MemoryError rather than hang forever if nothing kills us (the
        watchdog disabled or the rule armed without one)."""
        from ray_tpu_torch._private import fault_injection

        chaos = fault_injection.decide(
            "worker.oom",
            # keyed by the task's NAME first: rules can target one
            # function by its qualname without knowing function ids
            key=spec.name or spec.method_name or spec.function_id)
        if chaos is None or chaos.action != "oom":
            return
        # grow to just past the watchdog trigger, then park awaiting the
        # kill: under a virtual node envelope
        # (memory_monitor_node_total_bytes) this worker's RSS alone
        # crosses the threshold, so tests/bench never stress the real
        # host; without one the 4 GiB cap bounds the damage
        total = int(config.memory_monitor_node_total_bytes)
        threshold = float(config.memory_usage_threshold)
        target = min(int(total * threshold) + (64 << 20) if total > 0
                     else 4 << 30, 4 << 30)
        hoard = []
        step = 32 * 1024 * 1024
        while len(hoard) * step < target:
            hoard.append(b"\x01" * step)  # touched pages: real RSS
            time.sleep(0.02)  # let the watchdog sample mid-climb
        deadline = time.time() + 60.0
        while time.time() < deadline:  # the SIGKILL ends this park
            time.sleep(0.25)
        del hoard
        raise MemoryError(
            "chaos worker.oom bomb reached its allocation target but "
            "was never killed — is the memory watchdog disabled?")

    async def rpc_chaos_rules(self, rules: Optional[List] = None,
                              version: Optional[int] = None):
        """Agent-forwarded chaos rule set (fault_injection.py): installs
        the gossiped rules in THIS worker process so worker-side sites
        (worker.oom, rpc.*) fire here, including for workers that were
        already running when the rules were armed."""
        from ray_tpu_torch._private import fault_injection

        if config.chaos_enabled:
            fault_injection.install(rules or [], version)
        return {"ok": True}

    async def rpc_chaos_stall(self, duration_s: float = 1.0):
        """Chaos ``worker.stall`` site (fault_injection.py): busy-hang
        this process's RPC IO loop for ``duration_s``.  Deliberately a
        BLOCKING sleep on the loop — every push reply, stream item, and
        cancel RPC stalls while the process stays alive, which is the
        gray-failure shape (a replica wedged mid-GC) that kill-based
        chaos cannot produce.  Sent by the node agent as a oneway (the
        stalled loop cannot reply until it wakes)."""
        from ray_tpu_torch._private import fault_injection

        fault_injection.sleep_sync(min(float(duration_s), 600.0))
        return {"ok": True}

    async def rpc_exit_worker(self):
        self._task_queue.put(None)

    async def rpc_persist_actor_state(self):
        """Drain hook: flush this worker's actor state via ``__rt_save__``
        right now (the head calls it before migrating the actor off a
        draining node).  {"saved": False} when the actor has no save
        hook or no durable storage is configured — the head then falls
        back to a plain (stateless) restart or a normal death."""
        import asyncio as _aio

        saved = await _aio.get_running_loop().run_in_executor(
            None, self.persist_actor_state)
        return {"saved": bool(saved)}

    def _finish_exec(self, task_id: str) -> None:
        self._cancelled_exec.discard(task_id)
        self._exec_pending.discard(task_id)

    def exec_loop(self):
        """Worker main loop: executes tasks until exit (reference:
        python/ray/_private/workers/default_worker.py main loop).

        TaskCancelledError guards: PyThreadState_SetAsyncExc is
        inherently racy — a cancel aimed at a task that just finished
        can fire here between tasks.  A stale cancellation must not kill
        this thread (the worker would silently stop serving pushes)."""
        while True:
            item = None
            reply = None
            t0 = 0.0
            try:
                item = self._task_queue.get()
                if item is None:
                    # propagate shutdown to any extra concurrency threads
                    for _ in self._exec_threads:
                        self._task_queue.put(None)
                    return
                t0 = time.perf_counter()
                try:
                    reply = self._execute(item[0], item[2])
                except BaseException as e:  # _execute never raises by design
                    reply = self._classify_exec_error(
                        TaskSpec.from_wire(item[0]), e,
                        traceback.format_exc())
                # worker-reported execution time rides every result frame
                # so the owner's dispatch-depth estimator measures actual
                # service time, never the owner-side round trip
                reply["exec_s"] = time.perf_counter() - t0
                self._post_exec_reply(item[1], reply)
            except TaskCancelledError:
                # stale async-exc from an already-finished task fired
                # between tasks (or on the reply-post line): swallow it —
                # and still deliver the computed reply so the owner's
                # push never hangs on a lost future.  If it interrupted
                # this task's bookkeeping before a reply existed, report
                # a RETRYABLE worker fault — the interrupt belonged to a
                # different task, so this one must not read as cancelled
                if item is not None:
                    if reply is None:
                        reply = self._error_reply(
                            TaskSpec.from_wire(item[0]), RayWorkerError(
                                "exec interrupted by stale cancel"), "")
                        reply["retryable"] = True
                    if t0:
                        reply.setdefault(
                            "exec_s", time.perf_counter() - t0)
                    try:
                        self._post_exec_reply(item[1], reply)
                    except Exception:
                        pass
                continue

    def _classify_exec_error(self, spec: TaskSpec, e: BaseException,
                             tb: str) -> Dict[str, Any]:
        """Error reply for an exception that escaped task execution.

        A TaskCancelledError whose task was never actually cancelled here
        is a STALE interrupt: PyThreadState_SetAsyncExc aimed at a task
        that finished between the cancel RPC's liveness check and the
        raise lands at the next bytecode of whatever runs on this thread
        — i.e. inside the NEXT task's user code.  That task was disrupted
        through no fault of its own, so the reply is flagged retryable
        (the owner requeues it) instead of resolving as a cancellation
        of the wrong task."""
        if isinstance(e, TaskCancelledError) \
                and spec.task_id not in self._cancelled_exec:
            reply = self._error_reply(spec, RayWorkerError(
                f"task {spec.name or spec.function_id[:8]!r} was "
                f"interrupted by a stale cancellation aimed at an "
                f"already-finished task"), tb)
            reply["retryable"] = True
            return reply
        return self._error_reply(spec, e, tb)

    def _post_exec_reply(self, fut, reply) -> None:
        self._post_to_loop(self._set_exec_result, fut, reply)

    @staticmethod
    def _set_exec_result(fut, reply) -> None:
        if not fut.done():
            fut.set_result(reply)

    def _start_concurrency_threads(self, n: int):
        """Extra executors for actors with max_concurrency > 1
        (reference: concurrency groups / threaded actors,
        transport/concurrency_group_manager.h)."""
        for i in range(n):
            t = threading.Thread(target=self.exec_loop,
                                 name=f"rt-exec-{i + 1}", daemon=True)
            t.start()
            self._exec_threads.append(t)

    _metrics = None

    @classmethod
    def _get_metrics(cls):
        if cls._metrics is None:
            from ray_tpu_torch._private.metrics import Counter, Histogram

            cls._metrics = {
                "finished": Counter("rt_tasks_finished",
                                    "tasks executed successfully"),
                "failed": Counter("rt_tasks_failed", "tasks that raised"),
                "duration": Histogram("rt_task_duration_seconds",
                                      "task execution wall time"),
            }
        return cls._metrics

    def _execute(self, spec_wire: Dict[str, Any],
                 conn=None) -> Dict[str, Any]:
        """Deadline wrapper around the traced execute: the spec's
        absolute deadline is re-activated on this exec thread (and, via
        the context copy in _run_coroutine, in async task bodies) so
        nested ``.remote()`` submissions and ``get()`` calls inside the
        task inherit the caller's remaining budget — the same
        propagation contract trace context has."""
        dl = spec_wire.get("dl")
        if not dl:
            return self._execute_traced(spec_wire, conn)
        token = deadlines.activate(float(dl))
        try:
            return self._execute_traced(spec_wire, conn)
        finally:
            deadlines.restore(token)

    def _execute_traced(self, spec_wire: Dict[str, Any],
                        conn=None) -> Dict[str, Any]:
        """Tracing wrapper: a sampled submission carries its context in
        the spec; the execute span parents to the caller's submit span,
        and — via the contextvar — any `.remote()` the task body makes
        chains into the same trace (reference: tracing_helper.py
        _inject_tracing_into_function)."""
        ctx = tracing.ctx_from_wire(spec_wire.get("trace"))
        if ctx is None:
            return self._execute_inner(spec_wire, conn)
        if not ctx.sampled:
            # inherit the caller's negative decision: nested submits
            # from the task body must not re-roll sampling
            token = tracing.activate(ctx)
            try:
                return self._execute_inner(spec_wire, conn)
            finally:
                tracing.restore(token)
        span = tracing.start_span(
            "execute " + (spec_wire.get("name")
                          or spec_wire.get("method")
                          or spec_wire.get("fid", "")[:8] or "task"),
            kind=tracing.KIND_SERVER, parent=ctx)
        if span is None:  # tracing disabled in this worker
            return self._execute_inner(spec_wire, conn)
        span.set_attribute("task_id", spec_wire.get("tid", ""))
        token = tracing.activate(span.context())
        try:
            reply = self._execute_inner(spec_wire, conn)
        except BaseException as e:  # pragma: no cover — inner returns
            span.end(error=f"{type(e).__name__}: {e}")
            raise
        finally:
            tracing.restore(token)
        span.end(error=reply.get("error_str", "")
                 if reply.get("error") else "")
        return reply

    def _execute_inner(self, spec_wire: Dict[str, Any],
                       conn=None) -> Dict[str, Any]:
        spec = TaskSpec.from_wire(spec_wire)
        self._exec.task_id = spec.task_id
        self._exec.job_id = spec.job_id
        self._exec.num_returns = spec.num_returns
        if spec.runtime_env:
            # nested tasks/actors submitted from inside this task inherit
            # its (already job-merged, normalized) runtime env — matching
            # the reference's parent-env inheritance.  Safe worker-wide:
            # this worker only ever serves tasks of this env_key.
            self.job_runtime_env = spec.runtime_env
        m = self._get_metrics()
        t0 = time.time()
        self.record_task_event(spec.task_id, "RUNNING", name=spec.name
                               or spec.method_name or spec.function_id[:8],
                               kind=spec.kind, job_id=spec.job_id)
        if spec.task_id in self._cancelled_exec:
            # cancelled while queued behind earlier tasks: never run it
            self.record_task_event(spec.task_id, "FAILED", error="cancelled")
            self._finish_exec(spec.task_id)
            return self._error_reply(
                spec, TaskCancelledError(f"task {spec.task_id[:12]} was "
                                         "cancelled before it started"), "")
        if spec.deadline and time.time() >= spec.deadline:
            # expired while queued in this worker's pipeline (behind
            # earlier tasks): fail fast without running — the owner's
            # sweep likely resolved it already and discards this reply
            deadlines.count_exceeded("queued")
            self.record_task_event(spec.task_id, "FAILED",
                                   error="deadline exceeded")
            self._finish_exec(spec.task_id)
            return self._error_reply(
                spec, DeadlineExceededError(
                    f"task {spec.task_id[:12]} exceeded its deadline "
                    f"before it started", where="queued"), "")
        # registered BEFORE arg materialization so a cancel arriving
        # during a long remote-arg fetch interrupts it (the async exc
        # fires at the fetch loop's next bytecode) instead of being lost
        self._sync_running[spec.task_id] = threading.get_ident()
        try:
            args, kwargs, arg_ref_oids = self._materialize_args(spec)
        except BaseException as e:
            m["failed"].inc()
            self.record_task_event(spec.task_id, "FAILED", error=str(e)[:200])
            # classify BEFORE _finish_exec clears the cancel mark
            reply = self._classify_exec_error(spec, e, traceback.format_exc())
            self._sync_running.pop(spec.task_id, None)
            self._finish_exec(spec.task_id)
            return reply
        if spec.task_id in self._cancelled_exec:
            # cancel landed during materialization, after the first check
            self._sync_running.pop(spec.task_id, None)
            self.record_task_event(spec.task_id, "FAILED", error="cancelled")
            self._finish_exec(spec.task_id)
            return self._error_reply(
                spec, TaskCancelledError(f"task {spec.task_id[:12]} was "
                                         "cancelled before it started"), "")
        try:
            if spec.kind == ACTOR_CREATION_TASK:
                cls = self.functions.fetch(spec.function_id)
                self._actor_instance = cls(*args, **kwargs)
                self._actor_creation_spec = spec
                self._maybe_restore_actor_state(spec)
                if spec.max_concurrency > 1 and not self._exec_threads:
                    self._start_concurrency_threads(spec.max_concurrency - 1)
                self.record_task_event(spec.task_id, "FINISHED")
                return {"results": []}
            if spec.kind == ACTOR_TASK:
                if self._actor_instance is None:
                    raise ActorDiedError("actor instance not initialized")
                if spec.method_name.startswith("__rt_dag_"):
                    # compiled-DAG system methods (dag/execution.py):
                    # the exec loop PINS this exec thread — it blocks on
                    # its input channels and replays the actor's bound
                    # methods until the graph is torn down.  Flagged to
                    # the agent so the OOM watchdog treats this worker
                    # as a last-resort victim (killing it tears down the
                    # whole graph/pipeline/engine, not one task)
                    from ray_tpu_torch.dag import execution as _dag_exec

                    self._push_worker_flags(pinned=True)
                    try:
                        if spec.method_name == _dag_exec.DAG_INFO_METHOD:
                            value = _dag_exec.collect_node_info(self)
                        elif spec.method_name == _dag_exec.DAG_EXEC_METHOD:
                            value = _dag_exec.run_actor_loop(
                                self, self._actor_instance, *args)
                        elif spec.method_name in (PIPELINE_EXEC_METHOD,
                                                  PIPELINE_CTL_METHOD):
                            # MPMD pipeline stage loop / control ops
                            # (train/pipeline.py): the loop pins this
                            # exec thread for the whole training run,
                            # like the compiled-DAG loop above
                            from ray_tpu_torch.train import pipeline as _pipe

                            if spec.method_name == PIPELINE_EXEC_METHOD:
                                value = _pipe.run_stage_loop(
                                    self, self._actor_instance, *args)
                            else:
                                value = _pipe.run_stage_ctl(
                                    self, self._actor_instance, *args)
                        elif spec.method_name == LLM_EXEC_METHOD:
                            # LLM serving decode loop (serve/llm.py):
                            # pins this exec thread to the replica
                            # engine's continuous-batching step loop
                            from ray_tpu_torch.serve import llm as _serve_llm

                            value = _serve_llm.run_llm_loop(
                                self, self._actor_instance, *args)
                        else:
                            raise AttributeError(
                                f"unknown compiled-DAG system method "
                                f"{spec.method_name!r}")
                    finally:
                        self._push_worker_flags(pinned=False)
                else:
                    self._maybe_chaos_oom(spec)
                    fn = getattr(self._actor_instance, spec.method_name)
                    value = fn(*args, **kwargs)
            else:
                self._maybe_chaos_oom(spec)
                fn = self.functions.fetch(spec.function_id)
                value = fn(*args, **kwargs)
            if spec.num_returns == STREAMING:
                reply = self._stream_out(spec, value, conn)
                failed = bool(reply.get("error"))
                m["failed" if failed else "finished"].inc()
                m["duration"].observe(time.time() - t0)
                self.record_task_event(
                    spec.task_id, "FAILED" if failed else "FINISHED",
                    **({"error": reply.get("error_str", "")[:200]}
                       if failed else {}))
                return reply
            if inspect.iscoroutine(value):
                # async def tasks/actor methods (reference: async actors,
                # _raylet.pyx execute_task coroutine path).  All
                # coroutines share ONE persistent loop (see
                # _run_coroutine); a blocking call inside async code
                # stalls every async call on this worker — same caveat
                # as the reference's async actors.
                value = self._run_coroutine(value)
            if spec.kind == ACTOR_TASK \
                    and not spec.method_name.startswith("__rt_dag_"):
                # snapshot AFTER the method succeeded and BEFORE the
                # caller sees the result: state the reply proves is
                # durable enough to survive a SIGKILL right after
                self._maybe_save_actor_state()
        except BaseException as e:
            m["failed"].inc()
            m["duration"].observe(time.time() - t0)
            self.record_task_event(spec.task_id, "FAILED", error=str(e)[:200])
            # evaluated before the finally clears the cancel mark, so
            # stale-interrupt classification still sees _cancelled_exec
            return self._classify_exec_error(spec, e, traceback.format_exc())
        finally:
            self._sync_running.pop(spec.task_id, None)
            self._finish_exec(spec.task_id)
        m["finished"].inc()
        m["duration"].observe(time.time() - t0)
        self.record_task_event(spec.task_id, "FINISHED")
        try:
            return self._success_reply(spec, value, arg_ref_oids)
        except BaseException as e:
            # an unserializable return value (e.g. a generator returned
            # without num_returns="streaming") must produce an error
            # reply, not kill the exec thread and hang the owner's push
            return self._error_reply(spec, e, traceback.format_exc())

    # ------------------------------------------- stateful actor restarts

    def _actor_state_checkpoint(self, actor_id: str):
        """Snapshot store for this worker's actor (lazy): pickled blobs
        through train/checkpoint.py's storage layer, rooted at
        ``actor_state_storage_path`` (default <session_dir>/actor_state,
        reachable from every node in local clusters; point it at shared
        storage for real multi-host deployments)."""
        if self._actor_state_ckpt is not None:
            return self._actor_state_ckpt
        from ray_tpu_torch.train.checkpoint import ActorStateCheckpoint
        from ray_tpu_torch.train.storage import StorageContext

        root = config.actor_state_storage_path
        if not root:
            session = os.environ.get("RT_SESSION_DIR", "")
            if not session:
                return None  # nowhere durable to put snapshots
            root = os.path.join(session, "actor_state")
        self._actor_state_ckpt = ActorStateCheckpoint(
            StorageContext(root), actor_id,
            keep=int(config.actor_state_keep))
        return self._actor_state_ckpt

    def _maybe_restore_actor_state(self, spec: TaskSpec) -> None:
        """After the constructor ran: if the class opted in
        (``__rt_restore__``) and a previous incarnation of THIS actor id
        saved state, replay it — a killed counter/KV/optimizer actor
        resumes where its last completed call left it, instead of from
        __init__ (RESTARTING → ALIVE with state)."""
        inst = self._actor_instance
        if not hasattr(inst, "__rt_restore__") or not spec.actor_id:
            return
        try:
            ckpt = self._actor_state_checkpoint(spec.actor_id)
            if ckpt is None or not ckpt.has_snapshot():
                return
            state = ckpt.load_latest()
            if state is not None:
                inst.__rt_restore__(state)
        except Exception:
            # a broken restore must not fail the (re)start — the actor
            # comes up fresh, which is what it did before this feature
            traceback.print_exc()

    def persist_actor_state(self) -> bool:
        """Unconditional ``__rt_save__`` snapshot of this worker's actor,
        bypassing the per-method cadence — pinned loops (the MPMD
        pipeline stage loop) call this at optimizer-step boundaries,
        where ``_maybe_save_actor_state``'s after-each-method trigger
        never fires.  Returns False when the actor has no save hook or
        no durable storage root is configured."""
        inst = self._actor_instance
        spec = self._actor_creation_spec
        if inst is None or not hasattr(inst, "__rt_save__") \
                or spec is None or not spec.actor_id:
            return False
        with self._actor_state_save_lock:
            self._push_worker_flags(saving=True)
            try:
                ckpt = self._actor_state_checkpoint(spec.actor_id)
                if ckpt is None:
                    return False
                ckpt.save(inst.__rt_save__())
            finally:
                self._push_worker_flags(saving=False)
        return True

    def _maybe_save_actor_state(self) -> None:
        """After a successful actor method: persist ``__rt_save__()``
        every ``actor_state_save_every_n`` completed calls."""
        inst = self._actor_instance
        if not hasattr(inst, "__rt_save__"):
            return
        spec = self._actor_creation_spec
        if spec is None or not spec.actor_id:
            return
        # cadence bump under a short lock; the (possibly slow) pickle +
        # write serializes on a SEPARATE lock so concurrent methods that
        # don't save this call never queue behind an in-flight snapshot
        with self._actor_state_lock:
            self._actor_calls_since_save += 1
            if self._actor_calls_since_save \
                    < max(1, int(config.actor_state_save_every_n)):
                return
            self._actor_calls_since_save = 0
        with self._actor_state_save_lock:
            # marked mid-save for the OOM watchdog: killing a worker
            # inside __rt_save__ risks a torn/partial snapshot, so the
            # victim policy takes it only as a last resort
            self._push_worker_flags(saving=True)
            try:
                ckpt = self._actor_state_checkpoint(spec.actor_id)
                if ckpt is not None:
                    ckpt.save(inst.__rt_save__())
            except Exception:
                traceback.print_exc()  # snapshot loss, not call failure
            finally:
                self._push_worker_flags(saving=False)

    def _push_worker_flags(self, pinned: Optional[bool] = None,
                           saving: Optional[bool] = None) -> None:
        """Best-effort OOM-policy flags to our node agent (worker mode
        only): pinned-loop and mid-__rt_save__ workers are last-resort
        watchdog victims."""
        if self.mode != MODE_WORKER:
            return
        try:
            self.agent.oneway("worker_flags", worker_id=self.worker_id,
                              pinned=pinned, saving=saving)
        except Exception:
            pass  # the agent may be restarting; flags are advisory

    def _stream_out(self, spec: TaskSpec, value: Any,
                    conn) -> Dict[str, Any]:
        """Drive a streaming generator task: report each yield to the
        owner over the task-push connection as it is produced (reference:
        _raylet.pyx:1104 execute_streaming_generator_sync/async +
        ReportGeneratorItemReturns).  Sync and async generators both
        work; async items are pulled on the shared async-exec loop."""
        import asyncio as _aio

        if hasattr(value, "__anext__"):
            agen = value

            def _items():
                while True:
                    try:
                        yield self._run_coroutine(agen.__anext__())
                    except StopAsyncIteration:
                        return
            items = _items()
        elif hasattr(value, "__next__"):
            items = value
        else:
            return self._error_reply(spec, TypeError(
                "num_returns='streaming' requires the task body to be a "
                f"generator (got {type(value).__name__})"), "")
        tid = TaskID.from_hex(spec.task_id)
        loop = self._loop()
        n = 0
        try:
            for item in items:
                oid = ObjectID.from_index(tid, n + 1).hex()
                with SerializationContext() as ctx:
                    frames, size = serialization.serialize(item)
                if ctx.refs:
                    # items containing ObjectRefs would need the
                    # nested-ref ack/pin protocol per item; unsupported —
                    # fail loudly instead of letting the inner objects be
                    # released while the consumer still holds the refs
                    raise TypeError(
                        "streamed items must not contain ObjectRefs; "
                        "yield values, not references")
                if size <= config.max_direct_call_object_size:
                    blob = bytearray(size)
                    serialization.pack_into(frames, memoryview(blob))
                    wire = {"v": bytes(blob)}
                else:
                    self.plasma.put_serialized(oid, frames, size,
                                               primary=True)
                    wire = {"stored": {"oid": oid,
                                       "node": list(self.agent_addr),
                                       "size": size}}
                if conn is not None:
                    # per-connection coalescing: items buffer locally
                    # and ride ONE "stream_items" frame per flush tick
                    # shared by every stream on this owner connection.
                    # Ordering vs the final reply is preserved by the
                    # flush-now below: the drain lands on the IO loop's
                    # FIFO ahead of the reply post (_post_exec_reply)
                    self._queue_stream_item(conn, {
                        "task_id": spec.task_id, "index": n,
                        "item": wire})
                n += 1
        except BaseException as e:
            if conn is not None:
                self._flush_stream_items_now(conn)
            reply = self._error_reply(spec, e, traceback.format_exc())
            reply["stream_len"] = n  # items before the break stay valid
            return reply
        if conn is not None:
            self._flush_stream_items_now(conn)
        return {"results": [], "stream_len": n}

    _STREAM_FLUSH_S = 0.002  # stream-item coalescing window

    def _queue_stream_item(self, conn, payload: Dict[str, Any]) -> None:
        """Buffer one stream item for its owner connection; the first
        item of a batch schedules the flush tick."""
        key = id(conn)
        with self._stream_out_lock:
            ent = self._stream_out_bufs.get(key)
            if ent is None:
                ent = self._stream_out_bufs[key] = (conn, [])
            ent[1].append(payload)
            first = len(ent[1]) == 1
        if first:
            self._post_to_loop(self._schedule_stream_flush, key)

    def _schedule_stream_flush(self, key: int) -> None:
        # IO loop: delay one tick so concurrent streams' items coalesce
        self._loop().call_later(self._STREAM_FLUSH_S,
                                self._flush_stream_items, key)

    def _flush_stream_items(self, key: int) -> None:
        # IO loop: one frame carries everything buffered for this conn
        import asyncio as _aio

        with self._stream_out_lock:
            ent = self._stream_out_bufs.pop(key, None)
        if ent is None:
            return  # a flush-now already drained it
        conn, items = ent
        _aio.ensure_future(conn.push("stream_items", {"items": items}))

    def _flush_stream_items_now(self, conn) -> None:
        """Drain pending items ahead of this stream's final reply (the
        reply post queues behind this on the same IO-loop FIFO)."""
        self._post_to_loop(self._flush_stream_items, id(conn))

    _async_exec_loop = None
    _async_exec_lock = threading.Lock()

    def _run_coroutine(self, coro):
        """Drive an async task/method on ONE persistent event loop
        shared by every exec thread (reference: async actors run all
        coroutines on a single loop).  That makes loop-bound resources
        (client sessions, asyncio.Lock/Queue) created in one call usable
        in later calls regardless of which exec thread serves them, and
        keeps background asyncio.create_task work running between calls
        — the loop never stops.  Exec threads block on the result, so
        max_concurrency calls still overlap their awaits."""
        with self._async_exec_lock:
            loop = type(self)._async_exec_loop
            if loop is None or loop.is_closed():
                loop = asyncio.new_event_loop()
                type(self)._async_exec_loop = loop
                threading.Thread(target=loop.run_forever,
                                 name="rt-async-exec", daemon=True).start()
        # carry this exec thread's task context into the coroutine: the
        # loop thread's threading.local is empty, which would make put()
        # mint colliding driver-derived ObjectIDs and suppress the
        # blocked-worker notification.  run_coroutine_threadsafe copies
        # the CALLING thread's contextvars into the new asyncio.Task, so
        # the shadow is isolated per call.
        token = _exec_ctx.set(_ExecShadow(self._exec_tls))
        try:
            fut = asyncio.run_coroutine_threadsafe(coro, loop)
        finally:
            _exec_ctx.reset(token)
        # registered for cancellation: cancelling this concurrent future
        # cancels the wrapped asyncio task (reference: async actor task
        # cancel via Task.cancel)
        task_id = self._exec.task_id
        self._async_running[task_id] = fut
        if task_id in self._cancelled_exec:
            # cancel landed between exec registration and here, when the
            # sync path couldn't reach the coroutine — cancel it now so
            # it doesn't run on as an orphan
            fut.cancel()
        try:
            return fut.result()
        finally:
            self._async_running.pop(task_id, None)

    def _materialize_args(self, spec: TaskSpec):
        """Deserialize inline args and batch-fetch ref args, preserving
        positional order."""
        slots: List[Tuple[Optional[str], Any]] = []
        collected: List[ObjectRef] = []
        ref_list: List[ObjectRef] = []
        ref_slots: List[int] = []
        for arg in spec.args:
            if arg.object_id is not None:
                ref = ObjectRef(arg.object_id, owner_addr=arg.owner_addr)
                ref_list.append(ref)
                ref_slots.append(len(slots))
                slots.append((arg.kw, None))
            else:
                with SerializationContext() as ctx:
                    val = serialization.deserialize(arg.value)
                collected.extend(ctx.refs)
                slots.append((arg.kw, val))
        if ref_list:
            values = self.get(ref_list)
            for si, v in zip(ref_slots, values):
                slots[si] = (slots[si][0], v)
            collected.extend(ref_list)
        self._register_foreign_refs(collected)
        args = [v for kw, v in slots if not kw]
        kwargs = {kw: v for kw, v in slots if kw}
        return args, kwargs, {r.oid for r in collected}

    def _success_reply(self, spec: TaskSpec, value: Any,
                       arg_ref_oids: Set[str]) -> Dict[str, Any]:
        if spec.num_returns == 0:
            values = []
        elif spec.num_returns == 1:
            values = [value]
        else:
            values = list(value)
            if len(values) != spec.num_returns:
                return self._error_reply(spec, ValueError(
                    f"task declared num_returns={spec.num_returns} but returned "
                    f"{len(values)} values"), "")
        results = []
        nested: Dict[str, List] = {}
        needs_ack = False
        held = []
        tid = TaskID.from_hex(spec.task_id)
        for i, v in enumerate(values):
            oid = ObjectID.from_index(tid, i + 1).hex()
            with SerializationContext() as ctx:
                frames, size = serialization.serialize(v)
            if ctx.refs:
                nested[oid] = [[r.oid, list(r.owner_addr) if r.owner_addr else None,
                                list(r.node_addr) if r.node_addr else None]
                               for r in ctx.refs]
                needs_ack = True
                held.append((v, list(ctx.refs)))
            if size <= config.max_direct_call_object_size:
                blob = bytearray(size)
                serialization.pack_into(frames, memoryview(blob))
                results.append({"v": bytes(blob)})
            else:
                self.plasma.put_serialized(oid, frames, size, primary=True)
                results.append({"stored": {"oid": oid,
                                           "node": list(self.agent_addr),
                                           "size": size}})
        borrows = [oid for oid in arg_ref_oids if self.rc.count(oid) > 0]
        reply: Dict[str, Any] = {"results": results}
        if borrows:
            reply["borrows"] = borrows
        if nested:
            reply["nested"] = nested
            reply["needs_ack"] = True
            self._pending_acks[spec.task_id] = held
            # this runs on a task-execution thread; asyncio loops only allow
            # timer scheduling from the loop thread itself
            loop = self._loop()
            loop.call_soon_threadsafe(
                loop.call_later, 60.0,
                lambda: self._pending_acks.pop(spec.task_id, None))
        return reply

    def _error_reply(self, spec: TaskSpec, exc: BaseException, tb: str) -> Dict[str, Any]:
        name = spec.name or spec.method_name or spec.function_id[:8]
        # this interpreter build's concurrent.futures.CancelledError is a
        # DISTINCT class from asyncio.CancelledError (verified; upstream
        # they alias) — both appear on the async cancel path
        if isinstance(exc, (TaskCancelledError, asyncio.CancelledError,
                            _futures_cancelled)):
            # cancellation is not a task failure: surface the dedicated
            # type, unwrapped (reference: TaskCancelledError from get)
            blob = cloudpickle.dumps(TaskCancelledError(
                str(exc) or f"task {name!r} was cancelled"))
            n = max(1, spec.num_returns)
            return {"results": [{"err": blob} for _ in range(n)],
                    "error": True, "error_str": "task cancelled"}
        try:
            wrapped = RayTaskError(name, tb, cause=exc)
            blob = cloudpickle.dumps(wrapped)
        except Exception:
            blob = cloudpickle.dumps(RayTaskError(name, tb))
        n = max(1, spec.num_returns)
        return {"results": [{"err": blob} for _ in range(n)],
                "error": True, "error_str": f"{type(exc).__name__}: {exc}"}
