"""Serve API: deployments, controller, handles, batching.

Reference mapping:
  - @deployment / .options / .bind  -> python/ray/serve/api.py:248
  - serve.run / delete / get_handle -> api.py:543, _private/api.py
  - ServeController (named actor)   -> _private/controller.py
  - DeploymentHandle + router       -> handle.py, _private/router.py
    (least-outstanding-requests among replicas = the pow-2 intent with
    exact local counts)
  - @serve.batch                    -> batching.py (replica-side dynamic
    batching; replicas run with max_concurrency > 1 so concurrent calls
    coalesce into one forward — the TPU-efficient shape)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

CONTROLLER_NAME = "_serve_controller"

# ----------------------------------------------------------------- batching

# Batch state lives ONLY in this per-process registry, never on the user's
# class or instance: a _BatchState holds threading locks, and anything
# reachable from the decorated class must stay cloudpickle-able (the
# deployment ships the class to replicas by value).  Keyed by
# (id(owner), key); a weakref finalizer evicts the entry when the owner is
# collected, so short-lived instances don't leak state and a recycled id()
# can't adopt a dead owner's batches.
_batch_states: Dict[Any, "_BatchState"] = {}
_batch_states_lock = threading.Lock()


def _batch_state_for(owner, key: str, max_batch_size: int,
                     wait_s: float) -> "_BatchState":
    import weakref

    regkey = (id(owner), key)
    with _batch_states_lock:
        state = _batch_states.get(regkey)
        if state is None:
            state = _BatchState(max_batch_size, wait_s)
            _batch_states[regkey] = state
            try:
                weakref.finalize(owner, _batch_states.pop, regkey, None)
            except TypeError:
                # owner not weakref-able (__slots__ without __weakref__):
                # pin it so its id() can't be recycled into this entry —
                # a process-lifetime leak is better than another
                # instance silently adopting this owner's queued batches
                state.owner_pin = owner
        return state


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Dynamic request batching for replica methods.

    Concurrent callers (replica threads) enqueue items; one caller
    becomes the flusher, invokes the wrapped function ONCE with the list
    of items, and distributes the per-item results.
    """

    def wrap(fn: Callable) -> Callable:
        cfg = (max_batch_size, batch_wait_timeout_s)
        state_key = f"_serve_batch_{getattr(fn, '__name__', 'fn')}"

        def wrapped(self_or_item, *maybe_item):
            # support methods (self, item) and free functions (item)
            if maybe_item:
                owner, item = self_or_item, maybe_item[0]
                call = lambda items: fn(owner, items)
            else:
                # free function: the wrapper itself anchors the state
                owner, item = wrapped, self_or_item
                call = fn
            state = _batch_state_for(owner, state_key, *cfg)
            return state.submit(item, call)

        wrapped.__name__ = getattr(fn, "__name__", "batched")
        wrapped._is_serve_batch = True
        return wrapped

    if _func is not None:
        return wrap(_func)
    return wrap


class _BatchState:
    def __init__(self, max_batch_size: int, wait_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.max = max_batch_size
        self.wait = wait_s
        self.clock = clock  # injectable for deterministic timer tests
        self.owner_pin = None  # set for non-weakref-able owners
        self.lock = threading.Lock()
        # submitters notify the parked flusher the moment the batch
        # fills — a full batch flushes immediately instead of being
        # rediscovered by a poll tick (was a 1ms sleep-poll loop: up to
        # 1ms added latency per batch and a busy core at high rates)
        self.full = threading.Condition(self.lock)
        self.items: List[Any] = []
        self.futures: List[Any] = []
        self.flusher_here = False

    def submit(self, item: Any, call: Callable[[List[Any]], List[Any]]):
        import concurrent.futures as cf

        fut: cf.Future = cf.Future()
        with self.lock:
            self.items.append(item)
            self.futures.append(fut)
            i_flush = not self.flusher_here
            if i_flush:
                self.flusher_here = True
            elif len(self.items) >= self.max:
                self.full.notify()  # wake the flusher: batch is full
        if not i_flush:
            return fut.result(timeout=120)
        # this caller is the flusher: drain every batch, then hand back
        try:
            while True:
                deadline = self.clock() + self.wait
                with self.lock:
                    while len(self.items) < self.max:
                        remaining = deadline - self.clock()
                        if remaining <= 0:
                            break
                        self.full.wait(remaining)
                    items = self.items[:self.max]
                    futures = self.futures[:self.max]
                    del self.items[:self.max]
                    del self.futures[:self.max]
                self._run_batch(call, items, futures)
                with self.lock:
                    if not self.items:
                        self.flusher_here = False
                        break
        except BaseException:
            with self.lock:
                self.flusher_here = False
            raise
        return fut.result(timeout=120)

    @staticmethod
    def _run_batch(call, items, futures):
        try:
            results = call(items)
            if len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function returned {len(results)} results "
                    f"for {len(items)} inputs")
            for f, r in zip(futures, results):
                f.set_result(r)
        except BaseException as e:
            for f in futures:
                if not f.done():
                    f.set_exception(e)


# -------------------------------------------------------------- deployment


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    # int, or "auto" — replica count then follows load between the
    # autoscaling_config's min/max bounds (reference: serve's
    # num_replicas="auto" + autoscaling_config)
    num_replicas: Any = 1
    max_ongoing_requests: int = 8
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    init_args: tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)
    # reference: _private/autoscaling_policy.py — replica count follows
    # reported ongoing requests: {"min_replicas", "max_replicas",
    # "target_ongoing_requests"}
    autoscaling_config: Optional[Dict[str, Any]] = None
    # LLM serving tier (serve/llm.py llm_deployment): replicas host a
    # continuous-batching engine and the controller installs a pinned
    # decode loop on each one
    llm: bool = False
    # ---- tail tolerance (per-deployment policy; see DeploymentHandle) ----
    # end-to-end budget for one request through this deployment: callers
    # (handle.call_async, the HTTP proxy) cap their wait AND stamp the
    # deadline into the replica task so the whole downstream tree
    # inherits it (an X-Request-Deadline-Ms header tightens it further)
    request_timeout_s: Optional[float] = None
    # hedging (IDEMPOTENT deployments only): a request still unanswered
    # after this delay fires a duplicate against a second replica —
    # first response wins, the loser is cancelled.  A float is a fixed
    # delay; "p99" tracks the handle's observed p99 latency.
    hedge_after_s: Any = None
    # the user's promise that duplicate execution is safe; hedging is
    # refused without it (a duplicate non-idempotent request could
    # double-apply side effects)
    idempotent: bool = False
    # LLM deployments only: run chunked prefill on this many dedicated
    # replicas (a sibling "<name>-prefill" pool); decode replicas attach
    # the shipped KV pages by request_id (serve/llm.py).  0 = colocated
    # prefill (the PR-11 behaviour).
    prefill_replicas: int = 0

    def options(self, **opts) -> "Deployment":
        d = Deployment(self.func_or_class, self.name, self.num_replicas,
                       self.max_ongoing_requests,
                       dict(self.ray_actor_options),
                       self.init_args, dict(self.init_kwargs),
                       dict(self.autoscaling_config)
                       if self.autoscaling_config else None,
                       self.llm, self.request_timeout_s,
                       self.hedge_after_s, self.idempotent,
                       self.prefill_replicas)
        for k, v in opts.items():
            setattr(d, k, v)
        return d

    def policy(self) -> Dict[str, Any]:
        """The wire form of the tail-tolerance policy (stored by the
        controller, learned by every handle via get_replicas)."""
        pol = {"request_timeout_s": self.request_timeout_s,
               "hedge_after_s": self.hedge_after_s,
               "idempotent": bool(self.idempotent)}
        if self.llm and self.prefill_replicas:
            pol["prefill_pool"] = f"{self.name}-prefill"
        return pol

    def bind(self, *args, **kwargs) -> "Application":
        d = self.options()
        d.init_args = args
        d.init_kwargs = kwargs
        return Application(d)


@dataclass
class Application:
    deployment: Deployment


def deployment(_cls: Any = None, *, name: Optional[str] = None,
               num_replicas: Any = 1, max_ongoing_requests: int = 8,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               request_timeout_s: Optional[float] = None,
               hedge_after_s: Any = None, idempotent: bool = False):
    def make(target):
        return Deployment(target, name or getattr(target, "__name__", "app"),
                          num_replicas, max_ongoing_requests,
                          ray_actor_options or {},
                          autoscaling_config=autoscaling_config,
                          request_timeout_s=request_timeout_s,
                          hedge_after_s=hedge_after_s,
                          idempotent=idempotent)

    if _cls is not None:
        return make(_cls)
    return make


class _Replica:
    """Actor wrapping the user callable (reference: _private/replica.py)."""

    def __init__(self, target_blob: bytes, init_args, init_kwargs):
        import cloudpickle

        target = cloudpickle.loads(target_blob)
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target

    def handle_request(self, method: str, args, kwargs):
        if method == "__call__":
            return self._callable(*args, **kwargs)
        return getattr(self._callable, method)(*args, **kwargs)

    def stream_request(self, method: str, args, kwargs):
        """Generator variant: the user callable must return/be a
        generator; each item streams to the caller as its own object
        (reference: _private/replica.py handle_request_streaming).
        Invoked with num_returns="streaming" by DeploymentHandle.stream."""
        out = self.handle_request(method, args, kwargs)
        if not hasattr(out, "__next__") and not hasattr(out, "__anext__"):
            raise TypeError(
                f"stream() requires {method!r} to return a generator; "
                f"got {type(out).__name__}")
        if hasattr(out, "__anext__"):
            raise TypeError("async generators are not supported through "
                            "serve stream(); use a sync generator")
        yield from out

    def health(self):
        return True

    def __getattr__(self, name):
        # stateful-restart hooks (worker.py __rt_save__/__rt_restore__)
        # delegate to the wrapped callable WHEN IT DEFINES THEM — via
        # __getattr__ so plain replicas still fail hasattr() and skip
        # the autosave machinery entirely
        if name in ("__rt_save__", "__rt_restore__") \
                and "_callable" in self.__dict__:
            return getattr(self.__dict__["_callable"], name)
        raise AttributeError(name)


class ServeController:
    """Named actor owning deployment state, with a background
    reconciliation loop that replaces dead replicas and autoscales on
    handle-reported load (reference: _private/controller.py,
    deployment_state.py:1226, autoscaling_policy.py)."""

    RECONCILE_PERIOD_S = 0.5
    CHECKPOINT_KEY = "serve:controller:checkpoint"

    def __init__(self):
        self.apps: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._ckpt_lock = threading.Lock()  # serializes checkpoint writes
        self._version_counter = 0  # monotonic across redeploys
        self._stop = threading.Event()
        recovered = False
        for _ in range(5):
            recovered = self._recover_from_checkpoint()
            if recovered:
                break
            time.sleep(1.0)
        if not recovered:
            # proceeding with empty state would let the next
            # _save_checkpoint clobber the intact checkpoint and leak
            # every replica it references — fail the actor instead so
            # creation retries with a fresh controller
            raise RuntimeError(
                "serve controller could not read its checkpoint")
        # only sweep when the checkpoint was read reliably: sweeping
        # after a failed read would kill every live replica the intact
        # checkpoint still references
        self._sweep_orphan_replicas()
        self._loop_thread = threading.Thread(
            target=self._reconcile_loop, name="serve-reconcile", daemon=True)
        self._loop_thread.start()

    # ---- fault tolerance ---------------------------------------------------
    # The controller checkpoints desired state to the internal KV and
    # reattaches its detached, named replicas on restart — killing the
    # controller loses no deployments (reference: _private/controller.py
    # checkpoints to the GCS KV; application_state recovers replica
    # actors by name).

    def _save_checkpoint(self) -> None:
        import cloudpickle

        from ray_tpu_torch.experimental import internal_kv

        # _ckpt_lock spans snapshot-build AND kv_put so concurrent saves
        # cannot write an older snapshot after a newer one
        with self._ckpt_lock:
            with self._lock:
                snap = {"version_counter": self._version_counter, "apps": {}}
                for name, app in self.apps.items():
                    snap["apps"][name] = {
                        "target_blob": app["target_blob"],
                        "init_args": app["init_args"],
                        "init_kwargs": app["init_kwargs"],
                        "actor_options": app["actor_options"],
                        "max_ongoing": app["max_ongoing"],
                        "autoscaling": app["autoscaling"],
                        "llm": app.get("llm", False),
                        "policy": app.get("policy") or {},
                        "desired": app["desired"],
                        "version": app["version"],
                        "replica_names": list(
                            app.get("replica_names", {}).values()),
                    }
            try:
                internal_kv.kv_put(self.CHECKPOINT_KEY, cloudpickle.dumps(snap))
            except Exception:
                pass  # head briefly unreachable: next mutation re-saves

    def _recover_from_checkpoint(self) -> bool:
        """Returns True when the checkpoint state is reliably known
        (loaded, or confirmed absent).  False means the read failed —
        callers must NOT treat live replicas as orphans in that case."""
        import cloudpickle

        import ray_tpu_torch
        from ray_tpu_torch.experimental import internal_kv

        try:
            raw = internal_kv.kv_get(self.CHECKPOINT_KEY)
        except Exception:
            return False  # head unreachable: checkpoint state unknown
        if not raw:
            return True  # confirmed: no checkpoint exists
        try:
            snap = cloudpickle.loads(raw)
        except Exception:
            return False  # corrupt read: do not sweep on this basis
        self._version_counter = snap.get("version_counter", 0)
        for name, spec in snap.get("apps", {}).items():
            replicas = []
            replica_names = {}
            for rname in spec.get("replica_names", []):
                try:
                    h = ray_tpu_torch.get_actor(rname)
                    replicas.append(h)
                    replica_names[h._actor_id] = rname
                except Exception:
                    continue  # replica died with the outage: healed below
            self.apps[name] = {
                "target_blob": spec["target_blob"],
                "init_args": spec["init_args"],
                "init_kwargs": spec["init_kwargs"],
                "actor_options": spec["actor_options"],
                "max_ongoing": spec["max_ongoing"],
                "autoscaling": spec["autoscaling"],
                "llm": spec.get("llm", False),
                "policy": spec.get("policy") or {},
                "desired": spec["desired"],
                "replicas": replicas,
                "replica_names": replica_names,
                "version": spec["version"],
                "ongoing": {},
            }
        return True

    def _sweep_orphan_replicas(self) -> None:
        """Kill live 'serve:*' replica actors no checkpoint references:
        a controller that died mid-deploy (replicas are detached and
        started BEFORE the post-health-check checkpoint) leaves them
        running with no owner record."""
        import ray_tpu_torch

        known = set()
        with self._lock:
            for app in self.apps.values():
                known.update(app.get("replica_names", {}).values())
        try:
            actors = ray_tpu_torch.api._worker().head.call("list_actors",
                                                     timeout=10)["actors"]
        except Exception:
            return
        for a in actors:
            name = a.get("name", "")
            if (name.startswith("serve:") and name not in known
                    and a.get("state") in ("ALIVE", "PENDING", "RESTARTING")):
                try:
                    h = ray_tpu_torch.get_actor(name)
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass

    # ---- desired state -----------------------------------------------------

    def deploy(self, name: str, target_blob: bytes, num_replicas: int,
               max_ongoing: int, init_args, init_kwargs,
               actor_options: Dict[str, Any],
               autoscaling: Optional[Dict[str, Any]] = None,
               health_timeout: Optional[float] = None,
               llm: bool = False,
               policy: Optional[Dict[str, Any]] = None):
        import ray_tpu_torch

        if autoscaling:
            num_replicas = max(num_replicas,
                               int(autoscaling.get("min_replicas", 1)))
        app = {
            "target_blob": target_blob,
            "init_args": init_args,
            "init_kwargs": init_kwargs,
            "actor_options": actor_options,
            "max_ongoing": max_ongoing,
            "autoscaling": autoscaling,
            "llm": llm,
            "policy": dict(policy or {}),
            "desired": num_replicas,
            "replicas": [],
            "replica_names": {},  # actor_id -> detached actor name
            "version": 0,
            "ongoing": {},   # handle_id -> (reported count, timestamp)
        }
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch._private.errors import (DeploymentFailedError,
                                             GetTimeoutError)

        # blue-green: bring the new replicas up FIRST; a failing redeploy
        # must not take down a working deployment
        replicas = [self._start_replica(app, name)
                    for _ in range(num_replicas)]
        # the caller's (driver's) config wins: the controller process may
        # have been spawned before the driver set the knob
        if health_timeout is None:
            health_timeout = float(config.serve_replica_health_timeout_s)
        try:
            # block until every replica's constructor finished (model
            # loaded); bounded so ONE wedged replica can't stall the
            # deploy indefinitely (was a hardcoded 600s)
            ray_tpu_torch.get([r.health.remote() for r in replicas],
                        timeout=health_timeout)
        except ray_tpu_torch.RayError as e:
            for r in replicas:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
            if isinstance(e, GetTimeoutError):
                raise DeploymentFailedError(
                    f"deployment {name!r}: replicas did not pass the "
                    f"health check within serve_replica_health_timeout_s="
                    f"{health_timeout:g}s") from e
            raise
        app["replicas"] = replicas
        with self._lock:
            self._version_counter += 1
            app["version"] = self._version_counter
            existing = self.apps.get(name)
            self.apps[name] = app
        if existing:
            for h in existing["replicas"]:
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass
        self._save_checkpoint()
        return True

    def _start_replica(self, app, dep_name: str):
        import uuid

        import ray_tpu_torch

        # detached + named: replicas survive a controller crash and are
        # reattached from the checkpoint by name.  LLM replicas get two
        # extra exec threads: one is permanently pinned by the decode
        # loop, one keeps control methods (stats/health) responsive
        # when every other thread sits in a streaming request
        rname = f"serve:{dep_name}:{uuid.uuid4().hex[:8]}"
        cls = ray_tpu_torch.remote(_Replica).options(
            max_concurrency=max(2, app["max_ongoing"])
            + (2 if app.get("llm") else 0),
            name=rname, lifetime="detached",
            **app["actor_options"])
        h = cls.remote(app["target_blob"], app["init_args"],
                       app["init_kwargs"])
        with self._lock:  # _save_checkpoint iterates this under the lock
            app["replica_names"][h._actor_id] = rname
        self._ensure_llm_loop(app, h)
        return h

    def _ensure_llm_loop(self, app, replica) -> None:
        """Install the pinned continuous-batching decode loop on an LLM
        replica (worker-side dispatch: __rt_dag_llm_loop__, serve/llm.py
        run_llm_loop).  Idempotent — the engine's run_loop is
        single-flight, so re-ensuring after a controller restart (which
        loses the in-memory loop_refs) is safe."""
        if not app.get("llm"):
            return
        try:
            from ray_tpu_torch import api as _rapi
            from ray_tpu_torch._private.worker import LLM_EXEC_METHOD

            w = _rapi._worker()
            ref = w.submit_actor_task(
                replica._actor_id, LLM_EXEC_METHOD, (), {})[0]
            with self._lock:
                # the ref pins the loop task owner-side; reconcile uses
                # the key set to avoid re-submitting every round
                app.setdefault("loop_refs", {})[replica._actor_id] = ref
        except Exception:
            pass  # replica mid-create or unreachable: reconcile retries

    # ---- reconciliation ----------------------------------------------------

    def _reconcile_loop(self):
        import ray_tpu_torch
        from ray_tpu_torch._private import tracing

        # suppressed: health probes + replacement churn would otherwise
        # mint a root trace every period and evict real traces from the
        # head's bounded store
        with tracing.suppressed():
            while not self._stop.wait(self.RECONCILE_PERIOD_S):
                with self._lock:
                    apps = dict(self.apps)
                for name, app in apps.items():
                    try:
                        self._reconcile_one(ray_tpu_torch, name, app)
                    except Exception:
                        pass  # never let one deployment wedge the loop
                try:
                    self._refresh_replica_nodes()
                except Exception:
                    pass

    def _reconcile_one(self, ray_tpu_torch, name: str, app: Dict[str, Any]):
        # 0. llm decode loops: replicas recovered from a checkpoint (the
        # in-memory loop_refs died with the old controller) get their
        # loop re-ensured once — harmless on running loops.  Every few
        # seconds ALSO ask each replica whether its loop is still
        # running: a loop task that died (engine error, install push
        # cancelled by a controller-connection drop) would otherwise
        # leave a black-hole replica that admits sequences nothing
        # steps — re-ensuring is idempotent (engine-side single-flight)
        if app.get("llm"):
            with self._lock:
                missing = [r for r in app["replicas"]
                           if r._actor_id not in app.get("loop_refs", {})]
            for r in missing:
                self._ensure_llm_loop(app, r)
            now0 = time.monotonic()
            if now0 >= app.get("next_loop_check", 0.0):
                app["next_loop_check"] = now0 + 3.0
                # submit all probes first so the 5s timeouts overlap —
                # one wedged replica must not stall the round 5s per
                # replica (same pattern as the health pass below)
                checks = [(r, r.handle_request.remote("stats", (), {}))
                          for r in app["replicas"]]
                for r, ref in checks:
                    try:
                        st = ray_tpu_torch.get(ref, timeout=5)
                        if not st.get("loop_running"):
                            with self._lock:
                                app.get("loop_refs", {}).pop(
                                    r._actor_id, None)
                            self._ensure_llm_loop(app, r)
                        # engine backlog feeds the replica autoscaler:
                        # queued sequences mean token-boundary admission
                        # is falling behind this replica's decode loop
                        app.setdefault("replica_queue", {})[
                            r._actor_id] = int(st.get("queued", 0))
                    except ray_tpu_torch.RayError:
                        app.setdefault("replica_queue", {}).pop(
                            r._actor_id, None)
        # 1. health: drop replicas that fail a health probe.  Definitive
        # death (ActorDied/worker gone) drops immediately; a TIMEOUT
        # alone needs consecutive misses — a replica paying a long jit
        # compile or a GIL-heavy stretch (an LLM replica's first
        # forward) must not be executed for being slow once, which
        # previously aborted it MID-COMPILE and churned replacements
        from ray_tpu_torch._private.errors import GetTimeoutError

        alive = []
        changed = False
        misses = app.setdefault("health_misses", {})
        probes = [(r, r.health.remote()) for r in app["replicas"]]
        for r, probe in probes:
            try:
                ray_tpu_torch.get(probe, timeout=5)
                alive.append(r)
                misses.pop(r._actor_id, None)
                continue
            except GetTimeoutError:
                misses[r._actor_id] = misses.get(r._actor_id, 0) + 1
                if misses[r._actor_id] < 3:
                    alive.append(r)  # grace: still routed, watched
                    continue
            except ray_tpu_torch.RayError:
                pass  # dead for real: replace now
            changed = True
            misses.pop(r._actor_id, None)
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        # 2. autoscaling: replica count follows load signals with
        # hysteresis (see _autoscale_desired)
        desired = self._autoscale_desired(app, len(alive))
        # 3. converge replica count; scale-down victims drain first (they
        # leave the routing table now, die a few seconds later so
        # in-flight requests finish)
        now = time.monotonic()
        while len(alive) > desired:
            victim = alive.pop()
            changed = True
            app.setdefault("draining", []).append((victim, now + 5.0))
        still_draining = []
        for victim, kill_at in app.get("draining", []):
            if now >= kill_at:
                try:
                    ray_tpu_torch.kill(victim)
                except Exception:
                    pass
            else:
                still_draining.append((victim, kill_at))
        app["draining"] = still_draining
        started = []
        while len(alive) + len(started) < desired:
            started.append(self._start_replica(app, name))
            changed = True
        for r in started:
            try:
                # bounded so one stuck constructor can't freeze recovery
                # for every other deployment; retried next round if slow
                ray_tpu_torch.get(r.health.remote(), timeout=30)
                alive.append(r)
            except ray_tpu_torch.RayError:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
        # prune stale handle reports so 'ongoing' doesn't grow unboundedly
        with self._lock:
            app["ongoing"] = {h: (c, ts) for h, (c, ts) in
                              app["ongoing"].items() if now - ts < 10.0}
            app["sheds"] = {h: (c, ts) for h, (c, ts) in
                            app.get("sheds", {}).items() if now - ts < 10.0}
        if changed:
            with self._lock:
                current = self.apps.get(name) is app
                if current:
                    app["replicas"] = alive
                    live_ids = {r._actor_id for r in alive} | {
                        v._actor_id for v, _ in app.get("draining", [])}
                    app["replica_names"] = {
                        aid: rn for aid, rn in app["replica_names"].items()
                        if aid in live_ids}
                    app["loop_refs"] = {
                        aid: ref for aid, ref in
                        app.get("loop_refs", {}).items() if aid in live_ids}
                    app["replica_queue"] = {
                        aid: q for aid, q in
                        app.get("replica_queue", {}).items()
                        if aid in live_ids}
                    app["health_misses"] = {
                        aid: n for aid, n in
                        app.get("health_misses", {}).items()
                        if aid in live_ids}
                    self._version_counter += 1
                    app["version"] = self._version_counter
            if not current:
                # app was redeployed/deleted mid-round: replicas started
                # this round would otherwise leak
                for r in started:
                    try:
                        ray_tpu_torch.kill(r)
                    except Exception:
                        pass
            else:
                self._save_checkpoint()

    def _autoscale_desired(self, app: Dict[str, Any],
                           alive_count: int) -> int:
        """One autoscaling decision for one deployment.

        Signals (reference: autoscaling_policy.py, extended for the LLM
        tier): windowed handle-reported ongoing requests, replica-side
        engine queue depth (the stats probe above — sequences parked at
        token-boundary admission), and handle-reported 503 sheds (a
        shed means capacity is short RIGHT NOW: desired jumps past the
        current count instead of waiting for averages to catch up).

        Hysteresis: an upscale needs the computed desired above the
        current one for ``serve_autoscale_up_consecutive`` consecutive
        reconcile rounds; a downscale needs it below for
        ``serve_autoscale_down_delay_s`` — one burst neither thrashes
        replicas up nor tears warm replicas down the moment it ends."""
        auto = app.get("autoscaling")
        if not auto:
            return app["desired"]
        import math

        from ray_tpu_torch._private.config import config as _cfg

        now = time.monotonic()
        with self._lock:
            reports = list(app["ongoing"].values())
            shed_reports = list(app.get("sheds", {}).values())
        total = sum(c for c, ts in reports if now - ts < 5.0)
        recent_sheds = sum(c for c, ts in shed_reports if now - ts < 5.0)
        queued = sum(app.get("replica_queue", {}).values())
        target = max(1, int(auto.get(
            "target_ongoing_requests",
            _cfg.serve_autoscale_target_ongoing)))
        want = math.ceil((total + queued) / target)
        if recent_sheds:
            want = max(want, alive_count + 1)
        lo = int(auto.get("min_replicas",
                          _cfg.serve_autoscale_min_replicas))
        hi = int(auto.get("max_replicas",
                          _cfg.serve_autoscale_max_replicas))
        want = min(hi, max(lo, want))
        cur = app["desired"]
        up_needed = max(1, int(auto.get(
            "upscale_consecutive", _cfg.serve_autoscale_up_consecutive)))
        down_delay = float(auto.get("downscale_delay_s",
                                    _cfg.serve_autoscale_down_delay_s))
        if want > cur:
            app["up_streak"] = app.get("up_streak", 0) + 1
            app["below_since"] = None
            if app["up_streak"] >= up_needed:
                app["desired"] = want
                app["up_streak"] = 0
        elif want < cur:
            app["up_streak"] = 0
            t0 = app.get("below_since")
            if t0 is None:
                app["below_since"] = now
            elif now - t0 >= down_delay:
                app["desired"] = want
                app["below_since"] = None
        else:
            app["up_streak"] = 0
            app["below_since"] = None
        app["last_autoscale"] = {
            "want": want, "ongoing": total, "queued": queued,
            "sheds": recent_sheds, "desired": app["desired"]}
        return app["desired"]

    def autoscale_status(self, name: str):
        """Debuggability: the last autoscale inputs/decision for one
        deployment (surfaced by tests and `rtpu status`-adjacent
        tooling)."""
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return None
            return {"desired": app["desired"],
                    "replicas": len(app["replicas"]),
                    "autoscaling": dict(app.get("autoscaling") or {}),
                    "last": dict(app.get("last_autoscale") or {})}

    # ---- handle-facing RPCs ------------------------------------------------

    def get_replicas(self, name: str, known_version: int = -1):
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return None
            if known_version == app["version"]:
                return {"version": app["version"], "unchanged": True}
            ids = [r._actor_id for r in app["replicas"]]
            nodes = app.get("replica_nodes", {})
            return {"version": app["version"],
                    "replica_ids": ids,
                    "replica_nodes": [nodes.get(i, "") for i in ids],
                    "max_ongoing": app["max_ongoing"],
                    "policy": app.get("policy") or {}}

    def _refresh_replica_nodes(self) -> None:
        """Map replica actor ids to their nodes (for locality-aware
        routing; reference: pow_2_scheduler.py prefers same-node
        replicas)."""
        import ray_tpu_torch

        with self._lock:
            if not self.apps:
                return  # idle controller: skip the cluster-wide RPC
        try:
            actors = ray_tpu_torch.api._worker().head.call("list_actors",
                                                     timeout=10)["actors"]
        except Exception:
            return
        node_of = {a["actor_id"]: a.get("node_id", "") for a in actors}
        with self._lock:
            for app in self.apps.values():
                app["replica_nodes"] = {
                    r._actor_id: node_of.get(r._actor_id, "")
                    for r in app["replicas"]}

    def report_metrics(self, name: str, handle_id: str, ongoing: int,
                       sheds: int = 0):
        with self._lock:
            app = self.apps.get(name)
            if app is not None:
                now = time.monotonic()
                app["ongoing"][handle_id] = (ongoing, now)
                if sheds:
                    app.setdefault("sheds", {})[handle_id] = (sheds, now)
        return True

    def delete(self, name: str):
        import ray_tpu_torch

        with self._lock:
            app = self.apps.pop(name, None)
        if app:
            victims = list(app["replicas"]) + [
                v for v, _ in app.get("draining", [])]
            for h in victims:
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass
            self._save_checkpoint()
        return True

    def list_deployments(self):
        with self._lock:
            return {name: len(app["replicas"])
                    for name, app in self.apps.items()}


# ------------------------------------------------------------------ handle


class _SharedWaiter:
    """One background thread per process that watches in-flight serve
    refs and fires completion callbacks — replaces the former
    thread-per-request watcher."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: Dict[str, Callable[[], None]] = {}  # oid -> cb
        self._refs: Dict[str, Any] = {}
        # streaming calls: task_id -> (ObjectRefGenerator, cb); fired
        # when the underlying generator TASK completes/errors, which is
        # what keeps inflight accounting honest for streams the consumer
        # abandons without ever iterating
        self._gens: Dict[str, Any] = {}
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _start_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="serve-waiter", daemon=True)
            self._thread.start()

    def watch(self, ref, cb: Callable[[], None]) -> None:
        with self._lock:
            self._items[ref.oid] = cb
            self._refs[ref.oid] = ref
            self._start_locked()
        self._wake.set()

    def watch_gen(self, gen, cb: Callable[[], None]) -> None:
        """Fire ``cb`` once the streaming generator's replica-side task
        has finished producing (completed OR errored) — independent of
        whether any consumer ever iterates the stream."""
        with self._lock:
            self._gens[gen.task_id] = (gen, cb)
            self._start_locked()
        self._wake.set()

    def _check_gens(self) -> None:
        with self._lock:
            gens = list(self._gens.items())
        for tid, (gen, cb) in gens:
            try:
                done = gen.completed()
            except Exception:
                done = True  # runtime gone: release rather than leak
            if not done:
                continue
            with self._lock:
                if self._gens.pop(tid, None) is None:
                    continue
            try:
                cb()
            except Exception:
                pass

    def _run(self):
        import ray_tpu_torch

        idle_rounds = 0
        err_rounds = 0
        while True:
            self._check_gens()
            with self._lock:
                refs = list(self._refs.values())
                if not refs and not self._gens and idle_rounds >= 100:
                    # retire under the lock so a concurrent watch() either
                    # sees a dead thread (and restarts one) or we see its ref
                    self._thread = None
                    return
                busy = bool(refs or self._gens)
            if busy:
                idle_rounds = 0
            if not refs:
                self._wake.wait(0.1)
                self._wake.clear()
                idle_rounds += 1
                continue
            try:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.2)
                err_rounds = 0
            except Exception:
                # transient runtime trouble must not fire callbacks for
                # still-running requests; drain only if it persists
                # (runtime torn down)
                err_rounds += 1
                if err_rounds < 50:
                    time.sleep(0.1)
                    continue
                ready = refs
            for r in ready:
                with self._lock:
                    cb = self._items.pop(r.oid, None)
                    self._refs.pop(r.oid, None)
                if cb is not None:
                    try:
                        cb()
                    except Exception:
                        pass


_shared_waiter = _SharedWaiter()


def _abandon_stream(gen) -> None:
    """A stream consumer stopped before exhaustion (client disconnect,
    early break, GC of the wrapper): cancel the replica-side generator
    so it stops producing — an abandoned LLM decode must free its KV
    pages, not generate to max_seq_len for nobody.  No-op for streams
    whose producer already finished."""
    try:
        if not gen.completed():
            gen.cancel()
    except Exception:
        pass


def _watch_ref_done(ref, cb) -> None:
    """Fire ``cb`` once `ref` resolves (value OR error), releasing a
    handle's inflight charge.

    Fast path for refs owned by this process (every handle call — the
    submit happens locally): ONE memory-store waiter, fired on the IO
    thread at resolution, O(1) per request.  The closure pins the ref so
    the entry cannot be evicted (and the callback lost) if the caller
    abandons the ref mid-flight.  The shared waiter's wait()-polling
    loop — which re-registers EVERY in-flight ref on each round and eats
    the GIL under high concurrency — is kept only as the fallback for
    refs owned elsewhere."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if (w is not None and ref.owner_addr is not None
            and tuple(ref.owner_addr) == w.address):
        pin = [ref]

        def _fire():
            pin.clear()
            cb()

        if w.memory.add_waiter(ref.oid, _fire) is None:
            cb()  # already resolved
        return
    _shared_waiter.watch(ref, cb)


class _MetricsPusher:
    """ONE daemon thread pushing windowed-average ongoing requests for
    every live handle (reference: serve/_private/metrics_utils.py
    MetricsPusher).  Sampling on a clock — instead of piggybacking point
    reads on submit — keeps autoscaling correct when request completion
    is phase-aligned with submission bursts.  Handles are held by
    weakref: an abandoned handle (proxy re-creates them on RayError)
    simply drops out, so no thread or GC pin leaks with handle churn."""

    SAMPLE_PERIOD_S = 0.1
    PUSH_PERIOD_S = 0.5
    WINDOW = 20  # samples (~2 s)

    def __init__(self):
        self._lock = threading.Lock()
        self._handles: List[Any] = []  # weakref.ref[DeploymentHandle]
        self._thread: Optional[threading.Thread] = None

    def register(self, handle) -> None:
        import weakref

        with self._lock:
            self._handles.append(weakref.ref(handle))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="serve-metrics", daemon=True)
                self._thread.start()

    def _run(self):
        from ray_tpu_torch._private import tracing

        with tracing.suppressed():  # metric pushes are not user traffic
            while True:
                time.sleep(self.SAMPLE_PERIOD_S)
                with self._lock:
                    live = [(r, h) for r in self._handles
                            if (h := r()) is not None]
                    self._handles = [r for r, _ in live]
                    if not live:
                        self._thread = None  # retire; register() restarts
                        return
                now = time.monotonic()
                for _, h in live:
                    try:
                        self._sample_and_push(h, now)
                    except Exception:
                        pass  # runtime down or controller restarting

    def _sample_and_push(self, h, now: float) -> None:
        with h._lock:
            h._samples.append(sum(h._inflight.values()))
            if len(h._samples) > self.WINDOW:
                h._samples = h._samples[-self.WINDOW:]
            avg = sum(h._samples) / len(h._samples)
        if now - h._last_push < self.PUSH_PERIOD_S:
            return
        h._last_push = now
        with h._lock:
            sheds, h._sheds_pending = h._sheds_pending, 0
        ctrl = _controller()
        ctrl.report_metrics.remote(h._name, h._handle_id, int(round(avg)),
                                   sheds)


_metrics_pusher = _MetricsPusher()


class ReplicaCircuit:
    """Per-replica circuit breaker (reference intent: the router's
    replica health gating; the mechanism is the classic three-state
    breaker).  Failures AND hedge-slow events feed one time-decayed
    score; crossing ``fail_threshold`` opens the circuit and the
    replica leaves routing immediately — a gray (slow-not-dead) replica
    is evicted within a few hedge delays instead of waiting out 3
    health-probe periods.  After ``cooldown_s`` the breaker goes
    half-open: exactly ONE probe request is let through; its success
    closes the breaker, its failure re-opens it.

    The clock is injectable so the state machine unit-tests run
    sleep-free."""

    __slots__ = ("fail_threshold", "decay_s", "cooldown_s", "clock",
                 "score", "scored_at", "state", "opened_at", "probing",
                 "probe_since")

    def __init__(self, fail_threshold: Optional[float] = None,
                 decay_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ray_tpu_torch._private.config import config

        self.fail_threshold = float(
            fail_threshold if fail_threshold is not None
            else config.serve_circuit_fail_threshold)
        self.decay_s = float(decay_s if decay_s is not None
                             else config.serve_circuit_decay_s)
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else config.serve_circuit_cooldown_s)
        self.clock = clock
        self.score = 0.0
        self.scored_at = self.clock()
        self.state = "closed"
        self.opened_at = 0.0
        self.probing = False
        self.probe_since = 0.0

    def _decayed(self, now: float) -> float:
        # exponential half-life decay: one old burst of failures stops
        # mattering within a few decay windows with no bookkeeping
        age = max(0.0, now - self.scored_at)
        return self.score * (0.5 ** (age / self.decay_s))

    def record_failure(self, weight: float = 1.0) -> bool:
        """An error, timeout, or hedge-slow event against this replica.
        Returns True when this event OPENED the circuit (callers count
        ray_tpu_serve_circuit_open_total on the transition)."""
        now = self.clock()
        self.score = self._decayed(now) + weight
        self.scored_at = now
        if self.state == "half_open":
            # the probe failed: straight back to open, fresh cooldown
            self.state = "open"
            self.opened_at = now
            self.probing = False
            return False
        if self.state == "closed" and self.score >= self.fail_threshold:
            self.state = "open"
            self.opened_at = now
            self.probing = False
            return True
        return False

    def record_success(self) -> None:
        now = self.clock()
        if self.state == "half_open":
            self.state = "closed"
            self.score = 0.0
            self.scored_at = now
            self.probing = False
            return
        # successes actively pay DOWN the score (on top of time decay):
        # a mostly-healthy replica serving real traffic can never
        # accumulate its way to the threshold from the tail-rate slow
        # events p99 hedging produces by construction — only a replica
        # whose failures/slowness OUTPACE its successes opens
        self.score = max(0.0, self._decayed(now) - 0.5)
        self.scored_at = now

    def routable(self) -> bool:
        """May a request be routed to this replica right now?  Open →
        no; past the cooldown the breaker turns half-open and admits
        requests only while no probe is in flight.  Non-consuming: the
        picker calls ``note_picked`` on the replica it actually chose."""
        if self.state == "closed":
            return True
        now = self.clock()
        if self.state == "open":
            if now - self.opened_at < self.cooldown_s:
                return False
            self.state = "half_open"
            self.probing = False
        if self.probing and self.probe_since \
                and now - self.probe_since > max(2 * self.cooldown_s, 5.0):
            # stale probe: its outcome was never recorded (the probe
            # request was a stream, or a cancelled hedge loser) — a
            # lost probe must not wedge the replica out of routing
            # forever
            self.probing = False
        return not self.probing

    def note_picked(self) -> None:
        """The router chose this replica; a half-open breaker marks its
        single probe in flight (cleared by the probe's outcome, or by
        the stale-probe expiry in ``routable``)."""
        if self.state == "half_open":
            self.probing = True
            self.probe_since = self.clock()

    def allow(self) -> bool:
        """Convenience for tests/direct users: routable-and-picked in
        one step (exactly one half-open probe gets True)."""
        if not self.routable():
            return False
        self.note_picked()
        return True


class DeploymentHandle:
    """Client-side router: least-outstanding-requests replica choice
    (reference: router.py assign_request + pow_2_scheduler.py), with
    periodic replica-list refresh from the controller and load reporting
    for autoscaling."""

    REFRESH_PERIOD_S = 1.0

    def __init__(self, name: str, replica_ids: List[str], version: int = 0,
                 replica_nodes: Optional[List[str]] = None,
                 max_ongoing: int = 8,
                 policy: Optional[Dict[str, Any]] = None):
        import uuid
        from collections import deque

        from ray_tpu_torch._private.worker import global_worker_or_none

        self._name = name
        self._handle_id = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._version = version
        self._max_ongoing = max_ongoing
        # tail-tolerance policy (Deployment.policy(): request_timeout_s,
        # hedge_after_s | "p99", idempotent) — learned from the
        # controller, refreshed with the roster
        self._policy: Dict[str, Any] = dict(policy or {})
        # per-replica circuit breakers + a windowed latency sample ring
        # (the hedge_after="p99" source; the computed p99 is cached and
        # refreshed every ~20 samples — sorting 200 floats under the
        # handle lock per request would be hot-path waste)
        self._circuits: Dict[str, ReplicaCircuit] = {}
        self._latencies: "deque" = deque(maxlen=200)
        self._lat_version = 0
        self._p99_cache: Optional[tuple] = None  # (version, value)
        w = global_worker_or_none()
        self._my_node = w.node_id if w is not None else ""
        self._set_replicas(replica_ids, replica_nodes)
        self._last_refresh = time.monotonic()
        self._samples: List[int] = []  # recent inflight samples (window)
        self._last_push = 0.0
        # 503s observed against this deployment (proxy gate or replica
        # admission), drained to the controller with each metrics push —
        # the replica autoscaler's immediate scale-up trigger
        self._sheds_pending = 0
        # lazily-built handle to the sibling "<name>-prefill" pool
        # (disaggregated prefill; see _maybe_prefill)
        self._prefill_handle: Optional["DeploymentHandle"] = None
        _metrics_pusher.register(self)

    def note_shed(self) -> None:
        with self._lock:
            self._sheds_pending += 1

    # ---- tail tolerance ---------------------------------------------------

    def _circuit(self, rid: str) -> ReplicaCircuit:
        c = self._circuits.get(rid)
        if c is None:
            c = self._circuits.setdefault(rid, ReplicaCircuit())
        return c

    def _record_outcome(self, rid: str, latency_s: Optional[float] = None,
                        error: bool = False, slow: bool = False) -> None:
        """Feed one request outcome into the replica's breaker (and the
        handle's latency window).  A breaker OPEN transition counts in
        ray_tpu_serve_circuit_open_total — the moment a gray replica
        leaves routing."""
        c = self._circuit(rid)
        if error or slow:
            if c.record_failure():
                try:
                    from ray_tpu_torch._private.metrics import serve_tail_metrics

                    serve_tail_metrics()[1].inc(
                        tags={"deployment": self._name})
                except Exception:
                    pass
        else:
            c.record_success()
            if latency_s is not None:
                with self._lock:
                    self._latencies.append(latency_s)
                    self._lat_version += 1

    def _hedge_delay(self) -> Optional[float]:
        """Seconds to wait before firing a duplicate request, or None
        when hedging is off for this deployment.  Hedging requires the
        deployment to be declared idempotent — a duplicate of a
        non-idempotent request could double-apply side effects."""
        pol = self._policy
        h = pol.get("hedge_after_s")
        if h is None or not pol.get("idempotent"):
            return None
        if isinstance(h, (int, float)):
            return max(0.0, float(h))
        # "p99": track the observed distribution; until enough samples
        # exist, hedge at the configured floor
        from ray_tpu_torch._private.config import config

        floor = float(config.serve_hedge_min_delay_s)
        with self._lock:
            cached = self._p99_cache
            if cached is not None and self._lat_version - cached[0] < 20:
                return max(floor, cached[1])
            samples = sorted(self._latencies)
            if len(samples) < 10:
                return floor
            p99 = samples[min(len(samples) - 1,
                              int(0.99 * len(samples)))]
            self._p99_cache = (self._lat_version, p99)
        return max(floor, p99)

    def _set_replicas(self, replica_ids: List[str],
                      replica_nodes: Optional[List[str]] = None):
        from ray_tpu_torch.api import ActorHandle

        self._replicas = [ActorHandle(rid) for rid in replica_ids]
        self._replica_nodes = dict(zip(replica_ids, replica_nodes or []))
        # inflight is keyed by actor id so counts survive replica-list
        # swaps: late completion callbacks decrement the right counter
        # instead of corrupting a rebuilt positional array
        old = getattr(self, "_inflight", {})
        self._inflight = {rid: old.get(rid, 0) for rid in replica_ids}
        # breakers for replicas no longer in the roster are dropped (a
        # replaced replica's id never comes back)
        self._circuits = {rid: c for rid, c in self._circuits.items()
                          if rid in self._inflight}

    def _maybe_refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < self.REFRESH_PERIOD_S:
            return
        import ray_tpu_torch

        self._last_refresh = now
        try:
            ctrl = _controller()
            # an empty local roster (every cached replica was dropped as
            # dead) asks for the FULL roster: sending our version would
            # get "unchanged" back and leave the handle empty forever
            known = self._version if self._replicas else -1
            info = ray_tpu_torch.get(
                ctrl.get_replicas.remote(self._name, known),
                timeout=30)
        except Exception:
            # refresh is best-effort: during a controller restart the
            # cached replica set (detached actors, still alive) keeps
            # serving — a failed refresh must not fail the request
            return
        self._apply_refresh(info)

    async def _refresh_async(self, force: bool = False):
        """Awaitable replica-list refresh for event-loop callers: the
        controller reply is awaited via get_async instead of blocking
        the loop's thread.  (_controller() itself still does one sync
        name-resolution RPC — sub-ms, once per refresh period.)"""
        now = time.monotonic()
        if not force and now - self._last_refresh < self.REFRESH_PERIOD_S:
            return
        import ray_tpu_torch

        self._last_refresh = now
        try:
            ctrl = _controller()
            known = self._version if self._replicas else -1
            info = await ray_tpu_torch.get_async(
                ctrl.get_replicas.remote(self._name, known),
                timeout=30)
        except Exception:
            return  # best-effort, same as the sync path
        self._apply_refresh(info)

    def _apply_refresh(self, info) -> None:
        if info is None or info.get("unchanged"):
            return
        # same-version rosters still apply when the local list is empty:
        # a handle that _drop_replica'd its way to zero (every cached
        # replica looked dead) must be able to re-learn the roster even
        # though the controller's version never moved
        if info["version"] != self._version or not self._replicas:
            with self._lock:
                self._version = info["version"]
                self._max_ongoing = info.get("max_ongoing",
                                             self._max_ongoing)
                if info.get("policy") is not None:
                    self._policy = dict(info["policy"])
                self._set_replicas(info["replica_ids"],
                                   info.get("replica_nodes"))

    def _pick_replica(self, local_pref: bool = True, exclude=None,
                      probe: bool = False):
        """Choose a replica (least-outstanding-requests) and charge it
        +1 inflight; returns (replica, rid).  ``exclude`` filters out
        replicas a retrying caller already saw die — unless that would
        leave nothing, in which case every replica is fair game again
        (the exclusion list may be stale across a re-heal).  ``probe``
        marks a half-open pick as the breaker's single probe — only
        callers that RECORD outcomes (call_async) pass it; a stream
        pick must not consume the probe slot its outcome would never
        release."""
        import random

        with self._lock:
            if not self._replicas:
                raise RuntimeError(
                    f"deployment {self._name!r} has no replicas")
            candidates = self._replicas
            if exclude:
                alive = [r for r in candidates
                         if r._actor_id not in exclude]
                candidates = alive or candidates
            # circuit-broken replicas leave routing (open breaker) until
            # their half-open probe re-admits them; if EVERY candidate
            # is broken, routing falls back to all of them — degraded
            # service beats refusing to route at all
            if self._circuits:
                healthy = [r for r in candidates
                           if (c := self._circuits.get(r._actor_id))
                           is None or c.routable()]
                candidates = healthy or candidates
            # locality-aware power-of-two (reference:
            # pow_2_scheduler.py:717): prefer same-node replicas only
            # while they have queue headroom — a saturated local replica
            # must not absorb all ingress while remote ones sit idle —
            # then sample two candidates, take the fewer-outstanding one
            local = [r for r in candidates
                     if self._replica_nodes.get(r._actor_id)
                     == self._my_node
                     and self._inflight.get(r._actor_id, 0)
                     < self._max_ongoing] \
                if (local_pref and self._my_node) else []
            pool = local or candidates
            if len(pool) > 2:
                pool = random.sample(pool, 2)
            replica = min(pool,
                          key=lambda r: self._inflight.get(r._actor_id, 0))
            rid = replica._actor_id
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
            c = self._circuits.get(rid)
            if probe and c is not None:
                c.note_picked()  # a half-open pick is THE probe
        return replica, rid

    def _submit_call(self, replica, rid: str, _method: str, args, kwargs):
        """Submit one replica call (non-blocking) under a handle-call
        span; registers the completion watcher that releases the
        inflight charge.  Shared by remote() and remote_async()."""
        # handle-call span: ties a Serve request (HTTP ingress span or an
        # in-cluster caller's active trace) to the replica-side actor
        # task — the submit/execute spans chain under it automatically
        from ray_tpu_torch._private import tracing

        span = tracing.start_span(f"serve.handle {self._name}",
                                  kind=tracing.KIND_CLIENT,
                                  attributes={"replica_id": rid,
                                              "method": _method})
        token = tracing.activate(span.context()) if span else None
        try:
            ref = replica.handle_request.remote(_method, args, kwargs)
        finally:
            if span is not None:
                tracing.restore(token)
                span.end()

        def _done_cb(rid=rid):
            with self._lock:
                if rid in self._inflight:
                    self._inflight[rid] -= 1

        _watch_ref_done(ref, _done_cb)
        return ref

    def remote(self, *args, _method: str = "__call__", **kwargs):
        self._maybe_refresh()
        if not self._replicas:
            self._maybe_refresh(force=True)
        replica, rid = self._pick_replica()
        return self._submit_call(replica, rid, _method, args, kwargs)

    async def remote_async(self, *args, _method: str = "__call__", **kwargs):
        """Async-native remote(): same least-outstanding-requests
        replica choice and inflight accounting, but the periodic
        controller refresh is awaited on the calling loop instead of
        blocking a thread.  Returns the ObjectRef — ``await ref`` (or
        ``ray_tpu_torch.get_async``) for the value.  The async Serve ingress
        routes every request through this."""
        await self._refresh_async()
        if not self._replicas:
            await self._refresh_async(force=True)
        replica, rid = self._pick_replica()
        return self._submit_call(replica, rid, _method, args, kwargs)

    def _drop_replica(self, rid: str) -> None:
        """A call to this replica died: stop routing to it NOW, without
        waiting for the next controller refresh — during node churn the
        refresh window would otherwise keep feeding a dead replica."""
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r._actor_id != rid]
            self._replica_nodes.pop(rid, None)
            self._inflight.pop(rid, None)

    async def call_async(self, *args, _method: str = "__call__",
                         _timeout: float = 120.0, **kwargs):
        """Submit AND await one call, retrying dead replicas: if the
        picked replica died mid-flight (its node was SIGKILLed under
        load), the request is re-sent to a surviving replica instead of
        surfacing ActorDiedError to the client — graceful degradation
        under churn.  User exceptions (RayTaskError) are NEVER retried;
        only replica-death errors are, ``serve_dead_replica_retries``
        times, with a forced controller refresh between attempts.

        Tail tolerance rides here too: the deployment's
        ``request_timeout_s`` caps the budget (combined with any
        ambient deadline — an X-Request-Deadline-Ms ingress header —
        and stamped into the replica task so the downstream tree
        inherits it), IDEMPOTENT deployments hedge a duplicate request
        to a second replica after the hedge delay (first response
        wins, the loser is cancelled), and every outcome feeds the
        per-replica circuit breaker."""
        from ray_tpu_torch._private import deadlines
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch._private.errors import (ActorDiedError,
                                             ActorUnavailableError,
                                             DeadlineExceededError,
                                             RayWorkerError)

        await self._refresh_async()
        if not self._replicas:
            await self._refresh_async(force=True)
        rt = self._policy.get("request_timeout_s")
        policy_bound = rt is not None and float(rt) < _timeout
        if policy_bound:
            _timeout = float(rt)
        ambient = deadlines.current_deadline()
        # only a REAL bound (policy or ambient header deadline) stamps a
        # deadline into the replica task — the transport's 120s default
        # must not arm the deadline sweep for every unbounded request,
        # shorten a client's explicit (longer) header deadline, or
        # convert a long-running request into a 504
        if policy_bound:
            deadline = deadlines.effective_deadline(_timeout)
        else:
            deadline = ambient  # None when truly unbounded
        bounded = policy_bound or ambient is not None
        attempts = 1 + max(0, int(config.serve_dead_replica_retries))
        dead: set = set()
        for attempt in range(attempts):
            if not self._replicas:
                await self._refresh_async(force=True)
            replica, rid = self._pick_replica(exclude=dead, probe=True)
            try:
                return await self._await_call(replica, rid, _method, args,
                                              kwargs, deadline, bounded,
                                              dead, _timeout, policy_bound)
            except DeadlineExceededError:
                raise  # the budget is gone; retrying cannot help
            except (ActorDiedError, ActorUnavailableError,
                    RayWorkerError):
                # includes OutOfMemoryError (a RayWorkerError subclass):
                # a replica OOM-killed by the node memory watchdog reads
                # as replica death here — _one already fed the breaker a
                # failure, so repeated OOMs open the circuit and routing
                # heals away from the starved node while the controller
                # restarts the replica
                dead.add(rid)
                self._drop_replica(rid)
                if attempt == attempts - 1:
                    raise
                # the controller may have re-healed already; otherwise
                # surviving cached replicas keep serving
                await self._refresh_async(force=True)

    async def _await_call(self, replica, rid: str, _method: str, args,
                          kwargs, deadline: Optional[float],
                          bounded: bool, dead: set,
                          _timeout: float = 120.0,
                          policy_bound: bool = False):
        """One submit-and-await attempt, with hedging.  The replica
        task is submitted under the active deadline (so the spec
        carries it); if the primary has not answered after the hedge
        delay, a duplicate fires against a second replica — first
        response wins and the loser is cancelled through the task
        cancel machinery.  Outcomes (latency, errors, hedge-slowness)
        feed the per-replica circuit breakers."""
        import asyncio

        import ray_tpu_torch
        from ray_tpu_torch._private import deadlines
        from ray_tpu_torch._private.errors import (DeadlineExceededError,
                                             GetTimeoutError, RayTaskError)

        def _budget() -> float:
            rem = deadlines.remaining(deadline)
            return _timeout if rem is None else rem

        def _submit(rep, rep_id):
            token = deadlines.activate(deadline) if deadline else None
            try:
                return self._submit_call(rep, rep_id, _method, args, kwargs)
            finally:
                if token is not None:
                    deadlines.restore(token)

        async def _one(ref, rep_id, t_start):
            try:
                out = await ray_tpu_torch.get_async(ref, timeout=_budget())
            except GetTimeoutError:
                # a miss of the DEPLOYMENT's own SLO is a replica-health
                # signal; an expiry of the CLIENT's (possibly
                # impossibly-tight) header budget is not — feeding the
                # latter to the breaker would open circuits on healthy
                # replicas whenever an upstream sends doomed budgets
                if policy_bound:
                    self._record_outcome(rep_id, error=True)
                if bounded:
                    deadlines.count_exceeded("get")
                    raise DeadlineExceededError(
                        f"deployment {self._name!r} request exceeded its "
                        f"deadline", where="get") from None
                raise
            except RayTaskError:
                raise  # application error: not a replica-health signal
            except ray_tpu_torch.RayError:
                self._record_outcome(rep_id, error=True)
                raise
            self._record_outcome(rep_id,
                                 latency_s=time.monotonic() - t_start)
            return out

        hedge_delay = self._hedge_delay()
        t0 = time.monotonic()
        ref = _submit(replica, rid)
        primary = asyncio.ensure_future(_one(ref, rid, t0))
        if hedge_delay is None:
            return await primary
        done, _ = await asyncio.wait({primary}, timeout=hedge_delay)
        if done:
            return primary.result()  # answered before the hedge delay
        try:
            h_replica, h_rid = self._pick_replica(
                exclude={rid} | set(dead), probe=True)
        except RuntimeError:
            return await primary  # nowhere to hedge to
        if h_rid == rid:
            # exclusion exhausted (single live replica): nothing was
            # submitted for this pick — release its inflight charge or
            # every bailed hedge would inflate the count forever
            with self._lock:
                if rid in self._inflight:
                    self._inflight[rid] -= 1
            return await primary
        from ray_tpu_torch._private.metrics import serve_tail_metrics

        hedges = serve_tail_metrics()[0]
        h_ref = _submit(h_replica, h_rid)
        hedge = asyncio.ensure_future(_one(h_ref, h_rid,
                                           time.monotonic()))
        tasks = {primary: (ref, rid), hedge: (h_ref, h_rid)}
        pending = set(tasks)
        first_error = None
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    if t.exception() is None:
                        if t is hedge:
                            # the duplicate beat the primary: THAT is
                            # the gray-replica breaker signal (a p99
                            # hedge against a healthy primary usually
                            # loses the race, so healthy replicas
                            # don't accumulate slow events at the
                            # hedge-fire rate)
                            self._record_outcome(rid, slow=True)
                            hedges.inc(tags={"outcome": "won"})
                        else:
                            hedges.inc(tags={"outcome": "lost"})
                        return t.result()
                    if first_error is None or t is primary:
                        first_error = t.exception()
            raise first_error
        finally:
            # cancel the loser: its replica must stop working on a
            # request nobody will read (same machinery as client-
            # disconnect generator cancel)
            for t, (loser_ref, _loser_rid) in tasks.items():
                if not t.done():
                    t.cancel()
                    try:
                        from ray_tpu_torch._private.ids import ObjectID
                        from ray_tpu_torch._private.worker import \
                            global_worker_or_none

                        w = global_worker_or_none()
                        if w is not None:
                            tid = ObjectID(bytes.fromhex(
                                loser_ref.oid)).task_id().hex()
                            w._spawn(w._cancel_async(tid, False))
                    except Exception:
                        pass

    def _submit_stream(self, replica, rid: str, _method: str, args, kwargs):
        """Submit one streaming replica call; returns (gen, release)."""
        from ray_tpu_torch._private import tracing

        span = tracing.start_span(f"serve.stream {self._name}",
                                  kind=tracing.KIND_CLIENT,
                                  attributes={"replica_id": rid,
                                              "method": _method})
        token = tracing.activate(span.context()) if span else None
        try:
            gen = replica.stream_request.options(
                num_returns="streaming").remote(_method, args, kwargs)
        finally:
            if span is not None:
                tracing.restore(token)
                span.end()
        released = [False]

        def _release(rid=rid):
            # once-only: both the consumer finally and the waiter fire
            with self._lock:
                if released[0]:
                    return
                released[0] = True
                if rid in self._inflight:
                    self._inflight[rid] -= 1

        # the consumer-side finally alone LEAKS: a generator that is
        # never iterated never enters its try block, so an abandoned
        # stream() call would pin +1 inflight on the replica forever and
        # skew least-inflight selection.  The shared waiter decrements
        # when the replica-side task finishes producing (or errors), no
        # matter what the consumer does.
        _shared_waiter.watch_gen(gen, _release)
        return gen, _release

    def stream(self, *args, _method: str = "__call__", **kwargs):
        """Call a generator endpoint; yields one ObjectRef per item as
        the replica produces them (reference: DeploymentResponseGenerator
        in serve/handle.py).  Token streaming for TPU inference rides
        this: the replica yields tokens, callers consume mid-generation."""
        self._maybe_refresh()
        if not self._replicas:
            self._maybe_refresh(force=True)
        replica, rid = self._pick_replica(local_pref=False)
        gen, _release = self._submit_stream(replica, rid, _method, args,
                                            kwargs)

        def _wrapped():
            try:
                yield from gen
            finally:
                _abandon_stream(gen)
                _release()

        return _wrapped()

    async def _maybe_prefill(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Disaggregated-prefill hop: when the deployment's policy names
        a prefill pool, route the request's prefill phase to a dedicated
        replica there first.  The pool replica runs chunked prefill,
        exports the finished KV pages into the object store (the
        cross-node pull rides the bulk transfer plane, checksummed with
        alternate-holder retry), and returns a ``kv_ref``; the decode
        replica attaches the shipped pages by request_id and starts at
        the first generated token.  Any prefill-pool failure other than
        a deadline falls back to colocated prefill on the decode replica
        — disaggregation is an optimisation, never a new failure mode.
        Deadline errors propagate: the budget is gone either way."""
        pool = self._policy.get("prefill_pool")
        if (not pool or not isinstance(request, dict)
                or request.get("kv_ref") is not None
                or not request.get("tokens")):
            return request
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch._private.errors import DeadlineExceededError
        try:
            if len(request["tokens"]) < int(config.llm_disagg_min_prompt):
                return request
        except TypeError:
            return request
        request = dict(request)
        if not request.get("request_id"):
            import uuid

            request["request_id"] = uuid.uuid4().hex
        handle = self._prefill_handle
        if handle is None or handle._name != pool:
            import asyncio

            loop = asyncio.get_running_loop()
            try:
                handle = await loop.run_in_executor(
                    None, get_handle, pool)
            except Exception:
                return request  # pool missing/unhealthy: prefill locally
            self._prefill_handle = handle
        try:
            meta = await handle.call_async(request, _method="prefill")
        except DeadlineExceededError:
            raise
        except Exception:
            return request  # fall back to colocated prefill
        if isinstance(meta, dict) and meta.get("kv_ref") is not None:
            request["kv_ref"] = meta["kv_ref"]
        return request

    async def stream_async(self, *args, _method: str = "__call__",
                           _exclude=None, _info=None, **kwargs):
        """Async stream(): returns an async iterator of per-item
        ObjectRefs, item arrival awaited on the calling loop (no thread
        parked per stream).  The replica call is submitted EAGERLY in
        the caller's context — an active ingress span parents the
        serve.stream span, and an abandoned (never-iterated) stream
        still releases its inflight charge via the shared waiter.

        ``_exclude``/``_info`` serve the proxy's mid-stream resume
        retry: a retrying caller learns which replica served it (rid
        recorded into ``_info``) and skips replicas it already saw die
        — a freshly-refreshed roster may briefly still list them, and
        a dead replica's zero inflight makes least-outstanding choice
        otherwise gravitate right back to it."""
        await self._refresh_async()
        if not self._replicas:
            await self._refresh_async(force=True)
        if (_method == "__call__" and not _exclude and len(args) == 1
                and isinstance(args[0], dict)):
            args = (await self._maybe_prefill(args[0]),)
        replica, rid = self._pick_replica(local_pref=False,
                                          exclude=_exclude)
        if _info is not None:
            _info["rid"] = rid
        gen, _release = self._submit_stream(replica, rid, _method, args,
                                            kwargs)

        async def _aiter():
            try:
                async for ref in gen:
                    yield ref
            finally:
                _abandon_stream(gen)
                _release()

        return _aiter()

    def method(self, name: str):
        def call(*args, **kwargs):
            return self.remote(*args, _method=name, **kwargs)

        return call


# ---------------------------------------------------------------- serve API


def _controller():
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    import ray_tpu_torch.api as api

    try:
        return api.ActorClass(ServeController, name=CONTROLLER_NAME,
                              lifetime="detached").remote()
    except ray_tpu_torch.RayError:
        # lost the creation race to another caller; the winner may not
        # have registered the name yet — wait it out briefly
        import time as _time

        deadline = _time.monotonic() + 30
        while True:
            try:
                return ray_tpu_torch.get_actor(CONTROLLER_NAME)
            except ValueError:
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.2)


def run(app: Application, name: Optional[str] = None) -> DeploymentHandle:
    import cloudpickle

    import ray_tpu_torch
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.errors import DeploymentFailedError

    d = app.deployment
    dep_name = name or d.name
    num_replicas = d.num_replicas
    autoscaling = d.autoscaling_config
    if num_replicas == "auto":
        # declarative elasticity: replica count follows load between
        # the config bounds (the controller's reconcile loop scales on
        # ongoing requests + replica queue depth + shed pressure)
        autoscaling = dict(autoscaling or {})
        autoscaling.setdefault("min_replicas",
                               int(config.serve_autoscale_min_replicas))
        autoscaling.setdefault("max_replicas",
                               int(config.serve_autoscale_max_replicas))
        autoscaling.setdefault(
            "target_ongoing_requests",
            int(config.serve_autoscale_target_ongoing))
        num_replicas = int(autoscaling["min_replicas"])
    ctrl = _controller()
    pol = d.policy()
    blob = cloudpickle.dumps(d.func_or_class)
    health_timeout = float(config.serve_replica_health_timeout_s)
    try:
        if d.llm and int(d.prefill_replicas or 0) > 0:
            # disaggregated prefill: a sibling pool of identical llm
            # replicas handles the prefill phase only; handles learn the
            # pool name via the decode deployment's policy and ship the
            # finished KV pages over the bulk plane
            pool_name = f"{dep_name}-prefill"
            pol["prefill_pool"] = pool_name
            pool_pol = {k: v for k, v in pol.items()
                        if k != "prefill_pool"}
            ray_tpu_torch.get(ctrl.deploy.remote(
                pool_name, blob, int(d.prefill_replicas),
                d.max_ongoing_requests, d.init_args, d.init_kwargs,
                d.ray_actor_options, None, health_timeout, d.llm,
                pool_pol), timeout=health_timeout + 120.0)
        ray_tpu_torch.get(ctrl.deploy.remote(
            dep_name, blob, num_replicas,
            d.max_ongoing_requests, d.init_args, d.init_kwargs,
            d.ray_actor_options, autoscaling,
            health_timeout, d.llm,
            pol),
            timeout=health_timeout + 120.0)
    except ray_tpu_torch.RayTaskError as e:
        if isinstance(e.cause, DeploymentFailedError):
            raise e.cause from None  # typed: callers can catch it
        raise
    return get_handle(dep_name)


def get_handle(name: str, timeout: float = 30.0) -> DeploymentHandle:
    import ray_tpu_torch

    # ride through a controller crash: the name may briefly resolve to
    # the dead actor (or to nothing) until a fresh controller registers
    # and recovers its checkpoint — retry RayErrors within the window
    deadline = time.monotonic() + timeout
    while True:
        try:
            ctrl = _controller()
            info = ray_tpu_torch.get(ctrl.get_replicas.remote(name), timeout=60)
            break
        except (ray_tpu_torch.RayError, ValueError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.2)
    if info is None:
        raise ValueError(f"no deployment named {name!r}")
    return DeploymentHandle(name, info["replica_ids"], info["version"],
                            info.get("replica_nodes"),
                            max_ongoing=info.get("max_ongoing", 8),
                            policy=info.get("policy"))


def delete(name: str):
    import ray_tpu_torch

    ray_tpu_torch.get(_controller().delete.remote(name), timeout=120)


def shutdown():
    import ray_tpu_torch

    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    for name in list(ray_tpu_torch.get(ctrl.list_deployments.remote(), timeout=60)):
        ray_tpu_torch.get(ctrl.delete.remote(name), timeout=120)
    ray_tpu_torch.kill(ctrl)
