"""Public API: init/shutdown, @remote, get/put/wait, actors.

Ported from ray_tpu's API: ``num_gpus=`` reserves the ``"GPU"``
resource, which the node agent pins to concrete cards per lease;
``num_tpus=`` is gone.  ``bind()`` needs the compiled-graph package,
which a later slice brings.

Equivalent of the reference's driver API surface
(reference: python/ray/_private/worker.py — ray.init :1217, ray.get
:2533, ray.put :2665, ray.wait :2730, ray.remote :3123;
python/ray/remote_function.py:276 RemoteFunction._remote;
python/ray/actor.py:857 ActorClass._remote).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private.errors import RayError
from ray_tpu_torch._private.object_ref import ObjectRef

_state_lock = threading.RLock()
# RT_* env vars exported by init(_system_config=...) -> their PRIOR
# value (None = absent before): shutdown() restores rather than pops,
# so one cluster's overrides never leak into the next AND an
# operator-exported RT_* setting survives an init/shutdown cycle
_config_env_prior: Dict[str, Any] = {}
_global_node: Optional[Dict[str, Any]] = None  # procs + addrs when we own them


def is_initialized() -> bool:
    from ray_tpu_torch._private.worker import global_worker_or_none

    return global_worker_or_none() is not None


def _worker():
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is None:
        raise RayError("ray_tpu_torch.init() has not been called")
    return w


def init(address: Optional[str] = None, *,
         num_cpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         runtime_env: Optional[Dict[str, Any]] = None,
         log_to_driver: Optional[bool] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         ignore_reinit_error: bool = False):
    """Start (or connect to) a cluster and attach this process as a driver.

    With no address, spawns a head service and one node agent locally
    (reference: worker.py:1217 bootstrap path). With address="host:port",
    connects to an existing head and uses the head node's agent.

    ``log_to_driver`` (default: config ``log_to_driver``, on) streams
    worker stdout/stderr to this driver's console with
    ``(pid=..., node=...)`` prefixes via the node agents' log monitors.
    """
    import os as _os

    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.rpc import EventLoopThread, SyncRpcClient
    from ray_tpu_torch._private.worker import CoreWorker, MODE_DRIVER, \
        global_worker_or_none, set_global_worker

    if address is None:
        # the environment wins when a job/driver was launched by the CLI
        # or job supervisor (reference: RAY_ADDRESS)
        address = _os.environ.get("RT_ADDRESS") or None
    if address == "local":
        address = None
    client_mode = False
    if address and address.startswith("rt://"):
        # client mode (reference: ray.init("ray://...") — the driver may
        # run on a machine with no access to the node's shm arena; object
        # data proxies through the agent RPC instead of mmap)
        client_mode = True
        address = address[len("rt://"):]

    global _global_node
    with _state_lock:
        if global_worker_or_none() is not None:
            if ignore_reinit_error:
                return
            raise RayError("ray_tpu_torch.init() called twice")
        config.initialize(_system_config)
        env = {}
        if _system_config:
            env = config.deserialize_into_env(config.serialize())
            import os

            # prior values recorded so shutdown() can restore them:
            # without this a stale RT_* var from one cluster's
            # _system_config leaks into every LATER cluster's spawned
            # daemons (env has precedence over fresh overrides)
            for k in env:
                _config_env_prior.setdefault(k, os.environ.get(k))
            os.environ.update(env)
        if address is None:
            session_dir = node_mod.new_session_dir()
            head_proc, head_addr = node_mod.start_head(session_dir, env=env)
            res = node_mod.default_resources(num_cpus, resources)
            agent_proc, info = node_mod.start_node_agent(
                session_dir, head_addr, res,
                object_store_memory=object_store_memory,
                is_head_node=True, env=env)
            _global_node = {"procs": [agent_proc, head_proc],
                            "session_dir": session_dir}
        else:
            host, port_s = address.rsplit(":", 1)
            head_addr = (host, int(port_s))
            io = EventLoopThread(name="rt-init")
            try:
                head = SyncRpcClient(head_addr[0], head_addr[1], io, label="head")
                table = head.call("node_table")
                head.close()
            finally:
                io.stop()
            entry = next((v for v in table.values() if v.get("is_head_node")),
                         next(iter(table.values()), None))
            if entry is None:
                raise RayError(f"no node agents registered at {address}")
            info = {"addr": tuple(entry["addr"]), "node_id": entry["node_id"],
                    "arena_path": entry["arena_path"]}
            _global_node = None
        worker = CoreWorker(MODE_DRIVER, head_addr, info["addr"],
                            None if client_mode else info["arena_path"],
                            info["node_id"], log_to_driver=log_to_driver)
        if runtime_env:
            # job-level default: every task/actor of this driver inherits
            # it unless overridden (reference: job_config.runtime_env)
            from ray_tpu_torch._private import runtime_env as renv_mod

            try:
                worker.job_runtime_env = renv_mod.normalize(
                    runtime_env, worker.head)
            except BaseException:
                set_global_worker(None)
                worker.shutdown()
                _teardown_global_node()
                raise
        set_global_worker(worker)
        return


def _teardown_global_node():
    global _global_node
    if _global_node is not None:
        for p in _global_node["procs"]:
            p.terminate()
        _global_node = None


def shutdown():
    from ray_tpu_torch._private.worker import global_worker_or_none, set_global_worker

    global _global_node
    with _state_lock:
        w = global_worker_or_none()
        if w is not None:
            if _global_node is not None:
                try:
                    w.head.call("shutdown_cluster", timeout=2.0)
                except Exception:
                    pass
            set_global_worker(None)
            w.shutdown()
        _renv_cache.clear()
        _teardown_global_node()
        # _system_config overrides die with the cluster: initialize()
        # merges into the live override dict and init() exported RT_*
        # env vars, so without this cleanup a stale key from one init()
        # (e.g. a test's memory_monitor usage file) silently leaks into
        # the NEXT cluster's spawned daemons
        from ray_tpu_torch._private.config import config as _config

        _config._overrides.clear()
        import os as _os2

        for k, prior in _config_env_prior.items():
            if prior is None:
                _os2.environ.pop(k, None)
            else:
                _os2.environ[k] = prior
        _config_env_prior.clear()


def put(value: Any) -> ObjectRef:
    return _worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    w = _worker()
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout=timeout)[0]
    return w.get(list(refs), timeout=timeout)


async def get_async(refs: Union[ObjectRef, Sequence[ObjectRef]],
                    *, timeout: Optional[float] = None) -> Any:
    """Awaitable ray_tpu_torch.get: resolves on the calling event loop via
    owner-side completion futures — no thread blocked per caller, so an
    event-loop server (the async Serve ingress) can await thousands of
    refs concurrently.  ``await ref`` and ``ref.future()`` are sugar
    over the same path."""
    w = _worker()
    if isinstance(refs, ObjectRef):
        return (await w.get_async([refs], timeout=timeout))[0]
    return await w.get_async(list(refs), timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return _worker().wait(refs, num_returns=num_returns, timeout=timeout)


def kill(actor: "ActorHandle", *, no_restart: bool = True):
    _worker().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref, *, force: bool = False):
    """Cancel a submitted task (reference: ray.cancel,
    python/ray/_private/worker.py:2942).  Accepts any return ref of the
    task or its ObjectRefGenerator.  Non-force interrupts the running
    body (async tasks are cancelled; sync bodies get TaskCancelledError
    at the next bytecode); force=True kills the executing worker.
    Waiters observe TaskCancelledError.  No-op on finished tasks."""
    _worker().cancel(ref, force=force)


def get_actor(name: str) -> "ActorHandle":
    w = _worker()
    reply = w.head.call("get_named_actor", name=name)
    if not reply.get("found"):
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(reply["actor_id"],
                       method_num_returns=reply.get("method_num_returns"))


def cluster_resources() -> Dict[str, float]:
    return _worker().head.call("cluster_resources")["total"]


def available_resources() -> Dict[str, float]:
    return _worker().head.call("cluster_resources")["available"]


def nodes() -> List[Dict[str, Any]]:
    table = _worker().head.call("node_table")
    return list(table.values())


# --------------------------------------------------------------------- tasks


class RemoteFunction:
    """Handle produced by @remote on a function
    (reference: python/ray/remote_function.py)."""

    _OPT_KEYS = ("num_returns", "num_cpus", "num_gpus",
                 "memory", "resources", "max_retries", "name",
                 "runtime_env", "scheduling_strategy", "timeout_s",
                 "placement_group", "placement_group_bundle_index")

    def __init__(self, fn, **opts):
        bad = set(opts) - set(self._OPT_KEYS)
        if bad:
            raise TypeError(f"unknown @remote option(s): {sorted(bad)}")
        self._fn = fn
        self._opts = opts
        self._num_returns = opts.get("num_returns") or 1
        self._resources = _build_resources(
            opts.get("num_cpus"), opts.get("num_gpus"),
            opts.get("resources"), default_cpu=1,
            memory=opts.get("memory"))
        self._max_retries = opts.get("max_retries", 3)
        self._name = opts.get("name") or getattr(
            fn, "__qualname__", getattr(fn, "__name__", "fn"))
        # (cluster worker_id -> function table id): the table is per-head,
        # so a new init() after shutdown() must re-export
        self._function_ids: Dict[str, str] = {}
        self.__doc__ = getattr(fn, "__doc__", None)

    def options(self, **opts) -> "RemoteFunction":
        """New handle with the given options overriding, others inherited."""
        return RemoteFunction(self._fn, **{**self._opts, **opts})

    def _fid(self, w) -> str:
        fid = self._function_ids.get(w.worker_id)
        if fid is None:
            fid = w.functions.export(self._fn)
            self._function_ids = {w.worker_id: fid}
        return fid

    def remote(self, *args, **kwargs):
        w = _worker()
        pg = self._opts.get("placement_group")
        refs = w.submit_task(
            self._fid(w), args, kwargs, num_returns=self._num_returns,
            resources=self._resources, max_retries=self._max_retries,
            name=self._name, runtime_env=_normalized_renv(self, w),
            scheduling_strategy=_strategy_wire(self._opts),
            placement_group_id=pg.id if pg is not None else "",
            bundle_index=self._opts.get("placement_group_bundle_index", -1),
            timeout_s=self._opts.get("timeout_s"))
        if self._num_returns == 1 or self._num_returns == "streaming":
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of submitting now
        (reference: python/ray/dag/function_node.py)."""
        from ray_tpu_torch.dag.nodes import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._name} cannot be called directly; "
            f"use {self._name}.remote(...)")


def _strategy_wire(opts: Dict[str, Any]) -> Dict[str, Any]:
    from ray_tpu_torch.util.scheduling_strategies import strategy_to_wire

    return strategy_to_wire(opts.get("scheduling_strategy"))


_renv_cache: Dict[tuple, Dict[str, Any]] = {}


def _normalized_renv(handle, w) -> Dict[str, Any]:
    """Normalize (package + upload) a handle's runtime_env option once
    per (cluster connection, env content) — NOT per handle: options()
    mints a fresh handle per call, and re-zipping a working_dir on every
    submission would cost seconds of CPU each."""
    import json

    renv = handle._opts.get("runtime_env")
    if not renv:
        return {}
    key = (w.worker_id, json.dumps(renv, sort_keys=True, default=str))
    cached = _renv_cache.get(key)
    if cached is None:
        from ray_tpu_torch._private import runtime_env as renv_mod

        if len(_renv_cache) > 256:  # old connections / envs
            _renv_cache.clear()
        cached = _renv_cache[key] = renv_mod.normalize(renv, w.head)
    return cached


def _build_resources(num_cpus, num_gpus, resources,
                     default_cpu: float,
                     memory=None) -> Dict[str, float]:
    out: Dict[str, float] = dict(resources or {})
    out["CPU"] = float(num_cpus) if num_cpus is not None else float(default_cpu)
    if num_gpus is not None:
        # the node agent pins the lease to that many concrete cards,
        # exported to the worker as CUDA_VISIBLE_DEVICES
        out["GPU"] = float(num_gpus)
    if memory is not None:
        # bytes, bin-packed against the node's `memory` total (the
        # watchdog's virtual envelope when configured, else MemTotal) —
        # declared memory is a real reservation, not a hint
        out["memory"] = float(memory)
    return out


# -------------------------------------------------------------------- actors


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        num_returns = self._handle._method_num_returns.get(self._name, 1)
        return self._remote_n(num_returns, None, *args, **kwargs)

    def options(self, *, num_returns: Union[int, str, None] = None,
                timeout_s: Optional[float] = None):
        m = ActorMethod(self._handle, self._name)

        def call(*a, **kw):
            # None = keep the @method(num_returns=...) annotation —
            # options(timeout_s=...) alone must not reset return shape
            nr = num_returns if num_returns is not None \
                else self._handle._method_num_returns.get(self._name, 1)
            return self._remote_n(nr, timeout_s, *a, **kw)

        m.remote = call
        return m

    def _remote_n(self, num_returns, timeout_s, *args, **kwargs):
        w = _worker()
        if timeout_s is None:
            timeout_s = self._handle._timeout_s
        refs = w.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=num_returns,
            max_retries=self._handle._max_task_retries,
            timeout_s=timeout_s)
        return refs[0] if num_returns in (1, "streaming") else refs

    def __call__(self, *a, **kw):
        raise TypeError(f"Actor method {self._name} must be called with .remote()")


class ActorHandle:
    """Serializable handle to a remote actor
    (reference: python/ray/actor.py ActorHandle).  The handle returned by
    `.remote()` owns the actor's lifetime: when it is garbage collected
    the actor is terminated (reference: out-of-scope actor GC).  Copies
    obtained by serialization or get_actor do not own the actor."""

    def __init__(self, actor_id: str, max_task_retries: int = 0,
                 method_num_returns: Optional[Dict[str, int]] = None,
                 _owner: bool = False, timeout_s: Optional[float] = None):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries
        self._method_num_returns = method_num_returns or {}
        self._owner = _owner
        # default per-call deadline budget for every method of this
        # handle (ActorClass.options(timeout_s=...)); a per-call
        # ActorMethod.options(timeout_s=...) overrides it
        self._timeout_s = timeout_s

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):
        return (ActorHandle,
                (self._actor_id, self._max_task_retries,
                 self._method_num_returns, False, self._timeout_s))

    def __del__(self):
        if getattr(self, "_owner", False):
            try:
                from ray_tpu_torch._private.worker import global_worker_or_none

                w = global_worker_or_none()
                if w is not None:
                    w.kill_actor_async(self._actor_id)
            except Exception:
                pass

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:16]}…)"


class ActorClass:
    _OPT_KEYS = ("num_cpus", "num_gpus", "memory", "resources",
                 "max_restarts", "max_task_retries", "max_concurrency",
                 "name", "lifetime", "runtime_env", "scheduling_strategy",
                 "timeout_s",
                 "placement_group", "placement_group_bundle_index")

    def __init__(self, cls, **opts):
        bad = set(opts) - set(self._OPT_KEYS)
        if bad:
            raise TypeError(f"unknown actor option(s): {sorted(bad)}")
        self._cls = cls
        self._opts = opts
        # actors hold 0 CPUs while alive unless explicitly requested
        # (reference: ray actor default num_cpus=0 post-creation, so many
        # actors coexist on few cores)
        self._resources = _build_resources(
            opts.get("num_cpus"), opts.get("num_gpus"),
            opts.get("resources"), default_cpu=0,
            memory=opts.get("memory"))
        self._max_restarts = opts.get("max_restarts", 0)
        self._max_task_retries = opts.get("max_task_retries", 0)
        self._max_concurrency = opts.get("max_concurrency", 1)
        self._name = opts.get("name", "")
        self._lifetime = opts.get("lifetime", "")
        self._class_ids: Dict[str, str] = {}
        self.__doc__ = getattr(cls, "__doc__", None)

    def options(self, **opts) -> "ActorClass":
        """New handle with the given options overriding, others inherited."""
        return ActorClass(self._cls, **{**self._opts, **opts})

    def remote(self, *args, **kwargs) -> ActorHandle:
        w = _worker()
        cid = self._class_ids.get(w.worker_id)
        if cid is None:
            cid = w.functions.export(self._cls)
            self._class_ids = {w.worker_id: cid}
        pg = self._opts.get("placement_group")
        actor_id = w.create_actor(
            cid, args, kwargs, resources=self._resources,
            max_restarts=self._max_restarts,
            max_task_retries=self._max_task_retries,
            max_concurrency=self._max_concurrency, name=self._name,
            runtime_env=_normalized_renv(self, w),
            scheduling_strategy=_strategy_wire(self._opts),
            placement_group_id=pg.id if pg is not None else "",
            bundle_index=self._opts.get("placement_group_bundle_index", -1),
            method_num_returns=self._method_num_returns())
        owner = self._lifetime != "detached"
        return ActorHandle(actor_id, max_task_retries=self._max_task_retries,
                           method_num_returns=self._method_num_returns(),
                           _owner=owner,
                           timeout_s=self._opts.get("timeout_s"))

    def _method_num_returns(self) -> Dict[str, Any]:
        """Collect @method(num_returns=...) annotations off the class
        (reference: python/ray/actor.py method decorator)."""
        out: Dict[str, Any] = {}
        for name in dir(self._cls):
            fn = getattr(self._cls, name, None)
            nr = getattr(fn, "__rt_num_returns__", None)
            if nr is not None:
                out[name] = nr
        return out

    def bind(self, *args, **kwargs):
        """Build an actor DAG node instead of creating the actor now
        (reference: python/ray/dag/class_node.py)."""
        from ray_tpu_torch.dag.nodes import ClassNode

        return ClassNode(self, args, kwargs)

    def __call__(self, *a, **kw):
        raise TypeError("Actor classes must be instantiated with .remote()")


# ------------------------------------------------------------------- remote


def method(*, num_returns: Union[int, str] = 1):
    """Annotate an actor method's return shape, e.g. streaming:

        @ray_tpu_torch.remote
        class A:
            @ray_tpu_torch.method(num_returns="streaming")
            def gen(self): yield ...

    (reference: python/ray/actor.py:42 @ray.method)."""
    def mark(fn):
        fn.__rt_num_returns__ = num_returns
        return fn
    return mark


def remote(*args, **kwargs):
    """@remote decorator for functions and classes
    (reference: python/ray/_private/worker.py:3123)."""

    def make(target):
        if isinstance(target, type):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    return make
