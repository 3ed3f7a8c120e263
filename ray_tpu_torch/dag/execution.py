"""Compiled-graph execution: pinned actor loops over mutable channels.

Equivalent of the reference's accelerated DAG execution
(reference: python/ray/dag/compiled_dag_node.py:174 — CompiledDAG
`_execute_until` / the per-actor `do_exec_tasks` loop): compilation
creates the DAG's actors once, pre-allocates a mutable channel
(channel.py) per cross-process edge, and installs ONE persistent
execution-loop task per actor.  The loop blocks on its input channels,
runs its bound methods, writes its output channels, and repeats —
steady-state ``execute()`` involves **no task spec, no scheduler visit,
no new object refs**: the driver writes the input channel and hands
back a :class:`CompiledDAGRef` that reads the output channel, with
backpressure from the bounded version ring.

Error model:
  * a method raising inside the loop serializes the exception into its
    output channel version; downstream nodes forward it and
    ``CompiledDAGRef.get()`` re-raises it;
  * actor death fails the actor's loop-task ref; a driver-side monitor
    observes that within ``dag_monitor_interval_s`` and POISONS every
    channel (writer-node slots and mirrors), so all in-flight
    ``get()``/``execute()`` calls raise (``ActorDiedError``) instead of
    hanging;
  * ``teardown()`` is synchronous and idempotent: channels close, loops
    drain and exit, actors are killed and waited on, slots are freed.

Observability: every execute emits a ``dag.execute`` trace span (and
``get`` completion a ``dag.get`` span) through the PR-2 tracing store,
and the driver observes ``ray_tpu_dag_execute_latency_seconds`` per
result; the channels count reads/writes in
``ray_tpu_dag_channel_ops_total``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag import channel as ch
from ray_tpu_torch.dag.nodes import (ClassMethodNode, ClassNode, DAGNode,
                               FunctionNode, InputAttributeNode, InputNode,
                               MultiOutputNode, _map_args)
from ray_tpu_torch._private.errors import ActorDiedError, RayError

# special actor-method names dispatched by the worker's executor to this
# module (see CoreWorker._execute_inner) — they must start with an
# underscore so ActorHandle.__getattr__ can never shadow user methods
DAG_EXEC_METHOD = "__rt_dag_exec_loop__"
DAG_INFO_METHOD = "__rt_dag_node_info__"

_INPUT_KEY = "__input__"

# channel slots claimed by live (compiled, not-yet-torn-down) graphs in
# this process, keyed by graph identity.  The worker's memory summary
# reports them so the head's channel-leak tripwire can tell a slot a
# running pipeline still owns from one a dead/teardown-skipped graph
# left pinned in the store forever.
_live_channels: Dict[int, List[str]] = {}
_live_channels_lock = threading.Lock()


def live_channel_oids() -> List[str]:
    with _live_channels_lock:
        return [oid for oids in _live_channels.values() for oid in oids]


def _register_live_channels(graph_key: int, oids: List[str]) -> None:
    with _live_channels_lock:
        _live_channels[graph_key] = list(dict.fromkeys(oids))


def _unregister_live_channels(graph_key: int) -> None:
    with _live_channels_lock:
        _live_channels.pop(graph_key, None)


class _ArgRef:
    """Marker inside a step's arg template: replaced at loop runtime by
    the execute input, a projection of it, or another node's result."""

    __slots__ = ("kind", "key")

    def __init__(self, kind: str, key=None):
        self.kind = kind  # "input" | "input_attr" | "node"
        self.key = key

    def __reduce__(self):
        return (_ArgRef, (self.kind, self.key))

    def __repr__(self):
        return f"_ArgRef({self.kind}, {self.key!r})"


class _ErrValue:
    """An upstream error flowing through the loop's value context."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


# --------------------------------------------------------------- worker side


_node_info_cache: Optional[Dict[str, Any]] = None


def collect_node_info(worker) -> Dict[str, Any]:
    """Executed as a (special) actor task during compile: report where
    this actor lives so the driver can place channel slots and mirrors."""
    global _node_info_cache
    if _node_info_cache is None:
        try:
            xfer_port = int(worker.agent.call("node_info").get(
                "xfer_port") or 0)
        except Exception:
            xfer_port = 0
        _node_info_cache = {"node_id": worker.node_id,
                            "agent": list(worker.agent_addr),
                            "xfer_port": xfer_port}
    return dict(_node_info_cache)


def _resolve_template(template, ctx: Dict[str, Any]):
    """Substitute _ArgRef markers; returns (value, first_error|None)."""
    err: List[BaseException] = []

    def sub(obj):
        if isinstance(obj, _ArgRef):
            if obj.kind == "input":
                val = ctx[_INPUT_KEY]
            elif obj.kind == "input_attr":
                val = ctx[_INPUT_KEY]
                if not isinstance(val, _ErrValue):
                    kind, key = obj.key
                    val = getattr(val, key) if kind == "attr" else val[key]
            else:
                val = ctx[obj.key]
            if isinstance(val, _ErrValue) and not err:
                err.append(val.exc)
            return val
        if isinstance(obj, (list, tuple)):
            return type(obj)(sub(x) for x in obj)
        if isinstance(obj, dict):
            return {k: sub(v) for k, v in obj.items()}
        return obj

    out = sub(template)
    return out, (err[0] if err else None)


def _write_result(writer: ch.ChannelWriter, result: Any) -> None:
    """Publish one node result, degrading VALUE-level write failures
    (unserializable result, value larger than the channel slot) to an
    error version — only channel-level failures (closed/poisoned,
    transport death) may escape and take the loop down."""
    if isinstance(result, _ErrValue):
        writer.write(result.exc, error=True)
        return
    try:
        writer.write(result)
    except (ch.ChannelClosedError, ch.ChannelTimeoutError):
        raise
    except ch.ChannelError as e:  # e.g. oversized value
        writer.write(e, error=True)
    except Exception as e:
        from ray_tpu_torch._private.serialization import SerializationError

        if not isinstance(e, SerializationError):
            raise
        writer.write(e, error=True)


def run_actor_loop(worker, instance, plan: Dict[str, Any]) -> Dict[str, Any]:
    """The pinned per-actor execution loop (runs ON the actor's exec
    thread, occupying it until the DAG is torn down).

    Equivalent of the reference's ``do_exec_tasks``
    (reference: python/ray/dag/compiled_dag_node.py:129): one blocking
    iteration per execute — read every input channel version, run this
    actor's bound methods in topological order, write output channels,
    then release the input slots."""
    readers: List[Tuple[ch.ChannelReader, str]] = [
        (ch.ChannelReader(ch.ChannelSpec(**r["spec"]), r["index"]), r["key"])
        for r in plan["inputs"]]
    writers: List[Tuple[str, ch.ChannelWriter]] = [
        (o["key"], ch.ChannelWriter(ch.ChannelSpec(**o["spec"])))
        for o in plan["outputs"]]
    steps = plan["steps"]
    seq = 0
    iterations = 0
    try:
        while True:
            seq += 1
            ctx: Dict[str, Any] = {}
            try:
                for reader, key in readers:
                    value, is_err = reader.read(seq)
                    ctx[key] = _ErrValue(value) if is_err else value
                for step in steps:
                    try:
                        args, err = _resolve_template(step["args"], ctx)
                        kwargs, kerr = _resolve_template(step["kwargs"],
                                                         ctx)
                        err = err or kerr
                    except Exception as e:  # bad input projection etc.
                        err = e
                    if err is not None:
                        ctx[step["key"]] = _ErrValue(err)
                        continue
                    try:
                        ctx[step["key"]] = getattr(
                            instance, step["method"])(*args, **kwargs)
                    except Exception as e:  # noqa: BLE001 — serialized
                        ctx[step["key"]] = _ErrValue(e)
                for key, writer in writers:
                    _write_result(writer, ctx[key])
                # inputs released only now: zero-copy reads alias the
                # ring until the iteration's compute and writes finish
                for reader, _key in readers:
                    reader.advance(seq)
                iterations += 1
            except ch.ChannelClosedError:
                break
    finally:
        # teardown (or failure): closing our outputs wakes downstream
        # loops so shutdown propagates along the pipeline
        for _key, writer in writers:
            try:
                writer.close()
            except Exception:
                pass
            writer.detach()
    return {"iterations": iterations}


# --------------------------------------------------------------- driver side


class ChannelHost:
    """Driver-side owner of a set of channel slots spread over nodes:
    allocates the writer-node slot + reader-node mirrors for each spec,
    and provides fleet-wide poison/destroy for failure and teardown.

    Shared by :class:`CompiledGraph` and the MPMD training pipeline
    (train/pipeline.py) — both need identical slot lifecycle handling
    (create on every involved node, poison on death, destroy on
    teardown, pooled agent clients)."""

    def __init__(self):
        self._agent_clients: Dict[tuple, Any] = {}
        self._created: List[Tuple[tuple, str]] = []

    def agent(self, addr) -> Any:
        from ray_tpu_torch import api as _api
        from ray_tpu_torch._private.rpc import SyncRpcClient

        addr = tuple(addr)
        w = _api._worker()
        if addr == tuple(w.agent_addr):
            return w.agent
        client = self._agent_clients.get(addr)
        if client is None:
            client = SyncRpcClient(addr[0], addr[1], w._io,
                                   label=f"dag-agent-{addr[1]}")
            self._agent_clients[addr] = client
        return client

    def create(self, spec: ch.ChannelSpec) -> None:
        """Allocate the slot on the writer node and a mirror on every
        distinct reader node."""
        for node_id in dict.fromkeys([spec.writer_node]
                                     + spec.reader_nodes):
            agent = self.agent(spec.nodes[node_id]["agent"])
            agent.call("channel_create", oid=spec.oid,
                       size=spec.total_size(),
                       header=spec.header_wire())
            self._created.append(
                (tuple(spec.nodes[node_id]["agent"]), spec.oid))

    def oids(self) -> List[str]:
        return [oid for _addr, oid in self._created]

    def for_each_slot(self, fn) -> None:
        for addr, oid in self._created:
            try:
                fn(self.agent(addr), oid)
            except Exception:
                pass

    def poison_all(self, error_bytes: bytes = b"",
                   close_only: bool = False) -> None:
        self.for_each_slot(lambda agent, oid: agent.call(
            "channel_poison", oid=oid, error=error_bytes,
            close_only=close_only))

    def destroy_all(self) -> None:
        self.for_each_slot(lambda agent, oid: agent.call(
            "channel_destroy", oid=oid))
        self._created.clear()

    def close(self) -> None:
        for client in self._agent_clients.values():
            try:
                client.close()
            except Exception:
                pass
        self._agent_clients.clear()


class CompiledDAGRef:
    """Result handle for one ``execute()``: reads the output channel
    version instead of resolving an object ref.  ``get()`` may be
    called more than once (the value is cached) and out of submission
    order (earlier versions are read through and cached on the DAG)."""

    __slots__ = ("_dag", "seq", "_value", "_have")

    def __init__(self, dag: "CompiledGraph", seq: int):
        self._dag = dag
        self.seq = seq
        self._value = None
        self._have = False

    def get(self, timeout: Optional[float] = None):
        if not self._have:
            self._value = self._dag._result(self.seq, timeout)
            self._have = True
        return self._value

    def __repr__(self):
        return f"CompiledDAGRef(seq={self.seq})"


class CompiledGraph:
    """A frozen actor-method DAG replayed over pre-allocated channels.

    Build with ``dag.experimental_compile(use_channels=True)``.  Only
    actor-method graphs compile (ClassMethodNodes over ClassNodes, plus
    an optional InputNode and a MultiOutputNode root); task
    (FunctionNode) graphs keep using dynamic execution or the dynamic
    :class:`~ray_tpu_torch.dag.compiled.CompiledDAG`.
    """

    def __init__(self, root: DAGNode, max_in_flight: int = 8,
                 buffer_size_bytes: Optional[int] = None,
                 compile_timeout: float = 120.0):
        from ray_tpu_torch._private.config import config

        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self._root = root
        self._max_in_flight = max_in_flight
        self._buffer = int(buffer_size_bytes
                           or config.dag_channel_buffer_bytes)
        self._dag_id = uuid.uuid4().hex[:12]
        self._torn_down = False
        self._teardown_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._next_seq = 1
        self._exec_started: Dict[int, float] = {}
        self._out_cache: Dict[int, Any] = {}
        self._channels = ChannelHost()
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._in_writer: Optional[ch.ChannelWriter] = None
        self._loop_refs: Dict[int, Any] = {}
        self._plan(root)
        try:
            self._setup(compile_timeout)
        except BaseException:
            # half-built pipelines must not leak pinned slots or actors
            try:
                self.teardown(timeout=5.0)
            except Exception:
                pass
            raise

    # ------------------------------------------------------------- planning

    def _plan(self, root: DAGNode) -> None:
        order = root.topological()
        inputs = [n for n in order if isinstance(n, InputNode)]
        if len(inputs) > 1:
            raise ValueError("a DAG can reference at most one InputNode")
        self._input_node = inputs[0] if inputs else None

        # actors and their constructor dependencies resolve ONCE at
        # compile (same plan-memo rule as the dynamic CompiledDAG)
        self._plan_memo: Dict[int, Any] = {}
        self._actors: Dict[int, Any] = {}       # id(ClassNode) -> handle
        self._class_nodes: Dict[int, ClassNode] = {}
        ctor_nodes: set = set()
        for node in order:
            if isinstance(node, ClassNode):
                for dep in node.topological():
                    ctor_nodes.add(id(dep))
                    if id(dep) not in self._plan_memo:
                        if isinstance(dep, (InputNode, InputAttributeNode,
                                            MultiOutputNode)):
                            raise ValueError(
                                "actor constructor args cannot depend on "
                                "the runtime input")
                        self._plan_memo[id(dep)] = dep._apply(
                            self._plan_memo, (), {})
                self._actors[id(node)] = self._plan_memo[id(node)]
                self._class_nodes[id(node)] = node

        self._method_nodes: List[ClassMethodNode] = []
        for node in order:
            if isinstance(node, ClassMethodNode) \
                    and id(node) not in ctor_nodes:
                self._method_nodes.append(node)
            elif isinstance(node, FunctionNode) and id(node) not in ctor_nodes:
                raise ValueError(
                    "channel-compiled DAGs support actor-method graphs "
                    "only; FunctionNode tasks need dynamic execute() or "
                    "experimental_compile() without use_channels")
        if not self._method_nodes:
            raise ValueError("nothing to compile: the DAG has no actor "
                             "method calls")
        terminal = (root._outputs if isinstance(root, MultiOutputNode)
                    else [root])
        for leaf in terminal:
            if not isinstance(leaf, ClassMethodNode):
                raise ValueError(
                    "compiled-graph outputs must be actor method calls")
        self._terminal = terminal
        self._multi_output = isinstance(root, MultiOutputNode)

        # node keys + per-actor step lists (topological order per actor)
        self._node_key = {id(n): f"n{i}" for i, n in
                          enumerate(self._method_nodes)}
        steps_of: Dict[int, List[ClassMethodNode]] = {}
        for node in self._method_nodes:
            steps_of.setdefault(id(node._cls_node), []).append(node)
        self._steps_of = steps_of

        # cross-process consumers of each method node
        consumers: Dict[int, set] = {id(n): set() for n in self._method_nodes}
        self._uses_input: Dict[int, bool] = {}
        for node in self._method_nodes:
            aid = id(node._cls_node)
            uses_input = False
            for dep in node._children():
                if isinstance(dep, (InputNode, InputAttributeNode)):
                    uses_input = True
                elif isinstance(dep, ClassMethodNode) \
                        and id(dep) not in ctor_nodes \
                        and id(dep._cls_node) != aid:
                    consumers[id(dep)].add(aid)
            self._uses_input[aid] = self._uses_input.get(aid, False) \
                or uses_input
        self._consumers = consumers

        # channels: one per method node with a cross-process reader
        # ("driver" marks the driver as a reader); plus the input channel
        self._channel_readers: Dict[int, List[Any]] = {}
        for node in self._method_nodes:
            readers = sorted(consumers[id(node)], key=lambda a: str(a))
            if node in terminal:
                readers = readers + ["driver"]
            if readers:
                self._channel_readers[id(node)] = readers
        # actors with no channel inputs still need a per-execute trigger:
        # they subscribe to the driver's input channel as a tick
        input_readers: List[Any] = []
        for aid in steps_of:
            has_chan_input = any(
                aid in consumers[id(n)] for n in self._method_nodes)
            if self._uses_input.get(aid) or not has_chan_input:
                input_readers.append(aid)
        self._input_readers = sorted(input_readers, key=lambda a: str(a))

    # -------------------------------------------------------------- setup

    def _agent(self, addr) -> Any:
        return self._channels.agent(addr)

    def _setup(self, timeout: float) -> None:
        import ray_tpu_torch
        from ray_tpu_torch import api as _api

        w = _api._worker()
        # 1. where does everybody live?
        info_refs = {aid: w.submit_actor_task(
            handle._actor_id, DAG_INFO_METHOD, (), {})[0]
            for aid, handle in self._actors.items()
            if aid in self._steps_of}
        infos = dict(zip(info_refs,
                         ray_tpu_torch.get(list(info_refs.values()),
                                     timeout=timeout)))
        try:
            xfer_port = int(w.agent.call("node_info").get("xfer_port") or 0)
        except Exception:
            xfer_port = 0
        driver_info = {"node_id": w.node_id, "agent": list(w.agent_addr),
                       "xfer_port": xfer_port}
        self._node_info = {"driver": driver_info,
                           **{aid: infos[aid] for aid in infos}}

        def node_of(entity) -> str:
            return self._node_info[entity]["node_id"]

        node_table = {info["node_id"]: {"agent": info["agent"],
                                        "xfer_port": info["xfer_port"]}
                      for info in self._node_info.values()}

        # 2. channel specs (per-channel ring overrides from
        #    node.with_channel_options win over the compile-wide sizes)
        def make_spec(name: str, writer_entity, reader_entities,
                      opts: Optional[Dict[str, int]] = None
                      ) -> ch.ChannelSpec:
            opts = opts or {}
            wnode = node_of(writer_entity)
            rnodes = [node_of(r) for r in reader_entities]
            involved = dict.fromkeys([wnode] + rnodes)
            return ch.ChannelSpec(
                oid=f"dagch-{self._dag_id}-{name}",
                max_in_flight=int(opts.get("max_in_flight")
                                  or self._max_in_flight),
                slot_size=int(opts.get("buffer_size_bytes")
                              or self._buffer),
                n_readers=len(reader_entities),
                writer_node=wnode, reader_nodes=rnodes,
                nodes={nid: node_table[nid] for nid in involved})

        self._input_spec = make_spec(
            "in", "driver", self._input_readers,
            getattr(self._input_node, "_channel_opts", None))
        self._out_specs: Dict[int, ch.ChannelSpec] = {}
        for nid, readers in self._channel_readers.items():
            node = next(n for n in self._method_nodes if id(n) == nid)
            self._out_specs[nid] = make_spec(
                self._node_key[nid], id_to_actor(nid, self), readers,
                node._channel_opts)

        # 3. allocate slots (writer node) and mirrors (reader nodes)
        for spec in [self._input_spec] + list(self._out_specs.values()):
            self._channels.create(spec)
        _register_live_channels(id(self), self._channels.oids())

        # 4. driver-side endpoints
        self._in_writer = ch.ChannelWriter(self._input_spec)
        self._out_readers: List[Tuple[int, ch.ChannelReader]] = []
        for leaf in self._terminal:
            spec = self._out_specs[id(leaf)]
            idx = spec_reader_index(spec, self._channel_readers[id(leaf)],
                                    "driver")
            self._out_readers.append(
                (id(leaf), ch.ChannelReader(spec, idx)))

        # 5. install the pinned loops
        for aid, steps in self._steps_of.items():
            plan = self._actor_plan(aid, steps)
            handle = self._actors[aid]
            self._loop_refs[aid] = w.submit_actor_task(
                handle._actor_id, DAG_EXEC_METHOD, (plan,), {})[0]

        # 6. death watch
        self._monitor = threading.Thread(
            target=self._monitor_loop, name=f"rt-dag-monitor-{self._dag_id}",
            daemon=True)
        self._monitor.start()

    def _actor_plan(self, aid: int, steps: List[ClassMethodNode]) -> Dict:
        import dataclasses

        inputs = []
        if aid in self._input_readers:
            inputs.append({
                "spec": dataclasses.asdict(self._input_spec),
                "index": spec_reader_index(self._input_spec,
                                           self._input_readers, aid),
                "key": _INPUT_KEY})
        seen_chan = set()
        for node in steps:
            for dep in node._children():
                if isinstance(dep, ClassMethodNode) \
                        and id(dep) in self._out_specs \
                        and id(dep._cls_node) != aid \
                        and id(dep) not in seen_chan:
                    seen_chan.add(id(dep))
                    spec = self._out_specs[id(dep)]
                    inputs.append({
                        "spec": dataclasses.asdict(spec),
                        "index": spec_reader_index(
                            spec, self._channel_readers[id(dep)], aid),
                        "key": self._node_key[id(dep)]})
        outputs = [{"spec": dataclasses.asdict(self._out_specs[id(n)]),
                    "key": self._node_key[id(n)]}
                   for n in steps if id(n) in self._out_specs]
        plan_steps = []
        for node in steps:
            args_t = _map_args(list(node._bound_args[0:]),
                               lambda d: self._arg_ref(d, aid))
            kwargs_t = _map_args(dict(node._bound_kwargs),
                                 lambda d: self._arg_ref(d, aid))
            plan_steps.append({"key": self._node_key[id(node)],
                               "method": node._method,
                               "args": tuple(args_t), "kwargs": kwargs_t})
        return {"dag_id": self._dag_id, "inputs": inputs,
                "outputs": outputs, "steps": plan_steps}

    def _arg_ref(self, dep: DAGNode, aid: int):
        if isinstance(dep, InputNode):
            return _ArgRef("input")
        if isinstance(dep, InputAttributeNode):
            return _ArgRef("input_attr", (dep._kind, dep._key))
        if isinstance(dep, ClassMethodNode) and id(dep) in self._node_key:
            return _ArgRef("node", self._node_key[id(dep)])
        if isinstance(dep, ClassNode) and id(dep) in self._actors:
            return self._actors[id(dep)]  # resolved handle as a constant
        if id(dep) in self._plan_memo:
            return self._plan_memo[id(dep)]  # compile-time constant
        raise ValueError(f"unsupported dependency {type(dep).__name__} "
                         "in a channel-compiled DAG")

    # ------------------------------------------------------------ execution

    def _check_failure(self) -> None:
        if self._error is not None:
            raise self._error
        if self._torn_down:
            raise RayError("this CompiledGraph has been torn down")

    def execute(self, *input_args) -> CompiledDAGRef:
        """Write the input channel; returns a :class:`CompiledDAGRef`
        reading the output channel.  Bounded: at most ``max_in_flight``
        executes may be outstanding (un-``get``) at once."""
        from ray_tpu_torch._private import tracing
        from ray_tpu_torch._private.metrics import dag_metrics

        self._check_failure()
        if self._input_node is not None:
            if len(input_args) != 1:
                raise TypeError(f"this DAG expects exactly one input, "
                                f"got {len(input_args)}")
            value = input_args[0]
        else:
            if input_args:
                raise TypeError("this DAG takes no input")
            value = None
        delivered = min(r.consumed for _nid, r in self._out_readers)
        if self._next_seq - delivered > self._max_in_flight:
            raise RayError(
                f"cannot execute: {self._max_in_flight} results are "
                "already in flight — get() them before submitting more, "
                "or compile with a larger max_in_flight")
        span = tracing.start_span("dag.execute", kind=tracing.KIND_CLIENT)
        seq = self._next_seq
        try:
            self._in_writer.write(value, check=self._check_failure)
        except BaseException as e:
            if span is not None:
                span.end(error=f"{type(e).__name__}: {e}")
            raise
        self._next_seq = seq + 1
        self._exec_started[seq] = time.perf_counter()
        if span is not None:
            span.set_attribute("dag_id", self._dag_id)
            span.set_attribute("seq", seq)
            span.end()
        dag_metrics()[1].inc(tags={"op": "execute"})
        return CompiledDAGRef(self, seq)

    def _result(self, seq: int, timeout: Optional[float]):
        from ray_tpu_torch._private import tracing
        from ray_tpu_torch._private.metrics import dag_metrics

        if seq in self._out_cache:
            return self._finish(seq, self._out_cache[seq])
        if seq >= self._next_seq:
            raise ValueError(f"no execution with seq {seq}")
        deadline = None if timeout is None else time.monotonic() + timeout
        span = tracing.start_span("dag.get", kind=tracing.KIND_CLIENT)
        try:
            while True:
                done = min(r.consumed for _nid, r in self._out_readers)
                if done >= seq:
                    break
                want = done + 1
                values = []
                for _nid, reader in self._out_readers:
                    left = None if deadline is None \
                        else max(0.0, deadline - time.monotonic())
                    values.append(reader.read(
                        want, timeout=left, check=self._check_failure,
                        copy=True))
                    reader.advance(want)
                self._out_cache[want] = values
                if len(self._out_cache) > 2 * self._max_in_flight:
                    self._out_cache.pop(min(self._out_cache))
        except BaseException as e:
            if span is not None:
                span.end(error=f"{type(e).__name__}: {e}")
            raise
        if span is not None:
            span.set_attribute("dag_id", self._dag_id)
            span.set_attribute("seq", seq)
            span.end()
        t0 = self._exec_started.pop(seq, None)
        if t0 is not None:
            dag_metrics()[0].observe(time.perf_counter() - t0)
        values = self._out_cache.get(seq)
        if values is None:
            raise RayError(
                f"result for execution {seq} was evicted from the "
                "out-of-order cache (too many un-got CompiledDAGRefs)")
        return self._finish(seq, values)

    def _finish(self, seq: int, values: List[Tuple[Any, bool]]):
        # error results stay cached so a retried get() re-raises the
        # original exception instead of a misleading eviction error
        for value, is_err in values:
            if is_err:
                raise value
        self._out_cache.pop(seq, None)
        out = [v for v, _err in values]
        return out if self._multi_output else out[0]

    # ---------------------------------------------------------- death watch

    def _monitor_loop(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch._private.config import config

        interval = float(config.dag_monitor_interval_s)
        refs = list(self._loop_refs.values())
        while refs and not self._monitor_stop.is_set():
            try:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=interval)
            except Exception:
                return  # worker shut down under us
            if self._torn_down or self._monitor_stop.is_set():
                return
            for ref in ready:
                try:
                    ray_tpu_torch.get(ref, timeout=0)
                except Exception as e:  # noqa: BLE001 — loop death
                    self._fail(e if isinstance(e, RayError) else
                               ActorDiedError(f"compiled-DAG actor loop "
                                              f"failed: {e}"))
                    return
                refs.remove(ref)  # clean exit (teardown elsewhere)

    def _fail(self, error: BaseException) -> None:
        """Poison every channel on every involved node so all blocked
        readers/writers (driver and actors) raise promptly."""
        if self._error is not None:
            return
        self._error = error
        self._channels.poison_all(ch.pickle_error(error))

    # ------------------------------------------------------------- teardown

    def teardown(self, timeout: Optional[float] = None) -> None:
        """Synchronous, idempotent: close channels, drain loops, kill and
        wait out the plan's actors, free the pinned slots."""
        import ray_tpu_torch
        from ray_tpu_torch import api as _api
        from ray_tpu_torch._private.config import config

        with self._teardown_lock:
            if self._torn_down:
                return
            self._torn_down = True
        # this graph no longer claims its slots: if the destroys below
        # fail, the accounting layer flags them leaked (correctly)
        _unregister_live_channels(id(self))
        self._monitor_stop.set()
        timeout = (float(config.dag_teardown_timeout_s)
                   if timeout is None else timeout)
        deadline = time.monotonic() + timeout
        # 1. wake every loop: close all channels everywhere
        self._channels.poison_all(close_only=True)
        # 2. loops drain and return; a wedged loop is force-killed so
        #    teardown stays bounded
        refs = list(self._loop_refs.values())
        if refs:
            ready, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs),
                timeout=max(0.1, deadline - time.monotonic()))
            for ref in pending:
                try:
                    ray_tpu_torch.cancel(ref, force=True)
                except Exception:
                    pass
        # 3. kill the compiled plan's actors and wait for death
        for handle in self._actors.values():
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass
        w = _api._worker()
        for handle in self._actors.values():
            while time.monotonic() < deadline:
                try:
                    info = w.head.call("get_actor_info",
                                       actor_id=handle._actor_id)
                except Exception:
                    break
                if info.get("state") == "DEAD":
                    break
                time.sleep(0.05)
        self._actors.clear()
        # 4. free the pinned slots
        self._channels.destroy_all()
        if self._in_writer is not None:
            self._in_writer.detach()
        self._channels.close()
        if self._monitor is not None \
                and self._monitor is not threading.current_thread():
            self._monitor.join(timeout=1.0)

    def __del__(self):
        try:
            if not self._torn_down:
                self.teardown(timeout=2.0)
        except Exception:
            pass


def spec_reader_index(spec: ch.ChannelSpec, readers: List[Any],
                      entity) -> int:
    return readers.index(entity)


def id_to_actor(nid: int, dag: CompiledGraph) -> int:
    """The actor (ClassNode id) that owns method node `nid`."""
    for node in dag._method_nodes:
        if id(node) == nid:
            return id(node._cls_node)
    raise KeyError(nid)
