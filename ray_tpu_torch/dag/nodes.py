"""DAG node types and the dynamic (uncompiled) executor.

A DAG is built driver-side from ``.bind()`` calls and executed either
dynamically — every node becomes a regular task/actor call, refs flow as
arguments — or through ``CompiledDAG`` (compiled.py) which pre-resolves
the actor call chain once and replays it per input.

Reference: python/ray/dag/dag_node.py:1 (DAGNode + traversal),
function_node.py (FunctionNode), class_node.py (ClassNode /
ClassMethodNode), input_node.py (InputNode context manager).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


def _map_args(obj, fn):
    """Apply fn to every DAGNode inside (nested) args structures."""
    if isinstance(obj, DAGNode):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_args(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {k: _map_args(v, fn) for k, v in obj.items()}
    return obj


def _collect_children(args: tuple, kwargs: dict) -> List["DAGNode"]:
    out: List[DAGNode] = []

    def visit(node):
        out.append(node)
        return node

    _map_args(list(args), visit)
    _map_args(dict(kwargs), visit)
    return out


class DAGNode:
    """Base: an operation plus (possibly nested) upstream dependencies."""

    def __init__(self, args: tuple = (), kwargs: Optional[dict] = None):
        self._bound_args = args
        self._bound_kwargs = kwargs or {}
        self._channel_opts: Dict[str, int] = {}

    def with_channel_options(self, *, max_in_flight: Optional[int] = None,
                             buffer_size_bytes: Optional[int] = None
                             ) -> "DAGNode":
        """Per-channel ring overrides for channel-compiled execution.

        On a ClassMethodNode this sizes the node's OUTPUT channel; on an
        InputNode, the driver's input channel.  Unset fields inherit the
        compile-wide ``max_in_flight`` / ``buffer_size_bytes`` — so one
        deep edge (e.g. pipeline activations) can coexist with shallow
        control edges without raising the global ring size.  Returns
        ``self`` for chaining; ignored by dynamic execution."""
        if max_in_flight is not None:
            if max_in_flight < 1:
                raise ValueError("max_in_flight must be >= 1")
            self._channel_opts["max_in_flight"] = int(max_in_flight)
        if buffer_size_bytes is not None:
            if buffer_size_bytes < 1:
                raise ValueError("buffer_size_bytes must be >= 1")
            self._channel_opts["buffer_size_bytes"] = int(buffer_size_bytes)
        return self

    # ------------------------------------------------------------- traversal

    def _children(self) -> List["DAGNode"]:
        return _collect_children(self._bound_args, self._bound_kwargs)

    def topological(self) -> List["DAGNode"]:
        """All reachable nodes, dependencies before dependents, in a
        deterministic order (stable across processes for the same DAG —
        workflow step keys rely on this)."""
        order: List[DAGNode] = []
        seen = set()

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen.add(id(node))
            for child in node._children():
                visit(child)
            order.append(node)

        visit(self)
        return order

    # ------------------------------------------------------------- execution

    def execute(self, *input_args, **input_kwargs):
        """Run the DAG dynamically; returns the root's ObjectRef (or a
        list for MultiOutputNode).  Each call creates fresh tasks; actors
        in the DAG are created once per execute."""
        import weakref

        memo: Dict[int, Any] = {}
        order = self.topological()
        for node in order:
            memo[id(node)] = node._apply(memo, input_args, input_kwargs)
        out = memo[id(self)]
        # actors created for this execute must outlive the returned refs:
        # an owning ActorHandle kills its actor on GC, which would fail
        # still-running method tasks.  finalize() pins the handles to the
        # result refs' lifetime.
        handles = [memo[id(n)] for n in order if isinstance(n, ClassNode)]
        if handles:
            for ref in (out if isinstance(out, list) else [out]):
                weakref.finalize(ref, lambda _h: None, tuple(handles))
        return out

    def _apply(self, memo, input_args, input_kwargs):
        raise NotImplementedError

    def _resolved_args(self, memo) -> Tuple[tuple, dict]:
        args = _map_args(list(self._bound_args), lambda n: memo[id(n)])
        kwargs = _map_args(dict(self._bound_kwargs), lambda n: memo[id(n)])
        return tuple(args), kwargs

    # --------------------------------------------------------------- compile

    def experimental_compile(self, max_in_flight: int = 8,
                             use_channels: bool = False,
                             buffer_size_bytes: Optional[int] = None):
        """Freeze this DAG into a replayable plan.

        ``use_channels=False`` (default) returns the dynamic
        :class:`~ray_tpu_torch.dag.compiled.CompiledDAG`: actors are created
        once, but every ``execute()`` still submits real tasks.

        ``use_channels=True`` returns a
        :class:`~ray_tpu_torch.dag.execution.CompiledGraph`: actor-method
        graphs replay over pre-allocated mutable shm channels with a
        pinned per-actor execution loop — no per-call task submission,
        scheduling, or object refs (``execute()`` hands back a
        ``CompiledDAGRef``; call ``.get()`` on it, not ``ray_tpu_torch.get``).
        ``buffer_size_bytes`` overrides the per-version channel payload
        capacity (config ``dag_channel_buffer_bytes``)."""
        if use_channels:
            from ray_tpu_torch.dag.execution import CompiledGraph

            return CompiledGraph(self, max_in_flight=max_in_flight,
                                 buffer_size_bytes=buffer_size_bytes)
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, max_in_flight=max_in_flight)


class InputNode(DAGNode):
    """Placeholder for the runtime input, usable as a context manager:

        with InputNode() as inp:
            dag = f.bind(inp)
        dag.execute(5)
    """

    _tls = threading.local()

    def __init__(self):
        super().__init__()
        self._attrs: Dict[Any, InputAttributeNode] = {}

    def __enter__(self):
        if getattr(self._tls, "active", None) is not None:
            raise RuntimeError("InputNode contexts cannot nest")
        self._tls.active = self
        return self

    def __exit__(self, *exc):
        self._tls.active = None

    def __getitem__(self, key) -> "InputAttributeNode":
        if key not in self._attrs:
            self._attrs[key] = InputAttributeNode(self, key, kind="item")
        return self._attrs[key]

    def __getattr__(self, name) -> "InputAttributeNode":
        if name.startswith("_"):
            raise AttributeError(name)
        key = ("attr", name)
        if key not in self._attrs:
            self._attrs[key] = InputAttributeNode(self, name, kind="attr")
        return self._attrs[key]

    def _apply(self, memo, input_args, input_kwargs):
        if input_kwargs:
            raise TypeError("InputNode DAGs take positional input only; "
                            "use inp.key for structured inputs")
        if len(input_args) != 1:
            raise TypeError(
                f"this DAG expects exactly one input, got {len(input_args)}")
        return input_args[0]


class InputAttributeNode(DAGNode):
    """``inp[0]`` / ``inp.field`` — projects part of the runtime input."""

    def __init__(self, parent: InputNode, key, kind: str):
        super().__init__(args=(parent,))
        self._key = key
        self._kind = kind

    def _apply(self, memo, input_args, input_kwargs):
        value = memo[id(self._bound_args[0])]
        if self._kind == "attr":
            return getattr(value, self._key)
        return value[self._key]


class FunctionNode(DAGNode):
    """``remote_fn.bind(...)`` — a task invocation."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    @property
    def name(self) -> str:
        return self._remote_fn._name

    def _apply(self, memo, input_args, input_kwargs):
        args, kwargs = self._resolved_args(memo)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """``ActorCls.bind(...)`` — an actor to be created at execute time.
    Method bind on a ClassNode yields ClassMethodNodes sharing the
    actor instance within one execute."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _UnboundMethod(self, name)

    def _apply(self, memo, input_args, input_kwargs):
        args, kwargs = self._resolved_args(memo)
        return self._actor_cls.remote(*args, **kwargs)


class _UnboundMethod:
    def __init__(self, cls_node: ClassNode, method: str):
        self._cls_node = cls_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._cls_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    """``actor_node.method.bind(...)`` — an actor method invocation."""

    def __init__(self, cls_node: ClassNode, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._cls_node = cls_node
        self._method = method

    @property
    def name(self) -> str:
        return f"{self._cls_node._actor_cls._cls.__name__}.{self._method}"

    def _children(self):
        return [self._cls_node] + super()._children()

    def _apply(self, memo, input_args, input_kwargs):
        handle = memo[id(self._cls_node)]
        args, kwargs = self._resolved_args(memo)
        return getattr(handle, self._method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Terminal node returning several leaves: execute() -> list of refs."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(args=(tuple(outputs),))
        self._outputs = list(outputs)

    def _apply(self, memo, input_args, input_kwargs):
        return [memo[id(n)] for n in self._outputs]
