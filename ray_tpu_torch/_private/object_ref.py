"""ObjectRef: the user-facing future/handle to a distributed object.

Equivalent of the reference's ObjectRef
(reference: python/ray/includes/object_ref.pxi, ownership semantics in
src/ray/core_worker/reference_count.h): a ref pins the object while any
Python reference exists; serializing a ref into task args or other
objects transfers a *borrow* which is registered with the owner on
deserialization.

Pickling protocol: `__reduce__` routes through `_deserialize_ref`, which
(a) registers the materializing process as a borrower with the owner and
(b) reports the ref into the active serialization context so a submitter
can pin args until the task completes.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

_ctx = threading.local()


class SerializationContext:
    """Collects ObjectRefs encountered while (de)serializing a value."""

    def __init__(self):
        self.refs: List["ObjectRef"] = []

    def __enter__(self):
        stack = getattr(_ctx, "stack", None)
        if stack is None:
            stack = _ctx.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _ctx.stack.pop()

    @staticmethod
    def current() -> Optional["SerializationContext"]:
        stack = getattr(_ctx, "stack", None)
        return stack[-1] if stack else None


class ObjectRef:
    __slots__ = ("_oid", "_owner_addr", "_node_addr", "_worker", "__weakref__")

    def __init__(self, oid: str, owner_addr: Optional[Tuple[str, int]] = None,
                 node_addr: Optional[Tuple[str, int]] = None,
                 _register: bool = True):
        self._oid = oid
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._node_addr = tuple(node_addr) if node_addr else None
        self._worker = None
        if _register:
            from ray_tpu_torch._private.worker import global_worker_or_none

            w = global_worker_or_none()
            if w is not None:
                self._worker = w
                w.register_local_ref(self)

    @property
    def oid(self) -> str:
        return self._oid

    @property
    def owner_addr(self) -> Optional[Tuple[str, int]]:
        return self._owner_addr

    @property
    def node_addr(self) -> Optional[Tuple[str, int]]:
        return self._node_addr

    def hex(self) -> str:
        return self._oid

    def __reduce__(self):
        ctx = SerializationContext.current()
        if ctx is not None:
            ctx.refs.append(self)
        return (_deserialize_ref, (self._oid, self._owner_addr, self._node_addr))

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._oid == self._oid

    def __hash__(self):
        return hash(self._oid)

    def __repr__(self):
        return f"ObjectRef({self._oid[:16]}…)"

    def __del__(self):
        w = self._worker
        if w is not None:
            try:
                w.unregister_local_ref(self)
            except Exception:
                pass

    # Direct (sync) iteration stays blocked so a for-loop over a ref
    # fails loudly; `await ref` resolves through the owner-loop
    # completion path (worker.get_async) without parking a thread.
    def __iter__(self):
        raise TypeError(
            "ObjectRef is not iterable; use ray_tpu_torch.get(ref) to fetch the value")

    async def _resolve_async(self):
        from ray_tpu_torch._private.worker import global_worker_or_none

        w = self._worker or global_worker_or_none()
        if w is None:
            raise RuntimeError(
                "ray_tpu is not initialized; cannot await an ObjectRef")
        return (await w.get_async([self]))[0]

    def __await__(self):
        return self._resolve_async().__await__()

    def future(self):
        """Schedule resolution on the running event loop; returns an
        asyncio.Task resolving to the value (reference: ObjectRef.future
        / as_future in the asyncio integration).  Must be called from a
        coroutine or loop callback."""
        import asyncio

        return asyncio.ensure_future(self._resolve_async())


def _deserialize_ref(oid: str, owner_addr, node_addr) -> ObjectRef:
    ref = ObjectRef(oid, owner_addr, node_addr)
    ctx = SerializationContext.current()
    if ctx is not None:
        ctx.refs.append(ref)
    return ref
