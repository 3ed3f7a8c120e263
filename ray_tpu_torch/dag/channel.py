"""Mutable shared-memory channels for compiled DAG execution.

Equivalent role to the reference's accelerated-DAG channels
(reference: python/ray/experimental/channel/shared_memory_channel.py):
a single-writer / multi-reader mutable slot, allocated ONCE at compile
time and reused for every ``execute()``, so the steady state pays zero
object creation, zero scheduler visits, and zero control RPCs per hop.

Layout — one pre-allocated, permanently pinned shm slot holding a
seq-numbered ring of ``max_in_flight`` versions:

    header:
      [u64 magic][u64 flags][u64 max_in_flight][u64 slot_size]
      [u64 n_readers][u64 write_seq][u64 error_len]
      [error region: ERROR_CAP bytes]          (poison payload)
      [cursors: n_readers x u64]               (last seq consumed)
    ring (64-aligned), max_in_flight slots of stride align64(24+slot_size):
      [u64 seq][u64 length][u64 vflags][payload...]

The writer publishes version ``seq`` by writing the payload + version
header into ring slot ``(seq-1) % max_in_flight`` and THEN storing the
header's ``write_seq`` word (an aligned 8-byte store; readers that catch
a torn intermediate state re-validate against the slot's own seq word
and keep polling).  Readers are fan-out: every reader consumes every
version, in order, and advertises progress through its cursor word.
The writer blocks (bounded ring backpressure) until every reader's
cursor clears the slot it is about to overwrite — versions are never
dropped.

Remote readers: the writer knows its reader set at compile time, so
versions are PUSHED — the writer writes the version bytes straight into
the reader node's mirror slot over the PR-4 bulk transfer plane (a
write-flagged range request on the same raw-stream protocol; see
object_transfer.py), then pushes the 8-byte ``write_seq`` word.  No pull
round-trip exists on the data path.  When the bulk plane is unavailable
(no listener, filtered port) the writer falls back to the compat
control-RPC path (``channel_write`` on the reader's node agent), which
is also how agents without a transfer plane interoperate.

Error model: a version can carry ``VF_ERROR`` (payload = pickled
exception) — readers surface it as a value-level error the executor
forwards downstream.  Whole-channel failure (actor death) POISONS the
slot: the flags word plus a pickled exception in the error region; every
blocked reader and writer wakes and raises it.  ``CLOSED`` is the clean
variant used by teardown.
"""

from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private.errors import RayError

MAGIC = 0x0052544348414E31  # "RTCHAN1"

# header offsets
_OFF_MAGIC = 0
_OFF_FLAGS = 8
_OFF_MIF = 16
_OFF_SLOT = 24
_OFF_NREADERS = 32
OFF_SEQ = 40          # published write_seq (pushed to mirrors per version)
_OFF_ERRLEN = 48
_OFF_ERR = 56

FLAG_CLOSED = 1
FLAG_POISONED = 2

VF_ERROR = 1  # version payload is a pickled exception

ERROR_CAP = 16384  # poison-payload region size (fixed across the fleet)

_ALIGN = 64
_VHDR = 24  # per-version header: seq, length, vflags


class ChannelError(RayError):
    pass


class ChannelClosedError(ChannelError):
    """The channel was torn down cleanly; no more versions will arrive."""


class ChannelTimeoutError(ChannelError):
    pass


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _get_u64(view, off: int) -> int:
    return int.from_bytes(view[off:off + 8], "little")


def _put_u64(view, off: int, value: int) -> None:
    view[off:off + 8] = value.to_bytes(8, "little")


@dataclass
class ChannelSpec:
    """Picklable channel descriptor, shared by the driver and every
    participating actor.  The SAME oid names the writer-node slot and
    every reader-node mirror (store entries are per-node)."""

    oid: str
    max_in_flight: int
    slot_size: int                 # payload capacity per version
    n_readers: int
    writer_node: str = ""          # node_id the writer lives on
    reader_nodes: List[str] = field(default_factory=list)  # index -> node_id
    # node_id -> {"agent": [host, port], "xfer_port": int}; covers the
    # writer node and every reader node
    nodes: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    # ---- layout ----------------------------------------------------------

    def cursors_off(self) -> int:
        return _OFF_ERR + ERROR_CAP

    def cursor_off(self, index: int) -> int:
        return self.cursors_off() + 8 * index

    def ring_off(self) -> int:
        return _align(self.cursors_off() + 8 * self.n_readers)

    def stride(self) -> int:
        return _align(_VHDR + self.slot_size)

    def total_size(self) -> int:
        return self.ring_off() + self.max_in_flight * self.stride()

    def slot_off(self, seq: int) -> int:
        return self.ring_off() + ((seq - 1) % self.max_in_flight) * self.stride()

    def header_wire(self) -> Dict[str, int]:
        return {"max_in_flight": self.max_in_flight,
                "slot_size": self.slot_size, "n_readers": self.n_readers,
                "error_cap": ERROR_CAP}


def init_view(view, header: Dict[str, int]) -> None:
    """Initialize a freshly zeroed channel slot's static header fields
    (called on the node that owns the slot, under its store's loop)."""
    _put_u64(view, _OFF_MAGIC, MAGIC)
    _put_u64(view, _OFF_MIF, int(header["max_in_flight"]))
    _put_u64(view, _OFF_SLOT, int(header["slot_size"]))
    _put_u64(view, _OFF_NREADERS, int(header["n_readers"]))


def close_view(view) -> None:
    _put_u64(view, _OFF_FLAGS, _get_u64(view, _OFF_FLAGS) | FLAG_CLOSED)


def poison_view(view, error_bytes: bytes) -> None:
    """Record a pickled exception and wake every blocked party.  The
    error region is written BEFORE the flags word so a reader that
    observes POISONED always finds a complete payload."""
    err = error_bytes[:ERROR_CAP]
    view[_OFF_ERR:_OFF_ERR + len(err)] = err
    _put_u64(view, _OFF_ERRLEN, len(err))
    _put_u64(view, _OFF_FLAGS,
             _get_u64(view, _OFF_FLAGS) | FLAG_POISONED | FLAG_CLOSED)


def pickle_error(exc: BaseException) -> bytes:
    try:
        return cloudpickle.dumps(exc)
    except Exception:
        return cloudpickle.dumps(
            RayError(f"{type(exc).__name__}: {exc}"))


def _raise_poison(view) -> None:
    n = _get_u64(view, _OFF_ERRLEN)
    try:
        exc = pickle.loads(bytes(view[_OFF_ERR:_OFF_ERR + n]))
    except Exception:
        exc = ChannelError("channel poisoned (error payload unreadable)")
    raise exc


# --------------------------------------------------------------------- attach


_io_lock = threading.Lock()
_io_thread = None


def _get_io():
    """An EventLoopThread for RPC fallback clients: the in-process
    worker's IO thread when attached to a cluster, else one lazily
    created module-level thread (channel unit tests, bare agents)."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is not None:
        return w._io
    global _io_thread
    with _io_lock:
        if _io_thread is None:
            from ray_tpu_torch._private.rpc import EventLoopThread

            _io_thread = EventLoopThread(name="rt-dag-channel-io")
        return _io_thread


def attach_local_view(spec: ChannelSpec):
    """Map this process's local copy of the channel slot (writer-node
    slot or reader-node mirror) from the node's shm arena, zero-copy."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is None or getattr(w.plasma, "arena", None) is None:
        raise ChannelError(
            "compiled-graph channels need a local shm arena "
            "(client-mode drivers cannot run channel-compiled DAGs)")
    r = w.agent.call("channel_map", oid=spec.oid)
    if not r.get("found"):
        raise ChannelError(f"channel {spec.oid} not present on this node")
    if r["size"] != spec.total_size():
        raise ChannelError(f"channel {spec.oid} size mismatch")
    off = r["offset"]
    view = w.plasma.arena.view[off:off + r["size"]]
    if _get_u64(view, _OFF_MAGIC) != MAGIC:
        raise ChannelError(f"channel {spec.oid} slot has no channel header")
    return view


# ----------------------------------------------------------------- poll loop


def _poll_step(spins: int) -> int:
    """Adaptive wait: burn a few hundred GIL-released-free spins (the
    common case is a peer publishing within microseconds), then sleep
    with exponential backoff capped by dag_channel_poll_max_s."""
    from ray_tpu_torch._private.config import config

    if spins < 200:
        return spins + 1
    delay = min(20e-6 * (1 << min(spins - 200, 7)),
                float(config.dag_channel_poll_max_s))
    time.sleep(delay)
    return spins + 1


# ------------------------------------------------------------- remote target


class _RemoteTarget:
    """Writer-side forwarder to ONE remote reader node: pushes version
    bytes over the bulk transfer plane, falling back permanently to the
    compat control-RPC path on transport failure, and reads the mirror's
    cursor words for backpressure."""

    def __init__(self, spec: ChannelSpec, node_id: str):
        info = spec.nodes[node_id]
        self.spec = spec
        self.node_id = node_id
        self.agent_addr = tuple(info["agent"])
        self.xfer_port = int(info.get("xfer_port") or 0)
        self.bulk_ok = self.xfer_port > 0
        self._xfer = None
        self._rpc = None

    def _client(self):
        if self._xfer is None:
            from ray_tpu_torch._private.object_transfer import ObjectTransferClient

            self._xfer = ObjectTransferClient(self.agent_addr[0],
                                              self.xfer_port)
        return self._xfer

    def _agent(self):
        if self._rpc is None:
            from ray_tpu_torch._private.rpc import SyncRpcClient

            self._rpc = SyncRpcClient(
                self.agent_addr[0], self.agent_addr[1], _get_io(),
                label=f"dag-ch-{self.agent_addr[1]}")
        return self._rpc

    def push_range(self, offset: int, data) -> None:
        """Write `data` at `offset` of the remote mirror slot."""
        from ray_tpu_torch._private.object_transfer import TransferError

        if self.bulk_ok:
            try:
                self._client().write_range(self.spec.oid, offset, data)
                return
            except (TransferError, OSError):
                # bulk listener unreachable while control RPC works:
                # permanently drop to the compat path for this target
                self.bulk_ok = False
        r = self._agent().call("channel_write", oid=self.spec.oid,
                               offset=offset, data=bytes(data))
        if not r.get("ok"):
            raise ChannelError(
                f"channel {self.spec.oid[:16]} write rejected by "
                f"{self.agent_addr}: {r.get('error')}")

    def push_version(self, view, base: int, length: int) -> None:
        self.push_range(base, view[base:base + length])
        self.push_range(OFF_SEQ, view[OFF_SEQ:OFF_SEQ + 8])

    def read_cursors(self) -> bytes:
        from ray_tpu_torch._private.object_transfer import TransferError

        off = self.spec.cursors_off()
        n = 8 * self.spec.n_readers
        if self.bulk_ok:
            try:
                return bytes(self._client().read_range(self.spec.oid, off, n))
            except (TransferError, OSError):
                self.bulk_ok = False
        r = self._agent().call("channel_read", oid=self.spec.oid,
                               offset=off, length=n)
        if not r.get("ok"):
            raise ChannelError(
                f"channel {self.spec.oid[:16]} cursor read failed: "
                f"{r.get('error')}")
        return bytes(r["data"])

    def close(self) -> None:
        if self._xfer is not None:
            self._xfer.close()
        if self._rpc is not None:
            try:
                self._rpc.close()
            except Exception:
                pass


# -------------------------------------------------------------------- writer


class ChannelWriter:
    """Single writer of a channel.  Not thread-safe (one writer by
    contract).  `view` injection is for node-local tests/agents; normal
    use attaches through the local arena."""

    def __init__(self, spec: ChannelSpec, view=None):
        self.spec = spec
        self._view = view if view is not None else attach_local_view(spec)
        self._seq = _get_u64(self._view, OFF_SEQ)
        self._targets = [
            _RemoteTarget(spec, nid)
            for nid in dict.fromkeys(spec.reader_nodes)
            if nid != spec.writer_node and nid in spec.nodes]
        # reader cursors last fetched from remote mirrors (by index)
        self._remote_cache: Dict[int, int] = {
            i: 0 for i, nid in enumerate(spec.reader_nodes)
            if nid != spec.writer_node}
        self._target_by_node = {t.node_id: t for t in self._targets}

    @property
    def seq(self) -> int:
        return self._seq

    def _check_flags(self) -> None:
        flags = _get_u64(self._view, _OFF_FLAGS)
        if flags & FLAG_POISONED:
            _raise_poison(self._view)
        if flags & FLAG_CLOSED:
            raise ChannelClosedError(
                f"channel {self.spec.oid[:16]} is closed")

    def _min_cursor(self, refresh_remote: bool) -> int:
        if refresh_remote and self._remote_cache:
            for t in self._targets:
                raw = t.read_cursors()
                for i, nid in enumerate(self.spec.reader_nodes):
                    if nid == t.node_id:
                        self._remote_cache[i] = int.from_bytes(
                            raw[8 * i:8 * i + 8], "little")
        lo = None
        for i, nid in enumerate(self.spec.reader_nodes):
            if nid == self.spec.writer_node:
                cur = _get_u64(self._view, self.spec.cursor_off(i))
            else:
                cur = self._remote_cache[i]
            lo = cur if lo is None else min(lo, cur)
        return 0 if lo is None else lo

    def _wait_space(self, seq: int, timeout: Optional[float],
                    check: Optional[Callable[[], None]]) -> None:
        need = seq - self.spec.max_in_flight  # every cursor must reach this
        if need <= 0:
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        refresh = bool(self._remote_cache)
        while True:
            self._check_flags()
            if self._min_cursor(refresh_remote=refresh and spins > 0) >= need:
                return
            if check is not None:
                check()
            if deadline is not None and time.monotonic() >= deadline:
                raise ChannelTimeoutError(
                    f"channel {self.spec.oid[:16]} ring full for "
                    f"{timeout:.3f}s (slow reader; backpressure)")
            spins = _poll_step(spins)

    def write(self, value: Any, *, error: bool = False,
              timeout: Optional[float] = None,
              check: Optional[Callable[[], None]] = None) -> int:
        """Publish the next version; blocks under ring backpressure.
        With error=True, `value` is an exception to serialize into the
        version (readers surface it instead of a value)."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.metrics import (dag_channel_occupancy_gauge,
                                              dag_metrics)

        if error:
            frames = [memoryview(pickle_error(value))]
            total = frames[0].nbytes
            packed = False
        else:
            frames, total = serialization.serialize(value)
            packed = True
        if total > self.spec.slot_size:
            raise ChannelError(
                f"serialized value ({total} B) exceeds the channel slot "
                f"({self.spec.slot_size} B); recompile with a larger "
                f"buffer_size_bytes or raise dag_channel_buffer_bytes")
        seq = self._seq + 1
        self._check_flags()  # closed/poisoned channels reject writes even
        # when the ring has space (wait_space may not poll at all)
        self._wait_space(seq, timeout, check)
        view = self._view
        base = self.spec.slot_off(seq)
        if packed:
            serialization.pack_into(frames, view[base + _VHDR:
                                                 base + _VHDR + total])
        else:
            view[base + _VHDR:base + _VHDR + total] = frames[0]
        _put_u64(view, base + 8, total)
        _put_u64(view, base + 16, VF_ERROR if error else 0)
        _put_u64(view, base, seq)
        _put_u64(view, OFF_SEQ, seq)  # publish: local readers wake now
        self._seq = seq
        for t in self._targets:
            t.push_version(view, base, _VHDR + total)
        dag_metrics()[1].inc(tags={"op": "write"})
        # ring occupancy = published versions the slowest reader hasn't
        # consumed (cached cursors; no remote refresh on the hot path).
        # Pinned at max_in_flight == this stage's readers are the
        # pipeline bottleneck.
        dag_channel_occupancy_gauge().set(
            seq - self._min_cursor(refresh_remote=False),
            tags={"channel": self.spec.oid[:12]})
        return seq

    def close(self, propagate: bool = True) -> None:
        close_view(self._view)
        if propagate:
            for t in self._targets:
                try:
                    t.push_range(_OFF_FLAGS,
                                 self._view[_OFF_FLAGS:_OFF_FLAGS + 8])
                except Exception:
                    pass

    def poison(self, error_bytes: bytes, propagate: bool = True) -> None:
        poison_view(self._view, error_bytes)
        if propagate:
            end = _OFF_ERR + min(len(error_bytes), ERROR_CAP)
            for t in self._targets:
                try:
                    # error region + errlen first, flags last (ordering
                    # within one stream/RPC sequence)
                    t.push_range(_OFF_ERRLEN, self._view[_OFF_ERRLEN:end])
                    t.push_range(_OFF_FLAGS,
                                 self._view[_OFF_FLAGS:_OFF_FLAGS + 8])
                except Exception:
                    pass

    def detach(self) -> None:
        for t in self._targets:
            t.close()


# -------------------------------------------------------------------- reader


class ChannelReader:
    """One fan-out reader of a channel; reads versions strictly in
    order.  `advance(seq)` releases the slot back to the writer — call
    it only once the read value is no longer needed (zero-copy reads
    alias the ring memory)."""

    def __init__(self, spec: ChannelSpec, index: int, view=None):
        if not (0 <= index < spec.n_readers):
            raise ValueError(f"reader index {index} out of range")
        self.spec = spec
        self.index = index
        self._view = view if view is not None else attach_local_view(spec)
        self.consumed = _get_u64(self._view, spec.cursor_off(index))

    @property
    def next_seq(self) -> int:
        return self.consumed + 1

    def read(self, seq: int, timeout: Optional[float] = None,
             check: Optional[Callable[[], None]] = None,
             copy: bool = False) -> Tuple[Any, bool]:
        """Block until version `seq` is published; returns (value,
        is_error).  copy=True detaches the payload from the ring before
        deserializing (driver-side reads, where the value escapes to
        user code that may outlive the slot)."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.metrics import dag_metrics

        view = self._view
        spec = self.spec
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        base = spec.slot_off(seq)
        while True:
            if _get_u64(view, OFF_SEQ) >= seq \
                    and _get_u64(view, base) == seq:
                break
            flags = _get_u64(view, _OFF_FLAGS)
            if flags & FLAG_POISONED:
                _raise_poison(view)
            if flags & FLAG_CLOSED and _get_u64(view, OFF_SEQ) < seq:
                raise ChannelClosedError(
                    f"channel {spec.oid[:16]} closed before version {seq}")
            if check is not None:
                check()
            if deadline is not None and time.monotonic() >= deadline:
                raise ChannelTimeoutError(
                    f"timed out waiting for channel {spec.oid[:16]} "
                    f"version {seq}")
            spins = _poll_step(spins)
        length = _get_u64(view, base + 8)
        vflags = _get_u64(view, base + 16)
        payload = view[base + _VHDR:base + _VHDR + length]
        dag_metrics()[1].inc(tags={"op": "read"})
        if vflags & VF_ERROR:
            return pickle.loads(bytes(payload)), True
        if copy:
            payload = memoryview(bytes(payload))
        return serialization.deserialize(payload), False

    def advance(self, seq: int) -> None:
        if seq > self.consumed:
            self.consumed = seq
            _put_u64(self._view, self.spec.cursor_off(self.index), seq)
