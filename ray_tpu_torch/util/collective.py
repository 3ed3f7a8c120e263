"""Host-side collective communication between workers/actors.

Equivalent of the reference's ray.util.collective API
(reference: python/ray/util/collective/collective.py —
init_collective_group :120, allreduce :258, barrier :298, reduce :311,
broadcast :373, allgather :423, reducescatter :472, send/recv :531/:594).

Backend split, TPU-style (SURVEY §5.8): accelerator-plane collectives are
XLA collectives (jax.lax.psum/all_gather/ppermute) compiled over ICI
inside jit — NOT this module.  This module is the *host/control plane*:
small numpy payloads (rendezvous info, metrics, barriers) between worker
processes, riding the same RPC plane as tasks.  Rendezvous is the head's
KV (reference uses a named actor storing the NCCL unique id).

Topology: gather-to-root + broadcast (2(N-1) messages).  Payloads here
are control-sized; bulk tensors belong on the object store or in XLA
collectives.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_groups: Dict[str, "_Group"] = {}
_groups_lock = threading.Lock()
# messages that arrived before their group was initialized locally
_undelivered: Dict[str, List[Tuple[str, int, int, bytes, float]]] = {}


class _Group:
    def __init__(self, name: str, world_size: int, rank: int):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.members: List[Tuple[str, int]] = []  # rank -> worker RPC addr
        self.seq = 0                              # collective-op sequence
        self.p2p_send: Dict[int, int] = {}        # dst -> seq (per peer)
        self.p2p_recv: Dict[int, int] = {}        # src -> seq (per peer)
        self.lock = threading.Lock()
        # (channel, seq, src) -> payload; channel "op" | "p2p"
        self.inbox: Dict[Tuple[str, int, int], Any] = {}
        self.cv = threading.Condition(self.lock)

    def deliver(self, chan: str, seq: int, src: int, payload: bytes):
        with self.cv:
            self.inbox[(chan, seq, src)] = payload
            self.cv.notify_all()

    def take(self, chan: str, seq: int, src: int, timeout: float) -> bytes:
        deadline = time.monotonic() + timeout
        with self.cv:
            while (chan, seq, src) not in self.inbox:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"collective {self.name}: no {chan} message "
                        f"seq={seq} from rank {src}")
                self.cv.wait(remaining)
            return self.inbox.pop((chan, seq, src))


def _worker():
    import ray_tpu_torch

    return ray_tpu_torch.api._worker()


def _deliver_push(group_name: str, chan: str, seq: int, src: int,
                  payload: bytes):
    """Called from the worker's RPC loop; never blocks — early messages
    are buffered and drained by init_collective_group."""
    with _groups_lock:
        g = _groups.get(group_name)
        if g is None:
            box = _undelivered.setdefault(group_name, [])
            box.append((chan, seq, src, payload, time.monotonic()))
            # bound the buffer; drop oldest orphans
            cutoff = time.monotonic() - 120.0
            _undelivered[group_name] = [
                m for m in box[-1000:] if m[4] > cutoff]
            return
    g.deliver(chan, seq, src, payload)


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default",
                          timeout: float = 60.0) -> None:
    """All members call this; rendezvous through the head KV.

    Stale entries from an earlier same-named gang are filtered by pinging
    every collected address and re-reading the KV for peers that fail —
    dead addresses never make it into the member table.
    """
    w = _worker()
    g = _Group(group_name, world_size, rank)
    with _groups_lock:
        _groups[group_name] = g
        early = _undelivered.pop(group_name, [])
    key = f"coll:{group_name}:{rank}"
    w.head.call("kv_put", key=key,
                value=pickle.dumps(tuple(w.address)), overwrite=True)
    deadline = time.monotonic() + timeout
    members: List[Optional[Tuple[str, int]]] = [None] * world_size
    members[rank] = tuple(w.address)
    while time.monotonic() < deadline:
        for r in [r for r in range(world_size) if members[r] is None]:
            reply = w.head.call("kv_get", key=f"coll:{group_name}:{r}")
            if reply.get("value") is not None:
                addr = pickle.loads(reply["value"])
                if _ping(w, addr):
                    members[r] = addr
                else:
                    # stale entry from a previous gang: drop and re-poll
                    w.head.call("kv_del", key=f"coll:{group_name}:{r}")
        if all(m is not None for m in members):
            g.members = members  # type: ignore[assignment]
            for chan, seq, src, payload, _ in early:
                g.deliver(chan, seq, src, payload)
            return
        time.sleep(0.02)
    raise TimeoutError(f"collective group {group_name}: only "
                       f"{sum(m is not None for m in members)}/{world_size} "
                       f"members joined")


def _ping(w, addr, timeout: float = 2.0) -> bool:
    async def _do():
        c = await w._aclient_worker(tuple(addr))
        return await c.call("ping", timeout=timeout)

    try:
        return bool(w._io.run(_do(), timeout=timeout + 5.0))
    except Exception:
        return False


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        g = _groups.pop(group_name, None)
    if g is not None and g.rank == 0:
        w = _worker()
        for r in range(g.world_size):
            try:
                w.head.call("kv_del", key=f"coll:{group_name}:{r}")
            except Exception:
                pass


def _group(group_name: str) -> _Group:
    with _groups_lock:
        g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized here")
    return g


def _send_to(g: _Group, dst: int, seq: int, payload: bytes,
             chan: str = "op"):
    w = _worker()
    addr = g.members[dst]
    w._spawn(w._acoll_send(addr, g.name, chan, seq, g.rank, payload))


def send(data: np.ndarray, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send; sequenced per (src, dst) pair so sends to
    different peers cannot cross-match."""
    g = _group(group_name)
    with g.lock:
        g.p2p_send[dst_rank] = g.p2p_send.get(dst_rank, 0) + 1
        seq = g.p2p_send[dst_rank]
    _send_to(g, dst_rank, seq, pickle.dumps(np.asarray(data)), chan="p2p")


def recv(src_rank: int, group_name: str = "default",
         timeout: float = 60.0) -> np.ndarray:
    g = _group(group_name)
    with g.lock:
        g.p2p_recv[src_rank] = g.p2p_recv.get(src_rank, 0) + 1
        seq = g.p2p_recv[src_rank]
    return pickle.loads(g.take("p2p", seq, src_rank, timeout))


def _op_seq(g: _Group) -> int:
    with g.lock:
        g.seq += 1
        return g.seq


def allgather(data: np.ndarray, group_name: str = "default",
              timeout: float = 60.0) -> List[np.ndarray]:
    """Every rank returns [data_0, ..., data_{n-1}]."""
    g = _group(group_name)
    seq = _op_seq(g)
    arr = np.asarray(data)
    if g.rank == 0:
        parts: List[Any] = [arr] + [None] * (g.world_size - 1)
        for src in range(1, g.world_size):
            parts[src] = pickle.loads(g.take("op", seq, src, timeout))
        blob = pickle.dumps(parts)
        for dst in range(1, g.world_size):
            _send_to(g, dst, seq + 1, blob)
        with g.lock:
            g.seq += 1  # account for the broadcast step
        return parts
    _send_to(g, 0, seq, pickle.dumps(arr))
    out = pickle.loads(g.take("op", seq + 1, 0, timeout))
    with g.lock:
        g.seq += 1
    return out


_REDUCERS = {
    "sum": lambda parts: np.sum(parts, axis=0),
    "prod": lambda parts: np.prod(parts, axis=0),
    "max": lambda parts: np.max(parts, axis=0),
    "min": lambda parts: np.min(parts, axis=0),
}


def allreduce(data: np.ndarray, op: str = "sum",
              group_name: str = "default", timeout: float = 60.0) -> np.ndarray:
    parts = allgather(data, group_name, timeout)
    return _REDUCERS[op](np.stack([np.asarray(p) for p in parts]))


def reduce(data: np.ndarray, dst_rank: int = 0, op: str = "sum",
           group_name: str = "default", timeout: float = 60.0
           ) -> Optional[np.ndarray]:
    out = allreduce(data, op, group_name, timeout)
    g = _group(group_name)
    return out if g.rank == dst_rank else None


def broadcast(data: Optional[np.ndarray], src_rank: int = 0,
              group_name: str = "default", timeout: float = 60.0) -> np.ndarray:
    g = _group(group_name)
    seq = _op_seq(g)
    if g.rank == src_rank:
        blob = pickle.dumps(np.asarray(data))
        for dst in range(g.world_size):
            if dst != src_rank:
                _send_to(g, dst, seq, blob)
        return np.asarray(data)
    return pickle.loads(g.take("op", seq, src_rank, timeout))


def reducescatter(data: np.ndarray, op: str = "sum",
                  group_name: str = "default", timeout: float = 60.0
                  ) -> np.ndarray:
    """Each rank gets its 1/n slice (dim 0) of the reduction."""
    g = _group(group_name)
    total = allreduce(data, op, group_name, timeout)
    return np.array_split(total, g.world_size, axis=0)[g.rank]


def barrier(group_name: str = "default", timeout: float = 60.0) -> None:
    allgather(np.zeros(1), group_name, timeout)
