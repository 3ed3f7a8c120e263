"""Sharded cluster object directory (head-side).

Equivalent role to the reference's GCS-backed ObjectDirectory
(reference: src/ray/object_manager/ownership_object_directory.h plus the
object-location half of gcs tables), rebuilt for head scale-out: one
monolithic per-node snapshot map was the ceiling once several agents
heartbeat large object sets while every lease request scores locality
against it (ROADMAP open item 3).

Design:
  - entries are partitioned into ``object_directory_shards`` buckets by
    oid hash; each shard carries its own lock and version counter, so
    heartbeat applies, location lookups, and gossip reads on different
    shards never serialize on one structure;
  - agents report DELTAS (added/removed [oid, size] pairs vs what they
    last acked), not full snapshots — a steady-state heartbeat with no
    object churn costs O(1) regardless of how many objects a node
    holds.  An epoch token handshakes resets: when the head restarts
    (or first hears from a node), the agent re-sends its full summary;
  - consumers (agents doing locality scoring / alt-source pulls) hold a
    per-shard mirror refreshed by shard version: the heartbeat reply
    carries only shards whose version moved past what the agent has
    seen, each as a full replacement map (idempotent, self-healing).

The per-shard ``threading.Lock`` makes every entry point safe from any
thread; on the head's single event loop it is uncontended and cheap.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple


def _shard_index(oid: str, num_shards: int) -> int:
    """Deterministic cross-process shard index.  Python's hash() is
    process-salted — the head and each agent would disagree on which
    shard an oid lives in, silently breaking every mirror lookup."""
    return zlib.crc32(oid.encode()) % num_shards


class _Shard:
    __slots__ = ("lock", "version", "holders", "crcs")

    def __init__(self):
        self.lock = threading.Lock()
        self.version = 0
        # oid -> {node_id: size}
        self.holders: Dict[str, Dict[str, int]] = {}
        # oid -> seal-fixed CRC32 (checksummed transfers): a property of
        # the object's bytes, not of any holder — one slot per oid,
        # dropped with the last holder
        self.crcs: Dict[str, int] = {}


class ShardedObjectDirectory:
    """Head-side object location registry, sharded by oid CRC.

    Thread contract: every mutation and read takes the owning shard's
    lock (plus ``_node_lock`` for the per-node reverse index), so the
    structure is safe to write from the head's telemetry ingest loop
    (heartbeat delta application) while the scheduling core reads
    ``locations()``/``updates_since()`` from its own loop — no
    cross-loop hop needed for locality lookups."""

    def __init__(self, num_shards: int = 16, epoch: str = ""):
        self.num_shards = max(1, int(num_shards))
        self._shards = [_Shard() for _ in range(self.num_shards)]
        # handshake token: agents echo it with their deltas; a mismatch
        # (head restart, first contact) makes them re-send everything
        self.epoch = epoch
        # node_id -> oids it holds (for O(node's objects) death cleanup)
        self._node_oids: Dict[str, Set[str]] = {}
        self._node_lock = threading.Lock()

    def _shard_of(self, oid: str) -> _Shard:
        return self._shards[_shard_index(oid, self.num_shards)]

    # ---- writes (heartbeat deltas) -------------------------------------

    def apply_delta(self, node_id: str, added: Iterable[List[Any]],
                    removed: Iterable[str], full: bool = False) -> None:
        """Fold one agent's report in.  ``full`` marks a complete
        re-send (epoch mismatch): entries this node reported before but
        not now are dropped first, so a desynced agent converges in one
        beat."""
        added = [list(ent) for ent in added]
        with self._node_lock:
            known = self._node_oids.setdefault(node_id, set())
            stale = known - {ent[0] for ent in added} if full else set()
        if stale:
            self._drop_entries(node_id, stale)
        touched: Set[int] = set()
        for ent in added:
            # [oid, size] (pre-checksum agents) or [oid, size, crc]
            oid, size = ent[0], ent[1]
            crc = ent[2] if len(ent) > 2 else None
            shard = self._shard_of(oid)
            with shard.lock:
                shard.holders.setdefault(oid, {})[node_id] = int(size)
                if crc is not None:
                    shard.crcs[oid] = int(crc)
            touched.add(id(shard))
            with self._node_lock:
                self._node_oids.setdefault(node_id, set()).add(oid)
        removed = list(removed)
        if removed:
            self._drop_entries(node_id, removed)
        for shard in self._shards:
            if id(shard) in touched:
                with shard.lock:
                    shard.version += 1

    def _drop_entries(self, node_id: str, oids: Iterable[str]) -> None:
        for oid in oids:
            shard = self._shard_of(oid)
            with shard.lock:
                ent = shard.holders.get(oid)
                if ent is not None and ent.pop(node_id, None) is not None:
                    if not ent:
                        shard.holders.pop(oid, None)
                        shard.crcs.pop(oid, None)
                    shard.version += 1
            with self._node_lock:
                known = self._node_oids.get(node_id)
                if known is not None:
                    known.discard(oid)

    def drop_node(self, node_id: str) -> None:
        """Node died: every location it held is gone."""
        with self._node_lock:
            oids = self._node_oids.pop(node_id, set())
        self._drop_entries(node_id, oids)

    # ---- reads ---------------------------------------------------------

    def locations(self, oid: str) -> Dict[str, int]:
        shard = self._shard_of(oid)
        with shard.lock:
            return dict(shard.holders.get(oid) or {})

    def checksum(self, oid: str) -> Optional[int]:
        """The directory-recorded seal CRC32 for oid (None when no
        checksum-reporting holder has advertised it)."""
        shard = self._shard_of(oid)
        with shard.lock:
            return shard.crcs.get(oid)

    def versions(self) -> List[int]:
        return [s.version for s in self._shards]

    def version_total(self) -> int:
        """Sum of shard versions: a cheap single-number change signal
        (monotonic while this head lives) for status surfaces."""
        return sum(s.version for s in self._shards)

    def updates_since(self, seen: Optional[List[int]]
                      ) -> Dict[int, Dict[str, Any]]:
        """Shards whose version moved past ``seen`` (None = everything),
        each as a full replacement {"v": version, "holders": {...}} —
        the mirror protocol's idempotent unit."""
        out: Dict[int, Dict[str, Any]] = {}
        for idx, shard in enumerate(self._shards):
            last = seen[idx] if seen is not None and idx < len(seen) else -1
            with shard.lock:
                if shard.version > last:
                    out[idx] = {"v": shard.version,
                                "holders": {oid: dict(h) for oid, h
                                            in shard.holders.items()}}
        return out

    def node_entries(self, node_id: str) -> Dict[str, int]:
        """One node's {oid: size} view (introspection/tests)."""
        out: Dict[str, int] = {}
        with self._node_lock:
            oids = set(self._node_oids.get(node_id) or ())
        for oid in oids:
            shard = self._shard_of(oid)
            with shard.lock:
                ent = shard.holders.get(oid)
                if ent is not None and node_id in ent:
                    out[oid] = ent[node_id]
        return out


class DirectoryMirror:
    """Agent-side replica of the sharded directory, refreshed from the
    versioned shard updates piggybacked on heartbeat replies.  Lookups
    are O(1) per oid — locality scoring stops scanning every node's
    object map per argument."""

    def __init__(self, num_shards: int = 16):
        self.num_shards = max(1, int(num_shards))
        self._shards: Dict[int, Dict[str, Dict[str, int]]] = {}
        self._seen: List[int] = [-1] * self.num_shards

    def seen_versions(self) -> List[int]:
        return list(self._seen)

    def apply_updates(self, updates: Optional[Dict[Any, Dict[str, Any]]]
                      ) -> None:
        if not updates:
            return
        for idx, payload in updates.items():
            idx = int(idx)
            if idx >= self.num_shards:
                # head reconfigured with more shards: resync from scratch
                self.num_shards = idx + 1
                self._seen.extend([-1] * (idx + 1 - len(self._seen)))
            self._shards[idx] = payload.get("holders") or {}
            self._seen[idx] = int(payload.get("v", self._seen[idx]))

    def holders(self, oid: str) -> Dict[str, int]:
        shard = self._shards.get(_shard_index(oid, self.num_shards))
        if not shard:
            return {}
        return shard.get(oid) or {}

    def reset(self) -> None:
        """Forget everything (head restart: the new head's shard
        versions restart at 0, so stale high seen-versions would
        suppress updates — and its directory content is new anyway)."""
        self._shards.clear()
        self._seen = [-1] * self.num_shards


class DeltaReporter:
    """Agent-side bookkeeping: turns successive full store summaries
    into (added, removed) deltas against what the head last acked, with
    the epoch handshake forcing a full re-send after a head restart."""

    def __init__(self):
        self._acked: Dict[str, int] = {}
        self._epoch: Optional[str] = None

    def build(self, summary: List[List[Any]],
              head_epoch: Optional[str]) -> Dict[str, Any]:
        # summary entries: [oid, size] or [oid, size, crc]
        current = {ent[0]: (int(ent[1]), ent[2] if len(ent) > 2 else None)
                   for ent in summary}
        full = head_epoch is None or head_epoch != self._epoch
        base = {} if full else self._acked
        added = [[oid, size, crc] for oid, (size, crc) in current.items()
                 if base.get(oid) != (size, crc)]
        removed = [oid for oid in base if oid not in current]
        self._pending = (current, head_epoch)
        return {"add": added, "remove": removed, "full": full,
                "epoch": head_epoch or ""}

    def ack(self) -> None:
        """The heartbeat carrying the last-built delta was answered."""
        pending = getattr(self, "_pending", None)
        if pending is not None:
            self._acked, self._epoch = pending
            self._pending = None
