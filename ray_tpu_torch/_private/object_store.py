"""Shared-memory object store (plasma equivalent).

Equivalent role to the reference's plasma store
(reference: src/ray/object_manager/plasma/store.h,
object_lifecycle_manager.h, create_request_queue.h): one store per node,
living inside the node agent's event loop; clients (driver/workers on the
same host) mmap the same arena file and read sealed objects zero-copy.

Differences from the reference, chosen for the TPU build:
- The arena is a plain file in /dev/shm mmap'd MAP_SHARED by name — no
  fd-passing over a Unix socket (reference: plasma/fling.cc) is needed
  because clients can open the file themselves.
- Allocation is a 64-byte-aligned first-fit free list (reference uses a
  dlmalloc arena, plasma/dlmalloc.cc). 64-byte alignment keeps numpy /
  jax host-array frames cache-line aligned for fast host->device DMA.
- Objects that do not fit in the arena fall back to disk files
  (reference: fallback allocation in plasma/plasma_allocator.cc), and the
  store spills cold primaries / evicts secondary copies under pressure
  (reference: eviction_policy.h, local_object_manager.cc).

Client reads stay pinned while any deserialized value still references
the buffer: `Buffer` implements the PEP 688 buffer protocol, so arrays
produced by zero-copy deserialization keep the `Buffer` alive and its
collection releases the pin (reference: PlasmaBuffer in _raylet.pyx).
"""

from __future__ import annotations

import asyncio
import mmap
import os
import sys
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

_ALIGN = 64


class ObjectStoreFull(Exception):
    pass


class ObjectAlreadyExists(Exception):
    pass


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


# Not exposed by every CPython build; the raw Linux value is stable.
# Populates writable PTEs for the CALLING process's mapping without
# touching data — safe concurrently with other processes' writes.
_MADV_POPULATE_WRITE = getattr(mmap, "MADV_POPULATE_WRITE", 23)


class ShmArena:
    """A named, mmap'd shared-memory file that any local process can attach."""

    def __init__(self, path: str, size: int, create: bool):
        self.path = path
        self.size = size
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            else:
                self.size = os.fstat(fd).st_size
            self._mmap = mmap.mmap(fd, self.size, mmap.MAP_SHARED)
        finally:
            os.close(fd)
        self.view = memoryview(self._mmap)
        # True once this process's page tables cover the whole mapping
        # writable — writers can then skip per-put page touching
        self.populated = False

    @classmethod
    def create(cls, path: str, size: int) -> "ShmArena":
        arena = cls(path, size, create=True)
        arena._prefault()
        return arena

    def _prefault(self) -> None:
        """Touch every page once at creation so client writes never pay
        tmpfs fault+zero costs (measured 4x put-bandwidth difference:
        ~1.3 GB/s faulting vs ~6 GB/s into resident pages)."""
        try:
            self._mmap.madvise(_MADV_POPULATE_WRITE)
            self.populated = True
            return
        except (AttributeError, ValueError, OSError):
            pass
        zeros = b"\0" * (16 * 1024 * 1024)
        view = self.view
        for off in range(0, self.size, len(zeros)):
            chunk = min(len(zeros), self.size - off)
            view[off:off + chunk] = zeros[:chunk]
        self.populated = True

    def populate_async(self) -> None:
        """Install writable PTEs for this process's mapping in the
        background (attachers: drivers/workers).  Data is never touched,
        so this is safe while other processes write objects."""
        import threading

        def run():
            try:
                self._mmap.madvise(_MADV_POPULATE_WRITE)
                self.populated = True
            except Exception:
                pass  # per-put write-touch remains the fallback

        threading.Thread(target=run, name="rt-arena-populate",
                         daemon=True).start()

    @classmethod
    def attach(cls, path: str) -> "ShmArena":
        return cls(path, 0, create=False)

    def close(self, unlink: bool = False) -> None:
        try:
            self.view.release()
        except Exception:
            pass
        try:
            self._mmap.close()
        except Exception:
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class FreeListAllocator:
    """First-fit free-list allocator with coalescing; offsets 64-aligned."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        # sorted list of (offset, size) free blocks
        self._free: List[Tuple[int, int]] = [(0, capacity)]
        self.allocated = 0

    def largest_free(self) -> int:
        return max((blk for _, blk in self._free), default=0)

    def alloc(self, size: int) -> Optional[int]:
        size = _aligned(max(size, 1))
        for i, (off, blk) in enumerate(self._free):
            if blk >= size:
                if blk == size:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + size, blk - size)
                self.allocated += size
                return off
        return None

    def free(self, offset: int, size: int) -> None:
        size = _aligned(max(size, 1))
        self.allocated -= size
        # insert keeping order, then coalesce neighbors
        lo, hi = 0, len(self._free)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._free[mid][0] < offset:
                lo = mid + 1
            else:
                hi = mid
        self._free.insert(lo, (offset, size))
        # coalesce with next
        if lo + 1 < len(self._free):
            off, blk = self._free[lo]
            noff, nblk = self._free[lo + 1]
            if off + blk == noff:
                self._free[lo] = (off, blk + nblk)
                self._free.pop(lo + 1)
        # coalesce with prev
        if lo > 0:
            poff, pblk = self._free[lo - 1]
            off, blk = self._free[lo]
            if poff + pblk == off:
                self._free[lo - 1] = (poff, pblk + blk)
                self._free.pop(lo)


@dataclass
class _Entry:
    size: int
    location: str  # "shm" | "disk"
    offset: int = 0  # shm only
    path: str = ""  # disk only
    sealed: bool = False
    primary: bool = True
    # CRC32 of the payload, fixed at seal (bytes are immutable after)
    # and computed lazily on first export (object_checksums): carried in
    # directory entries and the transfer control protocol, verified by
    # pullers — detects post-seal/in-transit corruption end to end.
    # None for channels (mutable) and when checksums are disabled.
    crc: Optional[int] = None
    # reusable pinned channel slot (compiled-DAG channels): permanently
    # pinned, never spilled/evicted, excluded from the object directory,
    # and writable in place after seal (single-writer ring discipline is
    # enforced by the channel layer, not the store)
    channel: bool = False
    created_at: float = field(default_factory=time.monotonic)
    last_used: float = field(default_factory=time.monotonic)
    pins: Dict[str, int] = field(default_factory=dict)  # client_id -> count

    @property
    def pinned(self) -> bool:
        return any(v > 0 for v in self.pins.values())


class StoreCore:
    """Server-side object store logic; runs inside the node agent's loop.

    Async methods may wait (get blocks until seal); mutation is effectively
    serialized by the single event loop.
    """

    def __init__(self, arena_path: str, capacity: int, spill_dir: str):
        from ray_tpu_torch import _native

        self.arena = ShmArena.create(arena_path, capacity)
        # native C allocator when the toolchain built it; Python fallback
        # is behaviorally identical (reference: plasma/malloc.cc native)
        self.alloc = _native.make_allocator(capacity) \
            or FreeListAllocator(capacity)
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self.objects: Dict[str, _Entry] = {}
        self._seal_events: Dict[str, asyncio.Event] = {}
        self._deleted: Set[str] = set()  # freed oids: get() fails fast
        self.num_spilled = 0
        self.num_evicted = 0
        # put()-backpressure wakeup: set whenever bytes free (pin
        # release, drop, free) so a create waiting for shm room retries
        # event-driven instead of polling (created lazily — __init__
        # may run without a loop)
        self._room_event: Optional[asyncio.Event] = None

    # ---- lifecycle -------------------------------------------------------

    def create(self, oid: str, size: int, primary: bool = True,
               no_disk_fallback: bool = False) -> Dict[str, Any]:
        """Reserve space for oid. Returns {"location","offset"|"path"}.
        ``no_disk_fallback`` raises ObjectStoreFull instead of spilling
        the create to a disk file when shm cannot fit it right now —
        the put-backpressure wait path probes with it."""
        if oid in self.objects:
            raise ObjectAlreadyExists(oid)
        self._deleted.discard(oid)
        if size <= self.arena.size:
            offset = self.alloc.alloc(size)
            if offset is None:
                self._reclaim(size)
                offset = self.alloc.alloc(size)
            if offset is not None:
                self.objects[oid] = _Entry(size=size, location="shm", offset=offset,
                                           primary=primary)
                return {"location": "shm", "offset": offset, "size": size}
        if no_disk_fallback:
            raise ObjectStoreFull(
                f"no shm room for {size} bytes (arena "
                f"{self.alloc.capacity - self.alloc.allocated} free)")
        # fallback to disk (reference: plasma fallback allocation)
        path = os.path.join(self.spill_dir, f"obj-{oid}")
        with open(path, "wb") as f:
            f.truncate(size)
        self.objects[oid] = _Entry(size=size, location="disk", path=path,
                                   primary=primary)
        return {"location": "disk", "path": path, "size": size}

    def _wake_room_waiters(self) -> None:
        if self._room_event is not None:
            self._room_event.set()

    def room_may_free(self, size: int) -> bool:
        """Whether waiting could ever get `size` into shm: the object
        fits the arena at all, and bytes exist that CAN free — pinned
        entries (pins release), unsealed creates (they seal or abort),
        or freed-but-pinned leftovers.  When everything resident is
        unpinned+sealed, _reclaim already did its best and waiting is
        pointless."""
        if size > self.arena.size:
            return False
        for oid, e in self.objects.items():
            if e.location != "shm" or e.channel:
                continue
            if e.pinned or not e.sealed or oid in self._deleted:
                return True
        return False

    async def create_with_backpressure(self, oid: str, size: int,
                                       primary: bool = True,
                                       wait_s: float = 0.0) -> Dict[str, Any]:
        """create(), but a put that would fall to DISK only because the
        arena is transiently full of pinned/unsealed bytes blocks up to
        ``wait_s`` (the client bounds this by its ambient deadline) for
        room to free — backpressure instead of silently flooding the
        slow path.  After the wait (or when nothing can free) the
        normal create semantics apply: disk fallback, and only a truly
        unservable create raises."""
        deadline = time.monotonic() + max(0.0, wait_s)
        while True:
            try:
                return self.create(oid, size, primary=primary,
                                   no_disk_fallback=True)
            except ObjectStoreFull:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self.room_may_free(size):
                return self.create(oid, size, primary=primary)
            if self._room_event is None:
                self._room_event = asyncio.Event()
            self._room_event.clear()
            try:
                await asyncio.wait_for(self._room_event.wait(),
                                       min(remaining, 0.25))
            except asyncio.TimeoutError:
                pass  # re-probe: a pin may have released without a wake

    def create_channel(self, oid: str, size: int) -> Dict[str, Any]:
        """Reserve a reusable pinned shm slot for a compiled-DAG channel
        (writer-node slot or reader-node mirror).  Sealed immediately
        (readers mmap it for the channel's whole life), permanently
        pinned so reclaim can never spill or evict it, and zeroed so
        stale arena bytes cannot masquerade as a published version.
        Channels must live in shm — mirror pushes and zero-copy reads
        write through the arena mapping — so an arena too full to hold
        one raises instead of falling back to disk.  Idempotent per oid
        (a retried compile reuses the slot)."""
        entry = self.objects.get(oid)
        if entry is not None:
            if entry.channel and entry.size == size:
                return {"location": "shm", "offset": entry.offset,
                        "size": entry.size}
            raise ObjectAlreadyExists(oid)
        self._deleted.discard(oid)
        offset = self.alloc.alloc(size)
        if offset is None:
            self._reclaim(size)
            offset = self.alloc.alloc(size)
        if offset is None:
            raise ObjectStoreFull(
                f"cannot allocate a {size}-byte channel slot; channels "
                "require shm (lower max_in_flight / buffer_size_bytes or "
                "grow object_store_memory)")
        entry = _Entry(size=size, location="shm", offset=offset,
                       primary=True, sealed=True, channel=True)
        entry.pins["__channel__"] = 1
        self.objects[oid] = entry
        self.arena.view[offset:offset + size] = b"\0" * size
        return {"location": "shm", "offset": offset, "size": size}

    def destroy_channel(self, oid: str) -> None:
        """Release a channel slot; no-op for unknown/non-channel oids."""
        entry = self.objects.get(oid)
        if entry is None or not entry.channel:
            return
        entry.pins.pop("__channel__", None)
        self._deleted.add(oid)
        if not entry.pinned:
            self._drop(oid, entry)

    def seal(self, oid: str) -> None:
        entry = self.objects.get(oid)
        if entry is None:
            raise KeyError(f"seal of unknown object {oid}")
        entry.sealed = True
        ev = self._seal_events.pop(oid, None)
        if ev is not None:
            ev.set()

    def compute_crc(self, entry: _Entry) -> Optional[int]:
        """CRC32 of an entry's current payload bytes (None when
        checksums are disabled or the bytes are unreadable).  zlib.crc32
        runs ~1 GB/s+ in C; the directory floor (locality_min_bytes)
        keeps the entries that matter largest, and every byte hashed
        here is a byte a pull can verify later."""
        from ray_tpu_torch._private.config import config

        if not config.object_checksums:
            return None
        try:
            if entry.location == "shm":
                return zlib.crc32(
                    self.arena.view[entry.offset:entry.offset + entry.size])
            crc = 0
            with open(entry.path, "rb") as f:
                while True:
                    chunk = f.read(8 * 1024 * 1024)
                    if not chunk:
                        return crc
                    crc = zlib.crc32(chunk, crc)
        except OSError:
            return None

    def verify_crc(self, oid: str) -> Optional[bool]:
        """Re-hash a sealed local copy against its seal-time checksum:
        True = intact, False = CORRUPT, None = unverifiable (no stored
        crc / checksums off / not sealed here).  The corrupt-copy
        quarantine path runs this when a puller reports a mismatch."""
        entry = self.objects.get(oid)
        if entry is None or not entry.sealed or entry.crc is None:
            return None
        current = self.compute_crc(entry)
        if current is None:
            return None
        return current == entry.crc

    def checksum(self, oid: str) -> Optional[int]:
        """The seal-fixed CRC32 of a sealed object, computed lazily on
        first export (obj_info / directory summary) and cached — the
        bytes are immutable from seal, so hashing at first use is
        equivalent to hashing at seal while keeping the local put hot
        path at memcpy speed."""
        entry = self.objects.get(oid)
        if entry is None or not entry.sealed or entry.channel:
            return None
        if entry.crc is None:
            entry.crc = self.compute_crc(entry)
        return entry.crc

    def abort(self, oid: str) -> None:
        """Abort an unsealed create (client died mid-write)."""
        entry = self.objects.get(oid)
        if entry is not None and not entry.sealed:
            self._drop(oid, entry)

    def promote(self, oids: List[str]) -> Tuple[int, List[str]]:
        """Mark sealed copies PRIMARY (eviction-exempt).  The drain
        protocol hands primary-ship to the node that took over a
        draining node's copies — a secondary copy could be evicted
        under pressure the moment the original holder terminates.
        Returns (newly promoted, MISSING oids) — missing means this
        store holds no sealed copy (evicted/freed since the caller
        looked), which the drain must treat as not-handed-off."""
        n = 0
        missing: List[str] = []
        for oid in oids:
            entry = self.objects.get(oid)
            if entry is None or not entry.sealed:
                missing.append(oid)
            elif not entry.primary:
                entry.primary = True
                n += 1
        return n, missing

    async def get(self, oids: List[str], client_id: str,
                  wait_timeout: Optional[float] = None) -> List[Optional[Dict[str, Any]]]:
        """Wait for each oid to be sealed locally; pin and return locations.

        Returns None for objects not local (caller triggers a pull) and
        {"deleted": True} for freed objects.
        """
        deadline = None if wait_timeout is None else time.monotonic() + wait_timeout
        out: List[Optional[Dict[str, Any]]] = []
        for oid in oids:
            if oid in self._deleted:
                out.append({"deleted": True})
                continue
            entry = self.objects.get(oid)
            if entry is not None and not entry.sealed:
                ev = self._seal_events.setdefault(oid, asyncio.Event())
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    out.append(None)
                    continue
                entry = self.objects.get(oid)
            if entry is None:
                out.append({"deleted": True} if oid in self._deleted else None)
                continue
            entry.last_used = time.monotonic()
            if entry.location == "disk":
                entry.pins[client_id] = entry.pins.get(client_id, 0) + 1
                out.append({"location": "disk", "path": entry.path, "size": entry.size})
            else:
                entry.pins[client_id] = entry.pins.get(client_id, 0) + 1
                out.append({"location": "shm", "offset": entry.offset, "size": entry.size})
        return out

    def contains(self, oid: str) -> bool:
        if oid in self._deleted:
            return False
        e = self.objects.get(oid)
        return e is not None and e.sealed

    def release(self, oid: str, client_id: str) -> None:
        entry = self.objects.get(oid)
        if entry is None:
            return
        n = entry.pins.get(client_id, 0)
        if n <= 1:
            entry.pins.pop(client_id, None)
            self._wake_room_waiters()  # pinned bytes became reclaimable
        else:
            entry.pins[client_id] = n - 1

    def release_client(self, client_id: str) -> None:
        """Drop all pins held by a disconnected client (worker death)."""
        for entry in self.objects.values():
            entry.pins.pop(client_id, None)
        self._wake_room_waiters()

    def drop_copy(self, oid: str) -> bool:
        """Evict ONE local copy without owner-delete semantics (unlike
        free, which marks the oid deleted so local getters fail with
        "freed"): used for a corrupt local copy — the owner's ref and
        other nodes' copies stay valid, and local getters simply see
        not-local and pull afresh.  Pinned copies are left in place (a
        reader may be mid-access of the bytes)."""
        entry = self.objects.get(oid)
        if entry is None or entry.pinned or entry.channel:
            return False
        self._drop(oid, entry)
        return True

    def free(self, oids: List[str]) -> None:
        """Owner-driven delete. Pinned objects are dropped once unpinned."""
        for oid in oids:
            entry = self.objects.get(oid)
            if entry is None:
                continue
            self._deleted.add(oid)
            if not entry.pinned:
                self._drop(oid, entry)
            # else: dropped lazily by _reclaim once pins go away

    def usage(self) -> Dict[str, Any]:
        return {
            "capacity": self.alloc.capacity,
            "allocated": self.alloc.allocated,
            "num_objects": len(self.objects),
            "num_spilled": self.num_spilled,
            "num_evicted": self.num_evicted,
        }

    def byte_breakdown(self) -> Dict[str, Any]:
        """Who owns this store's bytes — the node half of `rtpu memory`
        (reference role: the `ray memory --stats-only` store stats).

        Buckets are over the ALIGNED footprint for shm entries (what the
        allocator actually charges), so `shm_bytes` reconciles exactly
        with the allocator's own `arena_used` gauge; `object_bytes` is
        the raw payload sum the owner-side reference tables attribute.
        """
        out = {
            "capacity": self.alloc.capacity,
            "arena_used": self.alloc.allocated,
            "arena_free": self.alloc.capacity - self.alloc.allocated,
            "shm_bytes": 0, "object_bytes": 0,
            "pinned_bytes": 0, "pinned_objects": 0,
            "channel_bytes": 0, "channel_slots": 0,
            "spilled_bytes": 0, "spilled_files": 0,
            "unsealed_bytes": 0, "freed_pending_bytes": 0,
            "num_objects": len(self.objects),
            "num_spilled": self.num_spilled,
            "num_evicted": self.num_evicted,
        }
        for oid, e in self.objects.items():
            if e.location == "shm":
                footprint = _aligned(max(e.size, 1))
                out["shm_bytes"] += footprint
            else:
                footprint = e.size
                out["spilled_bytes"] += e.size
                out["spilled_files"] += 1
            out["object_bytes"] += e.size
            if e.channel:
                out["channel_bytes"] += footprint
                out["channel_slots"] += 1
            elif e.pinned:
                out["pinned_bytes"] += footprint
                out["pinned_objects"] += 1
            if not e.sealed:
                out["unsealed_bytes"] += footprint
            if oid in self._deleted:
                out["freed_pending_bytes"] += footprint
        return out

    def object_summary(self, min_bytes: int, limit: int) -> List[List[Any]]:
        """[oid, size] pairs for sealed objects at/above min_bytes —
        piggybacked on heartbeats to feed the head's object directory
        (locality-aware spillback + multi-source pull retry).  Largest
        first, so the cap drops the entries that matter least.
        min_bytes <= 0 means locality is disabled: report nothing
        rather than every tiny object.  Entries carry the seal-fixed
        CRC32 when ALREADY computed (a pull/obj_info hashed it) — the
        directory picks checksums up opportunistically rather than this
        heartbeat-path walk hashing gigabytes on the agent loop; pull
        verification itself always gets a fresh crc from the holder's
        obj_info handshake, where the hash cost amortizes into the
        transfer."""
        if min_bytes <= 0:
            return []
        out = [[oid, e.size, e.crc]
               for oid, e in self.objects.items()
               if e.sealed and e.size >= min_bytes and not e.channel
               and oid not in self._deleted]
        if len(out) > limit:
            out.sort(key=lambda p: -p[1])
            del out[limit:]
        return out

    def list_objects(self, limit: int = 1000) -> List[Dict[str, Any]]:
        """Object summaries for the state API (reference:
        GetObjectsInfo in node_manager.proto:405)."""
        now = time.monotonic()
        out = []
        for oid, e in self.objects.items():
            out.append({"object_id": oid, "size": e.size,
                        "location": e.location, "sealed": e.sealed,
                        "primary": e.primary, "pins": sum(e.pins.values()),
                        "channel": e.channel, "freed": oid in self._deleted,
                        "age_s": round(now - e.created_at, 3)})
            if len(out) >= limit:
                break
        return out

    # ---- memory pressure -------------------------------------------------

    def _drop(self, oid: str, entry: _Entry) -> None:
        self.objects.pop(oid, None)
        # wake any getters blocked on the seal event; they re-check and see
        # the object is gone (deleted/None) instead of waiting out the timeout
        ev = self._seal_events.pop(oid, None)
        if ev is not None:
            ev.set()
        if entry.location == "shm":
            self.alloc.free(entry.offset, entry.size)
            self._wake_room_waiters()
        else:
            try:
                os.unlink(entry.path)
            except OSError:
                pass

    def _reclaim(self, needed: int) -> None:
        """Evict/spill until `needed` bytes could plausibly be allocated.

        Order: freed-but-pinned leftovers, secondary copies (LRU), then
        spill cold primaries to disk (reference: eviction_policy.h +
        local_object_manager.cc spilling).
        """
        # 1. deleted objects whose pins have since been released
        for oid in [o for o in self._deleted if o in self.objects]:
            e = self.objects[oid]
            if not e.pinned:
                self._drop(oid, e)
        if self._headroom() >= needed:
            return
        # 2. evict unpinned sealed secondary copies, LRU first
        candidates = sorted(
            ((oid, e) for oid, e in self.objects.items()
             if e.location == "shm" and e.sealed and not e.pinned and not e.primary),
            key=lambda kv: kv[1].last_used,
        )
        for oid, e in candidates:
            self._drop(oid, e)
            self.num_evicted += 1
            if self._headroom() >= needed:
                return
        # 3. spill unpinned sealed primaries to disk, LRU first
        candidates = sorted(
            ((oid, e) for oid, e in self.objects.items()
             if e.location == "shm" and e.sealed and not e.pinned and e.primary),
            key=lambda kv: kv[1].last_used,
        )
        for oid, e in candidates:
            self._spill(oid, e)
            if self._headroom() >= needed:
                return

    def _headroom(self) -> int:
        return self.alloc.largest_free()

    def _spill(self, oid: str, entry: _Entry) -> None:
        path = os.path.join(self.spill_dir, f"obj-{oid}")
        with open(path, "wb") as f:
            f.write(self.arena.view[entry.offset:entry.offset + entry.size])
        self.alloc.free(entry.offset, entry.size)
        entry.location = "disk"
        entry.path = path
        entry.offset = 0
        self.num_spilled += 1

    def close(self, unlink: bool = True) -> None:
        self.arena.close(unlink=unlink)


class Buffer:
    """A pinned read view; collection of the last view releases the pin.

    Implements the PEP 688 buffer protocol so zero-copy consumers (numpy,
    pickle5 out-of-band loads) hold a reference to *this* object, not just
    the underlying mmap — guaranteeing the store cannot recycle the bytes
    while any deserialized value is alive.
    """

    def __init__(self, mv: memoryview, on_release: Optional[Callable[[], None]] = None):
        self._mv = mv
        self._on_release = on_release

    def __buffer__(self, flags: int) -> memoryview:
        return self._mv

    def __len__(self) -> int:
        return self._mv.nbytes

    def __del__(self):
        cb, self._on_release = self._on_release, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


class _SharedRelease:
    """Calls `fn` once, after `count` participants have all released."""

    def __init__(self, count: int, fn: Callable[[], None]):
        self._count = count
        self._fn = fn

    def __call__(self):
        self._count -= 1
        if self._count == 0 and self._fn is not None:
            fn, self._fn = self._fn, None
            fn()


# Buffer's __buffer__ hook (PEP 688) only reaches the C buffer protocol
# on Python 3.12+; earlier interpreters see a plain object and every
# out-of-band consumer (numpy, pyarrow) rejects it with "a bytes-like
# object is required"
_PEP688 = sys.version_info >= (3, 12)


def deserialize_pinned(data: memoryview, on_release: Optional[Callable[[], None]]) -> Any:
    """Zero-copy deserialize; the pin is released when the value (all of its
    out-of-band-backed parts) is garbage collected, or immediately if the
    value embeds no out-of-band buffers.

    On interpreters without PEP 688 the out-of-band frames are copied
    instead (one memcpy per frame) and the pin releases immediately —
    correctness over zero-copy; the wrapper path resumes on 3.12+."""
    from ray_tpu_torch._private import serialization

    frames = serialization.unpack_frames(data)
    if len(frames) == 1 or on_release is None:
        import pickle

        value = pickle.loads(frames[0])
        if on_release is not None:
            on_release()
        return value
    import pickle

    if not _PEP688:
        try:
            return pickle.loads(frames[0],
                                buffers=[f.tobytes() for f in frames[1:]])
        finally:
            on_release()
    shared = _SharedRelease(len(frames) - 1, on_release)
    buffers = [Buffer(f, shared) for f in frames[1:]]
    return pickle.loads(frames[0], buffers=buffers)


class PlasmaClient:
    """Client-side store access: mmap attach + agent RPC for control.

    `rpc` is a SyncRpcClient to the node agent, whose RpcHost exposes
    store_create/store_seal/store_get/store_release/store_free/
    store_contains (see node_agent.py).
    """

    def __init__(self, arena_path: str, rpc, client_id: str):
        from ray_tpu_torch import _native

        self.arena = ShmArena.attach(arena_path)
        self.arena.populate_async()  # writable PTEs off the put path
        self.rpc = rpc
        self.client_id = client_id
        _native.warm_up()  # compile off the put path

    @staticmethod
    def _touch(view) -> None:
        """WRITE-fault one byte per page before packing.

        A fresh attach has no PTEs for the (already-resident) tmpfs
        pages; taking the faults inside the copy throttles it to
        ~2 GB/s.  A read-touch maps pages read-only and still pays a
        write-protect upgrade fault per page during the copy — writing
        one byte per page instead installs writable PTEs in a single
        pass (safe: this region is exclusively ours until seal).
        Parallelized in C when available."""
        from ray_tpu_torch import _native

        _native.touch_pages_write(view)

    def put_serialized(self, oid: str, frames, total_size: int,
                       primary: bool = True, wait_s: float = 0.0) -> None:
        from ray_tpu_torch._private import serialization

        loc = self.rpc.call("store_create", oid=oid, size=total_size,
                            primary=primary,
                            **({"wait_s": wait_s, "timeout": wait_s + 60.0}
                               if wait_s > 0 else {}))
        try:
            if loc["location"] == "shm":
                out = self.arena.view[loc["offset"]:loc["offset"] + total_size]
                if not self.arena.populated:
                    self._touch(out)
                serialization.pack_into(frames, out)
            else:
                buf = bytearray(total_size)
                serialization.pack_into(frames, memoryview(buf))
                with open(loc["path"], "r+b") as f:
                    f.write(buf)
        except BaseException:
            self._abort(oid)
            raise
        self.rpc.call("store_seal", oid=oid)

    def put_raw(self, oid: str, data: bytes, primary: bool = True,
                wait_s: float = 0.0) -> None:
        loc = self.rpc.call("store_create", oid=oid, size=len(data),
                            primary=primary,
                            **({"wait_s": wait_s, "timeout": wait_s + 60.0}
                               if wait_s > 0 else {}))
        try:
            if loc["location"] == "shm":
                from ray_tpu_torch import _native

                out = self.arena.view[loc["offset"]:loc["offset"] + len(data)]
                if not self.arena.populated:
                    self._touch(out)
                _native.copy_into(out, data)
            else:
                with open(loc["path"], "r+b") as f:
                    f.write(data)
        except BaseException:
            self._abort(oid)
            raise
        self.rpc.call("store_seal", oid=oid)

    def _abort(self, oid: str) -> None:
        try:
            self.rpc.call("store_abort", oid=oid)
        except Exception:
            pass

    def get_locations(self, oids: List[str],
                      timeout: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Resolve (and pin) locations for oids, waiting for seals.

        Missing/timed-out objects are absent from the result; freed objects
        map to {"deleted": True}. Each *found* object is pinned exactly once
        even across retries.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        found: Dict[str, Dict[str, Any]] = {}
        pending = list(oids)
        while pending:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            round_wait = 10.0 if remaining is None else min(10.0, remaining)
            locs = self.rpc.call(
                "store_get", oids=pending, client_id=self.client_id,
                wait_timeout=round_wait,
                timeout=round_wait * max(1, len(pending)) + 30.0,
            )
            still = []
            for oid, loc in zip(pending, locs):
                if loc is None:
                    still.append(oid)
                else:
                    found[oid] = loc
            pending = still
            if pending and deadline is not None and time.monotonic() >= deadline:
                break
        return found

    def get_values(self, oids: List[str], timeout: Optional[float] = None) -> List[Any]:
        """Fetch + deserialize; raises KeyError on timeout/missing/freed."""
        found = self.get_locations(oids, timeout=timeout)
        missing = [oid for oid in oids
                   if found.get(oid) is None or found[oid].get("deleted")]
        if missing:
            # release pins taken on the objects we did find before bailing
            for oid, loc in found.items():
                if not loc.get("deleted"):
                    try:
                        self.rpc.oneway("store_release", oid=oid,
                                        client_id=self.client_id)
                    except Exception:
                        pass
            loc = found.get(missing[0])
            freed = loc is not None and loc.get("deleted")
            raise KeyError(f"object {missing[0]} not available"
                           + (" (freed)" if freed else ""))
        return [self._load(oid, found[oid]) for oid in oids]

    def _load(self, oid: str, loc: Dict[str, Any]) -> Any:
        if loc["location"] == "shm":
            mv = self.arena.view[loc["offset"]:loc["offset"] + loc["size"]]
            release = self._make_release(oid)
            return deserialize_pinned(mv, release)
        # disk object: mmap the file for zero-copy reads
        with open(loc["path"], "rb") as f:
            mapped = mmap.mmap(f.fileno(), loc["size"], mmap.MAP_SHARED, mmap.PROT_READ)
        mv = memoryview(mapped)
        release = self._make_release(oid)
        return deserialize_pinned(mv, release)

    def _make_release(self, oid: str):
        rpc, client_id = self.rpc, self.client_id

        def release():
            try:
                rpc.oneway("store_release", oid=oid, client_id=client_id)
            except Exception:
                pass

        return release

    def contains(self, oid: str) -> bool:
        return bool(self.rpc.call("store_contains", oid=oid))

    def free(self, oids: List[str]) -> None:
        self.rpc.call("store_free", oids=oids)

    def close(self):
        self.arena.close(unlink=False)


class RpcPlasmaClient(PlasmaClient):
    """Store access for drivers with NO local arena (client mode): data
    rides the control-plane RPC in chunks instead of shared memory.

    Equivalent of the reference's Ray Client data path
    (reference: python/ray/util/client/server/server.py — a remote
    driver's puts/gets proxy through the cluster).  Slower than mmap by
    design; correct from any machine that can reach the node agent.
    """

    _CHUNK = 4 * 1024 * 1024

    def __init__(self, rpc, client_id: str):
        self.arena = None  # no mmap: all data moves over RPC
        self.rpc = rpc
        self.client_id = client_id

    def put_serialized(self, oid: str, frames, total_size: int,
                       primary: bool = True, wait_s: float = 0.0) -> None:
        from ray_tpu_torch._private import serialization

        buf = bytearray(total_size)
        serialization.pack_into(frames, memoryview(buf))
        self.put_raw(oid, buf, primary=primary, wait_s=wait_s)

    def put_raw(self, oid: str, data, primary: bool = True,
                wait_s: float = 0.0) -> None:
        # memoryview slices: no per-chunk copies (msgpack serializes any
        # buffer-protocol object directly)
        view = memoryview(data)
        self.rpc.call("store_create", oid=oid, size=view.nbytes,
                      primary=primary,
                      **({"wait_s": wait_s, "timeout": wait_s + 60.0}
                         if wait_s > 0 else {}))
        try:
            for pos in range(0, view.nbytes, self._CHUNK):
                reply = self.rpc.call(
                    "store_write", oid=oid, offset=pos,
                    data=view[pos:pos + self._CHUNK])
                if not reply.get("ok"):
                    raise RuntimeError(reply.get("error", "write failed"))
        except BaseException:
            self._abort(oid)
            raise
        self.rpc.call("store_seal", oid=oid)

    def _load(self, oid: str, loc: Dict[str, Any]) -> Any:
        from ray_tpu_torch._private import serialization

        size = loc["size"]
        data = bytearray(size)
        try:
            for pos in range(0, size, self._CHUNK):
                n = min(self._CHUNK, size - pos)
                r = self.rpc.call("obj_chunk", oid=oid, offset=pos, length=n)
                if not r.get("found"):
                    raise KeyError(f"object {oid} vanished mid-read")
                data[pos:pos + len(r["data"])] = r["data"]
        finally:
            # the bytes are ours now: drop the pin immediately
            self._make_release(oid)()
        return serialization.deserialize(memoryview(data))

    def close(self):
        pass
