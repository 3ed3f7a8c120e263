"""Bulk object-transfer plane: raw binary streams between node agents.

Equivalent role to the reference's object manager data plane
(reference: src/ray/object_manager/object_manager.h Push/Pull +
object_buffer_pool.h chunked reads): the survey is explicit that in Ray
"bulk data rides the object plane, never RPC" (rpc.py:8).  Control stays
on the msgpack RPC connection (obj_info pin/size lookup, obj_unpin);
object BYTES move here, on a dedicated listener with its own socket
pool, so a 256 MB pull can never head-of-line-block leases, heartbeats
or task pushes.

Wire protocol (one stream, any number of requests):

  request  (puller -> holder):  <u16 oid_len><u64 offset><u64 length>
                                <oid_len bytes of hex oid>
  response (holder -> puller):  <u8 status><u64 length>
                                <length raw payload bytes>   (status 0)

Status 0 = ok, 1 = object not found/unsealed (payload absent).
Responses come back in request order per stream, so a puller keeps
``object_transfer_window`` chunk requests in flight on one stream
(pipelined, no per-chunk round trip) and objects at or above
``object_transfer_parallel_threshold`` are striped across up to
``object_transfer_max_streams`` pooled connections.

Zero-copy discipline: the holder ``sendall``s straight from the arena
``memoryview`` (or an mmap of a disk-fallback file); the puller
``recv_into``s the pre-created plasma allocation (or an mmap of the
fallback file).  No intermediate ``bytes`` object exists on either side;
the only copies are the kernel's socket copies.

Thread model: the byte-moving loops run on plain BLOCKING sockets in
dedicated threads (holder: accept thread + thread per stream; puller:
executor threads, one per stripe).  Measured on this box, one blocking
stream moves ~5x what a non-blocking loop.sock_* implementation does —
every asyncio recv costs an epoll_ctl/epoll_wait round on top of the
recv itself, and syscalls dominate bulk transfer here.  It also means a
multi-hundred-MB transfer adds ZERO work to the node agent's event
loop, which keeps serving leases and heartbeats.
"""

from __future__ import annotations

import asyncio
import mmap
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import fault_injection

_REQ = struct.Struct("<HQQ")   # oid_len (| _WRITE_FLAG), offset, length
_RSP = struct.Struct("<BQ")    # status, length
_OK, _NOT_FOUND = 0, 1
_MAX_REQ_OID = 256
# high bit of oid_len marks a WRITE request: `length` payload bytes
# follow the oid and are stored at [offset, offset+length) of the named
# object.  Writes are only honored for channel slots (compiled-DAG
# mutable channels, see dag/channel.py) — immutable objects stay
# immutable on the wire.
_WRITE_FLAG = 0x8000
_IO_TIMEOUT_S = 60.0  # per socket op; a wedged peer must not pin a thread
_POOL_IDLE_S = 30.0   # drop pooled streams before the holder's idle
# timeout (_IO_TIMEOUT_S on its recv) can close them under us


class TransferError(Exception):
    """The holder could not serve a requested range (object vanished,
    stream died mid-transfer)."""


class _Rejected(Exception):
    """In-protocol refusal (status != OK) at a clean frame boundary —
    the stream stays usable and the request must NOT be retried."""


def _tune(sock: socket.socket) -> None:
    from ray_tpu_torch._private.config import config

    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    buf = int(config.object_transfer_sock_buf_bytes)
    # syscalls bound throughput on this plane; big kernel buffers keep
    # the bytes moved per send()/recv() call large
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, buf)
        except OSError:
            pass
    sock.settimeout(_IO_TIMEOUT_S)


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    pos = 0
    while pos < len(view):
        n = sock.recv_into(view[pos:])
        if n == 0:
            raise TransferError("transfer stream closed mid-payload")
        pos += n


def _recv_exact(sock: socket.socket, size: int,
                eof_ok: bool = False) -> Optional[bytearray]:
    """Read exactly `size` bytes; None on clean EOF at a frame boundary
    (eof_ok), TransferError on EOF mid-frame."""
    buf = bytearray(size)
    view = memoryview(buf)
    pos = 0
    while pos < size:
        n = sock.recv_into(view[pos:])
        if n == 0:
            if pos == 0 and eof_ok:
                return None
            raise TransferError("transfer stream closed mid-frame")
        pos += n
    return buf


def _discard(sock: socket.socket, length: int) -> None:
    """Read and drop exactly `length` payload bytes through a small
    fixed scratch buffer."""
    scratch = bytearray(min(length, 256 * 1024))
    view = memoryview(scratch)
    left = length
    while left > 0:
        n = sock.recv_into(view[:min(left, len(scratch))])
        if n == 0:
            raise TransferError("transfer stream closed mid-payload")
        left -= n


class _MappedFile:
    """A read/write mmap of a disk-fallback object file, so disk objects
    move through the same view-based path as arena objects."""

    def __init__(self, path: str, size: int, writable: bool):
        self.last_used = time.monotonic()
        with open(path, "r+b" if writable else "rb") as f:
            prot = mmap.PROT_READ | (mmap.PROT_WRITE if writable else 0)
            self._mm = mmap.mmap(f.fileno(), size, mmap.MAP_SHARED, prot)
        self.view = memoryview(self._mm)

    def close(self) -> None:
        try:
            self.view.release()
        except Exception:
            pass
        try:
            self._mm.close()
        except Exception:
            pass


class ObjectTransferServer:
    """Holder side: serves ranges of sealed local objects.

    The puller pins the object over control RPC (obj_info with pin_for)
    before the first range request, so entries cannot be dropped or
    spilled out from under an in-flight send; the store's entry fields
    are therefore stable for the duration and safe to read from the
    serving threads.
    """

    def __init__(self, store):
        self.store = store
        self.port = 0
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: Dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._stopped = False
        # disk-fallback objects mmap'd once per pull, not per chunk
        self._maps: Dict[str, _MappedFile] = {}
        self.bytes_out = 0

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(64)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rt-xfer-accept", daemon=True)
        self._accept_thread.start()
        return self.port

    async def stop(self) -> None:
        self._stopped = True
        if self._sock is not None:
            # shutdown BEFORE close: the accept thread blocked in
            # accept() holds the socket alive past close(), so the port
            # would keep accepting; shutdown wakes it deterministically
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        with self._lock:
            for m in self._maps.values():
                m.close()
            self._maps.clear()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stopped:  # raced a stop() that landed mid-accept
                try:
                    conn.close()
                except OSError:
                    pass
                return
            _tune(conn)
            with self._lock:
                self._conns[conn.fileno()] = conn
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="rt-xfer-serve", daemon=True).start()

    def object_view(self, oid: str, offset: int,
                    length: int) -> Optional[memoryview]:
        """A memoryview over [offset, offset+length) of a sealed local
        object, or None if it cannot be served.  Disk-fallback objects
        are served from an mmap cached across the pull (dropped on
        obj_unpin via release(), LRU-trimmed otherwise) — shared by the
        bulk streams AND the legacy obj_chunk RPC path."""
        entry = self.store.objects.get(oid)
        if entry is None or not entry.sealed:
            return None
        if offset < 0 or length < 0 or offset + length > entry.size:
            return None
        entry.last_used = time.monotonic()
        if entry.location == "shm":
            base = entry.offset
            return self.store.arena.view[base + offset:base + offset + length]
        with self._lock:
            m = self._maps.get(oid)
            if m is None:
                try:
                    m = _MappedFile(entry.path, entry.size, writable=False)
                except OSError:
                    return None
                self._maps[oid] = m
                self._trim_maps()
            m.last_used = time.monotonic()
            return m.view[offset:offset + length]

    def _trim_maps(self, keep: int = 8) -> None:
        # caller holds self._lock
        while len(self._maps) > keep:
            oid = min(self._maps, key=lambda o: self._maps[o].last_used)
            self._maps.pop(oid).close()

    def cache_stats(self) -> Dict[str, int]:
        """Footprint of the across-pull disk mmap cache — one line of
        the node's memory breakdown (`rtpu memory`)."""
        with self._lock:
            return {"files": len(self._maps),
                    "bytes": sum(m.view.nbytes for m in self._maps.values())}

    def release(self, oid: str) -> None:
        """Pull finished (obj_unpin): drop any held disk mapping."""
        with self._lock:
            m = self._maps.pop(oid, None)
        if m is not None:
            m.close()

    def channel_view(self, oid: str, offset: int,
                     length: int) -> Optional[memoryview]:
        """A writable view over a CHANNEL slot — the only entries the
        push path may mutate.  Channels are permanently pinned and live
        in shm, so the arena range is stable for the write."""
        entry = self.store.objects.get(oid)
        if entry is None or not getattr(entry, "channel", False) \
                or entry.location != "shm":
            return None
        if offset < 0 or length < 0 or offset + length > entry.size:
            return None
        base = entry.offset
        return self.store.arena.view[base + offset:base + offset + length]

    def _serve_conn(self, sock: socket.socket):
        fd = sock.fileno()
        try:
            while True:
                hdr = _recv_exact(sock, _REQ.size, eof_ok=True)
                if hdr is None:
                    return
                oid_len, offset, length = _REQ.unpack(hdr)
                is_write = bool(oid_len & _WRITE_FLAG)
                oid_len &= ~_WRITE_FLAG
                if oid_len == 0 or oid_len > _MAX_REQ_OID:
                    raise TransferError(f"bad oid length {oid_len}")
                oid = bytes(_recv_exact(sock, oid_len)).decode()
                if is_write:
                    view = self.channel_view(oid, offset, length)
                    if view is None:
                        # drain the payload (bounded scratch, never an
                        # allocation of the peer-supplied length) to
                        # keep stream framing sane
                        _discard(sock, length)
                        sock.sendall(_RSP.pack(_NOT_FOUND, 0))
                        continue
                    _recv_into(sock, view)
                    sock.sendall(_RSP.pack(_OK, 0))
                    continue
                view = self.object_view(oid, offset, length)
                if view is None:
                    sock.sendall(_RSP.pack(_NOT_FOUND, 0))
                    continue
                chaos = fault_injection.decide("xfer.send", key=oid)
                if chaos is not None:
                    if chaos.action == "delay":
                        fault_injection.sleep_sync(chaos.delay_s)
                    elif chaos.action == "sever":
                        raise TransferError("chaos: stream severed")
                    elif chaos.action == "truncate":
                        # promise the full range, deliver half, die —
                        # the puller hits EOF mid-payload (TransferError)
                        # exactly as if the holder crashed mid-stripe
                        sock.sendall(_RSP.pack(_OK, length))
                        sock.sendall(view[:length // 2])
                        raise TransferError("chaos: truncated mid-stripe")
                    elif chaos.action == "corrupt":
                        # flip bytes in a COPY (never the arena itself)
                        buf = bytearray(view)
                        for i in range(0, len(buf), 997):
                            buf[i] ^= 0xFF
                        sock.sendall(_RSP.pack(_OK, length))
                        sock.sendall(buf)
                        self.bytes_out += length
                        continue
                sock.sendall(_RSP.pack(_OK, length))
                sock.sendall(view)
                self.bytes_out += length
        except (TransferError, OSError, socket.timeout):
            pass
        finally:
            with self._lock:
                self._conns.pop(fd, None)
            try:
                sock.close()
            except OSError:
                pass


class ObjectTransferClient:
    """Puller side: a small pool of streams to ONE holder's transfer
    server; concurrent fetches check sockets out of the pool.  The
    blocking per-stripe loops run on executor threads so the calling
    event loop never blocks."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._free: List[Tuple[socket.socket, float]] = []  # (sock, checkin)
        self._lock = threading.Lock()
        self.closed = False

    def _checkout(self) -> Tuple[socket.socket, bool]:
        """A stream to the holder: (socket, fresh).  Pooled sockets past
        the idle horizon are discarded — the holder has likely timed
        them out already."""
        from ray_tpu_torch._private.config import config

        now = time.monotonic()
        with self._lock:
            # sweep the WHOLE pool, not just popped entries: an old
            # socket pinned under a frequently-reused one would
            # otherwise sit in CLOSE_WAIT forever once the holder's
            # idle timeout closes its end
            fresh_enough = []
            stale = []
            for sock, ts in self._free:
                (stale if now - ts > _POOL_IDLE_S else
                 fresh_enough).append((sock, ts))
            self._free = fresh_enough
            picked = self._free.pop() if self._free else None
        for sock, _ts in stale:
            try:
                sock.close()
            except OSError:
                pass
        if picked is not None:
            return picked[0], False
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        _tune(sock)
        sock.settimeout(float(config.rpc_connect_timeout_s))
        try:
            sock.connect((self.host, self.port))
        except OSError:
            sock.close()
            raise
        sock.settimeout(_IO_TIMEOUT_S)
        return sock, True

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self.closed:
                self._free.append((sock, time.monotonic()))
                return
        sock.close()

    def close(self) -> None:
        with self._lock:
            self.closed = True
            free, self._free = self._free, []
        for sock, _ts in free:
            try:
                sock.close()
            except OSError:
                pass

    def _sync_round(self, request_fn):
        """One blocking request/response round on a pooled stream,
        retrying on a fresh stream when a POOLED one turns out dead
        (channel range reads/writes are idempotent).  `request_fn(sock)`
        returns the result, raising _Rejected for a clean in-protocol
        refusal (frame boundary intact, stream reusable)."""
        while True:
            sock, fresh = self._checkout()
            try:
                result = request_fn(sock)
                self._checkin(sock)
                return result
            except _Rejected as e:
                self._checkin(sock)
                raise TransferError(str(e)) from None
            except (TransferError, OSError) as e:
                try:
                    sock.close()
                except OSError:
                    pass
                if fresh:
                    if isinstance(e, socket.timeout):
                        raise TransferError(f"transfer stalled: {e}") from e
                    raise
                # stale pooled stream: loop onto a fresher connection

    def write_range(self, oid: str, offset: int, payload) -> None:
        """Blocking channel push: store `payload` at [offset, ...) of a
        CHANNEL slot on the holder (compiled-DAG mutable channels)."""
        oid_b = oid.encode()

        def round_(sock):
            sock.sendall(_REQ.pack(len(oid_b) | _WRITE_FLAG, offset,
                                   len(payload)) + oid_b)
            sock.sendall(payload)
            status, _n = _RSP.unpack(_recv_exact(sock, _RSP.size))
            if status != _OK:
                raise _Rejected(f"channel write to {oid[:16]} rejected "
                                f"by {self.host}:{self.port}")

        self._sync_round(round_)

    def read_range(self, oid: str, offset: int, length: int) -> bytearray:
        """Blocking single-range read (channel cursor words etc.)."""
        oid_b = oid.encode()

        def round_(sock):
            sock.sendall(_REQ.pack(len(oid_b), offset, length) + oid_b)
            status, n = _RSP.unpack(_recv_exact(sock, _RSP.size))
            if status != _OK:
                raise _Rejected(f"range of {oid[:16]} not served by "
                                f"{self.host}:{self.port}")
            if n != length:
                raise TransferError(
                    f"short range reply for {oid[:16]}: {n} != {length}")
            return _recv_exact(sock, length)

        return self._sync_round(round_)

    async def fetch_into(self, oid: str, dest: memoryview) -> None:
        """Pull the whole object into `dest` (len(dest) == object size):
        striped across parallel streams when large, windowed chunk
        pipeline within each stream."""
        from ray_tpu_torch._private.config import config

        size = len(dest)
        chunk = max(64 * 1024, int(config.object_transfer_chunk_bytes))
        window = max(1, int(config.object_transfer_window))
        streams = 1
        if size >= int(config.object_transfer_parallel_threshold):
            streams = max(1, min(int(config.object_transfer_max_streams),
                                 (size + chunk - 1) // chunk))
        loop = asyncio.get_running_loop()
        if streams == 1:
            await loop.run_in_executor(
                None, self._fetch_range, oid, dest, 0, size, chunk, window)
            return
        stripe = ((size // streams) // chunk + 1) * chunk
        jobs = []
        start = 0
        while start < size:
            end = min(size, start + stripe)
            jobs.append(loop.run_in_executor(
                None, self._fetch_range, oid, dest, start, end, chunk,
                window))
            start = end
        # return_exceptions: ALL stripe threads must finish before this
        # raises — the caller aborts the store allocation on failure,
        # and a still-running blocking thread writing into a freed
        # (and possibly re-allocated) arena range would corrupt
        # whatever object lands there next
        results = await asyncio.gather(*jobs, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r

    def _fetch_range(self, oid: str, dest: memoryview,
                     start: int, end: int, chunk: int, window: int) -> None:
        """Blocking: fetch [start, end) of oid into dest, retrying on a
        fresh stream when a POOLED one turns out dead (the holder may
        have closed it between uses; object bytes are immutable, so
        refetching the range is idempotent).  A failure on a fresh
        stream is a real failure and propagates."""
        while True:
            sock, fresh = self._checkout()
            try:
                self._fetch_range_on(sock, oid, dest, start, end, chunk,
                                     window)
                return
            except (TransferError, OSError) as e:
                try:
                    sock.close()
                except OSError:
                    pass
                if fresh:
                    if isinstance(e, socket.timeout):
                        raise TransferError(f"transfer stalled: {e}") from e
                    raise
                # stale pooled stream: loop — the pool drains toward a
                # fresh connection, so this terminates

    def _fetch_range_on(self, sock: socket.socket, oid: str,
                        dest: memoryview, start: int, end: int, chunk: int,
                        window: int) -> None:
        """One attempt on one stream, keeping `window` chunk requests in
        flight (requests are ~50 bytes — they can never fill the send
        buffer, so writing ahead of the reads cannot deadlock)."""
        oid_b = oid.encode()
        offsets = iter(range(start, end, chunk))
        pending: List[Tuple[int, int]] = []

        def send_next() -> None:
            off = next(offsets, None)
            if off is None:
                return
            n = min(chunk, end - off)
            sock.sendall(_REQ.pack(len(oid_b), off, n) + oid_b)
            pending.append((off, n))

        for _ in range(window):
            send_next()
        while pending:
            off, n = pending.pop(0)
            hdr = _recv_exact(sock, _RSP.size)
            status, length = _RSP.unpack(hdr)
            if status != _OK:
                raise TransferError(
                    f"object {oid[:16]} not served by "
                    f"{self.host}:{self.port}")
            if length != n:
                raise TransferError(
                    f"short range reply for {oid[:16]}: {length} != {n}")
            _recv_into(sock, dest[off:off + n])
            send_next()
        # clean completion at a frame boundary: the stream is reusable
        self._checkin(sock)


def dest_view(store, loc: dict) -> Tuple[memoryview, Optional[_MappedFile]]:
    """Writable view over a just-created (unsealed) store allocation.

    Returns (view, mapped_file): the caller closes mapped_file (disk
    fallback destinations) after the transfer; shm destinations write
    straight into the arena and return None."""
    size = loc["size"]
    if loc["location"] == "shm":
        off = loc["offset"]
        return store.arena.view[off:off + size], None
    m = _MappedFile(loc["path"], size, writable=True)
    return m.view[:size], m


# ------------------------------------------------- KV-page shipping format
# Disaggregated LLM prefill (serve/llm.py) ships finished KV pages from
# prefill replicas to decode replicas as ordinary sealed store objects —
# the pull itself rides the bulk plane above with the seal-time CRC32 +
# alternate-holder retry machinery.  The pack format adds its OWN crc
# over the payload as defense in depth: a decode replica attaching pages
# into live pools must detect corruption even when object-level
# checksums are disabled (object_checksums=False) or the bytes came
# from a local, never-transferred copy.

_KV_MAGIC = b"RTKV"
_KV_HDR = struct.Struct("<4sII")  # magic, crc32(payload), payload length


def pack_kv_pages(meta: Dict, rows: Dict) -> bytes:
    """Serialize one sequence's prefilled KV rows + metadata into a
    self-checksummed blob.  ``meta`` is a small picklable dict (request
    id, prompt tokens, first generated token, slot count, page size);
    ``rows`` is {"k": [per-layer host arrays], "v": [...]} as returned
    by models.llama.gather_kv_slots."""
    import pickle
    import zlib

    payload = pickle.dumps({"meta": dict(meta), "rows": rows},
                           protocol=pickle.HIGHEST_PROTOCOL)
    return _KV_HDR.pack(_KV_MAGIC, zlib.crc32(payload),
                        len(payload)) + payload


def unpack_kv_pages(buf: bytes) -> Tuple[Dict, Dict]:
    """Parse and byte-verify a pack_kv_pages blob -> (meta, rows).
    Raises TransferError on a bad magic, length, or crc — the caller
    (decode-replica attach) falls back to a local re-prefill rather
    than scattering corrupt rows into live KV pools."""
    import pickle
    import zlib

    if len(buf) < _KV_HDR.size:
        raise TransferError(f"kv pack too short ({len(buf)} bytes)")
    magic, crc, length = _KV_HDR.unpack_from(buf)
    payload = bytes(buf[_KV_HDR.size:])
    if magic != _KV_MAGIC or len(payload) != length:
        raise TransferError("kv pack header mismatch")
    actual = zlib.crc32(payload)
    if actual != crc:
        raise TransferError(
            f"kv pack checksum mismatch: payload crc {actual:#010x} "
            f"!= packed crc {crc:#010x}")
    d = pickle.loads(payload)
    return d["meta"], d["rows"]
