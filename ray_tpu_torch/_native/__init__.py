"""Native (C) hot-path helpers, compiled in the background at first use.

Ported from ray_tpu's native helpers (the C source is a copy).  The
compute path is PyTorch on the card; this package natively accelerates
the *runtime* around it, starting with the object-store copy path
(reference: the C++ plasma client, src/ray/object_manager/plasma/
client.cc).  The C source lives next to this file; it is compiled with
``cc`` into the package's gitignored ``_build/`` directory (override
with ``RT_NATIVE_CACHE_DIR``), content-addressed, and loaded via
ctypes.  Every
entry point has a pure-Python fallback, so a missing toolchain only
costs speed, never correctness — and compilation happens on a
background thread so the first put never stalls behind the compiler.

Env: RT_DISABLE_NATIVE=1 forces the Python fallbacks (used by tests to
cover both paths).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_build_thread: Optional[threading.Thread] = None

# thread count for copies: bounded by the host's hardware threads;
# 8 measured fastest on the dev host even with 1 schedulable core
# (SMT + memory-level parallelism)
_COPY_THREADS = min(8, (os.cpu_count() or 1) * 2)


def _build_and_load() -> Optional[ctypes.CDLL]:
    src_path = os.path.join(_HERE, "copyfast.c")
    with open(src_path, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache_dir = os.environ.get(
        "RT_NATIVE_CACHE_DIR",
        os.path.join(os.path.dirname(_HERE), "_build"))
    so_path = os.path.join(cache_dir, f"copyfast-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(cache_dir, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-pthread",
                     src_path, "-o", tmp],
                    check=True, capture_output=True, timeout=60)
                os.replace(tmp, so_path)
                break
            except (OSError, subprocess.SubprocessError):
                try:
                    os.unlink(tmp)  # partial output from a failed compile
                except OSError:
                    pass
                continue
        else:
            return None
    lib = ctypes.CDLL(so_path)
    lib.parallel_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_size_t, ctypes.c_int]
    lib.parallel_copy.restype = None
    lib.parallel_touch.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_int]
    lib.parallel_touch.restype = None
    lib.parallel_touch_write.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_int]
    lib.parallel_touch_write.restype = None
    lib.fl_new.argtypes = [ctypes.c_size_t]
    lib.fl_new.restype = ctypes.c_void_p
    lib.fl_destroy.argtypes = [ctypes.c_void_p]
    lib.fl_destroy.restype = None
    lib.fl_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.fl_alloc.restype = ctypes.c_size_t
    lib.fl_free.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                            ctypes.c_size_t]
    lib.fl_free.restype = ctypes.c_int
    lib.fl_allocated.argtypes = [ctypes.c_void_p]
    lib.fl_allocated.restype = ctypes.c_size_t
    lib.fl_largest.argtypes = [ctypes.c_void_p]
    lib.fl_largest.restype = ctypes.c_size_t
    return lib


def _background_build() -> None:
    global _lib, _load_failed
    try:
        lib = _build_and_load()
    except Exception:
        lib = None
    with _lock:
        _lib = lib
        _load_failed = lib is None


def _get_lib() -> Optional[ctypes.CDLL]:
    """Non-blocking: returns the loaded library, or None while the
    background build runs (callers fall back to Python meanwhile)."""
    global _build_thread
    if _lib is not None or _load_failed:
        return _lib
    if os.environ.get("RT_DISABLE_NATIVE"):
        return None
    with _lock:
        if _lib is None and not _load_failed and _build_thread is None:
            _build_thread = threading.Thread(
                target=_background_build, name="rt-native-build", daemon=True)
            _build_thread.start()
    return _lib


def warm_up() -> None:
    """Start the background compile (idempotent); call at process start
    so the library is ready before the first large copy."""
    _get_lib()


def available(wait: bool = True) -> bool:
    """True when the native library is loaded.  With wait=True, blocks
    for the in-flight background build (used by tests/benchmarks that
    must exercise the native path)."""
    _get_lib()
    t = _build_thread
    if wait and t is not None:
        t.join(timeout=120)
    return _get_lib() is not None


def _addr_len(buf, writable: bool):
    """(address, nbytes) of a buffer-protocol object without copying.
    numpy handles readonly buffers, which ctypes.from_buffer cannot."""
    import numpy as np

    arr = np.frombuffer(buf, dtype=np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("destination buffer is read-only")
    return arr.ctypes.data, arr.nbytes


def copy_into(dst, src) -> None:
    """dst[:] = src at multithreaded-memcpy speed; falls back to a
    plain memoryview copy while the native library is unavailable.
    Raises ValueError for a read-only destination or a length mismatch
    on BOTH paths."""
    dst_addr, dst_n = _addr_len(dst, writable=True)
    src_addr, src_n = _addr_len(src, writable=False)
    if dst_n != src_n:
        raise ValueError(f"length mismatch: dst {dst_n} != src {src_n}")
    lib = _get_lib()
    if lib is None:
        memoryview(dst)[:] = src
        return
    lib.parallel_copy(dst_addr, src_addr, dst_n, _COPY_THREADS)


class NativeFreeListAllocator:
    """C first-fit free-list allocator with coalescing; same contract as
    object_store.FreeListAllocator (reference: plasma/malloc.cc is the
    reference's native arena allocator).  Construct via make_allocator,
    which returns None when the native library is unavailable."""

    __slots__ = ("_h", "capacity")

    def __init__(self, handle, capacity: int):
        self._h = handle
        self.capacity = capacity

    @property
    def allocated(self) -> int:
        return _get_lib().fl_allocated(self._h)

    def alloc(self, size: int):
        off = _get_lib().fl_alloc(self._h, size)
        return None if off == ctypes.c_size_t(-1).value else off

    def free(self, offset: int, size: int) -> None:
        if _get_lib().fl_free(self._h, offset, size) != 0:
            # fl_free mutates nothing on failure; losing arena bytes
            # silently is worse than surfacing the (tiny) realloc failure
            raise MemoryError("free-list block array allocation failed")

    def largest_free(self) -> int:
        return _get_lib().fl_largest(self._h)

    def __del__(self):
        try:
            lib = _lib  # skip rebuild during interpreter teardown
            if lib is not None and self._h:
                lib.fl_destroy(self._h)
        except Exception:
            pass


def make_allocator(capacity: int, wait_s: float = 0.0):
    """Native allocator instance, or None (caller falls back to the
    behaviorally-identical Python FreeListAllocator).  By default this
    NEVER waits for the background compile — a cold cache costs one run
    on the Python allocator, not a startup stall.  Tests pass wait_s to
    guarantee the native path."""
    lib = _get_lib()
    if lib is None and wait_s > 0:
        t = _build_thread
        if t is not None:
            t.join(timeout=wait_s)
        lib = _get_lib()
    if lib is None:
        return None
    handle = lib.fl_new(capacity)
    if not handle:
        return None
    return NativeFreeListAllocator(handle, capacity)


def touch_pages(view) -> None:
    """Read-fault one byte per page (parallel when native is loaded)."""
    lib = _get_lib()
    if lib is None:
        bytes(memoryview(view)[::4096])
        return
    addr, n = _addr_len(view, writable=False)
    lib.parallel_touch(addr, n, _COPY_THREADS)


def touch_pages_write(view) -> None:
    """WRITE-fault one byte per page (content-preserving): installs
    writable PTEs in one pass, for regions the caller owns and is about
    to overwrite (plasma put).  Parallel when native is loaded."""
    lib = _get_lib()
    if lib is None:
        mv = memoryview(view)
        sl = mv[::4096]
        sl[:] = bytes(sl)  # read + write back the same bytes
        return
    addr, n = _addr_len(view, writable=True)
    lib.parallel_touch_write(addr, n, _COPY_THREADS)
