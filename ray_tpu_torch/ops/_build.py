"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with plain ``nvcc`` for ``sm_90a`` into a
shared library with a C interface, content-addressed by a hash of the
sources and flags, under ``ray_tpu_torch/_build/`` (listed in
.gitignore; delete it to force a rebuild).  Sources that are not built
yet compile in parallel, one ``nvcc`` each.  There is no background
build and no fallback: a failed ``nvcc`` or ``dlopen`` raises with the
compiler's output.  Every C entry point returns ``cudaGetLastError()``
after its launch, and :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {path}); the port's "
            f"CUDA kernels build from source at first use")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the bytes of the
    source, every shared header, and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(*names: str) -> Sequence[ctypes.CDLL]:
    """Build (in parallel) whichever of ``names`` are not built yet and
    load them; returns the libraries in order."""
    with _lock:
        missing = [n for n in names if n not in _libs]
        builds = []
        for name in missing:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            builds.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in builds:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed "
                              f"(rc {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: readers never see half a file
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in missing:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return [_libs[n] for n in names]


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu``'s library, with its argument
    types declared (pointers and the stream as ``c_void_p``) and an
    ``int`` CUDA error code as its result."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name)[0], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise when a C entry point of ``name`` returned a CUDA error."""
    if rc == 0:
        return
    err = load(name)[0].rt_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    raise RuntimeError(f"{what}: CUDA error {rc} "
                       f"({err(rc).decode(errors='replace')})")
