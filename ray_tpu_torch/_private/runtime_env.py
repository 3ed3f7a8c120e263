"""Per-task/actor runtime environments.

Equivalent of the reference's runtime_env subsystem
(reference: python/ray/_private/runtime_env/working_dir.py:1, pip.py:1,
packaging.py — the driver packages local dirs into content-addressed
zips uploaded to GCS; agents download + extract once per content hash;
workers start inside the env).

Supported keys:
  env_vars:    {str: str} merged into the worker's process env
  working_dir: local dir, packaged + extracted; worker chdirs into it
               and prepends it to sys.path
  py_modules:  list of local dirs, packaged; prepended to sys.path
  pip:         GATED — this image has no network; requirements already
               present in the base env pass (validated via
               importlib.metadata), anything else raises at submission

Packages travel through the head's internal KV (`pkg:<sha256>` keys) —
fine for the code-dir sizes these carry; bulk data belongs in the
object store.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip", "config"}
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".eggs"}
MAX_PACKAGE_BYTES = 100 * 1024 * 1024


class RuntimeEnvError(Exception):
    pass


def _package_dir(path: str) -> Tuple[str, bytes]:
    """Deterministic zip of a directory -> (sha256, bytes).

    Timestamps are pinned so identical trees hash identically across
    machines (reference: packaging.py's content-addressed pkg URIs).
    """
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise RuntimeEnvError(f"runtime_env dir does not exist: {path}")
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for fname in sorted(files):
            if fname.endswith(".pyc"):
                continue
            full = os.path.join(root, fname)
            entries.append((os.path.relpath(full, path), full))
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in entries:
            with open(full, "rb") as f:
                data = f.read()
            total += len(data)
            if total > MAX_PACKAGE_BYTES:
                raise RuntimeEnvError(
                    f"runtime_env package {path} exceeds "
                    f"{MAX_PACKAGE_BYTES >> 20} MiB")
            info = zipfile.ZipInfo(rel, date_time=(2000, 1, 1, 0, 0, 0))
            info.external_attr = 0o644 << 16
            zf.writestr(info, data)
    blob = buf.getvalue()
    return hashlib.sha256(blob).hexdigest(), blob


def _check_pip(requirements: List[str]) -> None:
    """No network in this image: accept requirements the base env already
    satisfies (name AND version specifier), reject the rest loudly
    rather than failing at runtime."""
    import importlib.metadata as md

    from packaging.requirements import Requirement

    missing = []
    for req in requirements:
        try:
            parsed = Requirement(req)
        except Exception:
            missing.append(f"{req} (unparseable)")
            continue
        try:
            installed = md.version(parsed.name)
        except md.PackageNotFoundError:
            missing.append(req)
            continue
        if parsed.specifier and not parsed.specifier.contains(
                installed, prereleases=True):
            missing.append(f"{req} (installed: {installed})")
    if missing:
        raise RuntimeEnvError(
            f"pip runtime_env cannot be satisfied offline; unsatisfied in "
            f"the base environment: {missing}")


def normalize(renv: Dict[str, Any], head) -> Dict[str, Any]:
    """Driver-side: validate, package dirs, upload once, and rewrite to
    the wire form ({'pkg_working_dir': sha, 'pkg_py_modules': [sha...]}).

    `head` is the driver's sync head client (kv transport).
    """
    bad = set(renv) - _SUPPORTED
    if bad:
        raise RuntimeEnvError(f"unsupported runtime_env key(s): {sorted(bad)}")
    out: Dict[str, Any] = {}
    env_vars = renv.get("env_vars") or {}
    if env_vars:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in env_vars.items()):
            raise RuntimeEnvError("env_vars must be {str: str}")
        out["env_vars"] = dict(env_vars)
    if renv.get("pip"):
        _check_pip(list(renv["pip"]))
        out["pip_checked"] = sorted(renv["pip"])
    for key, many in (("working_dir", False), ("py_modules", True)):
        src = renv.get(key)
        if not src:
            continue
        paths = list(src) if many else [src]
        shas = []
        for p in paths:
            sha, blob = _package_dir(p)
            kv_key = f"pkg:{sha}"
            # presence check via key listing — kv_get would ship the
            # whole blob back just to discard it
            if not head.call("kv_keys", prefix=kv_key)["keys"]:
                head.call("kv_put", key=kv_key, value=blob, overwrite=True)
            shas.append(sha)
        out["pkg_py_modules" if many else "pkg_working_dir"] = \
            shas if many else shas[0]
    return out


def env_key(renv: Dict[str, Any]) -> str:
    """Stable identity of a normalized runtime env; workers are pooled
    per key (reference: worker_pool.h keys idle workers by runtime env
    hash so an env-X lease never reuses an env-Y worker)."""
    if not renv:
        return ""
    return hashlib.sha256(
        json.dumps(renv, sort_keys=True).encode()).hexdigest()[:16]


async def materialize(renv: Dict[str, Any], session_dir: str,
                      head) -> Tuple[Dict[str, str], Optional[str], List[str]]:
    """Agent-side: fetch + extract packages (cached per content hash);
    returns (env_vars, working_dir or None, extra sys.path dirs).

    `head` is the agent's async head RpcClient.
    """
    env_vars = dict(renv.get("env_vars") or {})
    cache_root = os.path.join(session_dir, "runtime_envs")
    extracted: Dict[str, str] = {}

    async def ensure(sha: str) -> str:
        dest = os.path.join(cache_root, sha)
        if not os.path.isdir(dest):
            reply = await head.call("kv_get", key=f"pkg:{sha}")
            blob = reply["value"]
            if blob is None:
                raise RuntimeEnvError(f"package pkg:{sha} missing from KV")
            tmp = dest + ".tmp"
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.replace(tmp, dest)
            except OSError:
                if not os.path.isdir(dest):  # concurrent extraction lost
                    raise
                shutil.rmtree(tmp, ignore_errors=True)
        return dest

    working_dir = None
    if renv.get("pkg_working_dir"):
        working_dir = await ensure(renv["pkg_working_dir"])
    path_dirs = []
    for sha in renv.get("pkg_py_modules", []):
        path_dirs.append(await ensure(sha))
    return env_vars, working_dir, path_dirs


def merge(job_env: Dict[str, Any], task_env: Dict[str, Any]) -> Dict[str, Any]:
    """Task-level runtime_env overrides the job default; env_vars merge
    key-wise (reference: runtime_env merge semantics)."""
    if not job_env:
        return task_env
    if not task_env:
        return job_env
    out = {**job_env, **task_env}
    if job_env.get("env_vars") or task_env.get("env_vars"):
        out["env_vars"] = {**(job_env.get("env_vars") or {}),
                           **(task_env.get("env_vars") or {})}
    return out
