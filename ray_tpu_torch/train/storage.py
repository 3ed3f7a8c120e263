"""Checkpoint/result storage over fsspec URIs (local, memory, s3, gs).

A copy of ray_tpu/train/storage.py (the port imports nothing of
ray_tpu): one storage_path that may be local or remote; checkpoints are
uploaded after local save and downloaded before restore.
torch.distributed.checkpoint writes the shards locally; this layer only
moves the finished checkpoint directory.

Backends:
  /abs/path or file://...  local filesystem (no copy when already local)
  memory://...             in-process fs (tests)
  s3://... gs://...        via fsspec, when the optional backend
                           (s3fs/gcsfs) is importable — otherwise a
                           clear error at construction, not mid-train
"""

from __future__ import annotations

import os
import posixpath
from typing import Optional, Tuple


def _split(uri: str) -> Tuple[str, str]:
    """(protocol, path)."""
    if "://" not in uri:
        return "file", os.path.abspath(uri)
    proto, rest = uri.split("://", 1)
    if proto == "file":
        return "file", os.path.abspath("/" + rest.lstrip("/"))
    return proto, rest


class StorageContext:
    def __init__(self, storage_path: str,
                 experiment_name: str = ""):
        self.protocol, base = _split(storage_path)
        self.experiment_path = (
            posixpath.join(base, experiment_name) if experiment_name else base)
        if self.protocol == "file":
            self.fs = None
            os.makedirs(self.experiment_path, exist_ok=True)
        else:
            try:
                import fsspec

                self.fs = fsspec.filesystem(self.protocol)
            except (ImportError, ValueError) as exc:
                raise ValueError(
                    f"storage protocol {self.protocol!r} needs an fsspec "
                    f"backend (e.g. s3fs/gcsfs): {exc}") from exc
            self.fs.makedirs(self.experiment_path, exist_ok=True)

    @property
    def is_remote(self) -> bool:
        return self.protocol != "file"

    def uri(self, *parts: str) -> str:
        path = posixpath.join(self.experiment_path, *parts)
        return path if self.protocol == "file" \
            else f"{self.protocol}://{path}"

    # ------------------------------------------------------------- dirs

    def persist_dir(self, local_dir: str, rel: str) -> str:
        """Upload a finished local directory to <experiment>/<rel>;
        returns the storage URI.  Local storage: no copy if already in
        place, else a directory copy."""
        dest = posixpath.join(self.experiment_path, rel)
        if self.protocol == "file":
            import shutil

            if os.path.abspath(local_dir) != dest:
                if os.path.exists(dest):
                    shutil.rmtree(dest)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                shutil.copytree(local_dir, dest)
            return dest
        self.fs.put(local_dir, dest, recursive=True)
        return f"{self.protocol}://{dest}"

    def fetch_dir(self, rel_or_uri: str, local_dir: str) -> str:
        """Download <experiment>/<rel> (or a full URI) into local_dir;
        returns the local path (which IS the storage path when local)."""
        proto, path = _split(rel_or_uri) if "://" in rel_or_uri \
            else (self.protocol, posixpath.join(self.experiment_path,
                                                rel_or_uri))
        if proto == "file":
            return path
        import shutil

        if os.path.exists(local_dir):
            shutil.rmtree(local_dir)
        # per-file download keyed on the source listing: deterministic
        # layout regardless of how a backend's recursive get nests dirs.
        # find() returns backend-normalized paths — normalize the base
        # the same way so relpath stays inside the tree.
        src = self.fs._strip_protocol(path.rstrip("/"))
        for remote_path, info in self.fs.find(src, withdirs=True,
                                              detail=True).items():
            rel = posixpath.relpath(remote_path, src)
            dest = os.path.join(local_dir, rel)
            if info.get("type") == "directory":
                os.makedirs(dest, exist_ok=True)  # keep empty dirs
                continue
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            self.fs.get_file(remote_path, dest)
        os.makedirs(local_dir, exist_ok=True)
        return local_dir

    # ------------------------------------------------------------ files

    def write_bytes(self, rel: str, data: bytes) -> None:
        """Binary sibling of write_text (actor-state snapshots ride
        this); local writes are atomic tmp+rename like the text path."""
        if self.protocol == "file":
            path = posixpath.join(self.experiment_path, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
            return
        with self.fs.open(posixpath.join(self.experiment_path, rel),
                          "wb") as f:
            f.write(data)

    def read_bytes(self, rel: str) -> Optional[bytes]:
        try:
            if self.protocol == "file":
                with open(posixpath.join(self.experiment_path, rel),
                          "rb") as f:
                    return f.read()
            with self.fs.open(posixpath.join(self.experiment_path, rel),
                              "rb") as f:
                return f.read()
        except (OSError, FileNotFoundError):
            return None

    def remove(self, rel: str) -> None:
        """Best-effort single-file delete (snapshot eviction)."""
        try:
            if self.protocol == "file":
                os.remove(posixpath.join(self.experiment_path, rel))
            else:
                self.fs.rm_file(posixpath.join(self.experiment_path, rel))
        except (OSError, FileNotFoundError):
            pass

    def write_text(self, rel: str, text: str) -> None:
        if self.protocol == "file":
            path = posixpath.join(self.experiment_path, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
            return
        with self.fs.open(posixpath.join(self.experiment_path, rel),
                          "w") as f:
            f.write(text)

    def read_text(self, rel: str) -> Optional[str]:
        try:
            if self.protocol == "file":
                with open(posixpath.join(self.experiment_path, rel)) as f:
                    return f.read()
            with self.fs.open(posixpath.join(self.experiment_path, rel),
                              "r") as f:
                return f.read()
        except (OSError, FileNotFoundError):
            return None

    def list_dir(self, rel: str = "") -> list:
        path = posixpath.join(self.experiment_path, rel) if rel \
            else self.experiment_path
        try:
            if self.protocol == "file":
                return sorted(os.listdir(path))
            return sorted(posixpath.basename(p.rstrip("/"))
                          for p in self.fs.ls(path, detail=False))
        except (OSError, FileNotFoundError):
            return []
