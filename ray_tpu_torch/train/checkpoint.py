"""Checkpoint helpers: torch.distributed.checkpoint save/restore + top-k
retention.

The port of ray_tpu/train/checkpoint.py.  A checkpoint is a directory.
A state is a tree (dicts, lists, tuples) of tensors and plain values: a
model's and an optimizer's ``state_dict``, a step count.  Its tensors go
through ``torch.distributed.checkpoint`` (DCP) under their tree paths,
so the same call saves sharded state from several processes without a
gather once a process group exists, as orbax does for the JAX package:
each process writes its own shards, and restoring into DTensors reads
each process's shards back; without a process group it runs in this
process alone.  The tree's shape and its plain values go beside them in
``tree.json``, which keeps what DCP's own flattening would lose (the int
keys of an optimizer's state).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import warnings
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

if TYPE_CHECKING:
    from ray_tpu_torch.train.storage import StorageContext

TREE_FILE = "tree.json"


def _encode(tree: Any, path: Tuple[Any, ...],
            tensors: Dict[str, torch.Tensor]) -> Any:
    """The JSON form of ``tree``; its tensors go into ``tensors`` keyed
    by their path."""
    if isinstance(tree, (np.ndarray, np.generic)):
        tree = torch.from_numpy(np.array(tree))
    if isinstance(tree, torch.Tensor):
        key = "/" + "/".join(str(p) for p in path)
        if key in tensors:
            raise ValueError(f"two tensors at one checkpoint path {key!r}")
        tensors[key] = tree.detach()
        return {"tensor": key}
    if isinstance(tree, dict):
        items = []
        for k, v in tree.items():
            if not isinstance(k, (str, int)):
                raise TypeError(f"checkpoint keys are str or int, got {k!r}")
            items.append([k, _encode(v, path + (k,), tensors)])
        return {"dict": items}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, path + (i,), tensors)
                       for i, v in enumerate(tree)]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _decode(node: Dict[str, Any], tensors: Dict[str, torch.Tensor]) -> Any:
    (kind, val), = node.items()
    if kind == "tensor":
        return tensors[val]
    if kind == "dict":
        return {k: _decode(v, tensors) for k, v in val}
    if kind == "list":
        return [_decode(v, tensors) for v in val]
    if kind == "tuple":
        return tuple(_decode(v, tensors) for v in val)
    return val


@contextlib.contextmanager
def _one_process_is_meant():
    """DCP runs in this process alone when no process group exists, and
    warns each time that it assumes so; here that is what is meant."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        yield


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save_checkpoint(path: str, state: Any) -> str:
    """Write a tree of tensors and plain values to ``path``.  Under a
    process group every process calls it with its own shards (DTensors,
    e.g. from ``torch.distributed.checkpoint.state_dict.get_state_dict``
    of an FSDP2 model and its optimizer) and the same plain values; each
    writes only its shards, and rank 0 alone clears the directory and
    writes the tree."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if _rank() == 0 and os.path.exists(path):
        shutil.rmtree(path)
    _barrier()
    tensors: Dict[str, torch.Tensor] = {}
    tree = _encode(state, (), tensors)
    with _one_process_is_meant():
        dcp.save(tensors, checkpoint_id=path)
    # the tree last: a directory that has it holds a whole checkpoint
    if _rank() == 0:
        tmp = os.path.join(path, TREE_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(tree, f)
        os.replace(tmp, os.path.join(path, TREE_FILE))
    _barrier()
    return path


def _empty_like(md, like: Optional[torch.Tensor]) -> torch.Tensor:
    if like is None:
        return torch.empty(md.size, dtype=md.properties.dtype, device="cpu")
    if isinstance(like, DTensor):
        # the target's mesh and placements: each process reads its shard
        return torch.empty_like(like)
    return torch.empty(md.size, dtype=like.dtype, device=like.device)


def restore_checkpoint(path: str, target: Any = None) -> Any:
    """Read a tree back, its tensors on the CPU in their saved dtypes;
    with ``target``, each tensor takes the dtype and device of the
    target's tensor at the same path, and a DTensor target its mesh and
    placements, so each process reads only its own shard.  ``target``
    itself is left as it was."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    with open(os.path.join(path, TREE_FILE)) as f:
        tree = json.load(f)
    like: Dict[str, torch.Tensor] = {}
    if target is not None:
        _encode(target, (), like)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    tensors = {key: _empty_like(md, like.get(key))
               for key, md in meta.items()}
    with _one_process_is_meant():
        dcp.load(tensors, checkpoint_id=path)
    return _decode(tree, tensors)


class CheckpointManager:
    """Top-k checkpoint retention by metric
    (reference: train/_internal/checkpoint_manager.py)."""

    def __init__(self, directory: str, *, num_to_keep: int = 2,
                 metric: Optional[str] = None, mode: str = "min",
                 storage: Optional["StorageContext"] = None):
        assert mode in ("min", "max")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.metric = metric
        self.mode = mode
        # optional remote persistence (reference: StorageContext —
        # checkpoints upload after local save, restore works from any
        # host that can reach the storage path)
        self.storage = storage
        self._entries: List[Dict[str, Any]] = []
        self._counter = 0
        self._load_index()
        if not self._entries and storage is not None:
            self._load_storage_index()

    def _index_path(self) -> str:
        return os.path.join(self.directory, "index.json")

    def _load_index(self):
        try:
            with open(self._index_path()) as f:
                data = json.load(f)
            self._entries = data["entries"]
            self._counter = data["counter"]
        except (OSError, ValueError, KeyError):
            pass

    def _save_index(self):
        with open(self._index_path(), "w") as f:
            json.dump({"entries": self._entries, "counter": self._counter}, f)

    def _load_storage_index(self):
        text = self.storage.read_text("checkpoints/index.json")
        if not text:
            return
        try:
            data = json.loads(text)
            self._entries = data["entries"]
            self._counter = data["counter"]
        except (ValueError, KeyError):
            pass

    def save(self, state: Any, metrics: Optional[Dict[str, Any]] = None) -> str:
        self._counter += 1
        name = f"ckpt_{self._counter:06d}"
        path = os.path.join(self.directory, name)
        save_checkpoint(path, state)
        entry: Dict[str, Any] = {"path": path, "metrics": metrics or {}}
        if self.storage is not None:
            # any storage path (NFS dir, memory://, s3://) gets the copy;
            # a local path identical to `path` is a no-op
            entry["uri"] = self.storage.persist_dir(
                path, f"checkpoints/{name}")
        self._entries.append(entry)
        self._evict()
        self._save_index()
        if self.storage is not None:
            self.storage.write_text(
                "checkpoints/index.json",
                json.dumps({"entries": self._entries,
                            "counter": self._counter}))
        return path

    def fetch(self, entry_path: str) -> str:
        """Local path for a checkpoint, downloading from storage when
        the local copy is absent (fresh host after a failover)."""
        if os.path.exists(entry_path):
            return entry_path
        entry = next((e for e in self._entries
                      if e["path"] == entry_path), None)
        if entry is None or "uri" not in entry or self.storage is None:
            return entry_path
        local = os.path.join(self.directory, os.path.basename(entry_path))
        return self.storage.fetch_dir(entry["uri"], local)

    def _score(self, entry) -> float:
        if self.metric is None:
            return 0.0
        v = entry["metrics"].get(self.metric)
        if v is None:  # metric-less checkpoints always rank worst
            return float("-inf") if self.mode == "max" else float("inf")
        return float(v)

    def _evict(self):
        if len(self._entries) <= self.num_to_keep:
            return
        # keep the k best by metric; metric-less -> most recent k
        # (reference: checkpoint_manager.py default recency retention);
        # the latest checkpoint is always kept for resume
        latest = self._entries[-1]
        if self.metric is None:
            keep = self._entries[-self.num_to_keep:]
        else:
            ranked = sorted(
                self._entries[:-1],
                key=self._score, reverse=(self.mode == "max"))
            keep = ranked[:self.num_to_keep - 1] + [latest]
        for entry in self._entries:
            if entry not in keep:
                shutil.rmtree(entry["path"], ignore_errors=True)
                if "uri" in entry and self.storage is not None:
                    try:  # evicted checkpoints leave storage too
                        if self.storage.fs is None:
                            if entry["uri"] != entry["path"]:
                                shutil.rmtree(entry["uri"],
                                              ignore_errors=True)
                        else:
                            self.storage.fs.rm(
                                entry["uri"].split("://", 1)[1],
                                recursive=True)
                    except Exception:
                        pass
        self._entries = [e for e in self._entries if e in keep]

    def best_checkpoint(self) -> Optional[str]:
        if not self._entries:
            return None
        if self.metric is None:
            return self._entries[-1]["path"]
        ranked = sorted(self._entries, key=self._score,
                        reverse=(self.mode == "max"))
        return ranked[0]["path"]

    def latest_checkpoint(self) -> Optional[str]:
        return self._entries[-1]["path"] if self._entries else None
