"""Per-worker training session: rank context + report channel.

Ported from ray_tpu's session module, which it equals but for the
trainer's name.  Equivalent of the reference's _TrainSession
(reference: python/ray/train/_internal/session.py:109 — report :401,
public train.report :661, context accessors python/ray/train/context.py).
The user's train loop runs in a thread inside the TrainWorker actor;
`report(metrics, checkpoint=...)` enqueues results that the driver-side
trainer drains via actor polls.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TrainContext:
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_dir: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank


class StopTrial(Exception):
    """Raised inside report() when the controller requested a stop
    (reference: function_trainable.py StopCallback semantics)."""


class _Session:
    def __init__(self, ctx: TrainContext,
                 checkpoint_to_restore: Optional[str] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self.ctx = ctx
        self.lock = threading.Lock()
        self.reports: List[Dict[str, Any]] = []
        self.checkpoint_to_restore = checkpoint_to_restore
        self.datasets = datasets or {}
        self.finished = threading.Event()
        self.stop_requested = threading.Event()
        self.error: Optional[BaseException] = None
        self.final: Any = None

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[str]):
        if self.stop_requested.is_set():
            raise StopTrial()
        with self.lock:
            self.reports.append({"metrics": dict(metrics),
                                 "checkpoint": checkpoint})

    def drain(self) -> List[Dict[str, Any]]:
        with self.lock:
            out, self.reports = self.reports, []
            return out


_current: Optional[_Session] = None


def _set_session(s: Optional[_Session]):
    global _current
    _current = s


def _get_session() -> _Session:
    if _current is None:
        raise RuntimeError(
            "No training session: report()/get_context() must be called "
            "from inside a train loop launched by TorchTrainer")
    return _current


def get_context() -> TrainContext:
    return _get_session().ctx


def report(metrics: Dict[str, Any], checkpoint: Optional[str] = None) -> None:
    """Report metrics (and optionally a checkpoint directory) from a
    training worker (reference: train.report, session.py:661)."""
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[str]:
    """Checkpoint directory to restore from, when resuming."""
    return _get_session().checkpoint_to_restore


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to TorchTrainer(datasets=...)
    (reference: ray.train.get_dataset_shard)."""
    ds = _get_session().datasets.get(name)
    if ds is None:
        raise KeyError(f"no dataset shard named {name!r} for this worker")
    return ds
