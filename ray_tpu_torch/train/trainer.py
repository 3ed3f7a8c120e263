"""TorchTrainer: SPMD training over a gang of GPU workers.

Ported from ray_tpu's JaxTrainer.  Equivalent of the reference's
TorchTrainer / DataParallelTrainer + BackendExecutor
(reference: python/ray/train/torch/torch_trainer.py;
data_parallel_trainer.py:22 training_loop :420;
_internal/backend_executor.py:65 — placement :197, rank mapping :347,
start_training :427, get_next_results :541):

  - ScalingConfig declares workers and per-worker resources: one GPU
    each by default, pinned by the runtime through CUDA_VISIBLE_DEVICES
    (``use_gpu=False`` asks for the CPU)
  - with more than one worker, the gang joins one torch.distributed
    process group before the loop starts (nccl over the GPUs, gloo on
    the CPU); inside the loop, ``make_mesh(spec)`` lays the mesh over
    the group's processes
  - worker failure fails the run (Train is not elastic in the reference
    either — SURVEY §5.3; restart-from-checkpoint is the recovery path)
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(Exception):
    pass


@dataclass
class ScalingConfig:
    """Reference: python/ray/air/config.py ScalingConfig."""

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        return {"GPU": 1} if self.use_gpu else {}


@dataclass
class RunConfig:
    name: str = "train_run"
    storage_path: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_results"))
    failure_max_retries: int = 0


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint: Optional[str] = None
    error: Optional[BaseException] = None
    per_worker_final: List[Any] = field(default_factory=list)


def _check_gpus(scaling: ScalingConfig) -> None:
    """Fail at once when the cluster cannot hold the gang's GPUs: a lease
    the cluster can never grant would otherwise wait out the launch
    timeout.  Nothing falls back to the CPU."""
    import ray_tpu_torch
    from ray_tpu_torch._private.errors import SchedulingError

    need = scaling.worker_resources().get("GPU", 0) * scaling.num_workers
    have = ray_tpu_torch.cluster_resources().get("GPU", 0)
    if need > have:
        raise SchedulingError(
            f"TorchTrainer needs {need:g} GPU for {scaling.num_workers} "
            f"worker(s) but the cluster has {have:g}; pass "
            f"ScalingConfig(use_gpu=False) to train on the CPU")


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[str] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self.train_loop = train_loop_per_worker
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.config = train_loop_config
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def fit(self) -> Result:
        """Run to completion, rebuilding the worker gang and resuming from
        the last reported checkpoint on failure, up to
        RunConfig.failure_max_retries times (reference:
        backend_executor.get_with_failure_handling :629 +
        tune_controller._schedule_trial_restore :1792 — Train is gang-
        restart, not elastic)."""
        _check_gpus(self.scaling)
        resume = self.resume_from_checkpoint
        history: List[Dict[str, Any]] = []
        failures = 0
        while True:
            group = WorkerGroup(self.scaling.num_workers,
                                self.scaling.worker_resources())
            try:
                return self._fit(group, resume, history)
            except TrainingFailedError as e:
                ckpt = getattr(e, "last_checkpoint", None)
                if ckpt:
                    resume = ckpt
                if failures >= self.run_config.failure_max_retries:
                    raise
                failures += 1
            finally:
                group.shutdown()

    def _fit(self, group: WorkerGroup, resume: Optional[str] = None,
             history: Optional[List[Dict[str, Any]]] = None) -> Result:
        import ray_tpu_torch

        n = group.num_workers
        trial_dir = os.path.join(self.run_config.storage_path,
                                 f"{self.run_config.name}-{int(time.time())}")
        os.makedirs(trial_dir, exist_ok=True)
        # multi-process rendezvous (reference: backend_executor start —
        # rank 0 address/port shared with the gang before the loop starts)
        if n > 1:
            try:
                info0 = group.execute_single(0, "node_info")
                port = group.execute_single(0, "free_port")
                coordinator = f"{info0['ip']}:{port}"
                self._init_distributed(group, coordinator, n)
            except ray_tpu_torch.RayError as e:
                err = TrainingFailedError(
                    f"worker gang failed during rendezvous: {e}")
                err.last_checkpoint = resume
                raise err from e
        fn_blob = cloudpickle.dumps(self.train_loop)
        # dataset ingest: each worker gets its round-robin block shard
        # (reference: _internal/data_config.py streaming_split)
        shard_map: Dict[int, Dict[str, Any]] = {r: {} for r in range(n)}
        for name, ds in self.datasets.items():
            for rank, shard in enumerate(ds.split(n)):
                shard_map[rank][name] = shard

        refs = []
        for rank, w in enumerate(group.workers):
            refs.append(w.run_async.remote(
                fn_blob, self.config, checkpoint=resume,
                experiment_name=self.run_config.name, trial_dir=trial_dir,
                datasets=shard_map[rank] or None))
        try:
            ray_tpu_torch.get(refs, timeout=120.0)
        except ray_tpu_torch.RayError as e:
            err = TrainingFailedError(f"worker gang failed to launch: {e}")
            err.last_checkpoint = resume
            raise err from e
        return self._poll_until_done(group, trial_dir, history)

    def _init_distributed(self, group: WorkerGroup, coordinator: str, n: int):
        import ray_tpu_torch

        refs = [w.init_distributed.remote(coordinator, n, rank)
                for rank, w in enumerate(group.workers)]
        ray_tpu_torch.get(refs, timeout=300.0)

    def _poll_until_done(self, group: WorkerGroup, trial_dir: str,
                         history: Optional[List[Dict[str, Any]]] = None) -> Result:
        import ray_tpu_torch

        history = history if history is not None else []
        last_checkpoint: Optional[str] = None
        done = [False] * group.num_workers
        finals: List[Any] = [None] * group.num_workers

        def _fail(msg: str, cause: BaseException):
            err = TrainingFailedError(msg)
            err.last_checkpoint = last_checkpoint  # resume point for fit()
            raise err from cause

        while not all(done):
            time.sleep(0.05)
            try:
                polls = group.execute("poll", timeout=120.0)
            except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.RayError) as e:
                _fail(f"a training worker died mid-run: {e}", e)
            for rank, p in enumerate(polls):
                for rep in p["reports"]:
                    if rank == 0 and "_error" not in rep["metrics"]:
                        history.append(rep["metrics"])
                    if rep.get("checkpoint"):
                        last_checkpoint = rep["checkpoint"]
                if p["done"] and not done[rank]:
                    done[rank] = True
                    if p["error"] is not None:
                        err = cloudpickle.loads(p["error"])
                        _fail(f"train loop failed on rank {rank}: {err}", err)
                    finals[rank] = p["final"]
        return Result(metrics=history[-1] if history else {},
                      metrics_history=history,
                      checkpoint=last_checkpoint,
                      per_worker_final=finals)
