"""WorkerGroup: a gang of actors executing SPMD work.

Ported from ray_tpu's worker group.  Equivalent of the reference's
WorkerGroup (reference: python/ray/train/_internal/worker_group.py) plus
the rank bookkeeping from BackendExecutor
(reference: _internal/backend_executor.py:347
_create_rank_world_size_mappings).

A worker that holds a GPU lease sees exactly its own cards through
``CUDA_VISIBLE_DEVICES`` (the runtime sets it per lease) and drives the
first of them, ``cuda:0``.  The user's loop runs in a thread of its own;
CUDA's current device is per thread, so the loop drives the same card
only because the lease leaves one card visible (``cuda:0`` in every
thread).
"""

from __future__ import annotations

import os
import socket
import threading
import traceback
from typing import Any, Dict, List, Optional

import cloudpickle


def _node_ip() -> str:
    """The address this worker's runtime serves on: its peers reach it
    there, so the gang's rendezvous does too."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    return w.address[0] if w is not None else "127.0.0.1"


def _free_port() -> int:
    """A port that was free on this node a moment ago."""
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TrainWorker:
    """Actor hosting one rank of the SPMD gang. The user's train loop
    runs in a thread so poll() stays responsive (actor methods execute
    serially)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self._session = None
        self._thread: Optional[threading.Thread] = None

    # ---- gang metadata -----------------------------------------------------

    def node_info(self) -> Dict[str, Any]:
        return {"hostname": socket.gethostname(), "pid": os.getpid(),
                "ip": _node_ip()}

    def free_port(self) -> int:
        return _free_port()

    def setup_env(self, env: Dict[str, str]) -> bool:
        os.environ.update(env)
        return True

    def init_distributed(self, coordinator: str, num_processes: int,
                         process_id: int) -> int:
        """Join the gang's process group (reference:
        train/torch/config.py:64 _setup_torch_process_group): nccl on
        ``cuda:0`` when this worker holds a GPU lease, gloo on the CPU
        when the trainer asked for the CPU.  Returns the world size."""
        from ray_tpu_torch._private.accelerators import visible_devices
        from ray_tpu_torch.parallel import init_distributed

        device = "cuda:0" if visible_devices() else "cpu"
        return init_distributed(coordinator, num_processes, process_id,
                                device=device)

    # ---- training ----------------------------------------------------------

    def run_async(self, fn_blob: bytes, config: Optional[Dict[str, Any]],
                  checkpoint: Optional[str] = None,
                  experiment_name: str = "", trial_dir: str = "",
                  datasets: Optional[Dict[str, Any]] = None) -> bool:
        from ray_tpu_torch.train.session import (TrainContext, _Session,
                                                 _set_session)

        fn = cloudpickle.loads(fn_blob)
        ctx = TrainContext(rank=self.rank, world_size=self.world_size,
                           local_rank=0, experiment_name=experiment_name,
                           trial_dir=trial_dir)
        session = _Session(ctx, checkpoint_to_restore=checkpoint,
                           datasets=datasets)
        self._session = session

        def target():
            from ray_tpu_torch.train.session import StopTrial

            _set_session(session)
            try:
                if config is not None:
                    session.final = fn(config)
                else:
                    session.final = fn()
            except StopTrial:
                pass  # controller-requested early stop: clean exit
            except BaseException as e:  # reported via poll()
                session.error = e
                session.reports.append(
                    {"metrics": {"_error": traceback.format_exc()},
                     "checkpoint": None})
            finally:
                session.finished.set()
                _set_session(None)

        self._thread = threading.Thread(target=target, name="rt-train", daemon=True)
        self._thread.start()
        return True

    def poll(self) -> Dict[str, Any]:
        s = self._session
        if s is None:
            return {"done": True, "reports": [], "error": None, "final": None}
        done = s.finished.is_set()
        err = None
        if done and s.error is not None:
            try:
                err = cloudpickle.dumps(s.error)
            except Exception:
                err = cloudpickle.dumps(RuntimeError(str(s.error)))
        return {"done": done, "reports": s.drain(), "error": err,
                "final": s.final if done and s.error is None else None}

    def request_stop(self) -> bool:
        """Ask the running loop to stop at its next report()."""
        if self._session is not None:
            self._session.stop_requested.set()
        return True

    def shutdown_worker(self) -> bool:
        return True


class WorkerGroup:
    """Driver-side handle to the actor gang."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 worker_cls: Any = None):
        import ray_tpu_torch

        cls = ray_tpu_torch.remote(worker_cls or TrainWorker)
        if resources_per_worker:
            cls = cls.options(resources=dict(resources_per_worker))
        self.num_workers = num_workers
        self.workers = [cls.remote(rank, num_workers)
                        for rank in range(num_workers)]

    def execute(self, method: str, *args, timeout: Optional[float] = 120.0,
                **kwargs) -> List[Any]:
        """Call a method on every worker, gather results (barrier)."""
        import ray_tpu_torch

        refs = [getattr(w, method).remote(*args, **kwargs) for w in self.workers]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def execute_single(self, rank: int, method: str, *args,
                       timeout: Optional[float] = 120.0, **kwargs) -> Any:
        import ray_tpu_torch

        ref = getattr(self.workers[rank], method).remote(*args, **kwargs)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def shutdown(self):
        import ray_tpu_torch

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
