"""Job submission: supervised driver lifecycles on the cluster.

Ported from ray_tpu's job submission: the entrypoint process takes its
node's CUDA_VISIBLE_DEVICES (the node agent's, or none), not the
supervisor's CPU lease, which hides every card; and ``submit_job``
returns once the supervisor has begun the run, since the run call lives
in the submitting process until then.

Equivalent of the reference's job submission stack
(reference: dashboard/modules/job/job_manager.py — JobManager launches
a supervisor actor per job that runs the entrypoint as a subprocess,
streams logs, and tracks JobInfo in the GCS KV;
python/ray/dashboard/modules/job/sdk.py JobSubmissionClient).

The supervisor is a detached actor: it Popens the entrypoint with
RT_ADDRESS pointing at the cluster (so `ray_tpu_torch.init()` inside the job
connects automatically), captures combined output, and publishes
status + log tail to the internal KV where any client can read them.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Dict, List, Optional

_STATUS_KEY = "job:{}:status"
_LOGS_KEY = "job:{}:logs"
_INDEX_KEY = "job:index"

TERMINAL = ("SUCCEEDED", "FAILED", "STOPPED")


class _JobSupervisor:
    """Detached actor owning one job's entrypoint process
    (reference: job_manager.py JobSupervisor)."""

    LOG_FLUSH_PERIOD_S = 1.0
    LOG_CAP_BYTES = 1 << 20  # last 1 MiB of output is kept in the KV

    def __init__(self, job_id: str, entrypoint: str, working_dir: str,
                 env_vars: Dict[str, str], address: str):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.working_dir = working_dir
        self.env_vars = env_vars
        self.address = address
        self._stop_requested = False

    def _kv_put(self, key: str, value: bytes) -> None:
        from ray_tpu_torch.experimental import internal_kv

        internal_kv.kv_put(key, value)

    def _set_status(self, **fields) -> None:
        from ray_tpu_torch.experimental import internal_kv

        raw = internal_kv.kv_get(_STATUS_KEY.format(self.job_id))
        info = json.loads(raw) if raw else {}
        info.update(fields)
        self._kv_put(_STATUS_KEY.format(self.job_id),
                     json.dumps(info).encode())

    def run(self) -> str:
        """Run the entrypoint to completion; returns the final status."""
        import os
        import subprocess

        from ray_tpu_torch._private.spawn import set_pdeathsig
        from ray_tpu_torch._private.worker import SPAWN_VISIBLE_DEVICES

        env = dict(os.environ)
        # the entrypoint sees its node's cards, not this actor's CPU
        # lease, whose CUDA_VISIBLE_DEVICES "" hides every card
        if SPAWN_VISIBLE_DEVICES is None:
            env.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            env["CUDA_VISIBLE_DEVICES"] = SPAWN_VISIBLE_DEVICES
        env.update(self.env_vars)
        env["RT_ADDRESS"] = self.address
        env["RT_JOB_ID"] = self.job_id
        self._set_status(status="RUNNING", start_time=time.time(),
                         entrypoint=self.entrypoint)
        buf = bytearray()
        try:
            # own session/process group: stop() can kill the whole group
            # without touching this worker; PDEATHSIG still ties the job
            # to the supervisor's life
            proc = subprocess.Popen(
                self.entrypoint, shell=True,
                cwd=self.working_dir or None, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                preexec_fn=set_pdeathsig, start_new_session=True)
        except Exception as e:
            self._set_status(status="FAILED", end_time=time.time(),
                             message=f"spawn failed: {e}")
            return "FAILED"
        self._proc = proc
        os.set_blocking(proc.stdout.fileno(), False)
        last_flush = 0.0
        while True:
            chunk = proc.stdout.read(65536)  # None when no data (non-block)
            if chunk:
                buf.extend(chunk)
                if len(buf) > self.LOG_CAP_BYTES:
                    del buf[:len(buf) - self.LOG_CAP_BYTES]
            elif proc.poll() is not None:
                rest = proc.stdout.read()
                if rest:
                    buf.extend(rest)
                break
            else:
                time.sleep(0.05)
            now = time.monotonic()
            if now - last_flush >= self.LOG_FLUSH_PERIOD_S:
                last_flush = now
                self._kv_put(_LOGS_KEY.format(self.job_id), bytes(buf))
        self._kv_put(_LOGS_KEY.format(self.job_id), bytes(buf))
        if self._stop_requested:
            status = "STOPPED"
        else:
            status = "SUCCEEDED" if proc.returncode == 0 else "FAILED"
        self._set_status(status=status, end_time=time.time(),
                         returncode=proc.returncode)
        return status

    def stop(self) -> None:
        """Terminate the entrypoint process group."""
        import os
        import signal

        self._stop_requested = True
        proc = getattr(self, "_proc", None)
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except Exception:
                try:
                    proc.terminate()
                except Exception:
                    pass

    def ping(self) -> bool:
        return True


class JobSubmissionClient:
    """Submit and manage jobs against a running cluster
    (reference: dashboard/modules/job/sdk.py)."""

    SUBMIT_TIMEOUT_S = 120.0

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import global_worker_or_none

        self._owns_runtime = global_worker_or_none() is None
        if self._owns_runtime:
            ray_tpu_torch.init(address=address)
        self._address = address

    def close(self) -> None:
        if self._owns_runtime:
            import ray_tpu_torch

            ray_tpu_torch.shutdown()

    # ---- submission --------------------------------------------------------

    def submit_job(self, entrypoint: str, *, submission_id: str = "",
                   working_dir: Optional[str] = None,
                   env_vars: Optional[Dict[str, str]] = None) -> str:
        import ray_tpu_torch
        from ray_tpu_torch.experimental import internal_kv

        job_id = submission_id or f"rtjob-{uuid.uuid4().hex[:10]}"
        w = ray_tpu_torch.api._worker()
        address = f"{w.head_addr[0]}:{w.head_addr[1]}"
        # max_concurrency=2: stop() must get through while run() blocks
        supervisor = ray_tpu_torch.api.ActorClass(
            _JobSupervisor, name=f"_rt_job:{job_id}",
            lifetime="detached", max_concurrency=2).remote(
                job_id, entrypoint, working_dir or "", env_vars or {},
                address)
        self._kv_append_index(job_id)
        internal_kv.kv_put(
            _STATUS_KEY.format(job_id),
            json.dumps({"job_id": job_id, "status": "PENDING",
                        "entrypoint": entrypoint,
                        "submission_time": time.time()}).encode())
        supervisor.run.remote()  # fire and forget; status lands in KV
        # the run call lives in this process until the supervisor takes
        # it: a short-lived caller (`job submit` without --wait) must
        # not exit before, or the job stays PENDING with no run
        deadline = time.monotonic() + self.SUBMIT_TIMEOUT_S
        while self.get_job_status(job_id) == "PENDING":
            if time.monotonic() > deadline:
                raise TimeoutError(f"job {job_id}: no supervisor ran it "
                                   f"within {self.SUBMIT_TIMEOUT_S} s")
            time.sleep(0.05)
        return job_id

    def _kv_append_index(self, job_id: str) -> None:
        from ray_tpu_torch.experimental import internal_kv

        raw = internal_kv.kv_get(_INDEX_KEY)
        ids: List[str] = json.loads(raw) if raw else []
        ids.append(job_id)
        internal_kv.kv_put(_INDEX_KEY, json.dumps(ids[-1000:]).encode())

    # ---- queries -----------------------------------------------------------

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        from ray_tpu_torch.experimental import internal_kv

        raw = internal_kv.kv_get(_STATUS_KEY.format(job_id))
        if raw is None:
            raise ValueError(f"no such job: {job_id}")
        return json.loads(raw)

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id)["status"]

    def get_job_logs(self, job_id: str) -> str:
        from ray_tpu_torch.experimental import internal_kv

        raw = internal_kv.kv_get(_LOGS_KEY.format(job_id))
        return (raw or b"").decode(errors="replace")

    def list_jobs(self) -> List[Dict[str, Any]]:
        from ray_tpu_torch.experimental import internal_kv

        raw = internal_kv.kv_get(_INDEX_KEY)
        out = []
        for job_id in (json.loads(raw) if raw else []):
            try:
                out.append(self.get_job_info(job_id))
            except ValueError:
                continue
        return out

    def stop_job(self, job_id: str) -> None:
        import ray_tpu_torch

        try:
            sup = ray_tpu_torch.get_actor(f"_rt_job:{job_id}")
            ray_tpu_torch.get(sup.stop.remote(), timeout=30)
        except Exception as e:
            raise ValueError(f"cannot stop {job_id}: {e}") from e

    def wait_until_finish(self, job_id: str, timeout: float = 600.0,
                          poll_s: float = 0.5) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in TERMINAL:
                return status
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still "
                           f"{self.get_job_status(job_id)} after {timeout}s")
