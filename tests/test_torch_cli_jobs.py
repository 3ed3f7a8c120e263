"""The port's CLI (``python -m ray_tpu_torch.scripts``, installed as
``rtpu-torch``) and job submission.

The cases of tests/test_cli_jobs.py on the port: a cluster stood up from
the shell runs a submitted job to completion, a second node joins, a
spinning job stops and keeps its logs.  Then what the port changes.  A
job submitted without ``--wait`` runs: the reference's stays PENDING,
its run call dying with the CLI process.  And a job's entrypoint sees
its node's cards: the supervisor actor holds a CPU lease, whose
``CUDA_VISIBLE_DEVICES`` is "" (every card hidden); the entrypoint takes
the node agent's own value instead, or none when the agent had none, as
the reference's entrypoint sees every chip of its node.  No card is
touched: a head started with ``CUDA_VISIBLE_DEVICES=0`` counts one GPU,
and the entrypoint prints the variable.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private.spawn import fast_python_cmd

from tests.torch_waits import bounded


@pytest.fixture
def isolated_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("RT_TMPDIR", str(tmp_path))
    return str(tmp_path)


def _cli(args, tmpdir, timeout=120, env_extra=None):
    cmd, env_up = fast_python_cmd("ray_tpu_torch.scripts", list(args))
    env = dict(os.environ)
    env.update(env_up)
    env["RT_TMPDIR"] = tmpdir
    for k, v in (env_extra or {}).items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _address(start_stdout: str) -> str:
    return [ln for ln in start_stdout.splitlines()
            if "cluster started at" in ln][0].split()[-1]


def test_cli_start_status_job_stop(isolated_tmpdir):
    tmp = isolated_tmpdir
    r = _cli(["start", "--head", "--num-cpus", "4"], tmp)
    assert r.returncode == 0, r.stderr
    assert "cluster started at" in r.stdout
    try:
        r = _cli(["status"], tmp)
        assert r.returncode == 0, r.stderr
        assert "1 node(s)" in r.stdout

        script = os.path.join(tmp, "jobscript.py")
        with open(script, "w") as f:
            f.write(
                "import ray_tpu_torch\n"
                "ray_tpu_torch.init()\n"  # RT_ADDRESS from the supervisor
                "@ray_tpu_torch.remote\n"
                "def sq(x):\n"
                "    return x * x\n"
                "print('job result:', ray_tpu_torch.get("
                "[sq.remote(i) for i in range(4)], timeout=60))\n"
                "ray_tpu_torch.shutdown()\n")
        r = _cli(["job", "submit", "--wait", "--",
                  sys.executable, "-S", script], tmp, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "SUCCEEDED" in r.stdout
        assert "job result: [0, 1, 4, 9]" in r.stdout

        r = _cli(["job", "list"], tmp)
        assert r.returncode == 0
        assert "SUCCEEDED" in r.stdout
    finally:
        r = _cli(["stop"], tmp)
    assert r.returncode == 0, r.stderr


def test_cli_worker_join(isolated_tmpdir):
    tmp = isolated_tmpdir
    r = _cli(["start", "--head", "--num-cpus", "2"], tmp)
    assert r.returncode == 0, r.stderr
    address = _address(r.stdout)
    try:
        r = _cli(["start", "--address", address, "--num-cpus", "2",
                  "--resources", json.dumps({"extra": 1})], tmp)
        assert r.returncode == 0, r.stderr
        deadline = time.monotonic() + 30
        ok = False
        while time.monotonic() < deadline:
            r = _cli(["status"], tmp)
            if "2 node(s)" in r.stdout:
                ok = True
                break
            time.sleep(0.5)
        assert ok, r.stdout
    finally:
        _cli(["stop"], tmp)


def test_job_api_stop_and_logs(isolated_tmpdir):
    tmp = isolated_tmpdir
    r = _cli(["start", "--head", "--num-cpus", "4"], tmp)
    assert r.returncode == 0, r.stderr
    address = _address(r.stdout)
    try:
        from ray_tpu_torch.job_submission import JobSubmissionClient

        client = bounded(lambda: JobSubmissionClient(address), 60,
                         "JobSubmissionClient")
        try:
            job_id = client.submit_job(
                f"{sys.executable} -S -c \"import time\n"
                "print('spinning', flush=True)\n"
                "time.sleep(600)\"")
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if client.get_job_status(job_id) == "RUNNING" \
                        and "spinning" in client.get_job_logs(job_id):
                    break
                time.sleep(0.3)
            assert client.get_job_status(job_id) == "RUNNING"
            bounded(lambda: client.stop_job(job_id), 60, "stop_job")
            status = client.wait_until_finish(job_id, timeout=60)
            assert status == "STOPPED"
            assert "spinning" in client.get_job_logs(job_id)
        finally:
            client.close()
    finally:
        _cli(["stop"], tmp)


def test_cli_job_submit_without_wait_runs_the_job(isolated_tmpdir):
    """`job submit` without --wait exits at once; the job still runs to
    its end.  On a verbatim copy of the reference's job_submission.py
    the run call dies with the CLI process and the job stays PENDING."""
    tmp = isolated_tmpdir
    r = _cli(["start", "--head", "--num-cpus", "2"], tmp)
    assert r.returncode == 0, r.stderr
    try:
        r = _cli(["job", "submit", "--", sys.executable, "-S", "-c",
                  "\"print('ran to its end')\""], tmp)
        assert r.returncode == 0, r.stdout + r.stderr
        job_id = r.stdout.split("submitted ", 1)[1].split()[0]
        deadline = time.monotonic() + 60
        status = ""
        while time.monotonic() < deadline:
            r = _cli(["job", "status", job_id], tmp)
            status = json.loads(r.stdout)["status"]
            if status not in ("PENDING", "RUNNING"):
                break
            time.sleep(0.3)
        assert status == "SUCCEEDED", status
        r = _cli(["job", "logs", job_id], tmp)
        assert "ran to its end" in r.stdout
    finally:
        _cli(["stop"], tmp)


@pytest.mark.parametrize("agent_visible", ["0", None],
                         ids=["agent-sees-card-0", "agent-unset"])
def test_job_entrypoint_sees_its_nodes_cards(isolated_tmpdir,
                                             agent_visible):
    """The entrypoint's CUDA_VISIBLE_DEVICES is the node agent's: "0"
    under a head started with "0" (which counts one GPU), unset under a
    head started without it.  A verbatim copy of the reference's
    job_submission.py hands down the supervisor's CPU lease, "", in
    both cases."""
    tmp = isolated_tmpdir
    env = {"CUDA_VISIBLE_DEVICES": agent_visible}
    r = _cli(["start", "--head", "--num-cpus", "2"], tmp, env_extra=env)
    assert r.returncode == 0, r.stderr
    try:
        r = _cli(["status"], tmp)
        assert r.returncode == 0, r.stderr
        if agent_visible is not None:
            assert "'GPU': 1.0" in r.stdout, r.stdout
        r = _cli(["job", "submit", "--wait", "--", sys.executable, "-S",
                  "-c", "\"import os; print('visible=%r' % "
                  "os.environ.get('CUDA_VISIBLE_DEVICES'))\""], tmp,
                 env_extra=env)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "SUCCEEDED" in r.stdout
        assert f"visible={agent_visible!r}" in r.stdout, r.stdout
    finally:
        _cli(["stop"], tmp)
