"""Cluster bootstrap: spawn and manage the head + node-agent daemons.

Equivalent of the reference's Node
(reference: python/ray/_private/node.py — start_head_processes :1323,
start_ray_processes :1352): `ray_tpu_torch.init()` on a fresh machine spawns
the head service and one node agent as real processes, then connects the
driver to them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Tuple


class ProcessHandle:
    def __init__(self, name: str, proc: subprocess.Popen):
        self.name = name
        self.proc = proc

    def terminate(self, timeout: float = 3.0):
        if self.proc.poll() is not None:
            return
        try:
            self.proc.terminate()
            self.proc.wait(timeout=timeout)
        except Exception:
            try:
                self.proc.kill()
                self.proc.wait(timeout=timeout)
            except Exception:
                pass


def _wait_for_file(path: str, timeout: float = 30.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                content = f.read()
            if content:
                return content
        time.sleep(0.01)
    raise TimeoutError(f"daemon did not write {path} within {timeout}s")


def new_session_dir() -> str:
    base = os.environ.get("RT_TMPDIR", "/tmp/ray_tpu")
    path = os.path.join(base, f"session_{int(time.time() * 1000)}_{os.getpid()}")
    os.makedirs(os.path.join(path, "logs"), exist_ok=True)
    return path


def default_resources(num_cpus: Optional[float] = None,
                      resources: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    out: Dict[str, float] = {}
    out["CPU"] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
    try:
        from ray_tpu_torch._private.accelerators import detect_accelerators

        out.update(detect_accelerators())
    except Exception:
        pass
    if resources:
        out.update(resources)
    return out


def start_head(session_dir: str, env: Optional[Dict[str, str]] = None,
               port: int = 0) -> Tuple[ProcessHandle, Tuple[str, int]]:
    from ray_tpu_torch._private.spawn import fast_python_cmd

    port_file = os.path.join(session_dir, f"head-{time.monotonic_ns()}.port")
    state_path = os.path.join(session_dir, "head.state")
    log = open(os.path.join(session_dir, "logs", "head.log"), "ab")
    penv = dict(os.environ)
    if env:
        penv.update(env)
    cmd, env_up = fast_python_cmd(
        "ray_tpu_torch._private.head",
        ["--port-file", port_file, "--state-path", state_path,
         "--port", str(port)])
    penv.update(env_up)
    proc = subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT, env=penv, start_new_session=True)
    log.close()
    bound = int(_wait_for_file(port_file))
    return ProcessHandle("head", proc), ("127.0.0.1", bound)


def start_node_agent(session_dir: str, head_addr: Tuple[str, int],
                     resources: Dict[str, float],
                     object_store_memory: Optional[int] = None,
                     is_head_node: bool = False,
                     env: Optional[Dict[str, str]] = None,
                     labels: Optional[Dict[str, str]] = None,
                     tag: str = "agent") -> Tuple[ProcessHandle, Dict[str, Any]]:
    from ray_tpu_torch._private.spawn import fast_python_cmd

    port_file = os.path.join(session_dir, f"{tag}-{os.getpid()}-{time.monotonic_ns()}.port")
    log = open(os.path.join(session_dir, "logs", f"{tag}.log"), "ab")
    penv = dict(os.environ)
    if env:
        penv.update(env)
    argv = ["--head-host", head_addr[0], "--head-port", str(head_addr[1]),
            "--session-dir", session_dir,
            "--resources", json.dumps(resources),
            "--port-file", port_file]
    if object_store_memory:
        argv += ["--capacity", str(object_store_memory)]
    if is_head_node:
        argv += ["--is-head-node"]
    if labels:
        argv += ["--labels", json.dumps(labels)]
    cmd, env_up = fast_python_cmd("ray_tpu_torch._private.node_agent", argv)
    penv.update(env_up)
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=penv, start_new_session=True)
    log.close()
    port_s, node_id, arena_path = _wait_for_file(port_file).split("\n")
    info = {"addr": ("127.0.0.1", int(port_s)), "node_id": node_id,
            "arena_path": arena_path}
    return ProcessHandle(tag, proc), info
