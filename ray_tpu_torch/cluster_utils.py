"""Multi-node clusters on one machine, for tests and local development.

Equivalent of the reference's cluster_utils.Cluster
(reference: python/ray/cluster_utils.py:135 — add_node :201,
remove_node :274): spawns one head service plus N node agents as real
processes; `remove_node` SIGKILLs an agent (its workers die with it via
PDEATHSIG), which is the node-failure injection used by fault-tolerance
tests (reference: test_utils.py:1497 NodeKillerActor).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import node as node_mod


class NodeHandle:
    def __init__(self, proc, info: Dict[str, Any]):
        self.proc = proc
        self.node_id: str = info["node_id"]
        self.addr = info["addr"]
        self.arena_path: str = info["arena_path"]

    @property
    def alive(self) -> bool:
        return self.proc.proc.poll() is None


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict[str, Any]] = None):
        self.session_dir = node_mod.new_session_dir()
        self._head_proc, self.head_addr = node_mod.start_head(self.session_dir)
        self.nodes: List[NodeHandle] = []
        if initialize_head:
            self.add_node(is_head_node=True, **(head_node_args or {}))

    @property
    def address(self) -> str:
        return f"{self.head_addr[0]}:{self.head_addr[1]}"

    def add_node(self, num_cpus: float = 4,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None,
                 is_head_node: bool = False,
                 labels: Optional[Dict[str, str]] = None) -> NodeHandle:
        res: Dict[str, float] = {"CPU": float(num_cpus)}
        if resources:
            res.update(resources)
        proc, info = node_mod.start_node_agent(
            self.session_dir, self.head_addr, res,
            object_store_memory=object_store_memory,
            is_head_node=is_head_node, labels=labels,
            tag=f"agent-{len(self.nodes)}")
        handle = NodeHandle(proc, info)
        self.nodes.append(handle)
        return handle

    def remove_node(self, node: NodeHandle, graceful: bool = False,
                    allow_graceful_fallback: bool = True) -> None:
        """Kill a node. Non-graceful = SIGKILL the agent (workers die via
        PDEATHSIG); the head notices via connection drop."""
        if graceful:
            node.proc.terminate()
        else:
            try:
                os.kill(node.proc.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                node.proc.proc.wait(timeout=5)
            except Exception:
                pass
        if node in self.nodes:
            self.nodes.remove(node)

    def restart_head(self, kill: bool = True) -> None:
        """Kill the head process and restart it on the SAME port from its
        persisted state (reference: GCS fault tolerance via Redis-backed
        store, tests/test_gcs_fault_tolerance.py).  Agents re-register on
        their next heartbeat; drivers ride out the window via the head
        client's retry-on-connection-loss."""
        port = self.head_addr[1]
        if kill:
            try:
                os.kill(self._head_proc.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        else:
            self._head_proc.terminate()
        try:
            self._head_proc.proc.wait(timeout=5)
        except Exception:
            pass
        self._head_proc, self.head_addr = node_mod.start_head(
            self.session_dir, port=port)

    def wait_for_nodes(self, count: Optional[int] = None,
                       timeout: float = 30.0) -> None:
        """Block until the head's node table has `count` live entries."""
        import ray_tpu_torch

        expect = count if count is not None else len(self.nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if len(ray_tpu_torch.nodes()) == expect:
                    return
            except Exception:
                pass
            time.sleep(0.1)
        raise TimeoutError(f"cluster did not reach {expect} nodes")

    def shutdown(self) -> None:
        for node in list(self.nodes):
            node.proc.terminate()
        self.nodes = []
        self._head_proc.terminate()


class AutoscalingCluster:
    """A head node plus an autoscaler over the fake provider — scale-up/
    down testable on one machine (reference: cluster_utils.py:26
    AutoscalingCluster + FakeMultiNodeProvider)."""

    def __init__(self, head_resources: Optional[Dict[str, float]] = None,
                 worker_node_types: Optional[Dict[str, Any]] = None,
                 idle_timeout_s: float = 60.0,
                 update_period_s: float = 0.5,
                 upscale_consecutive: Optional[int] = None,
                 sched_p99_threshold_ms: Optional[float] = None):
        from ray_tpu_torch.autoscaler import (AutoscalerConfig,
                                        FakeMultiNodeProvider,
                                        StandardAutoscaler)

        head_resources = head_resources or {"CPU": 2}
        self.cluster = Cluster(initialize_head=True, head_node_args={
            "num_cpus": head_resources.get("CPU", 2),
            "resources": {k: v for k, v in head_resources.items()
                          if k != "CPU"}})
        self.provider = FakeMultiNodeProvider(
            self.cluster.session_dir, self.cluster.head_addr)
        self.autoscaler = StandardAutoscaler(
            self.cluster.head_addr, self.provider,
            AutoscalerConfig(worker_node_types or {},
                             idle_timeout_s=idle_timeout_s,
                             update_period_s=update_period_s,
                             upscale_consecutive=upscale_consecutive,
                             sched_p99_threshold_ms=sched_p99_threshold_ms))
        self.autoscaler.start()

    @property
    def address(self) -> str:
        return self.cluster.address

    def status(self) -> Dict[str, Any]:
        """The autoscaler's live status (pending launches, draining
        nodes, last decision) — what /api/autoscaler serves."""
        return self.autoscaler.status()

    def shutdown(self) -> None:
        self.autoscaler.stop()
        self.provider.shutdown()
        self.cluster.shutdown()
