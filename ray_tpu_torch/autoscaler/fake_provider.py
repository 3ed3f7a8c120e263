"""Fake provider: "launches" node-agent processes on this machine.

Equivalent of the reference's FakeMultiNodeProvider
(reference: python/ray/autoscaler/_private/fake_multi_node/
node_provider.py) — the workhorse that lets autoscaler behavior be
tested end-to-end with real cluster membership but no cloud API.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, List

from ray_tpu_torch._private import node as node_mod
from ray_tpu_torch.autoscaler.node_provider import NodeProvider, ProviderNode


class FakeMultiNodeProvider(NodeProvider):
    def __init__(self, session_dir: str, head_addr):
        self._session_dir = session_dir
        self._head_addr = head_addr
        self._lock = threading.Lock()
        self._counter = 0
        self._nodes: Dict[str, ProviderNode] = {}
        self._procs: Dict[str, node_mod.ProcessHandle] = {}

    def create_node(self, node_type: str, resources: Dict[str, float],
                    count: int = 1) -> List[ProviderNode]:
        out: List[ProviderNode] = []
        for _ in range(count):
            with self._lock:
                self._counter += 1
                pid = f"fake-{node_type}-{self._counter}"
            proc, info = node_mod.start_node_agent(
                self._session_dir, self._head_addr, dict(resources),
                tag=pid)
            node = ProviderNode(pid, node_type, info["node_id"])
            with self._lock:
                self._nodes[pid] = node
                self._procs[pid] = proc
            out.append(node)
        return out

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(provider_id, None)
            proc = self._procs.pop(provider_id, None)
        if proc is None:
            return
        # SIGTERM → graceful agent shutdown (workers die via PDEATHSIG)
        proc.terminate()

    def non_terminated_nodes(self) -> List[ProviderNode]:
        with self._lock:
            alive = []
            for pid, node in list(self._nodes.items()):
                proc = self._procs.get(pid)
                if proc is not None and proc.proc.poll() is None:
                    alive.append(node)
                else:
                    self._nodes.pop(pid, None)
                    self._procs.pop(pid, None)
            return alive

    def shutdown(self) -> None:
        for pid in [n.provider_id for n in self.non_terminated_nodes()]:
            self.terminate_node(pid)
