"""Node provider abstraction: how the autoscaler launches real capacity.

Equivalent of the reference's NodeProvider
(reference: python/ray/autoscaler/node_provider.py — create_node,
terminate_node, non_terminated_nodes), reduced to what the demand loop
needs.  Cloud providers (GCE/GKE TPU; reference:
python/ray/autoscaler/_private/gcp/node.py:191 GCPTPU) implement this
against their VM/TPU APIs; tests use FakeMultiNodeProvider, which
spawns local node-agent processes (reference:
_private/fake_multi_node/node_provider.py).

A TPU slice is modelled as an atomic launch group: `create_node` for a
type with ``launch_group: k`` brings up k ICI-connected hosts together
or not at all — the provider-level face of slice gang scheduling.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional


class ProviderNode:
    """One provider-managed node (a VM / TPU host / local process)."""

    __slots__ = ("provider_id", "node_type", "cluster_node_id")

    def __init__(self, provider_id: str, node_type: str,
                 cluster_node_id: Optional[str] = None):
        self.provider_id = provider_id
        self.node_type = node_type
        # the node id the agent registered with the head (None until the
        # node has booted far enough to know it)
        self.cluster_node_id = cluster_node_id


class NodeProvider(ABC):
    @abstractmethod
    def create_node(self, node_type: str, resources: Dict[str, float],
                    count: int = 1) -> List[ProviderNode]:
        """Launch `count` nodes of `node_type`.  Blocking providers may
        return booted nodes; async providers may return placeholders
        that fill in cluster_node_id later."""

    @abstractmethod
    def terminate_node(self, provider_id: str) -> None:
        """Tear one node down."""

    @abstractmethod
    def non_terminated_nodes(self) -> List[ProviderNode]:
        """All nodes this provider currently manages."""
