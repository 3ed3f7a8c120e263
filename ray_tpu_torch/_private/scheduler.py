"""Local + cluster scheduling policy.

Equivalent of the reference's two-level scheduler
(reference: src/ray/raylet/scheduling/cluster_resource_scheduler.h,
local_task_manager.h, policy/hybrid_scheduling_policy.h): the cluster
policy picks a node for a lease request (prefer-local below a
utilization threshold, then top-k random among the best-scoring nodes);
the local scheduler grants leases against the node's available resources
in FIFO-with-resources order.

TPU note: TPU chips are ordinary resources here; slice gang placement is
layered on via placement groups whose bundles carry TPU resources, so
multi-host slices are all-or-nothing (reference:
python/ray/_private/accelerators/tpu.py TPU-{type}-head resources).
"""

from __future__ import annotations

import random
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ray_tpu_torch._private.resources import NodeResources, ResourceSet


class LocalScheduler:
    """FIFO-with-resources lease granting against one node's resources."""

    def __init__(self, resources: NodeResources):
        self.resources = resources
        # queue of (token, demand); granted via callback to preserve FIFO
        self._queue: Deque[Tuple[object, ResourceSet]] = deque()

    def try_acquire(self, demand: ResourceSet) -> bool:
        """Immediately acquire if available AND nothing older is waiting."""
        if self._queue:
            return False
        return self.resources.acquire(demand)

    def acquire_many(self, demand: ResourceSet, max_n: int) -> int:
        """Acquire up to ``max_n`` copies of ``demand`` immediately
        (FIFO-respecting: nothing while older requests queue).  Returns
        how many were acquired — the grant count of one batched
        request_leases frame (see node_agent.rpc_request_leases)."""
        n = 0
        while n < max_n and self.try_acquire(demand):
            n += 1
        return n

    def enqueue(self, token: object, demand: ResourceSet) -> None:
        self._queue.append((token, demand))

    def cancel(self, token: object) -> Tuple[bool, List[object]]:
        """Remove a queued request. Returns (found, newly-grantable tokens) —
        removing a head-of-line blocker can unblock the queue."""
        for i, (t, _) in enumerate(self._queue):
            if t == token:
                del self._queue[i]
                return True, self.drain()
        return False, []

    def pending_demands(self) -> List[Dict[str, float]]:
        """Resource shapes of queued (unsatisfiable-right-now) requests —
        the per-node half of the autoscaler's demand signal
        (reference: load_metrics.py resource_load_by_shape)."""
        return [d.to_dict() for _, d in self._queue]

    def cancel_all(self) -> List[object]:
        """Drop every queued request; returns their tokens (the caller
        wakes the waiters, who observe the queue's backing pool is gone)."""
        tokens = [t for t, _ in self._queue]
        self._queue.clear()
        return tokens

    def release(self, demand: ResourceSet) -> List[object]:
        """Release resources; returns tokens of newly grantable requests."""
        self.resources.release(demand)
        return self.drain()

    def drain(self) -> List[object]:
        """Grant queued requests in FIFO order while they fit."""
        granted = []
        while self._queue:
            token, demand = self._queue[0]
            if not self.resources.acquire(demand):
                break
            self._queue.popleft()
            granted.append(token)
        return granted

    @property
    def num_queued(self) -> int:
        return len(self._queue)


def pick_node(
    cluster: Dict[str, NodeResources],
    demand: ResourceSet,
    local_node_id: str,
    spread_threshold: float = 0.5,
    top_k_fraction: float = 0.2,
    top_k_absolute: int = 5,
    rng: Optional[random.Random] = None,
    strategy: Optional[Dict[str, object]] = None,
    labels_by_node: Optional[Dict[str, Dict[str, str]]] = None,
    arg_bytes_by_node: Optional[Dict[str, float]] = None,
    locality_min_bytes: int = 0,
    pressure_by_node: Optional[Dict[str, float]] = None,
    pressure_threshold: float = 1.0,
) -> Optional[str]:
    """Hybrid policy: choose the node to send a lease request to.

    0. Locality: with ``arg_bytes_by_node`` (argument bytes already
       resident per node, from the submission's WireArg hints plus the
       head's object directory) a feasible node holding at least
       ``locality_min_bytes`` wins, skipping the transfer entirely —
       the holder with the most bytes that can fit the demand now,
       else the best busy-but-feasible holder (the lease queues there;
       queued demand triggers the warm-lease reclaim push).  Reference:
       locality_aware_lease_policy.cc — "the best node is the one with
       the most object bytes local".  Explicit strategy overrides
       disable this; infeasible holders fall through to the hybrid
       default below.
    1. Local node if it has the resources available and is under the
       spread threshold.
    2. Otherwise a random pick among the top-k least-utilized nodes with
       the resources available.
    3. Otherwise any node where the demand is *feasible* (total resources
       cover it) — the request queues there.
    4. None if infeasible everywhere (caller surfaces a scheduling error).

    ``strategy`` overrides the hybrid default (reference:
    scheduling_strategy.py + policies under raylet/scheduling/policy/):
      {"type": "spread"}                     — least-utilized feasible
        node, no local preference (spread_scheduling_policy.cc)
      {"type": "node_affinity", "node_id", "soft"} — pin to one node;
        hard pins never fall back (node_affinity_scheduling_policy.cc)
      {"type": "node_label", "hard": {k: v}} — restrict to nodes whose
        labels match, then run the default policy
        (node_label_scheduling_policy.cc)

    ``pressure_by_node`` (node memory usage fraction, from the agents'
    watchdog samples riding heartbeats) demotes nodes at/above
    ``pressure_threshold``: while ANY under-pressure node can fit the
    demand, the over-pressure ones are removed from consideration — new
    work stops landing where the OOM watchdog is about to kill.  Hard
    placement constraints (node_affinity, node_label) and the
    no-alternative case still use the full set: a pressured node beats
    no node.
    """
    rng = rng or random
    stype = (strategy or {}).get("type", "")
    if (pressure_by_node and stype in ("", "spread")
            and pressure_threshold < 1.0):
        calm = {nid: nr for nid, nr in cluster.items()
                if pressure_by_node.get(nid, 0.0) < pressure_threshold}
        if calm and any(nr.can_fit(demand) for nr in calm.values()):
            cluster = calm
    if stype == "node_affinity":
        target = strategy.get("node_id", "")
        node = cluster.get(target)
        if node is not None and node.is_feasible(demand):
            return target  # available now or queues there
        if not strategy.get("soft"):
            return None  # hard affinity: never reschedule elsewhere
        # soft: fall through to the default policy
    elif stype == "node_label":
        labels_by_node = labels_by_node or {}
        hard = strategy.get("hard") or {}
        cluster = {
            nid: nr for nid, nr in cluster.items()
            if all(labels_by_node.get(nid, {}).get(k) == v
                   for k, v in hard.items())
        }
        if not cluster:
            return None
    elif stype == "spread":
        available = [(nid, nr) for nid, nr in cluster.items()
                     if nr.can_fit(demand)]
        if available:
            low = min(nr.utilization() for _, nr in available)
            best = [nid for nid, nr in available
                    if nr.utilization() <= low + 1e-9]
            return rng.choice(best)
        feasible = [nid for nid, nr in cluster.items()
                    if nr.is_feasible(demand)]
        if feasible:
            feasible.sort(key=lambda nid: cluster[nid].utilization())
            return feasible[0]
        return None
    if not stype and arg_bytes_by_node and locality_min_bytes > 0:
        # most-bytes-first; ties broken toward the colder node, then a
        # stable id order so repeated submissions don't flap
        holders = sorted(
            ((b, nid) for nid, b in arg_bytes_by_node.items()
             if b >= locality_min_bytes and nid in cluster
             and cluster[nid].is_feasible(demand)),
            key=lambda kv: (-kv[0], cluster[kv[1]].utilization(), kv[1]))
        for _b, nid in holders:
            if cluster[nid].can_fit(demand):
                return nid
        if holders:
            # no holder has free capacity RIGHT NOW, but skipping the
            # transfer usually beats a short queue wait: send the lease
            # to the best holder anyway — queued demand there triggers
            # the warm-lease reclaim push, and the holder's own
            # pick_node pass can still spill the request back if it is
            # genuinely saturated (reference: locality_aware lease
            # policy + retry_at_raylet spillback)
            return holders[0][1]
    local = cluster.get(local_node_id)
    if (local is not None and local.can_fit(demand)
            and local.utilization() < spread_threshold):
        return local_node_id

    available = [(nid, nr) for nid, nr in cluster.items() if nr.can_fit(demand)]
    if available:
        # under-threshold nodes score strictly better than hot ones
        # (reference: hybrid_scheduling_policy.h score buckets); the top-k
        # random pick is only for herd avoidance among the best bucket
        cold = [kv for kv in available if kv[1].utilization() < spread_threshold]
        pool = cold or available
        pool.sort(key=lambda kv: kv[1].utilization())
        # absolute floor is configurable (reference: ray_config_def.h
        # scheduler_top_k_fraction / scheduler_top_k_absolute)
        k = min(len(pool), max(top_k_absolute, int(len(pool) * top_k_fraction)))
        return rng.choice(pool[:k])[0]

    feasible = [nid for nid, nr in cluster.items() if nr.is_feasible(demand)]
    if feasible:
        # queue on the least loaded feasible node
        feasible.sort(key=lambda nid: cluster[nid].utilization())
        return feasible[0]
    return None
