"""Placement groups: gang-scheduled resource bundles.

Equivalent of the reference's placement group API
(reference: python/ray/util/placement_group.py:145 placement_group();
server side src/ray/gcs/gcs_server/gcs_placement_group_manager.h,
bundle policies src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h).

Reservation is all-or-nothing, which is what makes multi-host TPU slices
gang-schedulable: a slice's per-host bundles either all reserve or none
do (SURVEY §7.4 hard part 2).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.errors import RayError

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroupError(RayError):
    pass


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: Optional[List[Dict[str, float]]] = None,
                 info: Optional[Dict] = None):
        self.id = pg_id
        self._bundles = bundles or []
        # create-reply snapshot: when the head's inline scheduling pass
        # already committed the group, ready()/wait() answer from this
        # with no extra round trip (PG churn is a benchmarked hot path)
        self._created_info = info if (info or {}).get("state") == "CREATED" \
            else None

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self._bundles

    def _info(self, wait: bool = False, wait_s: Optional[float] = None) -> Dict:
        import ray_tpu_torch

        w = ray_tpu_torch.api._worker()
        return w.head.call("get_placement_group", pg_id=self.id, wait=wait,
                           wait_s=wait_s,
                           timeout=(wait_s or 30.0) + 30.0)

    def ready(self, timeout: Optional[float] = None) -> "PlacementGroup":
        """Block until every bundle is reserved (gang commit).

        Reference exposes ready() as an ObjectRef; blocking with a timeout
        is the ergonomic equivalent for this API.
        """
        if self._created_info is not None:
            # one-shot: the create reply proved CREATED for the first
            # ready()/wait(); later calls must re-poll — the group may
            # have gone back to PENDING on a node death or been removed,
            # and a cached success would lie about it.  (A bundle lost
            # in the tiny create→first-wait window is still recovered by
            # the lease path's "bundle not reserved" refresh-and-retry.)
            self._created_info = None
            return self
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError("placement group not ready in time")
            info = self._info(wait=True,
                              wait_s=min(remaining or 25.0, 25.0))
            if info["state"] == "CREATED":
                return self
            if info["state"] == "REMOVED":
                raise PlacementGroupError("placement group was removed")
            if info.get("failure"):
                raise PlacementGroupError(info["failure"])

    def wait(self, timeout: float = 30.0) -> bool:
        try:
            self.ready(timeout=timeout)
            return True
        except (TimeoutError, PlacementGroupError):
            return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    import ray_tpu_torch

    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    from ray_tpu_torch._private.ids import PlacementGroupID

    w = ray_tpu_torch.api._worker()
    # client-generated id makes the create idempotent across retries
    reply = w.head.call("create_placement_group", bundles=list(bundles),
                        strategy=strategy, name=name,
                        pg_id=PlacementGroupID.from_random().hex())
    return PlacementGroup(reply["pg_id"], list(bundles),
                          info=reply.get("info"))


def placement_group_table() -> List[Dict]:
    """All placement groups with states and placements
    (reference: python/ray/util/placement_group.py placement_group_table)."""
    import ray_tpu_torch

    w = ray_tpu_torch.api._worker()
    return w.head.call("list_placement_groups")["placement_groups"]


def remove_placement_group(pg: PlacementGroup) -> None:
    import ray_tpu_torch

    w = ray_tpu_torch.api._worker()
    w.head.call("remove_placement_group", pg_id=pg.id)

