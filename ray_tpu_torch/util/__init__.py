"""ray_tpu_torch.util: placement groups, collectives, and cluster utilities."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (PlacementGroup, placement_group,
                                          remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy)

__all__ = ["ActorPool", "PlacementGroup", "placement_group",
           "remove_placement_group", "NodeAffinitySchedulingStrategy",
           "NodeLabelSchedulingStrategy"]
