"""ray_tpu_torch.util: scheduling strategies (copied from ray_tpu.util).

The rest of ray_tpu.util (placement groups, the actor pool, host
collectives, the state API) comes with a later slice of the port.
"""

from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy)

__all__ = ["NodeAffinitySchedulingStrategy", "NodeLabelSchedulingStrategy"]
