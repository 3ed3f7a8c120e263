from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,  # noqa: F401
                                           StandardAutoscaler)
from ray_tpu_torch.autoscaler.fake_provider import \
    FakeMultiNodeProvider  # noqa: F401
from ray_tpu_torch.autoscaler.node_provider import (NodeProvider,  # noqa: F401
                                              ProviderNode)
