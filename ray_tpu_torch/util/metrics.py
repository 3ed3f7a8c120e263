"""User-facing metrics API.

Equivalent of the reference's application metrics
(reference: python/ray/util/metrics.py — Counter/Gauge/Histogram
recorded in any task/actor/driver and exported on the node's Prometheus
endpoint).  Metrics created in a worker are pushed to the node agent
and re-exported there with `worker_id` labels; the node agent's
endpoint is the one scrape target per node (see
_private/metrics.py and node_agent's metrics loop).
"""

from ray_tpu_torch._private.metrics import (Counter, Gauge,  # noqa: F401
                                      Histogram, default_registry)
