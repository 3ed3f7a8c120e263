"""ray_tpu_torch.data: distributed datasets over object-store blocks.

Equivalent of Ray Data (reference: python/ray/data/ — Dataset API
dataset.py, streaming executor _internal/execution/streaming_executor.py,
blocks in plasma).  Blocks are Arrow tables in the shared-memory object
store; transforms run as tasks; iteration streams with a bounded
in-flight window (backpressure).
"""

from ray_tpu_torch.data.dataset import (ActorPoolStrategy, Dataset, GroupedData,
                                  from_items, from_numpy, range, read_csv,
                                  read_json, read_parquet)

__all__ = ["ActorPoolStrategy", "Dataset", "GroupedData", "from_items",
           "from_numpy", "range", "read_parquet", "read_csv", "read_json"]
