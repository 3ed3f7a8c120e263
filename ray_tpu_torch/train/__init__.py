"""Training of the port on one device or over a process group: the
flagship model's train step (``train.gspmd.build_llama_train_state``),
checkpoints through torch.distributed.checkpoint (sharded state saved
and restored without a gather) with top-k retention, and checkpoint
storage over local or fsspec paths.  The trainer, worker group and
session of ray_tpu.train wait for the port of the actor runtime."""

from ray_tpu_torch.train.checkpoint import (CheckpointManager,
                                            restore_checkpoint,
                                            save_checkpoint)
from ray_tpu_torch.train.storage import StorageContext

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager",
           "StorageContext"]
