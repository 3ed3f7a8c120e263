"""ray_tpu_torch.train: training on GPUs through actor gangs.

Equivalent of Ray Train (reference: python/ray/train/ — TorchTrainer,
BackendExecutor _internal/backend_executor.py:65, session
_internal/session.py:109), ported from ray_tpu.train: ``TorchTrainer``
runs a train loop in a gang of GPU-pinned actors on the port's runtime
(each worker holds one card through ``CUDA_VISIBLE_DEVICES``; a gang of
several joins one torch.distributed group), restarting the gang from
the last reported checkpoint when a worker dies.  Inside the loop, the
flagship model's train step (``train.gspmd.build_llama_train_state``)
runs on one device or over the group's mesh; checkpoints go through
torch.distributed.checkpoint with top-k retention, over local or
fsspec storage.  ``TrainPipeline`` (``train.pipeline``) trains the
model as MPMD pipeline stages, one actor per stage, over compiled-graph
channels.
"""

import importlib

# name -> submodule; each loads on first use, so a worker that imports
# the trainer's actor class (worker_group) does not pay torch's import
_EXPORTS = {
    "ActorStateCheckpoint": "checkpoint", "CheckpointManager": "checkpoint",
    "restore_checkpoint": "checkpoint", "save_checkpoint": "checkpoint",
    "TrainContext": "session", "get_checkpoint": "session",
    "get_context": "session", "get_dataset_shard": "session",
    "report": "session", "StorageContext": "storage",
    "Result": "trainer", "RunConfig": "trainer", "ScalingConfig": "trainer",
    "TorchTrainer": "trainer", "TrainingFailedError": "trainer",
    "WorkerGroup": "worker_group",
    "PipelineError": "pipeline", "TrainPipeline": "pipeline",
    "one_f_one_b": "pipeline", "partition_layers": "pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(
            f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
