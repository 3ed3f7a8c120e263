"""Which runtime modules the port copies from ray_tpu, and how.

The actor runtime (head, node agents, workers, the object store and the
RPC plane) is pure Python and runs the same on a GPU host as on a TPU
host.  The port keeps its own copy of it: a copied module is ray_tpu's
file with its module paths renamed by :func:`rename`, nothing else.  A
module whose accelerator-specific part had to change for the GPU is
*ported* instead, and :data:`PORTED` says why.
``tests/test_torch_runtime.py`` re-applies :func:`rename` to every
module of :data:`COPIED` and requires the port's file to equal it.

Refresh the copies after a change to ray_tpu's runtime with::

    python -m ray_tpu_torch._private.runtime_copy

which reads the sources as text (it imports nothing of ray_tpu) and
rewrites the copied files; ported files are left to be merged by hand.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List

# paths relative to the package root (ray_tpu/ and ray_tpu_torch/)
COPIED: List[str] = [
    "_private/config.py",
    "_private/errors.py",
    "_private/deadlines.py",
    "_private/ids.py",
    "_private/fault_injection.py",
    "_private/profiling.py",
    "_private/tracing.py",
    "_private/metrics.py",
    "_private/rpc.py",
    "_native/copyfast.c",
    "_private/object_store.py",
    "_private/object_ref.py",
    "_private/object_directory.py",
    "_private/object_transfer.py",
    "_private/streaming.py",
    "_private/task_spec.py",
    "_private/resources.py",
    "_private/scheduler.py",
    "_private/function_manager.py",
    "_private/runtime_env.py",
    "_private/head_shards.py",
    "_private/node.py",
    "_private/memory_monitor.py",
    "_private/log_monitor.py",
    "util/scheduling_strategies.py",
    "experimental/__init__.py",
    "experimental/internal_kv.py",
    "serve/api.py",
    "serve/rpc_ingress.py",
    "serve/http.py",
    "dag/__init__.py",
    "dag/nodes.py",
    "dag/compiled.py",
    "dag/channel.py",
    "dag/execution.py",
    "util/__init__.py",
    "util/metrics.py",
    "util/actor_pool.py",
    "util/queue.py",
    "util/multiprocessing.py",
    "util/collective.py",
    "util/state/__init__.py",
    "util/state/api.py",
    "cluster_utils.py",
    "data/__init__.py",
    "data/logical.py",
    "data/block.py",
    "data/dataset.py",
    "tune/__init__.py",
    "tune/search.py",
    "tune/schedulers.py",
    "tune/tuner.py",
    "experimental/pubsub.py",
    "autoscaler/node_provider.py",
    "autoscaler/fake_provider.py",
    "autoscaler/autoscaler.py",
    "autoscaler/__init__.py",
    "workflow/storage.py",
    "workflow/executor.py",
    "workflow/__init__.py",
    "_private/dashboard.py",
    "scripts.py",
]

PORTED: Dict[str, str] = {
    "_private/accelerators.py":
        "the GPU count only: TPU slice metadata and TPU-* resources go",
    "_private/serialization.py":
        "torch tensors: CPU tensors out-of-band, CUDA tensors via the host",
    "_native/__init__.py":
        "builds into ray_tpu_torch/_build/, not ~/.cache",
    "_private/spawn.py":
        "no JAX site hook; PYTHONPATH names the port's repo root",
    "_private/worker_main.py":
        "no JAX site hook",
    "_private/node_agent.py":
        "assigns GPU indices (gpu_ids) behind the fungible GPU count; a "
        "fractional demand takes a share of one card; a placement-group "
        "bundle carves its cards' shares out when it is reserved",
    "_private/head.py":
        "forwards a lease's gpu_ids with an actor's creation push",
    "_private/worker.py":
        "CUDA_VISIBLE_DEVICES per lease; the value the worker was spawned "
        "with stays readable (SPAWN_VISIBLE_DEVICES)",
    "serve/__init__.py":
        "the LLM names load on first use: the controller and the proxy "
        "never import torch",
    "_private/memory_store.py":
        "an evict reached from a GC inside the store's own lock is "
        "deferred, not deadlocked",
    "_private/reference_count.py":
        "an ObjectRef finalised by a GC inside the counter's own lock is "
        "counted down once the lock is released, not deadlocked",
    "api.py":
        "num_tpus= goes; num_gpus= maps to the GPU resource",
    "train/session.py":
        "names TorchTrainer",
    "train/pipeline.py":
        "each stage is an nn.Module on its leased card (num_gpus per "
        "stage, or device='cpu'), a stage over several cards one process "
        "per card in a process group of its own; backward re-runs the "
        "stage forward under autograd; snapshots hold CPU tensors by "
        "parameter name",
    "job_submission.py":
        "the entrypoint takes the node's CUDA_VISIBLE_DEVICES (the agent's, "
        "or unset), not the supervisor's CPU lease's \"\", which hides "
        "every card: the reference pops TPU_VISIBLE_CHIPS for a CPU lease; "
        "submit_job returns once the supervisor runs the job, so a caller "
        "that exits at once (`job submit` without --wait) leaves no job "
        "PENDING for ever",
    "util/placement_group.py":
        "tpu_slice_bundles goes: its TPU-{type}-head bundle has no GPU "
        "meaning; a GPU host's bundle is a plain {\"GPU\": n, \"CPU\": c}",
}

_MODULE_PATH = re.compile(r"\bray_tpu(?=\.[A-Za-z_])")
_IMPORT = re.compile(r"\b(import|from) ray_tpu\b")
# the imported module passed on as an argument or bound as a parameter
# (serve/api.py's ``_reconcile_one(self, ray_tpu, ...)``, dag/compiled.py's
# ``_apply_backpressure(ray_tpu)``)
_ARGUMENT = re.compile(r"\bray_tpu(?=, |\))")


def rename(text: str) -> str:
    """ray_tpu's module paths become the port's: ``ray_tpu.x``,
    ``import/from ray_tpu`` and the module passed as an argument
    (``f(ray_tpu, ...)``, ``f(ray_tpu)``) name ``ray_tpu_torch``.
    Everything else keeps its text, metric names such as
    ``ray_tpu_actor_restarts_total`` among it."""
    text = _MODULE_PATH.sub("ray_tpu_torch", text)
    return _ARGUMENT.sub("ray_tpu_torch",
                         _IMPORT.sub(r"\1 ray_tpu_torch", text))


def main() -> None:
    port = Path(__file__).resolve().parent.parent
    src = port.parent / "ray_tpu"
    for rel in COPIED:
        (port / rel).parent.mkdir(parents=True, exist_ok=True)
        (port / rel).write_text(rename((src / rel).read_text()))
    print(f"rewrote {len(COPIED)} copies; merge by hand: "
          + ", ".join(sorted(PORTED)))


if __name__ == "__main__":
    main()
