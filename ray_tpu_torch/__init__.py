"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The actor runtime (``init``, ``remote``, ``get``, ``put``, ``wait``,
``kill``, ...: a head service, node agents and worker processes over a
shared-memory object store), with GPU leases pinned per task or actor
through ``CUDA_VISIBLE_DEVICES`` and torch tensors in the object store.
On top of it the flagship Llama model, its two attention kernels (flash
prefill and paged decode, hand-written CUDA for Hopper under ``csrc/``),
the continuous-batching LLM engine, served through the runtime
(``serve``: the controller, replicas, handles and the HTTP/SSE proxy,
with ``serve.llm_deployment`` replicas running the engine's pinned
decode loop, disaggregated prefill among them), and training on one
card, over a torch.distributed mesh (dp/fsdp/tp/sp, ring attention),
through ``train.TorchTrainer`` in GPU-pinned actors or as an MPMD
pipeline of stage actors, and PPO.  The libraries a trainer uses run on
the same runtime: ``tune`` (trials as GPU-pinned train workers, search
and schedulers), ``data`` (Arrow-block datasets fed to the trainers),
``util`` (placement groups, the actor pool, queues, host collectives,
the state API) and ``cluster_utils``.  A fractional ``num_gpus`` takes a
share of one card.  The package imports ``torch`` and numpy and nothing
of ``ray_tpu``; where it needs a pure-Python module from there it keeps
its own copy (``_private/runtime_copy.py`` lists them).  The
cluster-operations libraries run it from the shell and keep it: the
``rtpu-torch`` CLI (``scripts``), job submission whose entrypoints see
their node's cards, the head's dashboard, the ``autoscaler`` launching
GPU nodes, durable ``workflow`` steps and ``experimental.pubsub``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:
with no GPU and no explicit ``"cpu"`` they raise instead of quietly
running on the CPU.  On a CPU tensor each kernel wrapper computes its
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.
"""

from ray_tpu_torch._private.errors import (
    ActorDiedError, ActorUnavailableError, DeadlineExceededError,
    DeploymentFailedError, GetTimeoutError, ObjectFreedError,
    ObjectLostError, OutOfMemoryError, PoisonedTaskError, RayError,
    RayTaskError, RayWorkerError, RuntimeEnvSetupError, SchedulingError,
    TaskCancelledError)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.streaming import ObjectRefGenerator
from ray_tpu_torch.api import (
    ActorClass, ActorHandle, RemoteFunction, available_resources, cancel,
    cluster_resources, get, get_actor, get_async, init, is_initialized,
    kill, method, nodes, put, remote, shutdown, wait)

__all__ = [
    "init", "shutdown", "remote", "get", "get_async", "put", "wait",
    "kill", "cancel",
    "get_actor", "method", "cluster_resources", "available_resources",
    "nodes", "is_initialized", "ObjectRef", "ObjectRefGenerator",
    "ActorHandle", "ActorClass", "RemoteFunction",
    "RayError", "RayTaskError", "RayWorkerError", "ActorDiedError",
    "ActorUnavailableError", "ObjectLostError", "ObjectFreedError",
    "GetTimeoutError", "SchedulingError", "RuntimeEnvSetupError",
    "TaskCancelledError", "DeploymentFailedError", "DeadlineExceededError",
    "OutOfMemoryError", "PoisonedTaskError", "resolve_device",
]


def __getattr__(name):
    # torch loads on first use: the runtime's daemons import this
    # package and never touch torch
    if name == "resolve_device":
        from ray_tpu_torch._private.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
