"""ray_tpu_torch.serve: model serving on actor replicas.

Ported from ray_tpu.serve's package: the same exports.  The controller
and the HTTP proxy are actors that import ``serve.api``, and so this
package; the three LLM names load ``serve.llm`` (and torch) on first
use, so those processes never import torch.
"""

from ray_tpu_torch._private.errors import DeploymentFailedError
from ray_tpu_torch.serve.api import (Application, Deployment,
                                     DeploymentHandle, batch, delete,
                                     deployment, get_handle, run, shutdown)
from ray_tpu_torch.serve.http import (proxy_addresses, shutdown_http,
                                      start_http, start_per_node_http)
from ray_tpu_torch.serve.rpc_ingress import (RpcIngressClient,
                                             start_rpc_ingress,
                                             stop_rpc_ingress)

__all__ = ["deployment", "run", "get_handle", "delete", "shutdown",
           "batch", "Deployment", "DeploymentHandle", "Application",
           "start_http", "start_per_node_http", "proxy_addresses",
           "shutdown_http", "start_rpc_ingress", "stop_rpc_ingress",
           "RpcIngressClient", "DeploymentFailedError",
           "llm_deployment", "LLMEngine", "LLMOverloadedError"]

_LLM_NAMES = ("llm_deployment", "LLMEngine", "LLMOverloadedError")


def __getattr__(name):
    if name in _LLM_NAMES:
        from ray_tpu_torch.serve import llm

        return getattr(llm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
