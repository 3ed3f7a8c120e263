"""Binary RPC ingress for serve: the framework's length-prefixed
msgpack protocol instead of HTTP.

Equivalent of the reference's gRPC ingress
(reference: python/ray/serve/_private/proxy.py gRPCProxy +
grpc_util.py): a second, schema-light binary front door next to HTTP
for callers that want structured payloads without JSON overhead.  Here
it speaks the same framing as the cluster control plane (rpc.py), so
any `RpcClient`-style caller works, and `RpcIngressClient` wraps it for
applications.

    serve.run(model.bind(), name="scorer")
    addr = serve.start_rpc_ingress()
    client = serve.RpcIngressClient(*addr)
    client.invoke("scorer", {"x": [1.0, 2.0]})
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

PROXY_NAME = "_serve_rpc_ingress"


class _RpcIngressHost:
    """RpcHost-style handler set served by the ingress actor."""

    def __init__(self, proxy: "_RpcIngress"):
        self._proxy = proxy

    async def dispatch(self, method: str, payload: Dict[str, Any]) -> Any:
        import asyncio

        if method == "healthz":
            return {"ok": True}
        if method == "routes":
            import asyncio as _aio

            def _list():
                import ray_tpu_torch
                from ray_tpu_torch.serve import api as serve_api

                ctrl = serve_api._controller()
                return sorted(ray_tpu_torch.get(ctrl.list_deployments.remote(),
                                          timeout=30))

            loop = _aio.get_running_loop()
            return {"routes": await loop.run_in_executor(None, _list)}
        if method == "invoke":
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None, self._proxy._call_blocking,
                payload["app"], payload.get("args", ()),
                payload.get("kwargs") or {},
                payload.get("target_method", "__call__"),
                float(payload.get("backend_timeout", 120.0)))
        from ray_tpu_torch._private.rpc import RpcError

        raise RpcError(f"rpc ingress has no method {method!r}")

    def on_peer_disconnect(self, conn) -> None:
        pass


class _RpcIngress:
    """Actor wrapping an RpcServer on its own event loop (same shape as
    the HTTP proxy actor)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import asyncio

        self._handles: Dict[str, Any] = {}
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._addr: Optional[tuple] = None
        self._thread = threading.Thread(
            target=self._serve_forever, args=(host, port),
            name="serve-rpc-ingress", daemon=True)
        self._thread.start()
        self._started.wait(30)

    def _serve_forever(self, host: str, port: int):
        import asyncio

        from ray_tpu_torch._private.rpc import RpcServer

        asyncio.set_event_loop(self._loop)

        async def _start():
            server = RpcServer(_RpcIngressHost(self), host, port)
            bound = await server.start()
            self._addr = (host, bound)
            self._started.set()

        self._loop.run_until_complete(_start())
        self._loop.run_forever()

    def address(self):
        return list(self._addr) if self._addr else None

    def health(self):
        return True

    def _call_blocking(self, name: str, args, kwargs, method: str,
                       timeout: float = 120.0):
        import ray_tpu_torch
        from ray_tpu_torch.serve import api as serve_api

        handle = self._handles.get(name)
        if handle is None:
            try:
                handle = serve_api.get_handle(name)
            except ValueError:
                from ray_tpu_torch._private.rpc import RpcError

                raise RpcError(f"no deployment named {name!r}")
            self._handles[name] = handle
        caller = handle.remote if method == "__call__" \
            else handle.method(method)
        try:
            return ray_tpu_torch.get(caller(*args, **kwargs), timeout=timeout)
        except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.ActorUnavailableError,
                ray_tpu_torch.RayWorkerError):
            # replica infrastructure failure only — an application error
            # or timeout must NOT re-execute a side-effecting request;
            # replicas may have been replaced wholesale: refresh once
            self._handles.pop(name, None)
            handle = serve_api.get_handle(name)
            self._handles[name] = handle
            caller = handle.remote if method == "__call__" \
                else handle.method(method)
            return ray_tpu_torch.get(caller(*args, **kwargs), timeout=timeout)


def start_rpc_ingress(host: str = "127.0.0.1", port: int = 0):
    """Start (or fetch) the binary ingress actor; returns (host, port)."""
    import time

    import ray_tpu_torch
    import ray_tpu_torch.api as rapi

    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME)
    except ValueError:
        try:
            proxy = rapi.ActorClass(
                _RpcIngress, name=PROXY_NAME, lifetime="detached",
                max_concurrency=16).remote(host, port)
        except Exception as create_exc:
            deadline = time.monotonic() + 30
            while True:
                try:
                    proxy = ray_tpu_torch.get_actor(PROXY_NAME)
                    break
                except ValueError:
                    if time.monotonic() >= deadline:
                        raise create_exc
                    time.sleep(0.2)
    addr = ray_tpu_torch.get(proxy.address.remote(), timeout=120)
    if addr is None:
        try:
            ray_tpu_torch.kill(proxy)
        except Exception:
            pass
        raise RuntimeError(f"RPC ingress failed to bind (port {port} in use?)")
    return (addr[0], addr[1])


def stop_rpc_ingress():
    import ray_tpu_torch

    try:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(PROXY_NAME))
    except Exception:
        pass


class RpcIngressClient:
    """Blocking client for the binary ingress."""

    def __init__(self, host: str, port: int):
        from ray_tpu_torch._private.rpc import EventLoopThread, SyncRpcClient

        self._io = EventLoopThread(name="rpc-ingress-client")
        self._client = SyncRpcClient(host, port, self._io,
                                     label="rpc-ingress")

    def invoke(self, app: str, *args, method: str = "__call__",
               timeout: float = 120.0, **kwargs) -> Any:
        # backend_timeout rides the payload so the replica-side get
        # honors the caller's deadline; the RPC deadline sits just above
        return self._client.call("invoke", app=app, args=list(args),
                                 kwargs=kwargs, target_method=method,
                                 backend_timeout=timeout,
                                 timeout=timeout + 10.0)

    def routes(self) -> list:
        return self._client.call("routes")["routes"]

    def healthz(self) -> bool:
        return bool(self._client.call("healthz").get("ok"))

    def close(self):
        try:
            self._client.close()
        except Exception:
            pass
        self._io.stop()
