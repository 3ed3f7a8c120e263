"""Cluster-wide internal key-value store, backed by the head service.

Equivalent of the reference's internal KV
(reference: python/ray/experimental/internal_kv.py; server side
gcs_service.proto:522 InternalKVGcsService).  Carries the function
table, serve controller checkpoints, and collective rendezvous; user
code may use it for small cluster-global metadata (values ride the
control plane — keep them small, bulk data belongs in the object
store).
"""

from __future__ import annotations

from typing import List, Optional, Union


def _key(k: Union[str, bytes]) -> str:
    return k.decode() if isinstance(k, bytes) else k


def _head():
    import ray_tpu_torch

    return ray_tpu_torch.api._worker().head


def kv_put(key: Union[str, bytes], value: Union[str, bytes],
           overwrite: bool = True) -> bool:
    """Returns True if the key was newly added."""
    if isinstance(value, str):
        value = value.encode()
    return _head().call("kv_put", key=_key(key), value=value,
                        overwrite=overwrite)["added"]


def kv_get(key: Union[str, bytes]) -> Optional[bytes]:
    return _head().call("kv_get", key=_key(key))["value"]


def kv_del(key: Union[str, bytes]) -> bool:
    return _head().call("kv_del", key=_key(key))["deleted"]


def kv_exists(key: Union[str, bytes]) -> bool:
    return kv_get(key) is not None


def kv_list(prefix: Union[str, bytes] = "") -> List[str]:
    return _head().call("kv_keys", prefix=_key(prefix))["keys"]


# reference-compatible aliases
_internal_kv_put = kv_put
_internal_kv_get = kv_get
_internal_kv_del = kv_del
_internal_kv_exists = kv_exists
_internal_kv_list = kv_list
