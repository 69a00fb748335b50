"""Direct access to the GCS internal key/value store.

Reference: ``python/ray/experimental/internal_kv.py`` — thin wrappers over
the GCS KV service, namespaced.  The same store backs the function registry,
runtime-env packages, and Serve/Workflow metadata; user code gets the
``kv`` namespace by default so it cannot collide with internals.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.rpc import run_async

_DEFAULT_NS = "kv"


def _gcs():
    from ..core import api
    worker = api._state.worker
    if worker is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    return worker.gcs


def internal_kv_put(key: str, value: bytes, overwrite: bool = True,
                    namespace: str = _DEFAULT_NS) -> bool:
    if isinstance(value, str):
        value = value.encode()
    return run_async(_gcs().call("kv_put", ns=namespace, key=key,
                                 value=bytes(value), overwrite=overwrite))


def internal_kv_get(key: str, namespace: str = _DEFAULT_NS) -> Optional[bytes]:
    return run_async(_gcs().call("kv_get", ns=namespace, key=key))


def internal_kv_del(key: str, namespace: str = _DEFAULT_NS) -> bool:
    return run_async(_gcs().call("kv_del", ns=namespace, key=key))


def internal_kv_exists(key: str, namespace: str = _DEFAULT_NS) -> bool:
    return run_async(_gcs().call("kv_exists", ns=namespace, key=key))


def internal_kv_keys(prefix: str = "", namespace: str = _DEFAULT_NS) -> List[str]:
    return run_async(_gcs().call("kv_keys", ns=namespace, prefix=prefix))
