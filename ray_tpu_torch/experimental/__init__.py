"""ray_tpu_torch.experimental — counterparts of ``ray.experimental``.

Reference surface: ``python/ray/experimental/`` — ``internal_kv`` (GCS KV
access), ``set_resource``, ``simple_shuffle`` and the distributed
block-array package (``experimental/array/``, here ``darray`` with torch
block products on the card + a ``to_torch`` mesh bridge).  Kept
deliberately small; stable pieces graduate into ``ray_tpu_torch.util``.
"""

from . import darray
from .dynamic_resources import set_resource
from .shuffle import simple_shuffle
from .internal_kv import (
    internal_kv_del,
    internal_kv_exists,
    internal_kv_get,
    internal_kv_keys,
    internal_kv_put,
)

__all__ = [
    "darray",
    "set_resource",
    "simple_shuffle",
    "internal_kv_get",
    "internal_kv_put",
    "internal_kv_del",
    "internal_kv_exists",
    "internal_kv_keys",
]
