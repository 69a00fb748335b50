"""Device meshes over torch devices, and the tensor-parallel all-reduce.

Counterpart of ``ray_tpu/parallel/mesh.py``.  ``MeshSpec`` keeps the
reference's axes, sizes and errors; ``build`` lays a list of
``torch.device``s out as an array with ``AXIS_ORDER`` names, where the
reference builds a ``jax.sharding.Mesh`` (``named_sharding`` waits for the
sharding rules of ``models/sharding.py``).

Where XLA inserts the collectives of a sharded program, the port runs one
process over the mesh's devices and reduces explicitly: ``all_reduce`` sums
the shards' partial outputs on the first shard's device, in shard order,
and hands every shard its own copy of the sum.  One device may appear more
than once in a mesh (the port's counterpart of the reference's virtual CPU
mesh): its shards then run one after the other on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


class Mesh(NamedTuple):
    """Devices laid out along named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name of ``axis_names``."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes per axis; -1 on at most one axis = fill with remaining devices."""
    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def sizes(self) -> Dict[str, int]:
        return {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                "sp": self.sp, "ep": self.ep, "tp": self.tp}

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = self.sizes()
        fill = [k for k, v in sizes.items() if v == -1]
        if len(fill) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if fill:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[fill[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, "
                             f"have {n_devices}")
        return sizes

    def build(self, devices: Optional[Sequence] = None) -> Mesh:
        devices = [torch.device(d) for d in (
            devices if devices is not None else cuda_devices())]
        sizes = self.resolve(len(devices))
        arr = np.empty(len(devices), dtype=object)
        arr[:] = devices
        return Mesh(arr.reshape(tuple(sizes[a] for a in AXIS_ORDER)),
                    AXIS_ORDER)


def cuda_devices() -> List[torch.device]:
    """Every CUDA card this process sees (none without CUDA)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, **axis_sizes) -> Mesh:
    """Convenience: make_mesh(fsdp=4, tp=2) over the CUDA cards."""
    devices = cuda_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return MeshSpec(**axis_sizes).build(devices)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def replicate(t: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``t`` (on ``devices[0]``) for every shard: the first shard gets ``t``
    itself, every other shard a copy of its own on its device."""
    return [t] + [t.to(d, copy=True) for d in devices[1:]]


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' partial results, one tensor per shard.

    The sum runs on the first shard's device in shard order (``parts[0] +
    parts[1] + ...``), so every shard's copy holds the same bits; a shard
    on the same device as another still gets a tensor of its own.  One
    part is returned as it is."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total] + [total.to(p.device, copy=True) for p in parts[1:]]
