"""Device meshes over torch devices, shardings, and the collectives.

Counterpart of ``ray_tpu/parallel/mesh.py``.  ``MeshSpec`` keeps the
reference's axes, sizes and errors; ``build`` lays a list of
``torch.device``s out as an array with ``AXIS_ORDER`` names, where the
reference builds a ``jax.sharding.Mesh``.  ``PartitionSpec`` and
``NamedSharding`` are the port's own small counterparts of JAX's: a spec
names, per dimension of a leaf, the mesh axes that cut it (None: whole).
A leaf placed on a mesh is a ``Sharded``: one part per device, in the
mesh's device order (the counterpart of a ``jax.Array``'s
``addressable_shards``), each the block of the leaf its spec gives that
device; devices that differ only on axes the spec does not name hold
copies of one block (replicas).

Where XLA inserts the collectives of a sharded program, the port runs one
process over the mesh's devices and moves data explicitly:
``all_gather``, ``reduce_scatter`` and ``all_reduce`` work on the parts of
one group of devices, in the group's order.  Every sum runs on the first
part's device in part order (``parts[0] + parts[1] + ...``), so every
replica of a sum holds the same bits.  Each is differentiable: the
backward of an all-gather is a reduce-scatter of the gradients, of a
reduce-scatter an all-gather, of an all-reduce an all-reduce.
``ring_shift`` (the ring step of ring attention and the pipeline) and
``all_to_all`` (Ulysses attention) move blocks without summing.  One device
may appear more than once in a mesh (the port's counterpart of the
reference's virtual CPU mesh): its shards then run one after the other on
it, each with tensors of its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import device as device_mod

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


class Mesh(NamedTuple):
    """Devices laid out along named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name of ``axis_names``."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> List[torch.device]:
        """Every device, in the mesh's (row-major) order."""
        return list(self.devices.flat)

    def coords(self, i: int) -> Dict[str, int]:
        """Device i's index along each axis."""
        return dict(zip(self.axis_names,
                        np.unravel_index(i, self.devices.shape)))


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
        """The mesh over ``devices`` (default: every CUDA card; a list may
        name one device many times, e.g. ``["cuda:0"] * 8``)."""
        devices = [device_mod.resolve(d) for d in (
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


def axis_groups(mesh: Mesh, axes: Sequence[str]) -> List[List[int]]:
    """The mesh's device indices in groups that differ only along ``axes``:
    one group per combination of the other axes' indices, each ordered
    row-major over ``axes`` in ``AXIS_ORDER``'s order."""
    axes = [a for a in mesh.axis_names if a in axes]
    idx = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    rest = [k for k, a in enumerate(mesh.axis_names) if a not in axes]
    moved = idx.transpose(rest + [mesh.axis_names.index(a) for a in axes])
    size = math.prod(mesh.shape[a] for a in axes)
    return [list(g) for g in moved.reshape(-1, size).tolist()]


# ---------------------------------------------------------------------------
# Specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """Per dimension of a leaf: None (whole), an axis name, or a tuple of
    axis names (cut over their product, row-major).  Missing trailing
    entries are None, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding(NamedTuple):
    """A spec over a mesh: how a leaf is cut over the mesh's devices."""
    mesh: Mesh
    spec: PartitionSpec

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec cuts along."""
        return tuple(a for e in self.spec for a in spec_axes(e))

    def slices(self, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """Each device's block of a leaf of ``shape``, in mesh order.  An
        axis that does not divide the dimension it cuts raises."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than a "
                             f"leaf of shape {tuple(shape)} has dimensions")
        sizes = self.mesh.shape
        out = []
        for i in range(self.mesh.devices.size):
            at = self.mesh.coords(i)
            sl = []
            for dim, entry in enumerate(self.spec):
                axes = spec_axes(entry)
                n = math.prod(sizes[a] for a in axes)
                if shape[dim] % n:
                    raise ValueError(
                        f"mesh axes {axes} ({n} ways) do not divide "
                        f"dimension {dim} of size {shape[dim]} (spec "
                        f"{self.spec})")
                block = 0
                for a in axes:
                    block = block * sizes[a] + at[a]
                w = shape[dim] // n
                sl.append(slice(block * w, (block + 1) * w))
            out.append(tuple(sl))
        return out

    def replica_groups(self) -> List[List[int]]:
        """Device indices grouped by the block they hold (the devices that
        differ only on axes the spec leaves whole)."""
        return axis_groups(self.mesh, [a for a in self.mesh.axis_names
                                       if a not in self.axes()])


def named_sharding(mesh: Mesh, spec_tree):
    """Map a PartitionSpec tree to a NamedSharding tree for the given mesh,
    dropping axis names the mesh doesn't have (so the same rules work on a
    dp-only mesh and a full dp×fsdp×tp×sp×ep mesh)."""
    mesh_axes = set(mesh.axis_names)

    def fix_spec(spec: PartitionSpec) -> NamedSharding:
        parts = []
        for entry in spec:
            if entry is None:
                parts.append(None)
            elif isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in mesh_axes
                             and mesh.shape[a] > 0)
                parts.append(kept if kept else None)
            else:
                parts.append(entry if entry in mesh_axes else None)
        return NamedSharding(mesh, PartitionSpec(*parts))

    return _map_tree(fix_spec, spec_tree)


def _map_tree(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


class Sharded(NamedTuple):
    """A leaf on a mesh: ``parts[i]`` is device i's block (mesh order)."""
    parts: List[torch.Tensor]
    sharding: NamedSharding

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole leaf's shape."""
        counts = [math.prod(self.sharding.mesh.shape[a] for a in spec_axes(e))
                  for e in self.sharding.spec]
        block = self.parts[0].shape
        return tuple(s * (counts[d] if d < len(counts) else 1)
                     for d, s in enumerate(block))

    def full(self, device="cpu") -> torch.Tensor:
        """The leaf put back together on ``device`` from the first replica
        of each block."""
        shape = self.shape
        out = torch.empty(shape, dtype=self.parts[0].dtype, device=device)
        slices = self.sharding.slices(shape)
        for group in self.sharding.replica_groups():
            out[slices[group[0]]] = self.parts[group[0]].detach().to(device)
        return out


def split(x: torch.Tensor, sharding: NamedSharding,
          requires_grad: bool = False) -> Sharded:
    """Cut ``x`` (anywhere; on the host it never reaches a device whole)
    into the sharding's blocks, each copied to its device as a tensor of
    its own."""
    parts = []
    for sl, dev in zip(sharding.slices(x.shape), sharding.mesh.device_list):
        part = x[sl].to(dev, copy=True).contiguous()
        parts.append(part.requires_grad_(requires_grad))
    return Sharded(parts, sharding)


def device_put(tree, shardings, requires_grad: bool = False):
    """A tree of tensors (a dict tree, or one tensor) placed by a matching
    tree of ``NamedSharding``s: ``Sharded`` leaves, each leaf cut where it
    lies."""
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k], requires_grad)
                for k, v in tree.items()}
    return split(tree, shardings, requires_grad)


# ---------------------------------------------------------------------------
# Collectives over one group of parts
# ---------------------------------------------------------------------------

# The bodies of the collectives, without autograd: a remat layer's steps
# (``models/remat.py``) call them and write their backward out.  A part or
# gradient may be None (a copy nobody used): it adds nothing.

def ordered_sum(parts: Sequence[Optional[torch.Tensor]]):
    """The sum of the parts that are not None, in order, on the first such
    part's device (None when every part is None)."""
    total = None
    for p in parts:
        if p is None:
            continue
        total = p if total is None else total + p.to(total.device)
    return total


def _copies(t: torch.Tensor, devices: Sequence[torch.device]):
    """``t`` for the first device, a copy of its own for each other."""
    return [t] + [t.to(d, copy=True) for d in devices[1:]]


def gather_parts(parts, dim: int, devices) -> List[torch.Tensor]:
    """The parts put together along ``dim``, a copy on each device."""
    full = torch.cat([p.to(devices[0]) for p in parts], dim)
    return _copies(full, devices)


def scatter_sum(grads, dim: int, sizes, devices) -> List:
    """The sum cut along ``dim`` into blocks of ``sizes``: block i added up
    on ``devices[i]`` from every part's block i, in part order (the bits
    of ``ordered_sum``, with no whole sum held anywhere)."""
    blocks = [None if g is None else torch.split(g, list(sizes), dim)
              for g in grads]
    out = []
    for i, d in enumerate(devices):
        total = None
        for b in blocks:
            if b is None:
                continue
            if total is None:
                total = b[i].to(d, copy=True).contiguous()
            else:
                total.add_(b[i].to(d))
        out.append(total)
    return out


def sum_parts(parts, devices) -> List:
    """The sum, a copy on each device."""
    total = ordered_sum(parts)
    if total is None:
        return [None] * len(devices)
    return _copies(total.to(devices[0]), devices)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.set_materialize_grads(False)
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.devices = [p.device for p in parts]
        return tuple(gather_parts(parts, dim, devices))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None,
                *scatter_sum(grads, ctx.dim, ctx.sizes, ctx.devices))


class _ReduceScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.set_materialize_grads(False)
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        n = len(parts)
        size = parts[0].shape[dim]
        if size % n:
            raise ValueError(f"reduce_scatter: {n} parts do not divide "
                             f"dimension {dim} of size {size}")
        return tuple(scatter_sum(parts, dim, [size // n] * n, ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        if any(g is None for g in grads):
            ref = next(g for g in grads if g is not None)
            grads = [torch.zeros_like(ref) if g is None else g
                     for g in grads]
        return (None, *gather_parts(grads, ctx.dim, ctx.devices))


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, *parts):
        ctx.set_materialize_grads(False)
        ctx.devices = [p.device for p in parts]
        return tuple(sum_parts(parts, ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        return tuple(sum_parts(grads, ctx.devices))


def _differentiable(parts) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in parts)


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices: Optional[Sequence[torch.device]] = None
               ) -> List[torch.Tensor]:
    """The parts put together along ``dim``, one copy per device of
    ``devices`` (default: each part's own device; a subset gathers onto
    those devices only).  Backward: the gradients of every copy summed in
    order and cut back into the parts' blocks (a reduce-scatter)."""
    devices = [p.device for p in parts] if devices is None else list(devices)
    if len(parts) == 1 and devices == [parts[0].device]:
        return list(parts)
    if _differentiable(parts):
        return list(_AllGather.apply(dim, devices, *parts))
    return gather_parts(parts, dim, devices)


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int
                   ) -> List[torch.Tensor]:
    """The sum of the parts, cut along ``dim`` into ``len(parts)`` blocks:
    block i on part i's device.  Backward: an all-gather."""
    if len(parts) == 1:
        return list(parts)
    if _differentiable(parts):
        return list(_ReduceScatter.apply(dim, *parts))
    n = len(parts)
    return scatter_sum(parts, dim, [parts[0].shape[dim] // n] * n,
                        [p.device for p in parts])


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' partial results, one tensor per shard.

    The sum runs on the first shard's device in shard order (``parts[0] +
    parts[1] + ...``), so every shard's copy holds the same bits; a shard
    on the same device as another still gets a tensor of its own.  One
    part is returned as it is.  Backward: an all-reduce of the copies'
    gradients."""
    if len(parts) == 1:
        return list(parts)
    if _differentiable(parts):
        return list(_AllReduce.apply(*parts))
    return sum_parts(parts, [p.device for p in parts])


def replicate(t: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``t`` (on ``devices[0]``) for every shard: the first shard gets ``t``
    itself, every other shard a copy of its own on its device."""
    return _copies(t, devices)



# ---------------------------------------------------------------------------
# Moves without a sum: the ring step and the all-to-all
# ---------------------------------------------------------------------------

def ring_shift(parts: Sequence[Optional[torch.Tensor]],
               devices: Optional[Sequence[torch.device]] = None
               ) -> List[Optional[torch.Tensor]]:
    """One step around a ring (the reference's ``ppermute`` with ``i ->
    i + 1``): part i moves to position ``(i + 1) % n``, copied onto that
    position's device (default: each part's own), a tensor of its own
    even on the same device.  A None part stays None.  Differentiable:
    autograd's backward of the copies moves each gradient one step back."""
    n = len(parts)
    if devices is None:
        devices = [p.device for p in parts]
    return [None if parts[(i - 1) % n] is None else
            parts[(i - 1) % n].to(devices[i], copy=True) for i in range(n)]


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """The reference's tiled ``all_to_all``: each part is cut along
    ``split_dim`` into ``n`` blocks, and part i becomes the i-th blocks of
    every part, in part order, put together along ``concat_dim`` on part
    i's device.  Differentiable: the backward is the all-to-all with the
    two dimensions swapped."""
    n = len(parts)
    if parts[0].shape[split_dim] % n:
        raise ValueError(f"all_to_all: {n} parts do not divide dimension "
                         f"{split_dim} of size {parts[0].shape[split_dim]}")
    blocks = [torch.chunk(p, n, split_dim) for p in parts]
    return [torch.cat([b[i].to(parts[i].device) for b in blocks], concat_dim)
            for i in range(n)]
