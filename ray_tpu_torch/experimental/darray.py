"""Distributed block arrays over the object store.

Reference: ``python/ray/experimental/array/distributed/core.py`` — a
``DistArray`` holds a grid of block object refs plus ``zeros/ones/eye/
dot/assemble`` built from remote tasks per block.

The port's design (the JAX package's, on torch and the card):

- Block size is per-array (the reference hardcodes ``BLOCK_SIZE = 10``),
  chosen so blocks are large enough to keep a card busy when a task
  lands on one.
- ``dot``'s block products run in torch inside the task, on a card by
  default (``num_gpus=1`` tasks; ``device="cpu"`` for CPU tasks), in the
  dtypes the JAX package computes in with 64-bit types off (int64 blocks
  in int32, float64 in float32), and return host numpy.  The
  constructors, ``map_blocks`` and the elementwise ops stay numpy tasks.
- ``to_torch(mesh, spec)`` bridges into the port's mesh programs: the
  block grid becomes a ``parallel.mesh.Sharded`` laid out by a
  ``NamedSharding``, one part per mesh device (without a mesh, one
  tensor on the card).

Usage::

    from ray_tpu_torch.experimental import darray
    a = darray.from_numpy(np.arange(1e6).reshape(1000, 1000))
    b = darray.ones((1000, 1000))
    c = darray.dot(a, b)            # blockwise matmul, one task per block
    c_np = c.assemble()             # gather to the driver
    c_t = c.to_torch(mesh, PartitionSpec("dp", None))   # or: onto a mesh
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["DistArray", "from_numpy", "zeros", "ones", "eye", "dot",
           "map_blocks", "DEFAULT_BLOCK"]

#: default block edge — 512^2 f32 blocks are 1 MiB: big enough to matmul
#: efficiently, small enough to spread over a cluster
DEFAULT_BLOCK = 512


from ray_tpu_torch.util.remote_util import lazy_remote as _remote


# ---------------------------------------------------------------- kernels
# Each runs inside a worker task; the block product in torch, on the
# task's card unless it was sent to a CPU.

def _k_fill(shape, dtype, value):
    return np.full(shape, value, dtype)


def _k_eye(shape, dtype, k0, k1):
    out = np.zeros(shape, dtype)
    for r in range(shape[0]):
        c = r + k0 - k1
        if 0 <= c < shape[1]:
            out[r, c] = 1
    return out


#: the dtype the JAX package computes a block in, with 64-bit types off
#: (jnp's canonical dtypes)
_CANONICAL = {np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.complex128): np.dtype(np.complex64)}
#: integer products: inner indices taken at a time, so that a chunk's
#: [rows, chunk, cols] products hold at most this many elements
_INT_CHUNK_ELEMS = 1 << 24


def _int_matmul(a, b):
    """``a @ b`` for integer tensors on any device (torch has no CUDA
    integer matmul): products summed a chunk of the inner dimension at a
    time in the blocks' dtype, wrapping as XLA's integer product does (the
    sum is exact modulo 2**bits in any order)."""
    import torch
    rows, inner = a.shape
    cols = b.shape[1]
    step = max(1, _INT_CHUNK_ELEMS // max(1, rows * cols))
    out = torch.zeros((rows, cols), dtype=a.dtype, device=a.device)
    for k in range(0, inner, step):
        out += (a[:, k:k + step, None] * b[None, k:k + step, :]).sum(
            1, dtype=a.dtype)
    return out


def _k_matmul_sum(*blocks, device=None):
    """sum_k A_ik @ B_kj for one output block, in torch on ``device``
    (None: the task's card), accumulated in block order as the JAX
    package's jitted ``go`` does: each block in its canonical dtype
    (``_CANONICAL``), each product in the pair's promoted dtype.  Floats
    take ``matmul`` (TF32 as torch's default: off), integers
    ``_int_matmul``.  -> host numpy: a CUDA tensor in the store would
    need a card to read."""
    import torch

    from ray_tpu_torch.device import resolve

    dev = resolve(device)
    # store blocks may be read-only views: np.array copies before torch
    # takes them
    ts = [torch.from_numpy(np.array(b, dtype=_CANONICAL.get(b.dtype,
                                                           b.dtype))).to(dev)
          for b in blocks]
    n = len(ts) // 2
    acc = torch.zeros((ts[0].shape[0], ts[n].shape[1]), dtype=ts[0].dtype,
                      device=dev)
    for a, b in zip(ts[:n], ts[n:]):
        dtype = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dtype), b.to(dtype)
        acc = acc + (a @ b if dtype.is_floating_point or dtype.is_complex
                     else _int_matmul(a, b))
    return acc.cpu().numpy()


def _k_map(fn, *blocks):
    return np.asarray(fn(*blocks))


class DistArray:
    """A dense array stored as a grid of blocks in the object store.

    ``blocks`` is an object-dtype ndarray of ``ObjectRef``s with one entry
    per block-grid coordinate (reference: ``DistArray.objectids``)."""

    def __init__(self, shape: Sequence[int], blocks: np.ndarray,
                 block_shape: Sequence[int], dtype=np.float32):
        self.shape = tuple(int(s) for s in shape)
        self.block_shape = tuple(int(s) for s in block_shape)
        self.blocks = blocks
        self.dtype = np.dtype(dtype)
        expect = tuple(-(-s // b) for s, b in zip(self.shape,
                                                  self.block_shape))
        if blocks.shape != expect:
            raise ValueError(f"block grid {blocks.shape} != expected {expect}")

    # ------------------------------------------------------------- layout

    @property
    def num_blocks(self) -> Tuple[int, ...]:
        return self.blocks.shape

    def _block_bounds(self, index: Tuple[int, ...]):
        lower = [i * b for i, b in zip(index, self.block_shape)]
        upper = [min((i + 1) * b, s)
                 for i, b, s in zip(index, self.block_shape, self.shape)]
        return lower, upper

    # ------------------------------------------------------------- gather

    def assemble(self) -> np.ndarray:
        """Fetch every block and stitch the full array on the driver
        (reference: ``DistArray.assemble``)."""
        import ray_tpu_torch
        out = np.zeros(self.shape, self.dtype)
        flat_refs = list(self.blocks.flat)
        flat_vals = ray_tpu_torch.get(flat_refs)
        for index, val in zip(itertools.product(
                *[range(n) for n in self.num_blocks]), flat_vals):
            lo, up = self._block_bounds(index)
            out[tuple(slice(l, u) for l, u in zip(lo, up))] = val
        return out

    def to_torch(self, mesh=None, spec=None, device=None):
        """Assemble into torch: without a ``mesh``, one tensor on
        ``device`` (None: the card, which raises without one); with one,
        a ``parallel.mesh.Sharded`` laid out by ``NamedSharding(mesh,
        spec)`` (a ``parallel.mesh.PartitionSpec``), each part on its mesh
        device.  This is the bridge from task-built data to the port's
        mesh programs (the JAX package's ``to_jax``; the reference's
        DistArray never meets an accelerator)."""
        import torch

        from ray_tpu_torch.device import resolve
        from ray_tpu_torch.parallel import mesh as mesh_mod

        dev = resolve(device) if mesh is None else None
        host = torch.from_numpy(self.assemble())
        if mesh is None:
            return host.to(dev)
        return mesh_mod.device_put(host, mesh_mod.NamedSharding(mesh, spec))

    # -------------------------------------------------------------- math

    def map_blocks(self, fn) -> "DistArray":
        """Apply ``fn(block) -> block`` remotely to every block (shape-
        preserving elementwise ops)."""
        rt = _remote(_k_map)
        grid = np.empty(self.num_blocks, dtype=object)
        for index in itertools.product(*[range(n) for n in self.num_blocks]):
            grid[index] = rt.remote(fn, self.blocks[index])
        return DistArray(self.shape, grid, self.block_shape, self.dtype)

    def _binary(self, other: "DistArray", fn) -> "DistArray":
        if (self.shape != other.shape
                or self.block_shape != other.block_shape):
            raise ValueError("shape/block mismatch")
        rt = _remote(_k_map)
        grid = np.empty(self.num_blocks, dtype=object)
        for index in itertools.product(*[range(n) for n in self.num_blocks]):
            grid[index] = rt.remote(fn, self.blocks[index],
                                    other.blocks[index])
        return DistArray(self.shape, grid, self.block_shape, self.dtype)

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)


# ----------------------------------------------------------- constructors

def _build(shape, block, dtype, make_ref) -> DistArray:
    shape = tuple(int(s) for s in shape)
    block_shape = tuple(min(block, s) for s in shape)
    grid_shape = tuple(-(-s // b) for s, b in zip(shape, block_shape))
    grid = np.empty(grid_shape, dtype=object)
    for index in itertools.product(*[range(n) for n in grid_shape]):
        lower = [i * b for i, b in zip(index, block_shape)]
        upper = [min((i + 1) * b, s) for i, b, s in zip(index, block_shape,
                                                        shape)]
        bshape = tuple(u - l for l, u in zip(lower, upper))
        grid[index] = make_ref(index, lower, bshape)
    return DistArray(shape, grid, block_shape, dtype)


def from_numpy(a: np.ndarray, block: int = DEFAULT_BLOCK) -> DistArray:
    """Scatter a host array into the object store block by block
    (reference: ``numpy_to_dist``)."""
    import ray_tpu_torch
    a = np.asarray(a)

    def put_block(index, lower, bshape):
        sl = tuple(slice(l, l + s) for l, s in zip(lower, bshape))
        return ray_tpu_torch.put(np.ascontiguousarray(a[sl]))

    return _build(a.shape, block, a.dtype, put_block)


def zeros(shape, dtype=np.float32, block: int = DEFAULT_BLOCK) -> DistArray:
    rt = _remote(_k_fill)
    return _build(shape, block, dtype,
                  lambda i, lo, bs: rt.remote(bs, np.dtype(dtype).str, 0))


def ones(shape, dtype=np.float32, block: int = DEFAULT_BLOCK) -> DistArray:
    rt = _remote(_k_fill)
    return _build(shape, block, dtype,
                  lambda i, lo, bs: rt.remote(bs, np.dtype(dtype).str, 1))


def eye(n: int, dtype=np.float32, block: int = DEFAULT_BLOCK) -> DistArray:
    rt = _remote(_k_eye)
    return _build((n, n), block, dtype,
                  lambda i, lo, bs: rt.remote(bs, np.dtype(dtype).str,
                                              lo[0], lo[1]))


def map_blocks(fn, a: DistArray) -> DistArray:
    return a.map_blocks(fn)


def dot(a: DistArray, b: DistArray, device=None) -> DistArray:
    """Blocked matmul: one task per OUTPUT block computes
    ``sum_k A[i,k] @ B[k,j]`` in torch (reference:
    ``distributed/core.py:192`` dot — its per-block tasks run numpy).
    ``device=None`` puts every block task on a card (``num_gpus=1``; a
    runtime with no ``GPU`` raises here, where the tasks would wait
    forever), ``"cpu"`` on a CPU with no card.  The declared dtype is
    ``np.result_type`` of the two, as the JAX package's."""
    if len(a.shape) != 2 or len(b.shape) != 2:
        raise ValueError("dot needs 2-D arrays")
    if a.shape[1] != b.shape[0] or a.block_shape[1] != b.block_shape[0]:
        raise ValueError(
            f"inner dims/blocks must match: {a.shape}x{b.shape}, "
            f"blocks {a.block_shape}x{b.block_shape}")
    rt = _remote(_k_matmul_sum)
    if device is None:
        import ray_tpu_torch
        if ray_tpu_torch.cluster_resources().get("GPU", 0) < 1:
            raise RuntimeError(
                "dot: the runtime has no GPU for its block tasks; pass "
                "device='cpu' to run them on CPUs")
        rt = rt.options(num_gpus=1)
    elif device != "cpu":
        raise ValueError(f"dot: device must be None (a card) or 'cpu', "
                         f"not {device!r}")
    out_shape = (a.shape[0], b.shape[1])
    out_block = (a.block_shape[0], b.block_shape[1])
    grid_shape = tuple(-(-s // bl) for s, bl in zip(out_shape, out_block))
    grid = np.empty(grid_shape, dtype=object)
    K = a.num_blocks[1]
    for i in range(grid_shape[0]):
        for j in range(grid_shape[1]):
            a_refs = [a.blocks[i, k] for k in range(K)]
            b_refs = [b.blocks[k, j] for k in range(K)]
            grid[i, j] = rt.remote(*a_refs, *b_refs, device=device)
    return DistArray(out_shape, grid, out_block,
                     np.result_type(a.dtype, b.dtype))
