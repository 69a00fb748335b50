"""The port's ``ray_tpu_torch.experimental.darray`` against the JAX
package's.

Four kinds of test:

* the copy guard: ``experimental/darray.py`` is the reference's file with
  ``ray_tpu`` renamed, save the seams of ``SEAMS``: the module docstring,
  the block product (``_k_matmul_sum`` in torch on a device, in the
  reference's dtypes, where the reference jits ``jnp.dot``), ``to_torch``
  where the reference has ``to_jax``, and ``dot``'s ``device`` (``None``:
  ``num_gpus=1`` block tasks, refused on a runtime without a ``GPU``);
* ``_k_matmul_sum`` against the reference's on seeded f32, f64, int64 and
  mixed blocks with a ragged edge: the same dtypes (64-bit blocks computed
  in 32 bits, as JAX with 64-bit types off), integers bit for bit (their
  products overflow int32 and wrap), floats within 1e-5 of the largest
  magnitude;
* ``to_torch`` against ``jax.device_put(a, NamedSharding(...))`` on the 8
  virtual CPU devices, shard by shard and bit for bit;
* the reference's five runtime cases of ``tests/test_darray.py``, their
  source with the package renamed, on one port runtime for the module.

One line is mapped by hand: ``test_blocked_dot``'s ``darray.dot(da, db)``
becomes ``darray.dot(da, db, device="cpu")`` (``DOT_ON_CPU``), since the
port's ``dot`` puts its block tasks on a card by default and this
runtime has none.  ``test_to_jax_sharded`` is not run: ``to_torch``'s
parity test takes its place.
"""

import ast
import inspect
import re
import types
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

import ray_tpu_torch
from ray_tpu.experimental import darray as ref_darray
from ray_tpu_torch.experimental import darray
from ray_tpu_torch.parallel.mesh import MeshSpec, PartitionSpec, Sharded

ROOT = Path(__file__).resolve().parent.parent
REL = "experimental/darray.py"
#: the one line of the reference's tests mapped by hand, and what it becomes
DOT_ON_CPU = ("    c = darray.dot(da, db)\n",
              '    c = darray.dot(da, db, device="cpu")\n')
#: the reference's case that does not run here, and why
NOT_PORTED = {"test_to_jax_sharded":
              "to_torch replaces to_jax: test_to_torch_matches_device_put"}


def _renamed(text):
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)


def _span(text, first, last=None):
    """The whole lines of ``text`` from the top-level definition or
    assignment ``first`` (its decorators and ``#:`` comment lines too)
    through ``last`` (default: ``first``), with the final newline; a
    class's method is ``Class.method``."""
    tree = ast.parse(text)
    lines = text.splitlines()

    def node(name):
        scope, *member = name.split(".")
        found = next(n for n in tree.body if scope in (
            getattr(n, "name", None),
            *[getattr(t, "id", None) for t in getattr(n, "targets", ())]))
        if member:
            found = next(n for n in found.body
                         if getattr(n, "name", None) == member[0])
        return found

    start = node(first)
    lo = min([start.lineno] + [d.lineno for d in getattr(
        start, "decorator_list", ())]) - 1
    while lo > 0 and lines[lo - 1].lstrip().startswith("#:"):
        lo -= 1
    return "\n".join(lines[lo:node(last or first).end_lineno]) + "\n"


_REF_TEXT = (ROOT / "ray_tpu" / REL).read_text()


def _ref_span(first, last=None):
    return _span(_renamed(_REF_TEXT), first, last)


#: where the port differs from the renamed reference: each pair is the
#: renamed reference's text and the port's text in its place, or the
#: first and last of the port's definitions that take its place
SEAMS = [
    # the module docstring: the port's design and usage
    ('''TPU-first redesign:

- Block size is per-array (the reference hardcodes ``BLOCK_SIZE = 10``),
  chosen so blocks are large enough to keep the MXU busy when a task
  lands on a TPU worker.
- Block kernels run through ``jax.jit`` inside the task (``jnp.dot`` et
  al.), so the same code path is MXU-accelerated on TPU workers and
  XLA-compiled on CPU workers — the reference's numpy kernels never
  touch an accelerator.
- ``to_jax(mesh, spec)`` bridges into the SPMD world: the block grid
  becomes one ``jax.Array`` laid out by a ``NamedSharding``, so a
  dataset-scale array built by tasks can feed a ``pjit`` program
  directly.
''', '''The port's design (the JAX package's, on torch and the card):

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
'''),
    ('''    c_jax = c.to_jax(mesh, P("dp", None))   # or: shard onto a mesh
''', '''    c_t = c.to_torch(mesh, PartitionSpec("dp", None))   # or: onto a mesh
'''),
    ('''# Each runs inside a worker task; jnp+jit so TPU workers use the MXU.
''', '''# Each runs inside a worker task; the block product in torch, on the
# task's card unless it was sent to a CPU.
'''),
    # the block product: torch on a device, in the reference's dtypes
    (_ref_span("_matmul_jit", "_k_matmul_sum"),
     ("_CANONICAL", "_k_matmul_sum")),
    # to_jax -> to_torch (as iter_jax_batches -> iter_torch_batches)
    (_ref_span("DistArray.to_jax"), ("DistArray.to_torch",)),
    # dot(device=None): the block tasks on a card, checked up front
    (_ref_span("dot"), ("dot",)),
]


def test_darray_is_the_renamed_reference_but_its_seams():
    port = (ROOT / "ray_tpu_torch" / REL).read_text()
    want = _renamed(_REF_TEXT)
    for old, new in SEAMS:
        assert want.count(old) == 1, old
        if isinstance(new, tuple):
            new = _span(port, *new)
        want = want.replace(old, new)
    assert port == want


def test_experimental_exports_darray():
    import ray_tpu.experimental as ref_experimental
    import ray_tpu_torch.experimental as experimental
    assert experimental.darray is darray
    assert experimental.__all__ == ref_experimental.__all__


# -------------------------------------------------- the block product

def _blocks(kind, seed=0):
    """A blocks, then B blocks, of one output block: rows 5, inner 4 + 4 +
    2 (the ragged edge), cols 3."""
    rng = np.random.default_rng(seed)
    inner = (4, 4, 2)

    def make(shape, dtype):
        if np.dtype(dtype).kind == "i":
            # products up to 2**40: their int32 sums wrap
            return rng.integers(-2 ** 20, 2 ** 20, shape).astype(dtype)
        return rng.standard_normal(shape).astype(dtype)

    a_dtype, b_dtype = {"f32": ("float32", "float32"),
                        "f64": ("float64", "float64"),
                        "i64": ("int64", "int64"),
                        "f32xi64": ("float32", "int64"),
                        "i64xf32": ("int64", "float32")}[kind]
    return ([make((5, k), a_dtype) for k in inner]
            + [make((k, 3), b_dtype) for k in inner])


@pytest.mark.parametrize("kind", ("f32", "f64", "i64", "f32xi64", "i64xf32"))
def test_block_product_matches_the_reference(kind):
    blocks = _blocks(kind)
    with warnings.catch_warnings():
        # jnp takes the int64 / float64 blocks as 32-bit, as it warns
        warnings.simplefilter("ignore", UserWarning)
        want = ref_darray._k_matmul_sum(*blocks)
    for b in blocks:
        # blocks from the store may be read-only: taken without a warning
        b.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = darray._k_matmul_sum(*blocks, device="cpu")
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "i":
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_block_product_without_a_device_needs_a_card(monkeypatch):
    """``device=None`` is the task's card: without one it raises, never
    computes on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        darray._k_matmul_sum(*_blocks("f32"))


def test_int_matmul_wraps_as_int32():
    """Chunked products summed in int32 equal the exact product modulo
    2**32, chunk size 1 too."""
    rng = np.random.default_rng(3)
    a = rng.integers(-2 ** 31, 2 ** 31, (6, 9), dtype=np.int64)
    b = rng.integers(-2 ** 31, 2 ** 31, (9, 4), dtype=np.int64)
    exact = (a.astype(object) @ b.astype(object)) % 2 ** 32
    want = np.array([[int(v) - 2 ** 32 if v >= 2 ** 31 else int(v)
                      for v in row] for row in exact], dtype=np.int32)
    ta, tb = (torch.from_numpy(x.astype(np.int32)) for x in (a, b))
    np.testing.assert_array_equal(darray._int_matmul(ta, tb).numpy(), want)
    old = darray._INT_CHUNK_ELEMS
    try:
        darray._INT_CHUNK_ELEMS = 1
        np.testing.assert_array_equal(darray._int_matmul(ta, tb).numpy(),
                                      want)
    finally:
        darray._INT_CHUNK_ELEMS = old


# ------------------------------------------------- on the port runtime

@pytest.fixture(scope="module")
def port_runtime():
    """One port runtime with the reference fixture's 4 CPUs and no GPU."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=64 << 20)
    yield
    ray_tpu_torch.shutdown()


def _reference_module():
    """``tests/test_darray.py`` with the package renamed and DOT_ON_CPU
    mapped, as a module of its own."""
    path = ROOT / "tests" / "test_darray.py"
    src = _renamed(path.read_text())
    assert src.count(DOT_ON_CPU[0]) == 1
    mod = types.ModuleType(f"ported_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src.replace(*DOT_ON_CPU), str(path), "exec"), mod.__dict__)
    return mod


REFERENCE = _reference_module()
CASES = [name for name, fn in vars(REFERENCE).items()
         if name.startswith("test_") and inspect.isfunction(fn)
         and name not in NOT_PORTED]


def test_every_reference_case_is_ported():
    assert len(CASES) == 5 and set(NOT_PORTED) <= set(vars(REFERENCE))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case, port_runtime):
    fn = getattr(REFERENCE, case)
    assert list(inspect.signature(fn).parameters) == ["ray_start_regular"]
    fn(None)


def test_dot_without_a_gpu_raises(port_runtime):
    """``device=None`` asks for a card per block task: with no ``GPU`` on
    the runtime it raises before submitting, after the shape checks."""
    da = darray.from_numpy(np.ones((4, 4), np.float32), block=2)
    with pytest.raises(RuntimeError, match="no GPU"):
        darray.dot(da, da)
    with pytest.raises(ValueError, match="device must be"):
        darray.dot(da, da, device="cuda:0")
    with pytest.raises(ValueError, match="inner dims"):
        darray.dot(da, darray.from_numpy(np.ones((6, 4), np.float32),
                                         block=2))


def test_int_dot_takes_the_reference_dtype(port_runtime):
    """int64 blocks come back int32 (the reference's), written into the
    declared int64 array by ``assemble``."""
    rng = np.random.default_rng(4)
    a = rng.integers(-2 ** 20, 2 ** 20, (5, 7))
    b = rng.integers(-2 ** 20, 2 ** 20, (7, 3))
    c = darray.dot(darray.from_numpy(a, block=4),
                   darray.from_numpy(b, block=4), device="cpu")
    assert c.dtype == np.int64
    assert ray_tpu_torch.get(c.blocks[0, 0]).dtype == np.int32
    wrapped = ((a @ b) + 2 ** 31) % 2 ** 32 - 2 ** 31
    np.testing.assert_array_equal(c.assemble(), wrapped)


@pytest.mark.parametrize("layout", ("dp8", "dp4xtp2"))
def test_to_torch_matches_device_put(port_runtime, cpu_mesh_devices, layout):
    """Each part of the port's ``Sharded`` is the shard
    ``jax.device_put`` puts on the same mesh device, bit for bit."""
    a = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    d = darray.from_numpy(a, block=4)
    if layout == "dp8":
        sizes, names = (8,), ("dp",)
        mesh = MeshSpec(dp=8, fsdp=1).build(["cpu"] * 8)
    else:
        sizes, names = (4, 2), ("dp", "tp")
        mesh = MeshSpec(dp=4, fsdp=1, tp=2).build(["cpu"] * 8)
    spec = names if layout != "dp8" else ("dp", None)
    jmesh = JaxMesh(np.array(cpu_mesh_devices[:8]).reshape(sizes), names)
    want = jax.device_put(a, JaxNamedSharding(jmesh, JaxP(*spec)))
    by_device = {s.device: np.asarray(s.data) for s in want.addressable_shards}
    got = d.to_torch(mesh, PartitionSpec(*spec))
    assert isinstance(got, Sharded) and got.shape == (16, 8)
    assert len(got.parts) == 8
    for part, jdev in zip(got.parts, jmesh.devices.flat):
        assert part.device == torch.device("cpu")
        np.testing.assert_array_equal(part.numpy(), by_device[jdev])
    np.testing.assert_array_equal(got.full().numpy(), a)


def test_to_torch_without_a_mesh(port_runtime, monkeypatch):
    a = np.arange(35, dtype=np.float32).reshape(7, 5)
    d = darray.from_numpy(a, block=3)
    got = d.to_torch(device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), d.assemble())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        d.to_torch()
