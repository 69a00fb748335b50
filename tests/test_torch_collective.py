"""The port's ``ray_tpu_torch.util.collective`` against the JAX package's.

Four kinds of test:

* the copy guard: ``util/collective.py`` is the reference's file with
  ``ray_tpu`` renamed, save the seams of ``SEAMS``: the module docstring,
  ``mesh_collectives`` (the reference's wraps ``lax`` ops inside
  ``shard_map``; the port's takes every device's part over a
  ``parallel/mesh.py`` ``Mesh``) and the payload's trip to host numpy
  (``_host``, where the reference calls ``np.asarray``);
* ``mesh_collectives`` against the reference's under ``shard_map`` on the
  8 virtual CPU devices as a 2 x 2 x 2 mesh, every op and keyword along
  each axis and along all three at once, on the same seeded parts: moves,
  max, min and broadcast bit for bit, sums and means within 1e-6 of the
  largest magnitude, and the gradients of ``allreduce``, ``allgather`` and
  ``reducescatter`` within 1e-6 of ``jax.grad`` through ``shard_map``;
* the reference's ``tests/test_util.py::test_collective_group_host``, its
  source with the package renamed, on one port runtime for the module;
* the host group fed torch tensors: a CPU tensor goes in as numpy, a
  bfloat16 tensor raises ``TypeError``, and
  ``destroy_collective_group`` removes the group's state actor.
"""

import ast
import functools
import inspect
import re
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JaxP

import ray_tpu_torch
from ray_tpu.util import collective as ref_col
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.util import collective as col

ROOT = Path(__file__).resolve().parent.parent
REL = "util/collective.py"


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


def expected_port_text(ref_text, port_text, seams):
    """The renamed reference with each seam's old text (which must occur
    once) replaced: by the new text, or, where the seam names the first
    and last of the port's definitions in its place, by the port's own
    source of that span."""
    want = _renamed(ref_text)
    for old, new in seams:
        assert want.count(old) == 1, old
        if isinstance(new, tuple):
            new = _span(port_text, *new)
        want = want.replace(old, new)
    return want


_REF_TEXT = (ROOT / "ray_tpu" / REL).read_text()


def _ref_span(first, last=None):
    return _span(_renamed(_REF_TEXT), first, last)


#: where the port differs from the renamed reference: each pair is the
#: renamed reference's text and the port's text in its place, or the
#: first and last of the port's definitions that take its place
SEAMS = [
    # the module docstring: the port's stance on in-mesh collectives
    ('''TPU-native stance (SURVEY §2.3/§5.8): *in-mesh* tensor collectives are not a
runtime service — they are ``jax.lax`` ops (psum/all_gather/ppermute/
all_to_all) compiled into the pjit program and executed over ICI.  This module
therefore provides two things:

1. ``mesh_collectives`` — thin functional wrappers over the XLA collectives,
   for code written with ``shard_map`` that wants a backend-shaped API.
''', '''The port's stance: *in-mesh* tensor collectives are not a runtime service —
one process runs a leaf's parts over a ``parallel/mesh.py`` ``Mesh`` and
moves them with that module's collectives (``all_reduce``, ``all_gather``,
``reduce_scatter``, ``all_to_all``, ``ring_shift``).  This module therefore
provides two things:

1. ``mesh_collectives`` — the collectives of one leaf's parts along a mesh
   axis, with the keywords and edge behaviour of the ``lax`` ops the JAX
   package wraps (its versions run inside ``shard_map`` on one device's
   block; these take every device's part at once).
'''),
    ('''   tensors should live in sharded jax.Arrays inside compiled programs.
''', '''   tensors should live on the mesh, or move over NCCL in a process group.
   A torch tensor on any device goes in as host numpy (``.detach().cpu()``);
   results are numpy.
'''),
    # _host looks for torch in sys.modules (the module imports no torch)
    ("import time\n", "import sys\nimport time\n"),
    # mesh_collectives: every device's part over a Mesh, not lax in
    # shard_map
    ("# 1. In-mesh collectives (XLA / ICI): functional wrappers\n",
     "# 1. In-mesh collectives: one leaf's parts over a parallel.mesh Mesh\n"),
    (_ref_span("mesh_collectives"), ("_over_groups", "mesh_collectives")),
    # a payload's trip to host numpy: np.asarray of a CUDA tensor raises
    (_ref_span("_GroupState"), ("_host", "_GroupState")),
    *[(line, line.replace("np.asarray(array)", "_host(array)")) for line in (
        '        return self._sync("allreduce", np.asarray(array), red)\n',
        '        return self._sync("allgather", np.asarray(array), '
        'lambda p: list(p))\n',
        '        return self._sync("broadcast", np.asarray(array),\n',
        '        ray_tpu_torch.get(self.state.p2p_put.remote(key, '
        'np.asarray(array)))\n')],
]


def test_collective_is_the_renamed_reference_but_its_seams():
    """A fix or a drift outside the seams shows here; ``_GroupState`` is
    the reference's, with ``_host`` defined before it."""
    port = (ROOT / "ray_tpu_torch" / REL).read_text()
    assert port == expected_port_text(_REF_TEXT, port, SEAMS)
    assert _span(port, "_GroupState") == _ref_span("_GroupState")


# --------------------------------------------- mesh_collectives vs lax

AXES = ("dp", "fsdp", "tp")
#: each device's block: both dimensions divide by every group size (2, 8)
BLOCK = (8, 16)
SUM_TOL = 1e-6
GRAD_TOL = 1e-6
#: the mesh axes: each alone, then all three as one group of 8
AXIS_CASES = (*AXES, AXES)


def _n(axis):
    return 2 if isinstance(axis, str) else 8


#: (id, method, keywords(group size), exact): every op and keyword of the
#: reference; exact ones are moves or picks, the rest sums
OPS = (
    ("allreduce-sum", "allreduce", lambda n: {"op": "sum"}, False),
    ("allreduce-mean", "allreduce", lambda n: {"op": "mean"}, False),
    ("allreduce-max", "allreduce", lambda n: {"op": "max"}, True),
    ("allreduce-min", "allreduce", lambda n: {"op": "min"}, True),
    ("allgather", "allgather", lambda n: {"tiled": False}, True),
    ("allgather-tiled", "allgather", lambda n: {"tiled": True}, True),
    ("reducescatter-0", "reducescatter",
     lambda n: {"scatter_dimension": 0}, False),
    ("reducescatter-1", "reducescatter",
     lambda n: {"scatter_dimension": 1}, False),
    *[(f"alltoall-{s}{c}", "alltoall",
       functools.partial(lambda n, s, c: {"split_axis": s,
                                          "concat_axis": c}, s=s, c=c), True)
      for s in (0, 1) for c in (0, 1)],
    ("permute-ring", "permute",
     lambda n: {"perm": [(i, (i + 1) % n) for i in range(n)]}, True),
    # one pair: every other position gets zeros
    ("permute-one", "permute", lambda n: {"perm": [(n - 1, 0)]}, True),
    ("broadcast-0", "broadcast", lambda n: {"root": 0}, True),
    ("broadcast-last", "broadcast", lambda n: {"root": n - 1}, True),
)
OP_BY_ID = {op[0]: op for op in OPS}
GRAD_OPS = ("allreduce-sum", "allreduce-mean", "allgather", "allgather-tiled",
            "reducescatter-0", "reducescatter-1")


def _axis_id(axis):
    return axis if isinstance(axis, str) else "+".join(axis)


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), AXES)


@functools.lru_cache(maxsize=None)
def _port_mesh():
    return MeshSpec(dp=2, fsdp=2, tp=2).build(["cpu"] * 8)


def _parts(seed=0):
    """Device i's block, as one seeded [8, *BLOCK] array."""
    return np.random.default_rng(seed).standard_normal(
        (8, *BLOCK)).astype(np.float32)


def _shard_mapped(fn):
    """``fn`` on each device's block: the stacked blocks in, each device's
    output stacked along axis 0 out."""
    spec = JaxP(AXES)
    return jax.shard_map(fn, mesh=_jax_mesh(), in_specs=spec,
                         out_specs=spec)


def _per_device(global_out):
    return np.split(np.asarray(global_out), 8)


@functools.lru_cache(maxsize=None)
def _reference_outputs(axis):
    """Every op of OPS along ``axis`` under one ``shard_map``: id -> each
    device's output."""
    n = _n(axis)

    def body(x):
        return tuple(getattr(ref_col.mesh_collectives, method)(
            x, axis, **kw(n)) for _, method, kw, _ in OPS)

    x = jnp.asarray(_parts().reshape(8 * BLOCK[0], BLOCK[1]))
    outs = jax.jit(_shard_mapped(body))(x)
    return {op[0]: _per_device(o) for op, o in zip(OPS, outs)}


def _port_call(op_id, axis, parts):
    _, method, kw, _ = OP_BY_ID[op_id]
    return getattr(col.mesh_collectives, method)(parts, _port_mesh(), axis,
                                                 **kw(_n(axis)))


def _close(got, want, tol):
    """Within ``tol`` of want's largest magnitude (sums in another order)."""
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("axis", AXIS_CASES, ids=_axis_id)
@pytest.mark.parametrize("op_id", list(OP_BY_ID))
def test_mesh_collective_matches_lax_under_shard_map(op_id, axis):
    parts = [torch.from_numpy(p) for p in _parts()]
    got = _port_call(op_id, axis, parts)
    want = _reference_outputs(axis)[op_id]
    assert len(got) == 8
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        if OP_BY_ID[op_id][3]:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, SUM_TOL)


@pytest.mark.parametrize("axis", ("fsdp", AXES), ids=_axis_id)
@pytest.mark.parametrize("op_id", GRAD_OPS)
def test_mesh_collective_gradients_match_jax_grad(op_id, axis):
    """d/d(parts) of sum_i <out_i, w_i>, against ``jax.grad`` through
    ``shard_map`` of the reference's op."""
    _, method, kw, _ = OP_BY_ID[op_id]
    x = _parts()
    out_shape = _reference_outputs(axis)[op_id][0].shape
    w = np.random.default_rng(1).standard_normal(
        (8, *out_shape)).astype(np.float32)

    def loss(xg):
        out = _shard_mapped(lambda b: getattr(ref_col.mesh_collectives,
                                              method)(b, axis, **kw(_n(axis))))(xg)
        return (out * jnp.asarray(w.reshape(-1, *out_shape[1:]))).sum()

    want = _per_device(jax.jit(jax.grad(loss))(
        jnp.asarray(x.reshape(8 * BLOCK[0], BLOCK[1]))))
    parts = [torch.from_numpy(p).requires_grad_() for p in x]
    outs = _port_call(op_id, axis, parts)
    sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(outs, w)).backward()
    for p, g in zip(parts, want):
        _close(p.grad.numpy(), g, GRAD_TOL)


def test_mesh_collectives_refuse_what_lax_refuses():
    parts = [torch.zeros(BLOCK) for _ in range(8)]
    mesh = _port_mesh()
    with pytest.raises(ValueError, match="unsupported op"):
        col.mesh_collectives.allreduce(parts, mesh, "dp", op="prod")
    with pytest.raises(ValueError, match="parts for a mesh"):
        col.mesh_collectives.allreduce(parts[:4], mesh, "dp")
    with pytest.raises(ValueError, match="repeats"):
        col.mesh_collectives.permute(parts, mesh, "dp", [(0, 1), (1, 1)])
    with pytest.raises(ValueError, match="out of range"):
        col.mesh_collectives.permute(parts, mesh, "dp", [(0, 2)])


# ------------------------------------------- the host group on the port

@pytest.fixture(scope="module")
def port_runtime():
    """One port runtime with the reference fixture's 4 CPUs."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=64 << 20)
    yield
    ray_tpu_torch.shutdown()


def _reference_case(name):
    """The reference test's source with the package renamed, as a module
    of its own: what the case defines is shipped to the workers by
    value."""
    path = ROOT / "tests" / "test_util.py"
    mod = types.ModuleType(f"ported_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(_renamed(path.read_text()), str(path), "exec"), mod.__dict__)
    fn = getattr(mod, name)
    assert list(inspect.signature(fn).parameters) == ["ray_start_regular"]
    return fn


@pytest.mark.timeout(120)
def test_reference_collective_group_host_on_the_port(port_runtime):
    _reference_case("test_collective_group_host")(None)


def _state_actor_gone(name, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get_actor(f"_collective:{name}")
        except ValueError:
            return True
        time.sleep(0.05)
    return False


@pytest.mark.timeout(120)
def test_group_takes_torch_tensors_and_refuses_bfloat16(port_runtime):
    """A CPU tensor goes in as numpy and the results are numpy; a bfloat16
    tensor raises before it reaches the group (the next op still runs);
    ``destroy_collective_group`` removes the state actor."""
    g = col.init_collective_group(1, 0, group_name="torch_inputs")
    try:
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        out = g.allreduce(x.requires_grad_())
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, x.detach().numpy())
        gathered = g.allgather(torch.tensor([7], dtype=torch.int64))
        assert [a.tolist() for a in gathered] == [[7]]
        assert gathered[0].dtype == np.int64
        with pytest.raises(TypeError, match="bfloat16"):
            g.broadcast(torch.ones(2, dtype=torch.bfloat16))
        np.testing.assert_array_equal(
            g.reducescatter(torch.ones(4), op="max"), np.ones(4))
        g.send(torch.tensor([3.0]), dst_rank=0)
        np.testing.assert_array_equal(g.recv(src_rank=0), [3.0])
    finally:
        col.destroy_collective_group("torch_inputs")
    assert _state_actor_gone("torch_inputs")
    with pytest.raises(KeyError):
        col.get_group("torch_inputs")
