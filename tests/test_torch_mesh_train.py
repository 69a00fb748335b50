"""The port's mesh train step against the JAX package's, on the same inputs.

JAX runs its mesh step (``parallel/train_step.py``) on the 8 virtual CPU
devices of tests/conftest.py; the port builds the same mesh over eight
``"cpu"`` devices (one device holding every shard, the port's counterpart
of the virtual mesh) and steps from the same numpy state and batches.
Three float32 tiny configs: the dense ``tiny()`` and the biased one of
tests/test_torch_tp.py (LayerNorm, GELU MLP, learned positions; its biases
and norm scales drawn at random, so a bias added on every tp shard shows)
at ``dp=2, fsdp=2, tp=2``, and ``tiny(experts=4)`` at ``dp=2, fsdp=2,
ep=2``.

Tolerances: the loss, the aux loss and the gradient norm within 1e-4
relative of JAX's and 1e-5 of the port's one-device step at every step;
the adam moments within 1e-4 (1e-5) of the largest moment of the tree
(the f32 gradients of two programs sum in other orders); the params within
1e-4 (1e-5) absolutely.  A leaf whose true gradient is 0 (``bk``: softmax
does not see a shift of every key's score) holds only rounding noise, and
Adam's m / sqrt(v) turns that noise into steps of up to the learning rate
in any program, so such a leaf (moments below 1e-6 of the tree's largest)
is held to the most Adam can move it, the learning rate times the steps.
Shard leaves must equal JAX's ``addressable_shards`` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import sharding as jshard
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import sharding as tshard
from ray_tpu_torch.models.convert import (sharded_state_from_numpy,
                                          train_state_from_numpy)
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts

CONFIGS = {
    "dense": jcfg.tiny(),
    "biased": dataclasses.replace(jcfg.tiny(), use_rmsnorm=False,
                                  use_swiglu=False, use_rope=False),
    "moe": jcfg.tiny(experts=4),
}
MESHES = {"dense": dict(dp=2, fsdp=2, tp=2), "biased": dict(dp=2, fsdp=2, tp=2),
          "moe": dict(dp=2, fsdp=2, ep=2)}
OPT = dict(learning_rate=3e-4, warmup_steps=1, total_steps=8, grad_clip=6.5)
STEPS, BATCH, SEQ = 4, 8, 32
JAX_TOL, SELF_TOL = 1e-4, 1e-5
# the learning rate moves each leaf by more than MOVED x JAX_TOL over the
# steps; a larger one (1e-3) spreads the f32 sums of two programs past
# SELF_TOL by the fourth step
MOVED = 3
# (config, remat, loss mask): each mesh under the three remat policies,
# the mask on each config
CASES = [("dense", False, True), ("dense", "full", False),
         ("dense", "save_acts", False), ("biased", "full", True),
         ("moe", False, False), ("moe", "full", True),
         ("moe", "save_acts", False)]


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _tcfg(cfg):
    return tcfg.TransformerConfig(**dataclasses.asdict(cfg))


def _params_np(cfg):
    """JAX's init as numpy, biases and norm scales drawn at random."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0),
                                                    cfg))

    def draw(path, leaf):
        key = path[-1].key
        if key in ("bq", "bk", "bv", "bo", "b_in", "b_out", "bias"):
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        if key == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, tree)


def _batches(vocab, mask):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, vocab, (BATCH, SEQ + 1))
             .astype(np.int32)}
        if mask:
            b["loss_mask"] = (rng.random((BATCH, SEQ)) < 0.7).astype(
                np.float32)
        out.append(b)
    return out


def _jax_state(cfg, mesh, opt, params_np):
    params = jax.tree.map(jnp.asarray, params_np)
    state = jts.TrainState(params=params, opt_state=opt.init(params),
                           step=jnp.zeros((), jnp.int32))
    sh = jts.state_shardings(cfg, mesh, opt, state)
    return jax.device_put(state, sh), sh


def _adam(state):
    adam = state.opt_state[1][0]
    return (jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu), np.asarray(adam.count))


def _port_state(tc, mesh, jstate):
    mu, nu, count = _adam(jstate)
    return sharded_state_from_numpy(
        jax.tree.map(np.asarray, jstate.params), mu, nu, count,
        np.asarray(jstate.step), tts.state_shardings(tc, mesh))


def _meshes(name):
    spec = MESHES[name]
    return (jmesh.MeshSpec(**spec).build(jax.devices()),
            tmesh.MeshSpec(**spec).build(["cpu"] * 8))


def _whole(leaf):
    return leaf.full() if isinstance(leaf, tmesh.Sharded) else leaf.detach()


def _noise(mu):
    """The leaves whose true gradient is 0: mu below 1e-6 of the tree's
    largest (module docstring)."""
    mu = {path: np.abs(np.asarray(v)).max() for path, v in _paths(mu)}
    scale = max(mu.values())
    return {path for path, m in mu.items() if m < 1e-6 * scale}


def _assert_trees_close(got, want, tol, what):
    """Moments within ``tol`` of the tree's largest magnitude; params
    within ``tol`` absolutely, a leaf of noise within the most Adam moves
    it (module docstring)."""
    noise = _noise(want["mu"])
    for name in ("mu", "nu"):
        g = dict(_paths(got.opt_state[name]))
        w = dict(_paths(want[name]))
        scale = max(float(np.abs(np.asarray(v)).max()) for v in w.values())
        for path, leaf in g.items():
            ref = np.asarray(w[path])
            np.testing.assert_allclose(_whole(leaf).numpy(), ref, rtol=0,
                                       atol=tol * scale,
                                       err_msg=f"{what} {name} {path}")
    w = dict(_paths(want["params"]))
    for path, leaf in _paths(got.params):
        atol = OPT["learning_rate"] * STEPS if path in noise else tol
        np.testing.assert_allclose(_whole(leaf).numpy(), np.asarray(w[path]),
                                   rtol=0, atol=atol,
                                   err_msg=f"{what} params {path}")


# ---------------------------------------------------------------------------
# The rules and the placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_specs_and_shardings_equal_the_reference(name):
    cfg = CONFIGS[name]
    jspecs = dict(_paths(jshard.logical_param_specs(cfg)))
    tspecs = dict(_paths(tshard.logical_param_specs(_tcfg(cfg))))
    assert jspecs.keys() == tspecs.keys()
    for path, spec in jspecs.items():
        assert tuple(tspecs[path]) == tuple(spec), path
    assert tuple(tshard.batch_spec()) == tuple(jshard.batch_spec())
    assert tshard.BATCH_AXES == jshard.BATCH_AXES
    jm, tm = _meshes(name)
    jsh = jmesh.named_sharding(jm, jshard.logical_param_specs(cfg))
    tsh = dict(_paths(tmesh.named_sharding(
        tm, tshard.logical_param_specs(_tcfg(cfg)))))
    for path, s in jax.tree_util.tree_flatten_with_path(jsh)[0]:
        key = ".".join(p.key for p in path)
        assert tuple(tsh[key].spec) == tuple(s.spec), key


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_shard_leaves_equal_jax_addressable_shards(name):
    """After one JAX step (nonzero moments), the port's state converted
    from it holds in part i exactly JAX's ``addressable_shards[i]``, for
    params, mu and nu, on the mesh's device i."""
    cfg, tc = CONFIGS[name], _tcfg(CONFIGS[name])
    jm, tm = _meshes(name)
    jopt = jts.make_optimizer(**OPT)
    jstate, sh = _jax_state(cfg, jm, jopt, _params_np(cfg))
    jstate, _ = jts.make_train_step(cfg, jm, jopt, sh,
                                    compute_dtype=jnp.float32)(
        jstate, _batches(cfg.vocab_size, False)[0])
    tstate = _port_state(tc, tm, jstate)
    adam = jstate.opt_state[1][0]
    for jtree, ttree in ((jstate.params, tstate.params),
                         (adam.mu, tstate.opt_state["mu"]),
                         (adam.nu, tstate.opt_state["nu"])):
        got = dict(_paths(ttree))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            t = got[".".join(p.key for p in path)]
            assert len(t.parts) == len(leaf.addressable_shards) == 8
            for i, shard in enumerate(leaf.addressable_shards):
                assert shard.device == jm.devices.flat[i]
                part = t.parts[i]
                assert part.is_contiguous() and part.device == tm.device_list[i]
                np.testing.assert_array_equal(part.detach().numpy(),
                                              np.asarray(shard.data))
    assert all(int(p) == 1 for p in tstate.step.parts)
    assert all(int(p) == 1 for p in tstate.opt_state["count"].parts)


def test_init_on_a_mesh_equals_the_one_device_init():
    """``init_sharded_state(mesh, seed)`` draws what ``mesh=None`` draws,
    each leaf cut as its sharding says; the moments start at 0."""
    tc = _tcfg(CONFIGS["moe"])
    opt = tts.make_optimizer(**OPT)
    one, none = tts.init_sharded_state(tc, None, opt, seed=3, device="cpu")
    _, tm = _meshes("moe")
    mesh, sh = tts.init_sharded_state(tc, tm, opt, seed=3)
    assert none is None and sh.params.keys() == mesh.params.keys()
    want = dict(_paths(one.params))
    for path, leaf in _paths(mesh.params):
        assert all(p.requires_grad for p in leaf.parts)
        assert torch.equal(leaf.full(), want[path].detach()), path
        for i, (p, sl) in enumerate(zip(leaf.parts,
                                        leaf.sharding.slices(leaf.shape))):
            assert torch.equal(p.detach(), want[path].detach()[sl])
    for leaf in tts._leaves(mesh.opt_state["mu"]):
        assert all(not p.any() for p in leaf.parts)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,remat,mask", CASES)
def test_mesh_steps_match_jax_and_the_one_device_step(name, remat, mask):
    cfg, tc = CONFIGS[name], _tcfg(CONFIGS[name])
    jm, tm = _meshes(name)
    jopt, topt = jts.make_optimizer(**OPT), tts.make_optimizer(**OPT)
    params = _params_np(cfg)
    jstate, sh = _jax_state(cfg, jm, jopt, params)
    tstate = _port_state(tc, tm, jstate)
    mu, nu, count = _adam(jstate)
    one = train_state_from_numpy(params, mu, nu, count, 0, "cpu")
    jstep = jts.make_train_step(cfg, jm, jopt, sh, compute_dtype=jnp.float32,
                                remat=remat)
    tstep = tts.make_train_step(tc, tm, topt, tts.state_shardings(tc, tm),
                                compute_dtype=torch.float32, remat=remat)
    ostep = tts.make_train_step(tc, None, topt, None,
                                compute_dtype=torch.float32, remat=remat,
                                device="cpu")
    for batch in _batches(cfg.vocab_size, mask):
        jstate, jm_ = jstep(jstate, batch)
        got, tm_ = tstep(tstate, batch)
        assert got is tstate
        one, om = ostep(one, batch)
        for key in ("loss", "moe_aux_loss", "grad_norm", "total_loss"):
            want = float(jm_[key])
            assert float(tm_[key]) == pytest.approx(want, rel=JAX_TOL,
                                                    abs=1e-7), key
            assert float(tm_[key]) == pytest.approx(float(om[key]),
                                                    rel=SELF_TOL,
                                                    abs=1e-7), key
        assert float(tm_["tokens"]) == float(jm_["tokens"])
        assert tm_["loss"].device == tm.device_list[0]
    if name == "moe":
        assert float(tm_["moe_aux_loss"]) > 0
    mu, nu, _ = _adam(jstate)
    # every leaf but noise moved well past the params' limit, so a skipped
    # or wrong update fails the comparisons below
    start, noise = dict(_paths(params)), _noise(mu)
    for path, leaf in _paths(tstate.params):
        moved = np.abs(_whole(leaf).numpy() - start[path]).max()
        assert path in noise or moved > MOVED * JAX_TOL, (path, moved)
    _assert_trees_close(tstate, {"params": jax.tree.map(
        np.asarray, jstate.params), "mu": mu, "nu": nu}, JAX_TOL, "jax")
    _assert_trees_close(tstate, {"params": jax.tree.map(
        lambda t: t.detach().numpy(), one.params),
        "mu": jax.tree.map(lambda t: t.numpy(), one.opt_state["mu"]),
        "nu": jax.tree.map(lambda t: t.numpy(), one.opt_state["nu"])},
        SELF_TOL, "mesh=None")
    # every copy of a block holds the same bits
    for tree in (tstate.params, tstate.opt_state["mu"],
                 tstate.opt_state["nu"]):
        for path, leaf in _paths(tree):
            for g in leaf.sharding.replica_groups():
                for j in g[1:]:
                    assert torch.equal(leaf.parts[j], leaf.parts[g[0]]), path
    assert all(int(p) == STEPS for p in tstate.step.parts)


def test_biases_replicated_over_tp_are_added_once():
    """With ``bo`` and ``b_out`` large, a bias added on both tp shards would
    move the loss by far more than 1e-5: the mesh's loss equals the
    one-device loss."""
    cfg = _tcfg(CONFIGS["biased"])
    params = _params_np(CONFIGS["biased"])
    for key in ("attn", "mlp"):
        b = "bo" if key == "attn" else "b_out"
        params["blocks"][key][b] = params["blocks"][key][b] * 8
    _, tm = _meshes("biased")
    batch = _batches(cfg.vocab_size, False)[0]
    zeros = jax.tree.map(np.zeros_like, params)
    state = sharded_state_from_numpy(params, zeros, zeros, 0, 0,
                                     tts.state_shardings(cfg, tm))
    one = train_state_from_numpy(params, zeros, zeros, 0, 0, "cpu")
    m = tts.make_eval_step(cfg, tm, None, torch.float32)(state.params, batch)
    o = tts.make_eval_step(cfg, None, None, torch.float32, device="cpu")(
        one.params, batch)
    assert float(m["loss"]) == pytest.approx(float(o["loss"]), rel=SELF_TOL)


def test_eval_step_matches_jax_on_a_mesh():
    cfg, tc = CONFIGS["moe"], _tcfg(CONFIGS["moe"])
    jm, tm = _meshes("moe")
    jopt = jts.make_optimizer(**OPT)
    jstate, sh = _jax_state(cfg, jm, jopt, _params_np(cfg))
    tstate = _port_state(tc, tm, jstate)
    batch = {"tokens": _batches(cfg.vocab_size, False)[0]["tokens"]}
    jmet = jts.make_eval_step(cfg, jm, sh, compute_dtype=jnp.float32)(
        jstate.params, batch)
    tmet = tts.make_eval_step(tc, tm, None, torch.float32)(tstate.params,
                                                          batch)
    for key in ("loss", "moe_aux_loss"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]),
                                                 rel=JAX_TOL), key
    assert float(tmet["tokens"]) == float(jmet["tokens"])


def test_moe_routes_once_over_the_whole_batch(monkeypatch):
    """Each MoE layer routes once per call, every row block's tokens in one
    batch with the global capacity (the reference's semantics)."""
    tc = _tcfg(CONFIGS["moe"])
    _, tm = _meshes("moe")
    opt = tts.make_optimizer(**OPT)
    state, sh = tts.init_sharded_state(tc, tm, opt, seed=0)
    calls = []
    real = tmoe.route

    def route(logits, k, cap):
        calls.append((logits.shape, cap))
        return real(logits, k, cap)

    monkeypatch.setattr(tmoe, "route", route)
    tts.make_eval_step(tc, tm, sh, torch.float32)(
        state.params, _batches(tc.vocab_size, False)[0])
    t = BATCH * SEQ
    cap = tmoe.capacity(tc.expert_capacity_factor, tc.experts_per_token,
                        BATCH, SEQ, tc.num_experts)
    assert calls == [((t, tc.num_experts), cap)] * tc.num_layers


def test_one_device_mesh_steps_as_mesh_none():
    """``MeshSpec(fsdp=-1)`` over one device (bench.py's mesh on one card)
    takes the one-device step's values."""
    tc = _tcfg(CONFIGS["dense"])
    opt = tts.make_optimizer(**OPT)
    mesh = tmesh.MeshSpec(fsdp=-1).build(["cpu"])
    a, sh = tts.init_sharded_state(tc, mesh, opt, seed=1)
    b, _ = tts.init_sharded_state(tc, None, opt, seed=1, device="cpu")
    sa = tts.make_train_step(tc, mesh, opt, sh, compute_dtype=torch.float32)
    sb = tts.make_train_step(tc, None, opt, None, compute_dtype=torch.float32,
                             device="cpu")
    for batch in _batches(tc.vocab_size, False)[:2]:
        a, ma = sa(a, batch)
        b, mb = sb(b, batch)
        assert float(ma["loss"]) == pytest.approx(float(mb["loss"]),
                                                  rel=SELF_TOL)
    for path, leaf in _paths(b.params):
        got = dict(_paths(a.params))[path].full()
        torch.testing.assert_close(got, leaf.detach(), rtol=0, atol=SELF_TOL)


def test_mesh_refusals():
    tc = _tcfg(CONFIGS["dense"])
    opt = tts.make_optimizer(**OPT)

    def mesh(n, **spec):
        return tmesh.MeshSpec(**spec).build(["cpu"] * n)

    # an axis that does not divide the dimension it cuts (hidden 64)
    with pytest.raises(ValueError, match="do not divide"):
        tts.init_sharded_state(tc, mesh(3, fsdp=3), opt)
    # tp must divide the heads (4 q heads, 2 kv heads)
    with pytest.raises(ValueError, match="tp=4"):
        tts.make_train_step(tc, mesh(4, fsdp=1, tp=4), opt, None)
    # dp x fsdp must divide the batch
    ok = mesh(4, dp=2, fsdp=2)
    state, sh = tts.init_sharded_state(tc, ok, opt)
    step = tts.make_train_step(tc, ok, opt, sh, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="batch"):
        step(state, {"tokens": np.zeros((6, 9), np.int32)})
    # sp and pp meshes run (tests/test_torch_ring_attention.py,
    # tests/test_torch_pipeline.py): the eval step on sp=2 and the train
    # step on pp=2 (a replica on each pp index) give mesh=None's loss
    one, _ = tts.init_sharded_state(tc, None, opt, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tc.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want = float(tts.make_eval_step(tc, None, None, torch.float32,
                                    device="cpu")(one.params, batch)["loss"])
    states = {}
    for spec in (dict(sp=2, fsdp=1), dict(pp=2, fsdp=1)):
        st, shd = states[tuple(spec)] = tts.init_sharded_state(
            tc, mesh(2, **spec), opt)
        got = tts.make_eval_step(tc, mesh(2, **spec), shd, torch.float32,
                                 sp_axis="sp")(st.params, batch)
        assert float(got["loss"]) == pytest.approx(want, rel=SELF_TOL)
        step = tts.make_train_step(tc, mesh(2, **spec), opt, shd,
                                   compute_dtype=torch.float32,
                                   sp_axis="sp")
        st, m = step(st, batch)
        assert float(m["loss"]) == pytest.approx(want, rel=SELF_TOL)
        for leaf in tts._leaves(st.params):     # replicas stay equal
            for g in leaf.sharding.replica_groups():
                assert all(torch.equal(leaf.parts[g[0]], leaf.parts[j])
                           for j in g)
    with pytest.raises(ValueError, match="sp = 2 does not divide"):
        tts.make_eval_step(tc, mesh(2, sp=2, fsdp=1), None)(
            states[("sp", "fsdp")][0].params,
            {"tokens": toks[:, :-2], "targets": toks[:, 1:-1]})
    # the dp-manual step is ported (tests/test_torch_zero.py): it shards
    # over dp only, and this mesh has fsdp=2
    for kw in (dict(zero_sharded_update=True), dict(grad_quant_enabled=True)):
        with pytest.raises(ValueError, match="dp axis only"):
            tts.make_train_step(tc, ok, opt, sh, **kw)
    # sp_axis names an axis of size 1 here: the step is the same
    sp_step = tts.make_train_step(tc, ok, opt, sh, sp_axis="sp",
                                  compute_dtype=torch.float32)
    assert np.isfinite(float(sp_step(state, batch)[1]["loss"]))
    # the mesh names its devices; a device beside it is refused
    with pytest.raises(ValueError, match="device must be None"):
        tts.make_train_step(tc, ok, opt, sh, device="cpu")
    # devices=None: every CUDA card, and there are none here
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        tmesh.MeshSpec(fsdp=2).build()


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def test_collectives_and_their_backward():
    """all_gather, reduce_scatter and all_reduce: values, tensors of their
    own, and each backward the other collective in part order."""
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
             .requires_grad_() for _ in range(3)]
    outs = tmesh.all_gather(parts, 0)
    full = torch.cat([p.detach() for p in parts])
    assert all(torch.equal(o, full) for o in outs)
    assert len({o.data_ptr() for o in outs}) == 3
    gs = [torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
          for _ in range(3)]
    got = torch.autograd.grad(outs, parts, gs)
    want = ((gs[0] + gs[1]) + gs[2]).split(2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    wide = [torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
            .requires_grad_() for _ in range(3)]
    outs = tmesh.reduce_scatter(wide, 0)
    total = (wide[0] + wide[1]) + wide[2]
    assert all(torch.equal(o, b) for o, b in zip(outs, total.detach().split(2)))
    g = [torch.full((2, 3), float(i)) for i in range(3)]
    got = torch.autograd.grad(outs, wide, g)
    assert all(torch.equal(x, torch.cat(g)) for x in got)

    outs = tmesh.all_reduce(parts)
    got = torch.autograd.grad(outs, parts, g)
    assert all(torch.equal(x, (g[0] + g[1]) + g[2]) for x in got)
    # a gather onto a subset: the others' blocks get their slice back
    one = tmesh.all_gather(parts, 1, [torch.device("cpu")])
    assert len(one) == 1 and one[0].shape == (2, 9)
    got = torch.autograd.grad(one, parts, [torch.ones(2, 9)])
    assert all(torch.equal(x, torch.ones(2, 3)) for x in got)


def test_scatter_sum_adds_each_block_in_part_order():
    """Block i summed on its own device from every part's block i: the
    bits of the whole sum in part order, along any dim and for blocks of
    any size; a None part adds nothing, and a lone part is copied."""
    rng = np.random.default_rng(6)
    parts = [torch.from_numpy(rng.standard_normal((3, 7)).astype(np.float32))
             for _ in range(3)]
    sizes, devs = [2, 5], [torch.device("cpu")] * 2
    got = tmesh.scatter_sum([parts[0], None, parts[1], parts[2]], 1, sizes,
                            devs)
    want = ((parts[0] + parts[1]) + parts[2]).split(sizes, 1)
    assert all(torch.equal(a, b) and a.is_contiguous()
               for a, b in zip(got, want))
    lone = tmesh.scatter_sum([None, parts[0]], 0, [1, 2], devs)
    assert all(torch.equal(a, b) for a, b in zip(lone, parts[0].split([1, 2])))
    assert lone[0].data_ptr() != parts[0].data_ptr()
    assert tmesh.scatter_sum([None, None], 0, [1, 2], devs) == [None, None]


def test_axis_groups_and_slices_follow_the_mesh_order():
    mesh = tmesh.MeshSpec(dp=2, fsdp=2, tp=2).build(["cpu"] * 8)
    assert tmesh.axis_groups(mesh, ("tp",)) == [[0, 1], [2, 3], [4, 5],
                                               [6, 7]]
    assert tmesh.axis_groups(mesh, ("dp", "fsdp")) == [[0, 2, 4, 6],
                                                      [1, 3, 5, 7]]
    sh = tmesh.NamedSharding(mesh, tmesh.PartitionSpec(None, "fsdp", "tp"))
    x = torch.arange(2 * 4 * 6.0).reshape(2, 4, 6)
    s = tmesh.split(x, sh)
    assert s.shape == (2, 4, 6) and torch.equal(s.full(), x)
    assert torch.equal(s.parts[3], x[:, 2:4, 3:6])
    assert torch.equal(s.parts[7], s.parts[3])          # a dp replica
    assert sh.replica_groups() == [[0, 4], [1, 5], [2, 6], [3, 7]]
