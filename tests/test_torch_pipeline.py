"""The port's pipeline (``parallel/pipeline.py``) against the JAX package's,
on the same numpy inputs.

JAX runs on the virtual CPU devices of tests/conftest.py, the port on
``["cpu"] * n``, at the reference's tiny size (tests/test_pipeline.py:
4 layers, hidden 32, 4 heads, seq 32), in f32.  Partition and merge bit
for bit; the GPipe loss on pp=2 with dp=2, sp=2 and fsdp=2 and the
interleaved loss (M=4, V=2) within 1e-4 of JAX's; the pipeline's
gradients within 1e-4 of the port's own unpipelined ``mesh=None``
gradients (tests/test_torch_train_step.py holds those to JAX's); three
``make_pp_train_step`` steps from ``pp_state_from_numpy`` against JAX's.
JAX's losses and steps are computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpp
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import (params_from_numpy,
                                          pp_state_from_numpy)
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpp
from ray_tpu_torch.parallel import train_step as tts

TOL = 1e-4
JCFG = jcfg.tiny(vocab=128, layers=4, hidden=32, heads=4, seq=32)
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20)
# (mesh, microbatches, virtual stages)
LOSS_CASES = {
    "gpipe_pp2_dp2": (dict(pp=2, dp=2), 2, 1),
    "gpipe_pp2_sp2": (dict(pp=2, sp=2), 2, 1),
    "gpipe_pp2_fsdp2": (dict(pp=2, fsdp=2), 2, 1),
    "interleaved_pp2_dp2": (dict(pp=2, dp=2), 4, 2),
}
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: under the suite's parallel
    workers torch's threads oversubscribe the cores.  No tolerance here
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tc(cfg=JCFG):
    return tcfg.TransformerConfig(**dataclasses.asdict(cfg))


def _meshes(spec):
    n = int(np.prod(list(spec.values())))
    full = {"fsdp": 1, **spec}
    return (jmesh.MeshSpec(**full).build(jax.devices()[:n]),
            tmesh.MeshSpec(**full).build(["cpu"] * n))


def _params_np(cfg=JCFG):
    return jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0),
                                                    cfg))


def _batch(seed=1, rows=8):
    toks = np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (rows, JCFG.max_seq_len + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _zeros_like(tree):
    return jax.tree.map(np.zeros_like, tree)


def _port_params(cfg, tm, params_np, v):
    """The port's staged params from JAX's unstaged numpy params."""
    state, _ = pp_state_from_numpy(
        cfg, tm, {"params": params_np, "mu": _zeros_like(params_np),
                  "nu": _zeros_like(params_np), "count": 0, "step": 0},
        virtual_stages=v)
    return state.params


def _jax_loss_fn(cfg, jm, m, v):
    if v == 1:
        return jpp.pipeline_loss_fn(cfg, jm, m, compute_dtype=jnp.float32,
                                    loss_chunk=None)
    return jpp.interleaved_pipeline_loss_fn(cfg, jm, m, v,
                                            compute_dtype=jnp.float32,
                                            loss_chunk=None)


def _port_loss_fn(cfg, tm, m, v):
    if v == 1:
        return tpp.pipeline_loss_fn(cfg, tm, m, compute_dtype=torch.float32,
                                    loss_chunk=None)
    return tpp.interleaved_pipeline_loss_fn(cfg, tm, m, v,
                                            compute_dtype=torch.float32,
                                            loss_chunk=None)


@pytest.fixture(scope="module")
def jax_losses():
    params, batch = _params_np(), _batch()
    out = {}
    for name, (spec, m, v) in LOSS_CASES.items():
        jm, _ = _meshes(spec)
        staged = jpp.partition_layers(jax.tree.map(jnp.asarray, params), 2, v)
        _, metrics = jax.jit(_jax_loss_fn(JCFG, jm, m, v))(staged, batch)
        out[name] = float(metrics["loss"])
    return out


# ---------------------------------------------------------------------------
# Partition and merge, the state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v", [1, 2])
def test_partition_and_merge_equal_jax_bit_for_bit(v):
    params = _params_np()
    want = jax.tree.map(np.asarray, jpp.partition_layers(
        jax.tree.map(jnp.asarray, params), 2, v))
    got = tpp.partition_layers(params_from_numpy(params, "cpu"), 2, v)
    w = dict(_paths(want))
    for path, leaf in _paths(got):
        np.testing.assert_array_equal(leaf.numpy(), w[path], err_msg=path)
    back = dict(_paths(tpp.merge_layers(got, v)))
    for path, leaf in _paths(params):
        np.testing.assert_array_equal(back[path].numpy(), leaf)
    # the specs: the reference's, entry for entry
    for auto in ((), ("tp", "fsdp")):
        js = dict(_paths(jpp.pipeline_param_specs(JCFG, auto)))
        for path, spec in _paths(tpp.pipeline_param_specs(_tc(), auto)):
            assert tuple(spec) == tuple(js[path]), path


def test_init_pp_state_is_the_port_init_partitioned():
    cfg = _tc()
    _, tm = _meshes(dict(pp=2, fsdp=2))
    opt = tts.make_optimizer(**OPT)
    one, _ = tts.init_sharded_state(cfg, None, opt, seed=3, device="cpu")
    state, sh = tpp.init_pp_state(cfg, tm, opt, seed=3, virtual_stages=2)
    want = dict(_paths(tpp.partition_layers(
        {k: v for k, v in one.params.items()}, 2, 2)))
    for path, leaf in _paths(state.params):
        assert leaf.sharding == dict(_paths(sh.params))[path]
        assert all(p.requires_grad for p in leaf.parts)
        assert torch.equal(leaf.full(), want[path].detach()), path
    assert tuple(dict(_paths(sh.params))["blocks.attn.wq"].spec) == (
        "pp", None, "fsdp", None)
    assert all(not p.any() for leaf in tts._leaves(state.opt_state["mu"])
               for p in leaf.parts)


# ---------------------------------------------------------------------------
# The losses and the gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_pipeline_loss_matches_jax(name, jax_losses):
    spec, m, v = LOSS_CASES[name]
    cfg = _tc()
    _, tm = _meshes(spec)
    params = _port_params(cfg, tm, _params_np(), v)
    total, metrics = _port_loss_fn(cfg, tm, m, v)(params, _batch())
    assert float(metrics["loss"].detach()) == pytest.approx(
        jax_losses[name], rel=TOL)
    assert float(metrics["moe_aux_loss"].detach()) == 0.0
    assert float(total.detach()) == float(metrics["loss"].detach())
    assert int(metrics["tokens"]) == _batch()["targets"].size


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_pipeline_gradients_match_the_unpipelined_step(name):
    spec, m, v = LOSS_CASES[name]
    cfg = _tc()
    _, tm = _meshes(spec)
    params_np, batch = _params_np(), _batch()
    one = params_from_numpy(params_np, "cpu")
    leaves = tts._leaves(one)
    for leaf in leaves:
        leaf.requires_grad_(True)
    ref, _ = ttr.causal_lm_loss(one, {k: torch.from_numpy(x) for k, x in
                                      batch.items()}, cfg,
                                compute_dtype=torch.float32, loss_chunk=None)
    want = dict(zip([p for p, _ in sorted(tts._flat_paths(one).items())],
                    torch.autograd.grad(ref, leaves)))
    params = _port_params(cfg, tm, params_np, v)
    total, _ = _port_loss_fn(cfg, tm, m, v)(params, batch)
    staged = tts._leaves(params)
    got = torch.autograd.grad(total, [p for leaf in staged
                                      for p in leaf.parts],
                              allow_unused=True)
    grads, _ = tts._sum_copies(staged, got, tm.device_list[0])
    paths = sorted(tts._flat_paths(params))
    whole = {path: tmesh.Sharded(g, leaf.sharding).full()
             for path, g, leaf in zip(paths, grads, staged)}

    def tree(t, prefix=""):
        return {k: tree(x, f"{prefix}{k}.") if isinstance(x, dict)
                else whole[prefix + k] for k, x in t.items()}
    merged = dict(_paths(tpp.merge_layers(tree(params), v)))
    for path, g in want.items():
        torch.testing.assert_close(merged[path], g, rtol=0, atol=TOL,
                                   msg=path)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,m", [(1, 2), (2, 4)])
def test_pp_train_steps_match_jax(v, m):
    """Three steps of ``make_pp_train_step`` on pp=2, dp=2 from JAX's
    ``init_pp_state`` carried over by ``pp_state_from_numpy``: loss and
    grad norm per step, params and moments at the end."""
    jm, tm = _meshes(dict(pp=2, dp=2))
    jopt = jts.make_optimizer(**OPT)
    jstate, jsh = jpp.init_pp_state(JCFG, jm, jopt, virtual_stages=v)
    adam = jstate.opt_state[1][0]
    numpy_state = jax.tree.map(np.asarray, {
        "params": jstate.params, "mu": adam.mu, "nu": adam.nu,
        "count": adam.count, "step": jstate.step})
    cfg = _tc()
    state, sh = pp_state_from_numpy(cfg, tm, numpy_state, virtual_stages=v)
    for path, leaf in _paths(state.params):
        np.testing.assert_array_equal(
            leaf.full().numpy(), dict(_paths(numpy_state["params"]))[path])
    jstep = jpp.make_pp_train_step(JCFG, jm, jopt, jsh, num_microbatches=m,
                                   compute_dtype=jnp.float32,
                                   loss_chunk=None, virtual_stages=v)
    tstep = tpp.make_pp_train_step(cfg, tm, tts.make_optimizer(**OPT), sh,
                                   num_microbatches=m,
                                   compute_dtype=torch.float32,
                                   loss_chunk=None, virtual_stages=v)
    for i in range(STEPS):
        batch = _batch(seed=10 + i)
        jstate, jmet = jstep(jstate, batch)
        state, met = tstep(state, batch)
        for key in ("loss", "grad_norm", "total_loss"):
            assert float(met[key]) == pytest.approx(float(jmet[key]),
                                                    rel=TOL), key
    adam = jstate.opt_state[1][0]
    for tree, want in ((state.params, jstate.params),
                       (state.opt_state["mu"], adam.mu),
                       (state.opt_state["nu"], adam.nu)):
        w = {path: np.asarray(x) for path, x in _paths(want)}
        scale = max(1.0, max(float(np.abs(x).max()) for x in w.values()))
        for path, leaf in _paths(tree):
            np.testing.assert_allclose(leaf.full().numpy(), w[path], rtol=0,
                                       atol=TOL * scale, err_msg=path)
    assert all(int(p) == STEPS for p in state.step.parts)


def test_pipeline_errors_mirror_the_reference():
    _, tm = _meshes(dict(pp=2, sp=2))
    learned = dataclasses.replace(_tc(), use_rope=False)
    with pytest.raises(ValueError, match="RoPE"):
        tpp.pipeline_loss_fn(learned, tm, 2)
    with pytest.raises(ValueError, match="RoPE"):
        tpp.interleaved_pipeline_loss_fn(learned, tm, 2, 2)
    _, tm = _meshes(dict(pp=2, dp=2))
    with pytest.raises(AssertionError, match="multiple of pp=2"):
        tpp.interleaved_pipeline_loss_fn(_tc(), tm, 3, 2)
    # a batch that does not cut into dp x microbatches
    fn = tpp.pipeline_loss_fn(_tc(), tm, 4, compute_dtype=torch.float32)
    params = _port_params(_tc(), tm, _params_np(), 1)
    with pytest.raises(ValueError, match="microbatches"):
        fn(params, _batch(rows=6))
    # a state not staged as the step's shardings say
    state, _ = tts.init_sharded_state(_tc(), tm, tts.make_optimizer())
    step = tpp.make_pp_train_step(_tc(), tm, tts.make_optimizer(), None,
                                  num_microbatches=2)
    with pytest.raises(ValueError, match="not sharded as"):
        step(state, _batch())
