"""The port's loss, gradients and train step against the JAX package's, on
the same inputs.

Params come from the JAX package's init (plus numpy noise, so biases and
norm scales are not at their trivial values), batches from numpy; both
packages compute in float32.  The JAX flash kernels run in Pallas interpret
mode on the CPU, as tests/test_ops.py runs them; the port's flash wrapper
runs its plain versions there (CPU tensors).  Tolerances: 1e-5 relative on
the loss and 1e-4 of each leaf's largest gradient magnitude (f32 sums in
another order through two layers, the LM head and the softmax); 1e-4 on ten
optimizer steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import MeshSpec
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import (params_from_numpy,
                                          train_state_from_numpy)
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts

FLAGS = {
    "tiny": {},
    "gpt2": dict(use_rope=False, use_rmsnorm=False, use_swiglu=False,
                 tied_embeddings=True),
    "qwen": dict(use_qkv_bias=True),
}


def _cfgs(flags, **kw):
    base = dataclasses.asdict(jcfg.tiny(**kw))
    base.update(flags)
    return jcfg.TransformerConfig(**base), tcfg.TransformerConfig(**base)


def _params_np(jc, seed=0):
    params = jtr.init_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _torch_params(params_np):
    p = params_from_numpy(params_np, "cpu")
    for leaf in tts._leaves(p):
        leaf.requires_grad_(True)
    return p


def _batch(vocab, b=2, s=32, mask=False, seed=2):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s + 1)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


def _jax_loss_and_grads(jc, params_np, batch, **kw):
    def f(p):
        return jtr.causal_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, jc,
                                  compute_dtype=jnp.float32, **kw)

    (total, metrics), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    return float(total), metrics, grads


def _torch_loss_and_grads(tc, params_np, batch, **kw):
    p = _torch_params(params_np)
    total, metrics = ttr.causal_lm_loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
        compute_dtype=torch.float32, **kw)
    grads = torch.autograd.grad(total, tts._leaves(p))
    return float(total.detach()), metrics, grads


def _assert_grads_close(jgrads, tgrads, rtol=1e-4, atol=1e-8):
    """Within ``rtol`` of each leaf's largest magnitude; ``atol`` covers
    leaves whose gradient is zero analytically (the key bias: softmax does
    not see a constant added to every key's logit), where only rounding
    (~1e-9) remains."""
    jleaves = tts._leaves(jax.tree.map(np.asarray, jgrads))
    assert len(jleaves) == len(tgrads)
    for a, b in zip(tgrads, jleaves):
        assert np.abs(a.numpy() - b).max() <= rtol * np.abs(b).max() + atol


@pytest.mark.parametrize("chunk,mask", [(None, False), (16, True),
                                        (12, False), (0, True)],
                         ids=["unchunked", "chunked-mask",
                              "divisor-shrunk", "auto-mask"])
@pytest.mark.parametrize("flags", ["tiny", "gpt2", "qwen"])
def test_causal_lm_loss_and_grads_match_jax(flags, chunk, mask):
    jc, tc = _cfgs(FLAGS[flags])
    params_np = _params_np(jc)
    batch = _batch(jc.vocab_size, mask=mask)
    jl, jm, jg = _jax_loss_and_grads(jc, params_np, batch, loss_chunk=chunk)
    tl, tm, tg = _torch_loss_and_grads(tc, params_np, batch,
                                       loss_chunk=chunk)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert float(tm["loss"].detach()) == pytest.approx(float(jm["loss"]),
                                                       rel=1e-5)
    assert float(tm["tokens"]) == float(jm["tokens"])
    _assert_grads_close(jg, tg)


def test_chunked_cross_entropy_shrinks_to_a_divisor():
    _, tc = _cfgs({})
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 30, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 11)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 11, (2, 30)))
    want = -torch.log_softmax(x @ w, -1).gather(-1, t[..., None])[..., 0]
    for chunk in (7, 30, 64):   # 7 -> 6 (30 % 7 != 0); 64 -> 30
        got = ttr.chunked_cross_entropy(x, w, t, chunk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_remat_gives_the_same_grads():
    jc, tc = _cfgs({})
    params_np = _params_np(jc)
    batch = _batch(jc.vocab_size)
    l0, _, g0 = _torch_loss_and_grads(tc, params_np, batch, remat=False)
    l1, _, g1 = _torch_loss_and_grads(tc, params_np, batch, remat=True)
    l2, _, g2 = _torch_loss_and_grads(tc, params_np, batch, remat="full")
    assert l0 == l1 == l2
    for a, b, c in zip(g0, g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy", ["save_acts", "save_mlp", "dots"])
def test_remat_save_policies_are_not_ported(policy):
    """The save policies, once refused, now run: loss and grads within 1e-4
    of JAX's under the same policy, and bit for bit the port's own
    remat=False (every policy runs the same steps with the same backward
    arithmetic; only what is kept differs).  An unknown name still
    raises."""
    jc, tc = _cfgs(FLAGS["tiny"])
    params_np = _params_np(jc)
    batch = _batch(jc.vocab_size)
    jl, _, jg = _jax_loss_and_grads(jc, params_np, batch, remat=policy)
    tl, _, tg = _torch_loss_and_grads(tc, params_np, batch, remat=policy)
    l0, _, g0 = _torch_loss_and_grads(tc, params_np, batch, remat=False)
    assert tl == pytest.approx(jl, rel=1e-5)
    _assert_grads_close(jg, tg)
    assert tl == l0
    assert all(torch.equal(a, b) for a, b in zip(tg, g0))
    with pytest.raises(ValueError, match="unknown remat"):
        ttr.remat_policy("bogus")


# What each layer's backward runs again, per policy and attention: the
# JAX policy's saved set decides it.  Flash's residuals are named
# (attn_q/k/v/out/lse), so "save_acts" keeps them and never replays flash;
# splash's are not, so its forward runs again.
_ALL = {"attn_norm", "wq", "wk", "wv", "qkv", "attention", "wo",
        "attn_residual", "mlp_norm", "w_gate", "w_in", "mlp_act"}
_REPLAYED = {
    ("full", "splash"): _ALL,
    ("full", "flash"): _ALL,
    ("save_acts", "splash"): {"attn_norm", "attention", "wo",
                              "attn_residual", "mlp_norm", "mlp_act"},
    ("save_acts", "flash"): {"attn_norm", "wo", "attn_residual", "mlp_norm",
                             "mlp_act"},
    ("save_mlp", "splash"): _ALL - {"w_gate", "w_in"},
    ("dots", "splash"): {"attn_norm", "qkv", "attention", "attn_residual",
                         "mlp_norm", "mlp_act"},
    (False, "splash"): set(),
}
_KEPT = {
    ("full", "splash"): set(),
    ("full", "flash"): set(),
    ("save_acts", "splash"): {"attn_q", "attn_k", "attn_v", "attn_out",
                              "mlp_gate", "mlp_up"},
    ("save_acts", "flash"): {"attn_out", "mlp_gate", "mlp_up"},
    ("save_mlp", "splash"): {"mlp_gate", "mlp_up"},
    ("dots", "splash"): {"q_dot", "k_dot", "v_dot", "attn_proj", "mlp_gate",
                         "mlp_up"},
    # the products' inputs; the norms', attention's and the activation's
    # kept graphs hold the rest
    (False, "splash"): {"attn_in", "attn_out", "mlp_in", "mlp_hidden"},
}


@pytest.mark.parametrize("policy,impl", list(_REPLAYED),
                         ids=[f"{p}-{i}" for p, i in _REPLAYED])
def test_remat_policy_keeps_and_replays_what_jax_saves(policy, impl):
    """Per policy: the values each layer keeps for its backward (flash's
    graph holds q, k, v, out and lse under "save_acts"), and the steps the
    backward runs again, counted per layer; no product is replayed under
    "save_acts" but the output projection (its output is not named), none
    at all under "dots"."""
    from ray_tpu_torch.models import remat as rm
    _, tc = _cfgs({"attention_impl": impl}, hidden=256, heads=2, seq=128)
    tc = dataclasses.replace(tc, num_kv_heads=1)
    params = ttr.init_params(torch.Generator().manual_seed(0), tc)
    lp = ttr.unbind_layers(params["blocks"], tc.num_layers)[0]
    steps = ttr._layer_steps(lp, tc, torch.arange(128), (1, 128), False,
                             torch.float32)
    plan = rm._Plan(steps, ("x", *ttr._flat(lp)), "y",
                    ttr.remat_policy(policy)[1])
    assert set(plan.kept) == _KEPT[policy, impl]
    for leaf in tts._leaves(params):
        leaf.requires_grad_(True)
    rm.replays.clear()
    total, _ = ttr.causal_lm_loss(
        params, {"tokens": torch.randint(0, tc.vocab_size, (1, 129))}, tc,
        compute_dtype=torch.float32, remat=policy)
    assert not rm.replays      # the forward replays nothing
    torch.autograd.grad(total, tts._leaves(params))
    assert rm.replays == {n: tc.num_layers for n in _REPLAYED[policy, impl]}


def test_flash_model_loss_and_grads_match_jax_interpret():
    """attention_impl="flash" at S=256: JAX runs its Pallas forward and
    B2/B3 backward kernels in interpret mode, the port its plain versions
    of B1-B3, through the whole loss and gradient."""
    jc, tc = _cfgs({"attention_impl": "flash"}, seq=256)
    params_np = _params_np(jc)
    batch = _batch(jc.vocab_size, b=1, s=256)
    jl, _, jg = _jax_loss_and_grads(jc, params_np, batch, loss_chunk=None)
    calls = tflash.flash_attention.launches
    tl, _, tg = _torch_loss_and_grads(tc, params_np, batch, loss_chunk=None,
                                      remat=True)
    assert tflash.flash_attention.launches == calls   # CPU: no kernel
    assert tl == pytest.approx(jl, rel=1e-5)
    _assert_grads_close(jg, tg)


def test_remat_backward_frees_each_layers_recompute():
    """What a layer's backward recomputes is freed when that backward
    returns, not when the garbage collector next runs: with the collector
    off, no recompute state outlives the backward."""
    import gc
    from ray_tpu_torch.models import remat as rm
    jc, tc = _cfgs({})
    params = _torch_params(_params_np(jc))
    total, _ = ttr.causal_lm_loss(
        params, {k: torch.from_numpy(v) for k, v in
                 _batch(tc.vocab_size).items()}, tc,
        compute_dtype=torch.float32, remat="full")
    gc.collect()
    gc.disable()
    try:
        torch.autograd.grad(total, tts._leaves(params))
        left = [o for o in gc.get_objects() if isinstance(o, rm._Recompute)]
    finally:
        gc.enable()
    assert not left


def _jax_opt_state(state):
    adam = state.opt_state[1][0]
    return (jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
            np.asarray(adam.count))


def test_ten_train_steps_match_jax():
    """Ten fp32 steps of make_train_step (remat on, warmup then cosine, the
    clip active on some steps) from the same state and batches."""
    jc, tc = _cfgs({})
    opt_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                  grad_clip=10.0)
    mesh = MeshSpec(fsdp=1).build(jax.devices()[:1])
    jopt = jts.make_optimizer(**opt_kw)
    jstate, sh = jts.init_sharded_state(jc, mesh, jopt, seed=0)
    mu, nu, count = _jax_opt_state(jstate)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                    mu, nu, count, np.asarray(jstate.step),
                                    "cpu")
    jstep = jts.make_train_step(jc, mesh, jopt, sh,
                                compute_dtype=jnp.float32)
    tstep = tts.make_train_step(tc, None, tts.make_optimizer(**opt_kw), None,
                                compute_dtype=torch.float32, device="cpu")
    norms = []
    for i in range(10):
        batch = _batch(jc.vocab_size, b=4, s=32, seed=10 + i)
        jstate, jm = jstep(jstate, batch)
        tstate2, tm = tstep(tstate, batch)
        assert tstate2 is tstate
        for key in ("loss", "total_loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4)
        assert float(tm["tokens"]) == float(jm["tokens"])
        norms.append(float(tm["grad_norm"]))
    assert min(norms) < opt_kw["grad_clip"] < max(norms)   # both branches
    assert int(tstate.step) == int(jstate.step) == 10
    assert int(tstate.opt_state["count"]) == 10
    jparams = tts._leaves(jax.tree.map(np.asarray, jstate.params))
    # within 1e-4: Adam's m / sqrt(v) turns the rounding difference of an
    # element's tiny gradient into a difference of up to lr per step, so the
    # bound is absolute
    for a, b in zip(tts._leaves(tstate.params), jparams):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4)


def test_train_step_refuses_what_is_not_ported():
    _, tc = _cfgs({})
    opt = tts.make_optimizer()
    # without a mesh sp_axis is taken and ignored, as the reference's
    # ParallelContext.use_ring ignores it: the same bits as without it
    runs = []
    for kw in ({}, dict(sp_axis="sp")):
        state, _ = tts.init_sharded_state(tc, None, opt, seed=0,
                                          device="cpu")
        step = tts.make_train_step(tc, None, opt, None, device="cpu",
                                   compute_dtype=torch.float32, **kw)
        runs.append(float(step(state, _batch(tc.vocab_size))[1]["loss"]))
    assert runs[0] == runs[1]
    # the dp-manual step is ported (tests/test_torch_zero.py); it shards
    # over a mesh's dp axis, so without a mesh it raises
    for kw in (dict(grad_quant_enabled=True), dict(zero_sharded_update=True)):
        with pytest.raises(ValueError, match="pass a mesh"):
            tts.make_train_step(tc, None, opt, None, device="cpu", **kw)
    # the remat save policies are ported now; an unknown one raises
    for remat in ("save_acts", "save_mlp", "dots"):
        tts.make_train_step(tc, None, opt, None, device="cpu", remat=remat)
    with pytest.raises(ValueError, match="unknown remat"):
        tts.make_train_step(tc, None, opt, None, device="cpu", remat="x")
    # a mesh is ported (tests/test_torch_mesh_train.py), its sp and pp
    # axes too (tests/test_torch_ring_attention.py,
    # tests/test_torch_pipeline.py): the init draws what mesh=None draws
    one, _ = tts.init_sharded_state(tc, None, opt, seed=0, device="cpu")
    want = tts._leaves(one.params)
    for spec in (dict(sp=2, fsdp=1), dict(pp=2, fsdp=1)):
        state, sh = tts.init_sharded_state(
            tc, tmesh.MeshSpec(**spec).build(["cpu"] * 2), opt)
        assert all(torch.equal(a.full(), b.detach()) for a, b in
                   zip(tts._leaves(state.params), want))


def test_init_and_eval_step_on_cpu():
    _, tc = _cfgs({})
    opt = tts.make_optimizer()
    state, sh = tts.init_sharded_state(tc, None, opt, seed=0, device="cpu")
    assert sh is None and int(state.step) == 0
    leaves = tts._leaves(state.params)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in leaves)
    assert [m.shape for m in tts._leaves(state.opt_state["mu"])] == [
        p.shape for p in leaves]
    metrics = tts.make_eval_step(tc, None, sh, compute_dtype=torch.float32,
                                 device="cpu")(state.params,
                                               _batch(tc.vocab_size))
    assert np.isfinite(float(metrics["loss"]))
    assert int(metrics["tokens"]) == 2 * 32
