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
    with pytest.raises(NotImplementedError, match="remat save policies"):
        ttr.remat_policy(policy)
    with pytest.raises(ValueError, match="unknown remat"):
        ttr.remat_policy("bogus")


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
    for kw, match in ((dict(sp_axis="sp"), "ring attention"),
                      (dict(grad_quant_enabled=True), "A9"),
                      (dict(zero_sharded_update=True), "A9"),
                      (dict(remat="save_mlp"), "remat save policies")):
        with pytest.raises(NotImplementedError, match=match):
            tts.make_train_step(tc, None, opt, None, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        tts.init_sharded_state(tc, object(), opt, device="cpu")


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
