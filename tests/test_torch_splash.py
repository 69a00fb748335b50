"""The port's splash attention (kernel B4's plain versions on CPU tensors)
against the JAX package's ``splash_mha``, which runs the upstream Pallas
splash kernel in interpret mode on the CPU, as tests/test_chipspeed.py runs
it.

Inputs come from numpy with a seed, in float32.  Tolerances: 2e-5 on the
output (the tolerance of tests/test_ops.py: f32 sums over other tiles) and
1e-4 of each gradient's largest magnitude (the backward's sums run over
other tiles, and the softcap's tanh is one more rounding per score).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.ops.splash_attention as jsa
from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import splash_attention as tsa
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts

OUT_ATOL = 2e-5
GRAD_RTOL = 1e-4


def _inputs(b=1, s=256, h=4, kv=2, d=128, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                          (b, s, h, d))]


def _fresh_jax_kernels():
    """Drop the JAX package's cached splash kernels: one built under a
    trace (grad, vjp) holds that trace's arrays and must not be reused
    outside it."""
    jsa._get_kernel.cache_clear()


@pytest.fixture(autouse=True)
def _no_traced_jax_kernels_left_behind():
    """Empty the JAX package's splash kernel cache after every test too: a
    kernel this file built under a trace would otherwise reach the JAX
    package's own tests run later in the same process."""
    yield
    _fresh_jax_kernels()


def _jax_out_and_vjp(q, k, v, g, causal, softcap):
    _fresh_jax_kernels()

    def f(q, k, v):
        return jsa.splash_mha(q, k, v, causal=causal, logit_softcap=softcap,
                              block_q=128, block_kv=128)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_grads_close(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a = a.detach().numpy() if torch.is_tensor(a) else a
        err = np.abs(a - b).max()
        assert err <= GRAD_RTOL * np.abs(b).max(), (name, err)


@pytest.mark.parametrize("softcap", [0.0, 50.0, 5.0])
@pytest.mark.parametrize("causal", [True, False])
def test_splash_mha_and_its_gradients_match_jax(causal, softcap):
    """Output, and dq/dk/dv through autograd, against JAX's splash_mha and
    its vjp on the same (q, k, v, dO); softcap 5 makes tanh bite on
    unit-scale scores, 50 is Gemma-2's cap."""
    q, k, v, g = _inputs()
    want_out, want_grads = _jax_out_and_vjp(q, k, v, g, causal, softcap)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tsa.splash_mha(qt, kt, vt, causal=causal, logit_softcap=softcap,
                         block_q=128, block_kv=128)
    assert out.dtype == torch.float32 and out.shape == qt.shape
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=OUT_ATOL,
                               rtol=0)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    _assert_grads_close(got, want_grads)


def test_plain_backward_matches_jax_vjp_on_the_same_residuals():
    """The plain backward alone (B4's dq and dk/dv versions, scale 1 on a
    pre-scaled q) against JAX's vjp of splash_mha, softcap on, with the
    forward's residuals from the plain forward."""
    from ray_tpu_torch.ops import flash_attention as tfa
    q, k, v, g = _inputs(seed=3)
    _, want = _jax_out_and_vjp(q, k, v, g, True, 5.0)
    scale = q.shape[-1] ** -0.5
    qs, kt, vt, gt = (torch.from_numpy(x) for x in (q * scale, k, v, g))
    out, lse = tfa.flash_attention_reference(qs, kt, vt, True, 128, 128,
                                             softcap=5.0, scale=1.0)
    dqs, dk, dv = tfa.flash_attention_bwd_reference(
        qs, kt, vt, out, lse, gt, True, 128, 128, softcap=5.0, scale=1.0)
    _assert_grads_close((dqs * scale, dk, dv), want)


def test_decline_contract_warns_once():
    """D=64 is declined with None and exactly one RuntimeWarning over two
    calls; over a mesh every device runs its rows of the batch axes (the
    same output, put back together), and batch axes that do not divide the
    batch raise."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(s=128, d=64))
    tsa._warned = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert tsa.splash_mha(q, k, v) is None
        assert tsa.splash_mha(q, k, v) is None
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "splash" in str(w.message)]
    assert len(warned) == 1, warned
    assert "head_dim=64" in str(warned[0].message)
    assert tsa.splash_supported(256, 256, 4, 2, 128) is None
    assert "seq" in tsa.splash_supported(200, 200, 4, 2, 128)
    assert "kv heads" in tsa.splash_supported(256, 256, 4, 3, 128)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(b=4, s=128))
    mesh = tmesh.MeshSpec(dp=2, fsdp=2).build(["cpu"] * 4)
    out = tsa.splash_mha(q, k, v, mesh=mesh)
    assert [p.shape[0] for p in out.parts] == [1] * 4
    torch.testing.assert_close(out.full(), tsa.splash_mha(q, k, v), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="divide"):
        tsa.splash_mha(q[:3], k[:3], v[:3], mesh=mesh)


def test_pick_block_matches_jax():
    for seq, cap in ((256, 512), (384, 512), (2048, 512), (640, 512),
                     (128, 64)):
        assert tsa._pick_block(seq, cap) == jsa._pick_block(seq, cap)


def _model_cfgs(**kw):
    base = dict(vocab_size=128, num_layers=2, hidden_size=512, num_heads=4,
                num_kv_heads=2, mlp_size=256, max_seq_len=128,
                attention_impl="splash")
    base.update(kw)
    return jcfg.TransformerConfig(**base), tcfg.TransformerConfig(**base)


def _params_np(jc, seed=0):
    params = jtr.init_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def test_model_loss_and_grads_with_splash_match_jax():
    """attention_impl="splash" through the whole model: logits, the loss and
    every gradient leaf against JAX's on the same params, converted leaf by
    leaf (hidden 512 over 4 heads: D = 128, which splash takes; softcap 5,
    so the cap bites)."""
    jc, tc = _model_cfgs(attn_logit_softcap=5.0, num_layers=1)
    params_np = _params_np(jc)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jc.vocab_size, (1, 129)).astype(np.int32)

    def jloss(p):
        return jtr.causal_lm_loss(p, {"tokens": jnp.asarray(tokens)}, jc,
                                  compute_dtype=jnp.float32)[0]

    jp = jax.tree.map(jnp.asarray, params_np)
    _fresh_jax_kernels()
    jlogits = np.asarray(jtr.apply(jp, jnp.asarray(tokens[:, :-1]), jc,
                                   compute_dtype=jnp.float32)[0])
    _fresh_jax_kernels()
    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = params_from_numpy(params_np, "cpu")
    leaves = tts._leaves(tp)
    # the splash config's tree is the JAX tree, leaf for leaf
    assert [tuple(t.shape) for t in leaves] == [
        a.shape for a in tts._leaves(params_np)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    with torch.no_grad():
        tlogits = ttr.apply(tp, torch.from_numpy(tokens[:, :-1]), tc,
                            compute_dtype=torch.float32)[0]
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=1e-4, rtol=0)
    tl, _ = ttr.causal_lm_loss(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                               compute_dtype=torch.float32)
    tg = torch.autograd.grad(tl, leaves)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for a, b in zip(tg, tts._leaves(jax.tree.map(np.asarray, jg))):
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max() + 1e-8


def test_declining_model_equals_its_auto_twin():
    """head_dim 16 (tiny): splash declines, the model falls back to mha
    and gives the "auto" config's logits exactly, with one warning."""
    tc = tcfg.tiny()
    splash = dataclasses.replace(tc, attention_impl="splash")
    params = ttr.init_params(torch.Generator().manual_seed(0), tc)
    toks = torch.randint(0, tc.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    tsa._warned = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ttr.apply(params, toks, splash, compute_dtype=torch.float32)[0]
    assert sum(issubclass(w.category, RuntimeWarning) for w in caught) == 1
    want = ttr.apply(params, toks, tc, compute_dtype=torch.float32)[0]
    assert torch.equal(got, want)


def test_train_steps_with_splash_under_save_acts_match_jax():
    """make_train_step(remat="save_acts") with attention_impl="splash",
    three fp32 steps from the same state and batches as JAX's step: loss
    and grad norm within 1e-4 relative, params within 1e-4."""
    from ray_tpu.parallel import MeshSpec
    from ray_tpu.parallel import train_step as jts
    from ray_tpu_torch.models.convert import train_state_from_numpy

    jc, tc = _model_cfgs(num_layers=1)
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    mesh = MeshSpec(fsdp=1).build(jax.devices()[:1])
    jopt = jts.make_optimizer(**opt_kw)
    jstate, sh = jts.init_sharded_state(jc, mesh, jopt, seed=0)
    adam = jstate.opt_state[1][0]
    tstate = train_state_from_numpy(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        np.asarray(adam.count), np.asarray(jstate.step), "cpu")
    _fresh_jax_kernels()
    jstep = jts.make_train_step(jc, mesh, jopt, sh, remat="save_acts",
                                compute_dtype=jnp.float32)
    tstep = tts.make_train_step(tc, None, tts.make_optimizer(**opt_kw), None,
                                compute_dtype=torch.float32,
                                remat="save_acts", device="cpu")
    counts = tsa.splash_attention.launches
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = {"tokens": rng.integers(0, jc.vocab_size, (2, 129))
                 .astype(np.int32)}
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4)
    assert tsa.splash_attention.launches == counts   # CPU: no kernel
    for a, b in zip(tts._leaves(tstate.params),
                    tts._leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4)
