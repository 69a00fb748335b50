"""The port's transformer forward and decode path against the JAX package's.

Params come from the JAX package's ``init_params``, with every bias and
norm leaf perturbed by seeded numpy noise (so the bias, LayerNorm and
learned-position paths do real work), and go to the port through
``params_from_numpy``.  Three tiny configs: Llama-style (RMSNorm, RoPE,
SwiGLU, GQA), GPT-2 flags (LayerNorm with bias, learned positions, GELU,
tied embeddings), Qwen's QKV bias and Mixtral's MoE (4 experts, top 2).  Logits and cache rows agree within
1e-4 in float32; greedy tokens are identical.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import config as jcfg
from ray_tpu.models import decode as jdec
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import decode as tdec
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-4

# jitted once: the eager JAX calls would retrace their layer scan per call
_jdecode_step = jax.jit(jdec.decode_step, static_argnums=(4, 5))
_jprefill = jax.jit(jdec.prefill, static_argnums=(5, 6))
_jprefill_admit = jax.jit(jdec.prefill_admit, static_argnums=(10, 11, 12))
_jstate_loop = jax.jit(jdec.decode_state_loop, static_argnums=(3, 4, 5, 6))

_BASE = jcfg.tiny()
CONFIGS = {
    "llama": _BASE,
    "gpt2": dataclasses.replace(_BASE, use_rope=False, use_rmsnorm=False,
                                use_swiglu=False, tied_embeddings=True),
    "qwen": dataclasses.replace(_BASE, use_qkv_bias=True),
    "moe": jcfg.tiny(experts=4),
}


def _perturbed(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v, np.float32)
        if k in ("scale", "bias") or k.startswith("b"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        out[k] = a
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    cfg = CONFIGS[request.param]
    params = jtr.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tree = _perturbed(jax.tree.map(np.asarray, params),
                      np.random.default_rng(1))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, "cpu")
    tc = tcfg.TransformerConfig(**dataclasses.asdict(cfg))
    return cfg, tc, jparams, tparams


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_convert_keeps_tree_and_values(model):
    cfg, _, jparams, tparams = model
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(jax.tree.leaves(tparams))
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_apply_matches_jax(model):
    cfg, tc, jparams, tparams = model
    toks = _tokens((2, 16), cfg.vocab_size)
    want, want_aux = jtr.apply(jparams, jnp.asarray(toks), cfg,
                               compute_dtype=jnp.float32)
    got, aux = ttr.apply(tparams, torch.from_numpy(toks), tc,
                         compute_dtype=torch.float32)
    # the aux loss is 0 for a dense model, the blocks' mean for MoE
    assert got.dtype == torch.float32
    assert float(aux["moe_aux_loss"]) == pytest.approx(
        float(want_aux["moe_aux_loss"]), abs=1e-6)
    assert (float(aux["moe_aux_loss"]) > 0) == (cfg.num_experts > 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _prefill_both(model, prompt_lens, bucket=16, num_slots=4, max_len=32):
    cfg, tc, jparams, tparams = model
    b = len(prompt_lens)
    toks = np.zeros((b, bucket), np.int32)
    for i, n in enumerate(prompt_lens):
        toks[i, :n] = _tokens((n,), cfg.vocab_size, seed=10 + i)
    lengths = np.asarray(prompt_lens, np.int32)
    slots = np.arange(b, dtype=np.int32)
    jc = jdec.init_kv_cache(cfg, num_slots, max_len, jnp.float32)
    jc, jl = _jprefill(jparams, jc, jnp.asarray(toks), jnp.asarray(lengths),
                       jnp.asarray(slots), cfg, jnp.float32)
    tcache = tdec.init_kv_cache(tc, num_slots, max_len, torch.float32, "cpu")
    tcache, tl = tdec.prefill(tparams, tcache, torch.from_numpy(toks),
                              torch.from_numpy(lengths),
                              torch.from_numpy(slots), tc,
                              compute_dtype=torch.float32)
    return (jc, jl), (tcache, tl)


def _assert_cache_close(jc, tcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jc["length"]))


def test_prefill_matches_jax(model):
    (jc, jl), (tcache, tl) = _prefill_both(model, [5, 16, 9])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(jc, tcache)


def test_decode_steps_match_jax(model):
    cfg, tc, jparams, tparams = model
    (jc, jl), (tcache, tl) = _prefill_both(model, [5, 16, 9])
    active = np.asarray([True, True, False, False])
    toks = np.zeros((4,), np.int32)
    toks[:3] = np.asarray(jnp.argmax(jl, -1))
    for _ in range(8):
        jc, jl = _jdecode_step(jparams, jc, jnp.asarray(toks),
                               jnp.asarray(active), cfg, jnp.float32)
        tcache, tl = tdec.decode_step(tparams, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(active), tc,
                                      compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _assert_cache_close(jc, tcache)


def test_decode_at_max_len_drops_the_write_like_jax(model):
    """A slot standing at max_len: JAX drops the out-of-range K/V write and
    keeps the length at max_len; the port must give the same, not raise."""
    cfg, tc, jparams, tparams = model
    max_len = 8
    (jc, _), (tcache, _) = _prefill_both(model, [6], bucket=8, num_slots=2,
                                         max_len=max_len)
    toks = np.asarray([3, 0], np.int32)
    active = np.asarray([True, False])
    for step in range(4):       # lengths 6 -> 7 -> 8 -> 8 -> 8
        jc, jl = _jdecode_step(jparams, jc, jnp.asarray(toks),
                               jnp.asarray(active), cfg, jnp.float32)
        tcache, tl = tdec.decode_step(tparams, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(active), tc,
                                      compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        _assert_cache_close(jc, tcache)
        toks = np.asarray([11 + step, 0], np.int32)
    assert int(tcache["length"][0]) == max_len


def test_greedy_admit_and_state_loop_tokens_identical(model):
    cfg, tc, jparams, tparams = model
    num_slots, max_len, bucket = 4, 48, 16
    lens = [5, 12, 16]
    toks = np.zeros((4, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = _tokens((n,), cfg.vocab_size, seed=20 + i)
    lengths = np.asarray(lens + [1], np.int32)
    slots = np.asarray([0, 1, 2, 3], np.int32)      # row 3: scratch padding
    temps = np.zeros((4,), np.float32)
    budgets = np.asarray([17, 17, 17, 1], np.int32)
    eos = np.full((4,), -1, np.int32)
    real = np.asarray([True, True, True, False])
    args = (toks, lengths, slots, temps, budgets, eos, real)

    jc = jdec.init_kv_cache(cfg, num_slots, max_len, jnp.float32)
    js = jdec.init_decode_state(num_slots, jax.random.PRNGKey(0))
    jc, js, jfirst = _jprefill_admit(jparams, jc, js, *map(jnp.asarray, args),
                                     cfg, 0, jnp.float32)
    jc, js, jem = _jstate_loop(jparams, jc, js, 16, cfg, 0, jnp.float32)

    tcache = tdec.init_kv_cache(tc, num_slots, max_len, torch.float32, "cpu")
    ts = tdec.init_decode_state(num_slots, torch.Generator().manual_seed(0))
    tcache, ts, tfirst = tdec.prefill_admit(
        tparams, tcache, ts, *map(torch.from_numpy, args), tc,
        compute_dtype=torch.float32)
    tcache, ts, tem = tdec.decode_state_loop(tparams, tcache, ts, 16, tc,
                                             compute_dtype=torch.float32)

    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    for key in ("tokens", "active", "budget"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))


def test_sampling_shape_range_and_decay():
    """Temperature/top-k draws differ from JAX's by construction (another
    generator): check shape, range, greedy rows and on-device decay."""
    tc = tcfg.tiny()
    gen = torch.Generator().manual_seed(0)
    params = ttr.init_params(gen, tc)
    cache = tdec.init_kv_cache(tc, 3, 32, torch.float32, "cpu")
    state = tdec.init_decode_state(3, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_tokens((3, 8), tc.vocab_size))
    cache, state, first = tdec.prefill_admit(
        params, cache, state, toks, torch.tensor([8, 4, 1], dtype=torch.int32),
        torch.tensor([0, 1, 2], dtype=torch.int32),
        torch.tensor([1.0, 0.7, 0.0]), torch.tensor([5, 3, 1], dtype=torch.int32),
        torch.full((3,), -1, dtype=torch.int32),
        torch.tensor([True, True, False]), tc, top_k=5,
        compute_dtype=torch.float32)
    assert first.shape == (3,) and first.dtype == torch.int32
    assert state["active"].tolist() == [True, True, False]
    cache, state, em = tdec.decode_state_loop(params, cache, state, 6, tc,
                                              top_k=5,
                                              compute_dtype=torch.float32)
    assert em.shape == (6, 3)
    assert int(em.min()) >= 0 and int(em.max()) < tc.vocab_size
    # budgets 5 and 3 (minus the first token) run out on the device
    assert state["active"].tolist() == [False, False, False]
    assert state["budget"].tolist() == [0, 0, 0]
    logits = torch.randn((4, tc.vocab_size), generator=gen)
    np.testing.assert_array_equal(tdec.sample(logits, gen).numpy(),
                                  logits.argmax(-1).numpy())
    drawn = tdec.sample(logits, gen, temperature=1.0, top_k=3)
    top3 = logits.topk(3, dim=-1).indices
    assert all(int(d) in top3[i].tolist() for i, d in enumerate(drawn))


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; torch's default (erf) differs by more
    than the tolerance, which the GPT-2 config's tests would catch."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(F.gelu(xt, approximate="tanh").numpy(), want,
                               atol=1e-6)
    assert np.abs(F.gelu(xt).numpy() - want).max() > ATOL


def test_not_ported_options_raise():
    """Options once refused now run.  MoE: init_params draws the JAX
    package's ``moe`` leaves (and no ``mlp``), and the model runs on them.
    attention_impl="splash": on the tiny config (head dim 16) splash
    declines the shape and the model gives the "auto" config's logits, as
    the JAX package falls back."""
    tc = tcfg.tiny()
    gen = torch.Generator().manual_seed(0)
    moe_cfg = tcfg.tiny(experts=4)
    moe = ttr.init_params(gen, moe_cfg)
    want = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0),
                                                  jcfg.tiny(experts=4)))
    assert "mlp" not in moe["blocks"]
    assert {k: tuple(v.shape) for k, v in moe["blocks"]["moe"].items()} == {
        k: v.shape for k, v in want["blocks"]["moe"].items()}
    logits, aux = ttr.apply(moe, torch.zeros((1, 8), dtype=torch.int32),
                            moe_cfg, compute_dtype=torch.float32)
    assert torch.isfinite(logits).all() and float(aux["moe_aux_loss"]) > 0
    params = ttr.init_params(gen, tc)
    splash = dataclasses.replace(tc, attention_impl="splash")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the decline
        got = ttr.apply(params, toks, splash, compute_dtype=torch.float32)[0]
    want = ttr.apply(params, toks, tc, compute_dtype=torch.float32)[0]
    assert torch.equal(got, want)
