"""B1-B4 in f16 and f32, as the JAX package's kernels take them.

The port's flash (B1-B3) and splash (B4) kernels take bf16, f16 and f32 on
the card, each type through its own entry point; on the CPU their plain
versions run.  Here, on the CPU:

* the plain versions, forward and gradients, in f16 and f32 against the
  JAX package's ``flash_attention`` (Pallas interpret mode, as
  tests/test_ops.py runs it; blocks of 128, so the backward is its Pallas
  B2/B3) and ``splash_mha`` (upstream's splash kernel in interpret mode,
  which takes f16 on the CPU), on the same numpy inputs.  Limits: 2e-5
  (tests/test_ops.py's) in f32, on the output and as a share of each
  gradient's largest magnitude; 1e-3 of the largest magnitude in f16, whose
  outputs and gradients round to 11 bits (P and dS round to f16 in both,
  at the same tile boundaries);
* the dispatch: ``flash_kernel_takes``, ``splash_kernel_declines`` and
  ``transformer._attention_fn`` send bf16, f16 and f32 CUDA inputs to the
  kernels and no other type;
* with the library loader and the CUDA calls faked, each type reaches its
  own ``*_bf16`` / ``*_f16`` / ``*_f32`` entry point and per-type launch
  count, and f64 raises before any launch;
* a tiny Llama ``LLMEngine`` with ``compute_dtype=torch.float16`` against
  the JAX engine with ``jnp.float16``: prefill logits within 1e-2 of the
  largest magnitude (f16 rounds every activation, in another order).

tests/test_torch_attention_dtypes_cuda.py holds the kernels themselves on
the card.
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.ops.splash_attention as jsa
from ray_tpu.models import config as jcfg
from ray_tpu.models import decode as jdec
from ray_tpu.models import transformer as jtr
from ray_tpu.ops import flash_attention as jflash
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import decode as tdec
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import splash_attention as tsa
from ray_tpu_torch.serve import llm as tllm

DTYPES = {"f16": (torch.float16, jnp.float16),
          "f32": (torch.float32, jnp.float32)}
KERNEL_TYPES = (torch.bfloat16, torch.float16, torch.float32)


def _inputs(tag, b=1, s=256, h=4, kv=2, d=64, seed=0):
    """q, k, v, dO from numpy seed ``seed``, rounded to the type once."""
    rng = np.random.default_rng(seed)
    np_dt = np.float16 if tag == "f16" else np.float32
    return [rng.standard_normal(shape).astype(np_dt)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                          (b, s, h, d))]


def _assert_close(tag, got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    limit = 1e-3 * np.abs(want).max() if tag == "f16" else 2e-5 * max(
        1.0, np.abs(want).max())
    assert err <= limit, (what, err, limit)


def _port_out_and_grads(fn, q, k, v, g):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return out.detach(), grads


def _jax_out_and_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(g))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_flash_and_its_gradients_match_jax_in_each_type(tag, causal):
    """B1-B3's plain versions on f16 / f32 inputs against the JAX package's
    Pallas kernels in interpret mode: the output keeps the input type, and
    it and dq, dk, dv agree within the type's limit."""
    q, k, v, g = _inputs(tag)
    kw = dict(causal=causal, block_q=128, block_kv=128)
    out, grads = _port_out_and_grads(
        lambda *x: tflash.flash_attention(*x, **kw), q, k, v, g)
    want_out, want_grads = _jax_out_and_grads(
        lambda *x: jflash.flash_attention(*x, interpret=True, **kw),
        q, k, v, g)
    assert out.dtype == DTYPES[tag][0] and want_out.dtype == DTYPES[tag][1]
    _assert_close(tag, out.numpy(), want_out, "out")
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        assert a.dtype == DTYPES[tag][0], name
        _assert_close(tag, a.numpy(), b, name)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_splash_and_its_gradients_match_jax_in_each_type(tag, softcap):
    """B4's plain versions (``splash_mha`` on CPU tensors) on f16 / f32
    inputs against upstream's splash kernel in interpret mode, through the
    JAX package's ``splash_mha``: output and dq, dk, dv within the type's
    limit (softcap 5 bends tanh on these unit-scale scores)."""
    q, k, v, g = _inputs(tag, d=128, seed=1)
    kw = dict(causal=True, logit_softcap=softcap, block_q=128, block_kv=128)
    jsa._get_kernel.cache_clear()
    try:
        want_out, want_grads = _jax_out_and_grads(
            lambda *x: jsa.splash_mha(*x, **kw), q, k, v, g)
    finally:
        jsa._get_kernel.cache_clear()  # kernels built under a trace
    out, grads = _port_out_and_grads(
        lambda *x: tsa.splash_mha(*x, **kw), q, k, v, g)
    assert out.dtype == DTYPES[tag][0]
    _assert_close(tag, out.numpy(), want_out, "out")
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        _assert_close(tag, a.numpy(), b, name)


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_plain_attention_matches_jax_in_each_type(tag):
    """Plain causal attention (``mha`` on CPU tensors, and the engine's
    short prompts on the card) in f16 and f32 against the JAX package's
    ``attend``: the masked logits take the mask value in the logits' type
    in both (-inf in f16, whose range ends at 65504)."""
    from ray_tpu.ops import attention as jattn
    q, k, v, _ = _inputs(tag, s=48)
    want = jattn.attend(*map(jnp.asarray, (q, k, v)), causal=True)
    got = tattn.mha(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert got.dtype == DTYPES[tag][0]
    _assert_close(tag, got.numpy(), want, "out")


# ------------------------------------------------------------- dispatch

@pytest.mark.parametrize("dtype", KERNEL_TYPES)
def test_flash_kernel_takes_every_kernel_type(dtype):
    assert tattn.flash_kernel_takes(True, 1024, 128, 0.0, dtype)
    assert tattn.flash_kernel_takes(True, 2048, 64, 0.0, dtype)
    assert not tattn.flash_kernel_takes(False, 1024, 128, 0.0, dtype)
    assert not tattn.flash_kernel_takes(True, 1023, 128, 0.0, dtype)
    assert not tattn.flash_kernel_takes(True, 1024, 128, 50.0, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32,
                                   torch.complex64])
def test_flash_kernel_takes_no_other_type(dtype):
    assert not tattn.flash_kernel_takes(True, 1024, 128, 0.0, dtype)


@pytest.mark.parametrize("dtype", KERNEL_TYPES + (torch.float64,))
def test_splash_kernel_declines_only_a_head_dim(dtype):
    """B4 declines no type (its wrappers raise on one they do not take, as
    a kernel launch would), only a head dim it has no instantiation for."""
    for d in (128, 256):
        assert tsa.splash_kernel_declines(True, dtype, d) is None
    assert "head_dim=384" in tsa.splash_kernel_declines(True, dtype, 384)


def _cfg(impl):
    return dataclasses.replace(tcfg.tiny(hidden=256, heads=2, seq=2048),
                               attention_impl=impl)


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("dtype", KERNEL_TYPES + (torch.float64,))
def test_attention_fn_sends_kernel_types_to_flash(monkeypatch, impl, dtype):
    """The model's attention step on CUDA inputs at S=1024: flash's
    residual names, and a call of ``flash_attention`` (spied on, run on
    small f32 CPU tensors), for bf16, f16 and f32; neither for f64."""
    takes = dtype in KERNEL_TYPES
    calls = []
    monkeypatch.setattr(tflash, "flash_attention",
                        lambda *a, **kw: calls.append(1) or a[0])
    fn, names = ttr._attention_fn(_cfg(impl), 1024, True, dtype)
    assert (names == ttr.FLASH_RESIDUALS) is takes
    monkeypatch.setattr(tattn, "flash_kernel_takes",
                        lambda is_cuda, *a: takes)  # CPU tensors stand in
    q, k, v = (torch.ones((1, 8, heads, 128)) for heads in (2, 1, 1))
    fn(q, k, v)
    assert bool(calls) is takes


# ---------------------------------------------------------- entry points

class _FakeLib:
    """Stands in for a built library: every entry point records its name
    and returns 0 (accepted); the binder's argtypes stay on the entry."""

    def __init__(self, calls):
        self._calls, self._fns = calls, {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._fns:
            def fn(*args, _name=name):
                self._calls.append(_name)
                return 0
            self._fns[name] = fn
        return self._fns[name]


@pytest.fixture
def fake_launch(monkeypatch):
    """Launches through ``_FakeLib`` with CPU tensors standing in for CUDA
    ones; -> (the entry points called, the libraries bound)."""
    calls, libs = [], {}

    def load(name, bind):
        if name not in libs:
            libs[name] = _FakeLib(calls)
            bind(libs[name])
        return libs[name]

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(tflash, "_device_index", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return calls, libs


def _kernel_inputs(dtype, s=64, h=4, kv=2, d=128):
    q, k, v, g = (torch.zeros(shape, dtype=dtype) for shape in (
        (1, s, h, d), (1, s, kv, d), (1, s, kv, d), (1, s, h, d)))
    stats = torch.zeros((1, h, s), dtype=torch.float32)
    return q, k, v, g, stats


def _launch_all(dtype):
    """B1-B3's wrappers and B4's three launches, each once."""
    q, k, v, g, st = _kernel_inputs(dtype)
    tflash._flash_fwd_cuda(q, k, v, True)
    tflash.flash_attention_bwd_dq(q, k, v, g, st, st, True)
    tflash.flash_attention_bwd_dkv(q, k, v, g, st, st, True)
    tflash._fwd_launch("splash_attention_fwd", q, k, v, True, 1.0, 50.0,
                       head_dims=tsa.KERNEL_HEAD_DIMS)
    tsa.splash_attention_bwd_dq(q, k, v, g, st, st, True, 50.0)
    tsa.splash_attention_bwd_dkv(q, k, v, g, st, st, True, 50.0)


KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "splash_attention_fwd",
           "splash_attention_bwd_dq", "splash_attention_bwd_dkv")
COUNTED = (tflash.flash_attention, tflash.flash_attention_bwd_dq,
           tflash.flash_attention_bwd_dkv, tsa.splash_attention_bwd_dq,
           tsa.splash_attention_bwd_dkv)


@pytest.mark.parametrize("dtype,suffix", [
    (torch.bfloat16, "bf16"), (torch.float16, "f16"),
    (torch.float32, "f32")])
def test_each_type_reaches_its_own_entry_points(fake_launch, dtype, suffix):
    """Every kernel's launch in ``dtype`` calls its ``*_<suffix>`` entry
    point, and the wrappers count it under that type; every entry point of
    every type has its argtypes bound."""
    calls, libs = fake_launch
    before = [(c.launches, dict(c.launches_by_dtype)) for c in COUNTED]
    _launch_all(dtype)
    assert calls == [f"{k}_{suffix}" for k in KERNELS]
    for c, (n, by) in zip(COUNTED, before):
        assert c.launches == n + 1
        assert c.launches_by_dtype == {**by, suffix: by[suffix] + 1}
    bound = [name for lib in libs.values() for name, fn in lib._fns.items()
             if hasattr(fn, "argtypes") and "error_string" not in name]
    assert sorted(bound) == sorted(f"{k}_{s}" for k in KERNELS
                                   for s in ("bf16", "f16", "f32"))


def test_f64_raises_before_any_launch(fake_launch):
    """A type the kernels do not take raises in every wrapper, and nothing
    is launched or counted."""
    calls, _ = fake_launch
    before = [c.launches for c in COUNTED]
    q, k, v, g, st = _kernel_inputs(torch.float64)
    for launch in (lambda: tflash._flash_fwd_cuda(q, k, v, True),
                   lambda: tflash.flash_attention_bwd_dq(q, k, v, g, st, st),
                   lambda: tflash.flash_attention_bwd_dkv(q, k, v, g, st,
                                                          st),
                   lambda: tsa.splash_attention_bwd_dq(q, k, v, g, st, st),
                   lambda: tsa.splash_attention_bwd_dkv(q, k, v, g, st,
                                                        st)):
        with pytest.raises(ValueError, match="bf16, f16, f32"):
            launch()
    with pytest.raises(ValueError, match="bf16, f16, f32"):
        tflash.entry_name("flash_attention_fwd", torch.float64)
    assert calls == [] and [c.launches for c in COUNTED] == before


def test_mixed_types_raise(fake_launch):
    """q, k and v of two types raise: one entry point takes one type."""
    calls, _ = fake_launch
    q, k, v, _, _ = _kernel_inputs(torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        tflash._flash_fwd_cuda(q, k.half(), v.half(), True)
    assert calls == []


# ------------------------------------------------------------- the engine

def test_f16_engine_prefill_matches_jax():
    """A tiny Llama in f16 compute, the same f32 weights in both packages'
    ``LLMEngine``: one prefill of three prompts through each engine's
    params and its own f16 cache, last-token logits within 1e-2 of the
    largest magnitude, the caches within 1e-2 of theirs."""
    cfg = jcfg.tiny()
    tree = jax.tree.map(np.asarray, jtr.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    tc = tcfg.TransformerConfig(**dataclasses.asdict(cfg))
    jeng = jllm.LLMEngine(cfg, jax.tree.map(jnp.asarray, tree), num_slots=4,
                          max_len=64, compute_dtype=jnp.float16)
    teng = tllm.LLMEngine(tc, params_from_numpy(tree, "cpu"), num_slots=4,
                          max_len=64, compute_dtype=torch.float16,
                          device="cpu")
    try:
        assert teng.compute_dtype == torch.float16
        lens = [5, 17, 30]
        toks = np.zeros((3, 32), np.int32)
        rng = np.random.default_rng(4)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
        lengths = np.asarray(lens, np.int32)
        slots = np.arange(3, dtype=np.int32)
        jc, want = jax.jit(jdec.prefill, static_argnums=(5, 6))(
            jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(lengths),
            jnp.asarray(slots), cfg, jnp.float16)
        tcache, got = tdec.prefill(
            teng.params, teng.cache, torch.from_numpy(toks),
            torch.from_numpy(lengths), torch.from_numpy(slots), tc,
            compute_dtype=torch.float16)
    finally:
        jeng.shutdown()
        teng.shutdown()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()
    for key in ("k", "v"):
        assert tcache[key].dtype == torch.float16
        a = tcache[key].float().numpy()
        b = np.asarray(jc[key], np.float32)
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max(), key
