"""B1-B4 in f16 and f32 against their plain versions on a CUDA card.

f16 runs the same ``wgmma`` bodies as bf16 (templated on the 16-bit type),
f32 a body of its own on the CUDA cores (``csrc/attention_f32.cuh``).
Each is held to its plain version in the same type, at small and edge
shapes: ragged S, GQA, D in {64, 128, 256}, strided views, the softcap.
Limits: f16 out 5e-3, lse 1e-3, dq/dk/dv 5e-3 of the largest magnitude
(f16 keeps 11 bits: P and dS round 8 times finer than in bf16, whose
limits are 2e-2); f32 out 2e-5 (tests/test_ops.py's), lse 1e-5, dq/dk/dv
1e-4 of the largest magnitude (nothing rounds; f32 sums in another order).
lse is also allowed 5e-7 of its own magnitude (four f32 roundings): with
the softcap the scores reach 30-50, lse as much, and there one rounding of
a score's sum is already 2-4e-6.  The backward repeats bit for bit in
every type (no atomics).

Needs the card (the kernels have no CPU mode), so every test here is marked
``cuda`` and skips without one.  The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_dtypes_cuda.py
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import splash_attention as tsa

# (out, lse, dq/dk/dv as a share of the largest magnitude) per type
LIMITS = {torch.float16: (5e-3, 1e-3, 5e-3),
          torch.float32: (2e-5, 1e-5, 1e-4)}
TYPES = sorted(LIMITS, key=str)
SUFFIX = {torch.float16: "f16", torch.float32: "f32"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    return torch.device("cuda")


def _inputs(dev, dtype, B, S, H, KV, D, seed=0, strided=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        qkv = torch.randn((B, S, H + 2 * KV, D), generator=g, device=dev,
                          dtype=dtype)
        dout = torch.randn((B, H, S, D), generator=g, device=dev,
                           dtype=dtype).transpose(1, 2)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:], dout
    return [torch.randn(shape, generator=g, device=dev, dtype=dtype)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                          (B, S, H, D))]


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _rel_err(got, want):
    return _max_err(got, want) / want.float().abs().max().item()


def _check_lse(dtype, got, want):
    excess = (got - want).abs() - (LIMITS[dtype][1] + 5e-7 * want.abs())
    assert excess.max().item() <= 0, _max_err(got, want)


def _check_grads(dtype, got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= LIMITS[dtype][2], (name, _rel_err(a, b))


CASES = [  # (causal, S, H, KV, D, strided)
    (True, 1024, 8, 2, 128, False), (False, 256, 8, 8, 64, False),
    (True, 1000, 8, 2, 128, False), (True, 1088, 16, 4, 256, False),
    (False, 200, 4, 1, 128, False), (True, 64, 8, 2, 128, False),
    (True, 1088, 8, 2, 128, True), (True, 320, 8, 2, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES, ids=str)
@pytest.mark.parametrize("causal,S,H,KV,D,strided", CASES)
def test_flash_forward_matches_plain_on_card(cuda_device, dtype, causal, S,
                                             H, KV, D, strided):
    """B1 in ``dtype``: out (in ``dtype``) and lse (f32) within the type's
    limits of the plain version, one launch counted under its type."""
    q, k, v, _ = _inputs(cuda_device, dtype, 2, S, H, KV, D, strided=strided)
    before = tflash.flash_attention.launches_by_dtype[SUFFIX[dtype]]
    out, lse = tflash._flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert (tflash.flash_attention.launches_by_dtype[SUFFIX[dtype]]
            == before + 1)
    ref_out, ref_lse = tflash.flash_attention_reference(q, k, v, causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert _max_err(out, ref_out) <= LIMITS[dtype][0]
    _check_lse(dtype, lse, ref_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES, ids=str)
@pytest.mark.parametrize("causal,S,H,KV,D,strided", CASES)
def test_flash_backward_matches_plain_on_card(cuda_device, dtype, causal, S,
                                              H, KV, D, strided):
    """B2 and B3 in ``dtype`` against the plain backward on the same
    residuals, and the same bits on a second run."""
    q, k, v, dout = _inputs(cuda_device, dtype, 2, S, H, KV, D, seed=1,
                            strided=strided)
    out, lse = tflash._flash_fwd(q, k, v, causal)
    delta = tflash._delta(out, dout)

    def kernels():
        return (tflash.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                              causal),
                *tflash.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                causal))

    got, again = kernels(), kernels()
    torch.cuda.synchronize()
    _check_grads(dtype, got, tflash.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, causal))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES, ids=str)
@pytest.mark.parametrize("causal,S,H,KV,D,softcap", [
    (True, 1024, 8, 2, 128, 0.0), (True, 1024, 8, 2, 128, 50.0),
    (False, 256, 4, 4, 256, 50.0), (True, 384, 8, 1, 128, 30.0)])
def test_splash_matches_plain_on_card(cuda_device, dtype, causal, S, H, KV,
                                      D, softcap):
    """B4 in ``dtype`` (forward, dq, dk/dv; the scores scaled to reach the
    cap) against its plain versions, the backward bit for bit twice."""
    q, k, v, dout = _inputs(cuda_device, dtype, 2, S, H, KV, D, seed=2)
    qs = q * (D ** -0.5 * (softcap / 4 if softcap else 1.0))
    out, lse = tsa._splash_fwd(qs, k, v, causal, softcap, 128, 128)
    ref_out, ref_lse = tflash.flash_attention_reference(
        qs, k, v, causal, 128, 128, softcap, 1.0)
    assert _max_err(out, ref_out) <= LIMITS[dtype][0]
    _check_lse(dtype, lse, ref_lse)
    delta = tflash._delta(out, dout)

    def kernels():
        return (tsa.splash_attention_bwd_dq(qs, k, v, dout, lse, delta,
                                            causal, softcap),
                *tsa.splash_attention_bwd_dkv(qs, k, v, dout, lse, delta,
                                              causal, softcap))

    got, again = kernels(), kernels()
    torch.cuda.synchronize()
    _check_grads(dtype, got, tflash.flash_attention_bwd_reference(
        qs, k, v, out, lse, dout, causal, 128, 128, softcap, 1.0))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES, ids=str)
def test_autograd_through_mha_and_splash_mha_on_card(cuda_device, dtype):
    """``mha`` at S=1024 and ``splash_mha`` take the kernels for ``dtype``
    (their launches counted under it), and ``out.sum().backward()`` (a
    stride-0 dO) gives the plain versions' gradients."""
    q, k, v, _ = _inputs(cuda_device, dtype, 1, 1024, 4, 2, 128, seed=3)
    tag = SUFFIX[dtype]
    for fn, counters in (
            (tattn.mha,
             (tflash.flash_attention, tflash.flash_attention_bwd_dq,
              tflash.flash_attention_bwd_dkv)),
            (tsa.splash_mha,
             (tsa.splash_attention, tsa.splash_attention_bwd_dq,
              tsa.splash_attention_bwd_dkv))):
        before = [c.launches_by_dtype[tag] for c in counters]
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves).sum().backward()
        torch.cuda.synchronize()
        assert [c.launches_by_dtype[tag] for c in counters] == [
            n + 1 for n in before]
        with torch.no_grad():
            out, lse = tflash.flash_attention_reference(q, k, v, True)
            want = tflash.flash_attention_bwd_reference(
                q, k, v, out, lse, torch.ones_like(out), True)
        _check_grads(dtype, [t.grad for t in leaves], want)


@pytest.mark.cuda
def test_other_types_raise_on_card(cuda_device):
    """f64 and mixed types raise before any launch, in every wrapper."""
    q, k, v, dout = _inputs(cuda_device, torch.float64, 1, 256, 4, 2, 128)
    before = tflash.flash_attention.launches
    with pytest.raises(ValueError, match="bf16, f16, f32"):
        tflash._flash_fwd(q, k, v, True)
    with pytest.raises(ValueError, match="one dtype"):
        tflash._flash_fwd(q.float(), k.half(), v.half(), True)
    stats = torch.zeros((1, 4, 256), device=cuda_device)
    with pytest.raises(ValueError, match="bf16, f16, f32"):
        tflash.flash_attention_bwd_dq(q, k, v, dout, stats, stats)
    with pytest.raises(ValueError, match="bf16, f16, f32"):
        tsa.splash_mha(q, k, v)
    assert tflash.flash_attention.launches == before
