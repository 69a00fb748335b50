"""Kernel B4 (splash attention with the logit softcap) against its plain
versions on a CUDA card.

Needs the card (the kernels have no CPU mode), so every test here is marked
``cuda`` and skips without one.  The file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_splash_cuda.py
"""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import splash_attention as tsplash

# bf16 on the card against the plain version: out within 2e-2, lse within
# 1e-3, dq/dk/dv within 2e-2 of the plain version's largest magnitude (P and
# dS round to bf16 at other tile boundaries, f32 sums run in another order)
OUT_ATOL, LSE_ATOL, GRAD_RTOL = 2e-2, 1e-3, 2e-2
# with a softcap c the scores' std is c / 4, so that a row's largest scores
# reach about c, where tanh bends and the backward's factor (1 - t^2) falls
# to about a half: on scores of std 1 a kernel without that factor, or
# without the cap, would still pass GRAD_RTOL at c = 50
CAP_SCORE_STD = 0.25


def _q_scale(D, softcap):
    """splash_mha scales q by D^-0.5 beforehand; with a softcap the scores
    are spread to reach the cap."""
    return D ** -0.5 * (softcap * CAP_SCORE_STD if softcap else 1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the splash kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, B, S, H, KV, D, seed=0, softcap=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev,
                                 dtype=torch.bfloat16)
                     for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                                   (B, S, H, D)))
    return q * _q_scale(D, softcap), k, v, dout


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("causal,S,H,KV,D", [
    (True, 1024, 8, 2, 128), (False, 256, 4, 4, 128),
    (True, 384, 4, 1, 256)])
def test_splash_kernels_match_plain_on_card(cuda_device, causal, S, H, KV,
                                            D, softcap):
    """B4's forward, dq and dk/dv against the plain versions on the same
    residuals; each launch counted once; the backward repeats bit for
    bit."""
    qs, k, v, dout = _inputs(cuda_device, 2, S, H, KV, D, softcap=softcap)
    before = tsplash.splash_attention.launches
    out, lse = tsplash._splash_fwd(qs, k, v, causal, softcap, 128, 128)
    torch.cuda.synchronize()
    assert tsplash.splash_attention.launches == before + 1
    ref_out, ref_lse = tflash.flash_attention_reference(
        qs, k, v, causal, 128, 128, softcap, 1.0)
    assert (out.float() - ref_out.float()).abs().max().item() < OUT_ATOL
    assert (lse - ref_lse).abs().max().item() < LSE_ATOL

    delta = tflash._delta(out, dout)

    def kernels():
        got = (tsplash.splash_attention_bwd_dq(qs, k, v, dout, lse, delta,
                                               causal, softcap),
               *tsplash.splash_attention_bwd_dkv(qs, k, v, dout, lse, delta,
                                                 causal, softcap))
        torch.cuda.synchronize()
        return got

    counts = (tsplash.splash_attention_bwd_dq.launches,
              tsplash.splash_attention_bwd_dkv.launches)
    got = kernels()
    assert (tsplash.splash_attention_bwd_dq.launches,
            tsplash.splash_attention_bwd_dkv.launches) == (counts[0] + 1,
                                                           counts[1] + 1)
    want = tflash.flash_attention_bwd_reference(qs, k, v, out, lse, dout,
                                                causal, 128, 128, softcap,
                                                1.0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_RTOL, (name, _rel_err(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, kernels()))


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("causal,S,H,KV,D", [
    (True, 64, 8, 2, 128),      # the upper warpgroup has no live row
    (False, 128, 8, 2, 128),    # one q tile, non-causal
    (True, 1088, 4, 2, 256),    # 64 rows past a 1024-row boundary
    (True, 256, 16, 4, 256)])   # GQA reps 4
def test_splash_dq_edges_match_plain_on_card(cuda_device, causal, S, H, KV,
                                             D, softcap):
    """B4's dq at the edges of its tiles (q tiles of 128 rows over two
    warpgroups, 64 at D=256; K/V stages of 64 rows): within GRAD_RTOL of the
    plain version, and the same bits on a second run."""
    qs, k, v, dout = _inputs(cuda_device, 2, S, H, KV, D, seed=5,
                             softcap=softcap)
    out, lse = tsplash._splash_fwd(qs, k, v, causal, softcap, 128, 128)
    delta = tflash._delta(out, dout)
    got, again = (tsplash.splash_attention_bwd_dq(qs, k, v, dout, lse, delta,
                                                  causal, softcap)
                  for _ in range(2))
    torch.cuda.synchronize()
    want = tflash.flash_attention_bwd_reference(qs, k, v, out, lse, dout,
                                                causal, 128, 128, softcap,
                                                1.0)[0]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < GRAD_RTOL, _rel_err(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_splash_forward_on_strided_views_matches_plain_on_card(cuda_device,
                                                                softcap):
    """q, k and v as head slices of one fused [B, S, H + 2 KV, D] tensor:
    B4's forward follows the strides through its TMA maps, and out and lse
    match the plain version on the same views."""
    H, KV, D = 8, 2, 128
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((2, 1024, H + 2 * KV, D), generator=g,
                      device=cuda_device, dtype=torch.bfloat16)
    qkv[:, :, :H] *= _q_scale(D, softcap)
    qs, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not (qs.is_contiguous() or k.is_contiguous())
    out, lse = tsplash._splash_fwd(qs, k, v, True, softcap, 128, 128)
    torch.cuda.synchronize()
    ref_out, ref_lse = tflash.flash_attention_reference(
        qs, k, v, True, 128, 128, softcap, 1.0)
    assert (out.float() - ref_out.float()).abs().max().item() < OUT_ATOL
    assert (lse - ref_lse).abs().max().item() < LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_splash_dkv_on_strided_views_matches_plain_on_card(cuda_device,
                                                           softcap):
    """B4's dk/dv on q, k and v as head slices of one fused tensor and dO
    as a transposed view: read through the TMA maps' strides, within
    GRAD_RTOL of the plain version on the same views, bit for bit the same
    on a second run."""
    H, KV, D, S = 8, 2, 128, 1024
    g = torch.Generator(device=cuda_device).manual_seed(4)
    qkv = torch.randn((2, S, H + 2 * KV, D), generator=g,
                      device=cuda_device, dtype=torch.bfloat16)
    qkv[:, :, :H] *= _q_scale(D, softcap)
    qs, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    dout = torch.randn((2, H, S, D), generator=g, device=cuda_device,
                       dtype=torch.bfloat16).transpose(1, 2)
    out, lse = tsplash._splash_fwd(qs, k, v, True, softcap, 128, 128)
    delta = tflash._delta(out, dout)

    def dkv():
        got = tsplash.splash_attention_bwd_dkv(qs, k, v, dout, lse, delta,
                                               True, softcap)
        torch.cuda.synchronize()
        return got

    got = dkv()
    want = tflash.flash_attention_bwd_reference(qs, k, v, out, lse, dout,
                                                True, 128, 128, softcap,
                                                1.0)[1:]
    for name, a, b in zip(("dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_RTOL, (name, _rel_err(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, dkv()))


@pytest.mark.cuda
def test_requires_grad_through_splash_mha_gives_kernel_gradients(cuda_device):
    """A card tensor that requires grad goes through B4 forward and
    backward (and not B1-B3), and its gradients match the plain versions'
    through the same q scaling."""
    q, k, v, dout = _inputs(cuda_device, 2, 1024, 8, 2, 128, seed=1,
                            softcap=50.0)
    q = (q * 128 ** 0.5).detach()   # splash_mha scales it by D^-0.5
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counters = (tsplash.splash_attention, tsplash.splash_attention_bwd_dq,
                tsplash.splash_attention_bwd_dkv, tflash.flash_attention,
                tflash.flash_attention_bwd_dq, tflash.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out = tsplash.splash_mha(q, k, v, causal=True, logit_softcap=50.0)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        1, 1, 1, 0, 0, 0]
    with torch.no_grad():
        qs = q * 128 ** -0.5
        ref_out, ref_lse = tflash.flash_attention_reference(
            qs, k, v, True, 512, 512, 50.0, 1.0)
        dqs, dk, dv = tflash.flash_attention_bwd_reference(
            qs, k, v, ref_out, ref_lse, dout, True, 512, 512, 50.0, 1.0)
    for name, a, b in zip(("dq", "dk", "dv"),
                          grads, (dqs * 128 ** -0.5, dk, dv)):
        assert _rel_err(a, b) < GRAD_RTOL, (name, _rel_err(a, b))


@pytest.mark.cuda
def test_head_dim_the_kernel_lacks_raises(cuda_device, monkeypatch):
    """D=384 tiles for splash (a multiple of 128) but B4 has no such
    instantiation: ``splash_mha`` declines it up front, as it declines a
    shape that does not tile (one RuntimeWarning, then None, and the caller
    takes ``mha``).  B4 takes bf16, f16 and f32; a dtype it does not take
    (f64) raises.  The kernel's wrapper, called directly, still raises."""
    q, k, v, _ = _inputs(cuda_device, 1, 256, 2, 1, 384)
    assert tsplash.splash_supported(256, 256, 2, 1, 384) is None
    monkeypatch.setattr(tsplash, "_warned", False)
    before = tsplash.splash_attention.launches
    with pytest.warns(RuntimeWarning, match="head_dim=384"):
        assert tsplash.splash_mha(q, k, v) is None
    q, k, v, _ = _inputs(cuda_device, 1, 256, 2, 1, 128)
    with pytest.raises(ValueError, match="f32"):
        tsplash.splash_mha(q.double(), k.double(), v.double())
    assert tsplash.splash_attention.launches == before
    q, k, v, _ = _inputs(cuda_device, 1, 256, 2, 1, 384)
    with pytest.raises(ValueError, match="D in"):
        tsplash._splash_fwd(q, k, v, True, 0.0, 128, 128)
