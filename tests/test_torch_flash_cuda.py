"""The flash kernels against their plain versions on a CUDA card.

Needs the card (the kernels have no CPU mode), so every test here is marked
``cuda`` and skips without one.  The file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tflash

# dq/dk/dv in bf16 against the plain version, as a share of the largest
# magnitude of the plain version's result: P and dS round to bf16 at other
# tile boundaries and f32 sums run in another order.
GRAD_RTOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, B, S, H, KV, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                          (B, S, H, D))]


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,D", [(True, 1024, 128), (False, 256, 64),
                                        (True, 1000, 128), (True, 192, 256),
                                        (True, 1088, 128), (False, 200, 128)])
def test_flash_kernel_matches_plain_on_card(cuda_device, causal, S, D):
    """bf16 on the card: out within 2e-2, lse within 1e-3 of the plain
    version (bf16 rounding of P at other tile boundaries)."""
    q, k, v, _ = _inputs(cuda_device, 2, S, 8, 2, D)
    before = tflash.flash_attention.launches
    out, lse = tflash._flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    ref_out, ref_lse = tflash.flash_attention_reference(q, k, v, causal)
    assert (out.float() - ref_out.float()).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_kernel_on_strided_views_matches_plain_on_card(cuda_device, D):
    """q, k and v as head slices of one fused [B, S, H + 2 KV, D] tensor
    (non-contiguous, as a fused qkv projection leaves them): the kernel's
    TMA maps follow the strides, and out and lse match the plain version on
    the same views."""
    H, KV = 8, 2
    qkv = _inputs(cuda_device, 2, 1088, H + 2 * KV, 1, D)[0]
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    out, lse = tflash._flash_fwd(q, k, v, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = tflash.flash_attention_reference(q, k, v, True)
    assert (out.float() - ref_out.float()).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_launches_keep_the_callers_current_device():
    """B1, B2 and B3 on a second card leave the thread's current device
    where the caller set it (the C entries set their tensors' device; the
    wrappers restore the caller's), and compute what they compute on the
    first card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    q, k, v, dout = _inputs(torch.device("cuda", 1), 2, 1024, 8, 2, 128)
    out, lse = tflash._flash_fwd(q, k, v, True)
    assert torch.cuda.current_device() == 0
    dq, dk, dv = _kernel_bwd(q, k, v, out, lse, dout, True)
    assert torch.cuda.current_device() == 0
    on_0 = [t.to("cuda:0") for t in (q, k, v, dout)]
    out0, lse0 = tflash._flash_fwd(*on_0[:3], True)
    grads0 = _kernel_bwd(*on_0[:3], out0, lse0, on_0[3], True)
    assert torch.equal(out.cpu(), out0.cpu()) and torch.equal(lse.cpu(),
                                                              lse0.cpu())
    assert all(torch.equal(a.cpu(), b.cpu())
               for a, b in zip((dq, dk, dv), grads0))


def _kernel_bwd(q, k, v, out, lse, dout, causal):
    delta = tflash._delta(out, dout)
    dq = tflash.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal)
    torch.cuda.synchronize()
    return dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,H,KV,D", [
    (True, 1024, 8, 2, 128), (False, 256, 8, 8, 64), (True, 1000, 8, 2, 128),
    (False, 320, 4, 2, 256), (True, 192, 4, 1, 256),
    (True, 1088, 8, 2, 128)])
def test_flash_backward_kernels_match_plain_on_card(cuda_device, causal, S,
                                                    H, KV, D):
    """B2 and B3 against the plain backward on the same residuals, and two
    runs of the kernels give the same bits (no atomics)."""
    q, k, v, dout = _inputs(cuda_device, 2, S, H, KV, D)
    out, lse = tflash._flash_fwd(q, k, v, causal)
    before = (tflash.flash_attention_bwd_dq.launches,
              tflash.flash_attention_bwd_dkv.launches)
    got = _kernel_bwd(q, k, v, out, lse, dout, causal)
    assert (tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                         before[1] + 1)
    want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_RTOL, (name, _rel_err(a, b))
    again = _kernel_bwd(q, k, v, out, lse, dout, causal)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,H,KV,D", [
    (True, 64, 8, 2, 128),      # the upper warpgroup has no live row
    (False, 64, 8, 2, 64),      # one K/V stage
    (False, 128, 8, 2, 128),    # one q tile, non-causal
    (True, 1088, 4, 2, 256),    # 64 rows past a 1024-row boundary
    (True, 256, 16, 4, 256),    # GQA reps 4
    (True, 200, 4, 1, 128)])    # ragged inside the only q tile
def test_dq_kernel_edges_match_plain_on_card(cuda_device, causal, S, H, KV,
                                             D):
    """B2 at the edges of its tiles: q tiles of 128 rows over two
    warpgroups (64 at D=256), K/V stages of 64 rows.  dq within GRAD_RTOL
    of the plain version, and the same bits on a second run."""
    q, k, v, dout = _inputs(cuda_device, 2, S, H, KV, D, seed=4)
    out, lse = tflash._flash_fwd(q, k, v, causal)
    delta = tflash._delta(out, dout)
    got = tflash.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
    again = tflash.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
    torch.cuda.synchronize()
    want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                causal)[0]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < GRAD_RTOL, _rel_err(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_backward_kernels_on_strided_views_match_plain_on_card(
        cuda_device, D):
    """q, k and v as head slices of one fused [B, S, H + 2 KV, D] tensor
    and dO as a transposed view of a [B, H, S, D] tensor: B2 and B3 read
    them through their strides (B3 through TMA maps), match the plain
    backward on the same views and repeat bit for bit."""
    H, KV, S = 8, 2, 1088
    qkv = _inputs(cuda_device, 2, S, H + 2 * KV, 1, D)[0]
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    dout = torch.randn((2, H, S, D), generator=g, device=cuda_device,
                       dtype=torch.bfloat16).transpose(1, 2)
    assert not (q.is_contiguous() or dout.is_contiguous())
    out, lse = tflash._flash_fwd(q, k, v, True)
    got = _kernel_bwd(q, k, v, out, lse, dout, True)
    want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, dout, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_RTOL, (name, _rel_err(a, b))
    again = _kernel_bwd(q, k, v, out, lse, dout, True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sum_of_bf16_output_backward_on_card(cuda_device):
    """``out.sum().backward()`` hands the backward a dO expanded from one
    scalar (stride 0), which no TMA map can read: the wrapper copies it,
    and the gradients match the plain version's."""
    q, k, v, _ = _inputs(cuda_device, 2, 1024, 8, 2, 128, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tflash.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    out.sum().backward()
    torch.cuda.synchronize()
    with torch.no_grad():
        ref_out, ref_lse = tflash.flash_attention_reference(q, k, v, True)
        want = tflash.flash_attention_bwd_reference(
            q, k, v, ref_out, ref_lse, torch.ones_like(ref_out), True)
    for name, t, b in zip(("dq", "dk", "dv"), (q, k, v), want):
        assert torch.isfinite(t.grad).all(), name
        assert _rel_err(t.grad, b) < GRAD_RTOL, (name, _rel_err(t.grad, b))


@pytest.mark.cuda
def test_requires_grad_on_card_gives_kernel_gradients(cuda_device):
    """The dropped-gradient fault: on the card, flash_attention with inputs
    that require grad runs B1, B2 and B3, and its gradients match the plain
    forward and backward versions."""
    q, k, v, dout = _inputs(cuda_device, 2, 1024, 8, 2, 128, seed=1)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (tflash.flash_attention.launches,
              tflash.flash_attention_bwd_dq.launches,
              tflash.flash_attention_bwd_dkv.launches)
    out = tflash.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (tflash.flash_attention.launches,
            tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches) == tuple(
                c + 1 for c in counts)
    with torch.no_grad():
        ref_out, ref_lse = tflash.flash_attention_reference(q, k, v, True)
        want = tflash.flash_attention_bwd_reference(q, k, v, ref_out, ref_lse,
                                                    dout, True)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert _rel_err(a, b) < GRAD_RTOL, (name, _rel_err(a, b))
