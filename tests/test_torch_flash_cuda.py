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
                                        (True, 1000, 128), (True, 192, 256)])
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


def _kernel_bwd(q, k, v, out, lse, dout, causal):
    delta = tflash._delta(out, dout)
    dq = tflash.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal)
    torch.cuda.synchronize()
    return dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,H,KV,D", [
    (True, 1024, 8, 2, 128), (False, 256, 8, 8, 64), (True, 1000, 8, 2, 128),
    (False, 320, 4, 2, 256), (True, 192, 4, 1, 256)])
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
