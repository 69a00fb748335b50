"""The flash kernel against its plain version on a CUDA card.

Needs the card (the kernel has no CPU mode), so every test here is marked
``cuda`` and skips without one.  The file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tflash


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,D", [(True, 1024, 128), (False, 256, 64),
                                        (True, 1000, 128), (True, 192, 256)])
def test_flash_kernel_matches_plain_on_card(cuda_device, causal, S, D):
    """bf16 on the card: out within 2e-2, lse within 1e-3 of the plain
    version (bf16 rounding of P at other tile boundaries)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((2, S, 8, D), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    k = torch.randn((2, S, 2, D), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    v = torch.randn((2, S, 2, D), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    before = tflash.flash_attention.launches
    out, lse = tflash._flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    ref_out, ref_lse = tflash.flash_attention_reference(q, k, v, causal)
    assert (out.float() - ref_out.float()).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 1e-3
