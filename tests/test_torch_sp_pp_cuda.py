"""Ring attention and the pipeline through the flash kernels on a CUDA card,
against the same calls through the kernels' plain versions.

Needs the card (the kernels have no CPU mode), so every test here is marked
``cuda`` and skips without one.  The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sp_pp_cuda.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import ring_attention as tring
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpp
from ray_tpu_torch.parallel import train_step as tts

# bf16 against the plain versions: out within 2e-2, dq/dk/dv within 2e-2
# of the plain result's largest magnitude, a step's loss within 1e-3
OUT_ATOL, GRAD_RTOL, LOSS_ATOL = 2e-2, 2e-2, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _plain_ring(monkeypatch):
    monkeypatch.setattr(tring, "_flash_fwd",
                        lambda q, k, v, causal: tflash.
                        flash_attention_reference(q, k, v, causal))
    monkeypatch.setattr(tring, "_flash_bwd_stats",
                        tflash.flash_bwd_stats_reference)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_kernels_match_plain_on_card(cuda_device, monkeypatch, causal):
    mesh = tmesh.MeshSpec(sp=2, fsdp=1).build([cuda_device] * 2)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_()
               for shape in ((2, 512, 8, 128), (2, 512, 2, 128),
                             (2, 512, 2, 128)))
    dout = torch.randn(q.shape, generator=g, device=cuda_device,
                       dtype=torch.bfloat16)

    def run():
        out = tring.ring_attention(q, k, v, mesh, "sp", causal=causal)
        loss = sum((p.float() * dout[sl].float()).sum() for p, sl in
                   zip(out.parts, out.sharding.slices(dout.shape)))
        return (out.full(cuda_device), *torch.autograd.grad(loss, (q, k, v)))

    before = (tflash.flash_attention.launches,
              tflash.flash_attention_bwd_dq.launches)
    got = run()
    torch.cuda.synchronize()
    hops = 3 if causal else 4
    assert (tflash.flash_attention.launches - before[0],
            tflash.flash_attention_bwd_dq.launches - before[1]) == (hops,
                                                                    hops)
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    _plain_ring(monkeypatch)
    want = run()
    assert (got[0].float() - want[0].float()).abs().max().item() <= OUT_ATOL
    for a, w in zip(got[1:], want[1:]):
        rel = ((a.float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        assert rel <= GRAD_RTOL


class _PlainAttention(torch.autograd.Function):
    """Attention through B1-B3's plain versions, with ``mha``'s result."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = tflash.flash_attention_reference(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*tflash.flash_attention_bwd_reference(q, k, v, out, lse,
                                                      dout, ctx.causal),
                None)


@pytest.mark.cuda
@pytest.mark.parametrize("virtual", [1, 2])
def test_pipeline_steps_kernels_match_plain_on_card(cuda_device, monkeypatch,
                                                    virtual):
    """Two pp=2 steps (M=2) of a 4-layer config with S=1024 and D=128,
    where every stage's attention is B1-B3, against the same steps with
    attention through their plain versions."""
    cfg = tcfg.tiny(vocab=512, layers=4, hidden=512, heads=4, seq=1024)
    mesh = tmesh.MeshSpec(pp=2, fsdp=1).build([cuda_device] * 2)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, cfg.max_seq_len + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def run():
        opt = tts.make_optimizer(warmup_steps=1, total_steps=10)
        state, sh = tpp.init_pp_state(cfg, mesh, opt, seed=0,
                                      virtual_stages=virtual)
        step = tpp.make_pp_train_step(cfg, mesh, opt, sh,
                                      num_microbatches=2,
                                      virtual_stages=virtual)
        return [float(step(state, batch)[1]["loss"]) for _ in range(2)]

    before = tflash.flash_attention.launches
    got = run()
    # each layer once per microbatch, forward and full remat's replay
    assert tflash.flash_attention.launches - before == 2 * 2 * 2 * 4
    monkeypatch.setattr(ttr, "mha", lambda q, k, v, causal=True,
                        logit_softcap=0.0: _PlainAttention.apply(q, k, v,
                                                                 causal))
    want = run()
    assert all(np.isfinite(got))
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL
