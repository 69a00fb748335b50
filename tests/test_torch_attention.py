"""The port's attention ops against the JAX package's, on the same inputs.

Inputs are made with numpy from a seed and handed to both packages; the
comparison is in float32.  The JAX flash kernel runs in Pallas interpret
mode on the CPU, as tests/test_ops.py runs it; the port's flash wrapper
runs its plain version there (CPU tensors).  Tolerances: 2e-5 on attention
outputs (tests/test_ops.py's), 1e-5 on lse, and 2^-8 (a bf16 ulp below 1)
on outputs from bf16 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import flash_attention as jflash
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tflash


def _qkv(B=2, S=128, H=4, KV=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal,kv,softcap", [
    (True, 2, 0.0), (False, 2, 0.0), (True, 4, 0.0), (True, 2, 30.0),
    (False, 1, 5.0)])
def test_attend_matches_jax(causal, kv, softcap):
    q, k, v = _qkv(S=48, KV=kv)
    want = jattn.attend(*_j(q, k, v), causal=causal, logit_softcap=softcap)
    got = tattn.attend(*_t(q, k, v), causal=causal, logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_repeat_kv_matches_jax():
    _, k, _ = _qkv(KV=2)
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(k), 4).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(k), 4)))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_interpret(causal):
    q, k, v = _qkv()
    want = jflash.flash_attention(*_j(q, k, v), causal=causal, interpret=True)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_small_blocks_match_jax_interpret(causal):
    q, k, v = _qkv(S=64)
    want = jflash.flash_attention(*_j(q, k, v), causal=causal, block_q=32,
                                  block_kv=16, interpret=True)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal, block_q=32,
                                 block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("block", [64, 128])
def test_flash_reference_rounds_p_per_tile_as_jax_bf16(block):
    """bf16 inputs: the plain version on block x block tiles rounds P to
    bf16 where the JAX kernel on the same tiles does, so out agrees to a
    bf16 ulp of its values (< 1) and lse to 1e-5."""
    q, k, v = (a.astype(jnp.bfloat16) for a in _j(*_qkv(S=256)))
    want = jflash.flash_attention(q, k, v, causal=True, block_q=block,
                                  block_kv=block, interpret=True)
    want_lse = jflash._flash_fwd(*(a.swapaxes(1, 2) for a in (q, k, v)),
                                 True, block, block, True)[1]
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .bfloat16() for a in (q, k, v))
    got, got_lse = tflash.flash_attention_reference(tq, tk, tv, True, block,
                                                    block)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -8)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax(causal):
    q, k, v = _qkv()
    qj, kj, vj = (jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v))
    want = jflash._flash_fwd(qj, kj, vj, causal, 512, 512, True)[1]
    got = tflash._flash_fwd(*_t(q, k, v), causal)[1]
    assert got.shape == (2, 4, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_seq_matches_plain_attention(causal):
    """S not a multiple of the tile: the JAX wrapper falls back to plain
    attention there, so the port's flash is held to plain attention."""
    q, k, v = _qkv(S=100)
    want = jattn.attend(*_j(q, k, v), causal=causal)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal, block_q=64,
                                 block_kv=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_mha_use_flash_reaches_flash(monkeypatch):
    q, k, v = _t(*_qkv(S=32))
    calls = []
    real = tflash.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention", spy)
    out = tattn.mha(q, k, v, use_flash=True)
    assert calls == [q.shape]
    np.testing.assert_allclose(out.numpy(), tattn.attend(q, k, v).numpy(),
                               atol=2e-5)
    # on CPU tensors the automatic dispatch takes the plain path
    tattn.mha(*_t(*_qkv(S=1024, B=1, H=2, KV=1)))
    assert len(calls) == 1
    with pytest.raises(ValueError, match="softcap"):
        tattn.mha(q, k, v, logit_softcap=5.0, use_flash=True)


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float64), "bf16"),
    (dict(D=96), "D in"),
    (dict(skv=64), "Sq == Skv"),
    (dict(kv=3), "do not group"),
])
def test_kernel_input_checks_raise(change, match):
    """What the kernel does not take raises before any launch."""
    dt = change.get("dtype", torch.bfloat16)
    d = change.get("D", 64)
    kv = change.get("kv", 2)
    q = torch.zeros((1, 32, 4, d), dtype=dt)
    k = torch.zeros((1, change.get("skv", 32), kv, d), dtype=dt)
    with pytest.raises(ValueError, match=match):
        tflash._check_kernel_inputs(q, k, k.clone())


def test_kernel_input_checks_raise_on_strides_tma_cannot_take():
    """The forward reads q/k/v through TMA maps: a broadcast kv head
    (stride 0) raises before any launch, while a head slice of a fused
    [B, S, H + 2 KV, D] tensor (real, non-contiguous strides) passes."""
    q = torch.zeros((1, 32, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 32, 1, 64), dtype=torch.bfloat16).expand(1, 32, 2, 64)
    with pytest.raises(ValueError, match="stride"):
        tflash._check_kernel_inputs(q, k, k.contiguous())
    with pytest.raises(ValueError, match="stride"):
        tflash._check_kernel_inputs(q, k.contiguous(), k)
    qkv = torch.zeros((1, 32, 8, 64), dtype=torch.bfloat16)
    tflash._check_kernel_inputs(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])
