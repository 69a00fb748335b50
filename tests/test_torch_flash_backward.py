"""The port's flash-attention backward (plain versions of kernels B2 and B3,
on CPU tensors) against the JAX package's, on the same numpy inputs.

At blocks of 128 the JAX package's backward is its Pallas B2/B3 kernels,
run in interpret mode as tests/test_ops.py runs them; at blocks of 32 it is
the ``_bwd_blockwise`` scan.  Comparison in float32, within 1e-4 of each
gradient's largest magnitude (tests/test_ops.py's tolerance for the same
kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jflash
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tflash

RTOL = 1e-4


def _inputs(B=2, S=256, H=4, KV=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                          (B, S, H, D))]


def _port_grads(q, k, v, gup, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, **kw)
    return torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(gup))


def _jax_grads(q, k, v, gup, **kw):
    def f(q, k, v):
        return (jflash.flash_attention(q, k, v, interpret=True, **kw)
                * gup).sum()

    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _assert_close(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < RTOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [2, 4])
def test_flash_grads_match_jax_pallas_interpret(causal, kv):
    q, k, v, gup = _inputs(KV=kv)
    kw = dict(causal=causal, block_q=128, block_kv=128)
    _assert_close(_port_grads(q, k, v, gup, **kw),
                  _jax_grads(q, k, v, gup, **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax_blockwise(causal):
    """Blocks of 32 at S=64: the JAX backward is the blockwise scan."""
    q, k, v, gup = _inputs(S=64)
    kw = dict(causal=causal, block_q=32, block_kv=32)
    _assert_close(_port_grads(q, k, v, gup, **kw),
                  _jax_grads(q, k, v, gup, **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_pallas_on_the_same_residuals(causal):
    """flash_attention_bwd_reference against ``_flash_bwd_pallas`` given the
    same out, lse and dO: dq, and dk/dv folded over the GQA group."""
    q, k, v, g = _inputs(S=256, H=8, KV=2)
    qj, kj, vj, gj = (jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v, g))
    out, lse = jflash._flash_fwd(qj, kj, vj, causal, 128, 128, True)
    want = jflash._flash_bwd_pallas(qj, kj, vj, out, lse, gj, causal, 128,
                                    128, True)
    got = tflash.flash_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(out.swapaxes(1, 2))),
        torch.from_numpy(np.array(lse)), torch.from_numpy(g), causal, 128,
        128)
    _assert_close(got, [np.asarray(w).swapaxes(1, 2) for w in want])


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_seq_grads_match_plain_attention(causal):
    """S not a multiple of the tile: the JAX wrapper falls back to plain
    attention there, so the port is held to its own ``attend``'s autograd."""
    q, k, v, gup = _inputs(S=100, KV=2)
    got = _port_grads(q, k, v, gup, causal=causal, block_q=64, block_kv=32)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = torch.autograd.grad(tattn.attend(qt, kt, vt, causal=causal),
                               (qt, kt, vt), torch.from_numpy(gup))
    _assert_close(got, [w.numpy() for w in want])


def test_non_contiguous_dout_and_the_grad_fn():
    q, k, v, gup = _inputs(S=64)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, block_q=32, block_kv=32)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    g_nc = torch.from_numpy(np.ascontiguousarray(gup.swapaxes(1, 2)))
    got = torch.autograd.grad(out, (qt, kt, vt), g_nc.transpose(1, 2))
    want = _port_grads(q, k, v, gup, block_q=32, block_kv=32)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_backward_never_takes_the_plain_version(monkeypatch):
    """The backward dispatches on the device like the forward: a CUDA
    tensor goes to the kernels (which check their inputs and raise), never
    to the plain version."""
    def no_plain(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    class _FakeCuda:
        type = "cuda"

    class _T:
        device = _FakeCuda()
        dtype = torch.bfloat16

        def float(self):
            return torch.zeros(1, 1, 1, 1)

        def to(self, dtype):
            return self

    def kernel_path(*a, **k):
        raise RuntimeError("kernel path")

    monkeypatch.setattr(tflash, "flash_attention_bwd_reference", no_plain)
    monkeypatch.setattr(tflash, "flash_attention_bwd_dq", kernel_path)
    monkeypatch.setattr(tflash, "_kernel_strides", lambda t: t)
    with pytest.raises(RuntimeError, match="kernel path"):
        tflash._flash_bwd(_T(), None, None, _T(), None, _T())


@pytest.mark.parametrize("change,match", [
    (dict(dout_dtype=torch.float32), "dout"),
    (dict(lse_shape=(1, 4, 16)), "lse"),
    (dict(delta_dtype=torch.bfloat16), "delta"),
])
def test_backward_kernel_input_checks_raise(change, match):
    """What the backward kernels do not take raises before any launch."""
    q = torch.zeros((1, 32, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 32, 2, 64), dtype=torch.bfloat16)
    dout = torch.zeros_like(q, dtype=change.get("dout_dtype", torch.bfloat16))
    lse = torch.zeros(change.get("lse_shape", (1, 4, 32)))
    delta = torch.zeros((1, 4, 32), dtype=change.get("delta_dtype",
                                                     torch.float32))
    with pytest.raises(ValueError, match=match):
        tflash._check_bwd_inputs(q, k, k.clone(), dout, lse, delta)
