"""Splash attention: kernel B4, written by hand for Hopper, and its plain
PyTorch versions.

Counterpart of ``ray_tpu/ops/splash_attention.py``, which wraps the upstream
Pallas splash kernel.  What splash adds over flash attention there is a
logit softcap (scores s become c·tanh(s/c) before the mask), native GQA,
skipping of fully masked tiles and tile sizes of their own for the
backward.  On the card, B4 is the flash kernels' device code compiled once
more with the softcap (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_bwd_dkv.cu``: its
own entry points and kernel names); it reads GQA k/v in place and skips the
tiles past the causal diagonal, with the kernels' own tiles.

Layout as in the rest of ``ops/``: q ``[B, S, H, D]``, k/v ``[B, S, KV,
D]``, output ``[B, S, H, D]`` in q's dtype.  As upstream, the kernel
applies no softmax scale: ``splash_mha`` multiplies q by D^-0.5 in q's
dtype first.

Dispatch contract (``splash_mha``): the attention output, or **None** after
one RuntimeWarning per process when the shape does not tile for splash
(head dim or sequence not a multiple of 128, heads not a multiple of kv
heads) or, on CUDA tensors, when B4 has no instantiation for the head dim
(384, say); the caller then falls back to ``mha``.  Like the reference's,
B4 takes every float type it trains in: bf16, f16 and f32
(``flash_attention.KERNEL_DTYPES``, one entry point per type); any other
dtype on the card raises.  That is decided up front
(``splash_kernel_declines``).  The kernel wrappers themselves raise on
what they do not take, and a kernel that does not build or launch raises:
nothing gives way to the plain version after a failure.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from . import flash_attention as fa

__all__ = ["splash_mha", "splash_supported", "splash_kernel_declines",
           "DEFAULT_BLOCK"]

#: Forward/backward tile edge of the plain versions when the sequence
#: allows it; shrunk to the largest multiple of 128 that divides it.
DEFAULT_BLOCK = 512
#: Head dims B4 is instantiated for (splash takes multiples of 128).
KERNEL_HEAD_DIMS = (128, 256)

_warned = False


def _warn_once(reason: str) -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "splash attention unavailable (%s); falling back to the "
            "flash/plain attention path" % reason,
            RuntimeWarning, stacklevel=3)


def _pick_block(seq: int, cap: int) -> int:
    """Largest multiple of 128 that is <= cap and divides seq."""
    best = 128
    b = 128
    while b <= min(cap, seq):
        if seq % b == 0:
            best = b
        b += 128
    return best


def splash_supported(seq_q: int, seq_kv: int, num_heads: int,
                     num_kv_heads: int, head_dim: int) -> Optional[str]:
    """None when the shape tiles for the splash kernel, else the reason."""
    if head_dim % 128 != 0:
        return f"head_dim={head_dim} not a multiple of 128"
    if seq_q % 128 != 0 or seq_kv % 128 != 0:
        return f"seq ({seq_q}, {seq_kv}) not a multiple of 128"
    if num_kv_heads < 1 or num_heads % num_kv_heads != 0:
        return f"heads {num_heads} not a multiple of kv heads {num_kv_heads}"
    return None


def splash_kernel_declines(is_cuda: bool, dtype: torch.dtype,
                           head_dim: int) -> Optional[str]:
    """None when ``splash_mha`` can run inputs of this device, dtype and
    head dim, else the reason it declines: B4 has no instantiation for the
    head dim (``KERNEL_HEAD_DIMS``).  It declines no dtype, as the
    reference's splash declines none: the kernel takes bf16, f16 and f32,
    and its wrappers raise on any other.  CPU tensors take the plain
    versions, which take any."""
    del dtype
    if not is_cuda:
        return None
    if head_dim not in KERNEL_HEAD_DIMS:
        return (f"the splash kernel has no head_dim={head_dim} (it has "
                f"{KERNEL_HEAD_DIMS})")
    return None


class _SplashAttention(torch.autograd.Function):
    """out = splash(qs, k, v) on a pre-scaled q; the backward recomputes P
    from lse: Δ = rowsum(O∘dO) in f32, then B4's dq and dk/dv."""

    @staticmethod
    def forward(ctx, qs, k, v, causal, softcap, blocks):
        out, lse = _splash_fwd(qs, k, v, causal, softcap, *blocks[:2])
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.causal, ctx.softcap, ctx.blocks = causal, softcap, blocks
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _splash_bwd(qs, k, v, out, lse, dout, ctx.causal,
                                 ctx.softcap, *ctx.blocks[2:])
        return dq, dk, dv, None, None, None


def splash_attention(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, softcap: float = 0.0,
                     blocks: Tuple[int, int, int, int] = (512,) * 4
                     ) -> torch.Tensor:
    """The splash kernel's function on a pre-scaled ``qs`` [B, S, H, D] and
    k/v [B, S, KV, D] -> out [B, S, H, D]; differentiable in all three.

    ``blocks`` = (block_q, block_kv, block_q_bwd, block_kv_bwd) tile the
    plain versions (CPU tensors); the CUDA kernels fix their own tiles
    (``flash_attention``'s), sizes their shared-memory and register budgets
    set.  ``launches`` counts B4's forward launches and
    ``launches_by_dtype`` them per type (``splash_attention_bwd_dq`` and
    ``splash_attention_bwd_dkv`` count its backward's).
    """
    return _SplashAttention.apply(qs, k, v, causal, float(softcap),
                                  tuple(blocks))


fa._counters(splash_attention)


def _splash_fwd(qs, k, v, causal: bool, softcap: float, block_q: int,
                block_kv: int):
    """-> (out [B, S, H, D], lse [B, H, S] f32)."""
    if qs.device.type == "cpu":
        return fa.flash_attention_reference(qs, k, v, causal, block_q,
                                            block_kv, softcap, 1.0)
    if qs.device.type != "cuda":
        raise ValueError(f"splash attention runs on cpu or cuda, not "
                         f"{qs.device}")
    out, lse = fa._fwd_launch("splash_attention_fwd", qs, k, v, causal,
                              1.0, softcap, head_dims=KERNEL_HEAD_DIMS)
    fa._count(splash_attention, qs.dtype)
    return out, lse


def _splash_bwd(qs, k, v, out, lse, dout, causal: bool, softcap: float,
                block_q: int, block_kv: int):
    """-> (dq [B, S, H, D], dk, dv [B, S, KV, D])."""
    if qs.device.type == "cpu":
        return fa.flash_attention_bwd_reference(qs, k, v, out, lse, dout,
                                                causal, block_q, block_kv,
                                                softcap, 1.0)
    if qs.device.type != "cuda":
        raise ValueError(f"splash attention runs on cpu or cuda, not "
                         f"{qs.device}")
    delta = fa._delta(out, dout)
    g = fa._kernel_strides(dout.to(qs.dtype))
    dq = splash_attention_bwd_dq(qs, k, v, g, lse, delta, causal, softcap)
    dk, dv = splash_attention_bwd_dkv(qs, k, v, g, lse, delta, causal,
                                      softcap)
    return dq, dk, dv


def splash_attention_bwd_dq(qs, k, v, dout, lse, delta, causal: bool = True,
                            softcap: float = 0.0) -> torch.Tensor:
    """B4's dq on the card from a pre-scaled qs, k, v, dO (one dtype of
    ``flash_attention.KERNEL_DTYPES``), lse and Δ ([B, H, S] f32).
    ``launches`` counts its launches, ``launches_by_dtype`` them per
    type."""
    dq = fa._dq_launch("splash_attention_bwd_dq", qs, k, v, dout, lse,
                       delta, causal, 1.0, softcap,
                       head_dims=KERNEL_HEAD_DIMS)
    fa._count(splash_attention_bwd_dq, qs.dtype)
    return dq


fa._counters(splash_attention_bwd_dq)


def splash_attention_bwd_dkv(qs, k, v, dout, lse, delta, causal: bool = True,
                             softcap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4's dk and dv on the card, each summed over the q heads of its GQA
    group.  ``launches`` counts its launches, ``launches_by_dtype`` them
    per type."""
    dk, dv = fa._dkv_launch("splash_attention_bwd_dkv", qs, k, v, dout,
                            lse, delta, causal, 1.0, softcap,
                            head_dims=KERNEL_HEAD_DIMS)
    fa._count(splash_attention_bwd_dkv, qs.dtype)
    return dk, dv


fa._counters(splash_attention_bwd_dkv)


def splash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, logit_softcap: float = 0.0,
               mesh=None, batch_axes: Tuple[str, ...] = ("dp", "fsdp"),
               manual: bool = False, interpret: Optional[bool] = None,
               block_q: int = DEFAULT_BLOCK, block_kv: int = DEFAULT_BLOCK,
               block_q_bwd: Optional[int] = None,
               block_kv_bwd: Optional[int] = None
               ) -> Optional[torch.Tensor]:
    """Splash attention over [B, S, H, D] q and [B, S, KV, D] k/v.

    Returns None (after one RuntimeWarning per process) when the shape does
    not tile for splash, or when the kernel does not take these CUDA
    tensors (``splash_kernel_declines``); the caller is expected to fall
    back to ``mha``.
    The block sizes tile the plain versions (CPU tensors), forward and
    backward apart; on the card the kernel's own tiles apply.  With a
    ``mesh`` (the counterpart of the reference's ``_shard_map_call``), q,
    k and v are cut over the mesh's ``batch_axes`` (rows; the heads stay
    whole) unless they are ``Sharded`` already, and every device runs this
    function on its own rows, as the mesh trunk calls it per device: the
    output is ``Sharded`` like q.  ``manual`` and ``interpret`` are
    accepted for the JAX signature and ignored: there is no shard_map and
    no interpret mode here.
    """
    del manual, interpret
    kw = dict(causal=causal, logit_softcap=logit_softcap, block_q=block_q,
              block_kv=block_kv, block_q_bwd=block_q_bwd,
              block_kv_bwd=block_kv_bwd)
    if mesh is not None:
        return _per_device(q, k, v, mesh, batch_axes, kw)
    b, seq_q, num_heads, head_dim = q.shape
    seq_kv, num_kv = k.shape[1], k.shape[2]
    reason = (splash_supported(seq_q, seq_kv, num_heads, num_kv, head_dim)
              or splash_kernel_declines(q.is_cuda, q.dtype, head_dim))
    if reason is not None:
        _warn_once(reason)
        return None
    blocks = (_pick_block(seq_q, block_q), _pick_block(seq_kv, block_kv),
              _pick_block(seq_q, block_q_bwd or block_q),
              _pick_block(seq_kv, block_kv_bwd or block_kv))
    # the kernel applies no softmax scale itself; fold 1/sqrt(D) into q
    qs = q * (head_dim ** -0.5)
    out = splash_attention(qs, k, v, causal, logit_softcap, blocks)
    return out.to(q.dtype)


def _per_device(q, k, v, mesh, batch_axes, kw):
    """``splash_mha`` on each device's rows of the batch axes -> a
    ``Sharded`` output, or None when it declines."""
    from ..parallel.mesh import NamedSharding, PartitionSpec, Sharded
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    sh = NamedSharding(mesh, PartitionSpec(axes or None))
    q, k, v = (x if isinstance(x, Sharded) else Sharded(
        [x[sl].to(d) for sl, d in zip(sh.slices(x.shape), mesh.device_list)],
        sh) for x in (q, k, v))
    outs = [splash_mha(*p, **kw) for p in zip(q.parts, k.parts, v.parts)]
    return None if any(o is None for o in outs) else Sharded(outs, q.sharding)
