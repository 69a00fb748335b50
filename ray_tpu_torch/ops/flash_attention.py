"""Flash attention, forward and backward: CUDA kernels written by hand for
Hopper, and their plain PyTorch versions.

Counterpart of ``ray_tpu/ops/flash_attention.py``.  Three kernels compute
what the Pallas kernels compute:

* B1 (``csrc/flash_attention_fwd.cu``, ``_fwd_kernel``): an online softmax
  over K/V tiles in f32, causal tiles past the diagonal skipped, GQA K/V
  read in place, P cast to the input dtype for the P·V product; it returns
  out and the log-sum-exp ``lse``.
* B2 (``csrc/flash_attention_bwd.cu``, ``_bwd_dq_kernel``) and B3
  (``csrc/flash_attention_bwd_dkv.cu``, ``_bwd_dkv_kernel``): dq, and dk/dv
  folded over the q heads of a GQA group, with P recomputed from ``lse``
  and Δ = rowsum(dO∘O) computed here in f32, as ``_flash_bwd_pallas`` does.

``flash_attention`` is a ``torch.autograd.Function``: its forward saves q,
k, v, out and lse, and its backward runs B2 and B3.  Dispatch is by the
tensors' device only: a CPU tensor takes the plain versions (which repeat
the kernels' arithmetic tile by tile), a CUDA tensor launches the kernels or
raises on what they do not take.  There is no fallback from one to the
other.

The same sources hold the splash kernel B4 (``ops/splash_attention.py``):
B1-B3's device code with a logit softcap, behind entry points of its own.
The plain versions here take ``softcap`` and ``scale`` for it; at their
defaults (0, D^-0.5) they compute B1-B3's function.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF

KERNEL_HEAD_DIMS = (64, 128, 256)


def _bind_entries(lib: ctypes.CDLL, flash: str, splash: str, head) -> None:
    """argtypes of one flash entry point (``head`` then causal, scale and
    the stream) and of its splash twin (the softcap before the stream)."""
    getattr(lib, flash).argtypes = head + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    getattr(lib, splash).argtypes = head + [ctypes.c_int, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_void_p]
    getattr(lib, flash).restype = getattr(lib, splash).restype = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    _bind_entries(lib, "flash_attention_fwd_bf16", "splash_attention_fwd_bf16",
                  [ctypes.c_int] + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12)
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _bind_bwd_dq(lib: ctypes.CDLL) -> None:
    _bind_entries(lib, "flash_attention_bwd_dq_bf16",
                  "splash_attention_bwd_dq_bf16",
                  [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] * 15)
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p


def _bind_bwd_dkv(lib: ctypes.CDLL) -> None:
    _bind_entries(lib, "flash_attention_bwd_dkv_bf16",
                  "splash_attention_bwd_dkv_bf16",
                  [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] * 18)
    lib.flash_attention_bwd_dkv_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_dkv_error_string.restype = ctypes.c_char_p


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); the backward recomputes P from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv):
        out, lse = _flash_fwd(q, k, v, causal, block_q, block_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_q, ctx.block_kv = causal, block_q, block_kv
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, ctx.causal,
                                ctx.block_q, ctx.block_kv)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512) -> torch.Tensor:
    """Flash attention. q: [B, S, H, D], k/v: [B, S, KV, D] -> [B, S, H, D].

    Differentiable in q, k and v.  ``block_q``/``block_kv`` are the plain
    versions' tiles; the CUDA kernels fix their own (the forward 128 q rows
    against 128 K/V rows, 64 at D=256; dq 128 q rows, 64 at D=256, against
    64 K/V rows; dk/dv 128 kv rows, 64 at D=256, against 64 q rows), sizes
    their shared-memory and register budgets set.  ``launches`` counts B1's launches
    (``flash_attention_bwd_dq.launches`` and
    ``flash_attention_bwd_dkv.launches`` count B2's and B3's).
    """
    return _FlashAttention.apply(q, k, v, causal, block_q, block_kv)


flash_attention.launches = 0


def _flash_fwd(q, k, v, causal: bool = True, block_q: int = 512,
               block_kv: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B, S, H, D], lse [B, H, S] f32)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, block_q, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _flash_fwd_cuda(q, k, v, causal)


def _check_kernel_inputs(q, k, v, head_dims=KERNEL_HEAD_DIMS) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bf16; {name} is {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, heads, D], got "
                             f"{tuple(t.shape)}")
        if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"that are multiples of 8 and 16-byte alignment")
        if not _tma_strides(t):
            raise ValueError(f"{name} has a stride the kernel's TMA maps "
                             f"cannot take (0, a broadcast, or 2**40 bytes "
                             f"or more): {t.stride()}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] != s:
        raise ValueError(f"the flash kernel needs Sq == Skv, got {s} and "
                         f"{k.shape[1]}")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads do not group over {k.shape[2]} kv heads")
    if d not in head_dims:
        raise ValueError(f"the kernel takes D in {head_dims}, got {d}")


def _tma_strides(t: torch.Tensor) -> bool:
    """Whether the kernels' TMA maps can step over ``t``'s [B, S, heads]
    dimensions: byte strides nonzero (no broadcast) and below 2**40; a
    dimension of size 1 is never stepped over."""
    return all(n <= 1 or 0 < 2 * st < 1 << 40
               for n, st in zip(t.shape[:3], t.stride()[:3]))


def _device_index(t: torch.Tensor) -> int:
    return (t.device.index if t.device.index is not None
            else torch.cuda.current_device())


def _flash_fwd_cuda(q, k, v, causal: bool):
    out, lse = _fwd_launch("flash_attention_fwd_bf16", q, k, v, causal,
                           q.shape[-1] ** -0.5)
    flash_attention.launches += 1
    return out, lse


def _fwd_launch(entry: str, q, k, v, causal: bool, scale: float, *softcap,
                head_dims=KERNEL_HEAD_DIMS):
    """Launch forward entry point ``entry`` (B1's, or B4's with its
    ``softcap``) on the card -> (out, lse); raises when it is refused."""
    _check_kernel_inputs(q, k, v, head_dims)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b * s == 0:
        return out, lse
    lib = _build.load("flash_attention_fwd", _bind)
    with torch.cuda.device(q.device):     # the entry sets q's device
        err = getattr(lib, entry)(
            _device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, s, h, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), scale, *softcap,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({err})")
    return out, lse


def _scores_and_dcap(sc: torch.Tensor, softcap: float):
    """Scaled scores -> (capped scores, d(capped) / d(scores) or None):
    the logit softcap c·tanh(s/c) in JAX's splash order, tanh(s / c) * c;
    softcap 0 leaves the scores as they are."""
    if not softcap:
        return sc, None
    t = torch.tanh(sc / softcap)
    return t * softcap, 1 - t * t


def flash_attention_reference(q, k, v, causal: bool = True,
                              block_q: int = 512, block_kv: int = 512,
                              softcap: float = 0.0,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function -> (out, lse).

    Walks q tiles and, inside each, K/V tiles up to the causal diagonal with
    the online softmax: scores are the f32 product of the inputs (as the
    kernel's f32 accumulation gives them) times ``scale`` (default D^-0.5),
    capped at ``softcap`` (0: off) before the mask; P is cast to the input
    dtype before P·V and summed in f32.  Ragged tiles are cut short, not
    padded.
    """
    b, s, h, d = q.shape
    if k.shape[1] != s:
        raise ValueError(f"flash attention needs Sq == Skv, got {s} and "
                         f"{k.shape[1]}")
    reps = h // k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    block_q = min(block_q, s)
    block_kv = min(block_kv, s)
    qt = q.transpose(1, 2).float()                          # [B, H, S, D]
    kt = k.transpose(1, 2).repeat_interleave(reps, 1).float()
    vt = v.transpose(1, 2).repeat_interleave(reps, 1)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block_q):
        qb = qt[:, :, q0:q0 + block_q]
        nq = qb.shape[2]
        q_pos = q0 + torch.arange(nq, device=q.device)
        m = torch.full((b, h, nq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)
        kv_end = min(s, q0 + nq) if causal else s
        for k0 in range(0, kv_end, block_kv):
            kb = kt[:, :, k0:k0 + block_kv]
            vb = vt[:, :, k0:k0 + block_kv]
            sc, _ = _scores_and_dcap(
                torch.matmul(qb, kb.transpose(-1, -2)) * scale, softcap)
            if causal:
                k_pos = k0 + torch.arange(kb.shape[2], device=q.device)
                sc = sc.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + nq] = (acc / l).to(q.dtype).transpose(1, 2)
        lse[:, :, q0:q0 + nq] = (m + torch.log(l))[..., 0]
    return out, lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32, [B, H, S] contiguous."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _flash_bwd(q, k, v, out, lse, dout, causal: bool = True,
               block_q: int = 512, block_kv: int = 512):
    """-> (dq [B, S, H, D], dk, dv [B, S, KV, D])."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, causal,
                                             block_q, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _flash_bwd_stats(q, k, v, dout, lse, _delta(out, dout), causal)


def _flash_bwd_stats(q, k, v, dout, lse, delta, causal: bool = True,
                     block_q: int = 512, block_kv: int = 512):
    """B2 and B3 with the softmax statistics given: lse and Δ ([B, H, S]
    f32) may be those of a larger attention that this call's K/V block is
    one part of (ring attention passes the merged lse and the final
    output's Δ), so dq, dk and dv are this block's share of its gradients.
    -> (dq [B, S, H, D], dk, dv [B, S, KV, D])."""
    if q.device.type == "cpu":
        return flash_bwd_stats_reference(q, k, v, dout, lse, delta, causal,
                                         block_q, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    g = _kernel_strides(dout.to(q.dtype))
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


def _kernel_strides(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides, else a
    contiguous copy (autograd may hand over a dO of any layout: the gradient
    of ``out.sum()`` is an expanded tensor, stride 0 everywhere)."""
    if (t.stride(-1) == 1 and not any(st % 8 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0 and _tma_strides(t)):
        return t
    return t.contiguous()


def _check_bwd_inputs(q, k, v, dout, lse, delta,
                      head_dims=KERNEL_HEAD_DIMS) -> None:
    _check_kernel_inputs(q, k, v, head_dims)
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or dout.device != q.device):
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} on "
                         f"{dout.device} does not match q {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}")
    if _kernel_strides(dout) is not dout:
        raise ValueError("dout needs a contiguous last dim, nonzero strides "
                         "that are multiples of 8 and below 2**40 bytes, and "
                         "16-byte alignment")
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32
                or t.shape != (b, h, s) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 [B, H, S] "
                             f"tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _dq_launch(entry: str, q, k, v, dout, lse, delta, causal: bool,
               scale: float, *softcap,
               head_dims=KERNEL_HEAD_DIMS) -> torch.Tensor:
    """Launch dq entry point ``entry`` (B2's, or B4's with its
    ``softcap``) on the card; raises when it is refused."""
    _check_bwd_inputs(q, k, v, dout, lse, delta, head_dims)
    b, s, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b * s == 0:
        return dq
    lib = _build.load("flash_attention_bwd", _bind_bwd_dq)
    with torch.cuda.device(q.device):     # the entry sets q's device
        err = getattr(lib, entry)(
            _device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, s, h, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *dout.stride()[:3], *dq.stride()[:3],
            int(causal), scale, *softcap,
            torch.cuda.current_stream(q.device).cuda_stream)
    _bwd_check(entry, lib.flash_attention_bwd_error_string, err)
    return dq


def _dkv_launch(entry: str, q, k, v, dout, lse, delta, causal: bool,
                scale: float, *softcap, head_dims=KERNEL_HEAD_DIMS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch dk/dv entry point ``entry`` (B3's, or B4's with its
    ``softcap``) on the card; raises when it is refused."""
    _check_bwd_inputs(q, k, v, dout, lse, delta, head_dims)
    b, s, h, d = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if b * s == 0:
        return dk, dv
    lib = _build.load("flash_attention_bwd_dkv", _bind_bwd_dkv)
    with torch.cuda.device(q.device):     # the entry sets q's device
        err = getattr(lib, entry)(
            _device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, s, h, k.shape[2], d, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], int(causal), scale, *softcap,
            torch.cuda.current_stream(q.device).cuda_stream)
    _bwd_check(entry, lib.flash_attention_bwd_dkv_error_string, err)
    return dk, dv


def _bwd_check(entry: str, error_string, err: int) -> None:
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({err})")


def flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                           causal: bool = True) -> torch.Tensor:
    """Kernel B2 on the card: dq [B, S, H, D] from q, k, v, dO (all bf16),
    lse and Δ ([B, H, S] f32).  ``launches`` counts its launches."""
    dq = _dq_launch("flash_attention_bwd_dq_bf16", q, k, v, dout, lse, delta,
                    causal, q.shape[-1] ** -0.5)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3 on the card: (dk, dv) [B, S, KV, D], each summed over the
    q heads of its GQA group.  ``launches`` counts its launches."""
    dk, dv = _dkv_launch("flash_attention_bwd_dkv_bf16", q, k, v, dout, lse,
                         delta, causal, q.shape[-1] ** -0.5)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  causal: bool = True, block_q: int = 512,
                                  block_kv: int = 512, softcap: float = 0.0,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of B2 and B3 -> (dq, dk, dv) in the layouts of
    q, k and v.

    dO is cast to the input dtype and Δ = rowsum(dO∘O) is taken in f32, as
    ``_flash_bwd_pallas`` does; products take operands of the input dtype
    and sum in f32, and P and dS are cast to the input dtype before the
    products that consume them, as the kernels do.  With ``softcap`` c > 0
    the scores are capped as in the forward and dS gains 1 - tanh²(s/c),
    s the uncapped scaled score.  Ragged tiles are cut short, not padded.
    """
    return flash_bwd_stats_reference(q, k, v, dout, lse, _delta(out, dout),
                                     causal, block_q, block_kv, softcap,
                                     scale)


def flash_bwd_stats_reference(q, k, v, dout, lse, delta,
                              causal: bool = True, block_q: int = 512,
                              block_kv: int = 512, softcap: float = 0.0,
                              scale: Optional[float] = None):
    """``flash_attention_bwd_reference`` with lse and Δ given (see
    ``_flash_bwd_stats``) -> (dq, dk, dv) in the layouts of q, k and v."""
    args = _bwd_reference_args(q, k, v, dout, lse, delta, causal, block_q,
                               block_kv, softcap, scale)
    dq = _bwd_dq_reference(*args)
    dk, dv = _bwd_dkv_reference(*args)
    return (dq.to(q.dtype).transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def _bwd_reference_args(q, k, v, dout, lse, delta, causal: bool = True,
                        block_q: int = 512, block_kv: int = 512,
                        softcap: float = 0.0, scale: Optional[float] = None):
    """The arguments of ``_bwd_dq_reference`` / ``_bwd_dkv_reference``:
    q, k, v and dO (cast to the input dtype) as f32 [B, heads, S, D], lse
    and Δ as f32 [B, H, S], then causal, scale (default D^-0.5), tiles, the
    input dtype and the softcap."""
    s, d = q.shape[1], q.shape[3]
    if k.shape[1] != s:
        raise ValueError(f"flash attention needs Sq == Skv, got {s} and "
                         f"{k.shape[1]}")
    qt, kt, vt, gt = (x.transpose(1, 2).float()
                      for x in (q, k, v, dout.to(q.dtype)))
    return (qt, kt, vt, gt, lse.float(), delta, causal,
            d ** -0.5 if scale is None else scale, min(block_q, s),
            min(block_kv, s), q.dtype, softcap)


def _bwd_dq_reference(qt, kt, vt, gt, lse, delta, causal, scale, block_q,
                      block_kv, dtype, softcap=0.0):
    """``_bwd_dq_kernel`` tile by tile: for each q tile, dq = Σ dS·K over
    the K/V tiles up to the causal diagonal.  [B, H, S, D] f32 in and out."""
    b, h, s, d = qt.shape
    reps = h // kt.shape[1]
    kh = kt.repeat_interleave(reps, 1)
    vh = vt.repeat_interleave(reps, 1)
    dq = torch.empty_like(qt)
    for q0 in range(0, s, block_q):
        qb, gb = qt[:, :, q0:q0 + block_q], gt[:, :, q0:q0 + block_q]
        nq = qb.shape[2]
        q_pos = q0 + torch.arange(nq, device=qt.device)
        lse_b = lse[:, :, q0:q0 + nq, None]
        dlt_b = delta[:, :, q0:q0 + nq, None]
        acc = torch.zeros((b, h, nq, d), dtype=torch.float32, device=qt.device)
        kv_end = min(s, q0 + nq) if causal else s
        for k0 in range(0, kv_end, block_kv):
            kb, vb = kh[:, :, k0:k0 + block_kv], vh[:, :, k0:k0 + block_kv]
            sc, dcap = _scores_and_dcap(
                torch.matmul(qb, kb.transpose(-1, -2)) * scale, softcap)
            if causal:
                k_pos = k0 + torch.arange(kb.shape[2], device=qt.device)
                sc = sc.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            p = torch.exp(sc - lse_b)
            dp = torch.matmul(gb, vb.transpose(-1, -2))
            ds = p * (dp - dlt_b)
            if dcap is not None:
                ds = ds * dcap
            ds = ds * scale
            acc = acc + torch.matmul(ds.to(dtype).float(), kb)
        dq[:, :, q0:q0 + nq] = acc
    return dq


def _bwd_dkv_reference(qt, kt, vt, gt, lse, delta, causal, scale, block_q,
                       block_kv, dtype, softcap=0.0):
    """``_bwd_dkv_kernel`` tile by tile: for each kv tile, dv = Σ Pᵀ·dO and
    dk = Σ dSᵀ·Q over the group's ``reps`` q heads (outer) and the q tiles
    from the causal diagonal on (inner).  -> [B, KV, S, D] f32 each."""
    b, h, s, d = qt.shape
    kv_heads = kt.shape[1]
    reps = h // kv_heads
    dk, dv = torch.empty_like(kt), torch.empty_like(vt)
    for k0 in range(0, s, block_kv):
        kb, vb = kt[:, :, k0:k0 + block_kv], vt[:, :, k0:k0 + block_kv]
        nk = kb.shape[2]
        k_pos = k0 + torch.arange(nk, device=qt.device)
        dk_acc = torch.zeros((b, kv_heads, nk, d), dtype=torch.float32,
                             device=qt.device)
        dv_acc = torch.zeros_like(dk_acc)
        q_first = k0 // block_q * block_q if causal else 0
        for r in range(reps):
            # q head g * reps + r of every group g
            qr, gr = qt[:, r::reps], gt[:, r::reps]
            for q0 in range(q_first, s, block_q):
                qb, gb = qr[:, :, q0:q0 + block_q], gr[:, :, q0:q0 + block_q]
                nq = qb.shape[2]
                lse_b = lse[:, r::reps, None, q0:q0 + nq]
                dlt_b = delta[:, r::reps, None, q0:q0 + nq]
                s_t, dcap = _scores_and_dcap(
                    torch.matmul(kb, qb.transpose(-1, -2)) * scale, softcap)
                if causal:
                    q_pos = q0 + torch.arange(nq, device=qt.device)
                    s_t = s_t.masked_fill(q_pos[None, :] < k_pos[:, None],
                                          NEG_INF)
                p_t = torch.exp(s_t - lse_b)
                dv_acc = dv_acc + torch.matmul(p_t.to(dtype).float(), gb)
                dp_t = torch.matmul(vb, gb.transpose(-1, -2))
                ds_t = p_t * (dp_t - dlt_b)
                if dcap is not None:
                    ds_t = ds_t * dcap
                ds_t = ds_t * scale
                dk_acc = dk_acc + torch.matmul(ds_t.to(dtype).float(), qb)
        dk[:, :, k0:k0 + nk] = dk_acc
        dv[:, :, k0:k0 + nk] = dv_acc
    return dk, dv
