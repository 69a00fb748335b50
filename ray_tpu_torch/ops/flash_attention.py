"""Flash attention forward: a CUDA kernel written by hand for Hopper, and its
plain PyTorch version.

Counterpart of the forward half of ``ray_tpu/ops/flash_attention.py``.  The
kernel (``csrc/flash_attention_fwd.cu``) computes what the Pallas
``_fwd_kernel`` computes: an online softmax over K/V tiles in f32, causal
tiles past the diagonal skipped, GQA K/V read in place, P cast to the input
dtype for the P·V product; it returns out and the log-sum-exp ``lse``.

Dispatch is by the tensors' device only: a CPU tensor takes the plain
version (which repeats the kernel's arithmetic tile by tile), a CUDA tensor
launches the kernel or raises on what the kernel does not take.  There is
no fallback from one to the other.  The backward kernels are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .attention import NEG_INF

KERNEL_HEAD_DIMS = (64, 128, 256)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_fwd_bf16
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512) -> torch.Tensor:
    """Flash attention. q: [B, S, H, D], k/v: [B, S, KV, D] -> [B, S, H, D].

    ``block_q``/``block_kv`` are the plain version's tiles; the CUDA kernel
    tiles by 64 rows, a size its shared-memory budget fixes.  ``launches``
    counts the kernel's launches.
    """
    return _flash_fwd(q, k, v, causal, block_q, block_kv)[0]


flash_attention.launches = 0


def _flash_fwd(q, k, v, causal: bool = True, block_q: int = 512,
               block_kv: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B, S, H, D], lse [B, H, S] f32)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, block_q, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _flash_fwd_cuda(q, k, v, causal)


def _check_kernel_inputs(q, k, v) -> None:
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
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] != s:
        raise ValueError(f"the flash kernel needs Sq == Skv, got {s} and "
                         f"{k.shape[1]}")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads do not group over {k.shape[2]} kv heads")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes D in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")


def _flash_fwd_cuda(q, k, v, causal: bool):
    _check_kernel_inputs(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b * s == 0:
        return out, lse
    lib = _build.load("flash_attention_fwd", _bind)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd_bf16(
        q.device.index if q.device.index is not None
        else torch.cuda.current_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), d ** -0.5, stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out, lse


def flash_attention_reference(q, k, v, causal: bool = True,
                              block_q: int = 512, block_kv: int = 512
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function -> (out, lse).

    Walks q tiles and, inside each, K/V tiles up to the causal diagonal with
    the online softmax: scores are the f32 product of the inputs (as the
    kernel's f32 accumulation gives them), P is cast to the input dtype
    before P·V and summed in f32.  Ragged tiles are cut short, not padded.
    """
    b, s, h, d = q.shape
    if k.shape[1] != s:
        raise ValueError(f"flash attention needs Sq == Skv, got {s} and "
                         f"{k.shape[1]}")
    reps = h // k.shape[2]
    scale = d ** -0.5
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
            sc = torch.matmul(qb, kb.transpose(-1, -2)) * scale
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
