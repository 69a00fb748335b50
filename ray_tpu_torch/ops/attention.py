"""Attention ops: causal multi-head attention with GQA, plain PyTorch path +
the hand-written CUDA flash kernel on the card.

Counterpart of ``ray_tpu/ops/attention.py``.  The plain path is two einsums
and is the right choice for short sequences; the flash kernel
(``flash_attention.py``) takes over once S is large enough that the S×S score
matrix is worth never writing to device memory.  ``attend_blockwise`` /
``finalize_blockwise`` are the online-softmax accumulator ring attention
(``ring_attention.py``) folds its KV shards into where the kernels do not
take the call.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, H, D] by repeating kv heads (GQA)."""
    num_kv = k.shape[2]
    if num_kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // num_kv, dim=2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, q_offset: int = 0, kv_offset: int = 0,
           logit_softcap: float = 0.0) -> torch.Tensor:
    """Plain attention. q: [B, Sq, H, D], k/v: [B, Skv, KV, D] -> [B, Sq, H, D].

    Logits stay in the input dtype, the softmax runs in f32 and the
    probabilities return to the input dtype for the PV product, as in the
    JAX package.  Masked logits take ``NEG_INF`` (not -inf), so a fully
    masked row gives no NaN, cast to the logits' dtype as the JAX package's
    ``jnp.where`` casts it: in f16, whose range ends at 65504, that is -inf
    (a causal row always keeps its own position).
    """
    num_heads = q.shape[2]
    k = repeat_kv(k, num_heads)
    v = repeat_kv(v, num_heads)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k.to(q.dtype)) * scale
    if logit_softcap > 0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(
            ~mask[None, None], float(torch.tensor(NEG_INF, dtype=logits.dtype)))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


#: the dtypes the flash kernels take (``flash_attention.KERNEL_DTYPES``)
FLASH_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def flash_kernel_takes(is_cuda: bool, seq: int, head_dim: int,
                       logit_softcap: float, dtype: torch.dtype) -> bool:
    """Whether ``mha`` sends this call to the flash kernel: CUDA tensors
    of bf16, f16 or f32, long sequences, a head dim the kernel has, no
    softcap: the reference's conditions for its Pallas kernel, with "TPU"
    read as "CUDA".  Every other call takes plain attention, which computes
    them all: the kernel has no softcap."""
    return (is_cuda and dtype in FLASH_DTYPES and seq >= 1024
            and head_dim in (64, 128, 256) and logit_softcap == 0.0)


def mha(q, k, v, causal: bool = True, logit_softcap: float = 0.0,
        use_flash: Optional[bool] = None):
    """Dispatch between the flash kernel (bf16, f16 or f32 CUDA tensors,
    long seq) and plain attention."""
    if use_flash is None:
        use_flash = flash_kernel_takes(q.is_cuda, q.shape[1], q.shape[-1],
                                       logit_softcap, q.dtype)
    if use_flash:
        if logit_softcap > 0.0:
            raise ValueError("flash_attention does not implement logit_softcap;"
                             " use use_flash=False (or leave it None to"
                             " take the plain path)")
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    return attend(q, k, v, causal=causal, logit_softcap=logit_softcap)


def attend_blockwise(q, k, v, m, l, o, causal: bool, q_offset: int,
                     kv_offset: int, logit_softcap: float = 0.0):
    """One online-softmax accumulation step over a KV block.

    State: m [B,H,Sq] running max (f32), l [B,H,Sq] running denom (f32),
    o [B,Sq,H,D] running numerator (f32).  Returns updated (m, l, o).
    This is the flash-attention recurrence; ring attention calls it once
    per KV shard where the kernels do not take the call.  The scores are
    the product in q's dtype, then f32, capped, then masked by the global
    positions ``q_offset``/``kv_offset`` of the first query and key, as in
    the JAX package.
    """
    num_heads = q.shape[2]
    k = repeat_kv(k, num_heads)
    v = repeat_kv(v, num_heads)
    scale = q.shape[-1] ** -0.5
    s = (torch.einsum("bqhd,bkhd->bhqk", q, k.to(q.dtype)) * scale).float()
    if logit_softcap > 0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask[None, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def finalize_blockwise(m, l, o):
    """Normalize the online-softmax accumulator into the attention output
    (f32; the caller casts)."""
    return o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
