"""Decoder-only transformer forward: one implementation for GPT-2 / Llama-3.

Counterpart of the forward half of ``ray_tpu/models/transformer.py``:
* Params are a plain nested dict with the JAX tree's keys; every block weight
  is stacked ``[L, ...]``, so a JAX tree converts leaf by leaf
  (``models/convert.py``).
* Layers run as a Python loop over ``L`` where the JAX package scans.
* Norms compute in f32 and cast back; RoPE rotates halves, not interleaved
  pairs; GELU is the tanh approximation (``jax.nn.gelu``'s default).

Remat, the chunked cross entropy and the loss wait for the training slice;
MoE and splash attention raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attend, mha
from .config import TransformerConfig

Params = Dict[str, Any]


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP: {item})")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: TransformerConfig,
                dtype=torch.float32) -> Params:
    """Random params with the JAX package's keys and shapes, drawn from
    ``generator`` on its device.  (Values differ from the JAX package's
    draws; tests convert JAX params instead.)"""
    if cfg.num_experts > 1:
        raise _not_ported("MoE (num_experts > 1)", "queue A, ops/moe.py")
    h, hd = cfg.hidden_size, cfg.head_dim
    nh, nkv, m, L = cfg.num_heads, cfg.num_kv_heads, cfg.mlp_size, cfg.num_layers
    dev = generator.device

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        return x.mul_(std)

    def dense(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def norm_p():
        p = {"scale": torch.ones((L, h), dtype=dtype, device=dev)}
        if not cfg.use_rmsnorm:
            p["bias"] = zeros((L, h))
        return p

    blocks: Params = {
        "attn_norm": norm_p(),
        "attn": {
            "wq": dense((L, h, nh * hd), h),
            "wk": dense((L, h, nkv * hd), h),
            "wv": dense((L, h, nkv * hd), h),
            "wo": dense((L, nh * hd, h), nh * hd),
        },
        "mlp_norm": norm_p(),
    }
    if not cfg.use_rmsnorm or cfg.use_qkv_bias:
        # GPT-2 style (all biases) or Qwen-2 style (Q/K/V biases only)
        blocks["attn"]["bq"] = zeros((L, nh * hd))
        blocks["attn"]["bk"] = zeros((L, nkv * hd))
        blocks["attn"]["bv"] = zeros((L, nkv * hd))
    if not cfg.use_rmsnorm:
        blocks["attn"]["bo"] = zeros((L, h))
    mlp: Params = {"w_in": dense((L, h, m), h), "w_out": dense((L, m, h), m)}
    if cfg.use_swiglu:
        mlp["w_gate"] = dense((L, h, m), h)
    else:
        mlp["b_in"] = zeros((L, m))
        mlp["b_out"] = zeros((L, h))
    blocks["mlp"] = mlp

    params: Params = {
        "embed": {"tokens": normal((cfg.vocab_size, h), 0.02)},
        "blocks": blocks,
        "final_norm": {"scale": torch.ones((h,), dtype=dtype, device=dev)},
    }
    if not cfg.use_rope:
        params["embed"]["pos"] = normal((cfg.max_seq_len, h), 0.01)
    if not cfg.use_rmsnorm:
        params["final_norm"]["bias"] = zeros((h,))
    if not cfg.tied_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size), h)
    return params


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked block params (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, p: Params, cfg: TransformerConfig) -> torch.Tensor:
    x32 = x.float()
    if cfg.use_rmsnorm:
        x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                + cfg.norm_eps)
        return (x32 * p["scale"].float()).to(x.dtype)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    x32 = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
    return (x32 * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _rope_tables(positions: torch.Tensor, d: int, theta: float):
    """cos/sin of ``positions[..., None] * freqs`` in f32, [..., D/2]."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    # halves, not interleaved pairs (the JAX package's convention)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [S]."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _attention_block(x, p, cfg: TransformerConfig, positions):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cast = x.dtype
    q = x @ p["wq"].to(cast)
    k = x @ p["wk"].to(cast)
    v = x @ p["wv"].to(cast)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(cast), k + p["bk"].to(cast),
                   v + p["bv"].to(cast))
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.use_rope:
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    impl = cfg.attention_impl
    if impl == "splash":
        raise _not_ported('attention_impl="splash"', "queue B, kernel B4")
    if impl == "plain":
        out = attend(q, k, v, causal=cfg.causal,
                     logit_softcap=cfg.attn_logit_softcap)
    elif impl == "flash" and cfg.attn_logit_softcap == 0.0:
        from ..ops.flash_attention import flash_attention
        out = flash_attention(q, k, v, causal=cfg.causal)
    else:  # "auto", or flash declined a softcap
        out = mha(q, k, v, causal=cfg.causal,
                  logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(b, s, nh * hd) @ p["wo"].to(cast)
    if "bo" in p:
        out = out + p["bo"].to(cast)
    return out


def _mlp_block(x, p, cfg: TransformerConfig):
    cast = x.dtype
    if cfg.use_swiglu:
        return (F.silu(x @ p["w_gate"].to(cast))
                * (x @ p["w_in"].to(cast))) @ p["w_out"].to(cast)
    hmid = F.gelu(x @ p["w_in"].to(cast) + p["b_in"].to(cast),
                  approximate="tanh")
    return hmid @ p["w_out"].to(cast) + p["b_out"].to(cast)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def block_forward(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
                  positions: torch.Tensor):
    """One transformer block: x [B, S, H] -> (x, moe aux loss)."""
    if cfg.num_experts > 1:
        raise _not_ported("MoE (num_experts > 1)", "queue A, ops/moe.py")
    x = x + _attention_block(_norm(x, lp["attn_norm"], cfg), lp["attn"], cfg,
                             positions)
    out = _mlp_block(_norm(x, lp["mlp_norm"], cfg), lp["mlp"], cfg)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token (+ learned positional) embedding: [B, S] -> [B, S, H]."""
    x = params["embed"]["tokens"][tokens.long()].to(compute_dtype)
    if not cfg.use_rope:
        s = tokens.shape[1]
        x = x + params["embed"]["pos"][:s][None].to(compute_dtype)
    return x


def apply_trunk(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B, S] -> (final hidden states [B, S, H], aux dict)."""
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = []
    for i in range(cfg.num_layers):
        x, a = block_forward(x, layer_params(params["blocks"], i), cfg,
                             positions)
        aux.append(a)
    x = _norm(x, params["final_norm"], cfg)
    return x, {"moe_aux_loss": torch.stack(aux).mean()}


def lm_head_weight(params: Params, cfg: TransformerConfig,
                   dtype) -> torch.Tensor:
    """[H, V] head weight (tied embedding transpose or separate lm_head)."""
    if cfg.tied_embeddings:
        return params["embed"]["tokens"].T.to(dtype)
    return params["lm_head"].to(dtype)


def apply(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
          compute_dtype=torch.bfloat16
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B, S] -> (logits [B, S, V] f32, aux dict)."""
    x, aux = apply_trunk(params, tokens, cfg, compute_dtype)
    logits = x @ lm_head_weight(params, cfg, x.dtype)
    return logits.float(), aux
