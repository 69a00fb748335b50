"""Decoder-only transformer: one implementation for GPT-2 / Llama-3.

Counterpart of ``ray_tpu/models/transformer.py``:
* Params are a plain nested dict with the JAX tree's keys; every block weight
  is stacked ``[L, ...]``, so a JAX tree converts leaf by leaf
  (``models/convert.py``).
* Layers run as a Python loop over ``L`` where the JAX package scans; remat
  is ``torch.utils.checkpoint`` around each layer.
* Norms compute in f32 and cast back; RoPE rotates halves, not interleaved
  pairs; GELU is the tanh approximation (``jax.nn.gelu``'s default).
* The loss: ``causal_lm_loss`` with the blockwise LM head and cross entropy
  (``chunked_cross_entropy``, a ``torch.autograd.Function`` whose backward
  recomputes one chunk's logits at a time).

MoE, splash attention and the remat policies that save named activations
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attend, mha
from .config import TransformerConfig

Params = Dict[str, Any]

# The names the JAX package tags with checkpoint_name for its "save_acts" /
# "save_mlp" remat policies (kept so the two packages name the same set).
REMAT_SAVE_NAMES = ("attn_q", "attn_k", "attn_v", "attn_out", "attn_lse",
                    "mlp_gate", "mlp_up", "mlp_pre")


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


def unbind_layers(blocks: Params, num_layers: int) -> List[Params]:
    """Every layer's slice of the stacked block params (views, no copies),
    from one ``torch.unbind`` per leaf, whose backward stacks the L
    gradients once."""
    layers: List[Params] = [{} for _ in range(num_layers)]
    for k, v in blocks.items():
        parts = (unbind_layers(v, num_layers) if isinstance(v, dict)
                 else torch.unbind(v))
        for lp, part in zip(layers, parts):
            lp[k] = part
    return layers


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


def remat_policy(remat: Union[bool, str, None]) -> bool:
    """Whether ``remat`` replays each layer in the backward.

    - False/None: no rematerialization;
    - True / "full": save only each layer's input and replay the whole
      block (``torch.utils.checkpoint``, JAX's ``nothing_saveable``).
    "save_acts", "save_mlp" and "dots" keep named or matmul outputs through
    the replay in JAX; the port has no such policy yet.
    """
    if remat is None or remat is False:
        return False
    if remat is True or remat == "full":
        return True
    if remat in ("save_acts", "save_mlp", "dots"):
        raise _not_ported(f"remat={remat!r}", "queue A, remat save policies")
    raise ValueError(f"unknown remat policy {remat!r}")


def apply_trunk(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                compute_dtype=torch.bfloat16,
                remat: Union[bool, str, None] = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B, S] -> (final hidden states [B, S, H], aux dict).

    The trunk stops before the LM head so the loss can run the head
    blockwise (``chunked_cross_entropy``).  With ``remat`` each layer keeps
    only its input for the backward and replays its forward there (the
    flash forward runs again then)."""
    enabled = remat_policy(remat)
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = []
    for lp in unbind_layers(params["blocks"], cfg.num_layers):
        if enabled:
            x, a = checkpoint(block_forward, x, lp, cfg, positions,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = block_forward(x, lp, cfg, positions)
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
          compute_dtype=torch.bfloat16,
          remat: Union[bool, str, None] = False
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B, S] -> (logits [B, S, V] f32, aux dict)."""
    x, aux = apply_trunk(params, tokens, cfg, compute_dtype, remat=remat)
    logits = x @ lm_head_weight(params, cfg, x.dtype)
    return logits.float(), aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32 sums of the operands' values (JAX's
    ``preferred_element_type=f32``).  bf16 operands on the card go to one
    cuBLAS product with an f32 output; elsewhere the operands widen to f32
    exactly first."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def chunked_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                          targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Blockwise LM head + softmax cross entropy: peak memory O(B*chunk*V)
    instead of O(B*S*V).

    x: [B, S, H] (compute dtype), w: [H, V], targets: [B, S] int
    -> nll [B, S] f32.  Logits are f32 sums of the operands.  The forward
    keeps only the per-token lse; the backward recomputes one chunk's logits
    at a time and forms dlogits = (softmax - onehot) * g, cast to x's dtype
    before both products, with dw summed in f32.  A chunk that does not
    divide S shrinks to the largest divisor of S below it.
    """
    s = x.shape[1]
    if s % chunk != 0:
        chunk = next((c for c in range(min(chunk, s), 0, -1) if s % c == 0), s)
    return _ChunkedCE.apply(x, w, targets, chunk)


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        b, s, h = x.shape
        nll = torch.empty((b, s), dtype=torch.float32, device=x.device)
        lse = torch.empty_like(nll)
        for c0 in range(0, s, chunk):
            xc = x[:, c0:c0 + chunk].reshape(-1, h)
            logits = _dot_f32(xc, w)                              # [B*C, V]
            l = torch.logsumexp(logits, dim=-1)
            tc = targets[:, c0:c0 + chunk].reshape(-1, 1).long()
            ll = logits.gather(-1, tc)[:, 0]
            lse[:, c0:c0 + chunk] = l.view(b, -1)
            nll[:, c0:c0 + chunk] = (l - ll).view(b, -1)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, h = x.shape
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for c0 in range(0, s, chunk):
            xc = x[:, c0:c0 + chunk].reshape(-1, h)
            logits = _dot_f32(xc, w)
            p = torch.exp(logits - lse[:, c0:c0 + chunk].reshape(-1, 1))
            tc = targets[:, c0:c0 + chunk].reshape(-1, 1).long()
            p.scatter_add_(-1, tc, torch.full_like(tc, -1, dtype=p.dtype))
            dlog = (p * g[:, c0:c0 + chunk].reshape(-1, 1)).to(x.dtype)
            dx[:, c0:c0 + chunk] = (dlog @ w.T).view(b, -1, h)
            dw += _dot_f32(xc.T, dlog)
        return dx, dw.to(w.dtype), None, None


def causal_lm_loss(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: TransformerConfig, compute_dtype=torch.bfloat16,
                   moe_aux_weight: float = 0.01,
                   remat: Union[bool, str, None] = False,
                   loss_chunk: Optional[int] = 0):
    """batch: {"tokens": [B, S+1]} or {"tokens", "targets"}, optionally
    "loss_mask" [B, S].  Returns (loss, metrics).

    loss_chunk: sequence-chunk size for the blockwise LM head.  0 (default)
    chunks at 512 when the full logits tensor would be large
    (S*V > 2**25 elements); None disables; an int forces that chunk size.
    """
    if "targets" in batch:
        tokens, targets = batch["tokens"], batch["targets"]
    else:
        tokens, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    s = tokens.shape[1]
    if loss_chunk == 0:
        loss_chunk = 512 if s * cfg.vocab_size > 2 ** 25 else None
    x, aux = apply_trunk(params, tokens, cfg, compute_dtype, remat=remat)
    if loss_chunk:
        w = lm_head_weight(params, cfg, x.dtype)
        nll = chunked_cross_entropy(x, w, targets, min(loss_chunk, s))
    else:
        logits = (x @ lm_head_weight(params, cfg, x.dtype)).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
        denom = torch.full((), nll.numel(), dtype=torch.int32,
                           device=nll.device)
    else:
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
        denom = mask.sum()
    total = loss + moe_aux_weight * aux["moe_aux_loss"]
    return total, {"loss": loss, "moe_aux_loss": aux["moe_aux_loss"],
                   "tokens": denom}
