"""Autoregressive decoding with a slot-based KV cache — the inference side of
the transformer.

Counterpart of ``ray_tpu/models/decode.py``, function for function:
* The cache is a fixed [L, slots, max_len, KV, D] tensor; a "slot" is one
  sequence's reserved cache row.  Continuous batching admits and retires
  sequences by slot index, so tensor shapes never change.
* Where the JAX package donates the cache buffer to a jitted program and
  gets a new one back, the port updates the cache **in place** (prefill and
  decode write K/V rows and lengths into the tensors they were given) and
  returns the same dict.  The small per-slot decode state is rebuilt, not
  mutated, so tensors the engine still holds stay valid.
* A decode write at position ``max_len`` falls outside the cache.  JAX drops
  such a scatter silently; torch indexing would raise (a device assert on
  CUDA), so the port clamps the index and writes the old row back there,
  which gives JAX's result without a host sync.
* Layers run as a Python loop where the JAX package scans.  The sampling
  state carries a ``torch.Generator`` where the JAX package carries a PRNG
  key; the two draw different numbers, so only greedy decoding matches JAX
  token for token.
* Prefill attention goes through ``ops.attention.mha`` (the flash kernel on
  CUDA for buckets >= 1024); decode attention keeps the JAX package's
  numerics: the cache layer in f32, plain torch ops.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .. import device as _device
from ..ops.attention import NEG_INF
from .config import TransformerConfig
from .transformer import (Params, _mlp_block, _norm, _not_ported,
                          _rope_tables, _rotate, lm_head_weight,
                          unbind_layers)

KVCache = Dict[str, torch.Tensor]


def init_kv_cache(cfg: TransformerConfig, num_slots: int, max_len: int,
                  dtype=torch.bfloat16,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> KVCache:
    """Allocate the cache: K/V per layer per slot, plus per-slot lengths."""
    dev = _device.resolve(device)
    shape = (cfg.num_layers, num_slots, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "length": torch.zeros((num_slots,), dtype=torch.int32, device=dev),
    }


def cache_bytes(cfg: TransformerConfig, num_slots: int, max_len: int,
                dtype_bytes: int = 2) -> int:
    return (2 * cfg.num_layers * num_slots * max_len * cfg.num_kv_heads
            * cfg.head_dim * dtype_bytes)


# ---------------------------------------------------------------------------
# Shared per-layer attention pieces
# ---------------------------------------------------------------------------

def _qkv(x, p, cfg: TransformerConfig, positions):
    """x: [B, S, H] -> q [B,S,NH,D], k/v [B,S,NKV,D] with RoPE applied."""
    b, s, _ = x.shape
    cast = x.dtype
    q = x @ p["wq"].to(cast)
    k = x @ p["wk"].to(cast)
    v = x @ p["wv"].to(cast)
    if "bq" in p:
        q = q + p["bq"].to(cast)
        k = k + p["bk"].to(cast)
        v = v + p["bv"].to(cast)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = _rope_per_row(q, positions, cfg.rope_theta)
        k = _rope_per_row(k, positions, cfg.rope_theta)
    return q, k, v


def _rope_per_row(x: torch.Tensor, positions: torch.Tensor,
                  theta: float) -> torch.Tensor:
    """RoPE with per-batch-row positions. x: [B, S, H, D]; positions: [B, S]."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)   # [B, S, D/2]
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def _mlp(y, p, cfg: TransformerConfig):
    if cfg.num_experts > 1:
        raise _not_ported("MoE (num_experts > 1)", "queue A, ops/moe.py")
    return _mlp_block(y, p["mlp"], cfg)


def _proj_out(attn, p, cast):
    out = attn @ p["wo"].to(cast)
    if "bo" in p:
        out = out + p["bo"].to(cast)
    return out


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(params: Params, cache: KVCache, tokens: torch.Tensor,
            lengths: torch.Tensor, slot_ids: torch.Tensor,
            cfg: TransformerConfig,
            compute_dtype=torch.bfloat16) -> Tuple[KVCache, torch.Tensor]:
    """Run the causal forward over right-padded prompts, fill the cache in
    place.

    tokens: [B, S] int (right-padded to the bucket length S)
    lengths: [B] true prompt lengths; slot_ids: [B] cache rows to fill.
    Returns (cache, last-token logits [B, V] f32).
    """
    from ..ops.attention import mha

    b, s = tokens.shape
    cast = compute_dtype
    slots = slot_ids.long()
    x = params["embed"]["tokens"][tokens.long()].to(cast)
    if not cfg.use_rope:
        x = x + params["embed"]["pos"][:s][None].to(cast)
    positions = torch.arange(s, device=x.device).expand(b, s)

    for i, lp in enumerate(unbind_layers(params["blocks"], cfg.num_layers)):
        y = _norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(y, lp["attn"], cfg, positions)
        attn = mha(q, k, v, causal=True,
                   logit_softcap=cfg.attn_logit_softcap)
        x = x + _proj_out(attn.reshape(b, s, -1), lp["attn"], cast)
        x = x + _mlp(_norm(x, lp["mlp_norm"], cfg), lp, cfg)
        # write this layer's K/V into the slots (padded tail included;
        # decode's length mask keeps it unread)
        k_lay, v_lay = cache["k"][i], cache["v"][i]
        k_lay[slots, :s] = k.to(k_lay.dtype)
        v_lay[slots, :s] = v.to(v_lay.dtype)
    # logits of each prompt's *last real token* (next-token distribution);
    # the norm is row-wise, so gathering the rows first changes nothing
    last_idx = (lengths.long() - 1).clamp(min=0)
    last = x[torch.arange(b, device=x.device), last_idx]          # [B, H]
    last = _norm(last, params["final_norm"], cfg)
    logits = (last @ lm_head_weight(params, cfg, cast)).float()
    cache["length"][slots] = lengths.to(cache["length"].dtype)
    return cache, logits


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def decode_step(params: Params, cache: KVCache, tokens: torch.Tensor,
                active: torch.Tensor, cfg: TransformerConfig,
                compute_dtype=torch.bfloat16) -> Tuple[KVCache, torch.Tensor]:
    """One autoregressive step for every slot.

    tokens: [slots] int — the last emitted token per slot
    active: [slots] bool — inactive slots compute garbage that is masked out
    Returns (cache, logits [slots, V] f32).  Appends K/V at position `length`
    (in place; dropped where `length` == max_len) and increments `length`
    for active slots.
    """
    n_slots = tokens.shape[0]
    max_len = cache["k"].shape[2]
    cast = compute_dtype
    lengths = cache["length"].long()                           # [slots]
    dev = lengths.device
    x = params["embed"]["tokens"][tokens.long()][:, None].to(cast)  # [S,1,H]
    if not cfg.use_rope:
        x = x + params["embed"]["pos"][torch.clamp(
            lengths, max=cfg.max_seq_len - 1)][:, None].to(cast)
    positions = lengths[:, None]                               # [slots, 1]
    scale = cfg.head_dim ** -0.5
    reps = cfg.num_heads // cfg.num_kv_heads
    # mask over cache positions: <= current length (the new token's position)
    pos_mask = (torch.arange(max_len, device=dev)[None]
                <= lengths[:, None])                           # [slots, max_len]
    rows = torch.arange(n_slots, device=dev)
    # JAX drops the write of a slot standing at max_len; keep its row as is
    in_range = (lengths < max_len)[:, None, None]
    write_at = lengths.clamp(max=max_len - 1)

    for i, lp in enumerate(unbind_layers(params["blocks"], cfg.num_layers)):
        k_lay, v_lay = cache["k"][i], cache["v"][i]
        y = _norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(y, lp["attn"], cfg, positions)  # q:[S,1,NH,D] k/v:[S,1,NKV,D]
        # append at position `length` (one row per slot)
        k_lay[rows, write_at] = torch.where(in_range, k[:, 0].to(k_lay.dtype),
                                            k_lay[rows, write_at])
        v_lay[rows, write_at] = torch.where(in_range, v[:, 0].to(v_lay.dtype),
                                            v_lay[rows, write_at])
        # attention over the cache row, in f32 as the JAX package does
        qh = q[:, 0].reshape(n_slots, cfg.num_kv_heads, reps, cfg.head_dim)
        scores = torch.einsum("sgrd,smgd->sgrm", qh.float(),
                              k_lay.float()) * scale
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            scores = c * torch.tanh(scores / c)
        scores = scores.masked_fill(~pos_mask[:, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("sgrm,smgd->sgrd", probs, v_lay.float())
        attn = attn.reshape(n_slots, 1, cfg.num_heads * cfg.head_dim)
        x = x + _proj_out(attn.to(cast), lp["attn"], cast)
        x = x + _mlp(_norm(x, lp["mlp_norm"], cfg), lp, cfg)

    x = _norm(x, params["final_norm"], cfg)
    logits = (x[:, 0] @ lm_head_weight(params, cfg, cast)).float()
    new_len = torch.where(active, torch.clamp(lengths + 1, max=max_len),
                          lengths)
    cache["length"].copy_(new_len)
    return cache, logits


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise; argmax(logits + noise) is a categorical draw."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, NEG_INF)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k sampling. logits: [B, V]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        logits = _top_k_mask(logits, top_k)
    noise = _gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def sample_per_slot(logits: torch.Tensor, generator: torch.Generator,
                    temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """Mixed sampling with per-row temperature (0 = greedy), on the device.

    logits: [B, V]; temperature: [B] f32.  Rows with temperature 0 take the
    argmax; others sample categorically at their temperature.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / t
    if top_k > 0:
        scaled = _top_k_mask(scaled, top_k)
    noise = _gumbel(scaled.shape, generator, scaled.device)
    drawn = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, drawn, greedy)


def decode_and_sample(params: Params, cache: KVCache, tokens: torch.Tensor,
                      active: torch.Tensor, temperature: torch.Tensor,
                      generator: torch.Generator, cfg: TransformerConfig,
                      top_k: int = 0, compute_dtype=torch.bfloat16
                      ) -> Tuple[KVCache, torch.Tensor]:
    """One decode step with on-device sampling.  Inactive slots keep their
    token."""
    cache, logits = decode_step(params, cache, tokens, active, cfg,
                                compute_dtype)
    nxt = sample_per_slot(logits, generator, temperature, top_k)
    return cache, torch.where(active, nxt, tokens)


def decode_loop(params: Params, cache: KVCache, tokens: torch.Tensor,
                active: torch.Tensor, temperature: torch.Tensor,
                generator: torch.Generator, n_steps: int,
                cfg: TransformerConfig, top_k: int = 0,
                compute_dtype=torch.bfloat16
                ) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """``n_steps`` decode steps.  Returns (cache, final tokens [slots],
    emitted [n_steps, slots])."""
    emitted = []
    for _ in range(n_steps):
        cache, tokens = decode_and_sample(params, cache, tokens, active,
                                          temperature, generator, cfg, top_k,
                                          compute_dtype)
        emitted.append(tokens)
    return cache, tokens, torch.stack(emitted)


def prefill_and_sample(params: Params, cache: KVCache, tokens: torch.Tensor,
                       lengths: torch.Tensor, slot_ids: torch.Tensor,
                       temperature: torch.Tensor, generator: torch.Generator,
                       cfg: TransformerConfig, top_k: int = 0,
                       compute_dtype=torch.bfloat16
                       ) -> Tuple[KVCache, torch.Tensor]:
    """Prefill + sample each prompt's first output token on the device."""
    cache, logits = prefill(params, cache, tokens, lengths, slot_ids, cfg,
                            compute_dtype)
    return cache, sample_per_slot(logits, generator, temperature, top_k)


# ---------------------------------------------------------------------------
# Device-resident autoregressive state (no host round trip in the loop)
# ---------------------------------------------------------------------------
#
# The serving engine keeps the per-slot autoregressive state on the device
# and touches it only through two calls:
#
#   decode_state_loop(params, cache, state, n)   — n steps, state evolves
#   prefill_admit(params, cache, state, <admit batch>)
#
# `state` carries tokens/active/temps/budget/eos + the generator; active
# slots DECAY on the device (budget exhausted or EOS sampled) by the same
# predicate the host applies to the emitted tokens, so the host's scheduling
# mirror stays consistent without a device write of its own.

def init_decode_state(num_slots: int,
                      generator: torch.Generator) -> Dict[str, Any]:
    """Per-slot autoregressive state (incl. the scratch slot) on the
    generator's device."""
    dev = generator.device
    return {
        "tokens": torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        "active": torch.zeros((num_slots,), dtype=torch.bool, device=dev),
        "temps": torch.zeros((num_slots,), dtype=torch.float32, device=dev),
        "budget": torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        "eos": torch.full((num_slots,), -1, dtype=torch.int32, device=dev),
        "generator": generator,
    }


def _merge_admit(state: Dict[str, Any], first: torch.Tensor,
                 slot_ids: torch.Tensor, temps: torch.Tensor,
                 budgets: torch.Tensor, eos: torch.Tensor,
                 real_mask: torch.Tensor) -> Dict[str, Any]:
    """Merge one admit batch into the decode state.  The sampled first token
    spends one unit of budget; a 1-token request (or an immediate EOS) is
    born inactive."""
    budgets = budgets - 1
    act = real_mask & (budgets > 0) & (first != eos)
    idx = (slot_ids.long(),)
    return {
        "tokens": state["tokens"].index_put(idx, first.to(torch.int32)),
        "active": state["active"].index_put(idx, act),
        "temps": state["temps"].index_put(idx, temps.float()),
        "budget": state["budget"].index_put(idx, budgets.to(torch.int32)),
        "eos": state["eos"].index_put(idx, eos.to(torch.int32)),
        "generator": state["generator"],
    }


def prefill_admit(params: Params, cache: KVCache, state: Dict[str, Any],
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  slot_ids: torch.Tensor, temps: torch.Tensor,
                  budgets: torch.Tensor, eos: torch.Tensor,
                  real_mask: torch.Tensor, cfg: TransformerConfig,
                  top_k: int = 0, compute_dtype=torch.bfloat16):
    """Prefill + sample + merge into the decode state.  Returns (cache,
    state, first_tokens [B])."""
    cache, logits = prefill(params, cache, tokens, lengths, slot_ids, cfg,
                            compute_dtype)
    first = sample_per_slot(logits, state["generator"], temps, top_k)
    state = _merge_admit(state, first, slot_ids, temps, budgets, eos,
                         real_mask)
    return cache, state, first


def decode_state_loop(params: Params, cache: KVCache, state: Dict[str, Any],
                      n_steps: int, cfg: TransformerConfig, top_k: int = 0,
                      compute_dtype=torch.bfloat16):
    """``n_steps`` decode+sample steps with on-device active decay.

    Returns (cache, state, emitted [n_steps, slots]).  A slot goes inactive
    the step its budget hits zero or it samples its EOS token; inactive
    slots repeat their last token (the host emits only to live requests)."""
    temps, eos, gen = state["temps"], state["eos"], state["generator"]
    toks, active, budget = state["tokens"], state["active"], state["budget"]
    emitted = []
    for _ in range(n_steps):
        cache, logits = decode_step(params, cache, toks, active, cfg,
                                    compute_dtype)
        nxt = sample_per_slot(logits, gen, temps, top_k)
        nxt = torch.where(active, nxt, toks)
        budget = torch.where(active, budget - 1, budget)
        active = active & (budget > 0) & (nxt != eos)
        toks = nxt
        emitted.append(nxt)
    state = {"tokens": toks, "active": active, "budget": budget,
             "temps": temps, "eos": eos, "generator": gen}
    return cache, state, torch.stack(emitted)
