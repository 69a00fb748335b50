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
* Tensor parallelism (``tp`` shards): ``params`` is then a list of shard
  trees and ``cache`` a list of shard caches (``models/convert.tp_split``),
  shard 0 first.  Each shard runs every block on its own replica of the
  residual stream with its q/KV heads and MLP columns (head counts come
  from the weights' shapes), and ``parallel.mesh.all_reduce`` sums the
  attention and MLP outputs; the replicated output biases ``bo`` and
  ``b_out`` are added once, after the sum.  The embedding, the final norm,
  the LM head, MoE routing and the decode state run once, on shard 0; the
  per-call indices, masks and positions are copied to the other shards'
  devices, and the lengths and block tables (replicated) are copied after
  each update.
* Prefill attention goes through ``ops.attention.mha`` (the flash kernel on
  CUDA for buckets >= 1024); attention over the cache keeps the JAX
  package's numerics: the cache layer in f32, plain torch ops
  (``_cache_attention``, shared with the paged cache and the speculative
  verify window).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from .. import device as _device
from ..ops import moe as moe_ops
from ..ops.attention import NEG_INF
from ..parallel.mesh import all_reduce, replicate
from .config import TransformerConfig
from .transformer import (Params, _mlp_block, _norm, _rope_tables, _rotate,
                          lm_head_weight, unbind_layers)

KVCache = Dict[str, torch.Tensor]
#: one device's params or cache, or one per tp shard (shard 0 first)
Sharded = Union[Dict[str, Any], List[Dict[str, Any]]]


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
    """x: [B, S, H] -> q [B,S,NH,D], k/v [B,S,NKV,D] with RoPE applied (the
    head counts of ``p``'s weights: a tp shard's own)."""
    b, s, _ = x.shape
    cast = x.dtype
    q = x @ p["wq"].to(cast)
    k = x @ p["wk"].to(cast)
    v = x @ p["wv"].to(cast)
    if "bq" in p:
        q = q + p["bq"].to(cast)
        k = k + p["bk"].to(cast)
        v = v + p["bv"].to(cast)
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if cfg.use_rope:
        q = _rope_per_row(q, positions, cfg.rope_theta)
        k = _rope_per_row(k, positions, cfg.rope_theta)
    return q, k, v


def _rope_per_row(x: torch.Tensor, positions: torch.Tensor,
                  theta: float) -> torch.Tensor:
    """RoPE with per-batch-row positions. x: [B, S, H, D]; positions: [B, S]."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)   # [B, S, D/2]
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def _mlp_parts(ys: List[torch.Tensor], lps: List[Params],
               cfg: TransformerConfig) -> List[torch.Tensor]:
    """Each shard's MLP output on its norm'd input ``ys[s]``, before the
    output bias: the shards' parts sum to the block's MLP.  MoE routes once,
    on shard 0, and every shard's experts take that routing (its aux loss is
    dropped)."""
    if cfg.num_experts == 1:
        return [_mlp_block(y, lp["mlp"], cfg) for y, lp in zip(ys, lps)]
    cap, r = moe_ops.moe_route(ys[0], lps[0]["moe"]["router"],
                               cfg.experts_per_token,
                               cfg.expert_capacity_factor)
    return [moe_ops.moe_experts(y, moe_ops.Routing(*(f.to(y.device)
                                                     for f in r)),
                                cap, lp["moe"]["w_gate"], lp["moe"]["w_in"],
                                lp["moe"]["w_out"])
            for y, lp in zip(ys, lps)]


def _shards(params: Sharded, cache: Sharded):
    """(param trees, caches), one per tp shard: a model on one device is
    one shard."""
    if isinstance(params, list):
        return params, cache
    return [params], [cache]


def _on_shards(shards: List[Params], *tensors: torch.Tensor) -> List[tuple]:
    """``tensors`` (on shard 0's device) for every shard, on its device."""
    devices = [p["embed"]["tokens"].device for p in shards]
    return list(zip(*(replicate(t, devices) for t in tensors)))


def _sync(caches: List[KVCache], *keys: str) -> None:
    """Copy shard 0's replicated cache entries (lengths, block tables) to
    the other shards' caches."""
    for c in caches[1:]:
        for key in keys:
            c[key].copy_(caches[0][key])


def _layers(shards: List[Params], x: torch.Tensor, positions: torch.Tensor,
            attend: Callable, cfg: TransformerConfig, cast) -> torch.Tensor:
    """Every block over the tp shards (one shard without tp).  ``x`` [B, Q,
    H] and ``positions`` [B, Q] lie on shard 0's device; each shard runs
    the blocks on a replica of its own, and the all-reduce of the attention
    and MLP outputs keeps the replicas bitwise equal; the replicated output
    biases are added after it.  ``attend(s, i, q, k, v)`` writes shard s's
    K/V of layer i into its cache and returns its attention output [B, Q,
    NH_s * D] in ``cast``.  Returns shard 0's hidden states after the last
    block.  (The loop keeps its Python calls per layer few: at tp=1 decode
    is host-bound.)"""
    devices = [p["embed"]["tokens"].device for p in shards]
    xs, pos = replicate(x, devices), replicate(positions, devices)
    layers = [unbind_layers(p["blocks"], cfg.num_layers) for p in shards]
    for i in range(cfg.num_layers):
        lps = [per_shard[i] for per_shard in layers]
        parts = [attend(s, i, *_qkv(_norm(x_s, lp["attn_norm"], cfg),
                                    lp["attn"], cfg, pos[s]))
                 @ lp["attn"]["wo"].to(cast)
                 for s, (x_s, lp) in enumerate(zip(xs, lps))]
        biases = [lp["attn"].get("bo") for lp in lps]
        xs = [x_s + (o if b is None else o + b.to(o.dtype))
              for x_s, o, b in zip(xs, all_reduce(parts), biases)]
        ys = [_norm(x_s, lp["mlp_norm"], cfg) for x_s, lp in zip(xs, lps)]
        biases = [lp.get("mlp", {}).get("b_out") for lp in lps]
        xs = [x_s + (o if b is None else o + b.to(o.dtype))
              for x_s, o, b in zip(xs, all_reduce(_mlp_parts(ys, lps, cfg)),
                                   biases)]
    return xs[0]


def last_writer(keys: torch.Tensor) -> torch.Tensor:
    """For each write i of a scatter to ``keys`` [N], the index of the last
    write to the same key.  Gathering a scatter's values through it makes
    duplicate writes identical, so the result is the JAX package's on the
    CPU (XLA applies a scatter in order: the last write wins) in whatever
    order the device applies them.  Where a slot's row then feeds MoE
    routing (the scratch slot that admit padding rows share, the null page
    of the paged cache), the expert capacity its token takes depends on
    which write won."""
    order = torch.argsort(keys, stable=True)
    ordered = keys[order]
    last = order[torch.searchsorted(ordered, ordered, right=True) - 1]
    return torch.empty_like(order).index_put_((order,), last)


def _cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, cfg: TransformerConfig
                     ) -> torch.Tensor:
    """Attention of queries over cache rows in f32, as the JAX package
    computes it: q [B, Q, NH, D], k/v [B, M, NKV, D], mask [B, Q, M] (True
    where a query may read a position; ``NEG_INF`` elsewhere, so a masked
    position gets a probability of exactly 0).  Returns [B, Q, NH*D] f32."""
    b, nq, nh = q.shape[:3]
    nkv = k.shape[2]
    qh = q.reshape(b, nq, nkv, nh // nkv, cfg.head_dim).float()
    scores = torch.einsum("bqgrd,bmgd->bgqrm", qh, k.float())
    scores.mul_(cfg.head_dim ** -0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores.div_(c).tanh_().mul_(c)
    scores.masked_fill_(~mask[:, None, :, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    attn = torch.einsum("bgqrm,bmgd->bqgrd", probs, v.float())
    return attn.reshape(b, nq, nh * cfg.head_dim)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(params: Sharded, cache: Sharded, tokens: torch.Tensor,
            lengths: torch.Tensor, slot_ids: torch.Tensor,
            cfg: TransformerConfig,
            compute_dtype=torch.bfloat16) -> Tuple[Sharded, torch.Tensor]:
    """Run the causal forward over right-padded prompts, fill the cache in
    place.

    tokens: [B, S] int (right-padded to the bucket length S)
    lengths: [B] true prompt lengths; slot_ids: [B] cache rows to fill.
    Returns (cache, last-token logits [B, V] f32).
    """
    from ..ops.attention import mha

    shards, caches = _shards(params, cache)
    head = shards[0]
    b, s = tokens.shape
    cast = compute_dtype
    slots = slot_ids.long()
    x = head["embed"]["tokens"][tokens.long()].to(cast)
    if not cfg.use_rope:
        x = x + head["embed"]["pos"][:s][None].to(cast)
    positions = torch.arange(s, device=x.device).expand(b, s)
    # admit padding rows share the scratch slot: the last one's K/V stays
    on = _on_shards(shards, slots, last_writer(slots))

    def attend(sh, i, q, k, v):
        # write this layer's K/V into the slots (padded tail included;
        # decode's length mask keeps it unread)
        slots_s, src = on[sh]
        k_lay, v_lay = caches[sh]["k"][i], caches[sh]["v"][i]
        k_lay[slots_s, :s] = k[src].to(k_lay.dtype)
        v_lay[slots_s, :s] = v[src].to(v_lay.dtype)
        attn = mha(q, k, v, causal=True,
                   logit_softcap=cfg.attn_logit_softcap)
        return attn.reshape(b, s, -1)

    x = _layers(shards, x, positions, attend, cfg, cast)
    # logits of each prompt's *last real token* (next-token distribution);
    # the norm is row-wise, so gathering the rows first changes nothing
    last_idx = (lengths.long() - 1).clamp(min=0)
    last = x[torch.arange(b, device=x.device), last_idx]          # [B, H]
    last = _norm(last, head["final_norm"], cfg)
    logits = (last @ lm_head_weight(head, cfg, cast)).float()
    caches[0]["length"][slots] = lengths.to(caches[0]["length"].dtype)
    _sync(caches, "length")
    return cache, logits


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def decode_step(params: Sharded, cache: Sharded, tokens: torch.Tensor,
                active: torch.Tensor, cfg: TransformerConfig,
                compute_dtype=torch.bfloat16) -> Tuple[Sharded, torch.Tensor]:
    """One autoregressive step for every slot.

    tokens: [slots] int — the last emitted token per slot
    active: [slots] bool — inactive slots compute garbage that is masked out
    Returns (cache, logits [slots, V] f32).  Appends K/V at position `length`
    (in place; dropped where `length` == max_len) and increments `length`
    for active slots.
    """
    shards, caches = _shards(params, cache)
    head, ctl = shards[0], caches[0]
    n_slots = tokens.shape[0]
    max_len = ctl["k"].shape[2]
    cast = compute_dtype
    lengths = ctl["length"].long()                             # [slots]
    dev = lengths.device
    x = head["embed"]["tokens"][tokens.long()][:, None].to(cast)  # [S,1,H]
    if not cfg.use_rope:
        x = x + head["embed"]["pos"][torch.clamp(
            lengths, max=cfg.max_seq_len - 1)][:, None].to(cast)
    positions = lengths[:, None]                               # [slots, 1]
    # mask over cache positions: <= current length (the new token's position)
    pos_mask = (torch.arange(max_len, device=dev)[None, None]
                <= positions[:, :, None])                      # [slots, 1, max_len]
    rows = torch.arange(n_slots, device=dev)
    # JAX drops the write of a slot standing at max_len; keep its row as is
    in_range = (lengths < max_len)[:, None, None]
    write_at = lengths.clamp(max=max_len - 1)
    on = _on_shards(shards, pos_mask, rows, in_range, write_at)

    def attend(sh, i, q, k, v):
        # append at position `length` (one row per slot), then attend over
        # the cache row in f32, as the JAX package does
        mask, rows_s, in_range_s, at = on[sh]
        k_lay, v_lay = caches[sh]["k"][i], caches[sh]["v"][i]
        k_lay[rows_s, at] = torch.where(in_range_s, k[:, 0].to(k_lay.dtype),
                                        k_lay[rows_s, at])
        v_lay[rows_s, at] = torch.where(in_range_s, v[:, 0].to(v_lay.dtype),
                                        v_lay[rows_s, at])
        return _cache_attention(q, k_lay, v_lay, mask, cfg).to(cast)

    x = _layers(shards, x, positions, attend, cfg, cast)
    x = _norm(x, head["final_norm"], cfg)
    logits = (x[:, 0] @ lm_head_weight(head, cfg, cast)).float()
    new_len = torch.where(active, torch.clamp(lengths + 1, max=max_len),
                          lengths)
    ctl["length"].copy_(new_len)
    _sync(caches, "length")
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


def decode_and_sample(params: Sharded, cache: Sharded, tokens: torch.Tensor,
                      active: torch.Tensor, temperature: torch.Tensor,
                      generator: torch.Generator, cfg: TransformerConfig,
                      top_k: int = 0, compute_dtype=torch.bfloat16
                      ) -> Tuple[Sharded, torch.Tensor]:
    """One decode step with on-device sampling.  Inactive slots keep their
    token."""
    cache, logits = decode_step(params, cache, tokens, active, cfg,
                                compute_dtype)
    nxt = sample_per_slot(logits, generator, temperature, top_k)
    return cache, torch.where(active, nxt, tokens)


def decode_loop(params: Sharded, cache: Sharded, tokens: torch.Tensor,
                active: torch.Tensor, temperature: torch.Tensor,
                generator: torch.Generator, n_steps: int,
                cfg: TransformerConfig, top_k: int = 0,
                compute_dtype=torch.bfloat16
                ) -> Tuple[Sharded, torch.Tensor, torch.Tensor]:
    """``n_steps`` decode steps.  Returns (cache, final tokens [slots],
    emitted [n_steps, slots])."""
    emitted = []
    for _ in range(n_steps):
        cache, tokens = decode_and_sample(params, cache, tokens, active,
                                          temperature, generator, cfg, top_k,
                                          compute_dtype)
        emitted.append(tokens)
    return cache, tokens, torch.stack(emitted)


def prefill_and_sample(params: Sharded, cache: Sharded, tokens: torch.Tensor,
                       lengths: torch.Tensor, slot_ids: torch.Tensor,
                       temperature: torch.Tensor, generator: torch.Generator,
                       cfg: TransformerConfig, top_k: int = 0,
                       compute_dtype=torch.bfloat16
                       ) -> Tuple[Sharded, torch.Tensor]:
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
    src = last_writer(idx[0])   # padding rows share the scratch slot
    return {
        "tokens": state["tokens"].index_put(idx, first[src].to(torch.int32)),
        "active": state["active"].index_put(idx, act[src]),
        "temps": state["temps"].index_put(idx, temps[src].float()),
        "budget": state["budget"].index_put(idx,
                                            budgets[src].to(torch.int32)),
        "eos": state["eos"].index_put(idx, eos[src].to(torch.int32)),
        "generator": state["generator"],
    }


def prefill_admit(params: Sharded, cache: Sharded, state: Dict[str, Any],
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


def decode_state_loop(params: Sharded, cache: Sharded, state: Dict[str, Any],
                      n_steps: int, cfg: TransformerConfig, top_k: int = 0,
                      compute_dtype=torch.bfloat16):
    """``n_steps`` decode+sample steps with on-device active decay.

    Returns (cache, state, emitted [n_steps, slots]).  A slot goes inactive
    the step its budget hits zero or it samples its EOS token; inactive
    slots repeat their last token (the host emits only to live requests)."""
    return _state_loop(decode_step, params, cache, state, n_steps, cfg,
                       top_k, compute_dtype)


def _state_loop(step, params: Sharded, cache: Sharded, state: Dict[str, Any],
                n_steps: int, cfg: TransformerConfig, top_k: int,
                compute_dtype):
    """``decode_state_loop`` over any one-token ``step`` with
    ``decode_step``'s signature (the dense or the paged cache's)."""
    temps, eos, gen = state["temps"], state["eos"], state["generator"]
    toks, active, budget = state["tokens"], state["active"], state["budget"]
    emitted = []
    for _ in range(n_steps):
        cache, logits = step(params, cache, toks, active, cfg, compute_dtype)
        nxt = sample_per_slot(logits, gen, temps, top_k)
        nxt = torch.where(active, nxt, toks)
        budget = torch.where(active, budget - 1, budget)
        active = active & (budget > 0) & (nxt != eos)
        toks = nxt
        emitted.append(nxt)
    state = {"tokens": toks, "active": active, "budget": budget,
             "temps": temps, "eos": eos, "generator": gen}
    return cache, state, torch.stack(emitted)
