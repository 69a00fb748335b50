"""Speculative decoding: draft-model lookahead + one-shot target verify.

Counterpart of ``ray_tpu/models/speculative.py``, function for function.
Decode streams all weights for one matvec per slot; speculation turns k of
those steps of the target into one [slots, k]-token pass
(``verify_window``) behind k cheap steps of a small draft.  Greedy
acceptance keeps the output equal to vanilla greedy decode: accept draft
tokens while they match the target's argmax at the same position, then emit
the target's own token at the first mismatch, so every verify emits >= 1
token.

Where the JAX package scans rounds under one compiled program, the port
loops in Python on the device's queue: no host sync between rounds either.
The caches are updated in place, as ``decode.py``'s are; rollback is a
length reset only, never a copy or a clear.  A write past the end of the
dense cache (a window that crosses ``max_len``) is dropped, as JAX drops an
out-of-range scatter: torch indexing would raise (a device assert on CUDA).
The sampling state carries a ``torch.Generator``, so only greedy slots
match JAX token for token.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .config import TransformerConfig
from .decode import (KVCache, _cache_attention, _layers, decode_step,
                     sample_per_slot)
from .paged_decode import paged_verify_window
from .transformer import Params, _norm, lm_head_weight

__all__ = ["verify_window", "speculative_round", "speculative_decode_loop",
           "spec_state_round", "spec_decode_state_loop", "make_draft_params",
           "damp_block_outputs"]


def verify_window(params: Params, cache: KVCache, tokens: torch.Tensor,
                  active: torch.Tensor, cfg: TransformerConfig,
                  compute_dtype=torch.bfloat16
                  ) -> Tuple[KVCache, torch.Tensor]:
    """Process a k-token window per slot in one forward.

    tokens: [slots, k] int — token j sits at cache position length+j
    active: [slots] bool
    Returns (cache, logits [slots, k, V] f32); K/V for all k positions are
    written in place (a position at or past ``max_len`` is dropped) and
    ``length`` advances by k for active slots, capped at ``max_len``.
    Callers roll length back to the accepted prefix afterwards; the garbage
    tail beyond ``length`` is never read.  With k=1 this is
    ``decode_step``'s math.
    """
    n_slots, k = tokens.shape
    max_len = cache["k"].shape[2]
    cast = compute_dtype
    lengths = cache["length"].long()                            # [slots]
    dev = lengths.device
    positions = lengths[:, None] + torch.arange(k, device=dev)[None]  # [S,k]
    x = params["embed"]["tokens"][tokens.long()].to(cast)       # [S,k,H]
    if not cfg.use_rope:
        x = x + params["embed"]["pos"][
            positions.clamp(max=cfg.max_seq_len - 1)].to(cast)
    # query j may see cache positions <= length+j (its own position)
    pos_mask = (torch.arange(max_len, device=dev)[None, None]
                <= positions[:, :, None])          # [slots, k, max_len]
    rows = torch.arange(n_slots, device=dev)
    in_range = (positions < max_len)[:, :, None, None]
    write_at = positions.clamp(max=max_len - 1)

    def attend(_, i, q, kk, vv):
        # one position of the window at a time: an out-of-range position
        # clamps onto max_len-1 and writes back what is there by then, so
        # two writes never race for one row
        k_lay, v_lay = cache["k"][i], cache["v"][i]
        for j in range(k):
            at = write_at[:, j]
            k_lay[rows, at] = torch.where(in_range[:, j],
                                          kk[:, j].to(k_lay.dtype),
                                          k_lay[rows, at])
            v_lay[rows, at] = torch.where(in_range[:, j],
                                          vv[:, j].to(v_lay.dtype),
                                          v_lay[rows, at])
        return _cache_attention(q, k_lay, v_lay, pos_mask, cfg).to(cast)

    x = _layers([params], x, positions, attend, cfg, cast)
    x = _norm(x, params["final_norm"], cfg)
    logits = (x @ lm_head_weight(params, cfg, cast)).float()
    cache["length"].copy_(torch.where(
        active, torch.clamp(lengths + k, max=max_len), lengths))
    return cache, logits


def _draft_rollout(draft_params: Params, draft_cache: KVCache,
                   last: torch.Tensor, active: torch.Tensor, k: int,
                   draft_cfg: TransformerConfig, compute_dtype):
    """k-1 greedy draft steps, then one KV-only step so that a fully
    accepted round leaves d_{k-1}'s row in the draft cache too (its logits
    are discarded).  Returns (draft_cache, drafts [slots, k-1] int32)."""
    tok, drafts = last, []
    for _ in range(k - 1):
        draft_cache, logits = decode_step(draft_params, draft_cache, tok,
                                          active, draft_cfg, compute_dtype)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        drafts.append(tok)
    draft_cache, _ = decode_step(draft_params, draft_cache, tok, active,
                                 draft_cfg, compute_dtype)
    if drafts:
        return draft_cache, torch.stack(drafts, dim=1)
    return draft_cache, last.new_zeros((last.shape[0], 0))


def _accepted(drafts: torch.Tensor, greedy: torch.Tensor) -> torch.Tensor:
    """Leading drafts that match the target's argmax at their position:
    the index of the first mismatch, k-1 when all match.  [slots] int64."""
    match = drafts == greedy[:, :-1]                         # [slots, k-1]
    return match.long().cumprod(dim=1).sum(dim=1)


def speculative_round(target_params: Params, target_cache: KVCache,
                      draft_params: Params, draft_cache: KVCache,
                      last_tokens: torch.Tensor, active: torch.Tensor,
                      k: int, target_cfg: TransformerConfig,
                      draft_cfg: TransformerConfig,
                      ) -> Tuple[KVCache, KVCache, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
    """One draft -> verify -> accept round for every slot (bf16 compute, as
    the JAX package's).

    Returns (target_cache, draft_cache, emitted [slots, k] int32,
    emit_count [slots] int32 in 1..k, new_last [slots]).  Emitted slots
    beyond emit_count hold garbage; inactive slots emit 0 tokens.  With
    drafts d_1..d_{k-1} and target logits l_0..l_{k-1} over the window
    [last, d_1..d_{k-1}], accept d_{j+1} while it equals argmax(l_j), then
    emit argmax(l_a) at the first mismatch.
    """
    n_slots = last_tokens.shape[0]
    dt = torch.bfloat16
    draft_cache, drafts = _draft_rollout(draft_params, draft_cache,
                                         last_tokens, active, k, draft_cfg,
                                         dt)
    window = torch.cat([last_tokens[:, None], drafts], dim=1)
    t_len0 = target_cache["length"].clone()
    target_cache, logits = verify_window(target_params, target_cache, window,
                                         active, target_cfg, dt)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)    # [slots, k]
    accepted = _accepted(drafts, greedy)
    emit_count = torch.where(active, accepted + 1, 0).to(torch.int32)
    correction = greedy.gather(1, accepted[:, None])         # [slots, 1]
    drafts_pad = torch.cat([drafts, drafts.new_zeros((n_slots, 1))], dim=1)
    emitted = torch.where(
        torch.arange(k, device=greedy.device)[None] < accepted[:, None],
        drafts_pad, correction)                               # [slots, k]
    new_last = torch.where(active, correction[:, 0], last_tokens)
    # context now ends with ...last, d_1..d_a; the correction token is fed
    # next round, so length = len0 + 1 + accepted
    new_len = t_len0 + 1 + accepted
    target_cache["length"].copy_(torch.where(active, new_len, t_len0))
    draft_cache["length"].copy_(torch.where(active, new_len,
                                            draft_cache["length"]))
    return target_cache, draft_cache, emitted, emit_count, new_last


def speculative_decode_loop(target_params: Params, target_cache: KVCache,
                            draft_params: Params, draft_cache: KVCache,
                            last_tokens: torch.Tensor, active: torch.Tensor,
                            k: int, num_rounds: int,
                            target_cfg: TransformerConfig,
                            draft_cfg: TransformerConfig,
                            eos_id: int = -1,
                            ) -> Dict[str, Any]:
    """``num_rounds`` spec rounds with no host sync between them.

    Returns {tokens: [slots, num_rounds*k], counts: [slots], target_cache,
    draft_cache, last_tokens, active, rounds_accepted: [slots,
    num_rounds]}; tokens beyond counts are garbage.  A slot that emits
    ``eos_id`` (if >= 0) deactivates for the remaining rounds.
    """
    out = _emit_buffer(last_tokens, k, num_rounds)
    counts = torch.zeros_like(last_tokens, dtype=torch.int32)
    emits, last = [], last_tokens
    for _ in range(num_rounds):
        target_cache, draft_cache, emitted, n_emit, last = speculative_round(
            target_params, target_cache, draft_params, draft_cache, last,
            active, k, target_cfg, draft_cfg)
        keep = _append(out, counts, emitted, n_emit)
        counts = counts + n_emit
        emits.append(n_emit)
        if eos_id >= 0:
            hit_eos = (torch.where(keep, emitted, -1) == eos_id).any(dim=1)
            active = active & ~hit_eos
    return {"tokens": out, "counts": counts,
            "target_cache": target_cache, "draft_cache": draft_cache,
            "last_tokens": last, "active": active,
            "rounds_accepted": torch.stack(emits, dim=1)}


def _emit_buffer(tokens: torch.Tensor, k: int,
                 num_rounds: int) -> torch.Tensor:
    """Per-slot emit buffer [slots, num_rounds*k] int32."""
    return torch.zeros((tokens.shape[0], num_rounds * k), dtype=torch.int32,
                       device=tokens.device)


def _append(out: torch.Tensor, counts: torch.Tensor, emitted: torch.Tensor,
            n_emit: torch.Tensor) -> torch.Tensor:
    """Write emitted[:, :n_emit] at out[:, counts:counts+n_emit] in place;
    returns the mask of kept window entries [slots, k]."""
    k = emitted.shape[1]
    dev = out.device
    row = torch.arange(out.shape[0], device=dev)[:, None]
    idx = (counts[:, None] + torch.arange(k, device=dev)[None]).clamp(
        max=out.shape[1] - 1).long()
    keep = torch.arange(k, device=dev)[None] < n_emit[:, None]
    out[row, idx] = torch.where(keep, emitted, out[row, idx])
    return keep


# ---------------------------------------------------------------------------
# Serving-engine integration: decode-state rounds (continuous batching)
# ---------------------------------------------------------------------------

def spec_state_round(target_params: Params, target_cache, draft_params:
                     Params, draft_cache: KVCache, state: Dict[str, Any],
                     k: int, target_cfg: TransformerConfig,
                     draft_cfg: TransformerConfig, paged: bool = False,
                     top_k: int = 0, compute_dtype=torch.bfloat16):
    """One speculative round against the engine's decode state
    (``decode.init_decode_state`` layout), the serving twin of
    ``speculative_round``:

    * Greedy slots (temperature 0) accept while matching; sampled slots
      accept no drafts and emit one token drawn from the target's own
      first-position logits through ``sample_per_slot``, the distribution a
      vanilla step samples.
    * ``emit_count`` is clamped to the remaining budget and cut at the
      first emitted EOS (inclusive); budget and active decay on the device
      by the predicate ``decode_state_loop`` applies per step.
    * ``paged=True`` verifies through ``paged_decode.paged_verify_window``.
      Either way rollback resets ``length`` to ``len0 + emit_count`` (the
      cache then covers ``last, e_1..e_{cnt-1}``; ``e_cnt`` is fed back
      next round).

    The draft cache is always dense.  Returns (target_cache, draft_cache,
    state, emitted [slots, k], emit_count [slots]).
    """
    n_slots = state["tokens"].shape[0]
    last, active = state["tokens"], state["active"]
    temps, gen = state["temps"], state["generator"]
    dev = last.device

    draft_cache, drafts = _draft_rollout(draft_params, draft_cache, last,
                                         active, k, draft_cfg, compute_dtype)
    window = torch.cat([last[:, None], drafts], dim=1)
    t_len0 = target_cache["length"].clone()
    verify = paged_verify_window if paged else verify_window
    target_cache, logits = verify(target_params, target_cache, window,
                                  active, target_cfg, compute_dtype)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)    # [slots, k]

    is_greedy = temps <= 0.0
    accepted = torch.where(is_greedy, _accepted(drafts, greedy), 0)
    # sampled slots draw token 0 from the target's own next-token logits
    samp = sample_per_slot(logits[:, 0], gen, temps, top_k)
    correction = greedy.gather(1, accepted[:, None])[:, 0]
    first_tok = torch.where(is_greedy, correction, samp)
    drafts_pad = torch.cat([drafts, drafts.new_zeros((n_slots, 1))], dim=1)
    window_idx = torch.arange(k, device=dev)[None]
    emitted = torch.where(window_idx < accepted[:, None], drafts_pad,
                          first_tok[:, None])                 # [slots, k]

    # budget clamp + EOS cut (the device mirrors the host's retire)
    emit_count = torch.where(active, accepted + 1, 0)
    emit_count = torch.minimum(emit_count, state["budget"].clamp(min=0))
    eos_hits = ((emitted == state["eos"][:, None])
                & (window_idx < emit_count[:, None]))
    has_eos = eos_hits.any(dim=1)
    emit_count = torch.where(has_eos, eos_hits.long().argmax(dim=1) + 1,
                             emit_count).to(torch.int32)

    # roll both caches back to the verified prefix
    new_len = t_len0 + emit_count
    target_cache["length"].copy_(torch.where(active, new_len, t_len0))
    draft_cache["length"].copy_(torch.where(active, new_len,
                                            draft_cache["length"]))

    new_last = emitted.gather(1, (emit_count.long() - 1).clamp(min=0)[:, None])
    new_last = torch.where(active & (emit_count > 0), new_last[:, 0], last)
    new_budget = torch.where(active, state["budget"] - emit_count,
                             state["budget"])
    state = {"tokens": new_last, "active": active & (new_budget > 0) & ~has_eos,
             "temps": temps, "budget": new_budget, "eos": state["eos"],
             "generator": gen}
    return target_cache, draft_cache, state, emitted, emit_count


def spec_decode_state_loop(target_params: Params, target_cache,
                           draft_params: Params, draft_cache: KVCache,
                           state: Dict[str, Any], k: int, num_rounds: int,
                           target_cfg: TransformerConfig,
                           draft_cfg: TransformerConfig, paged: bool = False,
                           top_k: int = 0, compute_dtype=torch.bfloat16
                           ) -> Dict[str, Any]:
    """``num_rounds`` decode-state spec rounds, the engine's speculative
    twin of ``decode_state_loop`` (one dispatch, no host sync between
    rounds).

    Returns {tokens: [slots, num_rounds*k] (per-slot emit buffer; entries
    beyond counts are garbage), counts: [slots], emit_counts: [num_rounds,
    slots] (the host derives drafted/accepted/rollback tallies from these
    alone), target_cache, draft_cache, state}.
    """
    out = _emit_buffer(state["tokens"], k, num_rounds)
    counts = torch.zeros_like(state["tokens"], dtype=torch.int32)
    emits = []
    for _ in range(num_rounds):
        target_cache, draft_cache, state, emitted, n_emit = spec_state_round(
            target_params, target_cache, draft_params, draft_cache, state, k,
            target_cfg, draft_cfg, paged, top_k, compute_dtype)
        _append(out, counts, emitted, n_emit)
        counts = counts + n_emit
        emits.append(n_emit)
    return {"tokens": out, "counts": counts, "emit_counts": torch.stack(emits),
            "target_cache": target_cache, "draft_cache": draft_cache,
            "state": state}


# ---------------------------------------------------------------------------
# Draft-model construction
# ---------------------------------------------------------------------------

def _map_tree(fn, tree, path=()):
    return {k: _map_tree(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def make_draft_params(params: Params, num_layers: int) -> Params:
    """Layers-sliced draft: the leading ``num_layers`` blocks of the stacked
    target params (views, no copy), sharing embed, final norm and lm head.
    This is the zero-training draft the serving engine defaults to; greedy
    acceptance keeps the output exact whatever the draft says."""
    return {key: (_map_tree(lambda _p, a: a[:num_layers], val)
                  if key == "blocks" else val)
            for key, val in params.items()}


def damp_block_outputs(params: Params, scale: float = 0.05,
                       from_layer: int = 0) -> Params:
    """Param surgery for synthetic (randomly initialised) weights, out of
    place: scale the output projections (attention ``wo``, MLP ``w_out``
    and their biases) of every block with index >= ``from_layer`` by
    ``scale``.  With ``from_layer = draft_layers`` the target's deep tail
    adds only a small residual perturbation on top of the layers a sliced
    draft shares, so the pair agrees at rates a trained pair shows, while
    the target still pays its full depth per step.  Never for real
    checkpoints."""
    def _scale(path, leaf):
        if path[-1] not in ("wo", "bo", "w_out", "b_out"):
            return leaf
        # stacked block params carry the leading layer dim
        mult = torch.where(
            torch.arange(leaf.shape[0], device=leaf.device) >= from_layer,
            torch.tensor(scale, dtype=leaf.dtype, device=leaf.device),
            torch.tensor(1.0, dtype=leaf.dtype, device=leaf.device))
        return leaf * mult.reshape((-1,) + (1,) * (leaf.ndim - 1))

    out = dict(params)
    out["blocks"] = _map_tree(_scale, params["blocks"])
    return out
