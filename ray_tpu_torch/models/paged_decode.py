"""Paged KV cache + prefix caching: block tables over one page arena.

Counterpart of ``ray_tpu/models/paged_decode.py``, function for function:

* The cache is one tensor ``[L, num_pages, page, NKV, D]`` per K and V; a
  sequence's cache is the pages its **block table** row points at
  (``[slots, max_pages]`` int32).  Shapes never change.
* Page 0 is the **null page**: block tables point unused entries at it, and
  every write that must land nowhere (padding rows, inactive slots, window
  positions past a slot's pages) is sent there.  Every read of it is
  masked, and the mask gives those positions a probability of exactly 0,
  so the arena starts zeroed (``torch.zeros``): an uninitialised NaN there
  would survive the mask as 0 * NaN.  Duplicate writes into page 0 have no
  defined winner in ``index_put_``; that is harmless because page 0 is
  never read unmasked.
* As with the dense cache, where the JAX package donates the arena to a
  jitted program the port writes K/V, block-table rows and lengths **in
  place** and returns the same dict.  Layers run as a Python loop where
  JAX scans; the decode state carries a ``torch.Generator`` where JAX folds
  PRNG keys.
* Attention over the gathered pages is the JAX package's f32 einsums
  (``decode._cache_attention``); no kernel runs on this path, as none does
  in the reference.
* Under tensor parallelism ``params`` and ``cache`` are lists of shards,
  as in ``decode.py``: each shard's arena holds its KV heads, the block
  tables and lengths are replicated, and the write coordinates and masks
  are computed once, on shard 0, and copied to the other shards.
* Page allocation, refcounts and prefix hashing are host Python
  (``PageAllocator``, ``PrefixCache``), called per admit and retire, never
  per token.  ``PrefixCache._hash`` must stay byte-identical to the
  router's first-page block hash (4-byte little-endian tokens, 16-byte
  blake2b), so a router's digest lookups hit.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import device as _device
from .config import TransformerConfig
from .decode import (Sharded, _cache_attention, _layers, _merge_admit,
                     _on_shards, _shards, _state_loop, _sync, last_writer,
                     sample_per_slot)
from .transformer import Params, _norm, lm_head_weight

PagedKVCache = Dict[str, torch.Tensor]


def init_paged_cache(cfg: TransformerConfig, num_pages: int, page_size: int,
                     num_slots: int, max_pages_per_slot: int,
                     dtype=torch.bfloat16,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> PagedKVCache:
    """Allocate the page arena (zeroed: page 0 is read under the mask) and
    the block tables.  Allocators hand out pages 1..num_pages-1."""
    dev = _device.resolve(device)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "block_table": torch.zeros((num_slots, max_pages_per_slot),
                                   dtype=torch.int32, device=dev),
        "length": torch.zeros((num_slots,), dtype=torch.int32, device=dev),
    }


def paged_cache_bytes(cfg: TransformerConfig, num_pages: int, page_size: int,
                      dtype_bytes: int = 2) -> int:
    return (2 * cfg.num_layers * num_pages * page_size * cfg.num_kv_heads
            * cfg.head_dim * dtype_bytes)


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------

def _gather_pages(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """[P, page, NKV, D] through block-table rows [B, MP] -> [B, MP*page,
    NKV, D]."""
    g = pages[bt]
    return g.reshape(bt.shape[0], -1, *pages.shape[2:])


def _window_layers(shards: List[Params], caches: List[PagedKVCache],
                   x: torch.Tensor, positions: torch.Tensor, bt: torch.Tensor,
                   write, mask: torch.Tensor, cfg: TransformerConfig,
                   cast) -> torch.Tensor:
    """Every layer of a paged forward over a window of new tokens (a prompt
    suffix, one decode token, a verify window), on every tp shard: write
    each layer's K/V for the window as ``write`` (``_window_coords``: page,
    offset and source, flat over [B * Q]; page 0 for dropped writes) says,
    then attend over the gathered pages under ``mask`` [B, Q, span].
    Returns the final hidden states [B, Q, H] on shard 0."""
    b, nq = positions.shape
    on = _on_shards(shards, bt, mask, *write)

    def attend(sh, i, q, k, v):
        # write first, then attend over the gathered row (reused prefix
        # pages + the window itself) with the causal mask on absolute
        # positions: one code path covers both
        bt_s, mask_s, write_page, write_off, src = on[sh]
        k_pages, v_pages = caches[sh]["k"][i], caches[sh]["v"][i]
        k_pages[write_page, write_off] = k.reshape(
            b * nq, k.shape[2], -1)[src].to(k_pages.dtype)
        v_pages[write_page, write_off] = v.reshape(
            b * nq, v.shape[2], -1)[src].to(v_pages.dtype)
        return _cache_attention(q, _gather_pages(k_pages, bt_s),
                                _gather_pages(v_pages, bt_s), mask_s,
                                cfg).to(cast)

    x = _layers(shards, x, positions, attend, cfg, cast)
    return _norm(x, shards[0]["final_norm"], cfg)


def _window_coords(cache: PagedKVCache, bt: torch.Tensor,
                   positions: torch.Tensor, keep: torch.Tensor):
    """Scatter coordinates of window positions [B, Q] through block-table
    rows bt [B, MP]: (page [B*Q], offset [B*Q], source [B*Q]) with the
    positions ``keep`` marks False sent to the null page, and each write's
    values taken from the last write to the same page row (``last_writer``:
    the null page's rows end as JAX's); and the causal mask [B, Q, span]
    (a query reads absolute positions <= its own)."""
    page = cache["k"].shape[2]
    max_pages = bt.shape[1]
    kv_span = max_pages * page
    page_idx = bt.gather(1, (positions // page).clamp(max=max_pages - 1))
    safe_pi = torch.where(keep, page_idx, 0).reshape(-1)
    page_off = (positions % page).reshape(-1)
    mask = (torch.arange(kv_span, device=positions.device)[None, None]
            <= positions[:, :, None])
    return (safe_pi, page_off, last_writer(safe_pi * page + page_off)), mask


def _embed(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
           cfg: TransformerConfig, cast) -> torch.Tensor:
    x = params["embed"]["tokens"][tokens.long()].to(cast)
    if not cfg.use_rope:
        x = x + params["embed"]["pos"][
            positions.clamp(max=cfg.max_seq_len - 1)].to(cast)
    return x


def paged_prefill(params: Sharded, cache: Sharded, tokens: torch.Tensor,
                  lengths: torch.Tensor, slot_ids: torch.Tensor,
                  start_pos: torch.Tensor, cfg: TransformerConfig,
                  compute_dtype=torch.bfloat16
                  ) -> Tuple[Sharded, torch.Tensor]:
    """Causal forward over right-padded prompt suffixes; K/V land in pages.

    tokens:   [B, S] suffix tokens (positions start_pos .. start_pos+len)
    lengths:  [B] true suffix lengths (<= S)
    slot_ids: [B] slot whose block table routes the writes
    start_pos:[B] absolute position of tokens[:, 0] (0 unless a cached
              prefix was reused; reused pages are NOT written here)
    Returns (cache, last-real-token logits [B, V] f32).  Suffix queries also
    read the reused prefix pages (positions < start_pos) through the block
    table.
    """
    shards, caches = _shards(params, cache)
    head, ctl = shards[0], caches[0]
    b, s = tokens.shape
    dev = tokens.device
    slots = slot_ids.long()
    positions = start_pos.long()[:, None] + torch.arange(s, device=dev)[None]
    x = _embed(head, tokens, positions, cfg, compute_dtype)
    bt = ctl["block_table"][slots].long()                        # [B, MP]
    # padding positions of each row write into the null page
    valid_write = torch.arange(s, device=dev)[None] < lengths.long()[:, None]
    write, mask = _window_coords(ctl, bt, positions, valid_write)
    x = _window_layers(shards, caches, x, positions, bt, write, mask, cfg,
                       compute_dtype)
    last = x[torch.arange(b, device=dev),
             (lengths.long() - 1).clamp(min=0)]                  # [B, H]
    logits = (last @ lm_head_weight(head, cfg, compute_dtype)).float()
    ctl["length"][slots] = (start_pos + lengths).to(ctl["length"].dtype)
    _sync(caches, "length")
    return cache, logits


def paged_decode_step(params: Sharded, cache: Sharded,
                      tokens: torch.Tensor, active: torch.Tensor,
                      cfg: TransformerConfig, compute_dtype=torch.bfloat16
                      ) -> Tuple[Sharded, torch.Tensor]:
    """One token per active slot, attention over block-table pages.
    Inactive slots write into the null page (their old pages may already
    belong to another sequence)."""
    shards, caches = _shards(params, cache)
    head, ctl = shards[0], caches[0]
    lengths = ctl["length"].long()
    bt = ctl["block_table"].long()                                # [S, MP]
    positions = lengths[:, None]                                  # [S, 1]
    x = _embed(head, tokens[:, None], positions, cfg, compute_dtype)
    write, mask = _window_coords(ctl, bt, positions, active[:, None])
    x = _window_layers(shards, caches, x, positions, bt, write, mask, cfg,
                       compute_dtype)
    logits = (x[:, 0] @ lm_head_weight(head, cfg, compute_dtype)).float()
    ctl["length"].copy_(torch.where(active, lengths + 1, lengths))
    _sync(caches, "length")
    return cache, logits


def paged_verify_window(params: Params, cache: PagedKVCache,
                        tokens: torch.Tensor, active: torch.Tensor,
                        cfg: TransformerConfig, compute_dtype=torch.bfloat16
                        ) -> Tuple[PagedKVCache, torch.Tensor]:
    """Speculative-decode verify: a k-token window per slot over the paged
    cache (``speculative.verify_window`` through block tables).

    tokens: [slots, k] int — token j sits at absolute position
    ``length[s] + j``.  Returns (cache, logits [slots, k, V] f32);
    ``length`` advances by k for active slots (capped at the block-table
    span).  Callers roll ``length`` back to the accepted prefix afterwards:
    rollback is a length reset only.  Every window position lands in a page
    the slot already owns (private pages past the shared prefix), so a
    rejected position is unread garbage that the next round overwrites.
    Writes of inactive slots and of positions past the span go to the null
    page.
    """
    kwin = tokens.shape[1]
    page = cache["k"].shape[2]
    lengths = cache["length"].long()                              # [slots]
    bt = cache["block_table"].long()                              # [S, MP]
    kv_span = bt.shape[1] * page
    positions = (lengths[:, None]
                 + torch.arange(kwin, device=lengths.device)[None])  # [S, k]
    x = _embed(params, tokens, positions, cfg, compute_dtype)
    valid = active[:, None] & (positions < kv_span)
    write, mask = _window_coords(cache, bt, positions, valid)
    x = _window_layers([params], [cache], x, positions, bt, write, mask, cfg,
                       compute_dtype)
    logits = (x @ lm_head_weight(params, cfg, compute_dtype)).float()
    cache["length"].copy_(torch.where(
        active, torch.clamp(lengths + kwin, max=kv_span), lengths))
    return cache, logits


def paged_decode_loop(params: Params, cache: PagedKVCache,
                      tokens: torch.Tensor, active: torch.Tensor,
                      temperature: torch.Tensor, generator: torch.Generator,
                      n_steps: int, cfg: TransformerConfig, top_k: int = 0,
                      compute_dtype=torch.bfloat16
                      ) -> Tuple[PagedKVCache, torch.Tensor, torch.Tensor]:
    """``n_steps`` paged decode+sample steps.  Returns (cache, final tokens
    [slots], emitted [n_steps, slots])."""
    emitted = []
    for _ in range(n_steps):
        cache, logits = paged_decode_step(params, cache, tokens, active, cfg,
                                          compute_dtype)
        nxt = sample_per_slot(logits, generator, temperature, top_k)
        tokens = torch.where(active, nxt, tokens)
        emitted.append(tokens)
    return cache, tokens, torch.stack(emitted)


def paged_prefill_admit(params: Sharded, cache: Sharded,
                        state: Dict[str, Any], tokens: torch.Tensor,
                        lengths: torch.Tensor, slot_ids: torch.Tensor,
                        start_pos: torch.Tensor, bt_rows: torch.Tensor,
                        temps: torch.Tensor, budgets: torch.Tensor,
                        eos: torch.Tensor, real_mask: torch.Tensor,
                        cfg: TransformerConfig, top_k: int = 0,
                        compute_dtype=torch.bfloat16):
    """Paged admit: write the admitted slots' block-table rows ([B, MP]),
    prefill the uncached suffixes, sample, merge into the decode state
    (``decode.init_decode_state`` layout).  Returns (cache, state,
    first_tokens [B])."""
    caches = _shards(params, cache)[1]
    caches[0]["block_table"][slot_ids.long()] = bt_rows.to(
        caches[0]["block_table"].dtype)
    _sync(caches, "block_table")
    cache, logits = paged_prefill(params, cache, tokens, lengths, slot_ids,
                                  start_pos, cfg, compute_dtype)
    first = sample_per_slot(logits, state["generator"], temps, top_k)
    state = _merge_admit(state, first, slot_ids, temps, budgets, eos,
                         real_mask)
    return cache, state, first


def paged_decode_state_loop(params: Sharded, cache: Sharded,
                            state: Dict[str, Any], n_steps: int,
                            cfg: TransformerConfig, top_k: int = 0,
                            compute_dtype=torch.bfloat16):
    """Paged twin of ``decode.decode_state_loop`` (on-device active
    decay).  Returns (cache, state, emitted [n_steps, slots])."""
    return _state_loop(paged_decode_step, params, cache, state, n_steps, cfg,
                       top_k, compute_dtype)


# ---------------------------------------------------------------------------
# Host-side page allocator + prefix cache
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list page allocator with refcounts (page 0 = reserved null page).

    Prefix sharing gives pages refcount > 1; a page returns to the free list
    when its count hits zero.  Pure host Python — called per admit/retire,
    never per token."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    def available(self) -> int:
        return len(self._free)

    def used(self) -> int:
        """Pages currently referenced (the KV-utilization numerator; page 0
        is the reserved null page and counts as neither used nor free)."""
        return self.num_pages - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def incref(self, pages: Sequence[int]):
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: Sequence[int]):
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


class PrefixCache:
    """Content-hash -> page mapping for full-page prompt prefixes.

    A chunk key is the rolling hash of ALL tokens up to the end of that page
    (so two prompts share page i only if they agree on every token before
    it).  Eviction: a cached page with refcount 1 (cache-only) is reclaimed
    lazily when the allocator runs dry."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.alloc = allocator
        self.page = page_size
        self._map: Dict[bytes, int] = {}        # chunk hash -> page id
        self._lru: List[bytes] = []
        # first-page chunk keys (insertion-ordered): the bounded routing
        # digest reads these — a request can only start reusing at page 0
        self._first: Dict[bytes, None] = {}
        # lookup accounting: a lookup is a hit when >= 1 page was reused
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0
        self.evictions = 0

    @staticmethod
    def _hash(tokens: Sequence[int]) -> bytes:
        return hashlib.blake2b(
            b"".join(int(t).to_bytes(4, "little") for t in tokens),
            digest_size=16).digest()

    def match_prefix(self, tokens: Sequence[int],
                     max_pages: Optional[int] = None
                     ) -> Tuple[int, List[int]]:
        """Longest reusable page-aligned prefix.  Returns (n_tokens_reused,
        page_ids) with refcounts already taken.  ``max_pages`` caps the
        reuse (the engine must leave >= 1 prompt token to prefill for
        logits); capping here keeps the counters in agreement with what the
        caller reuses."""
        pages: List[int] = []
        n_full = len(tokens) // self.page
        if max_pages is not None:
            n_full = min(n_full, max_pages)
        reused = 0
        for i in range(n_full):
            key = self._hash(tokens[:(i + 1) * self.page])
            pid = self._map.get(key)
            if pid is None:
                break
            pages.append(pid)
            reused += self.page
        if pages:
            self.alloc.incref(pages)
        return reused, pages

    def count_lookup(self, tokens_reused: int):
        """Account one admission's prefix reuse — once per admitted request,
        not inside match_prefix: an arena-full retry re-runs the lookup and
        must not count twice."""
        self.lookups += 1
        if tokens_reused > 0:
            self.hits += 1
            self.tokens_reused += tokens_reused

    def stats(self) -> Dict[str, float]:
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
                "tokens_reused": self.tokens_reused,
                "cached_pages": len(self._map),
                "evictions": self.evictions}

    def insert(self, tokens: Sequence[int], page_ids: Sequence[int]):
        """Register freshly filled full pages for future reuse.  The cache
        holds one ref per registered page (released on eviction)."""
        n_full = min(len(tokens) // self.page, len(page_ids))
        for i in range(n_full):
            key = self._hash(tokens[:(i + 1) * self.page])
            if key in self._map:
                continue
            self._map[key] = page_ids[i]
            self.alloc.incref([page_ids[i]])
            self._lru.append(key)
            if i == 0:
                self._first[key] = None

    def evict_some(self, n: int = 8) -> int:
        """Drop up to n oldest cached chunks (returns pages whose only ref
        was the cache)."""
        dropped = 0
        while self._lru and dropped < n:
            key = self._lru.pop(0)
            pid = self._map.pop(key, None)
            self._first.pop(key, None)
            if pid is not None:
                self.alloc.release([pid])
                dropped += 1
        self.evictions += dropped
        return dropped

    def first_page_digest(self, cap: int = 32) -> List[str]:
        """Bounded digest of the hot first-page chunks for cache-aware
        routing: the newest ``cap`` first-page keys as 8-hex-char (32-bit)
        prefixes of the chunk hash, which a router computes the same way
        over a request's first ``page`` tokens."""
        keys = list(self._first)[-max(0, cap):]
        return [k.hex()[:8] for k in keys]
