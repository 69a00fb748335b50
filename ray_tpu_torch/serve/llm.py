"""Continuous-batching LLM inference engine: dense or paged KV cache,
optional speculative decoding.

Counterpart of the engine in ``ray_tpu/serve/llm.py``:
* The engine owns a KV cache and runs a scheduler loop on a dedicated
  thread: admit pending prompts into free slots via a **bucketed prefill**
  (prompts padded to the next length bucket, the batch padded to a fixed
  ``prefill_batch`` whose padding rows write into a scratch slot), then run
  ``steps_per_dispatch`` decode steps for the whole active batch.  New
  requests join the decode batch at the next dispatch boundary — continuous
  batching without ever changing a tensor shape.
* ``paged=True``: block-table pages instead of dense ``slots x max_len``
  rows (``models/paged_decode.py``), so memory scales with the requests'
  lengths.  Pages are planned per admission (prompt + generation budget);
  when the arena is full the request goes back to the queue
  (backpressure).  With ``prefix_cache`` identical full-page prompt
  prefixes share pages (refcounts) and only the uncached suffix is
  prefilled.
* ``spec_decode_enabled=True``: speculative decoding
  (``models/speculative.py``) with a layers-sliced draft
  (``spec_draft_layers`` leading blocks, sharing embed and lm head) on a
  dense draft cache; a dispatch runs ``max(1, steps_per_dispatch // k)``
  rounds, and with ``spec_adaptive`` k shrinks as the slots fill.  The
  draft's prefill swallows its errors (``draft_errors`` counts them):
  greedy acceptance keeps the output exact with any draft.
* Sampled tokens stay on the device until drained: the host reads a
  dispatch back only once ``fetch_lag`` newer dispatches are queued, so the
  card computes dispatch N+1 while the host reads dispatch N.
* ``tp=N``: in-replica tensor parallelism.  ``_apply_tp_sharding`` splits
  the params megatron-style over N shards (the JAX engine's rule,
  ``models/convert.tp_axis``): column-parallel q/k/v and MLP (and expert)
  input weights, row-parallel output weights, the rest replicated; each
  shard's KV cache holds its KV heads and is made on its own device.  One process drives the shards (the reference's one
  process over a ``tp`` mesh); the decode paths run each block on every
  shard and sum the partial outputs with ``parallel.mesh.all_reduce``.
  ``device=None`` places shard s on ``cuda:s``; one device places every
  shard on it (one card, or ``"cpu"`` in tests: the counterpart of the
  reference's virtual CPU mesh); a list of N devices places one shard on
  each.  ``tp`` must divide ``num_kv_heads``; speculative decoding does
  not compose with it, as in the reference.
* Runs on the card (``device=None`` means ``"cuda"``, and a missing card
  raises); the decode state, sampling and the scheduler's tensors live on
  shard 0's device.  A failure in a prefill or a decode dispatch reaches
  the affected callers' queues.

Not ported yet: the observability hooks (metrics, spans and gauges on the
runtime's metrics registry) and ``LLMServer`` / ``llm_deployment``, which
sit on the JAX package's runtime (ROADMAP A4).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import device as _device
from ..models import decode as dec
from ..models import paged_decode as pdec
from ..models import speculative as spec
from ..models import transformer
from ..models.convert import tp_split
from ..parallel.mesh import cuda_devices

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
_FLUSH = object()


class GenRequest:
    __slots__ = ("tokens", "max_tokens", "temperature", "top_k", "eos_id",
                 "out", "slot", "generated", "submitted_at", "first_token_at",
                 "pages", "prompt_len")

    def __init__(self, tokens: List[int], max_tokens: int,
                 temperature: float, top_k: int, eos_id: Optional[int]):
        self.tokens = tokens
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.out: "queue.Queue" = queue.Queue()
        self.slot = -1
        self.pages: List[int] = []
        self.generated = 0
        self.prompt_len = len(tokens)
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None


def _tp_devices(device, tp: int) -> List[torch.device]:
    """The tp shards' devices: ``None`` means one card per shard (``cuda:0``
    .. ``cuda:tp-1``; the current card at tp=1), one device every shard on
    it, a list of tp devices one shard on each."""
    if isinstance(device, (list, tuple)):
        if len(device) != tp:
            raise ValueError(f"tp={tp} needs {tp} devices, got {len(device)}")
        return [_device.resolve(d) for d in device]
    if device is None and tp > 1:
        cards = cuda_devices()
        if len(cards) < tp:
            raise ValueError(f"tp={tp} but only {len(cards)} devices")
        return cards[:tp]
    return [_device.resolve(device)] * tp


class LLMEngine:
    """Slot-scheduled continuous batching over prefill/decode calls.

    ``params``: a param tree (None draws one from ``seed``), or with
    ``tp > 1`` also one tree per shard, each on its shard's device
    (``models.convert.tp_params_from_numpy``)."""

    def __init__(self, cfg, params=None, *, num_slots: int = 8,
                 max_len: Optional[int] = None, buckets=DEFAULT_BUCKETS,
                 compute_dtype=None, seed: int = 0, top_k: int = 0,
                 fetch_lag: int = 2, steps_per_dispatch: int = 8,
                 prefill_batch: Optional[int] = None,
                 warmup_buckets: bool = False,
                 paged: bool = False, page_size: int = 64,
                 num_pages: Optional[int] = None, prefix_cache: bool = True,
                 tp: int = 1, spec_decode_enabled: bool = False,
                 spec_k: int = 4, spec_draft_layers: int = 1,
                 spec_adaptive: bool = True, device=None):
        if spec_decode_enabled and tp > 1:
            raise ValueError("spec_decode_enabled does not compose with "
                             "tp>1 yet (draft params are unsharded)")
        if cfg.num_kv_heads % tp:
            raise ValueError(f"tp={tp} must divide num_kv_heads="
                             f"{cfg.num_kv_heads}")
        self.tp = tp
        #: the shards' devices, shard 0 first; the engine's own is shard 0's
        self.devices = _tp_devices(device, tp)
        self.device = self.devices[0]
        self.cfg = cfg
        self.max_len = max_len or cfg.max_seq_len
        self.num_slots = num_slots
        self.buckets = tuple(b for b in buckets if b <= self.max_len)
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.top_k = top_k
        self.fetch_lag = max(0, fetch_lag)
        # decode steps per dispatch: one host readback per this many tokens
        # per slot, at the cost of <= steps_per_dispatch wasted steps after a
        # sequence finishes and <= one dispatch of added admission latency
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        if params is None:
            # at tp > 1 the whole tree once (tp=1's values), split below
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = transformer.init_params(gen, cfg, dtype=torch.bfloat16)
        if isinstance(params, list) or tp == 1:
            # a tree to split at tp > 1 may lie anywhere: it is copied
            trees = params if isinstance(params, list) else [params]
            homes = [t["embed"]["tokens"].device for t in trees]
            if homes != self.devices:
                raise ValueError(f"params are on {homes}, the engine's "
                                 f"shards on {self.devices}")
        self.params = params
        # Admission batches are padded to a FIXED size; padding rows write
        # into a scratch cache slot (index num_slots) decode never activates.
        self.prefill_batch = prefill_batch or min(num_slots, 8)
        self._scratch_slot = num_slots
        self.paged = paged
        # each shard's cache holds its KV heads and is made on its device
        # (the KV-head split of the whole cache, which is all zeros)
        shard_cfg = dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads
                                        // tp)
        if paged:
            self.page_size = page_size
            self.max_pages_per_slot = -(-self.max_len // page_size)
            # default budget: half the dense cache (the paged win)
            self.num_pages = num_pages or max(
                (num_slots + 1) * self.max_pages_per_slot // 2, 16)
            caches = [pdec.init_paged_cache(
                shard_cfg, self.num_pages, page_size, num_slots + 1,
                self.max_pages_per_slot, self.compute_dtype, d)
                for d in self.devices]
            self.allocator = pdec.PageAllocator(self.num_pages)
            self.prefix = (pdec.PrefixCache(self.allocator, page_size)
                           if prefix_cache else None)
        else:
            caches = [dec.init_kv_cache(shard_cfg, num_slots + 1,
                                        self.max_len, self.compute_dtype, d)
                      for d in self.devices]
        self.cache = caches if tp > 1 else caches[0]
        if tp > 1 and not isinstance(params, list):
            # no unsharded copy stays: a tree drawn here is dropped with
            # `params`, a caller's tree is the caller's
            self.params = self._apply_tp_sharding(params)
            del params
        self._state = dec.init_decode_state(
            num_slots + 1,
            torch.Generator(device=self.device).manual_seed(seed + 1))

        # Speculative decoding: a layers-sliced draft sharing embed/lm_head
        # with the target, on a dense cache.  The adaptive controller picks
        # k from occupancy (min k=2, never a plain-decode fallback, which
        # would strand the draft cache behind the target's).
        self.spec_enabled = bool(spec_decode_enabled)
        if self.spec_enabled:
            d = max(1, min(int(spec_draft_layers), cfg.num_layers - 1))
            self.spec_k = max(2, int(spec_k))
            self.spec_adaptive = bool(spec_adaptive)
            self.spec_draft_layers = d
            self._spec_draft_cfg = dataclasses.replace(cfg, num_layers=d)
            self._draft_params = spec.make_draft_params(self.params, d)
            self._draft_cache = dec.init_kv_cache(
                self._spec_draft_cfg, num_slots + 1, self.max_len,
                self.compute_dtype, self.device)
            self._spec_ks = sorted({self.spec_k,
                                    max(2, (self.spec_k + 1) // 2), 2},
                                   reverse=True)
            # accounting (breakdown()["spec"]), derived host-side from the
            # per-round emit counts only
            self.spec_rounds = 0
            self.spec_tokens = 0
            self.spec_drafted = 0
            self.spec_accepted = 0
            self.spec_draft_errors = 0
            #: the last error the draft's prefill swallowed
            self.spec_draft_last_error: Optional[BaseException] = None
            self.spec_dispatch_k: Dict[int, int] = {}

        # scheduler state
        self._pending: "queue.Queue[GenRequest]" = queue.Queue()
        self._active: Dict[int, GenRequest] = {}
        self._free_slots = list(range(num_slots))
        # dispatched-but-unfetched steps: (tokens_dev, {slot: req}, slots)
        self._unfetched: List[tuple] = []
        self._stop = False
        self._wake = threading.Event()
        # steady-state metrics
        self.steps = 0
        self.tokens_out = 0
        # admission accounting (padding waste = padded rows the fixed-size
        # prefill batch shipped for nothing)
        self.admit_batches = 0
        self.admit_rows_real = 0
        self.admit_rows_padded = 0
        #: admit batches per length bucket of the whole prompts (at buckets
        #: >= 1024 on CUDA, the dense prefill runs the flash kernel once per
        #: layer: the target's when the cache is dense, the draft's with
        #: speculative decoding; the paged prefill runs no kernel)
        self.admit_batches_by_bucket: Dict[int, int] = {}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()
        if warmup_buckets:
            for b in self.buckets:
                self.warmup(b)

    # ----------------------------------------------------------- public

    def submit(self, tokens: List[int], max_tokens: int = 64,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None) -> GenRequest:
        if len(tokens) >= self.max_len:
            raise ValueError(f"prompt length {len(tokens)} >= max_len "
                             f"{self.max_len}")
        req = GenRequest(list(map(int, tokens)), max_tokens, temperature,
                         top_k, eos_id)
        self._pending.put(req)
        self._wake.set()
        return req

    def generate(self, tokens: List[int], **kw) -> List[int]:
        """Blocking convenience: full output token list."""
        return list(self.stream(tokens, **kw))

    def stream(self, tokens: List[int], **kw) -> Iterator[int]:
        req = self.submit(tokens, **kw)
        while True:
            item = req.out.get()
            if item is _FLUSH:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)

    def breakdown(self) -> dict:
        """Serving-picture rollup: admission batch occupancy + padding
        waste, KV page utilization, prefix-cache hit rate, speculative
        acceptance."""
        rows = self.admit_rows_real + self.admit_rows_padded
        out = {
            "admit_batches": self.admit_batches,
            "batch_occupancy": (self.admit_rows_real / rows) if rows else 0.0,
            "padding_fraction": (self.admit_rows_padded / rows) if rows
            else 0.0,
            "active_slots": len(self._active),
            "num_slots": self.num_slots,
        }
        if self.paged:
            # total = allocatable pages (page 0 is the reserved null page),
            # so used/total equals the utilization field
            allocatable = max(self.num_pages - 1, 1)
            out["kv_pages"] = {
                "total": allocatable,
                "used": self.allocator.used(),
                "utilization": self.allocator.used() / allocatable,
            }
            out["prefix_cache"] = (self.prefix.stats()
                                   if self.prefix is not None else None)
        if self.spec_enabled:
            out["spec"] = {
                "k": self.spec_k,
                "draft_layers": self.spec_draft_layers,
                "rounds": self.spec_rounds,
                "tokens": self.spec_tokens,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                    if self.spec_drafted else 0.0),
                "rollback_tokens": self.spec_drafted - self.spec_accepted,
                "tokens_per_round": (self.spec_tokens / self.spec_rounds
                                     if self.spec_rounds else 0.0),
                "dispatch_k": dict(self.spec_dispatch_k),
                "draft_errors": self.spec_draft_errors,
            }
        return out

    def prefix_digest(self, cap: int = 32) -> Optional[dict]:
        """Bounded digest of this engine's hot first-page prefix chunks for
        cache-aware routing: ``{"page": page_size, "blocks": [8-hex
        truncated chunk hashes]}``.  None when the engine is dense or
        prefix caching is off."""
        if not self.paged or self.prefix is None:
            return None
        return {"page": self.page_size,
                "blocks": self.prefix.first_page_digest(cap)}

    def warmup(self, bucket: Optional[int] = None):
        """Run prefill(bucket)+decode once ahead of traffic."""
        b = bucket or self.buckets[0]
        req = self.submit([1] * min(4, b), max_tokens=2)
        while req.out.get() is not _FLUSH:
            pass

    # -------------------------------------------------------- tp sharding

    def _apply_tp_sharding(self, params):
        """Split a param tree over the tp shards megatron-style
        (``models/convert.tp_axis``: attention and MLP weights column then
        row parallel, small tensors replicated) -> one tree per shard on its
        shard's device, every leaf a contiguous tensor of its own.  The
        caches are made per shard (their KV heads split the same way)."""
        def place(t, s):
            return t.to(self.devices[s], memory_format=torch.contiguous_format,
                        copy=True)
        return tp_split(params, self.tp, place)

    # -------------------------------------------------------- scheduler

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_len

    def _loop(self):
        # shard 0's card; kernel launches set and restore their tensors'
        # own device, so no shard depends on this
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while not self._stop:
                did_work = False
                # admit: batch pending prompts of one bucket into one prefill
                admits: List[GenRequest] = []
                bucket = None
                while (len(admits) < len(self._free_slots)
                       and len(admits) < self.prefill_batch
                       and not self._pending.empty()):
                    nxt = self._pending.queue[0]
                    b = self._bucket_for(len(nxt.tokens))
                    if bucket is None:
                        bucket = b
                    if b != bucket:
                        break
                    admits.append(self._pending.get())
                if admits:
                    self._admit(admits, bucket)
                    did_work = True
                try:
                    if self._active:
                        self._dispatch_step()
                        did_work = True
                    # fetch completed steps once the pipeline is `fetch_lag`
                    # deep (the card computes step N+1 while the host reads N)
                    while len(self._unfetched) > (self.fetch_lag
                                                  if self._active else 0):
                        self._drain_one()
                        did_work = True
                except Exception as e:  # noqa: BLE001 - reaches the callers
                    self._fail_active(e)
                    did_work = True
                if not did_work:
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()

    def _fail_active(self, err: BaseException):
        """A decode dispatch or readback failed: every in-flight request gets
        the error, its slot and its pages back."""
        self._unfetched.clear()
        for s, r in list(self._active.items()):
            del self._active[s]
            self._free_slots.append(s)
            self._release_pages(r)
            r.out.put(err)
            r.out.put(_FLUSH)

    def _admit_arrays(self, reqs: List[GenRequest], bucket: int,
                      slots: List[int], starts: Optional[List[int]] = None):
        """Build one admit batch as plain numpy arrays (no device ops):
        each prompt from ``starts`` on (its cached prefix skipped)."""
        n_pad = self.prefill_batch - len(reqs)
        starts = starts or [0] * len(reqs)
        rows = [r.tokens[st:] for r, st in zip(reqs, starts)]
        toks = np.zeros((self.prefill_batch, bucket), np.int32)
        for i, row in enumerate(rows):
            toks[i, :len(row)] = row
        lengths = np.asarray([len(row) for row in rows] + [1] * n_pad,
                             np.int32)
        slots_arr = np.asarray(slots + [self._scratch_slot] * n_pad,
                               np.int32)
        temps = np.asarray([r.temperature for r in reqs] + [0.0] * n_pad,
                           np.float32)
        # effective budget mirrors the host retire predicate:
        # min(max_tokens, room left before max_len)
        budgets = np.asarray(
            [min(r.max_tokens, self.max_len - len(r.tokens)) for r in reqs]
            + [1] * n_pad, np.int32)
        eos = np.asarray(
            [-1 if r.eos_id is None else int(r.eos_id) for r in reqs]
            + [-1] * n_pad, np.int32)
        real_mask = np.asarray([True] * len(reqs) + [False] * n_pad)
        return toks, lengths, slots_arr, temps, budgets, eos, real_mask

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _admit(self, reqs: List[GenRequest], bucket: int):
        if self.paged:
            self._admit_paged(reqs, bucket)
            return
        slots = [self._free_slots.pop(0) for _ in reqs]
        arrays = self._admit_arrays(reqs, bucket, slots)
        try:
            (toks, lengths, slots_arr, temps, budgets, eos,
             real_mask) = self._to_device(*arrays)
            self.cache, self._state, first = dec.prefill_admit(
                self.params, self.cache, self._state, toks, lengths,
                slots_arr, temps, budgets, eos, real_mask, self.cfg,
                self.top_k, self.compute_dtype)
        except Exception as e:  # noqa: BLE001 - reaches the callers
            for r, s in zip(reqs, slots):
                self._free_slots.append(s)
                r.out.put(e)
                r.out.put(_FLUSH)
            return
        self._admitted(reqs, slots, first, bucket)

    def _admitted(self, reqs: List[GenRequest], slots: List[int],
                  first: torch.Tensor, bucket: int):
        """A prefill went through: the requests join the decode batch, the
        draft ingests their prompts, and their first tokens queue for the
        host."""
        snapshot = {}
        for r, s in zip(reqs, slots):
            r.slot = s
            self._active[s] = r
            snapshot[s] = r
        if self.spec_enabled:
            self._draft_prefill(reqs, slots)
        self._unfetched.append((first, snapshot, slots))
        self.steps += 1
        self.admit_batches += 1
        self.admit_batches_by_bucket[bucket] = (
            self.admit_batches_by_bucket.get(bucket, 0) + 1)
        self.admit_rows_real += len(reqs)
        self.admit_rows_padded += self.prefill_batch - len(reqs)

    def _plan_pages(self, r: GenRequest):
        """Reserve pages for one request: reuse cached prefix pages, allocate
        private pages for the rest of prompt + generation budget.  Returns
        (reused_tokens, page_row) or None when the arena is full."""
        page = self.page_size
        total = min(len(r.tokens) + r.max_tokens + 1, self.max_len)
        reused, rpages = 0, []
        if self.prefix is not None:
            # always leave >= 1 prompt token for the prefill (logits
            # needed), capped inside the lookup so the counters match the
            # reuse granted
            reused, rpages = self.prefix.match_prefix(
                r.tokens, max_pages=(len(r.tokens) - 1) // page)
        need = -(-total // page) - len(rpages)
        private = self.allocator.alloc(need)
        if private is None and self.prefix is not None:
            self.prefix.evict_some(need * 2)
            private = self.allocator.alloc(need)
        if private is None:
            self.allocator.release(rpages)
            return None
        if self.prefix is not None:
            # counted only on a successful plan: an arena-full requeue
            # retries this whole function and must not count twice
            self.prefix.count_lookup(reused)
        return reused, rpages + private

    def _admit_paged(self, reqs: List[GenRequest], bucket: int):
        planned = []
        for r in reqs:
            plan = self._plan_pages(r)
            if plan is None:
                # arena full: requeue (backpressure)
                self._pending.put(r)
                continue
            planned.append((r, plan))
        if not planned:
            return
        preqs = [r for r, _plan in planned]
        starts = [reused for _r, (reused, _pages) in planned]
        # suffix bucket: the longest uncached suffix, padded
        sbucket = self._bucket_for(max(
            len(r.tokens) - st for r, st in zip(preqs, starts)))
        slots = [self._free_slots.pop(0) for _ in planned]
        bt_rows = np.zeros((self.prefill_batch, self.max_pages_per_slot),
                           np.int32)
        for i, (r, (_reused, pages)) in enumerate(planned):
            r.pages = pages
            bt_rows[i, :len(pages)] = pages
        n_pad = self.prefill_batch - len(planned)
        arrays = self._admit_arrays(preqs, sbucket, slots, starts)
        starts_arr = np.asarray(starts + [0] * n_pad, np.int32)
        try:
            (toks, lengths, slots_arr, temps, budgets, eos, real_mask,
             start_pos, bt) = self._to_device(*arrays, starts_arr, bt_rows)
            self.cache, self._state, first = pdec.paged_prefill_admit(
                self.params, self.cache, self._state, toks, lengths,
                slots_arr, start_pos, bt, temps, budgets, eos, real_mask,
                self.cfg, self.top_k, self.compute_dtype)
        except Exception as e:  # noqa: BLE001 - reaches the callers
            for r, s in zip(preqs, slots):
                self._free_slots.append(s)
                self._release_pages(r)
                r.out.put(e)
                r.out.put(_FLUSH)
            return
        if self.prefix is not None:
            # register these prompts' full pages for future reuse
            for r in preqs:
                self.prefix.insert(r.tokens,
                                   r.pages[:len(r.tokens) // self.page_size])
        self._admitted(preqs, slots, first, bucket)

    def _draft_prefill(self, reqs: List[GenRequest], slots: List[int]):
        """Ingest the admitted prompts into the draft cache (KV only; the
        draft has no prefix cache, so always the full prompt from position
        0).  A failure here never fails the requests: greedy acceptance
        keeps the output exact even with a garbage draft (acceptance just
        collapses), so count it and go on."""
        bucket = self._bucket_for(max(len(r.tokens) for r in reqs))
        toks, lengths, slots_arr = self._admit_arrays(reqs, bucket, slots)[:3]
        try:
            self._draft_cache, _ = dec.prefill(
                self._draft_params, self._draft_cache,
                *self._to_device(toks, lengths, slots_arr),
                self._spec_draft_cfg, self.compute_dtype)
        except Exception as e:  # noqa: BLE001 - counted, see above
            self.spec_draft_errors += 1
            self.spec_draft_last_error = e

    def _spec_k_now(self) -> int:
        """Adaptive k: speculation pays when slots are idle (the verify
        window rides on weight traffic the batch pays anyway), so shrink
        the window as occupancy rises."""
        if not self.spec_adaptive or len(self._spec_ks) == 1:
            return self.spec_k
        occ = len(self._active) / max(1, self.num_slots)
        if occ <= 0.5:
            return self._spec_ks[0]
        if occ <= 0.85:
            return self._spec_ks[min(1, len(self._spec_ks) - 1)]
        return self._spec_ks[-1]

    def _dispatch_step(self):
        if self.spec_enabled:
            k = self._spec_k_now()
            # at most about steps_per_dispatch tokens per slot a dispatch,
            # the plain path's readback cadence
            rounds = max(1, self.steps_per_dispatch // k)
            res = spec.spec_decode_state_loop(
                self.params, self.cache, self._draft_params,
                self._draft_cache, self._state, k, rounds, self.cfg,
                self._spec_draft_cfg, self.paged, self.top_k,
                self.compute_dtype)
            self.cache = res["target_cache"]
            self._draft_cache = res["draft_cache"]
            self._state = res["state"]
            self._unfetched.append(
                ((res["tokens"], res["counts"], res["emit_counts"], k),
                 dict(self._active), "spec"))
            self.steps += rounds
            self.spec_dispatch_k[k] = self.spec_dispatch_k.get(k, 0) + 1
            return
        loop = (pdec.paged_decode_state_loop if self.paged
                else dec.decode_state_loop)
        self.cache, self._state, emitted = loop(
            self.params, self.cache, self._state, self.steps_per_dispatch,
            self.cfg, self.top_k, self.compute_dtype)
        self._unfetched.append((emitted, dict(self._active), None))
        self.steps += self.steps_per_dispatch

    def _drain_spec(self, payload, snapshot):
        """Fetch one speculative dispatch: emit each slot's accepted window
        and fold the per-round emit counts into the acceptance tallies (a
        round's emit_count e in 1..k means e-1 drafts accepted + one
        verified correction; the k-e rejected drafts are the rollback)."""
        tokens_dev, counts_dev, round_counts_dev, k = payload
        tokens = tokens_dev.cpu().numpy()   # waits for the dispatch
        counts = counts_dev.cpu().numpy()
        rounds = round_counts_dev.cpu().numpy()     # [num_rounds, slots]
        for row in rounds:
            act = int((row > 0).sum())
            if not act:
                continue
            self.spec_rounds += act
            self.spec_tokens += int(row.sum())
            self.spec_drafted += (k - 1) * act
            self.spec_accepted += int(
                np.minimum(np.maximum(row - 1, 0), k - 1).sum())
        now = time.monotonic()
        for s, r in snapshot.items():
            for j in range(int(counts[s])):
                if r.slot != s or self._active.get(s) is not r:
                    break
                if r.first_token_at is None:
                    r.first_token_at = now
                self._emit(r, int(tokens[s, j]))

    def _drain_one(self):
        tokens_dev, snapshot, prefill_slots = self._unfetched.pop(0)
        if prefill_slots == "spec":
            self._drain_spec(tokens_dev, snapshot)
            return
        tokens = tokens_dev.cpu().numpy()   # waits for the step to finish
        now = time.monotonic()
        if prefill_slots is not None:
            # prefill entry: tokens is [prefill_batch] in admit order
            for i, s in enumerate(prefill_slots):
                r = snapshot[s]
                r.first_token_at = now
                self._emit(r, int(tokens[i]))
        else:
            # decode entry: [steps_per_dispatch, slots]
            for k in range(tokens.shape[0]):
                for s, r in snapshot.items():
                    if r.slot == s and self._active.get(s) is r:
                        self._emit(r, int(tokens[k, s]))

    def _emit(self, r: GenRequest, token: int):
        r.tokens.append(token)
        r.generated += 1
        self.tokens_out += 1
        r.out.put(token)
        done = (r.generated >= r.max_tokens
                or (r.eos_id is not None and token == r.eos_id)
                or len(r.tokens) >= self.max_len)
        if done:
            self._retire(r)

    def _retire(self, r: GenRequest):
        # No device write: the decode loop decays `active` on the device by
        # the same budget/EOS predicate the host applies in _emit.
        if r.slot in self._active and self._active[r.slot] is r:
            del self._active[r.slot]
            self._free_slots.append(r.slot)
            self._release_pages(r)
        r.out.put(_FLUSH)

    def _release_pages(self, r: GenRequest):
        """Refcounted: shared prefix pages survive on the prefix cache's
        refs, private pages return to the free list.  Decode steps already
        queued may still write into released pages, but every such position
        is written again by its next owner's prefill or decode before it
        becomes readable."""
        if self.paged and r.pages:
            self.allocator.release(r.pages)
            r.pages = []
