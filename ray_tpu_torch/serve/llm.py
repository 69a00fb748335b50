"""Continuous-batching LLM inference engine (dense KV cache).

Counterpart of the dense engine in ``ray_tpu/serve/llm.py``:
* The engine owns a slot-based KV cache (``models/decode.py``) and runs a
  scheduler loop on a dedicated thread: admit pending prompts into free slots
  via a **bucketed prefill** (prompts padded to the next length bucket, the
  batch padded to a fixed ``prefill_batch`` whose padding rows write into a
  scratch slot), then run ``steps_per_dispatch`` decode steps for the whole
  active batch.  New requests join the decode batch at the next dispatch
  boundary — continuous batching without ever changing a tensor shape.
* Sampled tokens stay on the device until drained: the host reads a
  dispatch back only once ``fetch_lag`` newer dispatches are queued, so the
  card computes dispatch N+1 while the host reads dispatch N.
* Runs on the card (``device=None`` means ``"cuda"``, and a missing card
  raises); the engine thread runs on the engine's device.  A failure in a
  prefill or a decode dispatch reaches the affected callers' queues.

Not ported yet (``NotImplementedError``): the paged cache, speculative
decoding and tensor parallelism.  The observability hooks, ``LLMServer`` and
``llm_deployment`` sit on the JAX package's runtime and are left out.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import device as _device
from ..models import decode as dec
from ..models import transformer
from ..models.transformer import _not_ported

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
_FLUSH = object()


class GenRequest:
    __slots__ = ("tokens", "max_tokens", "temperature", "top_k", "eos_id",
                 "out", "slot", "generated", "submitted_at", "first_token_at",
                 "prompt_len")

    def __init__(self, tokens: List[int], max_tokens: int,
                 temperature: float, top_k: int, eos_id: Optional[int]):
        self.tokens = tokens
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.out: "queue.Queue" = queue.Queue()
        self.slot = -1
        self.generated = 0
        self.prompt_len = len(tokens)
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None


class LLMEngine:
    """Slot-scheduled continuous batching over prefill/decode calls."""

    def __init__(self, cfg, params=None, *, num_slots: int = 8,
                 max_len: Optional[int] = None, buckets=DEFAULT_BUCKETS,
                 compute_dtype=None, seed: int = 0, top_k: int = 0,
                 fetch_lag: int = 2, steps_per_dispatch: int = 8,
                 prefill_batch: Optional[int] = None,
                 warmup_buckets: bool = False, paged: bool = False,
                 tp: int = 1, spec_decode_enabled: bool = False,
                 device=None):
        if paged:
            raise _not_ported("paged=True", "queue A, models/paged_decode.py")
        if spec_decode_enabled:
            raise _not_ported("spec_decode_enabled=True",
                              "queue A, models/speculative.py")
        if tp > 1:
            raise _not_ported("tp > 1", "queue A, engine tensor parallelism")
        self.device = _device.resolve(device)
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
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = transformer.init_params(gen, cfg, dtype=torch.bfloat16)
        if params["embed"]["tokens"].device != self.device:
            raise ValueError(
                f"params are on {params['embed']['tokens'].device}, the "
                f"engine on {self.device}")
        self.params = params
        # Admission batches are padded to a FIXED size; padding rows write
        # into a scratch cache slot (index num_slots) decode never activates.
        self.prefill_batch = prefill_batch or min(num_slots, 8)
        self._scratch_slot = num_slots
        self.cache = dec.init_kv_cache(cfg, num_slots + 1, self.max_len,
                                       self.compute_dtype, self.device)
        self._state = dec.init_decode_state(
            num_slots + 1,
            torch.Generator(device=self.device).manual_seed(seed + 1))

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
        #: admit batches per length bucket (buckets >= 1024 run the flash
        #: kernel on CUDA, one launch per layer)
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
        waste."""
        rows = self.admit_rows_real + self.admit_rows_padded
        return {
            "admit_batches": self.admit_batches,
            "batch_occupancy": (self.admit_rows_real / rows) if rows else 0.0,
            "padding_fraction": (self.admit_rows_padded / rows) if rows
            else 0.0,
            "active_slots": len(self._active),
            "num_slots": self.num_slots,
        }

    def warmup(self, bucket: Optional[int] = None):
        """Run prefill(bucket)+decode once ahead of traffic."""
        b = bucket or self.buckets[0]
        req = self.submit([1] * min(4, b), max_tokens=2)
        while req.out.get() is not _FLUSH:
            pass

    # -------------------------------------------------------- scheduler

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_len

    def _loop(self):
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
        the error and its slot back."""
        self._unfetched.clear()
        for s, r in list(self._active.items()):
            del self._active[s]
            self._free_slots.append(s)
            r.out.put(err)
            r.out.put(_FLUSH)

    def _admit_arrays(self, reqs: List[GenRequest], bucket: int,
                      slots: List[int]):
        """Build one admit batch as plain numpy arrays (no device ops)."""
        n_pad = self.prefill_batch - len(reqs)
        toks = np.zeros((self.prefill_batch, bucket), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r.tokens)] = r.tokens
        lengths = np.asarray([len(r.tokens) for r in reqs] + [1] * n_pad,
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

    def _admit(self, reqs: List[GenRequest], bucket: int):
        slots = [self._free_slots.pop(0) for _ in reqs]
        arrays = self._admit_arrays(reqs, bucket, slots)
        try:
            (toks, lengths, slots_arr, temps, budgets, eos,
             real_mask) = [torch.from_numpy(a).to(self.device) for a in arrays]
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
        snapshot = {}
        for r, s in zip(reqs, slots):
            r.slot = s
            self._active[s] = r
            snapshot[s] = r
        self._unfetched.append((first, snapshot, slots))
        self.steps += 1
        self.admit_batches += 1
        self.admit_batches_by_bucket[bucket] = (
            self.admit_batches_by_bucket.get(bucket, 0) + 1)
        self.admit_rows_real += len(reqs)
        self.admit_rows_padded += self.prefill_batch - len(reqs)

    def _dispatch_step(self):
        self.cache, self._state, emitted = dec.decode_state_loop(
            self.params, self.cache, self._state, self.steps_per_dispatch,
            self.cfg, self.top_k, self.compute_dtype)
        self._unfetched.append((emitted, dict(self._active), None))
        self.steps += self.steps_per_dispatch

    def _drain_one(self):
        tokens_dev, snapshot, prefill_slots = self._unfetched.pop(0)
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
        r.out.put(_FLUSH)
