"""Batch iteration with prefetch + streaming_split for multi-worker ingest.

Reference: ``python/ray/data/iterator.py`` (``DataIterator``),
``_internal/block_batching/`` (prefetching, format conversion) and the
``streaming_split`` coordinator (``_internal/execution/operators/
output_splitter.py`` + ``StreamSplitDataIterator``): one coordinator actor runs
the streaming executor; N consumers (train worker actors on different hosts)
pull coherent disjoint shards per epoch.  The port has no
``iter_jax_batches``: ``iter_torch_batches(device=...)`` puts batches on the
card.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Iterable, Iterator, List, Optional

import numpy as np

from ..core.api import get as ray_get
from ..core.api import remote as ray_remote
from .block import BlockAccessor
from .context import DataContext
from .operators import RefBundle, _iter_batches_of

_SENTINEL = object()


def iter_batches_over_bundles(bundles: Iterable[RefBundle], *,
                              batch_size: Optional[int] = 256,
                              batch_format: str = "default",
                              prefetch_batches: int = 1,
                              drop_last: bool = False,
                              local_shuffle_buffer_size: Optional[int] = None,
                              local_shuffle_seed: Optional[int] = None
                              ) -> Iterator[Any]:
    """Fetch blocks (prefetching ahead in a background thread) and re-batch."""
    fmt = batch_format if batch_format != "default" else \
        DataContext.get_current().default_batch_format
    q: "queue.Queue" = queue.Queue(maxsize=max(2, prefetch_batches * 2))
    err: List[BaseException] = []

    def fetcher():
        try:
            for bundle in bundles:
                for ref, _ in bundle.blocks:
                    q.put(ray_get(ref))
        except BaseException as e:  # noqa: BLE001
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=fetcher, daemon=True, name="block-fetcher")
    t.start()

    def block_stream():
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item

    stream = block_stream()
    if local_shuffle_buffer_size:
        stream = _shuffle_blocks(stream, local_shuffle_buffer_size,
                                 local_shuffle_seed)
    last = None
    for batch in _iter_batches_of(stream, batch_size, fmt):
        if last is not None:
            yield last
        last = batch
    if last is not None:
        if drop_last and batch_size and _batch_rows(last) < batch_size:
            return
        yield last


def _batch_rows(batch) -> int:
    if isinstance(batch, dict):
        return len(next(iter(batch.values()))) if batch else 0
    return len(batch)


def _shuffle_blocks(stream, buffer_rows: int, seed):
    """Row-level local shuffle: maintain a buffer of >= buffer_rows rows,
    emit shuffled slices (reference: ``ShufflingBatcher``)."""
    rng = np.random.default_rng(seed)
    import pyarrow as pa
    buf: List[Any] = []
    nrows = 0
    for block in stream:
        t = BlockAccessor.for_block(block).to_arrow()
        buf.append(t)
        nrows += t.num_rows
        while nrows >= buffer_rows * 2:
            merged = pa.concat_tables(buf, promote_options="default")
            perm = rng.permutation(merged.num_rows)
            merged = merged.take(pa.array(perm))
            out = merged.slice(0, merged.num_rows - buffer_rows)
            keep = merged.slice(merged.num_rows - buffer_rows)
            buf, nrows = [keep], keep.num_rows
            yield out
    if buf:
        merged = pa.concat_tables(buf, promote_options="default")
        if merged.num_rows:
            perm = rng.permutation(merged.num_rows)
            yield merged.take(pa.array(perm))


# ---------------------------------------------------------------------------
# streaming_split
# ---------------------------------------------------------------------------

class _SplitCoordinator:
    """Actor that executes the dataset once per epoch and deals blocks to n
    output splits (round-robin; ``equal=True`` truncates to equal row counts
    after the epoch's plan finishes executing)."""

    def __init__(self, ds, n: int, equal: bool):
        self._ds = ds
        self._n = n
        self._equal = equal
        self._epoch = -1
        self._lock = threading.Lock()
        self._queues: List[collections.deque] = []
        self._done = False
        self._error: Optional[str] = None

    def start_epoch(self, epoch: int) -> int:
        with self._lock:
            if epoch <= self._epoch:
                return self._epoch
            self._epoch = epoch
            self._queues = [collections.deque() for _ in range(self._n)]
            self._done = False
            self._error = None
            threading.Thread(target=self._feed, daemon=True).start()
            return self._epoch

    def _feed(self):
        try:
            pending: List[List] = [[] for _ in range(self._n)]
            rows: List[int] = [0] * self._n
            i = 0
            ds = self._ds
            # re-execute from the logical plan each epoch
            from .executor import StreamingExecutor
            from .planner import plan
            stream = StreamingExecutor(plan(ds._logical), "split").start() \
                if ds._materialized is None else iter(ds._materialized)
            flat: List = []
            for bundle in stream:
                for blk in bundle.blocks:
                    if self._equal:
                        flat.append(blk)
                    else:
                        tgt = min(range(self._n), key=lambda j: rows[j])
                        self._queues[tgt].append([blk])
                        rows[tgt] += blk[1].num_rows or 0
                    i += 1
            if self._equal:
                self._equalize(flat)
        except BaseException as e:  # noqa: BLE001
            self._error = repr(e)
        finally:
            self._done = True

    def _equalize(self, blocks: List):
        """Deal exactly ``total // n`` rows to each split, slicing blocks that
        straddle a split boundary (only the remainder rows are dropped)."""
        total = sum(m.num_rows or 0 for _, m in blocks)
        target = total // self._n
        slice_task = ray_remote(_slice_range)
        # global row span of each block
        spans, acc = [], 0
        for ref, meta in blocks:
            n = meta.num_rows or 0
            spans.append((ref, meta, acc, acc + n))
            acc += n
        for j in range(self._n):
            lo, hi = j * target, (j + 1) * target
            for ref, meta, s, e in spans:
                os_, oe = max(lo, s), min(hi, e)
                if os_ >= oe:
                    continue
                if os_ == s and oe == e:
                    self._queues[j].append([(ref, meta)])
                else:
                    res = ray_get(slice_task.remote(ref, os_ - s, oe - s))
                    if res:
                        self._queues[j].append(list(res))

    def next_blocks(self, split: int, epoch: int):
        """Returns (blocks|None, done: bool). Non-blocking poll."""
        if epoch != self._epoch:
            return None, False
        if self._error:
            raise RuntimeError(f"streaming_split failed: {self._error}")
        q = self._queues[split]
        if q:
            return q.popleft(), False
        return None, self._done

    def stats(self):
        return {"epoch": self._epoch, "done": self._done,
                "queued": [len(q) for q in self._queues]}


def _slice_range(block, start: int, end: int):
    acc = BlockAccessor.for_block(block)
    out = acc.slice(start, end)
    if BlockAccessor.for_block(out).num_rows() == 0:
        return []
    from ..core.api import put as ray_put
    return [(ray_put(out), BlockAccessor.for_block(out).metadata())]


class DataIterator:
    """One consumer's handle onto a streaming split. Picklable — send it to a
    train worker actor and call ``iter_batches`` there each epoch."""

    def __init__(self, coordinator, split: int):
        self._coord = coordinator
        self._split = split
        self._epoch = -1

    def _bundle_stream(self, epoch: int) -> Iterator[RefBundle]:
        ray_get(self._coord.start_epoch.remote(epoch))
        backoff = 0.002
        while True:
            blocks, done = ray_get(
                self._coord.next_blocks.remote(self._split, epoch))
            if blocks:
                backoff = 0.002
                yield RefBundle([tuple(b) for b in blocks])
            elif done:
                return
            else:
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.1)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "default", prefetch_batches: int = 1,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        self._epoch += 1
        yield from iter_batches_over_bundles(
            self._bundle_stream(self._epoch), batch_size=batch_size,
            batch_format=batch_format, prefetch_batches=prefetch_batches,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           device=None, **kwargs):
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy", **kwargs):
            yield {k: (torch.as_tensor(v).to(device) if device else
                       torch.as_tensor(v)) for k, v in batch.items()}


def build_streaming_split(ds, n: int, *, equal: bool = False
                          ) -> List[DataIterator]:
    from ..core.actor import ActorClass
    coord = ActorClass(_SplitCoordinator).remote(ds, n, equal)
    return [DataIterator(coord, i) for i in range(n)]
