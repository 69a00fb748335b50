"""All-to-all exchanges: shuffle, repartition, sort, groupby-aggregate.

Reference: ``python/ray/data/_internal/planner/exchange/`` and
``push_based_shuffle.py`` — a two-stage exchange: map tasks partition each
input block into N sub-blocks; reduce tasks merge partition i from every map
task. Driver coordinates over refs only (no block data crosses the driver).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..core.api import get as ray_get
from ..core.api import put as ray_put
from ..core.api import remote as ray_remote
from .aggregate import AggregateFn
from .block import Block, BlockAccessor, BlockMetadata
from .operators import RefBundle


# -- remote task bodies -----------------------------------------------------

def _split_block(block: Block, n: int, mode: str, meta: Any) -> List[Block]:
    """Partition one block into n sub-blocks. mode: 'random'|'hash'|'range'|'round'."""
    t = BlockAccessor.for_block(block).to_arrow()
    rows = t.num_rows
    if rows == 0:
        return [t.slice(0, 0)] * n
    if mode == "random":
        seed = meta
        rng = np.random.default_rng(seed)
        assign = rng.integers(0, n, size=rows)
    elif mode == "round":
        assign = np.arange(rows) % n
    elif mode == "hash":
        # Stable across worker processes (Python's hash() is salted per
        # process, which would scatter equal keys to different partitions).
        import zlib
        key = meta
        col = t.column(key).to_numpy(zero_copy_only=False)
        assign = np.array([zlib.crc32(repr(v).encode()) % n for v in col])
    elif mode == "range":
        key, boundaries, descending = meta
        col = t.column(key).to_numpy(zero_copy_only=False)
        assign = np.searchsorted(np.asarray(boundaries), col,
                                 side="right")
        if descending:
            assign = (n - 1) - assign
    else:
        raise ValueError(mode)
    out = []
    for i in range(n):
        mask = assign == i
        out.append(t.filter(pa.array(mask)))
    return out


def _merge_blocks(sort_key, descending: bool, *parts: Block) -> List[tuple]:
    tables = [BlockAccessor.for_block(p).to_arrow() for p in parts
              if BlockAccessor.for_block(p).num_rows() > 0]
    if not tables:
        return []
    merged = pa.concat_tables(tables, promote_options="default")
    if sort_key is not None:
        order = "descending" if descending else "ascending"
        merged = merged.sort_by([(sort_key, order)])
    return [(ray_put(merged), BlockAccessor.for_block(merged).metadata())]


def _agg_partition(key: Optional[str], aggs: List[AggregateFn], *parts: Block
                   ) -> List[tuple]:
    tables = [BlockAccessor.for_block(p).to_arrow() for p in parts
              if BlockAccessor.for_block(p).num_rows() > 0]
    if not tables:
        return []
    merged = pa.concat_tables(tables, promote_options="default")
    if key is None:
        row = {a.name: a.finalize(a.block_acc(merged)) for a in aggs}
        t = pa.table({k: [v] for k, v in row.items()})
    else:
        groups: dict = {}
        keycol = merged.column(key).to_numpy(zero_copy_only=False)
        uniq = pa.compute.unique(merged.column(key)).to_pylist()
        cols: dict = {key: []}
        for a in aggs:
            cols[a.name] = []
        for kv in sorted(uniq, key=lambda x: (x is None, x)):
            mask = pa.array(keycol == kv) if kv is not None else pa.array(
                [v is None for v in keycol])
            sub = merged.filter(mask)
            cols[key].append(kv)
            for a in aggs:
                cols[a.name].append(a.finalize(a.block_acc(sub)))
        t = pa.table(cols)
    return [(ray_put(t), BlockAccessor.for_block(t).metadata())]


def _sample_block(block: Block, key: str, n: int, seed: int) -> list:
    t = BlockAccessor.for_block(block).to_arrow()
    if t.num_rows == 0:
        return []
    rng = np.random.default_rng(seed)
    idx = rng.choice(t.num_rows, size=min(n, t.num_rows), replace=False)
    return t.column(key).take(pa.array(idx)).to_pylist()


# -- driver-side exchange builders -----------------------------------------

def _all_refs(bundles: List[RefBundle]) -> List[Tuple[Any, BlockMetadata]]:
    out = []
    for b in bundles:
        out.extend(b.blocks)
    return out


def run_exchange(bundles: List[RefBundle], *, num_outputs: Optional[int],
                 mode: str, meta_for_block: Callable[[int], Any],
                 sort_key=None, descending: bool = False,
                 reduce_fn=None) -> List[RefBundle]:
    """Generic 2-stage exchange over block refs."""
    blocks = _all_refs(bundles)
    if not blocks:
        return []
    n_out = num_outputs or len(blocks)
    split = ray_remote(_split_block).options(num_returns=n_out if n_out > 1 else 1)
    # Map stage: split every block into n_out partitions.
    parts: List[List[Any]] = [[] for _ in range(n_out)]
    for i, (ref, _) in enumerate(blocks):
        res = split.remote(ref, n_out, mode, meta_for_block(i))
        if n_out == 1:
            res = [res]
        for j, r in enumerate(res):
            parts[j].append(r)
    # Reduce stage.
    reduce_task = ray_remote(reduce_fn or _merge_blocks)
    out_refs = []
    for j in range(n_out):
        if reduce_fn is None:
            out_refs.append(reduce_task.remote(sort_key, descending, *parts[j]))
        else:
            out_refs.append(reduce_task.remote(*parts[j]))
    out: List[RefBundle] = []
    for r in out_refs:
        bundle_list = ray_get(r)
        if bundle_list:
            out.append(RefBundle(list(bundle_list)))
    return out


def random_shuffle_fn(seed: Optional[int], num_outputs: Optional[int]):
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        base = seed if seed is not None else np.random.randint(0, 2**31)
        return run_exchange(bundles, num_outputs=num_outputs, mode="random",
                            meta_for_block=lambda i: base + i)
    return bulk


def repartition_fn(num_outputs: int, shuffle: bool):
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        if shuffle:
            return run_exchange(bundles, num_outputs=num_outputs, mode="round",
                                meta_for_block=lambda i: None)
        # Fast path: split/concat by row counts without a full exchange.
        return _repartition_by_slicing(bundles, num_outputs)
    return bulk


def _repartition_by_slicing(bundles: List[RefBundle], n: int) -> List[RefBundle]:
    blocks = _all_refs(bundles)
    total = sum(m.num_rows or 0 for _, m in blocks)
    if total == 0:
        return []
    per = -(-total // n)
    # Build slice plan: output i takes rows [i*per, min((i+1)*per, total)).
    slice_task = ray_remote(_slice_concat)
    spans = []  # per input block: (ref, start_row_global)
    acc = 0
    for ref, m in blocks:
        spans.append((ref, acc, acc + (m.num_rows or 0)))
        acc += m.num_rows or 0
    out = []
    for i in range(n):
        lo, hi = i * per, min((i + 1) * per, total)
        if lo >= hi:
            break
        pieces = []
        for ref, s, e in spans:
            os_, oe = max(lo, s), min(hi, e)
            if os_ < oe:
                pieces.append((ref, os_ - s, oe - s))
        refs = [p[0] for p in pieces]
        cuts = [(p[1], p[2]) for p in pieces]
        out_ref = slice_task.remote(cuts, *refs)
        bl = ray_get(out_ref)
        if bl:
            out.append(RefBundle(list(bl)))
    return out


def _slice_concat(cuts: List[Tuple[int, int]], *blocks: Block) -> List[tuple]:
    tables = []
    for (s, e), b in zip(cuts, blocks):
        t = BlockAccessor.for_block(b).to_arrow().slice(s, e - s)
        if t.num_rows:
            tables.append(t)
    if not tables:
        return []
    merged = pa.concat_tables(tables, promote_options="default")
    return [(ray_put(merged), BlockAccessor.for_block(merged).metadata())]


def sort_fn(key: str, descending: bool):
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        blocks = _all_refs(bundles)
        if not blocks:
            return []
        n_out = len(blocks)
        # Sample boundaries.
        sample = ray_remote(_sample_block)
        sample_refs = [sample.remote(ref, key, 20, i) for i, (ref, _) in
                       enumerate(blocks)]
        samples = sorted(s for lst in ray_get(sample_refs) for s in lst)
        if not samples:
            return []
        if n_out > 1:
            qs = np.linspace(0, len(samples) - 1, n_out + 1)[1:-1]
            boundaries = [samples[int(q)] for q in qs]
            # dedupe to keep searchsorted monotonic
            boundaries = sorted(set(boundaries))
        else:
            boundaries = []
        n_out = len(boundaries) + 1
        return run_exchange(bundles, num_outputs=n_out, mode="range",
                            meta_for_block=lambda i: (key, boundaries, descending),
                            sort_key=key, descending=descending)
    return bulk


def aggregate_fn(key: Optional[str], aggs: List[AggregateFn]):
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        blocks = _all_refs(bundles)
        if not blocks:
            return []
        if key is None:
            # Global aggregate: single reduce over all blocks.
            task = ray_remote(_agg_partition)
            res = ray_get(task.remote(None, aggs, *[r for r, _ in blocks]))
            return [RefBundle(list(res))] if res else []
        n_out = min(len(blocks), 8)
        return run_exchange(bundles, num_outputs=n_out, mode="hash",
                            meta_for_block=lambda i: key,
                            reduce_fn=lambda *parts: _agg_partition(key, aggs, *parts))
    return bulk


def randomize_block_order_fn(seed: Optional[int]):
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        blocks = _all_refs(bundles)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(blocks))
        return [RefBundle([blocks[i]]) for i in idx]
    return bulk


def zip_fn(right_bundles_getter: Callable[[], List[RefBundle]]):
    def bulk(left: List[RefBundle]) -> List[RefBundle]:
        right = right_bundles_getter()
        lrefs = _all_refs(left)
        rrefs = _all_refs(right)
        task = ray_remote(_zip_all)
        res = ray_get(task.remote([r for r, _ in lrefs], [r for r, _ in rrefs]))
        return [RefBundle(list(res))] if res else []
    return bulk


def _zip_all(left_refs, right_refs) -> List[tuple]:
    lt = [BlockAccessor.for_block(ray_get(r)).to_arrow() for r in left_refs]
    rt = [BlockAccessor.for_block(ray_get(r)).to_arrow() for r in right_refs]
    lcat = pa.concat_tables(lt, promote_options="default") if lt else pa.table({})
    rcat = pa.concat_tables(rt, promote_options="default") if rt else pa.table({})
    if lcat.num_rows != rcat.num_rows:
        raise ValueError(
            f"zip requires equal row counts, got {lcat.num_rows} vs {rcat.num_rows}")
    cols = {}
    for name in lcat.column_names:
        cols[name] = lcat.column(name)
    for name in rcat.column_names:
        out_name = name if name not in cols else f"{name}_1"
        cols[out_name] = rcat.column(name)
    t = pa.table(cols)
    return [(ray_put(t), BlockAccessor.for_block(t).metadata())]
