"""Dataset: lazy, distributed, streaming-executed data pipelines.

Reference: ``python/ray/data/dataset.py`` (class :178, ``map_batches`` :397,
``streaming_split`` :1149, ``iter_batches`` :3499). A Dataset wraps a logical
plan; transformations append logical ops; consumption plans + runs the
streaming executor over the cluster's task/actor substrate.  The port has
no ``iter_jax_batches``: ``iter_torch_batches(device=...)`` puts batches on
the card.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

from ..core.api import get as ray_get
from . import logical as L
from .aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum
from .block import BlockAccessor, BlockMetadata
from .context import DataContext
from .executor import StreamingExecutor, execute_to_bundles
from .operators import RefBundle, _iter_batches_of
from .planner import plan


def _normalize_compute(compute, concurrency):
    if concurrency is None and compute is None:
        return "tasks"
    if concurrency is not None:
        if isinstance(concurrency, int):
            return ("actors", concurrency, concurrency)
        mn, mx = concurrency
        return ("actors", mn, mx)
    return compute


class Dataset:
    def __init__(self, logical_op: L.LogicalOp):
        self._logical = logical_op
        self._materialized: Optional[List[RefBundle]] = None

    # -- plan helpers --------------------------------------------------------
    def _with(self, op: L.LogicalOp) -> "Dataset":
        op.input_op = self._logical
        return Dataset(op)

    def _execute(self) -> List[RefBundle]:
        if self._materialized is None:
            self._materialized = execute_to_bundles(plan(self._logical))
        return self._materialized

    def _stream(self) -> Iterator[RefBundle]:
        if self._materialized is not None:
            return iter(self._materialized)
        return StreamingExecutor(plan(self._logical)).start()

    # -- transformations -----------------------------------------------------
    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "default", compute=None,
                    concurrency=None, fn_args=(), fn_kwargs=None,
                    fn_constructor_args=(), zero_copy_batch: bool = False,
                    **ray_remote_args) -> "Dataset":
        return self._with(L.MapBatches(
            fn=fn, batch_size=batch_size, batch_format=batch_format,
            compute=_normalize_compute(compute, concurrency),
            fn_args=tuple(fn_args), fn_kwargs=dict(fn_kwargs or {}),
            fn_constructor_args=tuple(fn_constructor_args),
            zero_copy_batch=zero_copy_batch, ray_remote_args=ray_remote_args))

    def map(self, fn: Callable, *, compute=None, concurrency=None,
            **ray_remote_args) -> "Dataset":
        return self._with(L.MapRows(
            fn=fn, compute=_normalize_compute(compute, concurrency),
            ray_remote_args=ray_remote_args))

    def filter(self, fn: Callable, **ray_remote_args) -> "Dataset":
        return self._with(L.Filter(fn=fn, ray_remote_args=ray_remote_args))

    def flat_map(self, fn: Callable, **ray_remote_args) -> "Dataset":
        return self._with(L.FlatMap(fn=fn, ray_remote_args=ray_remote_args))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch
        return self.map_batches(add, batch_format="pandas")

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(t: pa.Table):
            return t.drop_columns([c for c in cols if c in t.column_names])
        return self.map_batches(drop, batch_format="pyarrow")

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(t: pa.Table):
            return t.select(cols)
        return self.map_batches(select, batch_format="pyarrow")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def ren(t: pa.Table):
            return t.rename_columns([mapping.get(c, c) for c in t.column_names])
        return self.map_batches(ren, batch_format="pyarrow")

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(n=n))

    def repartition(self, num_blocks: int, *, shuffle: bool = False) -> "Dataset":
        return self._with(L.Repartition(num_outputs=num_blocks, shuffle=shuffle))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        if seed is None:
            seed = DataContext.get_current().seed
        return self._with(L.RandomShuffle(seed=seed, num_outputs=num_blocks))

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(L.RandomizeBlockOrder(seed=seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(L.Sort(key=key, descending=descending))

    def union(self, *others: "Dataset") -> "Dataset":
        op = L.Union()
        op.extra_inputs = [o._logical for o in others]
        return self._with(op)

    def zip(self, other: "Dataset") -> "Dataset":
        op = L.Zip()
        op.extra_inputs = [other._logical]
        return self._with(op)

    def groupby(self, key: Optional[str]) -> "GroupedData":
        return GroupedData(self, key)

    # -- aggregations --------------------------------------------------------
    def aggregate(self, *aggs: AggregateFn) -> Dict[str, Any]:
        ds = self._with(L.Aggregate(key=None, aggs=list(aggs)))
        rows = ds.take_all()
        return rows[0] if rows else {}

    def count(self) -> int:
        # Fast path: sum block metadata row counts.
        total = 0
        for b in self._stream():
            n = b.num_rows()
            if n is None:
                return self.aggregate(Count())["count()"]
            total += n
        return total

    def sum(self, on: str):
        return self.aggregate(Sum(on))[f"sum({on})"]

    def min(self, on: str):
        return self.aggregate(Min(on))[f"min({on})"]

    def max(self, on: str):
        return self.aggregate(Max(on))[f"max({on})"]

    def mean(self, on: str):
        return self.aggregate(Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof))[f"std({on})"]

    # -- consumption ---------------------------------------------------------
    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        stream = self.limit(n)._stream()
        for bundle in stream:
            for ref, _ in bundle.blocks:
                acc = BlockAccessor.for_block(ray_get(ref))
                out.extend(acc.take(n - len(out)))
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for bundle in self._stream():
            for ref, _ in bundle.blocks:
                out.extend(BlockAccessor.for_block(ray_get(ref)).iter_rows())
        return out

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "default"):
        fmt = batch_format if batch_format != "default" else \
            DataContext.get_current().default_batch_format
        for batch in self.iter_batches(batch_size=batch_size, batch_format=fmt):
            return batch
        raise ValueError("dataset is empty")

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def schema(self):
        for bundle in self._stream():
            for ref, meta in bundle.blocks:
                if meta.schema is not None:
                    return meta.schema
                return BlockAccessor.for_block(ray_get(ref)).schema()
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s.names) if isinstance(s, pa.Schema) else None

    def num_blocks(self) -> int:
        return sum(len(b.blocks) for b in self._execute())

    def size_bytes(self) -> int:
        return sum(b.size_bytes() for b in self._execute())

    def materialize(self) -> "Dataset":
        self._execute()
        out = Dataset(L.InputData(bundles=self._materialized))
        out._materialized = self._materialized
        return out

    def stats(self) -> str:
        bundles = self._execute()
        rows = sum(b.num_rows() or 0 for b in bundles)
        return (f"Dataset: {len(bundles)} bundles, "
                f"{sum(len(b.blocks) for b in bundles)} blocks, {rows} rows, "
                f"{sum(b.size_bytes() for b in bundles)} bytes")

    # -- iteration -----------------------------------------------------------
    def iter_rows(self) -> Iterator[Any]:
        for bundle in self._stream():
            for ref, _ in bundle.blocks:
                yield from BlockAccessor.for_block(ray_get(ref)).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "default", prefetch_batches: int = 1,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        from .iterator import iter_batches_over_bundles
        yield from iter_batches_over_bundles(
            self._stream(), batch_size=batch_size, batch_format=batch_format,
            prefetch_batches=prefetch_batches, drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device: Optional[str] = None,
                           **kwargs) -> Iterator[Any]:
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy", **kwargs):
            out = {}
            for k, v in batch.items():
                t = torch.as_tensor(v)
                if device:
                    t = t.to(device)
                out[k] = t
            yield out

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List["DataIterator"]:
        from .iterator import build_streaming_split
        return build_streaming_split(self, n, equal=equal)

    def split(self, n: int) -> List["Dataset"]:
        bundles = self._execute()
        blocks = [blk for b in bundles for blk in b.blocks]
        out = []
        for i in range(n):
            part = blocks[i::n]
            ds = Dataset(L.InputData(bundles=[RefBundle(part)] if part else []))
            ds._materialized = [RefBundle(part)] if part else []
            out.append(ds)
        return out

    # -- export --------------------------------------------------------------
    def to_pandas(self):
        import pandas as pd
        dfs = []
        for bundle in self._stream():
            for ref, _ in bundle.blocks:
                dfs.append(BlockAccessor.for_block(ray_get(ref)).to_pandas())
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def to_arrow(self) -> pa.Table:
        ts = []
        for bundle in self._stream():
            for ref, _ in bundle.blocks:
                ts.append(BlockAccessor.for_block(ray_get(ref)).to_arrow())
        return pa.concat_tables(ts, promote_options="default") if ts else pa.table({})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return BlockAccessor.for_block(self.to_arrow()).to_numpy()

    def _write(self, path: str, fmt: str, **writer_args):
        ds = self._with(L.Write(path=path, file_format=fmt,
                                writer_args=writer_args))
        paths = []
        for bundle in execute_to_bundles(plan(ds._logical), "write"):
            for ref, _ in bundle.blocks:
                paths.extend(ray_get(ref).column("path").to_pylist())
        return paths

    def write_parquet(self, path: str, **kw):
        return self._write(path, "parquet", **kw)

    def write_csv(self, path: str, **kw):
        return self._write(path, "csv", **kw)

    def write_json(self, path: str, **kw):
        return self._write(path, "json", **kw)

    def write_numpy(self, path: str, **kw):
        return self._write(path, "npy", **kw)

    def write_tfrecords(self, path: str, **kw):
        return self._write(path, "tfrecords", **kw)

    def write_orc(self, path: str, **kw):
        return self._write(path, "orc", **kw)

    def write_webdataset(self, path: str, **kw):
        return self._write(path, "tar", **kw)

    def write_sql(self, sql: str, connection_factory) -> int:
        """Execute ``sql`` (an INSERT with ? placeholders) once per row;
        returns rows written (reference: ``Dataset.write_sql``)."""
        n = 0
        conn = connection_factory()
        try:
            cur = conn.cursor()
            for bundle in self._stream():
                for ref, _ in bundle.blocks:
                    acc = BlockAccessor.for_block(ray_get(ref))
                    rows = [tuple(r.values()) if isinstance(r, dict) else (r,)
                            for r in acc.iter_rows()]
                    cur.executemany(sql, rows)  # one round trip per block
                    n += len(rows)
            conn.commit()
        finally:
            conn.close()
        return n

    def write_mongo(self, uri: str, database: str, collection: str, *,
                    client_factory=None) -> int:
        """Insert every row as a document; returns documents written
        (reference: ``Dataset.write_mongo``; client_factory injects the
        pymongo client on this no-pymongo image).  One client serves the
        whole write, like write_sql's single connection."""
        from .datasource import _close_quietly, _default_mongo_client
        factory = client_factory or _default_mongo_client(uri)
        n = 0
        client = factory()
        try:
            coll = client[database][collection]
            for bundle in self._stream():
                for ref, _ in bundle.blocks:
                    acc = BlockAccessor.for_block(ray_get(ref))
                    docs = [dict(r) if isinstance(r, dict) else {"value": r}
                            for r in acc.iter_rows()]
                    if docs:
                        coll.insert_many(docs)
                        n += len(docs)
        finally:
            _close_quietly(client)
        return n

    def __repr__(self):
        names = [op.name() for op in self._logical.chain()]
        return f"Dataset({' -> '.join(names)})"


class GroupedData:
    """Reference: ``python/ray/data/grouped_data.py``."""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return self._ds._with(L.Aggregate(key=self._key, aggs=list(aggs)))

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn: Callable, *, batch_format: str = "default") -> Dataset:
        key = self._key
        sorted_ds = self._ds.sort(key) if key else self._ds

        def apply_groups(t: pa.Table):
            import pyarrow.compute as pc
            outs = []
            if t.num_rows == 0:
                return t
            keys = t.column(key).to_numpy(zero_copy_only=False)
            uniq = list(dict.fromkeys(keys.tolist()))
            fmt = batch_format if batch_format != "default" else \
                DataContext.get_current().default_batch_format
            for kv in uniq:
                sub = t.filter(pc.equal(t.column(key), pa.scalar(kv)))
                batch = BlockAccessor.for_block(sub).to_batch(fmt)
                out = fn(batch)
                from .block import batch_to_block
                outs.append(BlockAccessor.for_block(batch_to_block(out)).to_arrow())
            return pa.concat_tables(outs, promote_options="default")

        return sorted_ds.map_batches(apply_groups, batch_format="pyarrow",
                                     batch_size=None)
