"""ray_tpu_torch.data — distributed datasets with streaming execution.

Reference surface: ``python/ray/data/__init__.py`` — read_* constructors,
from_* converters, Dataset, aggregations, DataContext.
"""

from __future__ import annotations

from typing import Any, List, Optional

from . import logical as L
from .aggregate import AbsMax, AggregateFn, Count, Max, Mean, Min, Std, Sum
from .block import Block, BlockAccessor, BlockMetadata
from .context import DataContext
from .dataset import Dataset, GroupedData
from .datasource import (BinaryDatasource, BlocksDatasource, CSVDatasource,
                         Datasource, ImageDatasource, ItemsDatasource,
                         JSONDatasource, NumpyDatasource, ParquetDatasource,
                         RangeDatasource, ReadTask, SQLDatasource,
                         TextDatasource, TFRecordDatasource)
from .iterator import DataIterator


def read_datasource(datasource: Datasource, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(datasource=datasource, parallelism=parallelism))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1) -> Dataset:
    return read_datasource(RangeDatasource(n, tensor_shape=tuple(shape)),
                           parallelism=parallelism)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return read_datasource(ItemsDatasource(list(items)), parallelism=parallelism)


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return read_datasource(BlocksDatasource(dfs))


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return read_datasource(BlocksDatasource(tables))


def from_numpy(arrays) -> Dataset:
    import numpy as np
    if not isinstance(arrays, list):
        arrays = [arrays]
    blocks = [BlockAccessor.for_block([{"data": row} for row in a]).to_arrow()
              for a in arrays]
    return read_datasource(BlocksDatasource(blocks))


def from_huggingface(hf_dataset) -> Dataset:
    """Zero-copy from a HuggingFace datasets.Dataset (arrow-backed)."""
    table = hf_dataset.data.table if hasattr(hf_dataset.data, "table") \
        else hf_dataset.data
    return from_arrow(table.combine_chunks())


def from_torch(torch_dataset, *, block_size: int = 1000) -> Dataset:
    """Materialize a torch ``Dataset`` (map- or iterable-style) into
    blocks (reference: ``read_api.py`` ``from_torch``). A single-value
    item becomes a row ``{"item": value}``; a tuple item (the
    ``(features, label)`` convention) becomes ``{"item_0": ...,
    "item_1": ...}`` columns. Tensors convert to numpy so the blocks
    stay framework-neutral."""

    def to_np(v):
        return v.numpy() if hasattr(v, "numpy") else v

    def to_row(x):
        if isinstance(x, (tuple, list)):
            # mixed-type tuples (tensor, int-label) cannot share one
            # Arrow column — split into item_i fields
            return {f"item_{i}": to_np(v) for i, v in enumerate(x)}
        return {"item": to_np(x)}

    from builtins import range as _range  # this module shadows range()

    if hasattr(torch_dataset, "__len__") and hasattr(torch_dataset,
                                                     "__getitem__"):
        # map-style: index explicitly — plain iteration would fall back
        # to the sequence protocol, which never terminates on datasets
        # that don't raise IndexError
        items = (torch_dataset[i] for i in _range(len(torch_dataset)))
    elif hasattr(torch_dataset, "__iter__"):
        items = iter(torch_dataset)
    else:
        raise ValueError(
            "from_torch needs an iterable-style dataset (__iter__) or a "
            "map-style one with BOTH __len__ and __getitem__ — a bare "
            "__getitem__ would be iterated via the sequence protocol, "
            "which never terminates when IndexError is never raised")
    blocks, cur = [], []
    for item in items:
        cur.append(to_row(item))
        if len(cur) >= block_size:
            blocks.append(BlockAccessor.for_block(cur).to_arrow())
            cur = []
    if cur or not blocks:
        blocks.append(BlockAccessor.for_block(cur).to_arrow())
    return read_datasource(BlocksDatasource(blocks))


def read_parquet(paths, *, parallelism: int = -1, columns=None) -> Dataset:
    return read_datasource(ParquetDatasource(paths, columns=columns),
                           parallelism=parallelism)


def read_csv(paths, *, parallelism: int = -1, **arrow_csv_args) -> Dataset:
    return read_datasource(CSVDatasource(paths, **arrow_csv_args),
                           parallelism=parallelism)


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(JSONDatasource(paths), parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(NumpyDatasource(paths), parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(BinaryDatasource(paths), parallelism=parallelism)


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(TextDatasource(paths), parallelism=parallelism)


def read_tfrecords(paths, *, parallelism: int = -1, raw: bool = False) -> Dataset:
    return read_datasource(TFRecordDatasource(paths, raw=raw),
                           parallelism=parallelism)


def read_orc(paths, *, parallelism: int = -1, columns=None) -> Dataset:
    from .datasource import ORCDatasource
    return read_datasource(ORCDatasource(paths, columns=columns),
                           parallelism=parallelism)


def read_webdataset(paths, *, parallelism: int = -1) -> Dataset:
    from .datasource import WebDatasetDatasource
    return read_datasource(WebDatasetDatasource(paths),
                           parallelism=parallelism)


def read_sql(sql: str, connection_factory, *, shard_queries=None,
             parallelism: int = -1) -> Dataset:
    return read_datasource(
        SQLDatasource(sql, connection_factory, shard_queries=shard_queries),
        parallelism=parallelism)


def read_images(paths, *, size=None, mode=None, parallelism: int = -1) -> Dataset:
    return read_datasource(ImageDatasource(paths, size=size, mode=mode),
                           parallelism=parallelism)


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline=None, client_factory=None,
               parallelism: int = -1) -> Dataset:
    """Reference: ``ray.data.read_mongo`` — see MongoDatasource for the
    pymongo/client_factory contract on this no-pymongo image."""
    from .datasource import MongoDatasource
    return read_datasource(
        MongoDatasource(uri, database, collection, pipeline=pipeline,
                        client_factory=client_factory),
        parallelism=parallelism)


__all__ = [
    "Dataset", "GroupedData", "DataContext", "DataIterator", "Datasource",
    "ReadTask", "Block", "BlockAccessor", "BlockMetadata",
    "AggregateFn", "Count", "Sum", "Min", "Max", "Mean", "Std", "AbsMax",
    "read_datasource", "range", "range_tensor", "from_items", "from_pandas",
    "from_arrow", "from_numpy", "from_huggingface", "from_torch", "read_parquet", "read_csv",
    "read_json", "read_numpy", "read_binary_files", "read_text",
    "read_tfrecords", "read_sql", "read_images", "read_orc", "read_mongo",
    "read_webdataset", "TFRecordDatasource", "SQLDatasource",
    "ImageDatasource",
]

# Usage telemetry: which libraries a cluster actually uses (reference:
# usage_lib.record_library_usage at import time).  Never raises.
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("data")
del _rlu
