"""Block model: a Dataset is a list of object-store-resident blocks.

Reference: ``python/ray/data/block.py`` — a block is an Arrow table, a pandas
DataFrame, or a plain Python list ("simple" block); ``BlockAccessor`` gives a
uniform interface over the three formats, and ``BlockMetadata`` travels with
every block ref so the driver can plan without fetching data.

Canonical format here is **pyarrow.Table** (zero-copy through the shm object
store); list blocks hold arbitrary Python rows; pandas is converted lazily.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

Block = Union[pa.Table, List[Any], "pandas.DataFrame"]  # noqa: F821

# Column name used when wrapping bare values (ints, arrays) into tabular form,
# mirroring the reference's TENSOR_COLUMN_NAME/"item" convention.
VALUE_COL = "item"


@dataclass
class BlockMetadata:
    num_rows: Optional[int]
    size_bytes: Optional[int]
    schema: Optional[Any] = None
    input_files: List[str] = field(default_factory=list)
    exec_stats: Optional[dict] = None


def _is_pandas(block) -> bool:
    try:
        import pandas as pd
        return isinstance(block, pd.DataFrame)
    except ImportError:  # pragma: no cover
        return False


class BlockAccessor:
    """Uniform view over arrow / pandas / list blocks."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # -- shape ---------------------------------------------------------------
    def num_rows(self) -> int:
        b = self._block
        if isinstance(b, pa.Table):
            return b.num_rows
        if _is_pandas(b):
            return len(b)
        return len(b)

    def size_bytes(self) -> int:
        b = self._block
        if isinstance(b, pa.Table):
            return b.nbytes
        if _is_pandas(b):
            return int(b.memory_usage(deep=True).sum())
        # rough estimate for simple blocks
        import sys
        return sum(sys.getsizeof(r) for r in b) if len(b) < 10_000 else len(b) * 64

    def schema(self):
        b = self._block
        if isinstance(b, pa.Table):
            return b.schema
        if _is_pandas(b):
            return pa.Schema.from_pandas(b)
        return type(b[0]).__name__ if b else None

    def metadata(self, input_files: Optional[List[str]] = None) -> BlockMetadata:
        return BlockMetadata(num_rows=self.num_rows(), size_bytes=self.size_bytes(),
                             schema=self.schema(), input_files=input_files or [])

    # -- conversion ----------------------------------------------------------
    def to_arrow(self) -> pa.Table:
        b = self._block
        if isinstance(b, pa.Table):
            return b
        if _is_pandas(b):
            return pa.Table.from_pandas(b, preserve_index=False)
        # simple block: dict rows → columns; bare values → VALUE_COL
        if b and isinstance(b[0], dict):
            cols: Dict[str, list] = {k: [] for k in b[0]}
            for row in b:
                for k in cols:
                    cols[k].append(row.get(k))
            return pa.table({k: _to_arrow_array(v) for k, v in cols.items()})
        return pa.table({VALUE_COL: _to_arrow_array(list(b))})

    def to_pandas(self):
        import pandas as pd
        b = self._block
        if _is_pandas(b):
            return b
        if isinstance(b, pa.Table):
            return b.to_pandas()
        return self.to_arrow().to_pandas()

    def to_numpy(self, columns: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
        t = self.to_arrow()
        names = columns or t.column_names
        out = {}
        for name in names:
            col = t.column(name)
            out[name] = _column_to_numpy(col)
        return out

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "numpy_dict", "default"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    # -- row access ----------------------------------------------------------
    def iter_rows(self) -> Iterator[Any]:
        b = self._block
        if isinstance(b, list):
            yield from b
            return
        t = self.to_arrow()
        cols = t.column_names
        if cols == [VALUE_COL]:
            for v in t.column(VALUE_COL).to_pylist():
                yield v
            return
        data = {}
        for c in cols:
            col = t.column(c)
            if isinstance(col.type, getattr(pa, "FixedShapeTensorType", ())):
                data[c] = list(_column_to_numpy(col))
            else:
                data[c] = col.to_pylist()
        for i in range(t.num_rows):
            yield {c: data[c][i] for c in cols}

    def slice(self, start: int, end: int) -> Block:
        b = self._block
        if isinstance(b, pa.Table):
            return b.slice(start, end - start)
        if _is_pandas(b):
            return b.iloc[start:end]
        return b[start:end]

    def take(self, n: int) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def sample(self, n: int, rng: np.random.Generator) -> List[Any]:
        rows = list(self.iter_rows())
        if not rows:
            return []
        idx = rng.choice(len(rows), size=min(n, len(rows)), replace=False)
        return [rows[i] for i in idx]


def _to_arrow_array(values: list) -> pa.Array:
    if values and isinstance(values[0], np.ndarray):
        return _tensor_array(values)
    try:
        return pa.array(values)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return _tensor_array([np.asarray(v) for v in values])


def _tensor_array(arrs: List[np.ndarray]) -> pa.Array:
    """Fixed-shape tensor column (Arrow FixedShapeTensorType when uniform)."""
    shapes = {a.shape for a in arrs}
    if len(shapes) == 1 and arrs[0].ndim >= 1:
        stacked = np.stack(arrs)
        try:
            return pa.FixedShapeTensorArray.from_numpy_ndarray(stacked)
        except (AttributeError, pa.ArrowNotImplementedError):
            return pa.array(stacked.reshape(len(arrs), -1).tolist())
    return pa.array([a.tolist() for a in arrs])


def _column_to_numpy(col: pa.ChunkedArray) -> np.ndarray:
    if isinstance(col.type, getattr(pa, "FixedShapeTensorType", ())):
        combined = col.combine_chunks()
        return combined.to_numpy_ndarray()
    try:
        return col.to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return np.asarray(col.to_pylist(), dtype=object)


def batch_to_block(batch) -> Block:
    """Normalize a user-function return (dict of arrays / DataFrame / Table /
    list) into a block."""
    if isinstance(batch, pa.Table):
        return batch
    if _is_pandas(batch):
        return pa.Table.from_pandas(batch, preserve_index=False)
    if isinstance(batch, dict):
        n = None
        for v in batch.values():
            ln = len(v)
            if n is not None and ln != n:
                raise ValueError("batch columns have unequal lengths")
            n = ln
        return pa.table({k: _to_arrow_array(list(np.asarray(v)) if isinstance(v, np.ndarray) else list(v))
                         for k, v in batch.items()})
    if isinstance(batch, list):
        return batch
    raise TypeError(f"cannot convert batch of type {type(batch)} to a block")


class DelegatingBlockBuilder:
    """Accumulates rows or batches and emits blocks of bounded size.

    Reference: ``python/ray/data/_internal/delegating_block_builder.py``.
    """

    def __init__(self):
        self._rows: List[Any] = []
        self._tables: List[pa.Table] = []

    def add(self, row: Any):
        self._rows.append(row)

    def add_block(self, block: Block):
        acc = BlockAccessor.for_block(block)
        if isinstance(block, list):
            self._rows.extend(block)
        else:
            self._tables.append(acc.to_arrow())

    def num_rows(self) -> int:
        return len(self._rows) + sum(t.num_rows for t in self._tables)

    def build(self) -> Block:
        if self._tables and not self._rows:
            return pa.concat_tables(self._tables) if len(self._tables) > 1 else self._tables[0]
        if self._rows and not self._tables:
            if self._rows and isinstance(self._rows[0], dict):
                return BlockAccessor.for_block(self._rows).to_arrow()
            return list(self._rows)
        if not self._rows and not self._tables:
            return pa.table({})
        # mixed: go through arrow
        parts = list(self._tables)
        if self._rows:
            parts.append(BlockAccessor.for_block(self._rows).to_arrow())
        return pa.concat_tables(parts)
