"""Logical plan for ray_tpu_torch.data.

Reference: ``python/ray/data/_internal/logical/`` — operators describe *what*
to compute; the planner (``planner.py``) lowers them to physical operators and
applies fusion rules (consecutive map-type ops fuse into one task per block,
mirroring ``_internal/logical/rules/operator_fusion.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .datasource import Datasource


class LogicalOp:
    """A node in the logical DAG; ``input_op`` forms a chain, extra inputs
    (union/zip) are in ``extra_inputs``."""

    input_op: Optional["LogicalOp"] = None
    extra_inputs: List["LogicalOp"] = []

    def name(self) -> str:
        return type(self).__name__

    def chain(self) -> List["LogicalOp"]:
        out: List[LogicalOp] = []
        node: Optional[LogicalOp] = self
        while node is not None:
            out.append(node)
            node = node.input_op
        return list(reversed(out))


@dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)

    def name(self):
        return f"Read{self.datasource.name}"


@dataclass
class InputData(LogicalOp):
    """Already-materialized (ref, metadata) bundles."""
    bundles: List[Any]
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)


@dataclass
class AbstractMap(LogicalOp):
    fn: Callable = None
    fn_args: Tuple = ()
    fn_kwargs: Dict[str, Any] = field(default_factory=dict)
    # "tasks" or ("actors", min, max) for class-based fns
    compute: Any = "tasks"
    fn_constructor_args: Tuple = ()
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)
    ray_remote_args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MapBatches(AbstractMap):
    batch_size: Optional[int] = None
    batch_format: str = "default"
    zero_copy_batch: bool = False

    def name(self):
        return f"MapBatches({getattr(self.fn, '__name__', 'fn')})"


@dataclass
class MapRows(AbstractMap):
    def name(self):
        return f"Map({getattr(self.fn, '__name__', 'fn')})"


@dataclass
class Filter(AbstractMap):
    def name(self):
        return f"Filter({getattr(self.fn, '__name__', 'fn')})"


@dataclass
class FlatMap(AbstractMap):
    def name(self):
        return f"FlatMap({getattr(self.fn, '__name__', 'fn')})"


@dataclass
class Limit(LogicalOp):
    n: int = 0
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)


# -- all-to-all ops ---------------------------------------------------------

@dataclass
class AbstractAllToAll(LogicalOp):
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)


@dataclass
class RandomShuffle(AbstractAllToAll):
    seed: Optional[int] = None
    num_outputs: Optional[int] = None


@dataclass
class RandomizeBlockOrder(AbstractAllToAll):
    seed: Optional[int] = None


@dataclass
class Repartition(AbstractAllToAll):
    num_outputs: int = 1
    shuffle: bool = False


@dataclass
class Sort(AbstractAllToAll):
    key: Any = None
    descending: bool = False


@dataclass
class Aggregate(AbstractAllToAll):
    key: Optional[str] = None
    aggs: List[Any] = field(default_factory=list)


@dataclass
class Union(LogicalOp):
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)


@dataclass
class Zip(LogicalOp):
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)


@dataclass
class Write(LogicalOp):
    path: str = ""
    file_format: str = "parquet"
    writer_args: Dict[str, Any] = field(default_factory=dict)
    input_op: Optional[LogicalOp] = None
    extra_inputs: List[LogicalOp] = field(default_factory=list)
