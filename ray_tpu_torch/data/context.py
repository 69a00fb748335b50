"""DataContext — per-driver execution knobs for ray_tpu_torch.data.

Reference: ``python/ray/data/context.py`` (``DataContext.get_current``): a
process-wide singleton that operators and the planner consult for target block
sizes, parallelism, and backpressure budgets.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DataContext:
    # Target on-disk/in-store size of one block produced by reads and maps.
    target_max_block_size: int = 128 * 1024 * 1024
    # Default minimum number of blocks a read should produce.
    read_op_min_num_blocks: int = 8
    # Streaming executor: max concurrently running tasks per operator.
    max_tasks_in_flight_per_op: int = 8
    # Streaming executor: global cap on bytes of not-yet-consumed operator
    # outputs before backpressure kicks in.
    streaming_output_backpressure_bytes: int = 1 * 1024 * 1024 * 1024
    # Actor pool defaults for Dataset.map_batches(concurrency=...) class fns.
    actor_pool_min_size: int = 1
    actor_pool_max_size: int = 4
    # Batch format handed to user fns when not specified: "numpy" | "pandas"
    # | "pyarrow".
    default_batch_format: str = "numpy"
    # Whether map tasks should eagerly release input block refs.
    eager_free: bool = True
    # Streaming-generator map tasks: downstream operators consume output
    # blocks while the producing task still runs (num_returns="streaming").
    use_streaming_generators: bool = True
    # Producer pauses after this many unconsumed streamed blocks (0 = off).
    generator_backpressure: int = 8
    # Random seed used by random_shuffle/randomize_block_order when the user
    # does not pass one (None = nondeterministic).
    seed: Optional[int] = None
    extra: dict = field(default_factory=dict)

    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def get_current() -> "DataContext":
        with DataContext._lock:
            if DataContext._instance is None:
                DataContext._instance = DataContext()
            return DataContext._instance
