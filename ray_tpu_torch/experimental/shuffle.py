"""Two-stage distributed shuffle primitive (reference:
``python/ray/experimental/shuffle.py`` — the minimal map/reduce shuffle
used for scale exercising outside Ray Data).

``ray_tpu_torch.data``'s shuffle-exchange operator is the production path;
this is the bare primitive: M map tasks each hash-partition their block
into R shards (returned as R separate streamed outputs so a reducer can
pull only its shard), R reduce tasks concatenate their shards. All
traffic rides the object store — same-host zero-copy, cross-host
chunked pulls.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np

__all__ = ["simple_shuffle"]


def simple_shuffle(partitions: Sequence[Any],
                   num_reducers: Optional[int] = None,
                   key_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                   ) -> List[np.ndarray]:
    """Shuffle numpy-array partitions into ``num_reducers`` hash buckets.

    partitions: sequence of arrays (rows = records) or object refs to them.
    key_fn: rows -> int64 keys (default: the first column — or the value
    itself for 1-D blocks — cast to int64; supply key_fn for real
    hashing when keys are structured/strided).
    Returns the reduced partitions (list of arrays, one per reducer),
    where every row lands in bucket ``key % num_reducers``.
    """
    import ray_tpu_torch

    if num_reducers is not None and num_reducers < 1:
        raise ValueError(f"num_reducers must be >= 1, got {num_reducers}")
    r = len(partitions) if num_reducers is None else num_reducers

    @ray_tpu_torch.remote(num_returns=r)
    def shuffle_map(block):
        block = np.asarray(block)
        if key_fn is not None:
            keys = np.asarray(key_fn(block)).astype(np.int64)
        elif block.ndim > 1:
            keys = block[:, 0].astype(np.int64)
        else:
            keys = block.astype(np.int64)
        buckets = keys % r
        out = [block[buckets == i] for i in range(r)]
        return tuple(out) if r > 1 else out[0]

    @ray_tpu_torch.remote
    def shuffle_reduce(*shards):
        # empty shards keep the block's shape/dtype ((0, cols) slices),
        # so concatenation preserves both even for an empty bucket
        return np.concatenate(shards, axis=0)

    map_out = [shuffle_map.remote(p) for p in partitions]
    if r == 1:
        cols = [map_out]  # num_returns=1 gives bare refs
    else:
        cols = [[refs[i] for refs in map_out] for i in range(r)]
    return ray_tpu_torch.get([shuffle_reduce.remote(*col) for col in cols],
                       timeout=600)
