"""Sharded hot tables + secondary indexes for the control plane.

The GCS keeps its hot state (KV, actor table) in plain dicts; past ~10^5
entries two costs surface at exactly the wrong time:

* a dict resize is a single stop-the-world rehash of the WHOLE table — on
  the GCS event loop that pause lands in the middle of a submission burst
  and shows up as a p99 spike on every RPC parked behind it;
* "find every entry matching X" degenerates into full-table scans, and
  the callers that need them (node death → that node's actors, job finish
  → that job's actors) run during failures/teardown when the loop is
  already busy.

:class:`ShardedTable` bounds the first: the key space hash-partitions
over N independent dicts, so any single rehash touches 1/N of the
entries, and iteration can proceed shard-at-a-time (``shard_items``)
with event-loop yields in between.  :class:`SecondaryIndex` removes the
second: O(1)-maintained reverse buckets replace the scans entirely.

Reference: the GCS in the source system is backed by sharded Redis
tables (``gcs_table_storage.cc``); this is the in-process analogue.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, Iterable, Iterator, List, Set, Tuple


class ShardedTable:
    """A mapping hash-partitioned over ``num_shards`` independent dicts.

    Same asymptotics as a dict for point ops, but worst-case single-op
    latency (rehash pause) is bounded by the largest SHARD, and iteration
    is available per shard so maintenance scans can yield between shards
    instead of holding the loop for the whole table.
    """

    __slots__ = ("_shards", "_len")

    def __init__(self, num_shards: int = 16):
        num_shards = max(1, int(num_shards))
        self._shards: List[Dict[Hashable, Any]] = [
            {} for _ in range(num_shards)]
        self._len = 0

    def _shard(self, key: Hashable) -> Dict[Hashable, Any]:
        return self._shards[hash(key) % len(self._shards)]

    # -- point ops (all O(1) amortized per SHARD) -------------------------

    def __getitem__(self, key: Hashable) -> Any:
        return self._shard(key)[key]

    def __setitem__(self, key: Hashable, value: Any) -> None:
        shard = self._shard(key)
        if key not in shard:
            self._len += 1
        shard[key] = value

    def __delitem__(self, key: Hashable) -> None:
        del self._shard(key)[key]
        self._len -= 1

    def __contains__(self, key: Hashable) -> bool:
        return key in self._shard(key)

    def get(self, key: Hashable, default: Any = None) -> Any:
        return self._shard(key).get(key, default)

    def setdefault(self, key: Hashable, default: Any = None) -> Any:
        shard = self._shard(key)
        if key not in shard:
            self._len += 1
        return shard.setdefault(key, default)

    _MISSING = object()

    def pop(self, key: Hashable, default: Any = _MISSING) -> Any:
        shard = self._shard(key)
        if key in shard:
            self._len -= 1
            return shard.pop(key)
        if default is self._MISSING:
            raise KeyError(key)
        return default

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    # -- iteration (cold paths; shard-at-a-time available) ----------------

    def __iter__(self) -> Iterator[Hashable]:
        for shard in self._shards:
            yield from shard

    def keys(self) -> Iterator[Hashable]:
        return iter(self)

    def values(self) -> Iterator[Any]:
        for shard in self._shards:
            yield from shard.values()

    def items(self) -> Iterator[Tuple[Hashable, Any]]:
        for shard in self._shards:
            yield from shard.items()

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def shard_items(self, index: int) -> Iterable[Tuple[Hashable, Any]]:
        """Snapshot of ONE shard's items — incremental scans iterate shard
        ``i`` of ``num_shards`` per tick and yield the loop in between."""
        return list(self._shards[index].items())

    def to_dict(self) -> Dict[Hashable, Any]:
        """Flat copy (persistence snapshots / debug)."""
        out: Dict[Hashable, Any] = {}
        for shard in self._shards:
            out.update(shard)
        return out


class SecondaryIndex:
    """Reverse bucket index: group key -> set of primary keys.

    Replaces "scan the whole table for entries whose field == X" with an
    O(bucket) lookup; maintenance is O(1) per add/discard/move.  Empty
    buckets are dropped eagerly so the index's size tracks the LIVE
    grouping, not its history.
    """

    __slots__ = ("_buckets",)

    def __init__(self):
        self._buckets: Dict[Hashable, Set[Hashable]] = {}

    def add(self, group: Hashable, key: Hashable) -> None:
        if group is None:
            return
        self._buckets.setdefault(group, set()).add(key)

    def discard(self, group: Hashable, key: Hashable) -> None:
        if group is None:
            return
        bucket = self._buckets.get(group)
        if bucket is not None:
            bucket.discard(key)
            if not bucket:
                del self._buckets[group]

    def move(self, old_group: Hashable, new_group: Hashable,
             key: Hashable) -> None:
        if old_group == new_group:
            return
        self.discard(old_group, key)
        self.add(new_group, key)

    def get(self, group: Hashable) -> Set[Hashable]:
        """Snapshot copy (callers mutate the table while iterating)."""
        return set(self._buckets.get(group, ()))

    def __len__(self) -> int:
        return len(self._buckets)
