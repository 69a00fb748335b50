"""Binary IDs for jobs, tasks, actors, objects, nodes, workers.

Design follows the reference's ``src/ray/common/id.h``: fixed-width random binary ids with
hex rendering; object ids embed the id of the task that produced them plus a return-index,
so ownership and lineage can be derived from the id itself (reference: ``ObjectID::ForTaskReturn``).
Sizes are chosen for compactness, not wire-compatibility.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Optional

_NIL = b""

# Hot-path ID generation: one urandom syscall per id showed up at ~10 us/call
# in the task-submission path.  Uniqueness (not cryptographic strength) is
# what ids need, so hot ids (TaskID, put ObjectID — generated per call) use
# an 8-byte per-process random prefix + a monotonic counter, reseeded on fork
# (reference ids are likewise worker-prefix + counter composites,
# src/ray/common/id.h TaskID layout).  IMPORTANT: such ids share their prefix
# within a process, so they must never be truncated into identities (e.g.
# filenames) — NodeID/WorkerID/ActorID, which ARE truncated in places (store
# names, log names), stay fully random; they're created rarely.
_seed_lock = threading.Lock()
_seed_pid = -1
_seed_prefix = b""
_seq = itertools.count()


def _fast_unique16() -> bytes:
    global _seed_pid, _seed_prefix, _seq
    pid = os.getpid()
    if pid != _seed_pid:
        with _seed_lock:
            if pid != _seed_pid:
                _seed_prefix = os.urandom(8)
                _seq = itertools.count()
                _seed_pid = pid
    return _seed_prefix + next(_seq).to_bytes(8, "big")


class BaseID:
    SIZE = 16
    __slots__ = ("_bin", "_h")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(f"{type(self).__name__} must be {self.SIZE} bytes, got {len(binary)}")
        self._bin = binary
        self._h: Optional[int] = None

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def is_nil(self) -> bool:
        return self._bin == b"\x00" * self.SIZE

    def __eq__(self, other):
        return type(other) is type(self) and other._bin == self._bin

    def __hash__(self):
        # hot path (dict keys in refcounting/stores): cache; cross-type
        # collisions are fine — __eq__ checks the type
        h = self._h
        if h is None:
            h = self._h = hash(self._bin)
        return h

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]})"

    def __reduce__(self):
        return (type(self), (self._bin,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def from_random(cls):  # hot path: one per task submission
        return cls(_fast_unique16())


class PlacementGroupID(BaseID):
    SIZE = 16


class ObjectID(BaseID):
    """TaskID (16B) + 4-byte big-endian return index."""

    SIZE = 20

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def from_random(cls):  # for ray.put objects: synthesize a put-task id
        return cls(_fast_unique16() + (0).to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bin[:16])

    def return_index(self) -> int:
        return int.from_bytes(self._bin[16:], "big")


class _Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._v += 1
            return self._v
