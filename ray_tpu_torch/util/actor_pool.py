"""ActorPool: fan work out over a fixed set of actors.

Same capability as the reference's ``ray.util.ActorPool`` (round-robin
submission, ordered/unordered retrieval), built around a ticket ledger: every
submission gets a monotonically increasing *ticket*; the ledger maps tickets
to in-flight ObjectRefs and completed-but-unclaimed results.  Ordered
retrieval walks tickets in submission order; unordered retrieval waits on
whatever is in flight and claims the first completion.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


class _Ticket:
    __slots__ = ("ref", "actor")

    def __init__(self, ref, actor):
        self.ref = ref
        self.actor = actor


class ActorPool:
    """fn(actor, value) -> ObjectRef is the submission shape, matching the
    reference API so call sites port unchanged."""

    def __init__(self, actors: Iterable[Any]):
        self._ready = collections.deque(actors)   # actors with no task
        self._backlog: collections.deque = collections.deque()
        self._ledger: "collections.OrderedDict[int, _Ticket]" = \
            collections.OrderedDict()             # ticket -> in-flight work
        self._issue = 0                           # next ticket to issue
        self._serve = 0                           # next ticket for get_next()

    # ----------------------------------------------------------- submit

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        if not self._ready:
            self._backlog.append((fn, value))
            return
        actor = self._ready.popleft()
        self._ledger[self._issue] = _Ticket(fn(actor, value), actor)
        self._issue += 1

    def _recycle(self, actor) -> None:
        """Actor finished its task: give it backlog work or park it."""
        if self._backlog:
            fn, value = self._backlog.popleft()
            self._ledger[self._issue] = _Ticket(fn(actor, value), actor)
            self._issue += 1
        else:
            self._ready.append(actor)

    # ---------------------------------------------------------- results

    def has_next(self) -> bool:
        return bool(self._ledger)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Result of the oldest unreturned submission."""
        if not self.has_next():
            raise StopIteration("no pending results")
        # skip tickets already served out of order by get_next_unordered()
        while self._serve not in self._ledger and self._serve < self._issue:
            self._serve += 1
        ticket = self._serve
        self._serve += 1
        entry = self._ledger.pop(ticket)
        self._recycle(entry.actor)
        return ray_tpu_torch.get(entry.ref, timeout=timeout)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Whichever outstanding result lands first."""
        if not self._ledger:
            raise StopIteration("no pending results")
        by_ref = {t.ref: num for num, t in self._ledger.items()}
        done, _ = ray_tpu_torch.wait(list(by_ref), num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError("get_next_unordered timed out")
        ticket = by_ref[done[0]]
        entry = self._ledger.pop(ticket)
        self._recycle(entry.actor)
        return ray_tpu_torch.get(entry.ref)

    # -------------------------------------------------------------- map

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        n = 0
        for v in values:
            self.submit(fn, v)
            n += 1
        for _ in range(n):
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        n = 0
        for v in values:
            self.submit(fn, v)
            n += 1
        for _ in range(n):
            yield self.get_next_unordered()

    # ------------------------------------------------------ pool mgmt

    def has_free(self) -> bool:
        return bool(self._ready)

    def pop_idle(self) -> Optional[Any]:
        return self._ready.pop() if self._ready else None

    def push(self, actor) -> None:
        self._recycle(actor)
