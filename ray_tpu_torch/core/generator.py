"""Streaming-generator task returns (``num_returns="streaming"``).

Mirrors the reference's ``StreamingObjectRefGenerator``
(``python/ray/_raylet.pyx:267``): a task whose function body is a generator
ships each yielded value to its owner the moment it is produced, instead of
buffering the whole output until the task finishes.  Ray Data's map operators
consume blocks this way so downstream operators start while the producer is
still running; Serve streams LLM tokens over it.

TPU-first redesign notes (vs the reference's C++ generator protocol):
* Yields ride the SAME worker->owner connection that per-task result
  streaming already uses (req_id -1 "gen_yield" frames, core_worker.py
  ``_make_result_streamer``), so ordering with the final task reply is the
  TCP stream's ordering — no separate object-report RPC or sequence protocol.
* Yield i becomes owner-owned object ``ObjectID.for_task_return(task_id, i)``
  — the same id scheme as static multi-returns, so lineage reconstruction
  re-runs the generator and re-stores every yield with no extra machinery.
* Backpressure is consumer-driven: the producing worker pauses once
  ``produced - consumed >= spec.generator_backpressure``; the owner sends a
  one-way ``generator_ack`` as the user's ``next()`` consumes items
  (reference: ``_generator_backpressure_num_objects``).
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

from .ids import ObjectID, TaskID
from .object_ref import ObjectRef


class StreamState:
    """Owner-side bookkeeping for one streaming task (IO-loop confined except
    for the counters, which user threads read under the GIL)."""

    def __init__(self, task_id: TaskID, backpressure: int = 0):
        self.task_id = task_id
        self.backpressure = backpressure
        self.next_read = 0            # consumer cursor (user thread)
        self.available = 0            # yields stored so far
        self.total: Optional[int] = None   # set when the task finishes
        self.worker_addr: str = ""    # producer, for backpressure acks
        self.any_plasma = False
        self.abandoned = False
        #: lineage-reconstruction replay: store yields, expect no consumer
        self.replay = False
        self.event: Optional[asyncio.Event] = None  # lazily on the IO loop

    def signal(self):
        if self.event is not None:
            self.event.set()

    async def wait_change(self, timeout: Optional[float]):
        if self.event is None:
            self.event = asyncio.Event()
        self.event.clear()
        try:
            await asyncio.wait_for(self.event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def reset_for_retry(self):
        """A retried generator task replays its yields from index 0; already
        consumed items keep their (deterministic) object ids."""
        self.available = min(self.available, self.next_read)
        self.total = None


class ObjectRefGenerator:
    """Iterator of ObjectRefs for a ``num_returns="streaming"`` task.

    Supports both ``for ref in gen`` (blocking) and ``async for ref in gen``.
    When the task raises, the error becomes the stream's last item — the
    returned ref raises at ``get`` — matching the reference's semantics.
    """

    def __init__(self, worker, task_id: TaskID):
        self._w = worker
        self.task_id = task_id

    # -- sync protocol ----------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        from .rpc import run_async
        try:
            return run_async(self._next_async(None))
        except StopAsyncIteration:
            raise StopIteration from None

    def next(self, timeout: Optional[float] = None) -> ObjectRef:
        from .rpc import run_async
        try:
            return run_async(self._next_async(timeout))
        except StopAsyncIteration:
            raise StopIteration from None

    # -- async protocol ---------------------------------------------------

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        """Safe from any event loop: the wait itself always runs on the core
        worker's IO loop (where StreamState.event lives and is signalled)."""
        from .rpc import get_loop
        loop = get_loop()
        try:
            if asyncio.get_running_loop() is loop:
                return await self._next_async(None)
        except RuntimeError:
            pass
        cfut = asyncio.run_coroutine_threadsafe(self._next_async(None), loop)
        return await asyncio.wrap_future(cfut)

    async def _next_async(self, timeout: Optional[float]) -> ObjectRef:
        st = self._w.streams.get(self.task_id)
        if st is None:
            raise StopAsyncIteration
        while True:
            if st.next_read < st.available:
                i = st.next_read
                st.next_read += 1
                self._ack(st)
                return ObjectRef(ObjectID.for_task_return(self.task_id, i),
                                 owner=self._w.address)
            if st.total is not None and st.next_read >= st.total:
                self._w.streams.pop(self.task_id, None)
                raise StopAsyncIteration
            if not await st.wait_change(timeout):
                from .common import GetTimeoutError
                raise GetTimeoutError(
                    f"generator {self.task_id.hex()[:12]} produced nothing "
                    f"within {timeout}s")

    def _ack(self, st: StreamState):
        """Tell the producer a slot freed up (only when backpressure is on —
        the ack is pure overhead otherwise).  Runs on the IO loop (called
        from _next_async), so the one-way notify is fired as a loop task."""
        if not st.backpressure or not st.worker_addr:
            return
        try:
            client = self._w.worker_clients.get(st.worker_addr)
            asyncio.ensure_future(client.notify(
                "generator_ack", task_id=self.task_id,
                consumed=st.next_read))
        except Exception:
            pass  # producer finished/died: nothing to unblock

    def try_next(self) -> Optional[ObjectRef]:
        """Non-blocking next: a ref if one is already available, else None
        (poll-loop integration point — Data's streaming executor drives
        generators this way without parking its scheduling loop)."""
        st = self._w.streams.get(self.task_id)
        if st is None or st.next_read >= st.available:
            return None
        return self.__next__()

    # -- lifecycle ---------------------------------------------------------

    def completed(self) -> bool:
        st = self._w.streams.get(self.task_id)
        return st is None or (st.total is not None
                              and st.next_read >= st.total)

    def __del__(self):
        # Dropping the generator abandons unconsumed items: build-and-drop a
        # ref for each stored-but-unread yield so refcounting frees them, and
        # hand the producer an unbounded backpressure credit so a generator
        # parked in wait_capacity doesn't stall until its 600s timeout (e.g.
        # an HTTP client that disconnected mid-stream).
        try:
            st = self._w.streams.pop(self.task_id, None)
            if st is None:
                return
            st.abandoned = True
            for i in range(st.next_read, st.available):
                ObjectRef(ObjectID.for_task_return(self.task_id, i),
                          owner=self._w.address)
            if st.backpressure and st.worker_addr:
                from .rpc import get_loop
                client = self._w.worker_clients.get(st.worker_addr)
                asyncio.run_coroutine_threadsafe(
                    client.notify("generator_ack", task_id=self.task_id,
                                  consumed=1 << 62), get_loop())
        except Exception:
            pass


__all__ = ["ObjectRefGenerator", "StreamState"]
