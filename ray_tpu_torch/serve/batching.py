"""Dynamic request batching: ``@serve.batch``.

Reference: ``python/ray/serve/batching.py:65`` (_BatchQueue) / ``@serve.batch``
:337-351.  An async method decorated with ``@batch`` receives *lists* of its
arguments; concurrent callers are queued and flushed together when either
``max_batch_size`` requests are waiting or ``batch_wait_timeout_s`` elapses.
On TPU replicas this is what keeps the MXU fed: one forward pass over a padded
batch instead of N singleton passes.
"""

from __future__ import annotations

import asyncio
import functools
import time
from typing import Any, Callable, List, Optional

from . import observability as obs


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.queue: asyncio.Queue = asyncio.Queue()
        self._flusher: Optional[asyncio.Task] = None

    def _ensure_flusher(self):
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.get_event_loop().create_task(
                self._flush_loop())

    async def submit(self, instance, args, kwargs) -> Any:
        fut = asyncio.get_event_loop().create_future()
        # enqueue stamp: (deployment tag, trace ctx, wall clock) ride the
        # item so _run_batch can account each member's batch_wait and chain
        # its span under the request that queued it
        from ray_tpu_torch.util import tracing
        item_obs = (obs.current_deployment(), tracing.current_context(),
                    time.time()) if obs.enabled() else None
        await self.queue.put((instance, args, kwargs, fut, item_obs))
        self._ensure_flusher()
        return await fut

    async def _flush_loop(self):
        while True:
            batch = [await self.queue.get()]
            deadline = asyncio.get_event_loop().time() + self.timeout_s
            while len(batch) < self.max_batch_size:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self.queue.get(),
                                                        remaining))
                except asyncio.TimeoutError:
                    break
            await self._run_batch(batch)
            if self.queue.empty():
                return  # flusher exits when idle; resurrected on next submit

    async def _run_batch(self, batch: List[tuple]):
        instance = batch[0][0]
        # Batch each positional/keyword argument into a list.
        n_args = len(batch[0][1])
        arg_lists = [[item[1][i] for item in batch] for i in range(n_args)]
        kw_lists = {k: [item[2][k] for item in batch]
                    for k in batch[0][2]}
        futs = [item[3] for item in batch]
        self._record_flush(batch)
        try:
            if instance is not None:
                results = self.fn(instance, *arg_lists, **kw_lists)
            else:
                results = self.fn(*arg_lists, **kw_lists)
            if asyncio.iscoroutine(results):
                results = await results
            if len(results) != len(futs):
                raise ValueError(
                    f"@serve.batch function returned {len(results)} results "
                    f"for a batch of {len(futs)}")
            for fut, res in zip(futs, results):
                if not fut.done():
                    fut.set_result(res)
        except BaseException as e:  # noqa: BLE001
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _record_flush(self, batch: List[tuple]):
        """Observability for one flushed batch: occupancy (how full vs
        max_batch_size — padding waste is the complement), each member's
        queue wait, and a ``batch_wait`` span per member chained under the
        request that queued it."""
        stamps = [item[4] for item in batch if item[4] is not None]
        if not stamps or not obs.enabled():
            return
        now = time.time()
        deployment = stamps[0][0]
        obs.record_batch(deployment, len(batch), self.max_batch_size,
                         waits_s=[now - t0 for _d, _c, t0 in stamps])
        for _dep, ctx, t0 in stamps:
            if ctx is None:
                # no request trace: skip rather than let record_span fall
                # back to the flusher TASK's inherited context (which is
                # whatever request created the flusher — the span would
                # chain into an unrelated request's trace)
                continue
            obs.stamp_span("batch_wait", t0, now - t0,
                           trace_id=ctx[0], parent_id=ctx[1],
                           deployment=deployment)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: turn ``async def method(self, x)`` into a dynamically
    batched ``async def method(self, [x1, x2, ...])`` callee."""

    def wrap(fn: Callable):
        queues: dict = {}  # per-instance (or per-function) queue

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            # Method vs free function: heuristic matching the reference —
            # if the first arg owns the wrapped attr, treat it as self.
            instance = None
            call_args = args
            if args and getattr(type(args[0]), fn.__name__, None) is not None:
                instance = args[0]
                call_args = args[1:]
            key = id(instance)
            q = queues.get(key)
            if q is None:
                q = queues[key] = _BatchQueue(fn, max_batch_size,
                                              batch_wait_timeout_s)
            return await q.submit(instance, call_args, kwargs)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
