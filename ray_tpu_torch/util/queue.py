"""Distributed FIFO queue — reference ``python/ray/util/queue.py``: a named
actor wrapping an asyncio queue, usable from any process in the cluster."""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item: Any) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            return True, await asyncio.wait_for(self.q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def get_nowait(self):
        try:
            return True, self.q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def qsize(self) -> int:
        return self.q.qsize()

    async def empty(self) -> bool:
        return self.q.empty()

    async def full(self) -> bool:
        return self.q.full()


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        cls = ray_tpu_torch.remote(_QueueActor)
        self.actor = cls.options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            ok = ray_tpu_torch.get(self.actor.put_nowait.remote(item))
        else:
            ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full()

    def put_async(self, item: Any):
        return self.actor.put.remote(item, None)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
        else:
            ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty()
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass
