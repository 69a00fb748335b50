"""Model multiplexing: many models behind one replica set.

Reference: ``python/ray/serve/multiplex.py`` (``@serve.multiplexed`` — an
async model loader memoized per model id with LRU eviction, so one
deployment serves N fine-tunes/checkpoints without N replica sets).

TPU angle: the loader typically materializes weights into HBM; the LRU cap
is the HBM budget knob.  Eviction calls the model's ``unload()`` (when it
defines one) — deployments that run long forwards should release models
only between requests (e.g. load at request start), as eviction does not
track in-flight use (the reference ties that to its request context).
"""

from __future__ import annotations

import asyncio
import functools
from collections import OrderedDict
from typing import Any, Callable, Optional


class _ModelCache:
    def __init__(self, loader: Callable, max_num_models: int):
        self.loader = loader
        self.max_num_models = max_num_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._loading: dict = {}           # model_id -> asyncio.Event

    async def get(self, instance, model_id: str) -> Any:
        while True:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            ev = self._loading.get(model_id)
            if ev is None:
                break
            await ev.wait()  # someone else is loading it
        ev = self._loading[model_id] = asyncio.Event()
        try:
            await self._evict_for_space()
            out = (self.loader(instance, model_id) if instance is not None
                   else self.loader(model_id))
            if asyncio.iscoroutine(out):
                out = await out
            self._models[model_id] = out
            return out
        finally:
            self._loading.pop(model_id, None)
            ev.set()

    async def _evict_for_space(self):
        while len(self._models) >= self.max_num_models:
            victim = next(iter(self._models))  # least recently used
            model = self._models.pop(victim, None)
            unload = getattr(model, "unload", None)
            if callable(unload):
                try:
                    res = unload()
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    pass


def multiplexed(_fn: Optional[Callable] = None, *, max_num_models: int = 3):
    """Decorator over an async model loader: ``loader(self, model_id)`` is
    called at most once per cached model; the cache LRU-evicts beyond
    ``max_num_models`` (reference: serve/multiplex.py)."""

    def wrap(loader: Callable):
        # the cache lives ON the instance: a module-level dict keyed by
        # id(instance) would leak models past the instance and alias a new
        # instance onto a dead one's cache when CPython reuses the id
        attr = f"__mux_cache_{loader.__name__}"
        fn_cache: list = []  # for free functions (no instance)

        @functools.wraps(loader)
        async def wrapper(*args):
            if len(args) == 2:
                instance, model_id = args
                cache = getattr(instance, attr, None)
                if cache is None:
                    cache = _ModelCache(loader, max_num_models)
                    setattr(instance, attr, cache)
            else:
                instance, model_id = None, args[0]
                if not fn_cache:
                    fn_cache.append(_ModelCache(loader, max_num_models))
                cache = fn_cache[0]
            return await cache.get(instance, model_id)

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap


import contextvars  # noqa: E402

_current_model_id: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "raytpu_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the current request (reference API parity).  Set by
    the replica from the request's ``serve_multiplexed_model_id`` header or
    ``model_id`` JSON body field (replica.py); deployments can also just
    pass the id explicitly."""
    return _current_model_id.get("")


def _set_current_model_id(request) -> None:
    """Called by ReplicaActor around each request invocation."""
    mid = ""
    try:
        headers = getattr(request, "headers", None) or {}
        mid = headers.get("serve_multiplexed_model_id", "")
        if not mid and getattr(request, "body", None):
            body = request.json()
            if isinstance(body, dict):
                mid = str(body.get("model_id", ""))
    except Exception:
        mid = ""
    _current_model_id.set(mid)
