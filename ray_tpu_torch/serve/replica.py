"""Replica actor: wraps the user callable, serves requests, reports health +
queue depth, supports streaming and graceful drain.

Reference: ``python/ray/serve/_private/replica.py`` (RayServeReplica).  Runs as
an async actor with ``max_concurrency = max_concurrent_queries`` so requests
interleave on the replica's event loop; ``num_ongoing`` is both the router's
power-of-two-choices signal and the autoscaler's input.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict, Optional

import cloudpickle

from . import observability as obs


class Request:
    """Lightweight HTTP request container handed to deployments that take one
    (the reference hands a starlette Request; same role)."""

    __slots__ = ("method", "path", "query", "headers", "body")

    def __init__(self, method: str = "POST", path: str = "/", query=None,
                 headers=None, body: bytes = b""):
        self.method = method
        self.path = path
        self.query = dict(query or {})
        self.headers = dict(headers or {})
        self.body = body

    def json(self):
        import json
        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()


class ReplicaActor:
    """The actor class every replica runs (created by the controller)."""

    def __init__(self, deployment_name: str, replica_id: str, app_blob: bytes,
                 user_config: Any = None):
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        func_or_class, init_args, init_kwargs = cloudpickle.loads(app_blob)
        if inspect.isclass(func_or_class):
            self.callable = func_or_class(*init_args, **init_kwargs)
            self._entry = None  # resolve per request (method or __call__)
        else:
            self.callable = None
            self._fn = func_or_class
        self.num_ongoing = 0
        self.num_processed = 0
        self._draining = False
        self.started_at = time.time()
        self._streams: Dict[str, list] = {}
        self._stream_done: Dict[str, bool] = {}
        #: streams the CLIENT abandoned (stream timeout) -> cancel ts:
        #: the generator stops buffering and the finally path must not
        #: resurrect the done-flag entry — an unclaimed buffer would
        #: block drain() forever and leak per-stream memory.  A dict
        #: (not a set) so tombstones that are never consumed (cancel
        #: raced a completed-and-popped stream; ids are fresh uuids) age
        #: out instead of accumulating for the replica's lifetime.
        self._cancelled_streams: Dict[str, float] = {}
        if user_config is not None:
            self._apply_user_config(user_config)

    # ------------------------------------------------------- observability

    def _obs_begin(self):
        """Per-request instrumentation entry: install the event-loop stall
        monitor once (this runs ON the actor loop — __init__ does not),
        publish queue depth, and tag downstream instrumentation
        (@serve.batch, the LLM engine) with this deployment's config
        name.  Returns (t0, ctx token) for _obs_end."""
        obs.ensure_loop_monitor(
            self, f"serve_replica:{self.deployment_name}")
        obs.set_replica_queue_depth(self.deployment_name, self.num_ongoing)
        return time.monotonic(), obs.set_current_deployment(
            self.deployment_name)

    def _obs_end(self, begin, first_token_at: Optional[float] = None,
                 ok: bool = True, window: bool = True):
        """Request done: one TTFT sample into the histogram + rolling SLO
        window (streaming requests pass their first-chunk time; unary
        requests' TTFT is their full latency — the first response byte).
        Failed requests don't feed anything (an instant exception is not a
        fast first token — it would drag the SLO percentiles DOWN exactly
        when the deployment is misbehaving), and named-method calls
        (``window=False``: h.stats.remote() and other introspection/
        control routes) skip the WINDOW so fast non-inference polls can't
        mask real serving degradation — they still land in the TTFT
        histogram under the same deployment tag."""
        t0, token = begin
        obs.set_replica_queue_depth(self.deployment_name, self.num_ongoing)
        if ok:
            obs.observe_ttft(self.deployment_name,
                             (first_token_at if first_token_at is not None
                              else time.monotonic()) - t0,
                             window=window)
        # last: the ctx reset is the one step that can be running inside
        # asyncgen finalization (foreign context) — nothing may depend on it
        obs.reset_current_deployment(token)

    # ------------------------------------------------------------- serving

    def _resolve(self, method: Optional[str]):
        if self.callable is None:
            return self._fn
        target = self.callable
        if method:
            return getattr(target, method)
        if callable(target):
            return target.__call__
        raise AttributeError(f"{type(target)} is not callable; specify method")

    async def handle_request(self, args: tuple, kwargs: dict,
                             method: Optional[str] = None) -> Any:
        if self._draining:
            raise RuntimeError(f"replica {self.replica_id} is draining")
        self.num_ongoing += 1
        begin = self._obs_begin()
        ok = False
        try:
            if args and isinstance(args[0], Request):
                from .multiplex import _set_current_model_id
                _set_current_model_id(args[0])
            fn = self._resolve(method)
            out = fn(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = await out
            if inspect.isgenerator(out) or inspect.isasyncgen(out):
                raise TypeError(
                    "streaming responses go through handle_request_streaming")
            ok = True
            return out
        finally:
            self.num_ongoing -= 1
            self.num_processed += 1
            self._obs_end(begin, ok=ok, window=method is None)

    async def handle_request_streaming(self, stream_id: str, args: tuple,
                                       kwargs: dict,
                                       method: Optional[str] = None) -> None:
        """Run a (async) generator endpoint, buffering chunks for the caller
        to drain via next_chunks() — streaming over the actor RPC plane."""
        if stream_id in self._cancelled_streams:
            # cancel raced ahead of a queued start: never register (and
            # consume the tombstone BEFORE the draining check — either
            # refusal must not leave it behind)
            self._cancelled_streams.pop(stream_id, None)
            raise RuntimeError(f"stream {stream_id} cancelled before start")
        if self._draining:
            raise RuntimeError(f"replica {self.replica_id} is draining")
        self.num_ongoing += 1
        self._streams[stream_id] = []
        self._stream_done[stream_id] = False
        begin = self._obs_begin()
        first_at: Optional[float] = None
        ok = False
        try:
            fn = self._resolve(method)
            out = fn(*args, **kwargs)

            def buf():
                # None once the client cancelled (stream timeout): stop
                # generating instead of appending into a popped buffer
                return self._streams.get(stream_id)

            if inspect.isasyncgen(out):
                async for chunk in out:
                    if first_at is None:
                        first_at = time.monotonic()
                    b = buf()
                    if b is None:
                        break
                    b.append(chunk)
            elif inspect.isgenerator(out):
                for chunk in out:
                    if first_at is None:
                        first_at = time.monotonic()
                    b = buf()
                    if b is None:
                        break
                    b.append(chunk)
                    await asyncio.sleep(0)  # let pollers interleave
            else:
                if inspect.iscoroutine(out):
                    out = await out
                b = buf()
                if b is not None:
                    b.append(out)
            ok = True
        finally:
            if stream_id in self._cancelled_streams:
                # abandoned: every trace of the stream is already gone —
                # resurrecting the done flag would leak an entry forever
                self._cancelled_streams.pop(stream_id, None)
                self._streams.pop(stream_id, None)
                self._stream_done.pop(stream_id, None)
            else:
                self._stream_done[stream_id] = True
            self.num_ongoing -= 1
            self.num_processed += 1
            self._obs_end(begin, first_token_at=first_at, ok=ok,
                          window=method is None)

    async def handle_request_gen(self, args: tuple, kwargs: dict,
                                 method: Optional[str] = None):
        """Streaming endpoint as a native streaming-generator actor method
        (called with ``num_returns="streaming"``): each chunk ships to the
        caller the moment it is yielded — no next_chunks long-poll round
        trips (that path remains for deployment handles that want the
        buffered protocol)."""
        if self._draining:
            raise RuntimeError(f"replica {self.replica_id} is draining")
        self.num_ongoing += 1
        begin = self._obs_begin()
        first_at: Optional[float] = None
        ok = False
        try:
            fn = self._resolve(method)
            out = fn(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = await out
            if inspect.isasyncgen(out):
                async for chunk in out:
                    if first_at is None:
                        first_at = time.monotonic()
                    yield chunk
            elif inspect.isgenerator(out):
                for chunk in out:
                    if first_at is None:
                        first_at = time.monotonic()
                    yield chunk
                    await asyncio.sleep(0)  # keep the actor loop responsive
            else:
                first_at = time.monotonic()
                yield out
            ok = True
        finally:
            self.num_ongoing -= 1
            self.num_processed += 1
            self._obs_end(begin, first_token_at=first_at, ok=ok,
                          window=method is None)

    async def cancel_stream(self, stream_id: str) -> bool:
        """Client abandoned the stream (``stream(timeout_s=...)`` hit its
        deadline): drop the buffer and stop the generator so drain()
        never waits on chunks nobody will claim.  The tombstone covers
        both orderings — a still-running handler consumes it in its
        finally, a not-yet-started one at registration; a finished
        stream (done flag True) needs only the pops."""
        now = time.monotonic()
        # prune tombstones nobody consumed (cancel raced a stream that
        # had already completed and been popped — its fresh-uuid id will
        # never be seen again); 120s far exceeds any legitimate gap
        # between a cancel and the handler's finally
        for sid, ts in list(self._cancelled_streams.items()):
            if now - ts > 120.0:
                self._cancelled_streams.pop(sid, None)
        done = self._stream_done.get(stream_id)
        self._streams.pop(stream_id, None)
        self._stream_done.pop(stream_id, None)
        if done is not True:
            self._cancelled_streams[stream_id] = now
        return True

    async def next_chunks(self, stream_id: str, cursor: int) -> tuple:
        """Poll a stream: returns (new_chunks, next_cursor, done)."""
        for _ in range(200):  # long-poll up to ~2s per call
            buf = self._streams.get(stream_id)
            if buf is None:
                raise KeyError(f"unknown stream {stream_id}")
            if len(buf) > cursor:
                chunks = buf[cursor:]
                done = self._stream_done.get(stream_id, False)
                nxt = cursor + len(chunks)
                if done and nxt == len(buf):
                    self._streams.pop(stream_id, None)
                    self._stream_done.pop(stream_id, None)
                return chunks, nxt, done
            if self._stream_done.get(stream_id, False):
                self._streams.pop(stream_id, None)
                self._stream_done.pop(stream_id, None)
                return [], cursor, True
            await asyncio.sleep(0.01)
        return [], cursor, False

    # ------------------------------------------------------------ lifecycle

    def _apply_user_config(self, user_config: Any):
        target = self.callable if self.callable is not None else None
        if target is not None and hasattr(target, "reconfigure"):
            target.reconfigure(user_config)

    async def reconfigure(self, user_config: Any) -> bool:
        self._apply_user_config(user_config)
        return True

    async def health_check(self) -> Dict[str, Any]:
        # User-defined health check hooks in when present (reference:
        # replica.py check_health).
        target = self.callable
        if target is not None and hasattr(target, "check_health"):
            res = target.check_health()
            if inspect.iscoroutine(res):
                await res
        # SLO heartbeat piggyback: the rolling TTFT percentiles + queue
        # depth ride the health check the controller already runs — no
        # extra RPC, and the controller aggregates per deployment.
        out = {"ongoing": self.num_ongoing, "processed": self.num_processed,
               "draining": self._draining,
               "slo": obs.slo_snapshot(self.deployment_name,
                                       self.num_ongoing)}
        # Prefix-cache digest piggyback (cache-aware routing): deployments
        # exposing prefix_digest() (LLMServer over a paged engine) ship a
        # bounded set of first-page block hashes the router can score
        # candidates against.  A broken hook must not fail the health
        # check — routing just falls back to pure p2c for this replica.
        if target is not None and hasattr(target, "prefix_digest"):
            try:
                out["prefix"] = target.prefix_digest()
            except Exception:
                out["prefix"] = None
        return out

    async def queue_len(self) -> int:
        return self.num_ongoing

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Stop accepting new requests; wait for ongoing ones to finish AND
        for buffered streaming chunks to be fully claimed — killing a replica
        whose client is still polling next_chunks() would truncate the
        stream mid-flight."""
        self._draining = True
        deadline = time.monotonic() + timeout_s
        while ((self.num_ongoing > 0 or self._streams)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        return self.num_ongoing == 0 and not self._streams
