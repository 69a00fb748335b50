"""HTTP proxy: the ingress edge of Serve.

Reference: ``python/ray/serve/_private/http_proxy.py:922`` (HTTPProxy /
HTTPProxyActor).  The reference speaks ASGI through uvicorn; here the proxy is
an async actor running an aiohttp server (aiohttp is in the base image;
uvicorn/starlette are not).  Everything on the request path is ``await``-based
— the actor's private event loop must never block on a synchronous
``ray_tpu_torch.get`` or concurrent requests would serialize.

Routing: longest-prefix match on the controller's route table, then
power-of-two-choices replica selection (local in-flight counts), then a direct
actor call to the replica.  Streaming endpoints produce a chunked HTTP
response driven by the replica's ``next_chunks`` long-poll.
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from typing import Any, Dict, List, Optional, Tuple

from . import observability as obs
from .replica import Request

PROXY_NAME = "serve:proxy"


class AsyncRouter:
    """Replica selection + table refresh with async-only control calls.

    Same policy as ``router.Router`` (p2c over local in-flight counts) but
    safe to use on an async actor's event loop; refreshes ride the
    controller's long-poll so table changes propagate in ~one RTT.
    """

    def __init__(self):
        self._table: Dict[str, List[str]] = {}
        self._routes: Dict[str, str] = {}
        self._handles: Dict[str, Any] = {}
        self._inflight: Dict[str, int] = {}
        self._dep_inflight: Dict[str, int] = {}  # queue-depth gauge feed
        self._version = -1
        self._poller: Optional[asyncio.Task] = None

    def _track(self, deployment: str, delta: int):
        if not obs.enabled():  # kill switch sheds the bookkeeping too
            return
        n = self._dep_inflight.get(deployment, 0) + delta
        self._dep_inflight[deployment] = max(0, n)
        obs.set_router_queue_depth(deployment, self._dep_inflight[deployment])

    def _acquire(self, name: str, deployment: str):
        """One in-flight request landed on replica ``name``: bump both the
        p2c per-replica count and the deployment queue-depth gauge.  The
        single copy of this invariant — unary calls and long-lived streams
        must load both the same way."""
        self._inflight[name] = self._inflight.get(name, 0) + 1
        self._track(deployment, +1)

    def _release(self, name: str, deployment: str):
        self._inflight[name] = max(0, self._inflight.get(name, 1) - 1)
        self._track(deployment, -1)

    @staticmethod
    def _traced_submit(submit, deployment: str, t_route: float):
        """Run ``submit()`` with the trace context pointing at a fresh
        ``router_queue`` span id (so the replica's task slice chains
        proxy -> router -> replica), and stamp the span only once the
        submit actually dispatched — a dead-name retry must not leave N
        cumulative router_queue slices for one request."""
        from ray_tpu_torch.util import tracing
        parent = tracing.current_context()
        if parent is None or not obs.enabled():
            return submit()
        span_id = tracing.new_id()
        token = tracing.set_context((parent[0], span_id))
        try:
            out = submit()
        finally:
            tracing.reset_context(token)
        obs.stamp_span(
            "router_queue", t_route, time.time() - t_route,
            trace_id=parent[0], span_id=span_id, parent_id=parent[1],
            deployment=deployment)
        return out

    @staticmethod
    async def _aget(ref):
        import ray_tpu_torch
        return await asyncio.wrap_future(ray_tpu_torch.as_future(ref))

    def _controller(self):
        import ray_tpu_torch
        from .controller import CONTROLLER_NAME
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)

    async def refresh(self, force: bool = False):
        if self._version >= 0 and not force:
            return
        ctrl = self._controller()
        self._version, self._table = await self._aget(
            ctrl.get_routing_table.remote())
        _, self._routes = await self._aget(ctrl.get_http_routes.remote())
        live = {r for reps in self._table.values() for r in reps}
        self._handles = {k: v for k, v in self._handles.items() if k in live}

    def ensure_poller(self):
        if self._poller is None or self._poller.done():
            self._poller = asyncio.get_event_loop().create_task(
                self._poll_loop())

    async def _poll_loop(self):
        ctrl = self._controller()
        while True:
            try:
                self._version, self._table = await self._aget(
                    ctrl.wait_for_table_change.remote(self._version, 10.0))
                _, self._routes = await self._aget(
                    ctrl.get_http_routes.remote())
                live = {r for reps in self._table.values() for r in reps}
                self._handles = {k: v for k, v in self._handles.items()
                                 if k in live}
            except asyncio.CancelledError:
                raise
            except Exception:
                await asyncio.sleep(1.0)

    def match_route(self, path: str) -> Optional[Tuple[str, str]]:
        """Longest-prefix route match -> (deployment, route_prefix)."""
        best = None
        for prefix, dep in self._routes.items():
            if path == prefix or path.startswith(
                    prefix if prefix.endswith("/") else prefix + "/"):
                if best is None or len(prefix) > len(best[1]):
                    best = (dep, prefix)
        return best

    def _handle_for(self, name: str):
        import ray_tpu_torch
        h = self._handles.get(name)
        if h is None:
            h = ray_tpu_torch.get_actor(name)
            self._handles[name] = h
        return h

    async def choose(self, deployment: str, wait_s: float = 5.0) -> str:
        await self.refresh()
        deadline = asyncio.get_event_loop().time() + wait_s
        while True:
            replicas = self._table.get(deployment)
            if replicas:
                break
            if asyncio.get_event_loop().time() > deadline:
                raise LookupError(
                    f"no running replicas for deployment {deployment!r}")
            await self.refresh(force=True)
            await asyncio.sleep(0.1)
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        return (a if self._inflight.get(a, 0) <= self._inflight.get(b, 0)
                else b)

    async def call(self, deployment: str, args: tuple, kwargs: dict,
                   method: Optional[str] = None) -> Any:
        """Route + call + retry-on-dead/draining-replica."""
        from .router import is_retryable_failure
        last: Optional[BaseException] = None
        for _ in range(5):
            # per-attempt stamp: a retry after a replica died mid-request
            # measures ITS OWN routing time, not the failed attempt's
            # execution (each genuine dispatch gets one router_queue span)
            t_route = time.time()
            name = await self.choose(deployment)
            try:
                h = self._handle_for(name)
                ref = self._traced_submit(
                    lambda: h.handle_request.remote(args, kwargs, method),
                    deployment, t_route)
            except Exception as e:  # noqa: BLE001 — dead name
                last = e
                self._evict(deployment, name)
                continue
            self._acquire(name, deployment)
            try:
                return await self._aget(ref)
            except BaseException as e:  # noqa: BLE001
                if not is_retryable_failure(e):
                    raise
                last = e
                self._evict(deployment, name)
            finally:
                self._release(name, deployment)
        raise last  # type: ignore[misc]

    def _evict(self, deployment: str, name: str):
        if name in self._table.get(deployment, []):
            self._table[deployment].remove(name)
        self._handles.pop(name, None)
        try:
            self._controller().report_replica_failure.remote(deployment, name)
        except Exception:
            pass


class HTTPProxyActor:
    """Async actor hosting the aiohttp server (one per ingress node)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self.router = AsyncRouter()
        self._runner = None
        self._streaming_deployments: set = set()

    async def ready(self) -> int:
        """Start the server; returns the bound port."""
        if self._runner is not None:
            return self.port
        from aiohttp import web
        # a wedged proxy loop surfaces as
        # raytpu_event_loop_lag_seconds{process="serve_proxy"}
        obs.ensure_loop_monitor(self, "serve_proxy")
        self.router.ensure_poller()
        app = web.Application()
        app.router.add_route("GET", "/-/healthz", self._healthz)
        app.router.add_route("GET", "/-/routes", self._routes)
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        srv = list(self._runner.sites)[0]._server  # bound socket
        if self.port == 0:
            self.port = srv.sockets[0].getsockname()[1]
        return self.port

    async def _healthz(self, request):
        from aiohttp import web
        return web.Response(text="ok")

    async def _routes(self, request):
        from aiohttp import web
        await self.router.refresh(force=True)
        return web.json_response(self.router._routes)

    async def _handle(self, request):
        from aiohttp import web
        t0 = time.time()
        await self.router.refresh()
        match = self.router.match_route(request.path)
        if match is None:
            # bounded tags: an unmatched path must NOT become a label value
            obs.record_request("_unmatched", "_unmatched", "404",
                               time.time() - t0)
            return web.Response(status=404,
                                text=f"no deployment at {request.path}")
        deployment, prefix = match
        body = await request.read()
        req = Request(method=request.method,
                      path=request.path[len(prefix):] or "/",
                      query=dict(request.query),
                      headers=dict(request.headers),
                      body=body)
        # Request-scoped trace root: everything below — the router_queue
        # span, the replica's task slice, the engine's batch_wait/prefill/
        # decode — chains under this (trace_id, span_id), so `raytpu
        # timeline --breakdown` renders one connected trace per request.
        trace_id = span_id = token = None
        if obs.enabled():
            from ray_tpu_torch.util import tracing
            trace_id, span_id = tracing.new_id(), tracing.new_id()
            token = tracing.set_context((trace_id, span_id))
        status = "500"
        try:
            resp = await self._dispatch(request, deployment, req)
            status = str(resp.status)
            return resp
        except asyncio.CancelledError:
            # aiohttp cancels the handler when the client disconnects —
            # that is not a server error; recording it as 500 would inflate
            # the error rate exactly during client-timeout storms.  499 =
            # client closed request (nginx convention).
            status = "499"
            raise
        except (ConnectionResetError, BrokenPipeError):
            # mid-stream disconnect surfaces as a transport write error,
            # not CancelledError — same classification: the client left
            status = "499"
            raise
        except LookupError as e:
            status = "503"
            return web.Response(status=503, text=str(e))
        except Exception as e:  # noqa: BLE001
            status = "500"
            return web.Response(status=500, text=repr(e))
        finally:
            if token is not None:
                from ray_tpu_torch.util import tracing
                tracing.reset_context(token)
                obs.stamp_span("proxy_recv", t0, time.time() - t0,
                               trace_id=trace_id, span_id=span_id,
                               parent_id=None, deployment=deployment,
                               route=prefix, status=status)
            # `prefix` is the matched route from deployment config — the
            # raw request path never becomes a tag value
            obs.record_request(deployment, prefix, status, time.time() - t0)

    async def _dispatch(self, request, deployment: str, req: Request):
        """Route one matched request (unary or chunked-streaming)."""
        if deployment in self._streaming_deployments:
            return await self._stream_response(request, deployment, req)
        try:
            result = await self.router.call(deployment, (req,), {})
        except Exception as e:
            # A generator endpoint rejects the unary path with a
            # TypeError (TaskError-wrapped): remember it as streaming
            # and re-route through the chunked path.
            cause = getattr(e, "cause", e)
            if isinstance(cause, TypeError) and "streaming" in str(cause):
                self._streaming_deployments.add(deployment)
                return await self._stream_response(request, deployment, req)
            raise
        return self._pack(result)

    async def _stream_response(self, http_request, deployment: str,
                               req: Request):
        """Chunked HTTP response over a native streaming-generator actor call:
        each chunk the replica yields arrives as its own owner-side object
        push — no next_chunks long-poll round trips (the buffered
        handle_request_streaming/next_chunks protocol remains for deployment
        handles that poll)."""
        from .asgi import ASGIStart
        from aiohttp import web
        t_route = time.time()
        name = await self.router.choose(deployment)
        h = self.router._handle_for(name)
        gen = self.router._traced_submit(
            lambda: h.handle_request_gen.options(
                num_returns="streaming", generator_backpressure=256).remote(
                (req,), {}, None),
            deployment, t_route)
        # long-lived streams must load BOTH the queue-depth gauge and the
        # per-replica p2c count — otherwise choose() assigns multi-minute
        # LLM streams blind to each replica's open-stream load
        self.router._acquire(name, deployment)
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "text/plain; charset=utf-8"
        prepared = False
        t_write = None  # first-chunk write -> eof = the stream_write stage
        try:
            async for ref in gen:
                # Surfaces generator errors too: a raise lands as the
                # stream's final ref and re-raises here (truncating the
                # chunked body).
                c = await self.router._aget(ref)
                if not prepared and isinstance(c, ASGIStart):
                    # ASGI ingress streams (ASGIStart, *body chunks): apply
                    # the app's status/headers before the response is
                    # prepared.  Length/framing headers are dropped — this
                    # path chunks.
                    resp.set_status(c.status)
                    keep = [(k, v) for k, v in c.headers
                            if k.lower() not in ("content-length",
                                                 "transfer-encoding")]
                    for k in {k for k, _ in keep}:
                        resp.headers.popall(k, None)
                    for k, v in keep:  # add() preserves repeats (Set-Cookie)
                        resp.headers.add(k, v)
                    continue
                if not prepared:
                    await resp.prepare(http_request)
                    prepared = True
                    t_write = time.time()
                await resp.write(self._chunk_bytes(c))
            if not prepared:
                await resp.prepare(http_request)
            await resp.write_eof()
        finally:
            self.router._release(name, deployment)
            if t_write is not None:
                obs.stamp_span("stream_write", t_write,
                               time.time() - t_write, deployment=deployment)
        return resp

    @staticmethod
    def _chunk_bytes(c: Any) -> bytes:
        if isinstance(c, bytes):
            return c
        if isinstance(c, str):
            return c.encode()
        return (json.dumps(c) + "\n").encode()

    def _pack(self, result: Any):
        from aiohttp import web
        if isinstance(result, web.Response):
            return result
        if isinstance(result, bytes):
            return web.Response(body=result,
                                content_type="application/octet-stream")
        if isinstance(result, str):
            return web.Response(text=result)
        return web.json_response(result)

    async def drain(self) -> bool:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        return True
