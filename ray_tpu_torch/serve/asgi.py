"""ASGI ingress: mount an existing web application on a deployment.

Reference: ``python/ray/serve/api.py:194`` (``@serve.ingress(app)``) — users
bring an app that owns routing/middleware/docs and Serve mounts it behind
the proxy at the deployment's route prefix.  The reference takes a FastAPI
object; here ``ingress`` accepts ANY ASGI-3 callable ``app(scope, receive,
send)`` (starlette/FastAPI are not in this image — the bundled ``ASGIApp``
mini-framework below provides decorator routing + middleware so apps can be
written offline, but anything speaking ASGI works).

How it plugs in: the decorated class's ``__call__`` becomes an async
GENERATOR that drives the ASGI app and yields an ``ASGIStart`` (status +
headers) followed by body chunks as the app ``send``s them.  The replica's
native streaming-generator path ships each chunk the moment it is yielded,
and the HTTP proxy applies ``ASGIStart`` before preparing the chunked
response — so ASGI streaming responses (SSE and friends) stream end to end.
The replica instance is exposed to the app as ``scope["state"]["replica"]``
(the reference exposes it via FastAPI dependency injection).
"""

from __future__ import annotations

import asyncio
import functools
import json as _json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlencode

from .replica import Request


class ASGIStart:
    """First item of a streamed ASGI response: status + headers."""

    __slots__ = ("status", "headers")

    def __init__(self, status: int, headers: List[Tuple[str, str]]):
        self.status = status
        self.headers = headers

    def __repr__(self):
        return f"ASGIStart({self.status}, {self.headers!r})"


def _scope_for(request: Request, state: Optional[dict]) -> dict:
    q = urlencode(request.query) if request.query else ""
    return {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "scheme": "http",
        "path": request.path,
        "raw_path": request.path.encode(),
        "root_path": "",
        "query_string": q.encode(),
        "headers": [(k.lower().encode(), str(v).encode())
                    for k, v in request.headers.items()],
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
        "state": dict(state or {}),
    }


async def run_asgi(app: Callable, request: Request,
                   state: Optional[dict] = None):
    """Drive ONE HTTP request through an ASGI app.

    Async generator: yields ``ASGIStart`` once, then body ``bytes`` chunks
    in ``send`` order.  The app runs concurrently so a streaming app's
    chunks flow out before it returns.
    """
    scope = _scope_for(request, state)
    body = request.body or b""
    delivered = False

    async def receive():
        nonlocal delivered
        if not delivered:
            delivered = True
            return {"type": "http.request", "body": body, "more_body": False}
        return {"type": "http.disconnect"}

    out: asyncio.Queue = asyncio.Queue()

    async def send(message):
        await out.put(message)

    loop = asyncio.get_event_loop()
    app_task = loop.create_task(app(scope, receive, send))
    try:
        finished = False
        while not finished:
            q_get = loop.create_task(out.get())
            done, _ = await asyncio.wait(
                {q_get, app_task}, return_when=asyncio.FIRST_COMPLETED)
            msgs = []
            if q_get in done:
                msgs.append(q_get.result())
            else:
                q_get.cancel()
                exc = app_task.exception()
                if exc is not None:
                    raise exc
                while not out.empty():
                    msgs.append(out.get_nowait())
                finished = True
            for msg in msgs:
                t = msg.get("type")
                if t == "http.response.start":
                    yield ASGIStart(
                        int(msg.get("status", 200)),
                        [(k.decode(), v.decode())
                         for k, v in msg.get("headers", [])])
                elif t == "http.response.body":
                    chunk = msg.get("body", b"")
                    if chunk:
                        yield chunk
                    if not msg.get("more_body", False):
                        await app_task
                        finished = True
                        break
    finally:
        if not app_task.done():
            app_task.cancel()


def ingress(asgi_app: Callable):
    """Class decorator mounting an ASGI app on a deployment.

    Usage (reference api.py:194 shape)::

        app = ASGIApp()          # or any ASGI callable

        @serve.deployment
        @serve.ingress(app)
        class Site:
            def __init__(self): self.hits = 0

    Every HTTP request routed to the deployment flows through ``asgi_app``;
    the instance is ``scope["state"]["replica"]``.
    """
    def decorator(cls: Optional[type] = None):
        if cls is None:
            cls = object

        class _ASGIIngress(cls):  # type: ignore[valid-type,misc]
            __serve_asgi_app__ = asgi_app

            async def __call__(self, request: Request):
                async for item in run_asgi(
                        asgi_app, request, {"replica": self}):
                    yield item

        functools.update_wrapper(_ASGIIngress, cls, updated=[])
        _ASGIIngress.__name__ = getattr(cls, "__name__", "ASGIIngress")
        _ASGIIngress.__qualname__ = _ASGIIngress.__name__
        return _ASGIIngress
    return decorator


# --------------------------------------------------------------------------
# Minimal ASGI application framework (offline stand-in for starlette).


class ASGIRequest:
    """What ASGIApp handlers receive: parsed scope + buffered body."""

    def __init__(self, scope: dict, body: bytes):
        self.scope = scope
        self.method = scope.get("method", "GET")
        self.path = scope.get("path", "/")
        self.headers = {k.decode(): v.decode()
                        for k, v in scope.get("headers", [])}
        self.query = {}
        qs = scope.get("query_string", b"").decode()
        if qs:
            from urllib.parse import parse_qsl
            self.query = dict(parse_qsl(qs))
        self.body = body
        self.path_params: Dict[str, str] = {}
        self.state = scope.get("state", {})

    def json(self):
        return _json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()


class ASGIApp:
    """Tiny ASGI-3 app: decorator routing (with ``{param}`` segments),
    middleware chain, JSON/text/bytes/stream responses.

    Handlers: ``async def h(req: ASGIRequest)`` returning ``dict`` (JSON),
    ``str``/``bytes``, ``(status, payload)``, or an async generator
    (streamed chunks).  Middleware: ``async def mw(req, call_next)`` where
    ``await call_next(req)`` yields the downstream ``(status, headers,
    payload_or_gen)`` triple — it can short-circuit or mutate either side.
    """

    def __init__(self):
        self._routes: List[Tuple[set, re.Pattern, list, Callable]] = []
        self._middleware: List[Callable] = []

    def route(self, path: str, methods=("GET",)):
        # literal segments regex-escaped; only {param} groups match wild
        parts = re.split(r"{(\w+)}", path.rstrip("/") or "/")
        names = parts[1::2]
        pat = re.compile(
            "^" + "".join(re.escape(p) if i % 2 == 0 else r"([^/]+)"
                          for i, p in enumerate(parts)) + "$")

        def deco(fn):
            self._routes.append(
                ({m.upper() for m in methods}, pat, names, fn))
            return fn
        return deco

    def get(self, path: str):
        return self.route(path, ("GET",))

    def post(self, path: str):
        return self.route(path, ("POST",))

    def middleware(self, fn: Callable):
        self._middleware.append(fn)
        return fn

    # ------------------------------------------------------------ dispatch

    @staticmethod
    def _normalize(result: Any) -> Tuple[int, list, Any]:
        status, payload = 200, result
        if (isinstance(result, tuple) and len(result) == 2
                and isinstance(result[0], int)):
            status, payload = result
        if hasattr(payload, "__aiter__"):
            return status, [("content-type", "text/plain; charset=utf-8")], \
                payload
        if isinstance(payload, (dict, list)):
            return status, [("content-type", "application/json")], \
                _json.dumps(payload).encode()
        if isinstance(payload, str):
            return status, [("content-type", "text/plain; charset=utf-8")], \
                payload.encode()
        if payload is None:
            payload = b""
        return status, [("content-type", "application/octet-stream")], \
            payload

    async def _dispatch(self, req: ASGIRequest) -> Tuple[int, list, Any]:
        for methods, pat, names, fn in self._routes:
            m = pat.match(req.path.rstrip("/") or "/")
            if m and req.method.upper() in methods:
                req.path_params = dict(zip(names, m.groups()))
                out = fn(req)
                if asyncio.iscoroutine(out):
                    out = await out
                return self._normalize(out)
        return 404, [("content-type", "text/plain")], \
            f"no route for {req.method} {req.path}".encode()

    async def __call__(self, scope, receive, send):
        if scope["type"] != "http":  # lifespan etc.: ignore politely
            return
        chunks = []
        while True:
            msg = await receive()
            if msg["type"] != "http.request":
                break
            chunks.append(msg.get("body", b""))
            if not msg.get("more_body", False):
                break
        req = ASGIRequest(scope, b"".join(chunks))

        call = self._dispatch
        for mw in reversed(self._middleware):
            call = functools.partial(mw, call_next=call)
        try:
            status, headers, payload = await call(req)
        except Exception as e:  # noqa: BLE001 — app-level 500
            status, headers, payload = 500, \
                [("content-type", "text/plain")], repr(e).encode()
        await send({"type": "http.response.start", "status": status,
                    "headers": [(k.lower().encode(), str(v).encode())
                                for k, v in headers]})
        if hasattr(payload, "__aiter__"):
            async for chunk in payload:
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                elif not isinstance(chunk, (bytes, bytearray)):
                    chunk = (_json.dumps(chunk) + "\n").encode()
                await send({"type": "http.response.body", "body": bytes(chunk),
                            "more_body": True})
            await send({"type": "http.response.body", "body": b"",
                        "more_body": False})
        else:
            await send({"type": "http.response.body", "body": payload,
                        "more_body": False})
