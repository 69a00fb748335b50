"""gRPC ingress: the second protocol through the Serve edge.

Reference: ``python/ray/serve/_private/grpc_util.py`` (gRPCServer) and the
gRPC proxy half of ``_private/http_proxy.py`` — a grpc.aio server routing to
the same replica plane as HTTP.  Schema: ``protos/serve.proto``
(rayserve.ServeAPI).  The server registers with grpc's generic-handler API
and (de)serializes the two single-``bytes``-field messages with a
hand-rolled proto3 wire reader, so protoc-compiled clients interoperate
with zero generated code in the framework.

Routing rides invocation metadata ("deployment", optional "method"), the
replica call plane is shared with the HTTP proxy (AsyncRouter: p2c +
retries + table long-poll), and PredictStream uses the replica's native
streaming generator — every chunk ships as a separate gRPC message.
"""

from __future__ import annotations

import json
from typing import Any, AsyncIterator

from .http_proxy import AsyncRouter
from .replica import Request

GRPC_PROXY_NAME = "serve:grpc_proxy"
SERVICE_NAME = "rayserve.ServeAPI"


# ------------------------------------------------------- proto3 wire codec
# ServeRequest/ServeResponse/HealthzResponse each carry ONE length-delimited
# field (#1); the codec below is the full wire format for that shape.

def _varint_decode(buf: bytes, i: int):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _varint_encode(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decode_payload(buf: bytes) -> bytes:
    """Field 1 (length-delimited) of a proto3 message; b'' if absent."""
    i, n, payload = 0, len(buf), b""
    while i < n:
        tag, i = _varint_decode(buf, i)
        wire = tag & 7
        if wire == 2:
            ln, i = _varint_decode(buf, i)
            val = bytes(buf[i:i + ln])
            i += ln
            if tag >> 3 == 1:
                payload = val
        elif wire == 0:
            _, i = _varint_decode(buf, i)
        elif wire == 5:
            i += 4
        elif wire == 1:
            i += 8
        else:
            raise ValueError(f"unsupported proto wire type {wire}")
    return payload


def encode_payload(data: bytes) -> bytes:
    if not data:
        return b""  # proto3 default field is omitted
    return b"\x0a" + _varint_encode(len(data)) + data


def _result_bytes(result: Any) -> bytes:
    if isinstance(result, (bytes, bytearray)):
        return bytes(result)
    if isinstance(result, str):
        return result.encode()
    return json.dumps(result).encode()


class GrpcProxyActor:
    """Async actor hosting the grpc.aio ingress (one per edge node)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.router = AsyncRouter()
        self._server = None

    async def ready(self) -> int:
        import grpc

        if self._server is not None:
            return self.port
        self.router.ensure_poller()
        server = grpc.aio.server()
        ident = bytes
        handlers = {
            "Predict": grpc.unary_unary_rpc_method_handler(
                self._predict,
                request_deserializer=decode_payload,
                response_serializer=encode_payload),
            "PredictStream": grpc.unary_stream_rpc_method_handler(
                self._predict_stream,
                request_deserializer=decode_payload,
                response_serializer=encode_payload),
            "Healthz": grpc.unary_unary_rpc_method_handler(
                self._healthz,
                request_deserializer=ident,
                response_serializer=encode_payload),
            "ListDeployments": grpc.unary_unary_rpc_method_handler(
                self._list_deployments,
                request_deserializer=ident,
                response_serializer=encode_payload),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))
        self.port = server.add_insecure_port(f"{self.host}:{self.port}")
        await server.start()
        self._server = server
        return self.port

    async def get_config(self) -> dict:
        return {"host": self.host, "port": self.port}

    # ------------------------------------------------------------ handlers

    @staticmethod
    def _route_metadata(context):
        md = {k: v for k, v in (context.invocation_metadata() or ())}
        return md

    async def _target(self, context):
        import grpc

        md = self._route_metadata(context)
        deployment = md.get("deployment")
        if not deployment:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                "missing 'deployment' metadata key")
        return deployment, md.get("method") or None, md

    async def _predict(self, payload: bytes, context) -> bytes:
        import grpc

        deployment, method, md = await self._target(context)
        req = Request(method="GRPC", path="/", headers=md, body=payload)
        try:
            result = await self.router.call(deployment, (req,), {},
                                            method=method)
        except LookupError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:  # noqa: BLE001 — replica-side error
            await context.abort(grpc.StatusCode.INTERNAL, repr(e))
        return _result_bytes(result)

    async def _predict_stream(self, payload: bytes,
                              context) -> AsyncIterator[bytes]:
        import grpc

        deployment, method, md = await self._target(context)
        req = Request(method="GRPC", path="/", headers=md, body=payload)
        try:
            name = await self.router.choose(deployment)
            h = self.router._handle_for(name)
            gen = h.handle_request_gen.options(
                num_returns="streaming", generator_backpressure=256).remote(
                (req,), {}, method)
            from .asgi import ASGIStart
            async for ref in gen:
                chunk = await self.router._aget(ref)
                if isinstance(chunk, ASGIStart):
                    continue  # HTTP framing has no gRPC equivalent
                yield _result_bytes(chunk)
        except LookupError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:  # noqa: BLE001 — same contract as _predict
            await context.abort(grpc.StatusCode.INTERNAL, repr(e))

    async def _healthz(self, _request: bytes, _context) -> bytes:
        return b"ok"

    async def _list_deployments(self, _request: bytes, _context) -> bytes:
        await self.router.refresh(force=True)
        return json.dumps(self.router._routes).encode()

    async def drain(self) -> bool:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None
        return True
