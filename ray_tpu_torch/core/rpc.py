"""Asyncio RPC: length-prefixed pickled messages over TCP.

Plays the role of the reference's gRPC wrapper layer (``src/ray/rpc/`` — ``grpc_server.h``,
``client_call.h``): every control-plane service (GCS-equivalent, node agents, workers)
exposes coroutine handlers on an :class:`RpcServer`; clients hold persistent connections
with request/response correlation, automatic reconnect, and call timeouts (reference:
retryable gRPC clients).  The wire format is ``4-byte length | pickle((req_id, method,
args))``; responses are ``(req_id, ok, payload)``.  Messages with ``req_id < 0`` are
one-way notifications (used by pubsub long-polls, reference ``src/ray/pubsub/``).

A single background event-loop thread per process hosts every server and client
(reference analogue: the single-threaded asio io_context per component,
``src/ray/common/asio/``) — this keeps handler code free of locks.
"""

from __future__ import annotations

import asyncio
import itertools
import pickle
import random
import threading
import time
import traceback
import uuid
from typing import Any, Callable, Dict, Optional

from . import chaos
from .chaos import ChaosFault
from .config import get_config

_loop_lock = threading.Lock()
# IO-loop LANES: lane 0 is the process's default background loop (the
# historical single "raytpu-io" thread every component shares); additional
# lanes are extra loop threads that carry their own subset of connections —
# the submission-lane / control-plane-lane substrate (ROADMAP item 5: one
# driver's submit path spread over multiple OS threads so socket syscalls,
# frame codecs and read loops overlap instead of serializing on one loop).
# Keys are small ints or short strings (("lane", i) tuples, "cp-gcs", ...).
_lanes: Dict[Any, tuple] = {}  # lane key -> (loop, thread)


def get_loop(lane: Any = 0) -> asyncio.AbstractEventLoop:
    """The process-wide background event loop for ``lane`` (started
    lazily).  ``get_loop()`` is the default lane every existing caller
    uses; other lanes are opt-in via the lane-aware clients."""
    with _loop_lock:
        ent = _lanes.get(lane)
        if ent is None or ent[0].is_closed():
            loop = asyncio.new_event_loop()
            started = threading.Event()

            def _run():
                asyncio.set_event_loop(loop)
                loop.call_soon(started.set)
                loop.run_forever()

            name = "raytpu-io" if lane == 0 else f"raytpu-io-{lane}"
            t = threading.Thread(target=_run, name=name, daemon=True)
            t.start()
            started.wait()
            _lanes[lane] = (loop, t)
        return _lanes[lane][0]


def run_async(coro, timeout: float | None = None, lane: Any = 0):
    """Run a coroutine on the IO loop of ``lane`` from a synchronous
    caller."""
    loop = get_loop(lane)
    if threading.current_thread() is _lanes[lane][1]:
        raise RuntimeError("run_async called from the IO loop thread (would deadlock)")
    fut = asyncio.run_coroutine_threadsafe(coro, loop)
    return fut.result(timeout)


# --------------------------------------------------------- RPC self-metrics
#
# Per-method client/server latency histograms, byte counters, an in-flight
# gauge and error counters (reference: grpc server/client interceptor stats
# feeding metric_defs.cc).  One lazy singleton per process — every RpcServer
# and RpcClient in the process shares it, and the regular registry flush
# ships it to the node agent's /metrics endpoint.  Disabled (config
# rpc_metrics_enabled=False) the hot path pays a single None check.

class _RpcMetrics:
    __slots__ = ("client_seconds", "server_seconds", "bytes_sent",
                 "bytes_received", "client_inflight", "errors", "reconnects",
                 "client_inflight_n", "_keys")

    def method_keys(self, method: str) -> tuple:
        """Precomputed sorted tag-key tuples for one method:
        (latency, client-bytes, server-bytes).  Built once per method —
        the hot path then calls the *_key metric fast paths instead of
        re-sorting a tags dict per frame."""
        k = self._keys.get(method)
        if k is None:
            k = self._keys[method] = (
                (("method", method),),
                (("method", method), ("role", "client")),
                (("method", method), ("role", "server")),
            )
        return k

    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
        self.client_seconds = Histogram(
            "raytpu_rpc_client_seconds",
            "RPC client call latency (request sent -> response future done)",
            tag_keys=("method",))
        self.server_seconds = Histogram(
            "raytpu_rpc_server_seconds",
            "RPC server handler latency by method",
            tag_keys=("method",))
        self.bytes_sent = Counter(
            "raytpu_rpc_bytes_sent_total",
            "RPC frame bytes written, by method and side",
            tag_keys=("method", "role"))
        self.bytes_received = Counter(
            "raytpu_rpc_bytes_received_total",
            "RPC frame bytes read, by method and side",
            tag_keys=("method", "role"))
        self.client_inflight = Gauge(
            "raytpu_rpc_client_inflight",
            "RPC client calls awaiting a response in this process"
        ).set_fn(lambda: self.client_inflight_n)  # pull-based: zero hot-path cost
        self.errors = Counter(
            "raytpu_rpc_errors_total",
            "RPC failures by method, exception kind and side",
            tag_keys=("method", "kind", "role"))
        self.reconnects = Counter(
            "raytpu_rpc_reconnects_total",
            "client reconnections after a lost connection")
        self.client_inflight_n = 0
        self._keys: Dict[str, tuple] = {}


def _build_rpc_metrics():
    return _RpcMetrics() if get_config().rpc_metrics_enabled else None


_rpc_metrics_get: Optional[Callable[[], Optional[_RpcMetrics]]] = None


def rpc_metrics() -> Optional[_RpcMetrics]:
    global _rpc_metrics_get
    if _rpc_metrics_get is None:
        # the util.metrics import is deferred to FIRST CALL: at module
        # import time it would re-enter the ray_tpu_torch package init (circular)
        from ray_tpu_torch.util.metrics import lazy
        _rpc_metrics_get = lazy(_build_rpc_metrics)
    return _rpc_metrics_get()


def _encode(msg) -> bytes:
    payload = pickle.dumps(msg, protocol=5)
    if len(payload) >= 0x8000_0000:
        # The length word's top bit is the vectored-frame flag (_VEC_FLAG):
        # a >=2 GiB in-band payload would alias it and desync the stream.
        # Fail loudly — payloads that large must ship out-of-band.
        raise ValueError(f"frame payload too large ({len(payload)} B >= 2 GiB)")
    return len(payload).to_bytes(4, "big") + payload


# Vectored large-frame protocol: a frame whose length word has the top bit
# set carries out-of-band buffers after the pickle stream —
#
#   [4B VEC_FLAG | len(payload)] [payload] [4B nbufs] [8B hint]
#                                          [8B size]*nbufs [buf]*
#
# Large buffer-protocol payloads (object chunks, big inlined task args) ride
# as raw bytes instead of being re-copied through the pickle stream: the
# sender writes each buffer straight from its source memory (writev-style —
# see _flush_writer's large-part handling), and the receiver reads each into
# its own contiguous allocation and hands it to pickle out-of-band.  That
# removes one full-payload copy per side versus in-band pickling.
#
# ``hint`` is the reply's req_id (0 for requests/notifies): it lets the
# CLIENT route the first out-of-band buffer into a pre-registered
# destination view (``RpcClient.call_into`` — chunk pulls land readinto-
# style straight into the target shm segment, skipping the intermediate
# ``bytes`` materialization AND the slice-assign copy).  The req_id cannot
# serve this purpose from inside the payload: pickle.loads needs the
# buffers BEFORE it can surface the req_id.
_VEC_FLAG = 0x8000_0000
#: buffers below this stay in-band (framing + syscall overhead dominates)
_VEC_MIN_BUF = 256 * 1024
#: flush-queue parts at least this large are written individually (no join)
_LARGE_PART = 128 * 1024


def _encode_parts(msg, hint: int = 0) -> list:
    """Encode ``msg``, extracting large contiguous buffers out-of-band.
    Returns a list of wire parts (length 1 == a regular frame).  ``hint``
    rides the vectored header (the reply's req_id; see protocol note)."""
    bufs: list = []

    def _cb(pb: pickle.PickleBuffer):
        try:
            raw = pb.raw()
        except Exception:
            return True  # non-contiguous: serialize in-band
        if raw.nbytes < _VEC_MIN_BUF:
            return True
        bufs.append(raw)
        return False

    payload = pickle.dumps(msg, protocol=5, buffer_callback=_cb)
    if len(payload) >= _VEC_FLAG:
        raise ValueError(f"frame payload too large ({len(payload)} B >= 2 GiB)")
    if not bufs:
        return [len(payload).to_bytes(4, "big") + payload]
    head = ((_VEC_FLAG | len(payload)).to_bytes(4, "big") + payload
            + len(bufs).to_bytes(4, "big")
            + max(0, hint).to_bytes(8, "big")
            + b"".join(b.nbytes.to_bytes(8, "big") for b in bufs))
    return [head] + bufs


def coalesced_write(writer: "asyncio.StreamWriter", data: bytes) -> None:
    """Queue a frame and flush once per event-loop tick.

    One socket write per message was the top cost in PROFILE_CORE.md (53-68%
    of IO-loop samples in streams.write during tasks_async / n:n actors):
    every task submission, reply, and streamed result paid its own
    transport write.  Buffering frames and writing the concatenation on the
    next loop tick batches everything enqueued in the current tick into one
    syscall, preserving FIFO order PROVIDED every frame on a given writer
    goes through this function (mixing with direct writer.write would
    reorder).  Flow control: callers in coroutine context should
    ``await drain_if_needed(writer)`` after queueing.

    The FIRST frame of a tick writes through immediately (nothing is
    queued ahead of it, so FIFO holds): a single request/reply stops
    paying a +1-tick latency to an empty coalescing buffer — sequential
    RPC chains (sync task calls, the PG 2PC) were loop-tick-bound, not
    syscall-bound (ROADMAP 5).  A burst still batches frames 2..N of the
    tick into one write."""
    buf = getattr(writer, "_raytpu_buf", None)
    if buf is None:
        buf = writer._raytpu_buf = []
        writer._raytpu_buf_bytes = 0
    if not buf and not getattr(writer, "_raytpu_flush_scheduled", False):
        writer._raytpu_flush_scheduled = True
        asyncio.get_event_loop().call_soon(_flush_writer, writer)
        try:
            writer.write(data)
        except Exception:
            pass  # connection died; the read loop surfaces it
        return
    buf.append(data)
    writer._raytpu_buf_bytes += len(data)
    if not getattr(writer, "_raytpu_flush_scheduled", False):
        writer._raytpu_flush_scheduled = True
        asyncio.get_event_loop().call_soon(_flush_writer, writer)


def coalesced_write_frame(writer: "asyncio.StreamWriter", msg,
                          hint: int = 0) -> int:
    """Encode + queue one message, using the vectored wire format when the
    payload carries large buffers.  Vectored frames flush IMMEDIATELY (in
    FIFO order with everything already queued): their out-of-band parts are
    views over caller memory that must not dangle across a loop tick, and a
    multi-MB frame gains nothing from coalescing anyway.  Returns the wire
    bytes queued (the RPC byte counters' data source)."""
    parts = _encode_parts(msg, hint)
    if len(parts) == 1:
        coalesced_write(writer, parts[0])
        return len(parts[0])
    buf = getattr(writer, "_raytpu_buf", None)
    if buf is None:
        buf = writer._raytpu_buf = []
        writer._raytpu_buf_bytes = 0
    nbytes = sum(len(p) for p in parts)
    buf.extend(parts)
    writer._raytpu_buf_bytes += nbytes
    _flush_writer(writer)
    return nbytes


def _flush_writer(writer: "asyncio.StreamWriter") -> None:
    writer._raytpu_flush_scheduled = False
    buf = getattr(writer, "_raytpu_buf", None)
    if not buf:
        return
    parts = list(buf)
    buf.clear()
    writer._raytpu_buf_bytes = 0
    try:
        if len(parts) == 1:
            writer.write(parts[0])
            return
        # Small frames coalesce into one write; large parts (vectored
        # buffers) are written individually so a multi-MB payload never
        # pays a user-space concatenation — the socket layer copies it
        # straight from the source view into the kernel.
        run: list = []
        for p in parts:
            if len(p) >= _LARGE_PART:
                if run:
                    writer.write(b"".join(run))
                    run = []
                writer.write(p)
            else:
                run.append(p)
        if run:
            writer.write(b"".join(run) if len(run) > 1 else run[0])
    except Exception:
        pass  # connection died; the read loop surfaces it


async def drain_if_needed(writer: "asyncio.StreamWriter",
                          high_water: int = 1 << 20) -> None:
    """Apply backpressure only when the transport buffer is actually deep —
    an unconditional drain() per frame defeats the coalescing.  Pending
    coalesced frames still sit in the Python-level buffer until the next
    loop tick, so they must count toward the high-water mark: a coroutine
    emitting many frames without a real await never yields to the loop,
    and the transport alone would read as empty forever."""
    try:
        pending = getattr(writer, "_raytpu_buf_bytes", 0)
        if (pending + writer.transport.get_write_buffer_size()) > high_water:
            _flush_writer(writer)
            await writer.drain()
    except Exception:
        pass


class _OobSink:
    """A registered destination for one reply's out-of-band buffer (see
    ``RpcClient.call_into``).  ``done`` is set once the read loop has
    finished (or abandoned) landing into ``view`` — the caller's cleanup
    awaits it so no late frame can write into memory the caller is about
    to recycle."""

    __slots__ = ("view", "started", "done")

    def __init__(self, view: memoryview):
        self.view = view
        self.started = False
        self.done = asyncio.Event()


async def _read_buffer_into(reader: asyncio.StreamReader,
                            view: memoryview) -> None:
    """readinto-style exact read: drain the stream buffer DIRECTLY into
    ``view`` (one copy) instead of materializing an intermediate ``bytes``
    and slice-assigning it (two copies).  Uses StreamReader's internal
    buffer the same way readexactly does; falls back to readexactly+copy
    if the internals ever change shape."""
    n = view.nbytes
    buf = getattr(reader, "_buffer", None)
    if buf is None or not hasattr(reader, "_wait_for_data") \
            or not hasattr(reader, "_maybe_resume_transport"):
        view[:] = await reader.readexactly(n)
        return
    pos = 0
    while pos < n:
        exc = reader.exception()
        if exc is not None:
            raise exc
        if buf:
            take = min(len(buf), n - pos)
            with memoryview(buf) as mv:
                view[pos:pos + take] = mv[:take]
            del buf[:take]
            reader._maybe_resume_transport()
            pos += take
            continue
        if reader.at_eof():
            raise asyncio.IncompleteReadError(b"", n)
        await reader._wait_for_data("_read_buffer_into")


async def _read_msg(reader: asyncio.StreamReader,
                    sinks: Optional[Dict[int, _OobSink]] = None):
    """-> (message, wire_bytes) for one frame.

    ``sinks`` (client side only): req_id -> _OobSink.  When a vectored
    reply's hint matches a registered sink, its first out-of-band buffer
    is landed readinto-style straight into the sink view and that view is
    handed to pickle — zero-extra-copy receive for chunk pulls."""
    hdr = await reader.readexactly(4)
    n = int.from_bytes(hdr, "big")
    if not n & _VEC_FLAG:
        return pickle.loads(await reader.readexactly(n)), 4 + n
    # Vectored frame: pickle stream + out-of-band buffers.  Each buffer is
    # read into its own allocation (or the registered sink) and handed to
    # pickle out-of-band — in-band pickling would pay an extra copy
    # materializing the bytes out of the stream.
    plen = n & (_VEC_FLAG - 1)
    payload = await reader.readexactly(plen)
    nbufs = int.from_bytes(await reader.readexactly(4), "big")
    hint = int.from_bytes(await reader.readexactly(8), "big")
    sizes_raw = await reader.readexactly(8 * nbufs)
    bufs = []
    total = 16 + plen + 8 * nbufs
    entry = sinks.pop(hint, None) if (sinks is not None and hint) else None
    try:
        for i in range(nbufs):
            size = int.from_bytes(sizes_raw[8 * i:8 * i + 8], "big")
            if entry is not None and size <= entry.view.nbytes:
                entry.started = True
                try:
                    target = entry.view[:size]
                    await _read_buffer_into(reader, target)
                    bufs.append(target)
                finally:
                    entry.done.set()
                entry = None
            else:
                bufs.append(await reader.readexactly(size))
            total += size
    finally:
        if entry is not None:  # popped but unused (size mismatch)
            entry.done.set()
    return pickle.loads(payload, buffers=bufs), total


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class TransientServerError(RpcError):
    """Handler-raised transient failure with DROP-from-cache semantics:
    the reply is an error, but the idempotency entry for the call's token
    is removed instead of recorded — a same-token retry RE-EXECUTES the
    handler rather than replaying a stale error (used e.g. for lease
    grants that completed after the requester's connection died; the
    retry arrives on a live connection and deserves a fresh grant).
    ``call_retry`` treats it as retryable."""


class RemoteError(RpcError):
    """Handler raised; carries the remote traceback string."""

    def __init__(self, cause: BaseException, tb: str):
        super().__init__(f"{type(cause).__name__}: {cause}\n--- remote traceback ---\n{tb}")
        self.cause = cause
        self.remote_traceback = tb

    def __reduce__(self):
        # Default exception reduce would replay __init__ with the formatted
        # message only (TypeError on unpickle) — rebuild from the real parts
        # so a RemoteError inside a shipped task-error blob round-trips.
        return (RemoteError, (self.cause, self.remote_traceback))


class _BusyTimed:
    """Await a coroutine while accumulating the duration of each of its
    SYNCHRONOUS segments (the stretches between suspension points) into
    ``acc[0]``.

    Driving the inner coroutine's ``__await__`` iterator by hand lets the
    wrapper clock every ``send``/``throw`` — so a handler that parks 30 s
    in a long-poll attributes only the slivers it actually ran, while a
    handler that pickles a 10 MB table attributes all of it.  That
    distinction is the whole point: wall-time histograms
    (raytpu_rpc_server_seconds) can't tell "slow because busy" from
    "slow because waiting".  Segments are timed with ``perf_counter``,
    not the thread-CPU clock: a synchronous segment monopolizes the event
    loop for its full wall duration (GIL waits included), and that —
    "how long did this handler block the loop" — is the saturation
    signal; the thread-CPU clock also ticks too coarsely (10 ms on some
    kernels) to see microsecond handlers at all."""

    __slots__ = ("coro", "acc")

    def __init__(self, coro, acc):
        self.coro = coro
        self.acc = acc

    def __await__(self):
        it = self.coro.__await__()
        acc = self.acc
        val, exc = None, None
        while True:
            t0 = time.perf_counter()
            try:
                if exc is not None:
                    e, exc = exc, None
                    y = it.throw(e)
                else:
                    y = it.send(val)
            except StopIteration as e:
                acc[0] += time.perf_counter() - t0
                return e.value
            except BaseException:
                acc[0] += time.perf_counter() - t0
                raise
            acc[0] += time.perf_counter() - t0
            try:
                val = yield y
            except BaseException as e:  # noqa: BLE001 — forwarded inward
                val, exc = None, e


class RpcServer:
    """Dispatches ``(req_id, method, kwargs)`` to ``handler.handle_<method>`` coroutines."""

    #: idempotency-cache ceilings (entries AND approximate bytes — large
    #: cached replies, e.g. token'd actor_task inline results, must not
    #: pool hundreds of MB for the whole dedup window)
    IDEM_CACHE_MAX = 4096
    IDEM_CACHE_MAX_BYTES = 64 << 20

    def __init__(self, handler: Any, host: str = "127.0.0.1", port: int = 0,
                 bulk_replies: bool = False):
        self.handler = handler
        self.host = host
        self.port = port
        #: servers that stream multi-MB reply frames (node agents serving
        #: read_chunk) raise SO_SNDBUF on every accepted connection — a
        #: buffer CAP, not committed memory — so a vectored chunk reply
        #: moves in a few large sends instead of dozens of partial ones
        self.bulk_replies = bulk_replies
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.StreamWriter] = set()
        #: optional per-handler BUSY-seconds attribution callback
        #: ``(method, busy_s) -> None`` — when set (the GCS does, behind
        #: sched_metrics_enabled), each dispatch drives the handler
        #: coroutine through ``_BusyTimed`` and reports the time its
        #: synchronous segments blocked the loop (awaits excluded), the
        #: signal that names which handler is eating the event loop.
        self.busy_cb = None
        # Idempotency dedup window (reference: exactly-once semantics for
        # retried mutating RPCs): token -> (expiry, in-flight future |
        # (ok, result), approx_bytes).  A retry carrying a token already
        # seen replays the recorded reply — or awaits the original
        # execution still in flight — instead of re-running the handler.
        self._idem: Dict[str, tuple] = {}
        self._idem_bytes = 0

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self):
        # 16 MB stream buffer: the default 64 KB limit makes readexactly of
        # multi-MB frames (object chunks) crawl through hundreds of tiny
        # transport reads with pause/resume churn.
        self._server = await asyncio.start_server(self._on_conn, self.host,
                                                  self.port, limit=16 << 20)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def start_sync(self) -> "RpcServer":
        return run_async(self.start())

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conns.add(writer)
        if self.bulk_replies:
            try:
                import socket as _socket
                sock = writer.get_extra_info("socket")
                if sock is not None:
                    sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF,
                                    RpcClient.BULK_SOCK_BUF)
            except Exception:
                pass
        peer = writer.get_extra_info("peername")
        if hasattr(self.handler, "on_connect"):
            await self.handler.on_connect(peer, writer)
        try:
            while True:
                try:
                    (req_id, method, kwargs), nbytes = await _read_msg(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                m = rpc_metrics()
                if m is not None:
                    m.bytes_received.inc_key(m.method_keys(method)[2],
                                             nbytes)
                # Handle each request concurrently so a slow handler (e.g. a
                # blocking Get) doesn't head-of-line-block the connection.
                asyncio.ensure_future(self._dispatch(writer, req_id, method, kwargs))
        finally:
            self._conns.discard(writer)
            if hasattr(self.handler, "on_disconnect"):
                try:
                    await self.handler.on_disconnect(peer, writer)
                except Exception:
                    pass
            try:
                writer.close()
            except Exception:
                pass

    @classmethod
    def _approx_result_bytes(cls, result, _depth: int = 3) -> int:
        """Cheap size estimate for a cached reply: count bytes-like
        payloads (the only members that can be large) a few levels deep —
        actor replies are LISTS of ('inline', bytes, ...) tuples, so one
        level would miss every inline payload."""
        if isinstance(result, (bytes, bytearray, memoryview)):
            return len(result)
        n = 64
        if _depth > 0 and isinstance(result, (tuple, list)):
            for el in result:
                n += cls._approx_result_bytes(el, _depth - 1)
        return n

    def _idem_pop(self, tok: str):
        ent = self._idem.pop(tok, None)
        if ent is not None:
            self._idem_bytes -= ent[2]

    def _idem_store(self, tok: str, entry, nbytes: int):
        old = self._idem.get(tok)
        if old is not None:
            self._idem_bytes -= old[2]
        self._idem[tok] = (
            time.monotonic() + get_config().rpc_dedup_window_s, entry, nbytes)
        self._idem_bytes += nbytes

    def _prune_idem(self):
        # Amortized front-of-dict expiry: insertion order == arrival order
        # (value replacement keeps a key's position), so expired entries
        # cluster at the front.  Keeps the cache sized to the live window
        # instead of letting big cached results pool until the ceiling.
        now = time.monotonic()
        while self._idem:
            tok = next(iter(self._idem))
            exp, entry, _n = self._idem[tok]
            if exp < now and not isinstance(entry, asyncio.Future):
                self._idem_pop(tok)
            else:
                break
        # Hard ceilings (entries and bytes) regardless of expiry — but
        # never evict an IN-FLIGHT future: a same-token retry racing the
        # evicted original would re-execute the mutating handler
        # concurrently, the exact double-apply this cache prevents.
        if (len(self._idem) > self.IDEM_CACHE_MAX
                or self._idem_bytes > self.IDEM_CACHE_MAX_BYTES):
            for tok in list(self._idem):
                if (len(self._idem) <= self.IDEM_CACHE_MAX
                        and self._idem_bytes <= self.IDEM_CACHE_MAX_BYTES):
                    break
                if not isinstance(self._idem[tok][1], asyncio.Future):
                    self._idem_pop(tok)

    async def _dispatch(self, writer, req_id, method, kwargs):
        m = rpc_metrics()
        t0 = time.monotonic() if m is not None else 0.0
        inj = chaos.injector()
        token = kwargs.pop("_idem", None)
        cached = False
        inflight = None
        if token is not None:
            hit = self._idem.get(token)
            if hit is not None:
                entry = hit[1]
                if isinstance(entry, asyncio.Future):
                    # original execution still in flight (its reply was
                    # lost): piggyback on it — the handler runs ONCE
                    ok, result = await asyncio.shield(entry)
                else:
                    ok, result = entry
                cached = True
        if not cached:
            if (inj is not None and req_id >= 0
                    and inj.should("fail_before", method)):
                # fail-before-commit: the handler never ran; blind retry
                # is safe, so no dedup entry is recorded
                ok = False
                result = (ChaosFault(f"chaos: {method} failed before "
                                     "execution"), "")
            else:
                if token is not None:
                    inflight = asyncio.get_event_loop().create_future()
                    self._idem_store(token, inflight, 256)
                    self._prune_idem()
                try:
                    fn = getattr(self.handler, "handle_" + method)
                    if getattr(fn, "rpc_pass_writer", False):
                        # Handler streams interim server->client pushes on
                        # this connection (req_id -1 frames; the client
                        # routes them to its on_push handler) before the
                        # final reply.
                        kwargs["_writer"] = writer
                    if self.busy_cb is not None:
                        acc = [0.0]
                        try:
                            result = await _BusyTimed(fn(**kwargs), acc)
                        finally:
                            try:
                                self.busy_cb(method, acc[0])
                            except Exception:
                                pass
                    else:
                        result = await fn(**kwargs)
                    ok = True
                except BaseException as e:  # noqa: BLE001 — errors travel back
                    result = (e, traceback.format_exc())
                    ok = False
                    if m is not None:
                        m.errors.inc(tags={"method": method,
                                           "kind": type(e).__name__,
                                           "role": "server"})
                if inflight is not None:
                    if not ok and isinstance(result[0], TransientServerError):
                        # drop-from-cache semantics: waiters piggybacked on
                        # THIS execution see the error once, but a later
                        # same-token retry re-executes instead of
                        # replaying a stale transient failure
                        self._idem_pop(token)
                    else:
                        # the COMMITTED outcome — recorded before any
                        # chaos mangles the reply, so a retry observes it
                        self._idem_store(token, (ok, result),
                                         self._approx_result_bytes(result))
                    inflight.set_result((ok, result))
                if (inj is not None and ok and req_id >= 0
                        and inj.should("fail_after", method)):
                    # fail-after-commit: state changed, reply replaced by
                    # an error — only an idempotent retry survives this
                    ok = False
                    result = (ChaosFault(f"chaos: {method} failed after "
                                         "execution"), "")
        if m is not None:
            m.server_seconds.observe_key(m.method_keys(method)[0],
                                         time.monotonic() - t0)
        if req_id >= 0:
            if (inj is not None and not cached
                    and inj.should("drop_reply", method)):
                # a lost reply on a live TCP stream == the link dying:
                # abort so the client fails fast and retries
                try:
                    writer.transport.abort()
                except Exception:
                    pass
                return
            try:
                try:
                    # hint=req_id lets the client land this reply's
                    # out-of-band buffer into a pre-registered sink
                    n = coalesced_write_frame(writer, (req_id, ok, result),
                                              hint=req_id)
                except (ConnectionResetError, BrokenPipeError):
                    return
                except Exception:
                    # Unpicklable result/exception: degrade to a picklable
                    # error so the caller fails fast instead of timing out.
                    err = RuntimeError(
                        f"handler {method!r} produced an unpicklable "
                        f"{'result' if ok else 'exception'}: {result!r:.500}")
                    n = coalesced_write_frame(writer, (req_id, False, (err, "")))
                if m is not None:
                    m.bytes_sent.inc_key(m.method_keys(method)[2], n)
                await drain_if_needed(writer)
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def stop(self):
        # Close live connections BEFORE wait_closed: since 3.12 wait_closed
        # blocks until every connection handler returns, and long-poll
        # clients (pubsub, heartbeats) would keep theirs open forever.
        if self._server:
            self._server.close()
        for w in list(self._conns):
            try:
                w.close()
            except Exception:
                pass
        if self._server:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5)
            except Exception:
                pass

    def stop_sync(self):
        try:
            run_async(self.stop(), timeout=5)
        except Exception:
            pass


class RpcClient:
    """Persistent connection to one RpcServer; safe to share across coroutines.

    ``lane`` pins this client's connection, read loop, and frame codecs to
    a specific IO-loop thread (``get_loop(lane)``).  Lane-0 clients (the
    default) keep the historical behavior — their coroutines run on
    whatever loop awaits them.  Laned clients trampoline foreign-loop
    callers onto their home lane (``run_coroutine_threadsafe``), so the
    per-frame pickle/unpickle and socket syscalls of different connections
    land on different OS threads — the owner submission-lane substrate."""

    #: socket tuning applied to BULK (transfer-stripe) connections: big
    #: kernel buffers (caps, not committed memory) let an 8 MB reply
    #: frame move with far fewer partial sends, and a larger per-wakeup
    #: read size cuts the receiver's syscall + loop-iteration count per
    #: chunk.  Only dedicated transfer connections get this — on a
    #: control-plane connection a multi-MB recv allocation per 100-byte
    #: frame would be pure waste.
    BULK_SOCK_BUF = 8 << 20
    BULK_READ_SIZE = 2 << 20

    def __init__(self, address: str, lane: Any = 0, bulk: bool = False):
        self.address = address
        self._lane = lane
        self._bulk = bulk
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        # Pending futures are PER CONNECTION: each connection gets a fresh
        # dict whose read loop is the only popper, and whose teardown fails
        # exactly the futures that rode that connection.  A process-wide
        # dict had a race: _read_loop's finally cleared it while a
        # call_start parked at an await (chaos delay) could still insert —
        # that call then hung to its full timeout instead of failing fast.
        self._pending: Dict[int, asyncio.Future] = {}
        #: req_id -> _OobSink, per connection like _pending: registered
        #: destination views for replies' out-of-band buffers (call_into)
        self._sinks: Dict[int, _OobSink] = {}
        self._req_ids = itertools.count(1)
        self._connect_lock: asyncio.Lock | None = None
        self._closed = False
        self._connected_once = False
        self._push_handler: Callable[[str, dict], None] | None = None

    def on_push(self, fn: Callable[[str, dict], None]):
        """Register a callback for server-initiated one-way messages.
        On a laned client the callback fires on the LANE's loop thread —
        handlers that touch loop-0-confined state must hop themselves."""
        self._push_handler = fn

    def _foreign_home(self) -> Optional[asyncio.AbstractEventLoop]:
        """The home-lane loop when the caller is on a different loop (or
        no loop); None for lane-0 clients and on-lane callers — the
        zero-overhead common case is one int compare."""
        if self._lane == 0:
            return None
        home = get_loop(self._lane)
        try:
            if asyncio.get_running_loop() is home:
                return None
        except RuntimeError:
            pass
        return home

    async def ensure_connected(self):
        """Public connect (lane-aware): laned clients connect on their
        home lane so the connection's read loop lives there."""
        home = self._foreign_home()
        if home is not None:
            return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                self._ensure_connected(), home))
        return await self._ensure_connected()

    async def _ensure_connected(self):
        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            cfg = get_config()
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self._host, self._port,
                                        limit=16 << 20),
                timeout=cfg.rpc_connect_timeout_s)
            if self._bulk:
                try:
                    import socket as _socket
                    sock = self._writer.get_extra_info("socket")
                    if sock is not None:
                        sock.setsockopt(_socket.SOL_SOCKET,
                                        _socket.SO_SNDBUF,
                                        self.BULK_SOCK_BUF)
                        sock.setsockopt(_socket.SOL_SOCKET,
                                        _socket.SO_RCVBUF,
                                        self.BULK_SOCK_BUF)
                    self._writer.transport.max_size = self.BULK_READ_SIZE
                except Exception:
                    pass
            self._pending = {}
            self._sinks = {}
            if self._connected_once:
                m = rpc_metrics()
                if m is not None:
                    m.reconnects.inc()
            self._connected_once = True
            asyncio.ensure_future(
                self._read_loop(self._reader, self._writer, self._pending,
                                self._sinks))

    async def _read_loop(self, reader, writer, pending, sinks):
        try:
            while True:
                msg, nbytes = await _read_msg(reader, sinks)
                req_id, ok, payload = msg
                if req_id < 0:  # server push
                    if self._push_handler:
                        try:
                            self._push_handler(ok, payload)  # ok field carries topic
                        except Exception:
                            traceback.print_exc()
                    continue
                fut = pending.pop(req_id, None)
                if fut is not None:
                    m = rpc_metrics()
                    if m is not None:
                        method = getattr(fut, "_raytpu_method", "?")
                        m.bytes_received.inc_key(m.method_keys(method)[1],
                                                 nbytes)
                    if not fut.done():
                        if ok:
                            fut.set_result(payload)
                        else:
                            cause, tb = payload
                            fut.set_exception(RemoteError(cause, tb))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        finally:
            # Tear down only THIS connection's state: a reconnect may
            # already have installed a fresh writer/pending pair.
            if self._writer is writer:
                self._writer = None
            try:
                writer.close()
            except Exception:
                pass
            err = ConnectionLost(f"connection to {self.address} lost")
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(err)
            pending.clear()
            # never-consumed sinks can't be written anymore: release any
            # call_into cleanup parked on them
            for entry in sinks.values():
                entry.done.set()
            sinks.clear()

    def _chaos_pre(self, method: str):
        """Client-side chaos consultation for one outbound frame:
        -> (injector, added delay).  Raises ConnectionLost on partition."""
        inj = chaos.injector()
        d = 0.0
        if inj is not None:
            if inj.should("partition", method, self.address):
                raise ConnectionLost(
                    f"chaos: link to {self.address} partitioned")
            d = inj.delay_s(method, self.address)
        return inj, d

    def _chaos_drop_frame(self, writer):
        """A chaos-dropped frame on a live TCP stream is indistinguishable
        from the link dying: abort the connection so every pending call on
        it fails fast with ConnectionLost instead of hanging to timeout."""
        try:
            writer.transport.abort()
        except Exception:
            try:
                writer.close()
            except Exception:
                pass

    async def call_start(self, method: str, _oob_sink=None,
                         **kwargs) -> "asyncio.Future":
        """Issue the request and return its response future without awaiting it.
        Successive call_start invocations hit the server in program order —
        used for actor-call sequencing (reference: per-handle sequence numbers
        in CoreWorkerDirectActorTaskSubmitter).

        ``_oob_sink`` (a writable memoryview) registers a destination for
        the reply's first out-of-band buffer: the read loop lands it there
        readinto-style (see call_into), and the reply object pickle returns
        is a view over that memory."""
        if self._closed:
            raise RpcError("client closed")
        if self._foreign_home() is not None:
            # call_start hands back a future bound to ONE loop; awaiting
            # it from another loop is undefined — laned clients must be
            # driven via call/call_retry/notify from foreign loops.
            raise RuntimeError(
                "call_start on a laned RpcClient from a foreign loop "
                "(use call/call_retry, which trampoline)")
        inj, delay = self._chaos_pre(method)
        await self._ensure_connected()
        writer, pending, sinks = self._writer, self._pending, self._sinks
        if delay > 0.0:
            await asyncio.sleep(delay)
            # the connection may have died (or been replaced) during the
            # sleep — fail fast rather than enqueueing on a dead link
            if self._writer is not writer or writer is None \
                    or writer.is_closing():
                raise ConnectionLost(
                    f"connection to {self.address} lost before send")
        req_id = next(self._req_ids)
        fut = asyncio.get_event_loop().create_future()
        pending[req_id] = fut
        if _oob_sink is not None:
            entry = _OobSink(_oob_sink)
            sinks[req_id] = entry
            fut._raytpu_sink = (sinks, req_id, entry, writer)
        if inj is not None and inj.should("drop_request", method,
                                          self.address):
            nbytes = 0
        else:
            nbytes = coalesced_write_frame(writer, (req_id, method, kwargs))
        m = rpc_metrics()
        if m is not None:
            keys = m.method_keys(method)
            fut._raytpu_method = method
            m.bytes_sent.inc_key(keys[1], nbytes)
            m.client_inflight_n += 1
            t0 = time.monotonic()

            def _done(f, _m=m, _method=method, _lat_key=keys[0], _t0=t0):
                _m.client_inflight_n -= 1
                _m.client_seconds.observe_key(_lat_key,
                                              time.monotonic() - _t0)
                if f.cancelled():
                    kind = "cancelled"  # usually the caller's timeout
                else:
                    exc = f.exception()  # retrieves it: no GC-time warning
                    kind = type(exc).__name__ if exc is not None else None
                if kind:
                    _m.errors.inc(tags={"method": _method, "kind": kind,
                                        "role": "client"})

            fut.add_done_callback(_done)
        if nbytes == 0:
            # dropped frame: kill the link so this (and every pending)
            # call surfaces ConnectionLost promptly
            self._chaos_drop_frame(writer)
            return fut
        await drain_if_needed(writer)
        return fut

    async def call(self, method: str, _timeout: float | None = None, **kwargs) -> Any:
        home = self._foreign_home()
        if home is not None:
            return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                self.call(method, _timeout=_timeout, **kwargs), home))
        fut = await self.call_start(method, **kwargs)
        timeout = _timeout if _timeout is not None else get_config().rpc_call_timeout_s
        return await asyncio.wait_for(fut, timeout)

    async def call_into(self, method: str, sink: memoryview,
                        _timeout: float | None = None, **kwargs) -> Any:
        """``call`` whose reply's out-of-band buffer lands DIRECTLY into
        ``sink`` (zero-extra-copy receive: stream buffer -> sink, no
        intermediate bytes, no slice-assign).  The returned value for an
        out-of-band reply is a (readonly) memoryview over ``sink``; small
        in-band replies still return bytes the caller must place itself.

        The finally block guarantees that once this coroutine returns — by
        result, error, timeout or cancellation — NO late frame can write
        into ``sink``: the registration is withdrawn, or a landing already
        in progress is awaited to completion.  Callers may recycle the
        memory behind ``sink`` immediately after."""
        fut = await self.call_start(method, _oob_sink=sink, **kwargs)
        timeout = (_timeout if _timeout is not None
                   else get_config().rpc_call_timeout_s)
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            info = getattr(fut, "_raytpu_sink", None)
            if info is not None:
                sinks, req_id, entry, writer = info
                if sinks.get(req_id) is entry:
                    del sinks[req_id]  # read loop never took it: safe now
                elif entry.started and not entry.done.is_set():
                    # landing in progress on the read loop: wait it out so
                    # the caller can recycle the sink's memory
                    try:
                        await asyncio.wait_for(entry.done.wait(), 30.0)
                    except asyncio.TimeoutError:
                        # a landing wedged mid-stream for 30 s: kill the
                        # connection so the read loop aborts NOW — the
                        # no-late-write guarantee must hold even here
                        # (the caller may recycle an arena range next)
                        try:
                            writer.transport.abort()
                        except Exception:
                            pass
                        try:
                            await asyncio.wait_for(entry.done.wait(), 10.0)
                        except asyncio.TimeoutError:
                            pass

    async def call_retry(self, method: str, _timeout: float | None = None,
                         _attempts: int | None = None,
                         _idempotent: bool = True, **kwargs) -> Any:
        """Retrying call for transient transport faults (reference:
        retryable gRPC clients).  Bounded attempts with exponential backoff
        + full jitter, all under ONE shared deadline (`_timeout`, default
        ``rpc_call_timeout_s``) that propagates into each attempt's
        per-call timeout.

        With ``_idempotent=True`` (the default) a client-stamped
        idempotency token rides every attempt: the server's dedup window
        replays the committed reply for a retry instead of re-executing
        the handler, so retried MUTATING RPCs (register_actor, kv_put,
        lease grants/returns, pin grants) apply exactly once.  Pass
        ``_idempotent=False`` for read-only calls to skip the server-side
        cache entry (re-executing a read is free).

        Retries on: ConnectionLost / OSError (link died), TimeoutError
        with deadline remaining, and ChaosFault RemoteErrors (injected
        failures are retryable by definition).  Application errors
        propagate immediately."""
        home = self._foreign_home()
        if home is not None:
            # the whole retry loop (backoff sleeps included) runs on the
            # home lane; the caller just awaits its outcome
            return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                self.call_retry(method, _timeout=_timeout,
                                _attempts=_attempts,
                                _idempotent=_idempotent, **kwargs), home))
        cfg = get_config()
        attempts = (_attempts if _attempts is not None
                    else cfg.rpc_retry_max_attempts)
        total = _timeout if _timeout is not None else cfg.rpc_call_timeout_s
        deadline = time.monotonic() + total
        if _idempotent:
            kwargs["_idem"] = uuid.uuid4().hex
        last: Optional[BaseException] = None
        for attempt in range(max(1, attempts)):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                return await self.call(method, _timeout=remaining, **kwargs)
            except (ConnectionLost, ConnectionError, OSError,
                    asyncio.TimeoutError) as e:
                last = e
            except RemoteError as e:
                if not isinstance(e.cause, (ChaosFault, TransientServerError)):
                    raise
                last = e
            if self._closed or attempt >= attempts - 1:
                break  # no backoff after the FINAL attempt — nothing follows
            step = min(cfg.rpc_retry_max_delay_s,
                       cfg.rpc_retry_base_delay_s * (2 ** attempt))
            sleep = min(random.uniform(0, step),
                        max(0.0, deadline - time.monotonic()))
            if sleep > 0:
                await asyncio.sleep(sleep)
        if last is not None:
            raise last
        raise asyncio.TimeoutError(
            f"{method}: deadline exhausted before first attempt")

    async def notify(self, method: str, **kwargs):
        home = self._foreign_home()
        if home is not None:
            return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                self.notify(method, **kwargs), home))
        inj, delay = self._chaos_pre(method)
        await self._ensure_connected()
        writer = self._writer
        if delay > 0.0:
            await asyncio.sleep(delay)
            if self._writer is not writer or writer is None \
                    or writer.is_closing():
                raise ConnectionLost(
                    f"connection to {self.address} lost before send")
        if inj is not None and inj.should("drop_request", method,
                                          self.address):
            self._chaos_drop_frame(writer)
            return
        nbytes = coalesced_write_frame(writer, (-1, method, kwargs))
        m = rpc_metrics()
        if m is not None:
            m.bytes_sent.inc_key(m.method_keys(method)[1], nbytes)
        await drain_if_needed(writer)

    def call_sync(self, method: str, _timeout: float | None = None, **kwargs) -> Any:
        return run_async(self.call(method, _timeout=_timeout, **kwargs),
                         timeout=(_timeout or get_config().rpc_call_timeout_s) + 5)

    async def close(self):
        self._closed = True
        home = self._foreign_home()
        if home is not None:
            # flush + transport close must run on the loop that owns the
            # connection
            return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                self._close_local(), home))
        await self._close_local()

    async def _close_local(self):
        if self._writer:
            try:
                _flush_writer(self._writer)  # don't drop coalesced frames
                self._writer.close()
            except Exception:
                pass
            self._writer = None


class ClientPool:
    """Cache of RpcClients keyed by address (reference: rpc client pools).

    ``push_handler(topic, payload)``, when given, is installed on every
    client so server-initiated pushes (streamed task results) are routed.

    ``lanes > 1`` spreads addresses over that many IO-loop threads
    (sticky: an address keeps its lane for the pool's lifetime, so
    per-connection ordering — actor seq_nos, streamed yields — is
    unchanged; lane index 0 is the default loop, the rest are dedicated
    submission-lane threads).  Push handlers fire on the owning lane's
    thread — pass a thread-safe handler when lanes > 1."""

    def __init__(self, push_handler: Callable[[str, dict], None] | None = None,
                 lanes: int = 1):
        self._clients: Dict[str, RpcClient] = {}
        self._push_handler = push_handler
        self._num_lanes = max(1, int(lanes))
        self._lane_rr = 0
        self._lane_of: Dict[str, Any] = {}

    def _lane_for(self, address: str) -> Any:
        if self._num_lanes <= 1:
            return 0
        lane = self._lane_of.get(address)
        if lane is None:
            i = self._lane_rr % self._num_lanes
            self._lane_rr += 1
            lane = 0 if i == 0 else ("lane", i)
            self._lane_of[address] = lane
        return lane

    def get(self, address: str) -> RpcClient:
        c = self._clients.get(address)
        if c is None or c._closed:
            c = RpcClient(address, lane=self._lane_for(address))
            if self._push_handler is not None:
                c.on_push(self._push_handler)
            self._clients[address] = c
        return c

    def get_striped(self, address: str, stripe: int) -> RpcClient:
        """A PARALLEL connection to ``address``: stripe 0 is the pool's
        regular client, stripes >= 1 are extra sockets cached under a
        derived key (the bulk-transfer substrate: multi-MB reply frames
        to one peer stream over ``transfer_sockets_per_source``
        connections instead of serializing head-of-line on one).  Stripe
        assignment is the CALLER's — sticky per in-flight chunk — and a
        stripe keeps its connection (and its lane) for the pool's
        lifetime, so per-connection FIFO ordering still holds within a
        stripe."""
        if stripe <= 0:
            return self.get(address)
        key = f"{address}\x00stripe{stripe}"
        c = self._clients.get(key)
        if c is None or c._closed:
            c = RpcClient(address, lane=self._lane_for(key), bulk=True)
            if self._push_handler is not None:
                c.on_push(self._push_handler)
            self._clients[key] = c
        return c

    async def close(self, address: str):
        """Drop one connection — including its transfer stripes; their
        pending futures fail with ConnectionLost (used to force-surface a
        peer the caller KNOWS is dead without waiting on EOF delivery)."""
        c = self._clients.pop(address, None)
        if c is not None:
            await c.close()
        prefix = f"{address}\x00stripe"
        for key in [k for k in self._clients if k.startswith(prefix)]:
            sc = self._clients.pop(key, None)
            if sc is not None:
                await sc.close()

    async def close_all(self):
        for c in self._clients.values():
            await c.close()
        self._clients.clear()
