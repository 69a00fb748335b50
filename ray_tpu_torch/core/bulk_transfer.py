"""Bulk transfer channel: threaded blocking-socket chunk movement.

The asyncio RPC path tops out far below the wire on chunked pulls: every
payload byte funnels through ONE event-loop thread per process and is
copied twice in user space on the way (transport read -> StreamReader
buffer -> sink; measured ~0.4 GB/s per agent, flat no matter how many
sockets).  This module is the data plane's side channel — the same split
the reference runs (``object_manager.cc`` drives its chunk reads/writes
on ``rpc_service_`` THREADS, not the raylet's main loop):

* Each node agent runs a :class:`BulkServer`: a listening socket whose
  per-connection handler THREADS serve ``read_chunk`` requests with
  ``sendall(memoryview-over-shm)`` — one kernel crossing, zero user-space
  copies, GIL released for the whole send.  Entry/proxy records are
  PINNED around the send (marshalled onto the agent loop), so eviction
  and owner frees defer exactly like they do for zero-copy readers.
* The puller side (:class:`BulkPool`) keeps ``transfer_sockets_per_source``
  persistent blocking sockets per source and lands each chunk with
  ``recv_into`` STRAIGHT into the destination shm segment from an
  executor thread — kernel -> arena, no intermediate buffer, GIL
  released, landings from different sources running on different cores.

Protocol (one in-flight request per socket, strictly sequential):

    request:  MAGIC(2s) | flags(u8, bit0 = crc) | oid_len(u8) | oid |
              offset(u64) | length(u64)
    reply:    status(u8) | crc(u32) | algo_len(u8) | algo | nbytes(u64) |
              payload
    status:   0 = ok, 1 = range not available (typed ChunkNotAvailable),
              2 = error (utf-8 message as payload)

Fault injection parity: the client consults the chaos injector for the
``read_chunk`` method (delay / drop_request / drop_reply / partition), so
seeded chaos schedules exercise this channel exactly like the RPC one.
The asyncio ``read_chunk`` RPC remains the fallback (unknown bulk port,
``transfer_sockets_per_source=1`` — the A/B off arm) and the only path
for agent-less drivers.
"""

from __future__ import annotations

import asyncio
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from . import chaos
from .ids import ObjectID
from .object_store import ChunkNotAvailable

MAGIC = b"rB"
_REQ_FIX = struct.Struct("!2sBB")       # magic, flags, oid_len
_REQ_RANGE = struct.Struct("!QQ")       # offset, length
_REP_FIX = struct.Struct("!BIB")        # status, crc, algo_len

#: socket buffer caps (not committed memory) for the bulk sockets
SOCK_BUF = 8 << 20
#: recv_into slice cap per syscall (bounds per-call latency without
#: bounding throughput)
RECV_SLICE = 4 << 20

ST_OK, ST_NOT_AVAILABLE, ST_ERROR = 0, 1, 2


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    pos, n = 0, view.nbytes
    while pos < n:
        got = sock.recv_into(view[pos:pos + min(RECV_SLICE, n - pos)])
        if got == 0:
            raise ConnectionError("bulk peer closed mid-reply")
        pos += got


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


# ------------------------------------------------------------------ server

class BulkServer:
    """Per-agent threaded chunk server.

    ``acquire``/``release`` are coroutines the OWNING AGENT provides;
    they run on the agent's event loop (the store is loop-confined) and
    bracket serving with a pin, so the view a serving thread is pushing
    into the kernel can never have its arena range recycled under it.
    ``acquire(oid, off, n) -> (view, kind, full)``: with ``full`` the
    view spans the WHOLE sealed object and the connection CACHES the
    pinned grant — subsequent chunks of the same object slice it without
    another loop round trip (the per-chunk marshal was the serving
    ceiling: two cross-thread hops per 2 MB chunk put the agent loop
    back in the middle of every byte).  Partial holders return
    ``full=False`` per-chunk grants.  Cached grants age out after
    :data:`GRANT_TTL_S` (bounding how long a deferred free can stay
    servable) and are released on idle/replacement/close."""

    #: cached full-object grant lifetime; re-acquired after (bounds the
    #: window in which a freed-deferred object could still be served)
    GRANT_TTL_S = 5.0
    #: per-connection grant cache size (a pull streams one object; a few
    #: interleaved objects per stripe is already unusual)
    GRANT_CACHE_MAX = 4

    def __init__(self, acquire, release, loop: asyncio.AbstractEventLoop,
                 host: str = "127.0.0.1", on_sent=None):
        self._acquire = acquire
        self._release = release
        self._loop = loop
        #: optional per-send accounting hook ``(nbytes) -> None``, called
        #: from serving threads (must be thread-safe)
        self._on_sent = on_sent
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._closed = False
        self._conns: set = set()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="bulk-accept", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _peer = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, SOCK_BUF)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="bulk-serve", daemon=True).start()

    def _release_grant(self, oid: ObjectID, kind):
        try:
            asyncio.run_coroutine_threadsafe(self._release(oid, kind),
                                             self._loop)
        except RuntimeError:
            pass  # loop already closed (agent shutdown)

    def _serve(self, conn: socket.socket):
        grants: dict = {}   # oid -> (full_view, kind, t_acquired)
        conn.settimeout(10.0)
        try:
            while not self._closed:
                try:
                    fix = _recv_exact(conn, _REQ_FIX.size)
                except socket.timeout:
                    # idle: drop cached grants so pins don't outlive use
                    for o, (_v, kind, _t) in grants.items():
                        self._release_grant(o, kind)
                    grants.clear()
                    continue
                except (ConnectionError, OSError):
                    return
                magic, flags, oid_len = _REQ_FIX.unpack(fix)
                if magic != MAGIC:
                    return  # not our protocol: drop the connection
                oid = ObjectID(_recv_exact(conn, oid_len))
                off, length = _REQ_RANGE.unpack(
                    _recv_exact(conn, _REQ_RANGE.size))
                self._serve_one(conn, grants, oid, off, length,
                                bool(flags & 1))
        except (ConnectionError, OSError):
            pass
        finally:
            for o, (_v, kind, _t) in grants.items():
                self._release_grant(o, kind)
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _grant_for(self, grants: dict, oid: ObjectID, off: int,
                   length: int):
        """-> (view_of_chunk, release_kind | None).  A None kind means
        the grant is cached — no release after this send."""
        hit = grants.get(oid)
        if hit is not None:
            view, kind, t0 = hit
            if time.monotonic() - t0 <= self.GRANT_TTL_S:
                if off + length <= view.nbytes:
                    return view[off:off + length], None
            del grants[oid]
            self._release_grant(oid, kind)
        view, kind, full = asyncio.run_coroutine_threadsafe(
            self._acquire(oid, off, length), self._loop).result(30.0)
        if not full:
            return view, kind
        while len(grants) >= self.GRANT_CACHE_MAX:
            old_oid, (_v, old_kind, _t) = next(iter(grants.items()))
            del grants[old_oid]
            self._release_grant(old_oid, old_kind)
        grants[oid] = (view, kind, time.monotonic())
        if off + length > view.nbytes:
            raise ChunkNotAvailable(
                f"[{off}, {off + length}) outside object of "
                f"{view.nbytes} B")
        return view[off:off + length], None

    def _serve_one(self, conn, grants: dict, oid: ObjectID, off: int,
                   length: int, with_crc: bool):
        """Serve one chunk: pinned view granted on the agent loop (cached
        per connection for sealed objects), sendall from this thread
        (GIL released)."""
        kind = None
        try:
            view, kind = self._grant_for(grants, oid, off, length)
        except ChunkNotAvailable:
            conn.sendall(_REP_FIX.pack(ST_NOT_AVAILABLE, 0, 0)
                         + struct.pack("!Q", 0))
            return
        except Exception as e:  # noqa: BLE001 — typed error reply
            msg = f"{type(e).__name__}: {e}".encode()[:4096]
            conn.sendall(_REP_FIX.pack(ST_ERROR, 0, 0)
                         + struct.pack("!Q", len(msg)) + msg)
            return
        try:
            crc, algo = 0, b""
            if with_crc:
                from .transfer import chunk_checksum
                crc_v, algo_s = chunk_checksum(view)
                crc, algo = crc_v & 0xFFFFFFFF, algo_s.encode()
            header = (_REP_FIX.pack(ST_OK, crc, len(algo)) + algo
                      + struct.pack("!Q", view.nbytes))
            conn.sendall(header)
            conn.sendall(view)  # memoryview straight over the pinned shm
            if self._on_sent is not None:
                try:
                    self._on_sent(view.nbytes)
                except Exception:
                    pass
        finally:
            if kind is not None:
                self._release_grant(oid, kind)

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass


# ------------------------------------------------------------------ client

class BulkPool:
    """Per-process cache of blocking bulk sockets, keyed by
    ``(bulk address, stripe)`` — one lock per socket (the protocol is
    strictly sequential per connection), stripes giving a source
    ``transfer_sockets_per_source`` parallel streams.

    ``fetch`` BLOCKS (run it in an executor thread): it sends one
    request and lands the reply with ``recv_into`` straight into the
    caller's sink view — both directions release the GIL, so concurrent
    fetches from different sources run on different cores."""

    def __init__(self):
        self._socks: Dict[Tuple[str, int], Tuple[socket.socket,
                                                 threading.Lock]] = {}
        self._map_lock = threading.Lock()

    def _get(self, bulk_addr: str, stripe: int, timeout: float):
        key = (bulk_addr, stripe)
        with self._map_lock:
            ent = self._socks.get(key)
            if ent is None:
                ent = (None, threading.Lock())
                self._socks[key] = ent
        sock, lock = ent
        if sock is not None:
            return sock, lock
        with lock:  # serialize the connect per key
            with self._map_lock:
                cur = self._socks.get(key)
            if cur is not None and cur[0] is not None:
                return cur
            host, port = bulk_addr.rsplit(":", 1)
            sock = socket.create_connection(
                (host, int(port)), timeout=min(10.0, timeout))
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, SOCK_BUF)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._map_lock:
                self._socks[key] = (sock, lock)
            return sock, lock

    def drop_stripe(self, bulk_addr: str, stripe: int):
        """Kill ONE stripe's socket — an in-flight landing on it fails
        within a syscall; other stripes to the same address are
        untouched."""
        with self._map_lock:
            ent = self._socks.pop((bulk_addr, stripe), None)
        if ent and ent[0] is not None:
            try:
                ent[0].close()
            except OSError:
                pass

    def drop_addr(self, bulk_addr: str):
        """Kill every stripe to one address — forces any in-flight
        landing on it to fail fast (the no-late-write teardown path)."""
        with self._map_lock:
            keys = [k for k in self._socks if k[0] == bulk_addr]
        for key in keys:
            self.drop_stripe(*key)

    def fetch(self, rpc_addr: str, bulk_addr: str, stripe: int,
              oid: ObjectID, off: int, length: int, sink: memoryview,
              with_crc: bool, timeout: float) -> int:
        """Land ``[off, off+length)`` of ``oid`` into ``sink``; returns
        bytes landed.  ``rpc_addr`` is the source's RPC address — the
        chaos injector keys links by it, so seeded fault schedules hit
        this channel exactly like the RPC one."""
        inj = chaos.injector()
        if inj is not None:
            if inj.should("partition", "read_chunk", rpc_addr):
                raise ConnectionError(
                    f"chaos: link to {rpc_addr} partitioned")
            d = inj.delay_s("read_chunk", rpc_addr)
            if d > 0:
                time.sleep(d)
            if inj.should("drop_request", "read_chunk", rpc_addr):
                self.drop_stripe(bulk_addr, stripe)
                raise ConnectionError("chaos: bulk request dropped")
        sock, lock = self._get(bulk_addr, stripe, timeout)
        oid_b = oid.binary()
        req = (_REQ_FIX.pack(MAGIC, 1 if with_crc else 0, len(oid_b))
               + oid_b + _REQ_RANGE.pack(off, length))
        with lock:
            sock.settimeout(timeout)
            try:
                sock.sendall(req)
                fix = _recv_exact(sock, _REP_FIX.size)
                status, crc, algo_len = _REP_FIX.unpack(fix)
                algo = _recv_exact(sock, algo_len).decode() if algo_len \
                    else ""
                (nbytes,) = struct.unpack("!Q", _recv_exact(sock, 8))
                if status == ST_NOT_AVAILABLE:
                    raise ChunkNotAvailable(
                        f"{rpc_addr}: [{off}, {off + length}) not held")
                if status != ST_OK:
                    msg = _recv_exact(sock, nbytes).decode(
                        errors="replace") if nbytes else "bulk error"
                    raise RuntimeError(f"bulk read_chunk at {rpc_addr}: "
                                       f"{msg}")
                if nbytes > sink.nbytes:
                    raise ConnectionError(
                        f"bulk reply {nbytes} B exceeds sink "
                        f"{sink.nbytes} B")
                if with_crc:
                    # verify-then-copy through a scratch buffer: a
                    # work-steal straggler must never overwrite a DONE
                    # chunk's bytes with an unverified reply
                    scratch = bytearray(nbytes)
                    _recv_exact_into(sock, memoryview(scratch))
                    from .transfer import ChunkCrcError, chunk_checksum
                    got, got_algo = chunk_checksum(scratch)
                    if algo and got_algo == algo \
                            and (got & 0xFFFFFFFF) != crc:
                        raise ChunkCrcError(
                            f"bulk chunk [{off}, {off + nbytes}) from "
                            f"{rpc_addr}: checksum mismatch")
                    sink[:nbytes] = scratch
                else:
                    _recv_exact_into(sock, sink[:nbytes])
                if inj is not None and inj.should("drop_reply",
                                                  "read_chunk", rpc_addr):
                    # the bytes landed, but the caller must observe a
                    # dead link (reply "lost"): drop the socket and fail
                    self.drop_stripe(bulk_addr, stripe)
                    raise ConnectionError("chaos: bulk reply dropped")
                return nbytes
            except (socket.timeout, TimeoutError) as e:
                # a timed-out socket is mid-stream garbage: drop it
                self.drop_stripe(bulk_addr, stripe)
                raise asyncio.TimeoutError(
                    f"bulk read_chunk to {rpc_addr} timed out") from e
            except (ConnectionError, OSError):
                self.drop_stripe(bulk_addr, stripe)
                raise

    def close(self):
        with self._map_lock:
            socks = list(self._socks.values())
            self._socks.clear()
        for sock, _lock in socks:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
