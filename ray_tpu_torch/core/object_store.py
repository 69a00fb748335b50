"""Object storage: per-process memory store + per-node shared-memory (plasma-equivalent) store.

Two tiers, like the reference:

* **MemoryStore** — in-process store for small objects and for location records of large
  ones (reference: ``src/ray/core_worker/store_provider/memory_store/memory_store.h:43``).
  Values <= ``max_direct_call_object_size`` live here in full and travel inline in RPC
  replies; larger objects are represented by a :class:`PlasmaRecord` pointing at the node
  that holds the primary copy.

* **NodeObjectStore** — per-node shared-memory store (reference: plasma,
  ``src/ray/object_manager/plasma/store.h:55``).  Implemented as mmap'd files under
  ``/dev/shm`` (one per object — the same mmap+fd design plasma uses, minus the custom
  dlmalloc arena; an arena allocator is a planned C++ upgrade).  Any process on the node
  attaches segments by path for zero-copy reads.  Create/seal/get/free run inside the node
  agent; eviction is LRU over sealed, unpinned objects with optional spill-to-disk
  (reference: ``src/ray/raylet/local_object_manager.h:41``).
"""

from __future__ import annotations

import asyncio
import json
import mmap
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from . import external_spill, object_explain
from .config import get_config
from .external_spill import (KEY_TIER_EXTERNAL, KEY_TIER_LOCAL,
                             spill_metrics)
from .ids import ObjectID
from .object_explain import KEY_RESTORE, KEY_SPILL, ObjectEvent

_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()

class ObjectStoreFullError(Exception):
    pass


class ChunkNotAvailable(Exception):
    """``read_chunk`` hit a range an in-progress (partial) holder has not
    landed yet — the puller should re-stripe the chunk onto another source
    and re-probe this one's advertised ranges, NOT treat the holder as
    dead.  Travels across the RPC boundary as a RemoteError cause."""


# -- sealed-range bookkeeping (partial-object serving) ----------------------

def range_add(ranges: list, start: int, end: int) -> list:
    """Fold [start, end) into a sorted, merged list of [start, end) pairs."""
    out = []
    placed = False
    for s, e in ranges:
        if e < start or s > end:
            if not placed and s > end:
                out.append([start, end])
                placed = True
            out.append([s, e])
        else:
            start, end = min(s, start), max(e, end)
    if not placed:
        out.append([start, end])
    out.sort()
    return out


def range_covers(ranges: list, start: int, end: int) -> bool:
    """True iff [start, end) lies inside one merged range."""
    for s, e in ranges:
        if s <= start and end <= e:
            return True
    return False


# ---------------------------------------------------------------------------
# Shared-memory segments
# ---------------------------------------------------------------------------

class _PoolAttachCache:
    """Per-process cache of mmaps of whole pool files.  A pool slice path is
    ``{pool_path}#{offset}``; every attacher maps the pool once and indexes
    by offset (the plasma client pattern: one fd per store, not per object)."""

    def __init__(self):
        self._maps: Dict[str, mmap.mmap] = {}

    def view(self, pool_path: str, offset: int, size: int,
             populate_write: bool = False) -> memoryview:
        mm = self._maps.get(pool_path)
        if mm is None:
            fd = os.open(pool_path, os.O_RDWR)
            try:
                mm = mmap.mmap(fd, os.path.getsize(pool_path))
            finally:
                os.close(fd)
            self._maps[pool_path] = mm
        if populate_write and size >= (1 << 20) and \
                hasattr(mmap, "MADV_POPULATE_WRITE"):
            # Writers: establish writable PTEs for the slice in one syscall
            # instead of ~size/4K minor faults during the memcpy (pages are
            # already resident from the store's startup prefault).
            page = mmap.PAGESIZE
            start = (offset // page) * page
            length = offset + size - start
            try:
                mm.madvise(mmap.MADV_POPULATE_WRITE, start, length)
            except (OSError, ValueError):
                pass
        return memoryview(mm)[offset:offset + size]


_pool_attach = _PoolAttachCache()


class ShmSegment:
    """One mmap'd file; create-mode unlinks on free, attach-mode is read-only.

    Attach-mode also understands pool-slice paths (``pool#offset``), mapping
    the whole pool once per process via ``_pool_attach``."""

    def __init__(self, path: str, size: int, create: bool):
        self.path = path
        self.size = size
        self.created = create
        self.mm = None
        self._slice: Optional[memoryview] = None
        if "#" in path and not create:
            pool_path, off = path.rsplit("#", 1)
            # Attach-for-write is the writer's path (puts / task returns):
            # pre-populate the slice's PTEs so the copy runs at memcpy speed.
            self._slice = _pool_attach.view(pool_path, int(off), size,
                                            populate_write=True)
            return
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)

    def view(self) -> memoryview:
        if self._slice is not None:
            return self._slice
        return memoryview(self.mm)

    def close(self):
        if self.mm is None:
            return  # pool slice: the attach cache owns the pool mapping
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass  # outstanding zero-copy views keep the map alive until GC

    def unlink(self):
        if self.mm is None:
            return  # pool slice: only the owner's allocator frees the range
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


class PoolSlice:
    """Owner-side segment living inside the node's arena: close() is a no-op
    (the pool owns the mapping); unlink() returns the range to the
    allocator."""

    __slots__ = ("pool", "offset", "size")

    def __init__(self, pool, offset: int, size: int):
        self.pool = pool
        self.offset = offset
        self.size = size

    @property
    def path(self) -> str:
        return f"{self.pool.path}#{self.offset}"

    def view(self) -> memoryview:
        return self.pool.view(self.offset, self.size)

    def close(self):
        pass

    def unlink(self):
        self.pool.free(self.offset)


def shm_path_for(store_name: str, object_id: ObjectID) -> str:
    return os.path.join(_SHM_DIR, f"raytpu-{store_name}-{object_id.hex()}")


# ---------------------------------------------------------------------------
# Node-level store (runs inside the node agent)
# ---------------------------------------------------------------------------

@dataclass
class _Entry:
    segment: ShmSegment
    size: int
    #: bytes actually ALLOCATED in the arena (>= size: a reserve-then-
    #: write put may seal-truncate ``size`` to the exact encoding, but
    #: the allocator range — and this store's ``used`` accounting —
    #: stays the reservation until free)
    alloc: int = 0
    sealed: bool = False
    pinned: int = 0          # pin count: live reader views + peer transfers
    freed: bool = False      # owner freed it while pins were live (deferred)
    last_access: float = field(default_factory=time.monotonic)
    #: the owning CoreWorker's address (piggybacked on store_create): lets
    #: the spill/drain paths register an external copy back with the owner
    #: as a non-node location (None for legacy/ownerless writes)
    owner: Optional[str] = None
    #: sealed [start, end) byte ranges of an UNSEALED entry being pulled —
    #: the chunk ledger publishes each landed chunk here so ``read_chunk``
    #: can serve it to later pullers before the whole object seals
    #: (partial-object serving; None once sealed / for plain writers).
    avail: Optional[list] = None


@dataclass
class _ProxyEntry:
    """Zero-copy reference to a SAME-HOST peer store's sealed object.

    Plasma's same-node sharing, extended across node agents that share one
    /dev/shm: instead of copying the bytes through a socket, this node serves
    the SOURCE store's pool-slice path directly (workers attach it with the
    same ``_pool_attach`` mmap cache) and the source holds a pin for us until
    we free.  An N-node same-host broadcast therefore moves zero bytes —
    every consumer reads the origin's pages through the shared page cache."""
    path: str
    size: int
    source_addr: str
    pinned: int = 0          # reader pins on the proxy itself
    freed: bool = False      # free deferred until the pins release


class NodeObjectStore:
    """Plasma-equivalent store; all methods are called on the agent's IO loop."""

    def __init__(self, name: str, capacity: int = 0):
        cfg = get_config()
        if capacity <= 0:
            capacity = cfg.object_store_memory
        if capacity <= 0:
            try:
                total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
            except (ValueError, OSError):
                total = 8 << 30
            capacity = int(total * 0.3)
        self.name = name
        self.capacity = capacity
        self.used = 0
        self._entries: Dict[ObjectID, _Entry] = {}
        # Same-host zero-copy references (see _ProxyEntry): not counted
        # against capacity — the bytes live in the source node's arena.
        self._proxies: Dict[ObjectID, _ProxyEntry] = {}
        # attach-mode cache for serving chunks of paths this store does
        # not own (proxy relaying; see _attach_view)
        self._attach_maps: Dict[str, ShmSegment] = {}
        self._sealed_events: Dict[ObjectID, asyncio.Event] = {}
        self.num_creates = 0
        self.num_evictions = 0
        # Spill-on-evict is ON by default (reference: raylet spills rather
        # than drop; local_object_manager.h:41) — an empty config value means
        # "pick a default dir", not "disable".  Set it to "off" to disable.
        # Files live under a PER-STORE subdirectory with a pid marker, so a
        # restarted node incarnation's orphan sweep (sweep_orphan_spill_dirs)
        # can delete a dead store's leftovers without touching live peers'.
        if cfg.object_spilling_dir == "off":
            self.spill_root = None
            self.spill_dir = None
        else:
            self.spill_root = cfg.object_spilling_dir or os.path.join(
                tempfile.gettempdir(), "raytpu", "spill")
            self.spill_dir = os.path.join(self.spill_root, self.name)
        # External durability tier (core/external_spill.py): spilled objects
        # go to a cluster-readable fsspec URI instead of node-local disk and
        # are registered with the owner as a non-node location — they
        # survive this node's preemption and restore through ANY node's
        # pull path.
        self.external_uri = cfg.object_spilling_external_uri or None
        #: oid -> external URI (recorded at spill-submit time; the write
        #: itself may still be in flight — see _ext_writes)
        self._spilled_external: Dict[ObjectID, str] = {}
        #: oid -> in-flight external write future: readers racing the
        #: write wait it out; frees racing it mark _ext_drop_after_write
        self._ext_writes: Dict[ObjectID, "object"] = {}
        self._ext_drop_after_write: set = set()
        #: oid -> monotonic deadline of a restore-failure backoff window:
        #: after the agent's off-loop restore fails, the SYNC fallback in
        #: _maybe_restore must not re-attempt the same network read on the
        #: event loop — the pull path covers instead
        self._ext_backoff: Dict[ObjectID, float] = {}
        self._ext_pool = None
        #: agent hook, called (object_id, uri, owner) off-loop once an
        #: external spill write LANDS — registers the URI with the owner
        self.on_external_spill = None
        #: flight-recorder hook, called (object_id, event, detail) on the
        #: store's lifecycle transitions (SEALED/SPILLED/RESTORED/FREED/
        #: FREE_DEFERRED) — the agent buffers these and flushes them to
        #: the GCS object-event ring.  Only fired when the object plane's
        #: kill switch is on; None outside an agent.
        self.on_object_event = None
        #: spill-tier size ledgers: byte sizes of this store's local-disk
        #: and external-tier copies (the entry record dies with the evict,
        #: so the tier totals `memory_summary` reports need their own
        #: bookkeeping).
        self._spilled_sizes: Dict[ObjectID, int] = {}
        self._ext_sizes: Dict[ObjectID, int] = {}
        # Native arena (C++ first-fit allocator over ONE shm mapping — the
        # plasma design): per-object create cost drops from
        # open+ftruncate+mmap+page-zero to an allocator call.  Falls back to
        # file-per-object when the native lib can't build.
        self.pool = None
        if cfg.object_store_use_native_pool:
            try:
                from ray_tpu_torch.native import ShmPool
                # The path doubles as the attach-cache key in every client
                # process, so it must be unique per store INSTANCE: a reused
                # path would hand cached stale mmaps of a dead session's
                # arena to long-lived clients.
                uniq = os.urandom(4).hex()
                self.pool = ShmPool(
                    os.path.join(_SHM_DIR, f"raytpu-pool-{name}-{uniq}"),
                    capacity)
            except Exception:
                self.pool = None
        # Arena prefault is LAZY: triggered by the first create(), so a
        # cluster that never touches plasma doesn't eagerly commit gigabytes
        # of tmpfs RAM (see _maybe_start_prefault).
        self._prefault_started = not (
            self.pool is not None and cfg.object_store_prefault
            and hasattr(mmap, "MADV_POPULATE_WRITE"))

    def _maybe_start_prefault(self):
        """Fault the arena's tmpfs pages in once, on first use (plasma
        pre-touches its arena the same way): steady-state creates then cost
        an allocator call, and writers copy into already-resident pages at
        memcpy speed instead of page-fault speed.  Runs in a background
        thread, CHUNKED: madvise holds the GIL for the syscall's duration,
        so one whole-arena call would freeze the agent loop (capacity
        defaults to 30% of RAM).  The low region is prefaulted first —
        first-fit allocation reuses it most."""
        if self._prefault_started:
            return
        self._prefault_started = True
        import threading

        def _prefault(path=self.pool.path,
                      nbytes=min(self.capacity, 8 << 30)):
            try:
                fd = os.open(path, os.O_RDWR)
                try:
                    mm = mmap.mmap(fd, nbytes)
                finally:
                    os.close(fd)
                step = 128 << 20
                for off in range(0, nbytes, step):
                    mm.madvise(mmap.MADV_POPULATE_WRITE, off,
                               min(step, nbytes - off))
                    time.sleep(0)  # yield the GIL between chunks
                mm.close()
            except Exception:
                pass

        threading.Thread(target=_prefault, name="store-prefault",
                         daemon=True).start()

    def _event(self, object_id: ObjectID, event: str, **detail):
        """Stamp one lifecycle transition onto the flight recorder (via
        the agent's buffer).  One boolean check when the plane is off."""
        cb = self.on_object_event
        if cb is None or not object_explain.enabled():
            return
        try:
            cb(object_id, event, detail)
        except Exception:
            pass

    # -- creation ---------------------------------------------------------

    def create(self, object_id: ObjectID, size: int,
               owner: Optional[str] = None) -> str:
        """Allocate a segment; returns the shm path the writer should mmap.

        ``owner`` (the owning CoreWorker's address, when the caller knows
        it) is remembered on the entry so a later spill/drain can register
        an external copy back with the owner."""
        self._maybe_start_prefault()
        if object_id in self._entries:
            e = self._entries[object_id]
            if owner and not e.owner:
                e.owner = owner
            return e.segment.path
        if size > self.capacity:
            raise ObjectStoreFullError(
                f"object {object_id} ({size} B) exceeds store capacity {self.capacity} B")
        if self.used + size > self.capacity:
            self._evict(self.used + size - self.capacity)
        if self.pool is not None:
            seg = self._pool_alloc(size)
        else:
            path = shm_path_for(self.name, object_id)
            try:
                seg = ShmSegment(path, size, create=True)
            except FileExistsError:
                os.unlink(path)
                seg = ShmSegment(path, size, create=True)
        self._entries[object_id] = _Entry(segment=seg, size=size,
                                          alloc=size, owner=owner)
        self.used += size
        self.num_creates += 1
        return seg.path

    def _pool_alloc(self, size: int) -> "PoolSlice":
        off = self.pool.alloc(size)
        if off < 0:
            # allocator full (fragmentation can strand capacity even when
            # self.used says otherwise): evict until the arena yields
            self._evict(max(size, 1))
            off = self.pool.alloc(size)
            if off < 0:
                self._evict(self.capacity // 4)
                off = self.pool.alloc(size)
        if off < 0:
            raise ObjectStoreFullError(
                f"store {self.name}: arena cannot place {size} B "
                f"(used={self.pool.used}/{self.pool.capacity})")
        return PoolSlice(self.pool, off, size)

    def create_and_write(self, object_id: ObjectID, data,
                         owner: Optional[str] = None) -> str:
        path = self.create(object_id, len(data), owner=owner)
        e = self._entries[object_id]
        e.segment.view()[: len(data)] = data
        self.seal(object_id)
        return path

    def seal(self, object_id: ObjectID, truncate_to: Optional[int] = None):
        """Seal; ``truncate_to`` shrinks the entry's DATA size to the
        exact bytes written (reserve-then-write puts reserve an upper
        bound): readers, transfers and spills then never touch the
        ``[used, reserved)`` tail — which is recycled arena memory, i.e.
        another object's stale bytes.  The allocator range (and ``used``
        accounting) stays the reservation until free."""
        e = self._entries[object_id]
        e.sealed = True
        if truncate_to is not None and 0 < truncate_to < e.size:
            e.size = truncate_to
        e.avail = None  # full: range map no longer meaningful
        ev = self._sealed_events.pop(object_id, None)
        if ev:
            ev.set()
        self._event(object_id, ObjectEvent.SEALED, size=e.size)

    def mark_available(self, object_id: ObjectID, offset: int, length: int):
        """Publish one landed chunk of an in-progress pull: ``read_chunk``
        serves it and ``object_info`` advertises it from now on."""
        e = self._entries.get(object_id)
        if e is None or e.sealed or e.freed:
            return
        e.avail = range_add(e.avail or [], offset, offset + length)

    def available_ranges(self, object_id: ObjectID) -> Optional[list]:
        """Sealed ranges of an UNSEALED entry (None when nothing landed or
        the object is sealed/freed/absent)."""
        e = self._entries.get(object_id)
        if e is None or e.sealed or e.freed:
            return None
        return e.avail

    # -- reads ------------------------------------------------------------

    def contains(self, object_id: ObjectID) -> bool:
        """Locally retrievable: sealed in shm, proxied from a same-host peer,
        OR spilled to this node's disk (get_path restores spilled entries
        transparently — without this, fetch_object would declare a
        spilled-but-local object lost)."""
        # freed-deferred records (owner freed them; only live reader pins
        # keep the bytes around) are NOT retrievable: serving them would
        # hand new fetchers a deleted object whose slice is reclaimed the
        # moment the last pin releases.
        e = self._entries.get(object_id)
        if e is not None and e.sealed and not e.freed:
            return True
        p = self._proxies.get(object_id)
        if p is not None and not p.freed:
            return True
        return (object_id in self._spilled
                or object_id in self._spilled_external)

    async def wait_sealed(self, object_id: ObjectID, timeout: float | None = None) -> bool:
        e = self._entries.get(object_id)
        if e is not None and e.sealed:
            return True
        ev = self._sealed_events.setdefault(object_id, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def add_proxy(self, object_id: ObjectID, path: str, size: int,
                  source_addr: str):
        self._proxies[object_id] = _ProxyEntry(path, size, source_addr)

    def get_path(self, object_id: ObjectID) -> Optional[tuple[str, int]]:
        p = self._proxies.get(object_id)
        if p is not None and not p.freed:
            return p.path, p.size
        e = self._entries.get(object_id)
        if e is not None and e.freed:
            return None  # freed-deferred: not servable (see contains())
        if e is None or not e.sealed:
            if e is None:
                self._maybe_restore(object_id)
                e = self._entries.get(object_id)
                if e is None or not e.sealed:
                    return None
            else:
                return None
        e.last_access = time.monotonic()
        return e.segment.path, e.size

    def read_chunk_view(self, object_id: ObjectID, offset: int,
                        length: int) -> memoryview:
        """ZERO-COPY chunk serving: a view straight over the shm mapping
        (sealed entry, same-host proxy slice, or a covered range of an
        in-progress pull).  The caller must consume the view WITHIN the
        current event-loop tick — the vectored reply path flushes
        synchronously and the asyncio transport copies any unsent
        remainder into its own buffer before returning, and eviction/free
        run on this same loop, so no recycle can interleave with a
        same-tick consumer.  Holding the view across an ``await`` would
        break that invariant."""
        e = self._entries.get(object_id)
        if e is None:
            # Same-host proxy holders ARE byte sources: serve straight off
            # the source pool slice / file the proxy references (remote
            # pullers that can't zero-copy attach still get the bytes).
            p = self._proxies.get(object_id)
            if p is not None and not p.freed:
                return self._attach_view(p.path, p.size)[
                    offset:offset + length]
            self._maybe_restore(object_id)
            e = self._entries[object_id]
        if e.freed:
            # deleted, just not yet reclaimed (reader pins live): a remote
            # puller must try another source, not copy a freed object
            raise KeyError(f"object {object_id} is freed")
        if not e.sealed:
            # partial holder (an in-progress pull publishing its ledger):
            # serve only ranges that actually landed — anything else is a
            # typed miss the puller re-stripes, never silent garbage
            if not (e.avail and range_covers(e.avail, offset,
                                             offset + length)):
                raise ChunkNotAvailable(
                    f"object {object_id}: [{offset}, {offset + length}) "
                    f"not yet held (have {e.avail or []})")
        e.last_access = time.monotonic()
        return e.segment.view()[offset:offset + length]

    def read_chunk(self, object_id: ObjectID, offset: int, length: int) -> bytes:
        """Copying chunk read (non-RPC consumers; the serving hot path is
        :meth:`read_chunk_view`)."""
        view = self.read_chunk_view(object_id, offset, length)
        return view.tobytes()

    def _attach_view(self, path: str, size: int) -> memoryview:
        """Attach-mode view over a path this store does not own (proxy
        serving); file-backed attaches are cached like ShmReader's."""
        if "#" in path:
            pool_path, off = path.rsplit("#", 1)
            return _pool_attach.view(pool_path, int(off), size)
        seg = self._attach_maps.get(path)
        if seg is None:
            seg = ShmSegment(path, size, create=False)
            self._attach_maps[path] = seg
        return seg.view()[:size]

    def size_of(self, object_id: ObjectID) -> Optional[int]:
        e = self._entries.get(object_id)
        return e.size if e else None

    # -- lifetime ---------------------------------------------------------
    #
    # Pin/release protocol (the plasma-client contract the round-1 reader
    # deferred with a defensive copy per read): a consumer pins BEFORE
    # taking a zero-copy view over an arena slice, and releases when its
    # last view is garbage-collected.  While any pin is live the slice's
    # offset cannot be recycled: eviction skips pinned entries, and an
    # owner-initiated free is DEFERRED — marked ``freed`` and completed by
    # the final unpin.  All transitions run on the agent's IO loop, so
    # pin-after-locate cannot race an eviction.

    def pin(self, object_id: ObjectID):
        e = self._entries.get(object_id)
        if e:
            e.pinned += 1

    def pin_for_read(self, object_id: ObjectID) -> Optional[str]:
        """Pin a same-host proxy OR a sealed entry for a reader's view.

        Returns the KIND of record pinned ("proxy" / "local", truthy) or
        None.  Priority mirrors :meth:`get_path` — the record pinned must
        be the one whose path the reader was handed, or the pin protects
        the wrong mapping.  The caller keeps the kind and passes it back
        to :meth:`unpin` so a release can never decrement the twin record
        (entry and proxy can coexist with independent pin counts)."""
        p = self._proxies.get(object_id)
        if p is not None and not p.freed:
            p.pinned += 1
            return "proxy"
        e = self._entries.get(object_id)
        if e is not None and e.sealed and not e.freed:
            e.pinned += 1
            return "local"
        return None

    def pin_for_serve(self, object_id: ObjectID) -> Optional[str]:
        """Pin the record :meth:`read_chunk_view` just served a view of —
        the bulk-transfer server's bracket: its serving THREADS push the
        view into the kernel outside the store's loop, so the view must
        be pin-protected for the send's duration (unlike the same-tick
        RPC reply path).  Mirrors read_chunk_view's service order (entry
        first, proxy only when no entry) and, unlike
        :meth:`pin_for_read`, also pins UNSEALED partial entries (their
        landed ranges are servable).  Returns the kind for
        :meth:`unpin`."""
        e = self._entries.get(object_id)
        if e is not None and not e.freed:
            e.pinned += 1
            return "local"
        p = self._proxies.get(object_id)
        if p is not None and not p.freed:
            p.pinned += 1
            return "proxy"
        return None

    def unpin(self, object_id: ObjectID, kind: Optional[str] = None) -> Optional[str]:
        """Drop one pin; completes a deferred free when the last pin goes.
        Returns the proxy SOURCE address if the completed free was a proxy
        (the caller owes the source an unpin notify).

        ``kind`` ("local" / "proxy", from :meth:`pin_for_read`) targets the
        record the pin was granted on.  Without it (transfer pins via
        :meth:`pin`, legacy callers) the release lands on whichever record
        actually holds pins — never on a zero-pin twin, which would leak
        the real pin and prematurely release another reader's."""
        e = self._entries.get(object_id)
        p = self._proxies.get(object_id)
        te = e if kind != "proxy" else None
        tp = p if kind != "local" else None
        if te is not None and (te.pinned > 0 or tp is None or tp.pinned == 0):
            if te.pinned > 0:
                te.pinned -= 1
        elif tp is not None and tp.pinned > 0:
            tp.pinned -= 1
        # A deferred free completes only once NO pins remain on EITHER
        # record — free() defers when either is pinned, so completion must
        # mirror that or a proxy reader's slice is reclaimed under it.
        freed = (e is not None and e.freed) or (p is not None and p.freed)
        live = ((e.pinned if e is not None else 0)
                + (p.pinned if p is not None else 0))
        if freed and live == 0:
            return self._complete_free(object_id)
        return None

    def free(self, object_id: ObjectID, force: bool = False) -> Optional[str]:
        """Free a local object.  Returns the SOURCE agent address when the
        freed entry was a same-host proxy — the caller must send the unpin.

        A free that lands while reader pins are live is deferred (the
        segment must not be unlinked — or its arena offset recycled — under
        a live zero-copy view); the last unpin completes it.  ``force``
        (shutdown) skips the deferral."""
        e = self._entries.get(object_id)
        p = self._proxies.get(object_id)
        if not force and ((e is not None and e.pinned > 0)
                          or (p is not None and p.pinned > 0)):
            if e is not None:
                e.freed = True
            if p is not None:
                p.freed = True
            self._event(object_id, ObjectEvent.FREE_DEFERRED,
                        pins=(e.pinned if e is not None else 0)
                        + (p.pinned if p is not None else 0))
            # The spilled copy has no readers — reclaim it now.
            spilled = self._spilled.pop(object_id, None)
            self._spilled_sizes.pop(object_id, None)
            if spilled:
                try:
                    os.unlink(spilled)
                except OSError:
                    pass
            self._drop_external(object_id)
            return None
        return self._complete_free(object_id, drop_external=not force)

    def _drop_external(self, object_id: ObjectID):
        """Delete this store's external-tier copy of a freed object.  If the
        write is still in flight, deletion chains behind its completion
        (free-during-spill race: the copy must not survive the free)."""
        uri = self._spilled_external.pop(object_id, None)
        self._ext_sizes.pop(object_id, None)
        if uri is None:
            return
        if object_id in self._ext_writes:
            self._ext_drop_after_write.add(object_id)
        else:
            try:
                # off the caller's (event-loop) thread: a gs:// delete is
                # a network round trip, and free() runs in RPC handlers
                self._ext_executor().submit(external_spill.delete, uri)
            except Exception:
                pass

    def _complete_free(self, object_id: ObjectID,
                       drop_external: bool = True) -> Optional[str]:
        proxy = self._proxies.pop(object_id, None)
        if proxy is not None:
            # drop the chunk-serving attach mapping (if any): holding it
            # past the proxy's life would keep the origin's unlinked shm
            # pages resident forever on a long-lived agent
            seg = self._attach_maps.pop(proxy.path, None)
            if seg is not None:
                seg.close()
        # A freed object may live in shm, on the spill disk, the external
        # tier, or several at once.
        spilled = self._spilled.pop(object_id, None)
        self._spilled_owners.pop(object_id, None)
        self._spilled_sizes.pop(object_id, None)
        if spilled:
            try:
                os.unlink(spilled)
            except OSError:
                pass
        had_external = object_id in self._spilled_external
        if drop_external:
            self._drop_external(object_id)
        e = self._entries.pop(object_id, None)
        # Freeing an UNSEALED entry (a failed striped pull) must wake any
        # wait_sealed() waiter NOW: they re-resolve (get_path -> None ->
        # remote pull) instead of sleeping out their full timeout against
        # an event nothing will ever set.
        ev = self._sealed_events.pop(object_id, None)
        if ev:
            ev.set()
        if e is not None or proxy is not None or spilled is not None \
                or had_external:
            # stamp only when this store actually held SOMETHING: the
            # owner's free fans out to every listed location, including
            # nodes whose copy is already gone
            self._event(object_id, ObjectEvent.FREED)
        if e is None:
            return proxy.source_addr if proxy else None
        self.used -= e.alloc or e.size
        e.segment.close()
        e.segment.unlink()
        return proxy.source_addr if proxy else None

    def _evict(self, need_bytes: int):
        """LRU-evict sealed unpinned entries; spill them first if configured."""
        # A freed-deferred entry (only its proxy twin is pinned) must not be
        # spilled/evicted as if live: it would gain a spill copy nothing
        # cleans up and _maybe_restore could resurrect a freed object.
        victims = sorted(
            (e for oid, e in self._entries.items()
             if e.sealed and e.pinned == 0 and not e.freed),
            key=lambda e: e.last_access)
        freed = 0
        for e in victims:
            if freed >= need_bytes:
                break
            oid = next(k for k, v in self._entries.items() if v is e)
            if self.spill_dir or self.external_uri:
                self._spill(oid, e)
            self._entries.pop(oid)
            self.used -= e.alloc or e.size
            freed += e.alloc or e.size
            e.segment.close()
            e.segment.unlink()
            self.num_evictions += 1
        if freed < need_bytes:
            raise ObjectStoreFullError(
                f"store {self.name}: need {need_bytes} B but only {freed} B evictable "
                f"(used={self.used}/{self.capacity})")

    def _spill(self, object_id: ObjectID, e: _Entry):
        """Spill one evicted entry: to the external fsspec tier when
        configured (durable — survives this node), else to node-local disk.

        The external write runs on a background thread against a
        synchronous COPY of the bytes (the segment is reclaimed the moment
        eviction returns); the URI is recorded immediately so readers that
        race the write wait on the in-flight future instead of missing the
        copy.  Once the write lands, ``on_external_spill`` tells the agent
        to register the URI with the owner as a non-node location."""
        if self.external_uri:
            self._spill_external(object_id, e)
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        self._write_spill_marker()
        path = os.path.join(self.spill_dir, f"{self.name}-{object_id.hex()}.spill")
        with open(path, "wb") as f:
            # [:e.size]: a seal-truncated entry's segment is the (larger)
            # reservation — the tail is recycled arena bytes, never data
            f.write(e.segment.view()[:e.size])
        self._spilled.setdefault(object_id, path)
        self._spilled_sizes[object_id] = e.size
        if e.owner:
            # the entry record dies with the evict; the drain path still
            # needs to know whom to tell when it re-homes this file
            self._spilled_owners[object_id] = e.owner
        m = spill_metrics()
        if m is not None:
            m["bytes"].inc_key(KEY_TIER_LOCAL, e.size)
        object_explain.ledger_record(KEY_SPILL, e.size)
        self._event(object_id, ObjectEvent.SPILLED, tier="local",
                    size=e.size)

    def _spill_external(self, object_id: ObjectID, e: _Entry):
        if (object_id in self._spilled_external
                and object_id not in self._ext_writes):
            # restore->evict cycle: the landed external copy (kept by
            # _maybe_restore precisely for this) is still valid — byte
            # content is immutable once sealed, so re-uploading the whole
            # object (and re-firing the owner registration) is pure waste
            return
        data = bytes(e.segment.view()[:e.size])
        uri = external_spill.object_uri(self.external_uri, object_id)
        self._spilled_external[object_id] = uri
        self._ext_sizes[object_id] = len(data)
        object_explain.ledger_record(KEY_SPILL, len(data))
        self._event(object_id, ObjectEvent.SPILLED, tier="external",
                    size=len(data), uri=uri)
        fut = self._ext_executor().submit(external_spill.write, uri, data)
        self._ext_writes[object_id] = fut
        fut.add_done_callback(
            lambda f, oid=object_id, uri=uri, owner=e.owner, data=data:
            self._ext_write_done(oid, uri, owner, f, data))

    def _ext_executor(self):
        if self._ext_pool is None:
            import concurrent.futures
            self._ext_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="ext-spill")
        return self._ext_pool

    def _ext_write_done(self, object_id: ObjectID, uri: str,
                        owner: Optional[str], fut, data=None):
        """Runs on the spill writer thread (dict single-op mutations only —
        GIL-atomic; everything loop-bound goes through on_external_spill,
        which the agent marshals back onto its loop)."""
        self._ext_writes.pop(object_id, None)
        try:
            n = fut.result()
        except Exception:
            # failed write: the recorded URI is a dangling promise — drop
            # it so contains()/restore stop advertising a copy that isn't,
            # and FALL BACK to the local spill disk (the entry is already
            # evicted; without this the sole copy is simply gone while the
            # owner still routes pullers here)
            self._spilled_external.pop(object_id, None)
            self._ext_sizes.pop(object_id, None)
            if object_id in self._ext_drop_after_write:
                self._ext_drop_after_write.discard(object_id)
                return  # freed mid-write: nothing to preserve
            if data is not None and self.spill_dir:
                try:
                    os.makedirs(self.spill_dir, exist_ok=True)
                    self._write_spill_marker()
                    path = os.path.join(
                        self.spill_dir,
                        f"{self.name}-{object_id.hex()}.spill")
                    with open(path, "wb") as f:
                        f.write(data)
                    self._spilled[object_id] = path
                    self._spilled_sizes[object_id] = len(data)
                    self._event(object_id, ObjectEvent.SPILLED,
                                tier="local", size=len(data),
                                fallback=True)
                    if owner:
                        self._spilled_owners[object_id] = owner
                    m = spill_metrics()
                    if m is not None:
                        m["bytes"].inc_key(KEY_TIER_LOCAL, len(data))
                except Exception:
                    pass
            return
        m = spill_metrics()
        if m is not None:
            m["bytes"].inc_key(KEY_TIER_EXTERNAL, n)
        if object_id in self._ext_drop_after_write:
            # freed while the write was in flight: the copy must not
            # outlive the free
            self._ext_drop_after_write.discard(object_id)
            try:
                external_spill.delete(uri)
            except Exception:
                pass
            return
        cb = self.on_external_spill
        if cb is not None and self._spilled_external.get(object_id) == uri:
            try:
                cb(object_id, uri, owner)
            except Exception:
                pass

    def _write_spill_marker(self):
        """Pid marker for the orphan sweep: a later incarnation on this
        host deletes spill dirs whose writing process is gone."""
        marker = os.path.join(self.spill_dir, "owner.json")
        if not os.path.exists(marker):
            try:
                with open(marker, "w") as f:
                    json.dump({"pid": os.getpid(),
                               "store": self.name,
                               "started_at": time.time()}, f)
            except OSError:
                pass

    @property
    def _spilled(self) -> Dict[ObjectID, str]:
        if not hasattr(self, "_spilled_map"):
            self._spilled_map: Dict[ObjectID, str] = {}
        return self._spilled_map

    @property
    def _spilled_owners(self) -> Dict[ObjectID, str]:
        """Owner address per LOCALLY spilled object (the entry that held it
        is gone; the drain path re-homes these files and must register the
        new location with the owner)."""
        if not hasattr(self, "_spilled_owners_map"):
            self._spilled_owners_map: Dict[ObjectID, str] = {}
        return self._spilled_owners_map

    def external_only(self, object_id: ObjectID) -> bool:
        """True when the ONLY local knowledge of this object is an
        external-tier URI — the restore is a (possibly remote) network
        read the agent must run off-loop, unlike the local-disk path."""
        e = self._entries.get(object_id)
        if e is not None and e.sealed and not e.freed:
            return False
        p = self._proxies.get(object_id)
        if p is not None and not p.freed:
            return False
        return (object_id not in self._spilled
                and object_id in self._spilled_external)

    def restore_external_bytes(self, object_id: ObjectID,
                               data: bytes) -> None:
        """Land externally-restored bytes back into the store (the agent
        read them off-loop; this runs ON the loop).  The external record is
        kept — other nodes may be routed at it and re-evicting reuses it."""
        if object_id in self._entries:
            return
        self.create_and_write(object_id, data)
        object_explain.ledger_record(KEY_RESTORE, len(data))
        self._event(object_id, ObjectEvent.RESTORED, tier="external",
                    size=len(data))

    def _maybe_restore(self, object_id: ObjectID):
        path = self._spilled.pop(object_id, None)
        if path is not None:
            self._spilled_sizes.pop(object_id, None)
            t0 = time.monotonic()
            with open(path, "rb") as f:
                data = f.read()
            self.create_and_write(object_id, data,
                                  owner=self._spilled_owners.pop(
                                      object_id, None))
            os.unlink(path)
            m = spill_metrics()
            if m is not None:
                m["restore_seconds"].observe(time.monotonic() - t0)
            object_explain.ledger_record(KEY_RESTORE, len(data))
            self._event(object_id, ObjectEvent.RESTORED, tier="local",
                        size=len(data))
            return
        # External tier: wait out an in-flight spill write (the reader
        # raced the evict), then read the URI back into the store.  The
        # external copy is NOT deleted — it may be registered with the
        # owner as a location other nodes are pulling from; the owner's
        # free is its single deletion point.
        #
        # This SYNCHRONOUS branch is the local-disk-style fallback for
        # direct store users; the agent's read paths go through the
        # off-loop ``_restore_external`` FIRST and only land here after it
        # failed, so the in-flight wait is capped short rather than
        # letting one slow tier freeze the caller for a minute.
        uri = self._spilled_external.get(object_id)
        if uri is None:
            return
        if time.monotonic() < self._ext_backoff.get(object_id, 0.0):
            return  # off-loop restore just failed: don't retry ON-loop
        fut = self._ext_writes.get(object_id)
        if fut is not None:
            try:
                fut.result(timeout=5.0)
            except Exception:
                return  # write failed/slow; the caller's pull path covers
        try:
            data = external_spill.timed_read(uri)
        except Exception:
            self._ext_backoff[object_id] = time.monotonic() + 5.0
            return
        self._ext_backoff.pop(object_id, None)
        self.create_and_write(object_id, data)
        object_explain.ledger_record(KEY_RESTORE, len(data))
        self._event(object_id, ObjectEvent.RESTORED, tier="external",
                    size=len(data))

    def arena_report(self) -> dict:
        """Arena introspection: free bytes, largest free block, the
        fragmentation fraction (1 - largest_free/free: 0 = one contiguous
        free region, ->1 = free space shredded into slivers), and a
        coarse free-block size histogram when the native pool exposes
        block enumeration."""
        free = max(0, self.capacity - self.used)
        largest_free = free if self.pool is None else 0
        hist = None
        if self.pool is not None:
            try:
                largest_free = self.pool.largest_free
            except Exception:
                largest_free = 0
            blocks = []
            try:
                blocks = self.pool.free_blocks()
            except Exception:
                blocks = []
            if blocks:
                # power-of-4 buckets from 64 KiB: bounded (8 buckets),
                # readable, and enough to see sliver accumulation
                bounds = [64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20,
                          64 << 20, 256 << 20]
                hist = [0] * (len(bounds) + 1)
                for b in blocks:
                    i = 0
                    while i < len(bounds) and b > bounds[i]:
                        i += 1
                    hist[i] += 1
                hist = {"bounds": bounds, "counts": hist,
                        "num_free_blocks": len(blocks)}
        frag = 0.0
        if free > 0 and largest_free > 0:
            frag = max(0.0, 1.0 - largest_free / free)
        elif free > 0 and self.pool is not None:
            frag = 1.0  # free capacity exists but no allocatable block
        return {"free": free, "largest_free_block": largest_free,
                "frag_fraction": round(frag, 4), "free_block_hist": hist}

    def stats(self) -> dict:
        arena = self.arena_report()
        return {
            "capacity": self.capacity,
            "used": self.used,
            "largest_free_block": arena["largest_free_block"],
            "frag_fraction": arena["frag_fraction"],
            "free_block_hist": arena["free_block_hist"],
            "num_objects": len(self._entries),
            "num_proxies": len(self._proxies),
            "num_creates": self.num_creates,
            "num_evictions": self.num_evictions,
            "num_pinned": sum(1 for e in self._entries.values()
                              if e.pinned > 0)
            + sum(1 for p in self._proxies.values() if p.pinned > 0),
            "num_deferred_frees": sum(1 for e in self._entries.values()
                                      if e.freed)
            + sum(1 for p in self._proxies.values() if p.freed),
            "num_spilled_local": len(self._spilled),
            "num_spilled_external": len(self._spilled_external),
            # spill-tier byte totals (the external tier was invisible to
            # memory_summary before — only the spill counter saw it)
            "spilled_local_bytes": sum(self._spilled_sizes.get(oid, 0)
                                       for oid in self._spilled),
            "spilled_external_bytes": sum(self._ext_sizes.values()),
        }

    def objects(self) -> list:
        """Per-object report rows (the ``raytpu memory`` data source)."""
        rows = []
        for oid, e in self._entries.items():
            rows.append({"object_id": oid.hex(), "size": e.size,
                         "sealed": e.sealed, "pinned": e.pinned,
                         "freed": e.freed, "kind": "local",
                         "path": e.segment.path})
        for oid, p in self._proxies.items():
            rows.append({"object_id": oid.hex(), "size": p.size,
                         "sealed": True, "pinned": p.pinned,
                         "freed": p.freed, "kind": "proxy",
                         "path": p.path, "source": p.source_addr})
        for oid, path in self._spilled.items():
            rows.append({"object_id": oid.hex(),
                         "size": self._spilled_sizes.get(oid),
                         "sealed": True, "pinned": 0, "freed": False,
                         "kind": "spilled", "path": path})
        for oid, uri in self._spilled_external.items():
            if oid in self._entries:
                continue  # restored: already reported as "local"
            rows.append({"object_id": oid.hex(),
                         "size": self._ext_sizes.get(oid),
                         "sealed": True, "pinned": 0, "freed": False,
                         "kind": "external", "path": uri})
        return rows

    def shutdown(self):
        for seg in self._attach_maps.values():
            seg.close()
        self._attach_maps.clear()
        for oid in list(self._entries):
            self.free(oid, force=True)
        # spill files of still-referenced-but-evicted objects would otherwise
        # outlive the session and accumulate under the shared default dir.
        # External-tier copies are deliberately NOT deleted here: they may be
        # registered with owners as live locations (the whole point of the
        # durability tier); the owner's free — or a later orphan GC — is
        # their deletion point.
        for oid in list(self._spilled):
            path = self._spilled.pop(oid)
            try:
                os.unlink(path)
            except OSError:
                pass
        if self.spill_dir and os.path.isdir(self.spill_dir):
            # this incarnation's (now empty) spill subdir + marker
            import shutil
            shutil.rmtree(self.spill_dir, ignore_errors=True)
        if self._ext_pool is not None:
            self._ext_pool.shutdown(wait=False)
            self._ext_pool = None
        if self.pool is not None:
            self.pool.close(unlink=True)
            self.pool = None


def sweep_orphan_spill_dirs(spill_root: str, grace_s: float = 60.0) -> int:
    """Delete per-store local spill directories whose writing process is
    gone (a restarted node incarnation cleaning up its previous life).
    Each store writes an ``owner.json`` pid marker on first spill; a dir
    whose pid is dead — or that has spill files but no marker — is an
    orphan.  Marker-less dirs younger than ``grace_s`` are SKIPPED: a
    sibling agent's first spill creates the dir a moment before its
    marker write lands, and sweeping that window would delete a live
    store's file out from under its evict.  Returns the number of
    directories removed."""
    import shutil
    removed = 0
    try:
        names = os.listdir(spill_root)
    except OSError:
        return 0
    for name in names:
        d = os.path.join(spill_root, name)
        if not os.path.isdir(d):
            continue
        marker = os.path.join(d, "owner.json")
        pid = None
        try:
            with open(marker) as f:
                pid = int(json.load(f).get("pid", 0))
        except (OSError, ValueError, TypeError):
            pid = None
        if pid is None:
            try:
                if time.time() - os.path.getmtime(d) < grace_s:
                    continue  # mid-creation by a live sibling
            except OSError:
                continue
        alive = False
        if pid:
            try:
                os.kill(pid, 0)
                alive = True
            except ProcessLookupError:
                alive = False
            except PermissionError:
                alive = True  # exists, owned by someone else
            except OSError:
                alive = False
        if not alive:
            shutil.rmtree(d, ignore_errors=True)
            removed += 1
    return removed


# ---------------------------------------------------------------------------
# Per-process attach-side client
# ---------------------------------------------------------------------------

class ShmReader:
    """Attach-side reads of store segments.

    File-per-object segments are cached and returned zero-copy (an unlinked
    file stays valid for existing mmaps, so eviction cannot invalidate a
    reader's view).  Pool slices have two read modes:

    * :meth:`view` — ZERO-COPY readonly view, valid only while the caller
      holds a store pin on the object (the pin/release protocol: the agent
      pinned the entry at fetch time, and the pin blocks eviction and
      defers frees until the consumer's views die).
    * :meth:`read` — the unpinned fallback: copy out and let the caller
      re-validate with ``store_verify`` (the arena recycles offsets, so an
      unpinned view is not a stable identity).  Records a ``get_copy``
      event so the copy-discipline tests can pin the pinned path at zero.
    """

    def __init__(self):
        self._maps: Dict[str, ShmSegment] = {}

    def _stats(self):
        from .serialization import _stats  # the one lazy cycle-break shim
        return _stats()

    def view(self, path: str, size: int) -> memoryview:
        """Zero-copy view; caller must hold a pin for pool slices.

        Returned WRITABLE (ctypes ``from_buffer`` in the lease-attach step
        needs it); the deserializer wraps every slice readonly before any
        user code can touch it."""
        if "#" in path:
            pool_path, off = path.rsplit("#", 1)
            mv = _pool_attach.view(pool_path, int(off), size)
        else:
            seg = self._maps.get(path)
            if seg is None:
                seg = ShmSegment(path, size, create=False)
                self._maps[path] = seg
            mv = seg.view()[:size]
        self._stats().record("get_zero_copy", size)
        return mv

    def read(self, path: str, size: int):
        if "#" in path:
            pool_path, off = path.rsplit("#", 1)
            self._stats().record("get_copy", size)
            return bytes(_pool_attach.view(pool_path, int(off), size))
        seg = self._maps.get(path)
        if seg is None:
            seg = ShmSegment(path, size, create=False)
            self._maps[path] = seg
        return seg.view()[:size]

    def drop(self, path: str):
        seg = self._maps.pop(path, None)
        if seg:
            seg.close()

    def close(self):
        for seg in self._maps.values():
            seg.close()
        self._maps.clear()


# ---------------------------------------------------------------------------
# In-process memory store (owner-side)
# ---------------------------------------------------------------------------

@dataclass
class PlasmaRecord:
    """Location record for a large object (primary copy + replicas)."""
    size: int
    locations: list  # list of (node_id_hex, agent_address)


@dataclass
class ErrorRecord:
    """A task error stored in place of a value; raised on get.

    ``system`` marks faults recorded by the RUNTIME (OOM kill, worker crash,
    actor death) rather than raised by the task body: system faults surface
    typed from ``get`` (ray.exceptions semantics), while user exceptions —
    even RayTpuError subclasses a task let propagate from an inner get —
    wrap in TaskError so failures stay attributed to the right task."""
    error: bytes  # pickled exception
    system: bool = False


class MemoryStore:
    """Owner-side store: object id -> inline bytes | PlasmaRecord | ErrorRecord.

    Readiness is an asyncio.Event per pending id, so `get`/`wait` can await
    completion of the producing task (reference: GetRequest futures in
    memory_store.cc).
    """

    def __init__(self):
        self._values: Dict[ObjectID, object] = {}
        self._events: Dict[ObjectID, asyncio.Event] = {}
        # Batch waiters (wait_many): object id -> [waiter, ...] where a
        # waiter is a [remaining_count, future] pair shared by every id of
        # one batched get.  put() decrements O(1); the future resolves
        # when the LAST id lands — one future + one wakeup per batch
        # instead of one Event + one wait_for coroutine per ref (the
        # owner-loop cost that capped big drains; ROADMAP 5).
        self._batch_waiters: Dict[ObjectID, list] = {}

    def put(self, object_id: ObjectID, record) -> None:
        self._values[object_id] = record
        ev = self._events.pop(object_id, None)
        if ev:
            ev.set()
        waiters = self._batch_waiters.pop(object_id, None)
        if waiters:
            for w in waiters:
                w[0] -= 1
                if w[0] <= 0 and not w[1].done():
                    w[1].set_result(True)

    def contains(self, object_id: ObjectID) -> bool:
        return object_id in self._values

    def get_if_exists(self, object_id: ObjectID):
        return self._values.get(object_id)

    async def wait_ready(self, object_id: ObjectID, timeout: float | None = None) -> bool:
        if object_id in self._values:
            return True
        ev = self._events.setdefault(object_id, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def wait_many(self, object_ids, timeout: float | None = None) -> bool:
        """Await ALL of ``object_ids`` being present — one shared future
        for the whole batch (see _batch_waiters).  Timed-out waiters are
        left registered but done; put() skips them, and the entry list is
        popped whenever the id eventually lands (bounded by in-flight
        batches, not history)."""
        missing = [oid for oid in object_ids if oid not in self._values]
        if not missing:
            return True
        fut = asyncio.get_event_loop().create_future()
        waiter = [len(missing), fut]
        for oid in missing:
            self._batch_waiters.setdefault(oid, []).append(waiter)
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def free(self, object_id: ObjectID):
        self._values.pop(object_id, None)
        self._events.pop(object_id, None)

    def __len__(self):
        return len(self._values)
