"""Serialization: cloudpickle for code, pickle-5 out-of-band buffers for data.

The reference splits serialization the same way (``python/ray/_private/serialization.py``):
cloudpickle for closures/classes shipped through the function registry, and a zero-copy
buffer protocol (Arrow / pickle5) for array payloads so large tensors move as raw bytes
into the object store without an extra copy.  Here the out-of-band buffers are what lands
in the shared-memory store; deserialization reconstructs numpy arrays as views over the
store's mmap when possible.

ObjectRefs found inside arguments are collected during serialization (for dependency
tracking) exactly like the reference's ``SerializationContext`` does with
``_postprocess_serialized_object``.
"""

from __future__ import annotations

import io
import os
import pickle
import sys
import sysconfig
import types
from typing import Any, List, Tuple

import cloudpickle
from cloudpickle.cloudpickle import _dynamic_class_reduce

_copy_stats = None


def _stats():
    """ray_tpu_torch.util.metrics.copy_stats, imported lazily (core <-> util
    import cycle) and cached."""
    global _copy_stats
    if _copy_stats is None:
        from ray_tpu_torch.util.metrics import copy_stats
        _copy_stats = copy_stats
    return _copy_stats

# Roots under which a module is assumed importable on every worker: the
# interpreter's stdlib + site-packages, and this package itself (workers get
# the package root on PYTHONPATH — node_agent._spawn_worker).  Functions and
# classes defined anywhere else (driver scripts, test files, notebook dirs)
# are shipped BY VALUE, matching the reference's function-table export which
# pickles the def itself rather than a module path
# (python/ray/_private/function_manager.py export/fetch), so workers never
# need the driver's cwd or sys.path to run ``Pool.map(module_fn)``.
_PORTABLE_ROOTS = tuple(
    os.path.abspath(p) + os.sep
    for p in {
        sysconfig.get_paths().get("stdlib", ""),
        sysconfig.get_paths().get("platstdlib", ""),
        sysconfig.get_paths().get("purelib", ""),
        sysconfig.get_paths().get("platlib", ""),
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),  # ray_tpu_torch/
    }
    if p
)


def _ship_by_value(obj) -> bool:
    """True when ``obj``'s defining module may not be importable on workers."""
    mod_name = getattr(obj, "__module__", None)
    if mod_name is None or mod_name == "__main__":
        return False  # cloudpickle already pickles __main__ defs by value
    mod = sys.modules.get(mod_name)
    if mod is None:
        return False
    mod_file = getattr(mod, "__file__", None)
    if mod_file is None:
        return False  # builtin / frozen — always importable
    mod_file = os.path.abspath(mod_file)
    return not mod_file.startswith(_PORTABLE_ROOTS)


class _ByValuePickler(cloudpickle.CloudPickler):
    """CloudPickler that forces by-value pickling for non-portable defs."""

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType) and _ship_by_value(obj):
            return self._dynamic_function_reduce(obj)
        if isinstance(obj, type) and _ship_by_value(obj):
            return _dynamic_class_reduce(obj)
        return super().reducer_override(obj)


class SerializedObject:
    """A picked value split into a metadata stream + zero-copy buffers.

    Two-phase layout (the scatter-gather put): phase one is the pickle-5
    ``buffer_callback`` pass in :func:`serialize`, which produces the inband
    stream plus out-of-band :class:`pickle.PickleBuffer` views over the
    ORIGINAL payload memory (no copy); phase two is :meth:`write_into`,
    which lays header + inband + buffers directly into an arena-allocated
    store mapping — the payload's single host copy.  :meth:`to_bytes` (a
    full flatten through an intermediate ``bytes``) exists for small inline
    values and RPC blobs only; on large payloads it records a
    ``serialize_flatten`` copy event, which the copy-discipline tests pin
    at zero for the put path.
    """

    __slots__ = ("inband", "buffers", "contained_refs", "_header", "_sizes")

    def __init__(self, inband: bytes, buffers: List[pickle.PickleBuffer | memoryview | bytes],
                 contained_refs: list):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = contained_refs
        self._header: bytes | None = None
        self._sizes: list[int] | None = None

    def total_bytes(self) -> int:
        return len(self.inband) + sum(len(memoryview(b).cast("B")) for b in self.buffers)

    def to_bytes(self) -> bytes:
        """Flatten to one contiguous byte string: header + inband + buffers."""
        header, sizes = self.header_and_sizes()
        payload = sum(sizes)
        _stats().record("serialize_flatten", payload)
        out = io.BytesIO()
        out.write(len(header).to_bytes(4, "big"))
        out.write(header)
        out.write(self.inband)
        for b in self.buffers:
            out.write(memoryview(b).cast("B"))
        return out.getvalue()

    def header_and_sizes(self) -> tuple[bytes, list[int]]:
        # Cached: flat_size() + write_into() both need it, and the header
        # must be byte-identical between the sizing and writing phases.
        if self._header is None:
            self._sizes = [len(self.inband)] + [
                len(memoryview(b).cast("B")) for b in self.buffers]
            self._header = pickle.dumps(self._sizes, protocol=5)
        return self._header, self._sizes

    def flat_size(self) -> int:
        header, sizes = self.header_and_sizes()
        return 4 + len(header) + sum(sizes)

    def write_into(self, view: memoryview) -> int:
        """Serialize directly into a writable buffer (e.g. a store mmap).

        This is the put path's ONE data copy: buffers stream from the
        caller's memory straight into the arena mapping.  Recorded as a
        single ``object_write`` copy event regardless of buffer count."""
        header, sizes = self.header_and_sizes()
        off = 0
        view[0:4] = len(header).to_bytes(4, "big")
        off = 4
        view[off:off + len(header)] = header
        off += len(header)
        for part in [self.inband] + self.buffers:
            mv = memoryview(part).cast("B")
            view[off:off + len(mv)] = mv
            off += len(mv)
        _stats().record("object_write", sum(sizes))
        return off

    @classmethod
    def from_buffer(cls, buf) -> "SerializedObject":
        """Reconstruct from a flattened buffer (zero-copy views into ``buf``).

        Two layouts parse here: the classic sequential one
        (``[4B hlen][header=pickle(sizes)][inband][buffers...]``) and the
        zero-copy put's reserve-then-write layout, whose header is a dict
        in a fixed padded region and whose BUFFERS precede the inband
        stream (they land during the pickle dump, before the stream's
        final size is known — see :func:`serialize_into`)."""
        mv = memoryview(buf)
        hlen = int.from_bytes(bytes(mv[:4]), "big")
        header = pickle.loads(bytes(mv[4:4 + hlen]))
        off = 4 + hlen
        if isinstance(header, dict):
            # reserve-then-write layout: buffers first, inband last
            sizes = header["sizes"]
            bufs = []
            for s in sizes[1:]:
                bufs.append(mv[off:off + s])
                off += s
            return cls(bytes(mv[off:off + sizes[0]]), bufs, [])
        parts = []
        for s in header:
            parts.append(mv[off:off + s])
            off += s
        return cls(bytes(parts[0]), list(parts[1:]), [])


class _RefPickler(_ByValuePickler):
    """cloudpickle + ObjectRef interception: refs found inside the value are
    collected into ``self.contained`` (for dependency/borrow tracking) and
    replaced by persistent ids.  protocol 5 gives out-of-band buffer
    extraction for numpy and friends."""

    def __init__(self, file, buffer_callback):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self.contained: list = []

    def persistent_id(self, obj):
        from .object_ref import ObjectRef  # local import to break cycle
        if isinstance(obj, ObjectRef):
            self.contained.append(obj)
            return ("rayref", obj.id.binary(), obj.owner)
        return None


class _RefUnpickler(pickle.Unpickler):
    def persistent_load(self, pid):
        tag, idbin, owner = pid
        if tag != "rayref":
            raise pickle.UnpicklingError(f"unknown persistent id {tag}")
        from .ids import ObjectID
        from .object_ref import ObjectRef
        return ObjectRef(ObjectID(idbin), owner=owner)


def serialize(value: Any) -> SerializedObject:
    buffers: List[pickle.PickleBuffer] = []

    def _collect(pb: pickle.PickleBuffer) -> bool:
        buffers.append(pb)
        return False  # out-of-band

    sio = io.BytesIO()
    p = _RefPickler(sio, buffer_callback=_collect)
    p.dump(value)
    return SerializedObject(sio.getvalue(), buffers, p.contained)


# ---------------------------------------------------------------------------
# Zero-copy put: reserve-then-write serialization (serialize INTO an arena
# range instead of serialize-then-copy).
#
# The classic large-put pipeline is serialize() -> store_create -> one
# write_into memcpy: the payload is materialized once into the arena by a
# single thread, which PROFILE_CORE round 6 measured at ~78% of the box's
# single-thread memcpy ceiling — the whole put is bounded by that one
# memcpy.  Reserve-then-write removes it as a *separate, serial* stage:
#
#   1. estimate_flat_size() upper-bounds the flat encoding from the
#      value's buffer-protocol payload (no pickling);
#   2. the caller reserves an arena range of that size (store_create);
#   3. serialize_into() pickles straight at the reservation: out-of-band
#      buffers are assigned arena offsets as the pickler surfaces them
#      and then land by parallel memoryview gather-write (numpy copyto
#      stripes release the GIL, so big buffers land at aggregate memory
#      bandwidth, not the single-thread ceiling), the inband stream and
#      the padded header follow, and seal happens in place;
#   4. an estimate MISS (encoding outgrew the reservation, too many
#      buffers for the header region, payload not buffer-dominated)
#      raises _EstimateMiss and the caller falls back to the classic
#      1-copy path — correctness never depends on the estimate.
#
# No payload byte is ever materialized outside its source and the arena
# (the plasma/Arrow zero-copy-put convention: serialization targets store
# memory directly), which is what the copy ledger's put/copies=0 class
# declares.  Bytes still traverse the memory bus once — physics — but
# there is no intermediate bytes object and no serial post-hoc memcpy.

#: fixed padded header region of the reserve-then-write layout: the real
#: header (a dict with the part sizes) is backpatched here after the dump
#: and padded with zero bytes, which pickle.loads ignores past STOP.
ZC_HEADER_RESERVE = 4096
#: buffers at or above this stripe over the gather pool; smaller ones are
#: landed inline by the dumping thread (thread dispatch would cost more)
_GATHER_MIN_BUF = 4 << 20
#: minimum bytes of buffer-protocol payload per gather stripe
_GATHER_MIN_STRIPE = 2 << 20


class _EstimateMiss(Exception):
    """The reserve-then-write encoding outgrew its reservation (or the
    value's shape defeated the estimator mid-dump): fall back to the
    classic serialize-then-copy path."""


class SerializedInto:
    """Result of a completed :func:`serialize_into`: the metadata the put
    path needs (the bytes already live in the arena view)."""

    __slots__ = ("used", "payload_bytes", "contained_refs", "num_buffers")

    def __init__(self, used: int, payload_bytes: int, contained_refs: list,
                 num_buffers: int):
        self.used = used
        self.payload_bytes = payload_bytes
        self.contained_refs = contained_refs
        self.num_buffers = num_buffers


def _estimate_walk(value, state: list, depth: int) -> None:
    """Accumulate (buffer_bytes, inband_bytes, nodes) for the shapes the
    estimator understands; raise _EstimateMiss for anything else."""
    state[2] += 1
    if state[2] > 10_000 or depth > 8:
        raise _EstimateMiss("value too deep/wide to estimate")
    if value is None or isinstance(value, (bool, int, float, complex)):
        state[1] += 32
        return
    if isinstance(value, (bytes, bytearray)):
        # pickle-5 keeps plain bytes/bytearray IN-BAND (only
        # buffer-protocol reducers like ndarray export out-of-band), so
        # they are inband payload: a large pure-bytes value must take
        # the classic path, not claim a zero-copy landing
        state[1] += len(value) + 64
        return
    if isinstance(value, memoryview):
        raise _EstimateMiss("raw memoryview")  # unpicklable either way
    if isinstance(value, str):
        if len(value) > 256 * 1024:
            raise _EstimateMiss("large str payload")  # utf-8 length unknown
        state[1] += 4 * len(value) + 64
        return
    tname = type(value).__module__ + "." + type(value).__name__
    if tname == "numpy.ndarray":
        # contiguous arrays export one out-of-band buffer of nbytes;
        # non-contiguous ones pickle an nbytes-sized contiguous copy
        # in-band — either way nbytes (+ dtype/shape overhead) bounds it
        if value.dtype.hasobject:
            raise _EstimateMiss("object-dtype array")
        if value.flags.c_contiguous or value.flags.f_contiguous:
            state[0] += value.nbytes
        else:
            state[1] += value.nbytes
        state[1] += 256
        return
    if isinstance(value, (list, tuple, set, frozenset)):
        state[1] += 64
        for el in value:
            _estimate_walk(el, state, depth + 1)
        return
    if isinstance(value, dict) and type(value) is dict:
        state[1] += 64
        for k, v in value.items():
            _estimate_walk(k, state, depth + 1)
            _estimate_walk(v, state, depth + 1)
        return
    raise _EstimateMiss(f"unestimable type {tname}")


def estimate_flat_size(value: Any) -> tuple[int, int] | None:
    """``(reserve, floor)`` bounds on the flat reserve-then-write encoding
    of ``value`` — ``reserve`` is the upper bound to reserve in the arena,
    ``floor`` (the raw buffer-protocol payload) is a LOWER bound of the
    exact flat size, which is what size-threshold decisions (inline vs
    plasma) must compare against: deciding on the upper bound would
    reclassify at-threshold values.  None when the value's shape is not
    one the estimator understands OR its payload is not buffer-dominated
    (zero-copy put only pays off when most bytes land out-of-band;
    inband-heavy values keep the classic path, whose single memcpy IS
    their pickle cost)."""
    state = [0, 0, 0]  # buffer_bytes, inband_bytes_upper, nodes
    try:
        _estimate_walk(value, state, 0)
    except (_EstimateMiss, RecursionError):
        return None
    buf_b, inband_b, _ = state
    if buf_b < 3 * inband_b:
        return None  # not buffer-dominated
    return 4 + ZC_HEADER_RESERVE + buf_b + inband_b + 16 * 1024, buf_b


_gather_pool = None
_gather_pool_threads = 0


def _gather_executor(threads: int):
    global _gather_pool, _gather_pool_threads
    if _gather_pool is None or _gather_pool_threads < threads:
        import concurrent.futures
        if _gather_pool is not None:
            _gather_pool.shutdown(wait=False)
        _gather_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=threads, thread_name_prefix="put-gather")
        _gather_pool_threads = threads
    return _gather_pool


def gather_threads() -> int:
    """Resolved gather-lane count (config put_gather_threads; 0 = auto)."""
    from .config import get_config
    n = get_config().put_gather_threads
    if n <= 0:
        n = min(8, os.cpu_count() or 1)
    return max(1, n)


def _land_buffer(dst: memoryview, src: memoryview, threads: int) -> None:
    """Land one out-of-band buffer into its arena slice — striped across
    the gather pool when large (numpy copyto releases the GIL per stripe,
    so the stripes run at aggregate memory bandwidth), serial otherwise.
    memoryview gather-write only: no intermediate bytes object exists on
    this path (the hot-path lint pins that)."""
    _land_batch([(dst, src)], threads)


def _land_batch(pairs: list, threads: int) -> None:
    """Land MANY (dst_view, src_view) buffers in one parallel wave: all
    stripes of all buffers go to the gather pool together, so distinct
    buffers overlap each other as well as their own stripes — landing
    N medium arrays costs one wave, not N sequential ones."""
    small, jobs = [], []
    np = None
    if threads > 1 and any(src.nbytes >= _GATHER_MIN_BUF
                           for _d, src in pairs):
        try:
            import numpy as np  # noqa: F811 — optional fast path
        except ImportError:
            np = None
    for dst, src in pairs:
        n = src.nbytes
        k = max(1, min(threads, n // _GATHER_MIN_STRIPE)) \
            if np is not None and n >= _GATHER_MIN_BUF else 1
        if k == 1:
            small.append((dst, src, n))
            continue
        d = np.frombuffer(dst, np.uint8, count=n)
        s = np.frombuffer(src, np.uint8, count=n)
        step = -(-n // k)
        for i in range(k):
            jobs.append((d, s, i * step, min(n, i * step + step)))

    def _stripe(job):
        d, s, a, b = job
        np.copyto(d[a:b], s[a:b])

    fut = (_gather_executor(threads).map(_stripe, jobs) if jobs else None)
    for dst, src, n in small:   # the dumping thread lands the small ones
        dst[:n] = src
    if fut is not None:
        list(fut)


class _ZcWriter:
    """The reserve-then-write landing state over one reserved arena view.

    The pickler writes its inband stream through :meth:`write` (buffered:
    the stream interleaves with buffer callbacks, and its final arena
    offset — after the last buffer — is only known once the dump ends);
    out-of-band buffers are assigned sequential arena offsets up front by
    :meth:`land` and copied straight source -> arena.  ``finish``
    appends the inband stream and backpatches the padded header."""

    __slots__ = ("view", "limit", "cursor", "sizes", "inband",
                 "payload_bytes", "threads", "deferred")

    def __init__(self, view: memoryview, threads: int):
        self.view = view
        self.limit = view.nbytes
        self.cursor = 4 + ZC_HEADER_RESERVE
        self.sizes: list[int] = []          # buffer sizes, in land order
        self.inband = io.BytesIO()
        self.payload_bytes = 0
        self.threads = threads
        #: large buffers deferred to one batched parallel landing: the
        #: pool then overlaps DISTINCT buffers too, not just stripes
        self.deferred: list[tuple[int, memoryview]] = []

    def write(self, b) -> int:
        return self.inband.write(b)

    def land(self, pb: pickle.PickleBuffer) -> bool:
        """pickle-5 buffer_callback: claim the next arena range for this
        buffer.  Returns False (out-of-band) on success; raises on a
        reservation overflow so the dump aborts immediately."""
        try:
            raw = pb.raw()
        except Exception:
            return True  # non-contiguous: let pickle serialize it in-band
        if raw.format != "B" or raw.ndim != 1:
            raw = raw.cast("B")
        n = raw.nbytes
        if self.cursor + n > self.limit:
            raise _EstimateMiss(f"buffer overflows reservation "
                                f"({self.cursor + n} > {self.limit})")
        if len(self.sizes) >= 256:
            raise _EstimateMiss("too many buffers for the header region")
        off = self.cursor
        self.cursor += n
        self.sizes.append(n)
        self.payload_bytes += n
        if n >= _GATHER_MIN_BUF and self.threads > 1:
            self.deferred.append((off, raw))
        else:
            self.view[off:off + n] = raw
        return False

    def finish(self, contained_refs: list) -> SerializedInto:
        inband = self.inband.getbuffer()
        ilen = inband.nbytes
        if self.cursor + ilen > self.limit:
            raise _EstimateMiss("inband stream overflows reservation")
        header = pickle.dumps({"sizes": [ilen] + self.sizes}, protocol=5)
        if 4 + len(header) > 4 + ZC_HEADER_RESERVE:
            raise _EstimateMiss("header overflows its reserved region")
        if self.deferred:
            _land_batch([(self.view[off:off + raw.nbytes], raw)
                         for off, raw in self.deferred], self.threads)
        self.view[self.cursor:self.cursor + ilen] = inband
        used = self.cursor + ilen
        self.view[0:4] = ZC_HEADER_RESERVE.to_bytes(4, "big")
        self.view[4:4 + len(header)] = header
        pad_end = 4 + ZC_HEADER_RESERVE
        self.view[4 + len(header):pad_end] = \
            b"\x00" * (pad_end - 4 - len(header))  # inert past pickle STOP
        _stats().record("object_write_direct", self.payload_bytes + ilen)
        return SerializedInto(used, self.payload_bytes, contained_refs,
                              len(self.sizes))


def serialize_into(value: Any, view: memoryview) -> SerializedInto | None:
    """Serialize ``value`` DIRECTLY into the reserved arena ``view``
    (reserve-then-write; see the module section comment).  Returns the
    landing metadata, or None on a size-estimate miss — the caller falls
    back to the classic serialize-then-copy path; nothing useful is in
    ``view`` after a miss."""
    w = _ZcWriter(view, gather_threads())
    try:
        p = _RefPickler(w, buffer_callback=w.land)
        p.dump(value)
        return w.finish(p.contained)
    except _EstimateMiss:
        return None


def _attach_lease(buffers: list, lease) -> list:
    """Wrap raw store views in lease-carrying buffer exporters.

    The exporter must be the object the view chain's ROOT keeps alive, and
    it must not be an ndarray: numpy collapses ndarray base chains (a view
    of a view points at the ultimate owner), so a lease hung on an
    intermediate array is dropped the moment numpy re-wraps the buffer.  A
    ctypes array ``from_buffer`` over the mapping survives as the root
    memoryview's ``obj`` for every downstream view, releasing the lease —
    and with it the store pin — exactly when the LAST deserialized view
    dies, by plain refcounting.  The array type is built with ``type()``
    rather than ``c_char * n`` so it dies with the instance instead of
    accumulating in ctypes' permanent per-length type cache.  Views are
    handed out READONLY: they alias shared (possibly same-host-broadcast)
    store pages."""
    import ctypes
    wrapped = []
    for b in buffers:
        mv = memoryview(b)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        arr_t = type("_LeasedExport", (ctypes.Array,),
                     {"_type_": ctypes.c_char, "_length_": len(mv)})
        exporter = arr_t.from_buffer(mv)
        exporter._pin_lease = lease
        wrapped.append(memoryview(exporter).toreadonly())
    return wrapped


def deserialize(so: SerializedObject, pin_lease=None) -> Any:
    """Deserialize; with ``pin_lease`` the out-of-band buffers stay
    ZERO-COPY views over the (pinned) store mapping, and the pin releases
    when the last reconstructed view is garbage-collected.  Without a
    lease, buffers are consumed as-is (inline records, copied fetches)."""
    buffers = so.buffers
    if pin_lease is not None:
        if buffers:
            buffers = _attach_lease(buffers, pin_lease)
        else:
            # Whole value lives in the (copied) inband stream: nothing will
            # ever reference the mapping — release the pin now.
            pin_lease.release()
    return _RefUnpickler(io.BytesIO(so.inband), buffers=buffers).load()


def dumps(value: Any) -> bytes:
    """One-shot flat serialize (for RPC payloads, function registry)."""
    return serialize(value).to_bytes()


def loads(data) -> Any:
    return deserialize(SerializedObject.from_buffer(data))


_NONE_BYTES: bytes | None = None


def none_bytes() -> bytes:
    """Canonical flat serialization of ``None`` — the single most common task
    result.  Producers emit this exact blob and consumers match it by bytes
    equality, skipping a pickler round trip on both sides."""
    global _NONE_BYTES
    if _NONE_BYTES is None:
        _NONE_BYTES = serialize(None).to_bytes()
    return _NONE_BYTES


def dumps_function(fn) -> bytes:
    return dumps_function_with_refs(fn)[0]


def dumps_function_with_refs(fn) -> Tuple[bytes, list]:
    """Serialize a function/class AND report the ObjectRefs captured in its
    closure/defaults.  Captured refs are real data dependencies — the
    submitter must treat them like argument refs (pin them, and never batch
    the consumer with the producer), or a closure-captured ref can deadlock
    an intra-batch dependency."""
    sio = io.BytesIO()
    p = _RefPickler(sio, buffer_callback=None)
    p.dump(fn)
    return sio.getvalue(), p.contained


def loads_function(data: bytes):
    # _RefUnpickler: function blobs may contain persistent-id'd ObjectRefs
    # (closure captures) recorded by dumps_function_with_refs.
    return _RefUnpickler(io.BytesIO(data)).load()
