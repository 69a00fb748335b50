"""TaskSpec template cache — the submission hot path's serialization plane.

A process submitting the same function (or actor method) thousands of times
re-pickles the same invariant spec fields — function descriptor, options,
resources, runtime-env — on every call, and the executor re-unpickles them.
This module splits a :class:`~ray_tpu_torch.core.common.TaskSpec` into

* a **template**: every field invariant across calls of one
  ``(function, options)`` pair (or one actor method), pickled ONCE and
  addressed by a 16-byte content hash; and
* a **delta**: the per-call fields (``task_id``, ``args``, ``retry_count``,
  ``seq_no``, ``trace_ctx``) that ride every submission.

The sender keeps a bounded LRU of encoded templates keyed by the spec's
template key and tracks, per RPC connection, which template hashes the peer
has already received — so steady-state submissions wire-encode only the
hash plus the delta.  The receiver interns decoded templates by hash in a
bounded LRU of prototype specs; decoding a warm submission is a generated
field-copy clone plus six volatile stores, no pickling of the invariant
portion at all (TaskSpec is ``__slots__``-based, so clones are slot copies,
not ``__dict__`` copies).

**Packed batch frames** (the native submission plane): a warm push batch
whose specs are all template-cacheable wire-encodes into ONE flat binary
blob (``pack_specs``) instead of a list of per-spec tuples — the RPC
layer's pickle then sees a single bytes object (one memcpy) rather than
N nested tuples.  Each record is a fixed 52-byte header —

    thash(16) | task_id(16) | retry u32 | seq u64 | args_len u32
    | trace_len u32

— followed by the args blob and the (rare, pickled) trace context.  The
packer/scanner pair lives in ``ray_tpu_torch/native/submit_plane.cpp`` (plain C
ABI via ctypes, same toolchain as shm_pool.cpp); a pure-Python
struct-based fallback produces byte-identical frames when the .so is
absent or ``submit_plane_native_enabled`` is off for the C path.  The
per-template wire-invariant header bytes (the 16-byte content hash that
prefixes every record of that template) are precomputed once per
(function, options) pair and cached in the sender LRU entry.

Redefinition is handled by content addressing: a changed function or option
set produces a different template key AND hash, and stale entries age out
of both LRUs (eviction-on-redefine).  A receiver that evicted a template a
sender still believes is delivered raises :class:`SpecCacheMiss`; the
sender forgets its delivered-set for that connection and resends the full
template (the handler raised before executing anything, so the resend is
safe).

Reference analogue: the reference ships functions by content hash through
the GCS function table (``python/ray/_private/function_manager.py``) for
exactly this reason; here the same interning is applied to the whole
invariant spec portion on the direct task-transport path.
"""

from __future__ import annotations

import collections
import hashlib
import pickle
import struct
import threading
import time
from typing import List, Optional, Tuple

from .common import TEMPLATE_FIELDS, TaskSpec, copy_template_into
from .common import VOLATILE_FIELDS  # noqa: F401  (re-export, long-time home)
from .config import get_config
from .ids import TaskID

#: wire tag for a template-cached spec (anything else decodes as-is)
_WIRE_TAG = "tspec"

#: wire tag for a packed batch frame (``("sp1", blob, templates)``)
_PACK_TAG = "sp1"

#: packed-frame layout: 4-byte magic + u32 record count, then per record a
#: fixed header ``thash(16) task_id(16) retry(u32) seq(u64) args_len(u32)
#: trace_len(u32)`` followed by the variable payloads.
_PACK_MAGIC = b"SP01"
_PACK_HDR = struct.Struct("<IQII")     # retry, seq, args_len, trace_len
_REC_FIXED = 32 + _PACK_HDR.size       # 52 bytes

#: args blobs at least this large ride as out-of-band pickle-5 buffers in
#: the wire delta (same threshold as the RPC layer's vectored frames).
#: Packed frames keep the same discipline: a batch containing an args blob
#: this large falls back to per-spec tuples so the big payload stays OOB
#: instead of being copied through the packed frame.
from .rpc import _VEC_MIN_BUF as _OOB_ARGS_MIN


class SpecCacheMiss(Exception):
    """The receiver does not hold the template a hash-only submission
    references (its LRU evicted it, or a reordered first frame).  Raised
    BEFORE any task is dispatched, so the sender may safely resend the
    batch with the full template included."""


def _template_key(spec: TaskSpec) -> tuple:
    """Cheap hashable identity of the spec's invariant portion.  Must cover
    every non-volatile field that can differ between two specs a process
    submits — a collision here would run a task under another template's
    options."""
    return (
        spec.is_actor_task,
        spec.fn_id,
        spec.actor_id.binary() if spec.actor_id is not None else None,
        spec.actor_method,
        spec.name,
        spec.num_returns,
        tuple(sorted(spec.resources.items())) if spec.resources else (),
        repr(spec.scheduling_strategy),
        spec.max_retries,
        spec.retry_exceptions,
        repr(sorted(spec.runtime_env.items())) if spec.runtime_env else None,
        spec.generator_backpressure,
        spec.owner,
        spec.job_id.binary(),
        # constant defaults on task/method specs today, but covered so a
        # future path that sets them cannot collide two templates
        spec.max_restarts, spec.max_task_retries, spec.max_concurrency,
        spec.is_async_actor, spec.actor_name, spec.namespace, spec.lifetime,
    )


def _template_fields(spec: TaskSpec) -> dict:
    return {n: getattr(spec, n) for n in TEMPLATE_FIELDS}


# --------------------------------------------------------------- packing
#
# The pure-Python packer/scanner below and the C pair in
# native/submit_plane.cpp MUST produce byte-identical frames — the
# round-trip test in tests/test_submit_plane_native.py pins this.

def _py_pack(recs: List[tuple]) -> bytearray:
    """recs: [(thash, task_id_bin, retry, seq, args, trace_blob)]."""
    total = 8
    for _h, _t, _r, _s, a, tr in recs:
        total += _REC_FIXED + len(a) + len(tr)
    buf = bytearray(total)
    buf[0:4] = _PACK_MAGIC
    struct.pack_into("<I", buf, 4, len(recs))
    off = 8
    pack_hdr = _PACK_HDR.pack_into
    for h, t, r, s, a, tr in recs:
        buf[off:off + 16] = h
        buf[off + 16:off + 32] = t
        pack_hdr(buf, off + 32, r, s, len(a), len(tr))
        off += _REC_FIXED
        na = len(a)
        buf[off:off + na] = a
        off += na
        if tr:
            buf[off:off + len(tr)] = tr
            off += len(tr)
    return buf


def _native_pack(recs: List[tuple]) -> Optional[bytearray]:
    """Pack via the C extension; None when the .so is unavailable (caller
    uses the byte-identical pure-Python path)."""
    from ..native import load_submit_plane
    lib = load_submit_plane()
    if lib is None:
        return None
    import ctypes
    n = len(recs)
    total = 8
    for _h, _t, _r, _s, a, tr in recs:
        total += _REC_FIXED + len(a) + len(tr)
    buf = bytearray(total)
    hashes = b"".join(r[0] for r in recs)
    tids = b"".join(r[1] for r in recs)
    retries = (ctypes.c_uint32 * n)(*[r[2] for r in recs])
    seqs = (ctypes.c_uint64 * n)(*[r[3] for r in recs])
    args_ptrs = (ctypes.c_char_p * n)(*[r[4] for r in recs])
    args_lens = (ctypes.c_uint32 * n)(*[len(r[4]) for r in recs])
    trace_ptrs = (ctypes.c_char_p * n)(*[r[5] or None for r in recs])
    trace_lens = (ctypes.c_uint32 * n)(*[len(r[5]) for r in recs])
    out = (ctypes.c_char * total).from_buffer(buf)
    wrote = lib.sp_pack(out, total, n, hashes, tids, retries, seqs,
                        args_ptrs, args_lens, trace_ptrs, trace_lens)
    if wrote != total:
        return None
    return buf


def pack_specs(recs: List[tuple]) -> bytearray:
    """One flat frame for a warm batch — C when available and enabled,
    byte-identical pure Python otherwise."""
    if get_config().submit_plane_native_enabled:
        out = _native_pack(recs)
        if out is not None:
            return out
    return _py_pack(recs)


def unpack_specs(blob) -> List[tuple]:
    """-> [(thash, task_id_bin, retry, seq, args_bytes, trace_blob)].
    Scans with the C extension when present (offset/length arrays filled
    natively, Python only slices); falls back to the struct scanner."""
    mv = memoryview(blob)
    if len(mv) < 8 or bytes(mv[0:4]) != _PACK_MAGIC:
        raise SpecCacheMiss("malformed packed spec frame (bad magic)")
    (n,) = struct.unpack_from("<I", mv, 4)
    out: List[tuple] = []
    offs = _native_scan(mv, n)
    if offs is not None:
        for off, retry, seq, alen, tlen in offs:
            h = bytes(mv[off:off + 16])
            tid = bytes(mv[off + 16:off + 32])
            p = off + _REC_FIXED
            args = bytes(mv[p:p + alen])
            trace = bytes(mv[p + alen:p + alen + tlen]) if tlen else b""
            out.append((h, tid, retry, seq, args, trace))
        return out
    off = 8
    end = len(mv)
    for _ in range(n):
        if off + _REC_FIXED > end:
            raise SpecCacheMiss("truncated packed spec frame")
        h = bytes(mv[off:off + 16])
        tid = bytes(mv[off + 16:off + 32])
        retry, seq, alen, tlen = _PACK_HDR.unpack_from(mv, off + 32)
        off += _REC_FIXED
        if off + alen + tlen > end:
            raise SpecCacheMiss("truncated packed spec frame")
        args = bytes(mv[off:off + alen])
        off += alen
        trace = bytes(mv[off:off + tlen]) if tlen else b""
        off += tlen
        out.append((h, tid, retry, seq, args, trace))
    return out


def _native_scan(mv: memoryview, n: int):
    """C record scan -> [(rec_off, retry, seq, args_len, trace_len)], or
    None to use the pure-Python scanner."""
    if not get_config().submit_plane_native_enabled or n == 0:
        return None
    from ..native import load_submit_plane
    lib = load_submit_plane()
    if lib is None:
        return None
    import ctypes
    if mv.readonly:
        src = (ctypes.c_char * len(mv)).from_buffer_copy(mv)
    else:
        src = (ctypes.c_char * len(mv)).from_buffer(mv)
    rec_offs = (ctypes.c_uint64 * n)()
    retries = (ctypes.c_uint32 * n)()
    seqs = (ctypes.c_uint64 * n)()
    args_lens = (ctypes.c_uint32 * n)()
    trace_lens = (ctypes.c_uint32 * n)()
    got = lib.sp_scan(src, len(mv), n, rec_offs, retries, seqs,
                      args_lens, trace_lens)
    if got != n:
        raise SpecCacheMiss("truncated packed spec frame")
    return [(rec_offs[i], retries[i], seqs[i], args_lens[i], trace_lens[i])
            for i in range(n)]


class SpecEncoder:
    """Sender side: one per CoreWorker.  ``encode`` returns either the raw
    TaskSpec (cache disabled / actor-creation specs) or the compact wire
    tuple, including the template blob only when this connection has not
    seen the hash yet.  ``encode_batch`` returns the packed frame for a
    fully warm-packable batch, or None (caller encodes per spec)."""

    def __init__(self):
        # template key -> (hash, blob); LRU by move-to-end on hit.  The
        # hash doubles as the packed record's precomputed wire-invariant
        # header bytes — computed once per (function, options) pair.  The
        # lock covers the OrderedDict relinks: with owner_serialize_threads
        # the encoder runs on pool threads concurrently, and move_to_end/
        # popitem are not atomic under the GIL.
        self._lru: "collections.OrderedDict[tuple, Tuple[bytes, bytes]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def _template_for(self, spec: TaskSpec) -> Tuple[bytes, bytes]:
        key = _template_key(spec)
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                return hit
        blob = pickle.dumps(_template_fields(spec), protocol=5)
        thash = hashlib.blake2b(blob, digest_size=16).digest()
        with self._lock:
            self._lru[key] = (thash, blob)
            cap = max(get_config().spec_cache_max_entries, 8)
            while len(self._lru) > cap:
                self._lru.popitem(last=False)
        return thash, blob

    @staticmethod
    def _delivered_set(client) -> set:
        """Hashes the peer has received ON THE CURRENT CONNECTION.  Keyed
        by writer identity: a reconnect installs a fresh writer, and the
        receiver interns process-globally, so stale entries only ever cause
        a redundant template resend, never a miss."""
        w = client._writer
        rec = getattr(client, "_raytpu_tmpl_sent", None)
        if rec is None or rec[0] is not w:
            rec = client._raytpu_tmpl_sent = (w, set())
        return rec[1]

    @staticmethod
    def forget_client(client) -> None:
        """Drop the delivered-set after a :class:`SpecCacheMiss` so the
        next encode resends full templates."""
        client._raytpu_tmpl_sent = None

    def encode(self, client, spec: TaskSpec):
        if not get_config().spec_cache_enabled or spec.is_actor_creation:
            return spec
        thash, blob = self._template_for(spec)
        sent = self._delivered_set(client)
        if thash in sent:
            tblob = None
        else:
            tblob = blob
            sent.add(thash)
        args = spec.args
        if isinstance(args, bytes) and len(args) >= _OOB_ARGS_MIN:
            args = pickle.PickleBuffer(args)
        return (_WIRE_TAG, thash, tblob, spec.task_id, args,
                spec.retry_count, spec.seq_no, spec.trace_ctx)

    def encode_batch(self, client, specs: List[TaskSpec]):
        """Packed-frame encode for a warm batch: ``("sp1", blob,
        templates)`` where ``templates`` carries (hash, blob) pairs this
        connection has not seen.  None when any spec is ineligible (cache
        disabled, actor creation, oversized args that must ride OOB, or a
        non-bytes args payload) — the caller falls back to per-spec
        ``encode``, keeping frame order identical either way."""
        cfg = get_config()
        if not (cfg.submit_plane_native_enabled and cfg.spec_cache_enabled):
            return None
        for s in specs:
            if (s.is_actor_creation or not isinstance(s.args, bytes)
                    or len(s.args) >= _OOB_ARGS_MIN):
                return None
        sent = self._delivered_set(client)
        templates: List[Tuple[bytes, bytes]] = []
        recs: List[tuple] = []
        for s in specs:
            thash, blob = self._template_for(s)
            if thash not in sent:
                sent.add(thash)
                templates.append((thash, blob))
            trace = pickle.dumps(s.trace_ctx, protocol=4) \
                if s.trace_ctx is not None else b""
            recs.append((thash, s.task_id.binary(), s.retry_count,
                         s.seq_no, s.args, trace))
        blob = pack_specs(recs)
        wire_blob = pickle.PickleBuffer(bytes(blob)) \
            if len(blob) >= _OOB_ARGS_MIN else bytes(blob)
        return (_PACK_TAG, wire_blob, templates)


class SpecInterner:
    """Receiver side: process-global intern table hash -> prototype spec.
    Decoding clones the prototype (generated slot-field copy) and stores
    the six volatile fields — no pickling of the invariant portion on warm
    submissions."""

    def __init__(self):
        self._lru: "collections.OrderedDict[bytes, TaskSpec]" = \
            collections.OrderedDict()

    def _intern(self, thash: bytes, tblob: bytes) -> TaskSpec:
        proto = TaskSpec.__new__(TaskSpec)
        fields = pickle.loads(tblob)
        for k, v in fields.items():
            setattr(proto, k, v)
        self._lru[thash] = proto
        cap = max(get_config().spec_cache_max_entries, 8)
        while len(self._lru) > cap:
            self._lru.popitem(last=False)
        return proto

    def _proto_for(self, thash: bytes, tblob) -> TaskSpec:
        proto = self._lru.get(thash)
        if proto is None:
            if tblob is None:
                raise SpecCacheMiss(
                    f"unknown spec template {thash.hex()[:16]} "
                    "(receiver cache evicted it?)")
            proto = self._intern(thash, tblob)
        else:
            self._lru.move_to_end(thash)
        return proto

    def _clone(self, proto: TaskSpec, task_id, args, retry_count, seq_no,
               trace_ctx) -> TaskSpec:
        spec = TaskSpec.__new__(TaskSpec)
        copy_template_into(proto, spec)
        spec.task_id = task_id
        spec.args = args if isinstance(args, bytes) else bytes(args)
        spec.retry_count = retry_count
        spec.seq_no = seq_no
        spec.trace_ctx = trace_ctx
        spec.submitted_at = time.time()
        return spec

    def decode(self, wire) -> TaskSpec:
        if isinstance(wire, TaskSpec):
            return wire
        if not (isinstance(wire, tuple) and len(wire) == 8
                and wire[0] == _WIRE_TAG):
            raise TypeError(f"not a task spec wire form: {type(wire)}")
        _tag, thash, tblob, task_id, args, retry_count, seq_no, trace_ctx = \
            wire
        proto = self._proto_for(thash, tblob)
        return self._clone(proto, task_id, args, retry_count, seq_no,
                           trace_ctx)

    def decode_packed(self, wire) -> List[TaskSpec]:
        """Decode a ``("sp1", blob, templates)`` frame.  Templates intern
        first; an unknown record hash then raises :class:`SpecCacheMiss`
        before any spec is acted on (all-or-nothing, same contract as
        ``decode_many``)."""
        _tag, blob, templates = wire
        for thash, tblob in templates:
            if thash not in self._lru:
                self._intern(thash, tblob)
        recs = unpack_specs(blob)
        protos = [self._proto_for(h, None) for
                  (h, _t, _r, _s, _a, _tr) in recs]
        out: List[TaskSpec] = []
        for proto, (_h, tid, retry, seq, args, trace) in zip(protos, recs):
            trace_ctx = pickle.loads(trace) if trace else None
            out.append(self._clone(proto, TaskID(tid), args, retry, seq,
                                   trace_ctx))
        return out


_interner: Optional[SpecInterner] = None


def interner() -> SpecInterner:
    global _interner
    if _interner is None:
        _interner = SpecInterner()
    return _interner


def decode(wire) -> TaskSpec:
    return interner().decode(wire)


def decode_many(wires) -> list:
    """Decode a batch — either a packed ``("sp1", ...)`` frame or a list
    of per-spec wire forms — raising :class:`SpecCacheMiss` before any
    spec is acted on (the all-or-nothing contract the resend path relies
    on)."""
    it = interner()
    if isinstance(wires, tuple) and len(wires) == 3 \
            and wires[0] == _PACK_TAG:
        return it.decode_packed(wires)
    return [it.decode(w) for w in wires]
