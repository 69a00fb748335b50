"""Object-plane "explain" layer: lifecycle flight recorder vocabulary,
copy-amplification ledger, and the single kill switch for every
``raytpu_object_*`` / ``raytpu_mem_*`` series.

The data plane moves bytes; this module makes the moves *inspectable*
instead of inferred from offline profiles (PROFILE_CORE.md,
BENCH_BROADCAST.json are snapshots — nobody could answer "where did this
object's bytes get copied, spilled, or stuck" from the runtime):

* :class:`ObjectEvent` — the closed set of object lifecycle transitions.
  Stamps ride a dedicated bounded ring in the GCS (``add_object_events`` /
  ``get_object_events`` / ``explain_object`` — the PR-10 ``sched_decision``
  ring pattern), flushed in batches by node agents and owners, and are
  TRANSITIONS ONLY: one event per state change, never per read.
* Copy-amplification ledger — every path that moves object payload bytes
  (put, get, promote, transfer land, spill, restore, re-home) declares its
  COPY CLASS here (:data:`COPY_CLASS`) and accounts its bytes into
  ``raytpu_object_bytes_total{path,copies}`` via a precomputed ``KEY_*``
  tag key.  ``sum(copies>0) / sum(all)`` per path is the headline
  regression gauge the zero-copy-put work (ROADMAP item 4) must drive
  down.  An AST lint (tests/test_metric_naming.py) pins call sites to the
  ``KEY_*`` constants, so a new byte-moving path cannot ship without
  declaring what it copies.
* ``object_metrics_enabled`` — the one kill switch (PR-2 registry
  discipline): off, hot paths pay a single cached boolean check, no
  ``raytpu_object_*``/``raytpu_mem_*`` series render, and no ring writes
  happen anywhere (agent buffers, GCS ring, transfer ring).

Reference: the Ray paper (1712.05889) makes per-object lineage + location
metadata the backbone of its object store; Podracer (2104.06272) argues
the control/data split only pays off when the data path is measurable.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .config import get_config


class ObjectEvent:
    """Closed vocabulary of object lifecycle transitions.

    These are EVENT FIELD values — the set bounds what the flight
    recorder can say, so new transitions are added here (and to the
    lifecycle diagram in ARCHITECTURE.md), never inlined at a call site.
    """

    #: owner allocated a shm segment for the object (large put / task
    #: result landing in plasma)
    CREATED = "CREATED"
    #: value stored inline in the owner's in-process memory store (small
    #: objects; travels inside RPC replies, never touches the shm store)
    INLINED = "INLINED"
    #: store entry sealed — bytes complete and immutable from here on
    SEALED = "SEALED"
    #: first read pin granted on a node's copy (0 -> 1 transition only;
    #: further pins on an already-pinned copy stamp nothing)
    PINNED = "PINNED"
    #: evicted copy written out, ``tier`` = local | external
    SPILLED = "SPILLED"
    #: spilled copy read back into a node's store, ``tier`` says whence
    RESTORED = "RESTORED"
    #: a node landed a copy it did not have (chunked pull or same-host
    #: zero-copy proxy attach; ``zero_copy`` marks the proxy case)
    TRANSFERRED = "TRANSFERRED"
    #: a draining node pushed its sole copy elsewhere (external tier or a
    #: live peer) before disappearing
    RE_HOMED = "RE_HOMED"
    #: owner-initiated free landed while reader pins were live — deletion
    #: deferred until the last pin releases
    FREE_DEFERRED = "FREE_DEFERRED"
    #: object deleted (owner refcount zero / store free completed)
    FREED = "FREED"

    ALL = frozenset({
        "CREATED", "INLINED", "SEALED", "PINNED", "SPILLED", "RESTORED",
        "TRANSFERRED", "RE_HOMED", "FREE_DEFERRED", "FREED",
    })


# ------------------------------------------------------------- kill switch

_enabled_cache: tuple = (None, False)


def enabled() -> bool:
    """One cached boolean per Config identity — the hot-path check."""
    global _enabled_cache
    cfg = get_config()
    if _enabled_cache[0] is not cfg:
        _enabled_cache = (cfg, bool(getattr(cfg, "object_metrics_enabled",
                                            False)))
    return _enabled_cache[1]


# --------------------------------------------------- copy-amplification ledger
#
# Copy classes: how many times a path copies the payload bytes it moves.
# "0" — zero-copy (mmap attach / pinned view / proxy), "1" — exactly one
# memcpy (serialize-into-arena, spill write, chunk landing), "n" — more
# than one (scratch-buffer verify paths, peer replication).  The class is
# part of the PATH DECLARATION below, not chosen at the call site: the
# ledger is the contract the zero-copy rewrite regresses against.

COPY_ZERO = "0"
COPY_ONE = "1"
COPY_N = "n"

#: path -> declared copy class.  EVERY byte-moving path in the object
#: plane appears here; the AST lint pins ledger call sites to the KEY_*
#: constants derived from this table, so adding a path means declaring
#: its class first.
COPY_CLASS: Dict[str, str] = {
    # classic/fallback put: owner serialize -> one write_into memcpy into
    # the arena mapping (the single put memcpy PROFILE_CORE round 6
    # measured at ~78% of the box memcpy ceiling).  The DEFAULT large-put
    # path is now the reserve-then-write zero-copy put, declared by
    # COPY_CLASS_ZC below and recorded under KEY_PUT_ZC — this row keeps
    # the 1-copy class of the estimate-miss / kill-switch fallback.
    "put": COPY_ONE,
    # small value -> owner memory store (one encode into the inline blob)
    "put_inline": COPY_ONE,
    # same-host large get over a pinned store mapping (plasma contract)
    "get": COPY_ZERO,
    # unpinned-fallback get: copy out + store_verify
    "get_copy": COPY_ONE,
    # inline->shm promotion of a borrowed small result
    "promote": COPY_ONE,
    # chunked pull landing (readinto the destination segment; the socket
    # read is the one copy on this side)
    "transfer_land": COPY_ONE,
    # same-host zero-copy proxy attach (bytes never move)
    "transfer_proxy": COPY_ZERO,
    # evicted entry written to the local disk / external tier
    "spill": COPY_ONE,
    # spilled copy read back into the store
    "restore": COPY_ONE,
    # drain-path re-home: read out of the store + write to tier/peer
    "re_home": COPY_N,
}

#: Alternate declared classes: a path whose DEFAULT pipeline differs from
#: its fallback declares both (same path label, different ``copies`` tag —
#: the ledger separates them by construction).  "put" class 0 is the
#: reserve-then-write zero-copy put (core/serialization.py
#: ``serialize_into``): the pickler targets the reserved arena range
#: directly, so no payload byte is ever materialized outside its source
#: and the store — the plasma/Arrow zero-copy-put convention.  Its
#: fallback (estimate miss, ``zero_copy_put_enabled=False``) stays the
#: 1-copy class above, pinned separately by tests/test_copy_discipline.py.
COPY_CLASS_ZC: Dict[str, str] = {
    "put": COPY_ZERO,
}

#: precomputed sorted tag-key tuples (Counter.inc_key discipline): one per
#: declared path, named KEY_<PATH>.  Call sites MUST use these constants —
#: the lint rejects inline tuples/strings (an undeclared path would be an
#: unbounded label value and an unaudited copy).
KEY_PUT = (("copies", COPY_CLASS["put"]), ("path", "put"))
KEY_PUT_ZC = (("copies", COPY_CLASS_ZC["put"]), ("path", "put"))
KEY_PUT_INLINE = (("copies", COPY_CLASS["put_inline"]), ("path", "put_inline"))
KEY_GET = (("copies", COPY_CLASS["get"]), ("path", "get"))
KEY_GET_COPY = (("copies", COPY_CLASS["get_copy"]), ("path", "get_copy"))
KEY_PROMOTE = (("copies", COPY_CLASS["promote"]), ("path", "promote"))
KEY_TRANSFER_LAND = (("copies", COPY_CLASS["transfer_land"]),
                     ("path", "transfer_land"))
KEY_TRANSFER_PROXY = (("copies", COPY_CLASS["transfer_proxy"]),
                      ("path", "transfer_proxy"))
KEY_SPILL = (("copies", COPY_CLASS["spill"]), ("path", "spill"))
KEY_RESTORE = (("copies", COPY_CLASS["restore"]), ("path", "restore"))
KEY_RE_HOME = (("copies", COPY_CLASS["re_home"]), ("path", "re_home"))


def _build_object_metrics():
    from ray_tpu_torch.util.metrics import Counter
    return {
        "bytes": Counter(
            "raytpu_object_bytes_total",
            "object payload bytes moved by the data plane, by path and "
            "declared copy class (bytes_copied/bytes_moved per path is "
            "the copy-amplification gauge)",
            tag_keys=("path", "copies")),
    }


_object_metrics_get = None


def object_metrics() -> Optional[Dict[str, Any]]:
    global _object_metrics_get
    if not enabled():
        return None
    if _object_metrics_get is None:
        # deferred to first call: importing util.metrics at module import
        # time re-enters the ray_tpu_torch package init (circular import)
        from ray_tpu_torch.util.metrics import lazy
        _object_metrics_get = lazy(_build_object_metrics)
    return _object_metrics_get()


def ledger_record(key: tuple, nbytes: int) -> None:
    """Account ``nbytes`` moved through the path ``key`` (a KEY_*
    constant above — lint-enforced).  One dict-free counter bump; no-op
    when the kill switch is off."""
    m = object_metrics()
    if m is not None:
        m["bytes"].inc_key(key, nbytes)


def copy_amplification(values: Dict[tuple, float]) -> Optional[float]:
    """``bytes_copied / bytes_moved`` over a ``raytpu_object_bytes_total``
    values snapshot ({sorted-tag-key-tuple: bytes}).  Copy class "n"
    weighs 2 (a lower bound — the class means "more than one").  None
    when nothing moved."""
    weight = {COPY_ZERO: 0.0, COPY_ONE: 1.0, COPY_N: 2.0}
    moved = copied = 0.0
    for key, v in values.items():
        tags = dict(key)
        moved += v
        copied += weight.get(tags.get("copies", COPY_ONE), 1.0) * v
    if moved <= 0:
        return None
    return copied / moved
