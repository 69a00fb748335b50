"""Scheduler "explain" plane: typed pending reasons + sched metrics.

The control plane decides where work goes and why it waits; this module
makes those decisions *inspectable* instead of inferred:

* :class:`PendingReason` — the closed set of reasons a task/actor/PG can
  be in a non-running state.  Reason stamps ride the existing task-event
  plane as ``state="PENDING"`` events carrying ``reason=<constant>``, so
  the timeline, ``state.summarize_tasks()["pending_reasons"]`` and
  ``raytpu explain`` all read the same trail.  Stamps MUST use these
  constants — a lint (tests/test_metric_naming.py) rejects free-form
  strings, which would otherwise become unbounded label values.
* Decision records — ``pick_node``/``pack_bundles`` callers emit one
  structured record per scheduling decision (candidates considered,
  per-node rejection cause, outcome) into a bounded ring in the GCS
  (``add_sched_decisions`` / ``get_sched_decisions`` / ``explain``).
* ``sched_metrics_enabled`` — the single kill switch for every
  ``raytpu_sched_*`` / ``raytpu_loop_*`` / ``raytpu_gcs_*`` series
  (PR-2 registry discipline: off, hot paths pay one boolean check).

Reference: the Ray paper (1712.05889) makes bottom-up scheduling + GCS
the heart of the system and debuggability first-class; Podracer
(2104.06272) demands the control plane stay *provably* cheap — both need
"why is my task pending" answerable from the runtime.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .config import get_config


class PendingReason:
    """Closed vocabulary of non-running-state reasons.

    These are EVENT FIELD values and metric tag values — the set is the
    cardinality bound, so new reasons are added here (and to the state
    machine diagram in ARCHITECTURE.md), never inlined at a call site.
    """

    #: waiting on a dependency that is not schedulable work on this node:
    #: an actor call parked while its actor is still being placed/restarted
    WAITING_DEPS = "WAITING_DEPS"
    #: the owner's waitable admission gate parked the submitting thread
    #: (``submit_inflight_limit`` reached)
    ADMISSION_GATE = "ADMISSION_GATE"
    #: a lease request is parked in some agent's bounded lease queue
    #: (saturated node, request queued behind running leases)
    LEASE_QUEUED = "LEASE_QUEUED"
    #: an agent answered the lease request with a backpressure reply
    #: (queue at ``lease_queue_max_depth``, or the node is draining)
    BACKPRESSURED = "BACKPRESSURED"
    #: no alive node can satisfy the resource shape (infeasible now)
    NO_RESOURCES = "NO_RESOURCES"
    #: the only node(s) that could run it are draining (preemption notice)
    NODE_DRAINING = "NODE_DRAINING"
    #: scheduled against a placement group that is not CREATED yet
    PG_PENDING = "PG_PENDING"
    #: a warm-path submission hit SpecCacheMiss and is resending the full
    #: spec template before dispatch
    SPEC_CACHE_RESEND = "SPEC_CACHE_RESEND"

    ALL = frozenset({
        "WAITING_DEPS", "ADMISSION_GATE", "LEASE_QUEUED", "BACKPRESSURED",
        "NO_RESOURCES", "NODE_DRAINING", "PG_PENDING", "SPEC_CACHE_RESEND",
    })


#: per-node rejection causes a decision record may carry (the bounded
#: vocabulary ``pick_node``/``pack_bundles`` explain dicts use)
REJECT_CAUSES = ("dead", "draining", "resources", "affinity")

#: per-record cap on the {node: cause} rejection map — records live in a
#: 2048-deep ring and ship whole over RPC, so a 1000-node cluster must
#: not put 1000 entries in every one
REJECTED_SAMPLE_MAX = 8


def bound_rejected(rejected: Optional[Dict[str, str]]) -> dict:
    """Shrink a per-node rejection map to record size: a bounded sample
    of ``{node: cause}`` plus, when truncated, a full per-cause count
    rollup (``rejected_counts``) so nothing is silently dropped."""
    rejected = rejected or {}
    if len(rejected) <= REJECTED_SAMPLE_MAX:
        return {"rejected": rejected}
    sample = dict(list(rejected.items())[:REJECTED_SAMPLE_MAX])
    counts: Dict[str, int] = {}
    for cause in rejected.values():
        counts[cause] = counts.get(cause, 0) + 1
    return {"rejected": sample, "rejected_counts": counts,
            "rejected_total": len(rejected)}


def reason_for_no_node(explain: Optional[dict]) -> str:
    """Map a failed pick's explain record to the typed pending reason: a
    ``draining`` rejection cause marks a node that COULD have hosted the
    shape but is routed around by its preemption notice (infeasible
    nodes read ``resources`` whatever their drain state), so its
    presence means the drain is what is blocking the task
    (NODE_DRAINING); otherwise the shape simply has nowhere to run right
    now (NO_RESOURCES)."""
    rejected = (explain or {}).get("rejected") or {}
    if "draining" in set(rejected.values()):
        return PendingReason.NODE_DRAINING
    return PendingReason.NO_RESOURCES


# ------------------------------------------------------------- kill switch

_enabled_cache: tuple = (None, False)


def enabled() -> bool:
    """One cached boolean per Config identity — the hot-path check."""
    global _enabled_cache
    cfg = get_config()
    if _enabled_cache[0] is not cfg:
        _enabled_cache = (cfg, bool(getattr(cfg, "sched_metrics_enabled",
                                            False)))
    return _enabled_cache[1]


# ----------------------------------------------------------- sched metrics
#
# Lazy singletons on the PR-2 registry.  Tag keys are bounded by the
# allowlist lint: process / method / reason / node only.

def _build_owner_metrics():
    from ray_tpu_torch.util.metrics import Histogram
    return {
        "serialize": Histogram(
            "raytpu_sched_owner_serialize_seconds",
            "owner-side spec wire-encoding (pickling) time per push batch"),
        "flush": Histogram(
            "raytpu_sched_owner_flush_seconds",
            "owner-side submit-buffer flush (pool routing + pump) time"),
    }


_owner_metrics_get = None


def owner_metrics() -> Optional[Dict[str, Any]]:
    global _owner_metrics_get
    if not enabled():
        return None
    if _owner_metrics_get is None:
        from ray_tpu_torch.util.metrics import lazy
        _owner_metrics_get = lazy(_build_owner_metrics)
    return _owner_metrics_get()


def _build_backpressure_counter():
    from ray_tpu_torch.util.metrics import Counter
    return Counter(
        "raytpu_sched_backpressure_total",
        "lease requests answered with backpressure, by node and reason",
        tag_keys=("node", "reason"))


_bp_counter_get = None


def backpressure_counter():
    global _bp_counter_get
    if not enabled():
        return None
    if _bp_counter_get is None:
        from ray_tpu_torch.util.metrics import lazy
        _bp_counter_get = lazy(_build_backpressure_counter)
    return _bp_counter_get()


def _build_gcs_handler_hist():
    from ray_tpu_torch.util.metrics import Histogram
    return Histogram(
        "raytpu_gcs_handler_seconds",
        "GCS handler BUSY seconds per invocation (synchronous-segment "
        "time the handler blocked that GCS process's loop; awaits "
        "excluded, so long-polls read near zero).  ``shard`` is bounded "
        "by the process count: \"router\" or the shard index.",
        tag_keys=("method", "shard"))


_gcs_hist_get = None


def gcs_handler_hist():
    global _gcs_hist_get
    if not enabled():
        return None
    if _gcs_hist_get is None:
        from ray_tpu_torch.util.metrics import lazy
        _gcs_hist_get = lazy(_build_gcs_handler_hist)
    return _gcs_hist_get()
