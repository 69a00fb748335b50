"""State API — reference ``python/ray/util/state/api.py`` (``list_actors``
:782, ``list_tasks`` :1014, ``summarize_tasks`` :1375) backed by the GCS
(the reference routes through the dashboard's StateHead aggregator;
here the GCS-equivalent is queried directly over RPC)."""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from ..core.core_worker import global_worker
from ..core.rpc import run_async


def _gcs_call(method: str, **kwargs):
    w = global_worker()
    return run_async(w.gcs.call(method, **kwargs))


def _apply_filters(rows: List[Dict[str, Any]],
                   filters: Optional[List[tuple]]) -> List[Dict[str, Any]]:
    """Filters are (key, predicate, value) with predicate '=' or '!='."""
    for key, pred, value in (filters or []):
        if pred == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif pred == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"unsupported predicate {pred!r}")
    return rows


def list_actors(filters: Optional[List[tuple]] = None,
                limit: int = 1000) -> List[Dict[str, Any]]:
    rows = _gcs_call("list_actors")
    return _apply_filters(rows, filters)[:limit]


def list_nodes(filters: Optional[List[tuple]] = None,
               limit: int = 1000) -> List[Dict[str, Any]]:
    view = _gcs_call("get_cluster_view")
    rows = [{"node_id": nid, **info} for nid, info in view.items()]
    return _apply_filters(rows, filters)[:limit]


def list_tasks(filters: Optional[List[tuple]] = None,
               limit: int = 1000) -> List[Dict[str, Any]]:
    rows = _gcs_call("list_task_events", limit=limit)
    return _apply_filters(rows, filters)[:limit]


def list_jobs(filters: Optional[List[tuple]] = None,
              limit: int = 1000) -> List[Dict[str, Any]]:
    rows = _gcs_call("list_jobs")
    return _apply_filters(rows, filters)[:limit]


def list_placement_groups(filters: Optional[List[tuple]] = None,
                          limit: int = 1000) -> List[Dict[str, Any]]:
    rows = _gcs_call("list_placement_groups")
    return _apply_filters(rows, filters)[:limit]


def list_objects(filters: Optional[List[tuple]] = None,
                 limit: int = 1000) -> List[Dict[str, Any]]:
    """Owner-side view of this process's objects (the reference aggregates
    per-worker ownership tables the same way, scoped cluster-wide)."""
    w = global_worker()
    rows = []
    for oid, rec in list(w.memory_store._values.items())[:limit]:
        rows.append({
            "object_id": oid.hex(),
            "type": type(rec).__name__,
            "size": getattr(rec, "size", None) or (
                len(rec) if isinstance(rec, (bytes, bytearray)) else None),
        })
    return _apply_filters(rows, filters)[:limit]


def _annotate_memory_rows(w, rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Add this process's ``kind: "owner"`` rows for objects no store
    reported (inline values, location records) and annotate every row with
    its refcounts (local/submitted/borrowers) where this worker holds
    references."""
    refs = w.reference_counter.summary()
    seen = {r["object_id"] for r in rows}
    for oid, rec in list(w.memory_store._values.items()):
        if oid.hex() in seen:
            continue
        rows.append({
            "object_id": oid.hex(), "kind": "owner",
            "type": type(rec).__name__,
            "size": getattr(rec, "size", None) or (
                len(rec) if isinstance(rec, (bytes, bytearray)) else None),
        })
    for r in rows:
        r["refs"] = refs.get(r["object_id"])
    return rows


def _sweep_cluster_stores(w, with_stats: bool):
    """ONE pass over every alive node's store: a single GCS view fetch and
    one (optionally stats+) objects round trip per agent, so stats and rows
    come from the same snapshot of each node.  Agents racing shutdown are
    skipped — report what answered.  -> (node_stats, object_rows)."""
    view = _gcs_call("get_cluster_view")
    nodes: Dict[str, Any] = {}
    rows: List[Dict[str, Any]] = []
    for nid, info in view.items():
        if not info.get("alive", True):
            continue
        client = w.agent_clients.get(info["address"])
        try:
            st = run_async(client.call("store_stats")) if with_stats else None
            rows.extend(run_async(client.call("store_objects")))
        except Exception:
            continue
        if st is not None:
            st["address"] = info["address"]
            nodes[nid] = st
    return nodes, rows


def list_memory(filters: Optional[List[tuple]] = None,
                limit: int = 10000) -> List[Dict[str, Any]]:
    """Cluster-wide per-object memory rows (the ``ray memory`` equivalent).

    One row per object copy in any node's plasma-equivalent store —
    size, node, pin count, deferred-free flag, shm path — annotated with
    this process's refcounts (local/submitted/borrowers) where it holds
    references.  Objects only this worker knows about (inline values,
    location records) get a ``kind: "owner"`` row so small objects are
    not invisible to the report."""
    w = global_worker()
    _, rows = _sweep_cluster_stores(w, with_stats=False)
    return _apply_filters(_annotate_memory_rows(w, rows), filters)[:limit]


def memory_summary() -> Dict[str, Any]:
    """``raytpu memory``'s payload: per-node store stats + object rows."""
    w = global_worker()
    nodes, rows = _sweep_cluster_stores(w, with_stats=True)
    return {"nodes": nodes, "objects": _annotate_memory_rows(w, rows)}


def explain(id: str) -> Dict[str, Any]:
    """The scheduler's decision trail for one task / actor / placement
    group id (hex): typed pending-reason transitions, the structured
    decision records that mention it (candidates considered, per-node
    rejection causes, outcome), and its current state — the programmatic
    face of ``raytpu explain <id>``."""
    return _gcs_call("explain", id=id)


def explain_object(id: str) -> Dict[str, Any]:
    """The object-plane flight recorder's trail for ONE object id (hex):
    lifecycle transition events (CREATED/INLINED/SEALED/PINNED/SPILLED/
    RESTORED/TRANSFERRED/RE_HOMED/FREED) with owner + node + tier history,
    oldest first, plus the latest state — the programmatic face of
    ``raytpu explain <object_id>``."""
    return _gcs_call("explain_object", id=id)


def object_events(limit: int = 200, id: str | None = None,
                  event: str | None = None) -> List[Dict[str, Any]]:
    """Tail of the GCS object lifecycle event ring, newest first."""
    return _gcs_call("get_object_events", limit=limit, id=id, event=event)


def transfers(limit: int = 100) -> List[Dict[str, Any]]:
    """Completed-pull flight records from every alive node's bounded
    transfer ring, newest first: per-source bytes/chunks/failures,
    steal/retry counts and relay fraction per chunked pull, plus
    zero-copy proxy attaches — the post-hoc "how did this object get
    here / why was this broadcast slow" surface (``raytpu transfers``)."""
    w = global_worker()
    view = _gcs_call("get_cluster_view")
    out: List[Dict[str, Any]] = []
    for _nid, info in view.items():
        if not info.get("alive", True):
            continue
        client = w.agent_clients.get(info["address"])
        try:
            out.extend(run_async(client.call("transfers", limit=limit)))
        except Exception:
            continue
    out.sort(key=lambda r: r.get("ts", 0.0), reverse=True)
    return out[:limit]


def memory_leaks(pin_ttl_s: float | None = None) -> List[Dict[str, Any]]:
    """Ref-debt / leak suspects from every alive node's agent sweep
    (``raytpu memory --leaks``): read pins held past the TTL by live
    consumers, deferred frees stuck behind vanished pins, and sole-copy
    objects whose owner process no longer answers — annotated with this
    driver's refcounts where it holds references."""
    w = global_worker()
    view = _gcs_call("get_cluster_view")
    leaks: List[Dict[str, Any]] = []
    for _nid, info in view.items():
        if not info.get("alive", True):
            continue
        client = w.agent_clients.get(info["address"])
        try:
            leaks.extend(run_async(client.call(
                "store_leaks", pin_ttl_s=pin_ttl_s)))
        except Exception:
            continue
    refs = w.reference_counter.summary()
    for r in leaks:
        r["refs"] = refs.get(r["object_id"])
    return leaks


def sched_stats() -> Dict[str, Any]:
    """Control-plane saturation rollup from the GCS: per-handler
    cumulative busy seconds (time each handler blocked the GCS loop),
    the GCS loop's busy fraction, and decision-ring occupancy."""
    return _gcs_call("sched_stats")


def sched_decisions(limit: int = 200, id: str | None = None,
                    kind: str | None = None) -> List[Dict[str, Any]]:
    """Tail of the GCS scheduler decision ring, newest first."""
    return _gcs_call("get_sched_decisions", limit=limit, id=id, kind=kind)


def health(limit: int = 50) -> Dict[str, Any]:
    """Cluster health plane (util/health.py): the deduplicated
    active-alert set plus the recent raised/cleared transition trail
    from the GCS ring — what ``raytpu doctor`` / ``raytpu alerts`` /
    ``GET /api/health`` render.  Queryable whether or not
    ``health_metrics_enabled`` is on (the switch gates the background
    detectors and the raytpu_health_* series, not the ring)."""
    return _gcs_call("health", limit=limit)


def health_alerts(limit: int = 100, rule: str | None = None,
                  kind: str | None = None) -> List[Dict[str, Any]]:
    """Newest-first tail of the health alert transition ring."""
    return _gcs_call("get_health_alerts", limit=limit, rule=rule, kind=kind)


def drain_notices() -> List[Dict[str, Any]]:
    """Active + recently-completed preemption drain notices (node agents
    report at drain START; ``active`` = the node is still alive).  The
    elastic train plane resizes on these; ``raytpu doctor`` renders them
    so planned churn never reads as node flapping."""
    return _gcs_call("get_drain_notices") or []


def train_resizes(limit: int = 100) -> Dict[str, Any]:
    """The elastic-resize ledger: ``records`` (completed transitions,
    oldest first — direction/from/to/wall_s/trigger nodes) and
    ``in_progress`` (trial -> the transition currently re-forming)."""
    return _gcs_call("get_train_resizes", limit=limit) or {}


def summarize_tasks() -> Dict[str, Any]:
    """Task-state rollup + per-stage latency percentiles + pending-reason
    rollup.

    ``stage_latency`` aggregates the lifecycle breakdown: owner-side
    ``queue`` (submit -> dispatch) and ``total`` (submit -> terminal)
    durations ride RUNNING/FINISHED events; executor-side ``dep_fetch`` /
    ``arg_deser`` / ``execute`` / ``result_put`` ride STAGES events
    (``CoreWorker._record_stages``).

    ``pending_reasons`` counts every task whose NEWEST event is
    non-terminal by its typed reason (core/sched_explain.PendingReason);
    queued tasks never stamped with a reason count under ``SUBMITTED``."""
    from ray_tpu_torch.util.metrics import latency_summary

    events = _gcs_call("list_task_events", limit=100_000)
    by_name: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    latest: Dict[str, Dict[str, Any]] = {}
    stage_samples: Dict[str, List[float]] = collections.defaultdict(list)
    for ev in events:
        tid = ev.get("task_id")
        state = ev.get("state")
        if state == "STAGES":
            for stage, (_t0, dur) in (ev.get("stages") or {}).items():
                stage_samples[stage].append(dur)
            continue  # annotation, not a state transition
        if state == "SPAN":
            continue
        if ev.get("queue_s") is not None:
            stage_samples["queue"].append(ev["queue_s"])
        if ev.get("total_s") is not None:
            stage_samples["total"].append(ev["total_s"])
        if tid is not None:
            # list_task_events returns newest-first: keep the newest event
            # per task (first seen wins ties), not whichever iterates last —
            # the rollup used to count every task under its OLDEST state.
            prev = latest.get(tid)
            if prev is None or ev.get("ts", 0.0) > prev.get("ts", 0.0):
                latest[tid] = ev
    pending_reasons: collections.Counter = collections.Counter()
    for ev in latest.values():
        state = ev.get("state", "?")
        by_name[ev.get("name", "?")][state] += 1
        if state == "PENDING":
            pending_reasons[ev.get("reason") or "UNKNOWN"] += 1
        elif state == "SUBMITTED":
            pending_reasons["SUBMITTED"] += 1
    return {"cluster": {name: dict(states)
                        for name, states in sorted(by_name.items())},
            "total_tasks": len(latest),
            "pending_reasons": dict(pending_reasons),
            "stage_latency": {stage: latency_summary(samples)
                              for stage, samples
                              in sorted(stage_samples.items())}}


def summarize_actors() -> Dict[str, Any]:
    actors = list_actors()
    by_class: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for a in actors:
        by_class[a.get("class_name", "?")][a.get("state", "?")] += 1
    return {"cluster": {cls: dict(states)
                        for cls, states in sorted(by_class.items())},
            "total_actors": len(actors)}


def cluster_info() -> Dict[str, Any]:
    return _gcs_call("cluster_info")
