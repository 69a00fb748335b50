"""Elastic training: turn a preemption drain notice into a *resize
event* instead of a job failure.

The signal path (ARCHITECTURE.md "Elastic training"):

1. the node agent's graceful drain (``node_agent._preempt``) reports a
   **drain notice** to the GCS at drain START (``report_drain_notice``)
   — seconds before the node dies, not after;
2. the driver-side :class:`ElasticWatcher` polls the notice registry and
   the cluster view between barrier rounds and emits a typed
   :class:`ResizeSignal` (down when a notice names a node hosting one of
   our workers, up when capacity for more workers appears while we run
   below target);
3. ``BackendExecutor`` consumes the signal AT the barrier — every rank
   is parked in ``report()`` and the round's checkpoint is registered —
   so it can tear the ``WorkerGroup`` down and re-form it at the new
   world size with nothing in flight, re-splitting dataset shards across
   the survivors and resuming from the just-registered checkpoint.

While below target the watcher also reports the missing worker shapes
as **pending demand** to the GCS (``report_pending_demand``) — the same
feed the autoscaler's ``_unmet_demands`` consumes, so a drained node is
replaced by the cluster, not just tolerated by the trainer.

Reference: the reference trainer's elasticity lives in Train v2's
worker-group recovery; the spot-fleet papers (Gemma-on-Cloud-TPU,
Podracer) assume preemptible fleets that grow and shrink under a live
learner — this module is that contract for the train plane.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ResizeSignal:
    """One typed elastic transition request, emitted by the watcher and
    consumed by ``BackendExecutor`` at the next barrier round."""

    #: "down" | "up"
    direction: str
    #: "drain" (graceful notice), "capacity" (room to grow back toward
    #: target), "failure" (worker died with no notice)
    reason: str
    #: nodes that triggered the signal (draining node ids for down,
    #: newly-usable node ids for up); may be empty for "failure"
    node_ids: List[str] = dataclasses.field(default_factory=list)
    #: world size the executor should re-form at
    target_world_size: int = 0
    #: monotonic deadline by which the triggering drain completes
    #: (0 = no deadline known)
    deadline: float = 0.0

    def to_record(self) -> Dict[str, Any]:
        return {"direction": self.direction, "reason": self.reason,
                "node_ids": list(self.node_ids),
                "target_world_size": self.target_world_size}


def _gcs():
    from ..core.core_worker import global_worker
    return global_worker().gcs


def _gcs_call(method: str, **kwargs):
    from ..core.rpc import run_async
    return run_async(_gcs().call(method, **kwargs))


def fit_world_size(view: Dict[str, dict], bundle: Dict[str, float],
                   lo: int, hi: int,
                   reclaim: Optional[Dict[str, int]] = None) -> int:
    """Largest world size in ``[lo, hi]`` the cluster can host right now:
    greedy bundle-fit over alive, non-draining nodes' available
    resources.  ``reclaim`` maps node_id -> number of OUR current worker
    bundles on that node — resources the resize itself frees, counted as
    available so a same-size re-form on surviving nodes never looks
    infeasible."""
    reclaim = reclaim or {}
    total = 0
    for nid, n in (view or {}).items():
        if not n.get("alive") or n.get("draining"):
            continue
        avail = dict(n.get("available") or {})
        # short-lived task leases (per-epoch dataset tasks and the like)
        # idle-return within seconds once their submitter stops — without
        # counting them a node churning 1-CPU tasks looks permanently full
        # and an up-resize only fires if a poll hits a momentary idle gap
        for k, v in (n.get("task_leased") or {}).items():
            avail[k] = avail.get(k, 0.0) + v
        for k, v in bundle.items():
            avail[k] = avail.get(k, 0.0) + reclaim.get(nid, 0) * v
        fits = min((int(avail.get(k, 0.0) // v) for k, v in bundle.items()
                    if v > 0), default=0)
        total += max(0, fits)
        if total >= hi:
            return hi
    return max(lo, min(hi, total))


class ElasticWatcher:
    """Driver-side poller: drain notices + cluster view -> ResizeSignal.

    Stateless against the cluster (every poll re-reads), rate-limited so
    a sub-second barrier cadence costs one RPC pair per ``poll_s`` at
    most.  All calls are best-effort: a control-plane hiccup returns
    ``None`` (no signal) rather than failing the training loop.
    """

    def __init__(self, *, target_workers: int, min_workers: int,
                 bundle: Dict[str, float], trial: str,
                 poll_s: float = 0.5, demand_every_s: float = 2.0):
        self.target = int(target_workers)
        self.min_workers = max(1, int(min_workers))
        self.bundle = dict(bundle)
        self.trial = trial or "train"
        self.poll_s = float(poll_s)
        self.demand_every_s = float(demand_every_s)
        self._last_poll = 0.0
        self._last_demand = 0.0
        #: node_ids whose drain notices were already consumed by a resize
        #: — a notice outlives the transition in the GCS registry, and
        #: re-signaling on it would resize in a loop
        self._handled_drains: set = set()

    # ------------------------------------------------------------- polling

    def poll(self, worker_node_ids: Dict[str, int],
             current_workers: int) -> Optional[ResizeSignal]:
        """One rate-limited check.  ``worker_node_ids`` maps node_id ->
        number of our workers currently on that node."""
        now = time.monotonic()
        if now - self._last_poll < self.poll_s:
            return None
        self._last_poll = now
        try:
            notices = _gcs_call("get_drain_notices") or []
        except Exception:
            return None
        active = {n["node_id"]: n for n in notices
                  if n.get("active") and n["node_id"]
                  not in self._handled_drains}
        draining_ours = [nid for nid in active if nid in worker_node_ids]
        if draining_ours:
            lost = sum(worker_node_ids[nid] for nid in draining_ours)
            new_n = max(self.min_workers, current_workers - lost)
            # the registry reports wall-clock deadlines; convert the
            # tightest notice's remaining budget to OUR monotonic clock
            # (0.0 when no notice carries a remaining_s, i.e. unknown)
            remaining = [active[nid]["remaining_s"] for nid in draining_ours
                         if active[nid].get("remaining_s") is not None]
            deadline = (time.monotonic() + min(remaining)) if remaining \
                else 0.0
            self._handled_drains.update(draining_ours)
            return ResizeSignal(direction="down", reason="drain",
                                node_ids=draining_ours,
                                target_world_size=new_n, deadline=deadline)
        if current_workers < self.target:
            self._report_demand(current_workers, now)
            sig = self._check_capacity(worker_node_ids, current_workers)
            if sig is not None:
                return sig
        return None

    def _check_capacity(self, worker_node_ids: Dict[str, int],
                        current_workers: int) -> Optional[ResizeSignal]:
        try:
            view = _gcs_call("get_cluster_view") or {}
        except Exception:
            return None
        n = fit_world_size(view, self.bundle, lo=current_workers,
                           hi=self.target, reclaim=worker_node_ids)
        if n > current_workers:
            fresh = [nid for nid, nv in view.items()
                     if nv.get("alive") and not nv.get("draining")
                     and nid not in worker_node_ids]
            return ResizeSignal(direction="up", reason="capacity",
                                node_ids=fresh, target_world_size=n)
        return None

    def _report_demand(self, current_workers: int, now: float) -> None:
        """Feed the autoscaler: the workers we are missing are pending
        demand exactly like infeasible task shapes (GCS entries expire in
        ~5s, so keep refreshing while below target)."""
        if now - self._last_demand < self.demand_every_s:
            return
        self._last_demand = now
        try:
            _gcs_call("report_pending_demand",
                      reporter=f"elastic:{self.trial}",
                      shape=self.bundle,
                      count=self.target - current_workers)
        except Exception:
            pass

    # ------------------------------------------------------------ records

    def publish_resize(self, record: Dict[str, Any]) -> None:
        """Best-effort push of a completed-resize record to the GCS ring
        (``raytpu train`` / doctor read it back via get_train_resizes)."""
        try:
            _gcs_call("add_train_resize", record=record)
        except Exception:
            pass

    def publish_resize_started(self, record: Dict[str, Any]) -> None:
        try:
            _gcs_call("train_resize_started", trial=self.trial,
                      record=record)
        except Exception:
            pass
