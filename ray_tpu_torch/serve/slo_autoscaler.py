"""SLO-driven replica autoscaler: the consumer of ``serve.slo_signal()``.

The serve plane has carried the producer side since PR 6 — every replica
heartbeats a rolling TTFT window + queue depth to the controller, which
aggregates it into the documented ``serve.slo_signal()`` contract.  This
module closes the loop (Podracer's pattern: keep the chips saturated with
a cheap control plane that reacts to load):

* :class:`SLOPolicy` — the PURE per-deployment control function.  One
  call per reconcile tick maps ``{TTFT-p95 vs target, queue depth per
  replica, running/target replicas}`` to a desired replica count with
  hysteresis: upscale FAST when the SLO breaches or the queue grows
  (sustained ``upscale_delay_s``, surge capped per decision), downscale
  SLOWLY (one replica per decision, only after the signal has sat below
  ``downscale_low_water`` of both targets for ``downscale_delay_s``), a
  deadband between the two thresholds so a noisy signal cannot flap, and
  immediate recovery when the running set hits zero.  Pure state machine
  — the table-driven unit tests drive it with signal fixtures, no cluster.
* :class:`AutoscaleLedger` — the bounded decision ring (the PR-10
  sched-decision pattern): EVERY scale event — including "wanted N,
  cluster capped at M" — lands as a queryable record surfaced through
  ``serve.status()`` / ``serve.autoscale_decisions()`` / ``raytpu serve
  status`` / ``GET /api/serve/autoscale``, and as ``raytpu_autoscale_*``
  metrics (tag keys bounded to deployment/direction/reason — enforced by
  the test_metric_naming lint).

The controller owns the impure half: it feeds each policy the staleness-
guarded deployment rollup, clamps scale-up against the live cluster view
(capacity-aware: a decision the scheduler cannot place would park
STARTING replicas forever while the record claims success), and retires
scale-down victims emptiest-first through the graceful-drain path (stop
accepting, finish in-flight, then kill — never mid-request).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, lazy

from .config import AutoscalingConfig

# closed reason vocabulary — these become metric tag values and decision-
# record fields, so the set must stay bounded (and the allowlist lint in
# tests/test_metric_naming.py pins the tag KEYS to deployment/direction/
# reason)
REASON_SLO_BREACH = "slo_breach"        # TTFT-p95 over target
REASON_QUEUE_DEPTH = "queue_depth"      # queue/replica over target
REASON_RECOVERY = "recovery"            # sustained quiet -> scale down
REASON_ZERO_RUNNING = "zero_running"    # running set hit zero
ALL_REASONS = (REASON_SLO_BREACH, REASON_QUEUE_DEPTH, REASON_RECOVERY,
               REASON_ZERO_RUNNING)

DIR_UP = "up"
DIR_DOWN = "down"


@dataclasses.dataclass
class Decision:
    """One scale event.  ``wanted`` is the policy's unclamped ask;
    ``desired`` is what the controller will reconcile toward; they differ
    exactly when the cluster (or ``max_replicas``) capped the ask —
    ``capped`` marks the capacity case so "wanted N, cluster capped at M"
    is queryable, not silent."""
    desired: int
    direction: str
    reason: str
    wanted: int
    capped: bool = False


class SLOPolicy:
    """Pure hysteresis control function over the slo_signal contract.

    State is only the pending-direction timer and the last-event stamp;
    everything else comes in through ``decide(signal, current, now)``.
    Determinism: same signal sequence + same clock -> same decisions.
    """

    def __init__(self, cfg: AutoscalingConfig):
        self.cfg = cfg
        self._pending_dir = 0
        self._pending_since: Optional[float] = None
        self._last_event_ts: Optional[float] = None
        self._last_event_dir = 0

    # ------------------------------------------------------------ breach

    def _breaches(self, signal: dict, running: int):
        """-> (slo_breach, queue_breach, quiet) for this tick."""
        cfg = self.cfg
        queue = float(signal.get("queue_depth", 0))
        # queue_depth in the rollup sums FRESH replicas only — divide by
        # the fresh count too, or partial staleness silently understates
        # per-replica load (3 of 4 stale: the one reporting replica's
        # queue would be spread over all four)
        fresh = max(running - int(signal.get("stale_replicas", 0)), 1)
        q_per = queue / fresh
        q_target = max(cfg.target_ongoing_requests, 1e-9)
        queue_breach = q_per > q_target

        ttft = signal.get("ttft_p95_ms")
        # gate on the window that PRODUCED the worst p95 when the rollup
        # reports it (ttft_p95_window_n) — the deployment-wide sample sum
        # would let one replica's single slow request read as a percentile
        # backed by everyone else's windows
        window_n = int(signal.get("ttft_p95_window_n",
                                  signal.get("window_n", 0)))
        slo_breach = (cfg.ttft_p95_target_ms is not None
                      and ttft is not None
                      and window_n >= cfg.min_window_n
                      and ttft > cfg.ttft_p95_target_ms)

        # the downscale condition is NOT "no breach": the signal must sit
        # below the low-water fraction of BOTH targets — the deadband in
        # between holds the current count (anti-flap hysteresis)
        low = cfg.downscale_low_water
        quiet = q_per <= q_target * low and (
            cfg.ttft_p95_target_ms is None or ttft is None
            or ttft <= cfg.ttft_p95_target_ms * low)
        return slo_breach, queue_breach, quiet

    def _wanted_up(self, signal: dict, running: int, slo_breach: bool) -> int:
        """The unclamped scale-up ask: enough replicas to absorb the live
        queue at the per-replica target, surged by the TTFT breach ratio
        (capped per decision so one noisy window cannot 10x the fleet)."""
        cfg = self.cfg
        queue = float(signal.get("queue_depth", 0))
        want = math.ceil(queue / max(cfg.target_ongoing_requests, 1e-9))
        if slo_breach:
            ratio = min(signal["ttft_p95_ms"] / cfg.ttft_p95_target_ms,
                        cfg.upscale_surge_max)
            want = max(want, running + 1, math.ceil(running * ratio))
        return max(want, running + 1)

    # ------------------------------------------------------------ decide

    def decide(self, signal: dict, current: int, now: float,
               capacity_max: Optional[int] = None) -> Optional[Decision]:
        """One control tick: ``signal`` is the (staleness-guarded)
        deployment slo_signal row, ``current`` the present target,
        ``capacity_max`` the cluster's placement ceiling (None = don't
        clamp).  Returns a Decision on a scale event, else None."""
        cfg = self.cfg
        running = int(signal.get("running_replicas", 0))

        # zero-running recovery bypasses hysteresis entirely: a deployment
        # with no live replica cannot produce the signal that would scale
        # it, so waiting out a delay would be a deadlock-by-policy
        if running == 0:
            desired = max(cfg.min_replicas, 1)
            if current < desired:
                self._reset_pending()
                return self._event(Decision(desired, DIR_UP,
                                            REASON_ZERO_RUNNING, desired),
                                   now)
            return None

        # all snapshots stale = the controller is flying blind, not idle:
        # the rollup reads queue_depth=0 / no percentiles, which the quiet
        # check would mistake for recovery and shrink the fleet exactly
        # while the real queue is deepest.  Hold until data returns.
        if int(signal.get("stale_replicas", 0)) >= running:
            self._reset_pending()
            return None

        slo_breach, queue_breach, quiet = self._breaches(signal, running)

        if slo_breach or queue_breach:
            wanted = self._wanted_up(signal, running, slo_breach)
            desired = min(wanted, cfg.max_replicas)
            capped = False
            if capacity_max is not None and desired > capacity_max:
                desired = max(capacity_max, current)
                capped = True
            if desired <= current and not capped:
                self._reset_pending()
                return None
            reason = REASON_SLO_BREACH if slo_breach else REASON_QUEUE_DEPTH
            # upscale "fast" still means SUSTAINED for upscale_delay_s —
            # and because every emitted event resets the timer, successive
            # surges are naturally spaced one delay apart (new replicas
            # get a chance to report in before the next surge)
            if not self._sustained(+1, now, cfg.upscale_delay_s):
                return None
            # capped down to where we already are: not a scale event, but
            # "wanted N, cluster capped at M" must still be recorded (the
            # event stamp rate-limits the record to once per delay period)
            return self._event(
                Decision(desired, DIR_UP, reason, wanted, capped=capped), now)

        if quiet and current > cfg.min_replicas:
            # downscale slowly: one replica per decision, and never below
            # what the live queue still needs
            floor = math.ceil(float(signal.get("queue_depth", 0))
                              / max(cfg.target_ongoing_requests, 1e-9))
            desired = max(current - 1, floor, cfg.min_replicas)
            if desired >= current:
                self._reset_pending()
                return None
            # flap guard: a fresh upscale blocks downscale for a full
            # downscale delay measured from the EVENT, not from when the
            # signal first went quiet
            if (self._last_event_dir > 0 and self._last_event_ts is not None
                    and now - self._last_event_ts < cfg.downscale_delay_s):
                return None
            if not self._sustained(-1, now, cfg.downscale_delay_s):
                return None
            return self._event(
                Decision(desired, DIR_DOWN, REASON_RECOVERY, desired), now)

        # deadband (or already at the clamp): hold, and reset the timer so
        # a later excursion must re-earn its full delay
        self._reset_pending()
        return None

    # ------------------------------------------------------------- state

    def _sustained(self, direction: int, now: float, delay: float) -> bool:
        if self._pending_dir != direction or self._pending_since is None:
            self._pending_dir = direction
            self._pending_since = now
        return now - self._pending_since >= delay

    def _reset_pending(self):
        self._pending_dir = 0
        self._pending_since = None

    def _event(self, dec: Decision, now: float) -> Decision:
        self._reset_pending()
        self._last_event_ts = now
        self._last_event_dir = 1 if dec.direction == DIR_UP else -1
        return dec


# ----------------------------------------------------------- decision ring

#: ring length: autoscale events are rare (hysteresis-limited), so a small
#: ring holds hours of history; bounded so the controller's memory is too
DECISION_RING_LEN = 256


class AutoscaleLedger:
    """Bounded ring of autoscale decision records + the raytpu_autoscale_*
    metric stamps.  Records survive the kill switch (they ARE the control
    plane's own audit trail and rare by construction); only the metric
    series are shed with serve_metrics_enabled."""

    def __init__(self, ring_len: int = DECISION_RING_LEN):
        self._ring: Deque[dict] = deque(maxlen=ring_len)
        self._lock = threading.Lock()

    def record(self, deployment: str, dec: Decision, current: int,
               signal: dict, policy: str) -> dict:
        rec = {
            "ts": time.time(),
            "deployment": deployment,
            "policy": policy,
            "direction": dec.direction,
            "reason": dec.reason,
            "from_replicas": current,
            "to_replicas": dec.desired,
            "wanted": dec.wanted,
            "capped": dec.capped,
            # compact signal snapshot: what the policy saw when it decided
            "signal": {k: signal[k] for k in
                       ("queue_depth", "ttft_p95_ms", "window_n",
                        "running_replicas", "stale_replicas")
                       if k in signal},
        }
        with self._lock:
            self._ring.append(rec)
        _stamp_metrics(deployment, dec)
        return rec

    def tail(self, limit: int = 50,
             deployment: Optional[str] = None) -> List[dict]:
        with self._lock:
            recs = list(self._ring)
        if deployment is not None:
            recs = [r for r in recs if r["deployment"] == deployment]
        return recs[-limit:]


# ----------------------------------------------------------------- metrics

def _build_metrics():
    return {
        "decisions": Counter(
            "raytpu_autoscale_decisions_total",
            "autoscale scale events by deployment/direction/reason",
            tag_keys=("deployment", "direction", "reason")),
        "target": Gauge(
            "raytpu_autoscale_target_replicas",
            "current autoscaler replica target per deployment",
            tag_keys=("deployment",)),
        "capped": Gauge(
            "raytpu_autoscale_capped_replicas",
            "replicas the last scale-up wanted but the cluster could not "
            "place (0 when uncapped)",
            tag_keys=("deployment",)),
    }


_metrics = lazy(_build_metrics)


def _stamp_metrics(deployment: str, dec: Decision):
    from . import observability as obs
    if not obs.enabled():
        return
    m = _metrics()
    if m is None:
        return
    m["decisions"].inc_key((("deployment", deployment),
                            ("direction", dec.direction),
                            ("reason", dec.reason)))
    m["target"].set_key((("deployment", deployment),), dec.desired)
    m["capped"].set_key((("deployment", deployment),),
                        max(0, dec.wanted - dec.desired) if dec.capped else 0)


# ------------------------------------------------------------ capacity view

def capacity_max_replicas(cluster_view: Optional[Dict[str, dict]],
                          alive_replicas: int, cpus_per_replica: float) -> \
        Optional[int]:
    """The placement ceiling for one deployment: replicas already alive
    plus how many more the cluster's free CPUs can take — draining and
    dead nodes contribute nothing (the PR-8 drain path routes around
    them, so the autoscaler must not count capacity a drain is about to
    remove).  None when the view is unavailable (don't clamp on a blind
    tick)."""
    if cluster_view is None:
        return None
    free = 0.0
    for info in cluster_view.values():
        if not info.get("alive") or info.get("draining"):
            continue
        free += max(0.0, float(info.get("available", {}).get("CPU", 0.0)))
    return alive_replicas + int(free // max(cpus_per_replica, 1e-9))
