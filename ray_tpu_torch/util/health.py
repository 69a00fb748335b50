"""Cluster health plane: rule-based anomaly detection over the planes
that already exist.

Five observability planes (task stages, serve SLO, train goodput/MFU,
scheduler explain, object memory) emit series and rings that nothing
*consumes* — an operator still correlates ``raytpu top`` against
``raytpu explain`` by hand to notice that events are shedding or a
replica's SLO signal went stale.  This module closes the loop:

* :class:`HealthRule` — the closed vocabulary of detectable conditions.
  Rule names are metric tag values and ring record fields, so the set is
  the cardinality bound: new rules are added here (and to the table in
  ARCHITECTURE.md), never inlined at a call site — a lint in
  tests/test_metric_naming.py rejects free-form strings (the PR-10
  PendingReason discipline).
* :class:`HealthDetector` — a pure hysteresis engine.  Each rule's
  ``check`` maps an evidence snapshot to ``{scope: (value, evidence)}``;
  the engine raises an :class:`Alert` once the value holds above
  ``raise_at`` for ``hold_s`` and clears it only after the value holds
  at/below ``clear_at`` for ``min_hold_s`` — flapping metrics cannot
  spam the ring.  Deduplication is structural: one alert per
  ``(rule, scope)``, re-raises update evidence in place.
* Alert transitions land in a bounded age-out ring in the GCS (the
  sched_decision ring pattern): ``add_health_alerts`` /
  ``get_health_alerts`` / ``health`` handlers, surfaced through
  ``state.health()``, ``GET /api/health``, ``raytpu doctor`` /
  ``raytpu alerts`` and the ALERTS line in ``raytpu top``.
* ``health_metrics_enabled`` — ONE kill switch: off means zero
  ``raytpu_health_*`` series AND no detector CPU (the head scrape loop
  and the GCS snapshot loop skip evaluation entirely); the ring stays
  queryable on demand and ``raytpu doctor`` still works (its one-shot
  evaluation is explicitly requested work, not background CPU).

The detector runs where the evidence already is: the dashboard head's
existing scrape loop evaluates the metrics/SLO rules per scrape tick,
and the GCS evaluates its two process-local rules (EVENTS_SHED,
GCS_HANDLER_HOT) at health-check cadence — no new per-task work on any
hot path.

Reference: Ray's dashboard ships exactly this layer on top of its
metrics pipeline; the Gemma-on-Cloud-TPU paper makes the operational
case that on spot-priced chips, minutes of undetected degradation are
the dominant cost.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config

__all__ = [
    "HealthRule", "Rule", "HealthDetector", "Alert",
    "enabled", "alerts_counter", "active_gauge",
    "default_rules", "head_detector", "gcs_detector",
    "build_head_snapshot", "evaluate_oneshot", "next_step",
]

SEV_WARNING = "warning"
SEV_CRITICAL = "critical"

#: the only severities an alert may carry (metric tag values)
SEVERITIES = frozenset({SEV_WARNING, SEV_CRITICAL})


class HealthRule:
    """Closed vocabulary of health conditions.

    These are metric tag values and ring record fields — the set is the
    cardinality bound.  Every rule maps to an existing explain surface
    (the ``next_step`` pointer printed by ``raytpu doctor``), so an
    alert is always actionable, never just a red light.
    """

    #: an event-loop (owner/agent/worker/GCS) spent ~all wall time on-CPU
    #: — submissions and heartbeats queue behind it
    OWNER_LOOP_SATURATED = "OWNER_LOOP_SATURATED"
    #: the GCS task-event buffer hit ``task_events_max_buffer`` and shed
    #: events — the state/timeline planes are silently incomplete
    EVENTS_SHED = "EVENTS_SHED"
    #: a serve deployment's autoscaler input is partially blind: replica
    #: heartbeats older than 3x the period are being dropped
    SLO_SIGNAL_STALE = "SLO_SIGNAL_STALE"
    #: TTFT p95 above the deployment's declared SLO target
    TTFT_BREACH = "TTFT_BREACH"
    #: shm arena fragmentation high — large allocations will fail or
    #: spill despite free bytes
    ARENA_FRAG_HIGH = "ARENA_FRAG_HIGH"
    #: pins past TTL / deferred frees stuck behind vanished pins
    LEAK_SUSPECTS = "LEAK_SUSPECTS"
    #: train goodput (productive step time / wall) dropped
    GOODPUT_DROP = "GOODPUT_DROP"
    #: a node's /metrics scrape flipped error<->ok repeatedly in window
    NODE_FLAPPING = "NODE_FLAPPING"
    #: a node is draining under an active preemption notice — planned
    #: churn (elastic trainers resize on it), distinct from flapping
    NODE_DRAINING = "NODE_DRAINING"
    #: a training run is mid elastic resize (worker group torn down,
    #: re-form in flight) — expected to clear within seconds
    TRAIN_RESIZING = "TRAIN_RESIZING"
    #: one GCS handler is eating a large fraction of a shard's loop
    GCS_HANDLER_HOT = "GCS_HANDLER_HOT"
    #: sustained heavy spill traffic out of the shm store
    SPILL_STORM = "SPILL_STORM"
    #: lease requests answered with backpressure, sustained
    BACKPRESSURE_SUSTAINED = "BACKPRESSURE_SUSTAINED"
    #: session/spill filesystem nearly full on a node
    DISK_LOW = "DISK_LOW"

    ALL = frozenset({
        "OWNER_LOOP_SATURATED", "EVENTS_SHED", "SLO_SIGNAL_STALE",
        "TTFT_BREACH", "ARENA_FRAG_HIGH", "LEAK_SUSPECTS", "GOODPUT_DROP",
        "NODE_FLAPPING", "NODE_DRAINING", "TRAIN_RESIZING",
        "GCS_HANDLER_HOT", "SPILL_STORM",
        "BACKPRESSURE_SUSTAINED", "DISK_LOW",
    })


#: rule -> "what to run next" pointer rendered by doctor/alerts.  Every
#: entry names an existing CLI surface and, where one exists, the knob.
_NEXT_STEP: Dict[str, str] = {
    HealthRule.OWNER_LOOP_SATURATED:
        "run `raytpu explain --stats` (submit_plane, loop stalls); "
        "lower submit_inflight_limit or move work off the saturated loop",
    HealthRule.EVENTS_SHED:
        "raise task_events_max_buffer (timeline/state output is "
        "incomplete); run `raytpu list tasks` to see what survived",
    HealthRule.SLO_SIGNAL_STALE:
        "run `raytpu serve status`; stale replicas stopped heartbeating "
        "— check their worker logs via `raytpu logs <node-id>`",
    HealthRule.TTFT_BREACH:
        "run `raytpu serve status` and `raytpu serve decisions`; raise "
        "max_replicas or check why upscale is capped",
    HealthRule.ARENA_FRAG_HIGH:
        "run `raytpu memory --arena <node-id>`; long-pinned objects "
        "fragment the pool — release pins or raise object_store_memory",
    HealthRule.LEAK_SUSPECTS:
        "run `raytpu memory --leaks` for holder/age per suspect; "
        "object_pin_leak_ttl_s bounds the grace period",
    HealthRule.GOODPUT_DROP:
        "run `raytpu top` (train pane) and `raytpu explain --stats`; "
        "input stalls and preemptions are the usual thieves",
    HealthRule.NODE_FLAPPING:
        "run `raytpu status` and `raytpu logs <node-id>`; a flapping "
        "agent usually means OOM kills or a dying host",
    HealthRule.NODE_DRAINING:
        "planned churn: the node is draining under a preemption notice "
        "(`raytpu doctor` shows the remaining window); elastic trainers "
        "resize around it — only act if it never clears",
    HealthRule.TRAIN_RESIZING:
        "a trainer is re-forming its worker group (`raytpu train` shows "
        "the transition ledger); investigate only if stuck >5 min",
    HealthRule.GCS_HANDLER_HOT:
        "run `raytpu explain --stats` (top_handlers); raise gcs_shards "
        "or batch the offending call path",
    HealthRule.SPILL_STORM:
        "run `raytpu memory` and `raytpu transfers`; working set "
        "exceeds the shm pool — raise object_store_memory",
    HealthRule.BACKPRESSURE_SUSTAINED:
        "run `raytpu explain --stats`; lease queues are pinned at "
        "lease_queue_max_depth — add nodes or slow submission",
    HealthRule.DISK_LOW:
        "free disk on the node (session logs + spill dir); spilling "
        "will start failing at 100%",
}


def next_step(rule: str) -> str:
    return _NEXT_STEP.get(rule, "run `raytpu status`")


class Alert:
    """One deduplicated health condition: ``(rule, scope)`` identity,
    evidence snapshot from the breaching observation, ``since_ts`` from
    the FIRST breach of the episode (not the raise tick)."""

    __slots__ = ("rule", "severity", "scope", "value", "evidence",
                 "since_ts", "last_ts")

    def __init__(self, rule: str, severity: str, scope: str, value: float,
                 evidence: dict, since_ts: float, last_ts: float):
        self.rule = rule
        self.severity = severity
        self.scope = scope
        self.value = value
        self.evidence = evidence
        self.since_ts = since_ts
        self.last_ts = last_ts

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity,
            "scope": self.scope, "value": round(float(self.value), 4),
            "evidence": self.evidence,
            "since_ts": round(self.since_ts, 3),
            "last_ts": round(self.last_ts, 3),
            "next_step": next_step(self.rule),
        }


class Rule:
    """One detectable condition: a ``check`` over the evidence snapshot
    plus the hysteresis envelope.  ``check(snap)`` returns every observed
    ``{scope: (value, evidence)}`` — higher value is always worse; the
    engine owns the thresholds, so the raise/clear asymmetry lives in
    ONE place and unit tests can drive it with synthetic values."""

    def __init__(self, name: str, check: Callable[[dict], Dict[str, tuple]],
                 raise_at: float, clear_at: float,
                 severity: str = SEV_WARNING,
                 hold_s: Optional[float] = None,
                 min_hold_s: Optional[float] = None):
        if name not in HealthRule.ALL:
            raise ValueError(f"unknown health rule: {name!r}")
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity: {severity!r}")
        if clear_at > raise_at:
            raise ValueError(f"{name}: clear_at must be <= raise_at")
        self.name = name
        self.check = check
        self.raise_at = float(raise_at)
        self.clear_at = float(clear_at)
        self.severity = severity
        self.hold_s = hold_s          # None -> detector default
        self.min_hold_s = min_hold_s  # None -> detector default


# ---------------------------------------------------------------- checks
#
# Each check reads optional snapshot keys (absent surface -> no scopes,
# never an error) and returns {scope: (value, evidence)}.  Scope strings
# are bounded: "cluster", "node:<id12>", "deployment:<name>",
# "loop:<node>/<process>", "gcs:<method>".

def _check_loop_saturated(snap: dict) -> Dict[str, tuple]:
    out = {}
    stalls = snap.get("loop_stalls") or {}
    for scope, busy in (snap.get("loop_busy") or {}).items():
        out[f"loop:{scope}"] = (busy, {
            "busy_fraction": round(busy, 3),
            "stalls": stalls.get(scope, 0)})
    return out


def _check_events_shed(snap: dict) -> Dict[str, tuple]:
    shed = snap.get("events_shed")
    if shed is None:
        return {}
    return {"cluster": (float(shed), {
        "shed_in_interval": int(shed),
        "shed_total": int(snap.get("events_shed_total", shed))})}


def _check_slo_stale(snap: dict) -> Dict[str, tuple]:
    out = {}
    for dep, row in (snap.get("slo") or {}).items():
        stale = float(row.get("stale_replicas", 0) or 0)
        out[f"deployment:{dep}"] = (stale, {
            "stale_replicas": int(stale),
            "running_replicas": row.get("running_replicas"),
            "queue_depth": row.get("queue_depth")})
    return out


def _check_ttft_breach(snap: dict) -> Dict[str, tuple]:
    out = {}
    for dep, row in (snap.get("slo") or {}).items():
        target = row.get("ttft_p95_target_ms")
        ttft = row.get("ttft_p95_ms")
        if not target or ttft is None:
            continue
        out[f"deployment:{dep}"] = (float(ttft) / float(target), {
            "ttft_p95_ms": round(float(ttft), 1),
            "ttft_p95_target_ms": float(target),
            "running_replicas": row.get("running_replicas")})
    return out


def _check_arena_frag(snap: dict) -> Dict[str, tuple]:
    return {f"node:{n}": (frac, {"frag_fraction": round(frac, 3)})
            for n, frac in (snap.get("arena_frag") or {}).items()}


def _check_leaks(snap: dict) -> Dict[str, tuple]:
    return {f"node:{n}": (float(c), {"leak_suspects": int(c)})
            for n, c in (snap.get("leak_suspects") or {}).items()}


def _check_goodput(snap: dict) -> Dict[str, tuple]:
    # value = 1 - goodput so "higher is worse" like every other rule
    return {f"node:{n}": (1.0 - g, {"goodput_fraction": round(g, 3)})
            for n, g in (snap.get("goodput") or {}).items()}


def _check_flapping(snap: dict) -> Dict[str, tuple]:
    return {f"node:{n}": (float(c), {"flaps_in_window": int(c)})
            for n, c in (snap.get("flaps") or {}).items()}


def _check_draining(snap: dict) -> Dict[str, tuple]:
    return {f"node:{n}": (1.0, {"notice_remaining_s": round(float(r), 1)})
            for n, r in (snap.get("draining_notices") or {}).items()}


def _check_resizing(snap: dict) -> Dict[str, tuple]:
    return {f"trial:{t}": (1.0, dict(info or {}))
            for t, info in (snap.get("train_resizing") or {}).items()}


def _check_handler_hot(snap: dict) -> Dict[str, tuple]:
    return {f"gcs:{m}": (frac, {"busy_fraction": round(frac, 3)})
            for m, frac in (snap.get("handler_busy") or {}).items()}


def _check_spill_storm(snap: dict) -> Dict[str, tuple]:
    return {f"node:{n}": (rate, {"spill_bytes_per_s": int(rate)})
            for n, rate in (snap.get("spill_rate") or {}).items()}


def _check_backpressure(snap: dict) -> Dict[str, tuple]:
    return {f"node:{n}": (rate, {"rejects_per_s": round(rate, 2)})
            for n, rate in (snap.get("backpressure_rate") or {}).items()}


def _check_disk_low(snap: dict) -> Dict[str, tuple]:
    return {f"node:{n}": (frac, {"disk_used_fraction": round(frac, 3)})
            for n, frac in (snap.get("disk_used_frac") or {}).items()}


# --------------------------------------------------------------- registry
#
# Threshold rationale lives in ARCHITECTURE.md's rule table.  hold_s /
# min_hold_s = None inherit the detector (config) defaults; rules that
# need a faster raise or a stickier clear say so here.

def default_rules() -> List[Rule]:
    return [
        Rule(HealthRule.OWNER_LOOP_SATURATED, _check_loop_saturated,
             raise_at=0.95, clear_at=0.80, severity=SEV_CRITICAL),
        Rule(HealthRule.EVENTS_SHED, _check_events_shed,
             raise_at=1.0, clear_at=0.0, severity=SEV_CRITICAL,
             hold_s=0.0),  # any shed is data loss; raise immediately
        Rule(HealthRule.SLO_SIGNAL_STALE, _check_slo_stale,
             raise_at=1.0, clear_at=0.0, severity=SEV_WARNING),
        Rule(HealthRule.TTFT_BREACH, _check_ttft_breach,
             raise_at=1.2, clear_at=1.0, severity=SEV_CRITICAL),
        Rule(HealthRule.ARENA_FRAG_HIGH, _check_arena_frag,
             raise_at=0.75, clear_at=0.50, severity=SEV_WARNING),
        Rule(HealthRule.LEAK_SUSPECTS, _check_leaks,
             raise_at=1.0, clear_at=0.0, severity=SEV_WARNING),
        Rule(HealthRule.GOODPUT_DROP, _check_goodput,
             raise_at=0.40, clear_at=0.25, severity=SEV_WARNING),
        Rule(HealthRule.NODE_FLAPPING, _check_flapping,
             raise_at=2.0, clear_at=1.0, severity=SEV_CRITICAL,
             hold_s=0.0),  # >=2 flips in window IS the sustained signal
        Rule(HealthRule.NODE_DRAINING, _check_draining,
             raise_at=1.0, clear_at=0.0, severity=SEV_WARNING,
             hold_s=0.0, min_hold_s=0.0),  # the notice IS the condition
        Rule(HealthRule.TRAIN_RESIZING, _check_resizing,
             raise_at=1.0, clear_at=0.0, severity=SEV_WARNING,
             hold_s=0.0, min_hold_s=0.0),  # clears when the re-form lands
        Rule(HealthRule.GCS_HANDLER_HOT, _check_handler_hot,
             raise_at=0.50, clear_at=0.25, severity=SEV_WARNING),
        Rule(HealthRule.SPILL_STORM, _check_spill_storm,
             raise_at=64 * 1024 * 1024, clear_at=8 * 1024 * 1024,
             severity=SEV_WARNING),
        Rule(HealthRule.BACKPRESSURE_SUSTAINED, _check_backpressure,
             raise_at=1.0, clear_at=0.0, severity=SEV_WARNING),
        Rule(HealthRule.DISK_LOW, _check_disk_low,
             raise_at=0.90, clear_at=0.85, severity=SEV_CRITICAL),
    ]


#: rules the GCS evaluates from process-local state at snapshot cadence
#: (drain notices and the in-progress resize map live in GCS memory)
GCS_RULE_NAMES = frozenset({
    HealthRule.EVENTS_SHED, HealthRule.GCS_HANDLER_HOT,
    HealthRule.NODE_DRAINING, HealthRule.TRAIN_RESIZING,
})

#: rules the dashboard head evaluates per scrape tick.  Disjoint from
#: GCS_RULE_NAMES so one (rule, scope) never has two writers.
HEAD_RULE_NAMES = HealthRule.ALL - GCS_RULE_NAMES


# ---------------------------------------------------------------- engine

class _Track:
    __slots__ = ("breach_since", "clear_since", "alert")

    def __init__(self):
        self.breach_since: Optional[float] = None  # pending raise
        self.clear_since: Optional[float] = None   # pending clear
        self.alert: Optional[Alert] = None         # active


class HealthDetector:
    """Hysteresis engine over a rule subset.  Pure: ``observe()`` takes
    the snapshot and an explicit ``now`` (tests drive synthetic time),
    returns the transition events this tick, and keeps the active-alert
    map.  No I/O, no metrics — callers emit those (so the engine is
    usable from the GCS, the head, and unit tests identically)."""

    def __init__(self, rules: Optional[List[Rule]] = None,
                 hold_s: float = 10.0, min_hold_s: float = 30.0):
        self.rules = list(rules if rules is not None else default_rules())
        self.hold_s = float(hold_s)
        self.min_hold_s = float(min_hold_s)
        #: (rule, scope) -> _Track
        self._tracks: Dict[Tuple[str, str], _Track] = {}

    # ------------------------------------------------------------- state

    def active(self) -> List[dict]:
        return sorted((t.alert.to_dict() for t in self._tracks.values()
                       if t.alert is not None),
                      key=lambda a: (a["severity"] != SEV_CRITICAL,
                                     a["rule"], a["scope"]))

    def active_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for t in self._tracks.values():
            if t.alert is not None:
                out[t.alert.rule] = out.get(t.alert.rule, 0) + 1
        return out

    # ----------------------------------------------------------- observe

    def observe(self, snap: dict, now: Optional[float] = None) -> List[dict]:
        """One detector tick.  Returns transition events (kind =
        ``raised`` | ``cleared``), each carrying the full alert payload
        — exactly what the GCS ring stores."""
        now = float(snap.get("now", now if now is not None else time.time()))
        events: List[dict] = []
        for rule in self.rules:
            try:
                observed = rule.check(snap) or {}
            except Exception:
                observed = {}  # a broken surface must not kill the loop
            hold = self.hold_s if rule.hold_s is None else rule.hold_s
            min_hold = (self.min_hold_s if rule.min_hold_s is None
                        else rule.min_hold_s)
            seen = set()
            for scope, (value, evidence) in observed.items():
                seen.add(scope)
                self._step(rule, scope, float(value), evidence or {},
                           now, hold, min_hold, events)
            # scopes with an open track but absent from this snapshot
            # (deployment deleted, node gone) read as value 0
            for (rname, scope), track in list(self._tracks.items()):
                if rname == rule.name and scope not in seen:
                    self._step(rule, scope, 0.0, {}, now, hold, min_hold,
                               events)
        return events

    def _step(self, rule: Rule, scope: str, value: float, evidence: dict,
              now: float, hold: float, min_hold: float,
              events: List[dict]) -> None:
        key = (rule.name, scope)
        track = self._tracks.get(key)
        if track is None:
            if value < rule.raise_at:
                return  # healthy and untracked: the common case, no state
            track = self._tracks[key] = _Track()

        if track.alert is None:
            # pending-raise side of the hysteresis loop
            if value >= rule.raise_at:
                if track.breach_since is None:
                    track.breach_since = now
                if now - track.breach_since >= hold:
                    track.alert = Alert(rule.name, rule.severity, scope,
                                        value, evidence,
                                        since_ts=track.breach_since,
                                        last_ts=now)
                    track.clear_since = None
                    events.append({"kind": "raised", "ts": round(now, 3),
                                   **track.alert.to_dict()})
            else:
                # dipped below raise before holding long enough: forget
                self._tracks.pop(key, None)
            return

        # active side: refresh evidence, look for a sustained clear
        track.alert.last_ts = now
        if value > rule.clear_at:
            track.clear_since = None
            if value >= rule.raise_at:
                # still breaching: dedup = update in place, no new event
                track.alert.value = value
                track.alert.evidence = evidence
            return
        if track.clear_since is None:
            track.clear_since = now
        if (now - track.clear_since >= min_hold
                and now - track.alert.since_ts >= min_hold):
            events.append({"kind": "cleared", "ts": round(now, 3),
                           **track.alert.to_dict()})
            self._tracks.pop(key, None)


def evaluate_oneshot(snap: dict,
                     rules: Optional[List[Rule]] = None) -> List[dict]:
    """Instantaneous evaluation (no hysteresis): every rule whose value
    is at/above ``raise_at`` RIGHT NOW.  The ``raytpu doctor`` path —
    a one-shot diagnosis must not wait out a hold window."""
    out = []
    now = float(snap.get("now", time.time()))
    for rule in (rules if rules is not None else default_rules()):
        try:
            observed = rule.check(snap) or {}
        except Exception:
            continue
        for scope, (value, evidence) in observed.items():
            if float(value) >= rule.raise_at:
                out.append(Alert(rule.name, rule.severity, scope,
                                 float(value), evidence or {},
                                 since_ts=now, last_ts=now).to_dict())
    return sorted(out, key=lambda a: (a["severity"] != SEV_CRITICAL,
                                      a["rule"], a["scope"]))


def _rules_named(names) -> List[Rule]:
    names = set(names)
    return [r for r in default_rules() if r.name in names]


def head_detector(hold_s: Optional[float] = None,
                  min_hold_s: Optional[float] = None) -> HealthDetector:
    cfg = get_config()
    return HealthDetector(
        _rules_named(HEAD_RULE_NAMES),
        hold_s=cfg.health_raise_hold_s if hold_s is None else hold_s,
        min_hold_s=(cfg.health_min_hold_s if min_hold_s is None
                    else min_hold_s))


def gcs_detector(hold_s: Optional[float] = None,
                 min_hold_s: Optional[float] = None) -> HealthDetector:
    cfg = get_config()
    return HealthDetector(
        _rules_named(GCS_RULE_NAMES),
        hold_s=cfg.health_raise_hold_s if hold_s is None else hold_s,
        min_hold_s=(cfg.health_min_hold_s if min_hold_s is None
                    else min_hold_s))


# ----------------------------------------------------------- kill switch

_enabled_cache: tuple = (None, False)


def enabled() -> bool:
    """One cached boolean per Config identity — checked by the head
    scrape hook and the GCS snapshot hook before ANY detector work."""
    global _enabled_cache
    cfg = get_config()
    if _enabled_cache[0] is not cfg:
        _enabled_cache = (cfg, bool(getattr(cfg, "health_metrics_enabled",
                                            False)))
    return _enabled_cache[1]


# --------------------------------------------------------------- metrics
#
# Lazy singletons on the shared registry; tag keys bounded by the
# allowlist lint (rule / severity only — scope would be unbounded-ish
# and is available from the ring).

def _build_alerts_counter():
    from ray_tpu_torch.util.metrics import Counter
    return Counter(
        "raytpu_health_alerts_total",
        "health alerts raised (transitions, not active count), by rule "
        "and severity", tag_keys=("rule", "severity"))


_alerts_counter_get = None


def alerts_counter():
    global _alerts_counter_get
    if not enabled():
        return None
    if _alerts_counter_get is None:
        from ray_tpu_torch.util.metrics import lazy
        _alerts_counter_get = lazy(_build_alerts_counter)
    return _alerts_counter_get()


def _build_active_gauge():
    from ray_tpu_torch.util.metrics import Gauge
    return Gauge(
        "raytpu_health_active_alerts",
        "currently-active health alerts, by rule", tag_keys=("rule",))


_active_gauge_get = None


def active_gauge():
    global _active_gauge_get
    if not enabled():
        return None
    if _active_gauge_get is None:
        from ray_tpu_torch.util.metrics import lazy
        _active_gauge_get = lazy(_build_active_gauge)
    return _active_gauge_get()


def record_transitions(events: List[dict],
                       detector: HealthDetector) -> None:
    """Emit the raytpu_health_* series for one detector tick (no-op with
    the switch off — callers already skipped the tick, this is belt and
    braces for on-demand paths)."""
    if not events and not detector._tracks:
        return
    c = alerts_counter()
    if c is not None:
        for ev in events:
            if ev.get("kind") == "raised":
                c.inc(1, {"rule": ev["rule"], "severity": ev["severity"]})
    g = active_gauge()
    if g is not None:
        counts = detector.active_counts()
        # only rules that have EVER raised get a series (cleared ones
        # read 0; never-fired rules contribute zero series, not
        # zero-valued series — the PR-2 cardinality discipline)
        gauged = getattr(detector, "_gauged", None)
        if gauged is None:
            gauged = detector._gauged = set()
        gauged.update(counts)
        for rule in gauged:
            g.set(counts.get(rule, 0), {"rule": rule})


def alert_trail(limit: int = 50) -> dict:
    """Best-effort health rollup for benchmark artifacts (bench_storm /
    bench_scale attach this to their JSON): the active alert set + the
    recent raise/clear transitions at capture time.  Never raises — a
    bench must not fail because the health plane is off or unreachable."""
    try:
        from ray_tpu_torch.util import state
        h = state.health(limit=limit)
        return {"enabled": h.get("enabled"),
                "active": h.get("active") or [],
                "transitions": h.get("recent") or []}
    except Exception as e:  # noqa: BLE001 — observability must not wedge
        return {"enabled": None, "active": [], "transitions": [],
                "error": f"{type(e).__name__}: {e}"}


# ----------------------------------------------------- snapshot builders

def _key_labels(key: str) -> Dict[str, str]:
    """Exposition key -> label dict (``name{a="b",c="d"}``)."""
    if "{" not in key:
        return {}
    body = key.split("{", 1)[1].rstrip("}")
    out = {}
    for part in body.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip().strip('"')
    return out


def _sum_positive_deltas(points: List[list], window_s: float,
                         now: float) -> float:
    """Gauge-increase rate over the window: sum of positive deltas / span
    (for cumulative-ish gauges like spilled-bytes-resident)."""
    pts = [p for p in points if p[0] >= now - window_s]
    if len(pts) < 2:
        return 0.0
    gained = sum(max(0.0, b[1] - a[1]) for a, b in zip(pts, pts[1:]))
    span = pts[-1][0] - pts[0][0]
    return gained / span if span > 0 else 0.0


def build_head_snapshot(store, slo: Optional[dict] = None,
                        sched_stats: Optional[dict] = None,
                        now: Optional[float] = None,
                        window_s: float = 60.0,
                        drain_notices: Optional[List[dict]] = None) -> dict:
    """Evidence snapshot for the HEAD rule subset, read entirely from
    the MetricsHistory the scrape loop already maintains (plus the serve
    signal / sched_stats dicts the caller may already hold).  Cost: dict
    walks over the freshest sample per node — no new RPCs.

    ``drain_notices`` (the GCS get_drain_notices rows, when the caller
    holds them) suppresses NODE_FLAPPING for nodes under an active
    preemption notice: a drained node's scrape going dark is planned
    elastic churn, and alarming it as flapping sends the operator
    chasing a healthy mechanism."""
    now = time.time() if now is None else now
    snap: Dict[str, Any] = {"now": now}
    loop_busy: Dict[str, float] = {}
    loop_stalls: Dict[str, float] = {}
    arena_frag: Dict[str, float] = {}
    leaks: Dict[str, int] = {}
    goodput: Dict[str, float] = {}
    flaps: Dict[str, int] = {}
    spill: Dict[str, float] = {}
    bp: Dict[str, float] = {}
    disk: Dict[str, float] = {}

    _, latest = store.latest()
    for node, samples in latest.items():
        if not isinstance(samples, dict) or "error" in samples and \
                samples.get("error") is not None and len(samples) == 1:
            continue
        store_used = 0.0
        for key, val in samples.items():
            name = key.split("{", 1)[0]
            if name == "raytpu_loop_busy_fraction":
                proc = _key_labels(key).get("process", "?")
                scope = f"{node}/{proc}"
                loop_busy[scope] = max(loop_busy.get(scope, 0.0), val)
            elif name == "raytpu_event_loop_stalls":
                proc = _key_labels(key).get("process", "?")
                scope = f"{node}/{proc}"
                loop_stalls[scope] = val
            elif name == "raytpu_mem_arena_frag_fraction":
                arena_frag[node] = val
            elif name == "raytpu_object_store_bytes":
                store_used = val
            elif name == "raytpu_mem_leak_suspects":
                leaks[node] = int(val)
            elif name == "raytpu_train_goodput_fraction":
                goodput[node] = min(goodput.get(node, 1.0), val)
            elif name == "raytpu_node_disk_used_fraction":
                disk[node] = val
        # fragmentation of an EMPTY pool is noise, not a condition
        if arena_frag.get(node) is not None and store_used <= 0:
            arena_frag.pop(node, None)

        if hasattr(store, "flaps"):
            f = store.flaps(node)
            if f:
                flaps[node] = f

        rates = store.rates(node, prefix="raytpu_s")
        for key, pts in rates.items():
            name = key.split("{", 1)[0]
            recent = [p for p in pts if p[0] >= now - window_s]
            if not recent:
                continue
            rate = sum(p[1] for p in recent) / len(recent)
            if name == "raytpu_spill_bytes_total":
                spill[node] = spill.get(node, 0.0) + rate
            elif name == "raytpu_sched_backpressure_total":
                bp[node] = bp.get(node, 0.0) + rate

    if flaps and drain_notices:
        # scrape-target names and GCS node ids may be different lengths
        # (short vs full hex) — match on either containing the other
        draining_ids = [str(n.get("node_id") or "") for n in drain_notices
                        if n.get("active")]
        flaps = {node: c for node, c in flaps.items()
                 if not any(d and (d in str(node) or str(node) in d)
                            for d in draining_ids)}

    snap["loop_busy"] = loop_busy
    snap["loop_stalls"] = loop_stalls
    snap["arena_frag"] = arena_frag
    snap["leak_suspects"] = leaks
    snap["goodput"] = goodput
    snap["flaps"] = flaps
    snap["spill_rate"] = spill
    snap["backpressure_rate"] = bp
    snap["disk_used_frac"] = disk
    if slo:
        snap["slo"] = slo
    if sched_stats:
        # head never evaluates the GCS-owned rules, but doctor reuses
        # this builder with the full rule set — feed them when present
        shed = sched_stats.get("task_events_dropped")
        if shed:
            snap["events_shed"] = shed
            snap["events_shed_total"] = shed
    return snap
