"""Serve-plane observability: ``raytpu_serve_*`` metrics, request-scoped
stage spans, and the rolling SLO window the controller aggregates.

The runtime core got its instrumentation plane in PR 2 (task stage
histograms, RPC metrics, node telemetry); this module is the serve-side
counterpart — the path that must carry production traffic.  Three
surfaces, one kill switch (``serve_metrics_enabled``):

* **Metrics** on the shared registry (util/metrics.py), exported through
  the same per-node agent ``/metrics`` endpoint: request latency / TTFT /
  TPOT histograms, token counters, router + replica queue-depth gauges,
  batch occupancy + padding waste, KV page utilization and prefix-cache
  hit rate.  Tag values are BOUNDED: ``deployment`` and ``route`` come
  from deployment config (never raw request paths — enforced by the
  test_metric_naming.py serve lint), ``status`` is an HTTP status string.
* **Stage spans** into the task-event stream (util/tracing.py): the proxy
  stamps ``proxy_recv``/``router_queue``/``stream_write``, ``@serve.batch``
  stamps ``batch_wait``, the LLM engine stamps ``batch_wait``/``prefill``/
  ``decode`` — all chained to the request's trace context so ``raytpu
  timeline --breakdown`` renders one connected cross-process trace per
  request.
* **SLO window**: each replica process keeps a rolling window of TTFT
  samples; ``slo_snapshot`` rolls it into p50/p95/p99 + queue depth, which
  rides the health-check heartbeat to the controller — the per-deployment
  signal ``serve.status()`` / ``raytpu serve status`` / ``/api/serve``
  report and the ``policy="slo"`` autoscaler (serve/slo_autoscaler.py)
  consumes.

Hot-path discipline follows PR 2: metrics are lazy-constructed once, tag
keys are precomputed per (deployment, ...) and cached, and every record
call early-outs on one boolean when the kill switch is off.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, lazy

#: Deployment whose request is currently being handled on this
#: task/coroutine — set by the replica around user-code invocation so
#: downstream instrumentation (``@serve.batch``, the LLM engine's
#: ``submit``) can tag metrics with a config-derived deployment name
#: without threading it through every call signature.
_deployment_ctx: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("raytpu_serve_deployment", default=None)


def set_current_deployment(name: Optional[str]):
    return _deployment_ctx.set(name)


def reset_current_deployment(token):
    try:
        _deployment_ctx.reset(token)
    except ValueError:
        # an abandoned async generator's finally can run during asyncgen
        # finalization in a FRESH context (loop.call_soon) where the token
        # was never set — clear instead of raising out of cleanup
        _deployment_ctx.set(None)


def current_deployment(default: str = "-") -> str:
    return _deployment_ctx.get() or default


#: (config object, its serve_metrics_enabled) — the flag is static per
#: Config instance, so cache by identity: the hot path pays one call +
#: one `is` check instead of import + getattr per record, while
#: set_config/reset_config (tests, reinit) still take effect because they
#: install a NEW Config object.
_enabled_cache: tuple = (None, True)
_get_config = None


def enabled() -> bool:
    global _get_config, _enabled_cache
    if _get_config is None:  # deferred: avoids an import cycle at load
        from ray_tpu_torch.core.config import get_config
        _get_config = get_config
    cfg = _get_config()
    cached = _enabled_cache
    if cached[0] is cfg:
        return cached[1]
    v = bool(getattr(cfg, "serve_metrics_enabled", True))
    _enabled_cache = (cfg, v)
    return v


# --------------------------------------------------------------- metrics

#: request latencies span sub-ms cache hits to multi-minute generations
_LATENCY_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
#: per-output-token time: ms-scale on chips, 100s of ms on CPU CI
_TPOT_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5)
#: batch occupancy fraction (0..1]
_FRACTION_BOUNDS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def _build():
    return {
        "requests": Counter(
            "raytpu_serve_requests_total",
            "serve requests by deployment/route/status",
            tag_keys=("deployment", "route", "status")),
        "latency": Histogram(
            "raytpu_serve_request_latency_seconds",
            "end-to-end serve request latency at the ingress",
            boundaries=_LATENCY_BOUNDS,
            tag_keys=("deployment", "route", "status")),
        "ttft": Histogram(
            "raytpu_serve_ttft_seconds",
            "time to first token/chunk (stage=replica|engine)",
            boundaries=_LATENCY_BOUNDS, tag_keys=("deployment", "stage")),
        "tpot": Histogram(
            "raytpu_serve_tpot_seconds",
            "time per output token after the first",
            boundaries=_TPOT_BOUNDS, tag_keys=("deployment",)),
        "tokens": Counter(
            "raytpu_serve_tokens_total",
            "prompt (in) and generated (out) tokens",
            tag_keys=("deployment", "direction")),
        "router_depth": Gauge(
            "raytpu_serve_router_queue_depth",
            "in-flight requests this router has routed, per deployment",
            tag_keys=("deployment",)),
        "replica_depth": Gauge(
            "raytpu_serve_replica_queue_depth",
            "requests in flight on this replica",
            tag_keys=("deployment",)),
        "batch_size": Histogram(
            "raytpu_serve_batch_size",
            "requests flushed per @serve.batch / engine admit batch",
            boundaries=(1, 2, 4, 8, 16, 32, 64, 128, 256),
            tag_keys=("deployment",)),
        "batch_occupancy": Histogram(
            "raytpu_serve_batch_occupancy",
            "filled fraction of the batch (1 - padding waste)",
            boundaries=_FRACTION_BOUNDS, tag_keys=("deployment",)),
        "batch_wait": Histogram(
            "raytpu_serve_batch_wait_seconds",
            "time a request waited for its batch to flush",
            boundaries=_LATENCY_BOUNDS, tag_keys=("deployment",)),
        "engine_slots": Gauge(
            "raytpu_serve_engine_active_slots",
            "LLM engine decode slots currently generating",
            tag_keys=("deployment",)),
        "kv_util": Gauge(
            "raytpu_serve_kv_page_utilization",
            "fraction of paged-KV pages in use",
            tag_keys=("deployment",)),
        "prefix_lookups": Counter(
            "raytpu_serve_prefix_cache_lookups_total",
            "prefix-cache lookups by result",
            tag_keys=("deployment", "result")),
        "prefix_tokens": Counter(
            "raytpu_serve_prefix_cache_tokens_reused_total",
            "prompt tokens whose KV was served from the prefix cache",
            tag_keys=("deployment",)),
        "spec_accept": Histogram(
            "raytpu_serve_spec_acceptance_rate",
            "draft-token acceptance fraction per speculative dispatch",
            boundaries=_FRACTION_BOUNDS, tag_keys=("deployment",)),
        "spec_tokens_round": Histogram(
            "raytpu_serve_spec_tokens_per_round",
            "tokens emitted per speculative round (1..k)",
            boundaries=(1, 2, 3, 4, 6, 8, 12, 16),
            tag_keys=("deployment",)),
        "spec_rollbacks": Counter(
            "raytpu_serve_spec_rollback_tokens_total",
            "draft tokens rejected by verification and rolled back",
            tag_keys=("deployment",)),
        "prefix_route": Counter(
            "raytpu_serve_prefix_route_total",
            "cache-aware routing decisions by result (hit|miss|fallback)",
            tag_keys=("deployment", "result")),
    }


_metrics = lazy(_build)

#: precomputed sorted tags keys, interned so hot paths hand the SAME tuple
#: to inc_key/observe_key every call (PR-2 discipline).  Bounded:
#: deployments x routes x statuses, all config/enumeration-derived.
_key_cache: Dict[tuple, tuple] = {}


def _key(**tags: str) -> tuple:
    ck = tuple(sorted(tags.items()))
    return _key_cache.setdefault(ck, ck)


# ------------------------------------------------------ record helpers

def record_request(deployment: str, route: str, status: str, dur_s: float):
    """Ingress-side: one completed HTTP request.  ``route`` is the matched
    route PREFIX from deployment config (bounded), never the raw path."""
    if not enabled():
        return
    m = _metrics()
    if m is None:
        return
    k = _key(deployment=deployment, route=route, status=status)
    m["requests"].inc_key(k)
    m["latency"].observe_key(k, dur_s)


def observe_ttft(deployment: str, seconds: float, stage: str = "replica",
                 window: bool = True):
    """First token/chunk latency; ``window=True`` also feeds the rolling
    SLO window (exactly one window sample per request — the replica-level
    observation — so engine-level TTFT doesn't double-count)."""
    if not enabled():
        return
    m = _metrics()
    if m is not None:
        m["ttft"].observe_key(_key(deployment=deployment, stage=stage),
                              seconds)
    if window:
        slo_window(deployment).observe(seconds)


def observe_tpot(deployment: str, seconds_per_token: float):
    if not enabled():
        return
    m = _metrics()
    if m is not None:
        m["tpot"].observe_key(_key(deployment=deployment),
                              seconds_per_token)


def add_tokens(deployment: str, direction: str, n: int):
    if n <= 0 or not enabled():
        return
    m = _metrics()
    if m is not None:
        m["tokens"].inc_key(_key(deployment=deployment,
                                 direction=direction), n)


def set_router_queue_depth(deployment: str, depth: int):
    if not enabled():
        return
    m = _metrics()
    if m is not None:
        m["router_depth"].set_key(_key(deployment=deployment), depth)


def set_replica_queue_depth(deployment: str, depth: int):
    if not enabled():
        return
    m = _metrics()
    if m is not None:
        m["replica_depth"].set_key(_key(deployment=deployment), depth)


def record_batch(deployment: str, size: int, capacity: int,
                 waits_s: Optional[list] = None):
    """One flushed batch: size, occupancy (1 - padding waste), and each
    member's time-in-queue."""
    if not enabled():
        return
    m = _metrics()
    if m is None:
        return
    dk = _key(deployment=deployment)
    m["batch_size"].observe_key(dk, size)
    m["batch_occupancy"].observe_key(dk, size / max(capacity, 1))
    if waits_s:
        for w in waits_s:
            m["batch_wait"].observe_key(dk, w)


def set_engine_gauges(deployment: str, active_slots: int,
                      kv_pages_used: Optional[int] = None,
                      kv_pages_total: Optional[int] = None):
    if not enabled():
        return
    m = _metrics()
    if m is None:
        return
    m["engine_slots"].set_key(_key(deployment=deployment), active_slots)
    if kv_pages_total:
        m["kv_util"].set_key(_key(deployment=deployment),
                             (kv_pages_used or 0) / kv_pages_total)


def record_prefix_lookup(deployment: str, hit: bool, tokens_reused: int):
    if not enabled():
        return
    m = _metrics()
    if m is None:
        return
    m["prefix_lookups"].inc_key(
        _key(deployment=deployment, result="hit" if hit else "miss"))
    if tokens_reused > 0:
        m["prefix_tokens"].inc_key(_key(deployment=deployment),
                                   tokens_reused)


def record_spec_dispatch(deployment: str, rounds: int, tokens: int,
                         drafted: int, accepted: int):
    """One drained speculative dispatch: acceptance fraction, emitted
    tokens per round, and rejected (rolled-back) draft tokens."""
    if not enabled():
        return
    m = _metrics()
    if m is None:
        return
    dk = _key(deployment=deployment)
    if drafted > 0:
        m["spec_accept"].observe_key(dk, accepted / drafted)
    if rounds > 0:
        m["spec_tokens_round"].observe_key(dk, tokens / rounds)
    rolled = drafted - accepted
    if rolled > 0:
        m["spec_rollbacks"].inc_key(dk, rolled)


def record_prefix_route(deployment: str, result: str):
    """Cache-aware routing decision; result is hit|miss|fallback."""
    if not enabled():
        return
    m = _metrics()
    if m is None:
        return
    m["prefix_route"].inc_key(_key(deployment=deployment, result=result))


def stamp_span(name: str, t0: float, dur: float, *,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               parent_id: Optional[str] = None, **attributes):
    """Serve stage span into the task-event stream, gated on the same kill
    switch as the metrics; returns the span id (or None when shed)."""
    if not enabled():
        return None
    from ray_tpu_torch.util import tracing
    return tracing.record_span(name, t0, dur, trace_id=trace_id,
                               span_id=span_id, parent_id=parent_id,
                               **attributes)


# ------------------------------------------------------------ SLO window

class SLOWindow:
    """Rolling window of (monotonic ts, value) samples with age-out.

    ``summary()`` prunes everything older than ``window_s`` and returns
    nearest-rank percentiles over what remains — the replica-local rollup
    that piggybacks on health-check heartbeats.  Bounded two ways: by age
    and by ``max_samples`` (a flood drops oldest first), so the heartbeat
    payload and the percentile sort stay O(small)."""

    def __init__(self, window_s: float = 60.0, max_samples: int = 2048):
        self.window_s = float(window_s)
        self._samples: Deque[Tuple[float, float]] = deque(maxlen=max_samples)
        self._lock = threading.Lock()

    def observe(self, value: float, now: Optional[float] = None):
        with self._lock:
            self._samples.append((now if now is not None
                                  else time.monotonic(), float(value)))

    def _prune(self, now: float):
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def summary(self, now: Optional[float] = None) -> dict:
        now = now if now is not None else time.monotonic()
        with self._lock:
            self._prune(now)
            vals = sorted(v for _, v in self._samples)
        n = len(vals)
        if not n:
            return {"window_n": 0}

        def pct(p: float) -> float:
            return vals[min(n - 1, max(0, int(p * n + 0.5) - 1))]

        return {"window_n": n,
                "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}


_windows: Dict[str, SLOWindow] = {}
_windows_lock = threading.Lock()


def slo_window(deployment: str) -> SLOWindow:
    w = _windows.get(deployment)
    if w is None:
        from ray_tpu_torch.core.config import get_config
        with _windows_lock:
            w = _windows.setdefault(deployment, SLOWindow(
                getattr(get_config(), "serve_slo_window_s", 60.0)))
    return w


def slo_snapshot(deployment: str, queue_depth: int) -> dict:
    """The per-replica SLO signal that rides the health-check heartbeat:
    rolling TTFT percentiles (ms) + current queue depth.  With the kill
    switch off only queue depth ships (the autoscaler's minimum input —
    it predates this plane)."""
    out = {"queue_depth": int(queue_depth)}
    if not enabled():
        return out
    s = slo_window(deployment).summary()
    out["window_n"] = s.get("window_n", 0)
    for p in ("p50", "p95", "p99"):
        if p in s:
            out[f"ttft_{p}_ms"] = round(s[p] * 1000.0, 3)
    return out


# ------------------------------------------------------- loop monitor

def ensure_loop_monitor(holder, source: str):
    """Install the event-loop stall detector on the CURRENT (actor) event
    loop, once per holder object — serve replica / proxy / controller
    processes run their request handling on an actor loop distinct from
    the worker's RPC loop, so the core worker's monitor cannot see a
    decode step wedging THIS loop.  Config-gated like every other
    install (``loop_monitor_enabled``); stores the monitor on the holder
    so drain/shutdown paths can stop it."""
    if getattr(holder, "_serve_loop_monitor", None) is not None:
        return holder._serve_loop_monitor
    holder._serve_loop_monitor = False  # tried; don't retry every request
    try:
        import asyncio

        from ray_tpu_torch.core.core_worker import global_worker_or_none
        from ray_tpu_torch.util.loop_monitor import install

        w = global_worker_or_none()
        gcs_call = w.gcs.call if w is not None and w.gcs else None
        mon = install(asyncio.get_event_loop(), source, gcs_call=gcs_call)
        if mon is not None:
            holder._serve_loop_monitor = mon
        return mon
    except Exception:
        return None
