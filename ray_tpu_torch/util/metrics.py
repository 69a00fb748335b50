"""User-defined metrics: Counter / Gauge / Histogram.

Reference: ``python/ray/util/metrics.py`` (the Cython metric surface) and the
export pipeline ``src/ray/stats`` -> per-node agent ->
``_private/metrics_agent.py:375`` (Prometheus).  Here each process keeps a
registry; a daemon thread pushes snapshots to its node agent, which serves
the Prometheus text endpoint (``node_agent._render_prometheus``).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_BOUNDARIES = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                      5.0, 10.0, 30.0, 60.0)

#: Prometheus metric-name grammar (exposition format spec).  The previous
#: ``name.replace("_","").isalnum()`` check both rejected valid names with
#: colons and accepted non-ASCII alphanumerics that Prometheus rejects.
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}
_flusher_started = False


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None and existing.kind != self.kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{existing.kind}")
            _registry[name] = self
        _ensure_flusher()

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]):
        if self._default_tags or tags:
            merged = dict(self._default_tags)
            merged.update(tags or {})
            return merged
        return None

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only go up")
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def inc_key(self, key: tuple, value: float = 1.0):
        """Hot-path increment with a PRECOMPUTED sorted tags key (the tuple
        ``_tags_key`` would produce).  RPC/task hot paths cache these keys
        per method/stage — skipping the per-call dict build + sort is what
        keeps instrumentation inside its overhead budget."""
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def snapshot(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "help": self.description,
                    "values": dict(self._values)}


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[_tags_key(self._merged(tags))] = float(value)

    def set_key(self, key: tuple, value: float):
        """Hot-path set with a precomputed tags key (see Counter.inc_key)."""
        with self._lock:
            self._values[key] = float(value)

    def set_fn(self, fn) -> "Gauge":
        """Pull-based gauge: ``fn()`` is sampled at snapshot time instead of
        the instrumented code pushing on every change — the right shape for
        values that change per hot-path event (e.g. RPC in-flight count),
        where even a cheap per-event set() is pure overhead."""
        self._value_fn = fn
        return self

    def snapshot(self) -> dict:
        fn = getattr(self, "_value_fn", None)
        if fn is not None:
            try:
                self.set_key((), float(fn()))
            except Exception:
                pass
        with self._lock:
            return {"kind": self.kind, "help": self.description,
                    "values": dict(self._values)}


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries=DEFAULT_BOUNDARIES,
                 tag_keys=()):
        self.boundaries = tuple(sorted(boundaries))
        self._buckets: Dict[tuple, List[int]] = {}
        self._sum: Dict[tuple, float] = {}
        self._count: Dict[tuple, int] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self.observe_key(_tags_key(self._merged(tags)), value)

    def observe_key(self, key: tuple, value: float):
        """Hot-path observe with a precomputed tags key (see
        Counter.inc_key)."""
        with self._lock:
            buckets = self._buckets.get(key)
            if buckets is None:
                buckets = self._buckets[key] = \
                    [0] * (len(self.boundaries) + 1)
            i = bisect.bisect_left(self.boundaries, value)
            buckets[i if i < len(self.boundaries) else -1] += 1
            self._sum[key] = self._sum.get(key, 0.0) + value
            self._count[key] = self._count.get(key, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "help": self.description,
                    "boundaries": self.boundaries,
                    "buckets": {k: list(v) for k, v in self._buckets.items()},
                    "sum": dict(self._sum), "count": dict(self._count)}


# ------------------------------------------------- data-plane copy accounting

class CopyStats:
    """Process-local counters of DATA-PLANE byte copies (object payloads
    moving through put/get/transfer), keyed by operation.

    This is the instrument behind the object plane's copy discipline: a
    large ``put`` must record exactly one ``object_write`` (the single
    serialize-into-arena memcpy), a same-host ``get`` must record zero
    ``get_copy`` events (pinned zero-copy views), and
    ``serialize_flatten`` must stay at zero on the put path (it fires when
    a large payload is materialized through an intermediate contiguous
    ``bytes`` blob).  Tests assert on these counters directly — they are
    deterministic, unlike GB/s numbers — and the snapshot is exported
    through the regular metrics registry as ``raytpu_data_copies`` /
    ``raytpu_bytes_copied``.
    """

    #: payloads below this size are not accounted (headers, inline values)
    ACCOUNT_THRESHOLD = 64 * 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._bytes: Dict[str, int] = {}

    def record(self, op: str, nbytes: int, force: bool = False):
        if not force and nbytes < self.ACCOUNT_THRESHOLD:
            return
        with self._lock:
            self._counts[op] = self._counts.get(op, 0) + 1
            self._bytes[op] = self._bytes.get(op, 0) + int(nbytes)

    def count(self, op: str) -> int:
        with self._lock:
            return self._counts.get(op, 0)

    def bytes(self, op: str) -> int:
        with self._lock:
            return self._bytes.get(op, 0)

    def snapshot(self) -> Dict[str, Tuple[int, int]]:
        with self._lock:
            return {op: (self._counts[op], self._bytes.get(op, 0))
                    for op in self._counts}

    def reset(self):
        with self._lock:
            self._counts.clear()
            self._bytes.clear()


#: process-wide instance; hot paths call ``copy_stats.record(...)``
copy_stats = CopyStats()


def _copy_stats_metrics() -> Dict[str, dict]:
    """Render copy_stats as synthetic counter snapshots for export."""
    snap = copy_stats.snapshot()
    if not snap:
        return {}
    return {
        "raytpu_data_copies": {
            "kind": "counter", "help": "data-plane copy events by op",
            "values": {(("op", op),): c for op, (c, _b) in snap.items()}},
        "raytpu_bytes_copied": {
            "kind": "counter", "help": "data-plane bytes copied by op",
            "values": {(("op", op),): b for op, (_c, b) in snap.items()}},
    }


# ---------------------------------------------------------------- flushing

def get_metric(name: str) -> Optional["Metric"]:
    """Look up a registered metric by name (None if never constructed) —
    the introspection seam tests and the chaos harness use to read
    counters like ``raytpu_chaos_injected_total`` without re-registering
    them."""
    with _registry_lock:
        return _registry.get(name)


def snapshot_registry() -> Dict[str, dict]:
    with _registry_lock:
        metrics = list(_registry.items())
    out = {name: m.snapshot() for name, m in metrics}
    out.update(_copy_stats_metrics())
    return out


def _flush_once() -> bool:
    """Push this process's registry to its node agent (best effort)."""
    try:
        from ray_tpu_torch.core.core_worker import global_worker_or_none
        from ray_tpu_torch.core.rpc import run_async

        w = global_worker_or_none()
        if w is None or w.agent is None:
            return False
        try:
            from ray_tpu_torch.core.api import _state
            agent = getattr(_state, "node_agent", None)
            if (agent is not None
                    and agent.server.address == w.agent_address):
                # Local mode: the node agent lives in THIS process and its
                # /metrics handler serves this same process-global registry
                # directly (reporter "agent-<nid>") — pushing it again would
                # double every series under a second reporter label.
                return True
        except Exception:
            pass
        snap = snapshot_registry()
        if not snap:
            return True
        run_async(w.agent.call(
            "report_metrics",
            reporter=f"{w.mode}-{w.worker_id.hex()[:12]}",
            metrics=snap), timeout=5)
        return True
    except Exception:
        return False


def flush_metrics() -> bool:
    """Push this process's registry to its node agent NOW (one flusher
    tick, synchronously).  Short-lived processes — a train worker killed
    moments after its loop finishes — call this at their last report so
    the final gauge/counter values survive the process; everyone else
    rides the periodic flusher."""
    return _flush_once()


def _ensure_flusher(period_s: float = 2.0):
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True

    def loop():
        while True:
            time.sleep(period_s)
            _flush_once()

    threading.Thread(target=loop, daemon=True,
                     name="metrics-flush").start()


def lazy(factory):
    """Memoize a metric-construction factory for hot-path instrumentation:
    ``lazy(build)()`` builds once on first call and returns the same object
    after; a construction failure (registry kind conflict, import error
    mid-teardown) logs ONCE and returns None forever — instrumentation
    degrades visibly-but-gracefully instead of either crashing the hot path
    or silently vanishing.  Shared by rpc/core_worker/node_agent/
    loop_monitor so the pattern lives in one place."""
    state: list = [None]

    def get():
        if state[0] is None:
            try:
                state[0] = factory() or False
            except Exception as e:  # noqa: BLE001 — never break the hot path
                state[0] = False
                try:
                    import sys
                    print(f"[ray_tpu_torch] metrics disabled for "
                          f"{getattr(factory, '__qualname__', factory)!r}: "
                          f"{type(e).__name__}: {e}", file=sys.stderr)
                except Exception:
                    pass
        return state[0] or None

    return get


def latency_summary(samples: Sequence[float]) -> Optional[dict]:
    """count/mean/p50/p90/p99/max rollup of raw duration samples — the
    shape ``state.summarize_tasks`` and ``raytpu status`` report per task
    stage.  Nearest-rank percentiles: exact on the sorted sample set, no
    interpolation surprises on tiny n."""
    if not samples:
        return None
    s = sorted(samples)
    n = len(s)

    def pct(p: float) -> float:
        return s[min(n - 1, max(0, int(p * n + 0.5) - 1))]

    return {"count": n, "mean": sum(s) / n, "p50": pct(0.50),
            "p90": pct(0.90), "p99": pct(0.99), "max": s[-1]}


# ------------------------------------------------------------- rendering

def escape_label_value(v) -> str:
    """Exposition-format label-value escaping: backslash, double-quote and
    newline must be escaped or an arbitrary tag string (an exception repr,
    a path with quotes) yields malformed output that scrapers reject."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def render_prometheus(per_reporter: Dict[str, Dict[str, dict]]) -> str:
    """{reporter -> {metric -> snapshot}} -> Prometheus exposition text."""
    out: List[str] = []
    seen_header = set()

    def fmt_tags(key: tuple, extra: Dict[str, str]) -> str:
        pairs = dict(key)
        pairs.update(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in sorted(pairs.items()))
        return "{" + inner + "}"

    for reporter, metrics in sorted(per_reporter.items()):
        for name, snap in sorted(metrics.items()):
            if name not in seen_header:
                seen_header.add(name)
                if snap.get("help"):
                    out.append(f"# HELP {name} {snap['help']}")
                out.append(f"# TYPE {name} {snap['kind']}")
            extra = {"reporter": reporter}
            if snap["kind"] in ("counter", "gauge"):
                for key, v in snap["values"].items():
                    out.append(f"{name}{fmt_tags(key, extra)} {v}")
            elif snap["kind"] == "histogram":
                bounds = snap["boundaries"]
                for key, buckets in snap["buckets"].items():
                    acc = 0
                    for i, b in enumerate(bounds):
                        acc += buckets[i]
                        out.append(
                            f"{name}_bucket"
                            f"{fmt_tags(key, {**extra, 'le': str(b)})} {acc}")
                    acc += buckets[-1]
                    out.append(
                        f"{name}_bucket"
                        f"{fmt_tags(key, {**extra, 'le': '+Inf'})} {acc}")
                    out.append(f"{name}_sum{fmt_tags(key, extra)} "
                               f"{snap['sum'][key]}")
                    out.append(f"{name}_count{fmt_tags(key, extra)} "
                               f"{snap['count'][key]}")
    return "\n".join(out) + "\n"
