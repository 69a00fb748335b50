"""Seeded, deterministic fault-injection plane (the chaos harness).

Reference: the chaos release tests (``chaos_network_delay.yaml`` and the
``NodeKillerActor`` in ``test_utils.py:1401``) that kill nodes and degrade
links under real workloads.  Here the harness lives INSIDE the runtime:
every process installs one :class:`FaultInjector` from config/env
(``RAYTPU_CHAOS_SPEC``), and the RPC layer (``core/rpc.py``) consults it on
every frame — so a single JSON spec degrades the whole cluster coherently,
and the same seed reproduces the same injected-fault sequence.

Spec format (JSON)::

    {
      "seed": 7,
      "rules": [
        {"kind": "delay",        "ms": 200, "prob": 1.0},
        {"kind": "drop_request", "prob": 0.05},
        {"kind": "drop_reply",   "prob": 0.05, "method": "kv_put"},
        {"kind": "fail_before",  "prob": 0.5,  "method": "register_actor"},
        {"kind": "fail_after",   "prob": 0.5,  "method": "kv_put"},
        {"kind": "partition",    "peer": "127.0.0.1:6379", "times": 10}
      ],
      "kills": [{"after_s": 3.0, "target": "worker", "node": "ab12"},
                {"kind": "preempt_node", "after_s": 5.0, "notice_s": 2.0,
                 "node": "cd34"}]
    }

Rule fields: ``kind`` (required), ``prob`` (default 1.0), ``ms`` (delay
only), ``method`` (exact RPC method name; absent = every method), ``peer``
(substring of the peer address — per-link faults; absent = every link),
``times`` (max injections for this rule; absent = unlimited).

Fault semantics (where each hook lives):

* ``delay`` — client-side: sleep before the frame is written.
* ``drop_request`` — client-side: the frame is not written and the
  connection is ABORTED (a lost frame on a live TCP stream is
  indistinguishable from the link dying), so every pending call fails fast
  with ``ConnectionLost`` instead of hanging to its timeout.
* ``drop_reply`` — server-side: the handler RAN (state committed) but the
  reply is lost and the connection aborted — the window that exercises the
  client's idempotent retry (``call_retry`` + server dedup).
* ``fail_before`` — server-side: the handler is NOT executed; the caller
  sees a :class:`ChaosFault` RemoteError (safe to retry blindly).
* ``fail_after`` — server-side: the handler executed and its result was
  recorded in the idempotency cache, but the caller sees a ChaosFault —
  a retry with the same token must observe the committed result.
* ``partition`` — client-side: calls to matching peers raise
  ``ConnectionLost`` immediately (link blackhole).
* ``kills`` — the node agent runs the schedule: at ``after_s`` seconds
  after install it kills one worker process (deterministic victim: first
  registered non-actor worker by worker id; ``node`` restricts the
  schedule entry to agents whose node id starts with that prefix).
* ``kills`` entries with ``kind: "preempt_node"`` (or ``target: "node"``)
  preempt the WHOLE matching node instead: the agent receives a shutdown
  notice of ``notice_s`` seconds and drains — stops accepting leases,
  re-homes sole-copy objects to the external spill tier / a peer, lets
  outstanding leases return, deregisters — with a hard kill when the
  notice expires.  ``notice_s: 0`` is the no-warning preemption (the node
  just dies; recovery rides the external tier and lineage).

Determinism: decisions are not drawn from a shared RNG stream (call
interleaving would perturb them) — the n-th evaluation of rule *i* for
method *m* hashes ``(seed, i, m, n)`` into a uniform fraction, so the
decision sequence per (rule, method) is a pure function of the spec.

Every injected fault increments ``raytpu_chaos_injected_total{kind}`` so
chaos is observable in the existing telemetry plane, and is appended to a
bounded decision log (``decision_log()``) that tests compare across runs.

Runtime control: GCS ``chaos_set``/``chaos_clear`` (see ``core/gcs.py``)
broadcast a new spec over pubsub and heartbeat piggyback; the ``raytpu
chaos`` CLI subcommand drives them.
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
from typing import Any, Dict, List, Optional

from .config import get_config


class ChaosFault(RuntimeError):
    """A chaos-injected failure.  By definition retryable: the runtime
    raised it deliberately, either before any state changed (fail_before)
    or after recording the committed result in the idempotency cache
    (fail_after) — ``RpcClient.call_retry`` treats it like a lost
    connection."""


#: control-plane methods the injector never faults — chaos must not be able
#: to lock out the switch that turns chaos off
_EXEMPT_METHODS = frozenset(
    {"chaos_set", "chaos_clear", "chaos_get", "chaos_update"})


def _build_chaos_counter():
    from ray_tpu_torch.util.metrics import Counter
    return Counter("raytpu_chaos_injected_total",
                   "faults injected by the chaos plane, by kind",
                   tag_keys=("kind",))


_chaos_counter_get = None


def _chaos_counter():
    global _chaos_counter_get
    if _chaos_counter_get is None:
        # deferred to first call: importing util.metrics at module import
        # time re-enters the ray_tpu_torch package init (circular import)
        from ray_tpu_torch.util.metrics import lazy
        _chaos_counter_get = lazy(_build_chaos_counter)
    return _chaos_counter_get()


class _Rule:
    __slots__ = ("kind", "prob", "ms", "method", "peer", "times", "hits")

    def __init__(self, raw: Dict[str, Any]):
        self.kind = str(raw["kind"])
        self.prob = float(raw.get("prob", 1.0))
        self.ms = float(raw.get("ms", 0.0))
        self.method = raw.get("method")
        self.peer = raw.get("peer")
        self.times = raw.get("times")
        self.hits = 0


class FaultInjector:
    """One per process; every RpcClient/RpcServer in the process consults
    it (plus the node agent's kill-schedule loop)."""

    def __init__(self, spec: Any):
        if isinstance(spec, str):
            spec = json.loads(spec) if spec.strip() else {}
        self.spec: Dict[str, Any] = dict(spec or {})
        self.seed = int(self.spec.get("seed", 0))
        self.rules: List[_Rule] = [_Rule(r) for r in self.spec.get("rules", [])]
        self.kills: List[dict] = list(self.spec.get("kills", []))
        self._lock = threading.Lock()
        self._counters: Dict[tuple, int] = {}
        self._counts: Dict[str, int] = {}
        self._log: "collections.deque" = collections.deque(maxlen=4096)

    # ------------------------------------------------------------- decisions

    def _fraction(self, rule_idx: int, method: str, n: int) -> float:
        """Deterministic uniform fraction for the n-th evaluation of one
        rule against one method — a pure function of (seed, rule, method,
        n), independent of cross-method call interleaving."""
        h = hashlib.sha256(
            f"{self.seed}|{rule_idx}|{method}|{n}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def _roll(self, rule_idx: int, rule: _Rule, method: str) -> bool:
        with self._lock:
            if rule.times is not None and rule.hits >= rule.times:
                return False
            key = (rule_idx, method)
            n = self._counters.get(key, 0)
            self._counters[key] = n + 1
        hit = (rule.prob >= 1.0
               or self._fraction(rule_idx, method, n) < rule.prob)
        if hit:
            with self._lock:
                rule.hits += 1
                self._log.append((rule.kind, method, n))
        return hit

    @staticmethod
    def _matches(rule: _Rule, method: str, peer: Optional[str]) -> bool:
        if rule.method is not None and rule.method != method:
            return False
        if rule.peer is not None and (peer is None or rule.peer not in peer):
            return False
        return True

    # ----------------------------------------------------------------- hooks

    def delay_s(self, method: str, peer: Optional[str] = None) -> float:
        """Client-side added latency for one frame (sum of matching delay
        rules that fire)."""
        if method in _EXEMPT_METHODS:
            return 0.0
        total = 0.0
        for i, r in enumerate(self.rules):
            if (r.kind == "delay" and self._matches(r, method, peer)
                    and self._roll(i, r, method)):
                total += r.ms / 1000.0
        if total > 0.0:
            self.record("delay")
        return total

    def should(self, kind: str, method: str,
               peer: Optional[str] = None) -> bool:
        """True iff a rule of ``kind`` fires for this (method, peer) call;
        records the injection when it does."""
        if method in _EXEMPT_METHODS:
            return False
        for i, r in enumerate(self.rules):
            if (r.kind == kind and self._matches(r, method, peer)
                    and self._roll(i, r, method)):
                self.record(kind)
                return True
        return False

    # ------------------------------------------------------------ accounting

    def record(self, kind: str):
        """Count one injected fault (also used by external injectors like
        the agent's kill schedule)."""
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
        c = _chaos_counter()
        if c is not None:
            c.inc(tags={"kind": kind})

    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def decision_log(self) -> List[tuple]:
        """Bounded log of (kind, method, n) triples for every injected
        fault — the artifact the determinism tests compare run-to-run."""
        with self._lock:
            return list(self._log)


# ---------------------------------------------------------------------------
# Process-wide singleton
# ---------------------------------------------------------------------------

_UNSET = object()
_injector: Any = _UNSET
_injector_lock = threading.Lock()


def _build_from_config() -> Optional[FaultInjector]:
    try:
        cfg = get_config()
    except Exception:
        return None
    spec: Optional[dict] = None
    if getattr(cfg, "chaos_spec", ""):
        try:
            spec = json.loads(cfg.chaos_spec)
        except (ValueError, TypeError):
            spec = None
    if cfg.chaos_rpc_delay_ms > 0.0:
        # Back-compat: the original single-knob harness is now just a
        # one-rule spec on the same injector.
        spec = dict(spec or {})
        spec.setdefault("rules", []).append(
            {"kind": "delay", "ms": cfg.chaos_rpc_delay_ms})
    if not spec or (not spec.get("rules") and not spec.get("kills")):
        return None
    return FaultInjector(spec)


def injector() -> Optional[FaultInjector]:
    """The process's installed injector (None = chaos disabled; the hot
    path pays one global check).  Lazily built from config/env on first
    use; replaced at runtime by :func:`install`."""
    global _injector
    if _injector is _UNSET:
        with _injector_lock:
            if _injector is _UNSET:
                _injector = _build_from_config()
    return _injector


def install(spec: Any) -> Optional[FaultInjector]:
    """Install (or, with a falsy/empty spec, clear) the runtime chaos spec
    for this process.  A runtime install overrides the config/env spec.

    Idempotent per spec: re-installing the SAME spec keeps the existing
    injector (and its counters/decision log).  The broadcast plane
    converges through several channels — pubsub, heartbeat piggyback,
    agent->worker forward — and in-process multi-agent clusters share one
    injector, so the second delivery of one chaos_set must not wipe the
    faults the first already recorded."""
    global _injector
    with _injector_lock:
        if isinstance(spec, str):
            spec = json.loads(spec) if spec.strip() else {}
        if not spec or (not spec.get("rules") and not spec.get("kills")):
            _injector = None
        elif (isinstance(_injector, FaultInjector)
                and _injector.spec == dict(spec)):
            pass  # same spec re-delivered: keep counters + decision log
        else:
            _injector = FaultInjector(spec)
        return _injector


def reset():
    """Forget the installed injector so the next :func:`injector` call
    re-derives from config/env — called by ``shutdown()`` alongside
    ``reset_config()``."""
    global _injector
    with _injector_lock:
        _injector = _UNSET
