"""Structured event framework (reference: ``src/ray/util/event.h:41``
``RAY_EVENT`` macros + ``dashboard/modules/event``).

Any process in the cluster records severity-leveled, labeled events;
they land in a bounded ring buffer in the GCS KV (namespace ``events``)
and are queryable cluster-wide (``list_events``) and over the dashboard
REST route ``/api/events``.  Redesigned for the pure-Python control
plane: instead of the reference's per-process event files + an agent
that tails and aggregates them, events ride the existing KV + pubsub —
one write per event, no files to rotate, and the ring bound is enforced
at the writer.

Usage::

    from ray_tpu_torch.util import events
    events.record("WARNING", "autoscaler", "scale-up failed",
                  node_type="v5e-8", error="quota")
    events.list_events(severity="WARNING")
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")

_NS = "events"
_RING = 1000  # per-writer ring size; a writer's oldest events are evicted
_seq = itertools.count()
_writer_id: Optional[tuple] = None  # (pid, token) — regenerated after fork


def _writer_token() -> str:
    """Random per-writer token: PIDs repeat across nodes and process
    lifetimes, so keying the ring on the PID alone lets two writers
    silently overwrite each other's rings.  Cache per-PID so a forked
    child mints its own token."""
    global _writer_id
    pid = os.getpid()
    if _writer_id is None or _writer_id[0] != pid:
        _writer_id = (pid, os.urandom(4).hex())
    return _writer_id[1]


def _kv():
    from ray_tpu_torch.experimental import internal_kv
    return internal_kv


def make_event(severity: str, source: str, message: str,
               **labels: Any):
    """Build one event's (key, value-bytes, dict) without writing it —
    for callers that must write through their own async KV path (e.g.
    the node agent's IO loop, where the blocking record() would raise)."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}")
    ev = {
        "severity": severity,
        "source": source,
        "message": message,
        "labels": {k: str(v) for k, v in labels.items()},
        "ts": time.time(),
        "pid": os.getpid(),
    }
    # Per-writer ring: each process cycles its own _RING keys (no global
    # counter round-trip); readers order by `ts`.  The key embeds a random
    # writer token because PIDs collide across nodes and restarts.
    seq = next(_seq) % _RING
    return (f"ev:{os.getpid()}:{_writer_token()}:{seq:04d}",
            json.dumps(ev).encode(), ev)


def record(severity: str, source: str, message: str,
           **labels: Any) -> Dict[str, Any]:
    """Record one structured event; returns the event dict."""
    key, blob, ev = make_event(severity, source, message, **labels)
    _kv().internal_kv_put(key, blob, namespace=_NS)
    return ev


async def record_via(gcs_call, severity: str, source: str, message: str,
                     **labels: Any) -> Dict[str, Any]:
    """Async variant for IO-loop callers (node agent, GCS-side loops):
    writes through a caller-supplied async ``call(method, **kw)`` client so
    the namespace/key scheme stays owned by this module.  KV failures are
    swallowed — event emission must never break the emitting subsystem."""
    key, blob, ev = make_event(severity, source, message, **labels)
    try:
        await gcs_call("kv_put", ns=_NS, key=key, value=blob,
                       overwrite=True)
    except Exception:
        pass
    return ev


_GLOBAL_CAP = 5000  # cluster-wide bound enforced lazily by readers


def list_events(severity: Optional[str] = None,
                source: Optional[str] = None,
                limit: int = 200) -> List[Dict[str, Any]]:
    """Cluster-wide events, newest first, optionally filtered.

    Also the reclamation point: writer tokens are unique per process
    lifetime, so dead writers' ring keys are never overwritten — each read
    (the dashboard polls this) prunes the oldest entries beyond
    ``_GLOBAL_CAP`` to keep the namespace bounded under process churn."""
    kv = _kv()
    rows: List[tuple] = []  # (ts, key, ev)
    for key in kv.internal_kv_keys("ev:", namespace=_NS):
        blob = kv.internal_kv_get(key, namespace=_NS)
        if not blob:
            continue
        try:
            ev = json.loads(blob)
        except ValueError:
            kv.internal_kv_del(key, namespace=_NS)
            continue
        rows.append((ev.get("ts", 0.0), key, ev))
    rows.sort(key=lambda r: -r[0])
    for _, key, _ev in rows[_GLOBAL_CAP:]:
        try:
            kv.internal_kv_del(key, namespace=_NS)
        except Exception:
            pass
    out = [ev for _, _, ev in rows]
    if severity:
        out = [e for e in out if e.get("severity") == severity]
    if source:
        out = [e for e in out if e.get("source") == source]
    return out[:limit]


__all__ = ["record", "record_via", "make_event", "list_events",
           "SEVERITIES"]
