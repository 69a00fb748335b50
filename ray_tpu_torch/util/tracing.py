"""Tracing: span API + chrome://tracing export.

Reference: ``python/ray/util/tracing/tracing_helper.py`` (OpenTelemetry span
wrapping — opentelemetry is lazy/optional there and absent in this image, so
spans record into the task-event stream instead and export to the same
places) and the ``ray timeline`` Chrome trace export (scripts.py).

``chrome_trace()`` converts the GCS task-event history into the Chrome Trace
Event Format (phase "X" complete events, one row per worker), loadable in
chrome://tracing or Perfetto.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: Active trace context (trace_id, span_id) — flows through TaskSpec into
#: remote execution (reference: tracing_helper.py's propagated span context),
#: so a driver span, the tasks it submits, and THEIR nested submissions all
#: share one trace id and chain parent ids.
_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("raytpu_trace_ctx", default=None)


def new_id() -> str:
    return os.urandom(6).hex()


#: Spans recorded while NO global worker exists (driver before ``init``,
#: a serve proxy process mid-boot) buffer here instead of being dropped,
#: and drain into the worker's task-event stream (-> GCS) the next time a
#: span is recorded with a worker present, or via ``flush_pending_spans``.
#: Bounded: a process that never gets a worker must not grow forever.
#: The lock covers the check-then-append and copy-then-clear windows —
#: spans are recorded from arbitrary threads (actor loops, the LLM engine
#: thread) racing the worker appearing, and an unsynchronized drain could
#: drop a concurrently-buffered span or deliver the backlog twice.
_pending: List[dict] = []
_pending_lock = threading.Lock()
_PENDING_MAX = 10_000


def _append_event(ev: dict) -> None:
    """Land one span event: into the worker's task-event stream when one
    exists (its flush loop ships batches to the GCS), else into the local
    pending buffer.  Any buffered backlog drains first so ordering by
    ``ts`` survives the buffer hop."""
    from ray_tpu_torch.core.core_worker import global_worker_or_none

    try:
        with _pending_lock:
            w = global_worker_or_none()
            if w is None:
                if len(_pending) < _PENDING_MAX:
                    _pending.append(ev)
                return
            if _pending:
                w._task_events.extend(_pending)
                _pending.clear()
            w._task_events.append(ev)
    except Exception:
        pass


def flush_pending_spans() -> int:
    """Drain spans buffered while no worker existed into the (now
    present) worker's event stream; returns how many moved.  No-op when
    there is still no worker."""
    from ray_tpu_torch.core.core_worker import global_worker_or_none

    try:
        with _pending_lock:
            w = global_worker_or_none()
            if w is None or not _pending:
                return 0
            n = len(_pending)
            w._task_events.extend(_pending)
            _pending.clear()
            return n
    except Exception:
        return 0


def record_span(name: str, t0: float, dur: float, *,
                trace_id: Optional[str] = None,
                span_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                **attributes) -> str:
    """Explicit-timestamp span record — for instrumentation whose begin and
    end straddle awaits or thread hops (serve request stages: the proxy's
    ``router_queue``, the engine's ``prefill``/``decode``), where a
    ``with span()`` block cannot bracket the measured interval.  Defaults
    parent/trace to the ambient context; returns the span id so a caller
    can chain a follow-up stage under this one."""
    parent = _ctx.get()
    if trace_id is None:
        trace_id = parent[0] if parent else new_id()
    if parent_id is None and parent is not None:
        parent_id = parent[1]
    if span_id is None:
        span_id = new_id()
    _append_event({
        "task_id": f"span-{name}-{int(t0 * 1e6)}",
        "name": name, "state": "SPAN",
        "job_id": "", "ts": t0, "dur": max(dur, 0.0),
        "actor_id": None,
        "attributes": attributes or None,
        "worker": _worker_hint(),
        "trace_id": trace_id, "span_id": span_id,
        "parent_id": parent_id,
    })
    return span_id


def _worker_hint() -> str:
    from ray_tpu_torch.core.core_worker import global_worker_or_none

    w = global_worker_or_none()
    if w is not None:
        try:
            return w.worker_id.hex()[:12]
        except Exception:
            pass
    return f"pid-{os.getpid()}"


def current_context() -> Optional[Tuple[str, str]]:
    return _ctx.get()


def set_context(ctx: Optional[Tuple[str, str]]):
    """Install (trace_id, span_id) as the active context; returns the reset
    token (used by the worker around task execution)."""
    return _ctx.set(ctx)


def reset_context(token):
    _ctx.reset(token)


@contextlib.contextmanager
def span(name: str, **attributes) -> Iterator[None]:
    """User-code span: records begin/end into the task-event stream, so user
    phases land in the same timeline as task state transitions.  Nested
    spans and remote calls made inside chain to it via the context var.
    With no global worker yet (driver before ``init``, a serve proxy
    process mid-boot) the record buffers locally and flushes through the
    worker/GCS path once one exists — never silently dropped."""
    from ray_tpu_torch.core.core_worker import global_worker_or_none

    w = global_worker_or_none()
    parent = _ctx.get()
    trace_id = parent[0] if parent else new_id()
    span_id = new_id()
    token = _ctx.set((trace_id, span_id))
    t0 = time.time()
    try:
        yield
    finally:
        _ctx.reset(token)
        _append_event({
            "task_id": f"span-{name}-{int(t0 * 1e6)}",
            "name": name, "state": "SPAN",
            "job_id": (w.job_id.hex() if w is not None and w.job_id
                       else ""),
            "ts": t0, "dur": time.time() - t0,
            "actor_id": None,
            "attributes": attributes or None,
            "worker": _worker_hint(),
            "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent[1] if parent else None,
        })


def _pid_for(ev: dict) -> str:
    return ev.get("worker") or ev.get("node_id") or "driver"


def _flow_events(out: List[dict], base: dict, ts_us: float, ev: dict):
    """Chrome flow arrows: a slice with a span_id STARTS a flow under that
    id; a slice with a parent_id FINISHES the parent's flow — the viewer
    draws arrows from parent spans to the work they caused, across
    processes."""
    if ev.get("span_id"):
        out.append({**base, "ph": "s", "cat": "flow", "ts": ts_us + 1,
                    "id": ev["span_id"]})
    if ev.get("parent_id"):
        out.append({**base, "ph": "f", "bp": "e", "cat": "flow",
                    "ts": ts_us + 1, "id": ev["parent_id"]})


def _stage_slices(out: List[dict], base: dict, stages_ev: dict):
    """Render one STAGES event (executor-side per-stage breakdown, see
    ``CoreWorker._record_stages``) as nested "X" sub-slices.  They inherit
    the parent task slice's pid/tid so the viewer nests them inside the
    task's slice — a Perfetto timeline shows where each task's wall clock
    went (dep fetch vs deserialization vs execution vs result put)."""
    for stage, (t0, dur) in sorted((stages_ev.get("stages") or {}).items(),
                                   key=lambda kv: kv[1][0]):
        out.append({"pid": base["pid"], "tid": base["tid"],
                    "name": stage, "ph": "X", "ts": t0 * 1e6,
                    "dur": max(dur * 1e6, 0.5), "cat": "stage",
                    "args": {"task_id": stages_ev.get("task_id"),
                             "task": stages_ev.get("name")}})


def chrome_trace(events: Optional[List[dict]] = None,
                 breakdown: bool = True) -> List[dict]:
    """Task events -> Chrome Trace Event Format (reference: `ray timeline`).

    RUNNING->FINISHED/FAILED pairs become complete ("X") slices; other state
    transitions become instant ("i") events; SPAN records map directly.
    With ``breakdown`` (the ``raytpu timeline --breakdown`` path), STAGES
    events become per-stage sub-slices nested inside their task's slice.
    """
    if events is None:
        import ray_tpu_torch
        events = ray_tpu_torch.timeline()

    out: List[dict] = []
    running: Dict[str, dict] = {}
    ordered = sorted(events, key=lambda e: e.get("ts", 0.0))  # sort ONCE
    # task_id -> STAGES event (latest wins: a retry's breakdown replaces
    # the killed attempt's partial one)
    stage_evs: Dict[str, dict] = {}
    if breakdown:
        for ev in ordered:
            if ev.get("state") == "STAGES":
                stage_evs[ev.get("task_id")] = ev
    rendered_stages: set = set()
    for ev in ordered:
        state = ev.get("state")
        us = ev.get("ts", 0.0) * 1e6
        base = {"pid": _pid_for(ev), "tid": _pid_for(ev),
                "name": ev.get("name") or ev.get("task_id", "")[:12]}
        trace_args = {k: ev[k] for k in ("trace_id", "span_id", "parent_id")
                      if ev.get(k)}
        if state == "SPAN":
            out.append({**base, "ph": "X", "ts": us,
                        "dur": ev.get("dur", 0.0) * 1e6,
                        "cat": "span",
                        "args": {**(ev.get("attributes") or {}),
                                 **trace_args}})
            _flow_events(out, base, us, ev)
        elif state == "RUNNING":
            running[ev.get("task_id")] = ev
        elif state == "STAGES":
            pass  # rendered as sub-slices of the task slice below
        elif state in ("FINISHED", "FAILED"):
            start = running.pop(ev.get("task_id"), None)
            if start is not None:
                start_us = start.get("ts", 0.0) * 1e6
                args = {"state": state,
                        "task_id": ev.get("task_id"),
                        **trace_args,
                        **{k: start[k] for k in
                           ("trace_id", "span_id", "parent_id")
                           if start.get(k)}}
                if ev.get("total_s") is not None:
                    args["total_s"] = ev["total_s"]
                if start.get("queue_s") is not None:
                    args["queue_s"] = start["queue_s"]
                out.append({**base, "ph": "X",
                            "ts": start_us,
                            "dur": max(us - start_us, 1.0),
                            "cat": "task",
                            "args": args})
                _flow_events(out, base, start_us, {**ev, **start})
                st_ev = stage_evs.get(ev.get("task_id"))
                if breakdown and st_ev is not None:
                    rendered_stages.add(ev.get("task_id"))
                    _stage_slices(out, base, st_ev)
            else:
                out.append({**base, "ph": "i", "ts": us, "s": "t",
                            "cat": "task", "args": {"state": state}})
        else:
            out.append({**base, "ph": "i", "ts": us, "s": "t",
                        "cat": "task", "args": {"state": state}})
    # Still-open slices render as instants so nothing is silently dropped —
    # WITH their flow arrows (span/parent ids ride the RUNNING event), so an
    # in-progress trace keeps the parent -> child arrows a finished one has.
    for task_id, start in running.items():
        base = {"pid": _pid_for(start), "tid": _pid_for(start),
                "name": start.get("name") or task_id[:12]}
        ts_us = start.get("ts", 0.0) * 1e6
        out.append({**base, "ph": "i", "ts": ts_us, "s": "t",
                    "cat": "task",
                    "args": {"state": "RUNNING",
                             "task_id": task_id,
                             **{k: start[k] for k in
                                ("trace_id", "span_id", "parent_id")
                                if start.get(k)}}})
        _flow_events(out, base, ts_us, start)
        st_ev = stage_evs.get(task_id)
        if breakdown and st_ev is not None:
            rendered_stages.add(task_id)
            _stage_slices(out, base, st_ev)
    if breakdown:
        # breakdowns whose task slice never formed (e.g. the RUNNING event
        # was trimmed from the buffer) still render, on the worker's row
        for task_id, st_ev in stage_evs.items():
            if task_id not in rendered_stages:
                base = {"pid": _pid_for(st_ev), "tid": _pid_for(st_ev)}
                _stage_slices(out, base, st_ev)
    return out


def export_chrome_trace(path: str, events: Optional[List[dict]] = None,
                        breakdown: bool = True):
    import json
    with open(path, "w") as f:
        json.dump(chrome_trace(events, breakdown=breakdown), f)
    return path
