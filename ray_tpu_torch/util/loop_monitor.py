"""Event-loop stall detector — the asyncio analogue of the reference's
race/deadlock tooling (SURVEY §5.2: TSAN builds + ``RAY_CHECK``-style
watchdogs in ``src/ray/util``).

The whole control plane here rides ONE asyncio loop per process
(core/rpc.py); the failure mode that discipline invites is a callback
that blocks the loop — a synchronous file read, a pickle of a huge
object, an accidental ``time.sleep`` — freezing every RPC the process
serves. C++ Ray catches its analogues with sanitizer builds; a Python
runtime can do better at runtime: a sibling thread heartbeats the loop
with ``call_soon_threadsafe`` and, when an echo is overdue, captures the
loop thread's CURRENT stack (``sys._current_frames``) — naming the
exact frame that is blocking, not just the fact of the stall.

Enable per-process via config ``loop_monitor_enabled`` (the node agent
and GCS turn it on when set) or directly::

    mon = LoopMonitor(loop, threshold_s=0.5, on_stall=print)
    mon.start()

Each stall invokes ``on_stall(stall_s, stack_str)`` once (re-armed after
the loop recovers) — the runtime wires this to a WARNING structured
event (util/events.py) tagged ``source=loop_monitor``.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Optional

__all__ = ["LoopMonitor", "install", "format_loop_stack"]

# Lazy gauges shared by every monitor in the process (tag `process`
# separates the series): current heartbeat lag, stall count and worst
# stall land in the metrics registry so agent/worker asyncio stalls show
# up on /metrics next to the runtime metrics, not only as WARNING events.
def _build_lag_gauges():
    from ray_tpu_torch.util.metrics import Gauge
    return (
        Gauge("raytpu_event_loop_lag_seconds",
              "event-loop heartbeat lag beyond the probe interval",
              tag_keys=("process",)),
        Gauge("raytpu_event_loop_stalls",
              "stall episodes (lag beyond threshold) since start",
              tag_keys=("process",)),
        # keeps the pre-existing series name alive (it used to be rendered
        # as agent-local text on /metrics; now per-process and registry-fed)
        Gauge("raytpu_loop_worst_stall_seconds",
              "longest single stall observed since start",
              tag_keys=("process",)),
    )


_lag_gauges_get = None


def _lag_gauges():
    global _lag_gauges_get
    if _lag_gauges_get is None:
        # deferred to first call: keeps this module import-light (and
        # consistent with the other lazy metric singletons)
        from ray_tpu_torch.util.metrics import lazy
        _lag_gauges_get = lazy(_build_lag_gauges)
    return _lag_gauges_get()


def _build_busy_gauge():
    from ray_tpu_torch.util.metrics import Gauge
    return Gauge("raytpu_loop_busy_fraction",
                 "fraction of wall time the event-loop thread spent on-CPU "
                 "over the last sampling window (thread-CPU clock deltas "
                 "measured from inside the loop)",
                 tag_keys=("process",))


_busy_gauge_get = None


def _busy_gauge():
    """Gauge behind the sched_metrics_enabled kill switch: never
    constructed (zero series) while the switch is off."""
    from ray_tpu_torch.core import sched_explain
    if not sched_explain.enabled():
        return None
    global _busy_gauge_get
    if _busy_gauge_get is None:
        from ray_tpu_torch.util.metrics import lazy
        _busy_gauge_get = lazy(_build_busy_gauge)
    return _busy_gauge_get()


def format_loop_stack(thread_id: Optional[int]) -> str:
    """Render the current stack of one thread (the loop's) — the
    blocking frame is the deepest application frame."""
    frames = sys._current_frames()
    frame = frames.get(thread_id) if thread_id is not None else None
    if frame is None:
        return "<loop thread stack unavailable>"
    return "".join(traceback.format_stack(frame))


class LoopMonitor:
    """Heartbeat the loop from a daemon thread; report overdue echoes.

    The probe is O(1) per interval (one threadsafe callback), cheap
    enough to leave on in production — the reference pays for its race
    coverage with separate sanitizer CI builds; this rides along.
    """

    #: minimum window over which one busy-fraction sample is computed
    BUSY_WINDOW_S = 0.5

    def __init__(self, loop, threshold_s: float = 0.5,
                 interval_s: float = 0.1,
                 on_stall: Optional[Callable[[float, str], None]] = None,
                 source: str = "", busy_enabled: bool = False,
                 stall_gauges: bool = True):
        self.loop = loop
        self.threshold_s = float(threshold_s)
        self.interval_s = float(interval_s)
        self.on_stall = on_stall
        self.source = source
        #: export the lag/stall gauges (loop_monitor_enabled scope); a
        #: busy-only monitor (sched_metrics_enabled alone) must not grow
        #: series outside its documented kill switch
        self.stall_gauges = bool(stall_gauges)
        self.stall_count = 0
        self.worst_stall_s = 0.0
        # Busy-fraction sampling (the control-plane saturation signal):
        # the echo callback runs ON the loop thread, where
        # time.thread_time() reads that thread's CPU clock — so
        # delta(cpu)/delta(wall) between echoes is exactly the fraction of
        # wall time the loop spent executing callbacks vs parked in epoll.
        # This is what turns "tasks_async is slow" into "the owner loop is
        # 97% busy" (vs "the loop is idle; the bottleneck is elsewhere").
        self.busy_enabled = bool(busy_enabled)
        self.busy_fraction = 0.0
        self._busy_prev: Optional[tuple] = None  # (wall, thread_cpu)
        self._last_echo = time.monotonic()
        self._loop_thread_id: Optional[int] = None
        self._reported_current = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- loop side ---------------------------------------------------------
    def _echo(self):
        self._last_echo = time.monotonic()
        self._loop_thread_id = threading.get_ident()
        self._reported_current = False
        if self.busy_enabled:
            now, cpu = time.monotonic(), time.thread_time()
            prev = self._busy_prev
            if prev is None:
                self._busy_prev = (now, cpu)
            elif now - prev[0] >= self.BUSY_WINDOW_S:
                dt = now - prev[0]
                self.busy_fraction = min(1.0, max(0.0,
                                                  (cpu - prev[1]) / dt))
                self._busy_prev = (now, cpu)

    # -- monitor thread ----------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            try:
                self.loop.call_soon_threadsafe(self._echo)
            except RuntimeError:  # loop closed
                return
            self._stop.wait(self.interval_s)
            overdue = time.monotonic() - self._last_echo
            if self.source and self.stall_gauges:
                # a healthy loop echoes within ~interval_s of the probe, so
                # lag is whatever the echo is overdue beyond that
                g = _lag_gauges()
                if g is not None:
                    try:
                        tags = {"process": self.source}
                        g[0].set(max(0.0, overdue - self.interval_s), tags)
                        g[1].set(self.stall_count, tags)
                        g[2].set(self.worst_stall_s, tags)
                    except Exception:
                        pass
            if self.source and self.busy_enabled:
                bg = _busy_gauge()
                if bg is not None:
                    try:
                        # process KIND only ("worker", "driver", "gcs",
                        # "node_agent"...): the per-process id suffix would
                        # be an unbounded tag value under worker churn —
                        # the reporter label already separates processes
                        bg.set(self.busy_fraction,
                               {"process": self.source.split(":", 1)[0]})
                    except Exception:
                        pass
            if overdue > self.threshold_s:
                # worst-stall tracks the FULL duration (it keeps growing
                # while the episode lasts); the report fires once per
                # episode, re-armed by the next echo
                self.worst_stall_s = max(self.worst_stall_s, overdue)
            if overdue > self.threshold_s and not self._reported_current:
                self._reported_current = True
                self.stall_count += 1
                if self.on_stall is not None:
                    try:
                        self.on_stall(
                            overdue, format_loop_stack(self._loop_thread_id))
                    except Exception:
                        pass

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="raytpu-loop-monitor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def stats(self) -> dict:
        return {"stall_count": self.stall_count,
                "worst_stall_s": self.worst_stall_s,
                "threshold_s": self.threshold_s}


def install(loop, source: str, gcs_call=None) -> Optional[LoopMonitor]:
    """Config-gated install used by the runtime processes (node agent,
    GCS). Off by default — like the reference's sanitizer builds, the
    race tooling is opt-in (``loop_monitor_enabled`` system config).

    The stall handler runs on the MONITOR thread while the loop is
    wedged, so it must never await; the distress event is enqueued via
    ``call_soon_threadsafe`` and flushes once the loop recovers — late,
    but carrying the stack captured DURING the stall, which is the part
    that matters.

    The saturation plane rides the same probe: with
    ``sched_metrics_enabled`` on, the monitor installs even when stall
    reporting is off and samples the loop's busy fraction
    (``raytpu_loop_busy_fraction{process}``) — stall events remain gated
    on ``loop_monitor_enabled``."""
    from ray_tpu_torch.core import sched_explain
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    stalls = getattr(cfg, "loop_monitor_enabled", False)
    busy = sched_explain.enabled()
    if not stalls and not busy:
        return None

    def on_stall(stall_s: float, stack: str):
        if gcs_call is None:
            return
        from ray_tpu_torch.util import events

        def enqueue():
            import asyncio
            asyncio.ensure_future(events.record_via(
                gcs_call, "WARNING", "loop_monitor",
                f"{source}: event loop blocked {stall_s * 1e3:.0f}ms",
                process=source, stall_ms=f"{stall_s * 1e3:.0f}",
                stack=stack[-2000:]))

        try:
            loop.call_soon_threadsafe(enqueue)
        except RuntimeError:
            pass

    mon = LoopMonitor(loop, threshold_s=cfg.loop_monitor_threshold_s,
                      on_stall=on_stall if stalls else None, source=source,
                      busy_enabled=busy, stall_gauges=stalls)
    return mon.start()
