"""Train-plane observability: per-step wall-clock decomposition, running
MFU + goodput, device-memory gauges, per-step trace spans, and the
per-worker rollup that rides the report channel into ``train.Result``
and ``train.status()``.

The runtime core got its instrumentation plane in PR 2 and the serve
path in PR 6; this module is the *training* counterpart — the measuring
stick for ROADMAP item 3 ("push single-chip MFU to >= 0.50"): MFU/flops
math that previously lived only in offline bench scripts (``bench.py``,
``ray_tpu_torch/models/config.py``) now runs inside the train loop.  Three
surfaces, one kill switch (``train_metrics_enabled``):

* **Metrics** on the shared registry (util/metrics.py), exported through
  the per-node agent ``/metrics`` endpoint: per-stage wall-clock
  histograms (``data_wait`` / ``host_to_device`` / ``step_compute`` /
  ``checkpoint``), step-time histogram with the FIRST step's compute
  split out into ``raytpu_train_compile_seconds`` (the jit trace+compile
  call must not poison the step medians), running MFU computed from the
  model's ``flops_per_token()`` against the chip's detected peak
  (``models.config.detect_peak_flops``), goodput fraction (productive
  step time / wall clock since loop start), token/step counters, and
  ``memory_stats()`` gauges.  Tag values are BOUNDED: only ``rank`` and
  ``stage`` (enforced by the test_metric_naming.py train lint) — never
  hostnames or trial ids.
* **Stage spans** into the task-event stream (util/tracing.py): each
  step records a ``train_step`` span chained to the ambient trace
  context — the ``start_training`` actor task carries the chief's span,
  so ``raytpu timeline --breakdown`` renders one connected
  chief -> worker-task -> step chain per rank, with the recorded phases
  nested under each step.
* **Rollup**: ``StepTracker.snapshot()`` piggybacks on the existing
  report channel (``TrainContext.report`` -> ``TrainWorker.next_result``)
  so the driver aggregates per-rank snapshots every barrier round into
  ``train.Result.train_obs`` and the live ``train.status()`` registry —
  no extra RPC.

Hot-path discipline follows PR 2/PR 6: metrics are lazy-constructed
once, tag keys are precomputed per (rank, stage) and every record call
early-outs on one boolean when the kill switch is off.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram, lazy,
                                  latency_summary)

#: (config object, its train_metrics_enabled) — static per Config
#: instance, so cache by identity (same pattern as serve/observability).
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
    v = bool(getattr(cfg, "train_metrics_enabled", True))
    _enabled_cache = (cfg, v)
    return v


# --------------------------------------------------------------- metrics

#: step/stage times span ms-scale CPU toys to multi-second pod steps
_STEP_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
#: compile can run minutes on big models
_COMPILE_BOUNDS = (0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
                   600.0, 1800.0)


def _build():
    return {
        "step": Histogram(
            "raytpu_train_step_seconds",
            "wall clock per training step (compile step excluded)",
            boundaries=_STEP_BOUNDS, tag_keys=("rank",)),
        "stage": Histogram(
            "raytpu_train_stage_seconds",
            "per-step wall-clock decomposition "
            "(data_wait/host_to_device/step_compute/checkpoint)",
            boundaries=_STEP_BOUNDS, tag_keys=("rank", "stage")),
        "compile": Histogram(
            "raytpu_train_compile_seconds",
            "first-call jit trace+compile time split out of step medians",
            boundaries=_COMPILE_BOUNDS, tag_keys=("rank",)),
        "steps": Counter(
            "raytpu_train_steps_total",
            "training steps completed", tag_keys=("rank",)),
        "tokens": Counter(
            "raytpu_train_tokens_total",
            "tokens consumed by completed steps", tag_keys=("rank",)),
        "mfu": Gauge(
            "raytpu_train_mfu",
            "running model-flops utilization over the recent step window",
            tag_keys=("rank",)),
        "goodput": Gauge(
            "raytpu_train_goodput_fraction",
            "productive step time / wall clock since the loop started",
            tag_keys=("rank",)),
        "mem_used": Gauge(
            "raytpu_train_device_bytes_in_use",
            "accelerator memory in use (device memory_stats)",
            tag_keys=("rank",)),
        "mem_peak": Gauge(
            "raytpu_train_device_peak_bytes",
            "peak accelerator memory since program start",
            tag_keys=("rank",)),
        "mem_limit": Gauge(
            "raytpu_train_device_bytes_limit",
            "accelerator memory capacity", tag_keys=("rank",)),
        "resizes": Counter(
            "raytpu_train_resizes_total",
            "elastic worker-group resizes (in place, no job restart)",
            tag_keys=("direction",)),
        "collective_bytes": Counter(
            "raytpu_train_collective_bytes_total",
            "per-device bytes this rank put on the wire in gradient/param "
            "collectives, by collective op and wire dtype — the series "
            "that shows the int8 quantized-reduce win (parallel/zero.py)",
            tag_keys=("rank", "op", "dtype")),
        "opt_bytes": Gauge(
            "raytpu_train_opt_state_bytes",
            "resident optimizer-state bytes on this rank (ZeRO sharding "
            "divides this by the dp world size)",
            tag_keys=("rank",)),
    }


_metrics = lazy(_build)

#: the canonical stage names; phase() accepts others but the lint keeps
#: the tag domain reviewable
STAGES = ("data_wait", "host_to_device", "step_compute", "checkpoint")


def _device_memory_stats() -> Optional[Dict[str, int]]:
    """The current CUDA card's allocated, peak and total bytes — only when
    this process has ALREADY initialised CUDA (observability must never be
    the thing that drags the accelerator runtime in)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    try:
        stats = torch.cuda.memory_stats()
        _, total = torch.cuda.mem_get_info()
        return {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
                "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
                "bytes_limit": int(total)}
    except Exception:
        return None


class StepTracker:
    """Per-rank training-step instrumentation.

    Created by ``TrainWorker.init_session`` and reachable from the user
    loop as ``train.get_context().observability()``::

        cfg = llama_400m()            # the model being trained
        batch_size, seq = 8, 2048
        obs = train.get_context().observability()
        obs.set_model(cfg, seq_len=seq, tokens_per_step=batch_size * seq)
        for _ in range(steps):
            with obs.phase("data_wait"):
                batch = next(it)
            with obs.phase("step_compute"):
                state, metrics = step(state, batch)
            train.report({...})       # <- closes the step

    A *step* runs from the previous ``report()`` barrier release to the
    next ``report()`` call, so the step wall clock and the goodput
    denominator exist even in an un-instrumented loop; the ``phase``
    blocks refine it into the data_wait/host_to_device/step_compute/
    checkpoint decomposition.  The FIRST step's compute is recorded as
    compile time (first-call jit trace+compile) and excluded from the
    step histogram, the recent-window median, and the productive-time
    numerator.
    """

    #: recent-step window for the running MFU / step-time percentiles
    WINDOW = 256
    #: full snapshots (percentile sort, memory_stats) recompute at most
    #: this often — between recomputes report() piggybacks the cached one
    #: (the driver's rollup lags <1 s; Result gets a fresh final snapshot)
    SNAPSHOT_PERIOD_S = 0.5

    def __init__(self, rank: int, trial: str = ""):
        self.rank = int(rank)
        self.trial = trial
        self._k_rank = (("rank", str(rank)),)
        self._k_stage: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        now = time.monotonic()
        self._train_t0 = now
        self._step_t0 = now
        self._steps = 0
        self._compile_s: Optional[float] = None
        self._productive_s = 0.0
        self._step_walls: Deque[float] = deque()
        self._wall_sum = 0.0  # running sum of _step_walls (O(1) MFU)
        self._stage_totals: Dict[str, float] = {}
        self._phases: Dict[str, float] = {}
        self._phase_spans: List[Tuple[str, float, float]] = []
        self._tokens_total = 0
        #: precomputed ((tag_key_tuple, bytes), ...) incremented per step
        self._collective_rates: Tuple[Tuple[tuple, int], ...] = ()
        self._collective_per_step: Optional[Dict[str, int]] = None
        self._opt_state_bytes: Optional[int] = None
        self._flops_per_token: Optional[float] = None
        self._tokens_per_step: Optional[int] = None
        self._peak_flops: Optional[float] = None
        self._mfu: Optional[float] = None
        self._goodput: Optional[float] = None
        self._memory: Optional[Dict[str, int]] = None
        self._last_step: Optional[Dict[str, Any]] = None
        self._snap_cache: Optional[dict] = None
        self._snap_ts = 0.0
        self._span_window_ts = 0.0
        self._span_window_n = 0

    # ----------------------------------------------------------- config

    def set_model(self, model_config=None, *, seq_len: Optional[int] = None,
                  tokens_per_step: Optional[int] = None,
                  flops_per_token: Optional[float] = None,
                  peak_flops: Optional[float] = None) -> "StepTracker":
        """Teach the tracker the MFU arithmetic: either a
        ``TransformerConfig``-style object (its ``flops_per_token(seq)``
        is used) or an explicit ``flops_per_token``; ``tokens_per_step``
        is the GLOBAL batch in tokens divided by world size (i.e. this
        rank's share).  ``peak_flops`` defaults to the detected peak of
        the local accelerator (``models.config.detect_peak_flops``)."""
        if model_config is not None and flops_per_token is None:
            try:
                flops_per_token = model_config.flops_per_token(seq_len)
            except Exception:
                flops_per_token = None
        if flops_per_token is not None:
            self._flops_per_token = float(flops_per_token)
        if tokens_per_step is not None:
            self._tokens_per_step = int(tokens_per_step)
        if peak_flops is not None:
            self._peak_flops = float(peak_flops)
        elif self._peak_flops is None:
            self._peak_flops = self._detect_peak()
        return self

    def set_collectives(self, bytes_per_step: Optional[Dict[Any, int]] = None,
                        opt_state_bytes: Optional[int] = None) -> "StepTracker":
        """Teach the tracker the step's wire/HBM accounting.

        ``bytes_per_step``: {(op, dtype): per-device bytes each step puts
        on the wire} — the ``step.collective_bytes`` attribute of the
        train-step builders.  Tag keys are precomputed here so the hot
        path only increments.  ``opt_state_bytes`` (the builders'
        ``step.opt_state_bytes``) sets the resident-optimizer gauge once.
        """
        if bytes_per_step is not None:
            rates = []
            snap: Dict[str, int] = {}
            for (op, dtype), nbytes in sorted(bytes_per_step.items()):
                key = tuple(sorted((("rank", str(self.rank)),
                                    ("op", str(op)), ("dtype", str(dtype)))))
                rates.append((key, int(nbytes)))
                snap[f"{op}/{dtype}"] = int(nbytes)
            with self._lock:
                self._collective_rates = tuple(rates)
                self._collective_per_step = snap
        if opt_state_bytes is not None:
            with self._lock:
                self._opt_state_bytes = int(opt_state_bytes)
            if enabled():
                m = _metrics()
                if m is not None:
                    m["opt_bytes"].set_key(self._k_rank, int(opt_state_bytes))
        return self

    @staticmethod
    def _detect_peak() -> Optional[float]:
        torch = sys.modules.get("torch")
        if torch is None:
            return None
        try:
            from ray_tpu_torch.models.config import detect_peak_flops
            return detect_peak_flops(
                torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_initialized() else torch.device("cpu"))
        except Exception:
            return None

    # ------------------------------------------------------------ hot path

    def start(self) -> None:
        """Reset the wall/goodput clocks — called at loop entry so agent
        boot and session setup don't count against goodput."""
        now = time.monotonic()
        with self._lock:
            self._train_t0 = now
            self._step_t0 = now

    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute a slice of the current step to one stage
        (``data_wait`` / ``host_to_device`` / ``step_compute`` /
        ``checkpoint``).  No-op cost with the kill switch off."""
        if not enabled():
            yield
            return
        # one clock, not two: wall time serves both the duration and the
        # span timestamp (phase durations are ms-scale; monotonic's
        # immunity to clock steps isn't worth a second syscall per edge)
        t0 = time.time()
        try:
            yield
        finally:
            dur = time.time() - t0
            with self._lock:
                self._phases[name] = self._phases.get(name, 0.0) + dur
                self._phase_spans.append((name, t0, dur))

    def _stage_key(self, name: str) -> tuple:
        k = self._k_stage.get(name)
        if k is None:
            k = self._k_stage[name] = tuple(sorted(
                (("rank", str(self.rank)), ("stage", name))))
        return k

    def on_report(self) -> Optional[dict]:
        """Close the current step (called by ``TrainContext.report``);
        returns the snapshot that piggybacks to the driver."""
        if not enabled():
            return None
        now = time.monotonic()
        noww = time.time()
        with self._lock:
            wall = max(now - self._step_t0, 1e-9)
            phases = self._phases
            spans = self._phase_spans
            self._phases = {}
            self._phase_spans = []
            first = self._steps == 0
            self._steps += 1
            compute = phases.get("step_compute")
            m = _metrics()
            if first and self._compile_s is None:
                # first-call compile: the first step's compute (the whole
                # step when no phases were recorded) is dominated by jit
                # trace+compile — split it out of every step-time series
                self._compile_s = compute if compute is not None else wall
                if m is not None:
                    m["compile"].observe_key(self._k_rank, self._compile_s)
            else:
                self._step_walls.append(wall)
                self._wall_sum += wall
                if len(self._step_walls) > self.WINDOW:
                    self._wall_sum -= self._step_walls.popleft()
                self._productive_s += compute if compute is not None else wall
                if m is not None:
                    m["step"].observe_key(self._k_rank, wall)
            for name, dur in phases.items():
                if first and name == "step_compute":
                    continue  # recorded as compile above
                self._stage_totals[name] = \
                    self._stage_totals.get(name, 0.0) + dur
                if m is not None:
                    m["stage"].observe_key(self._stage_key(name), dur)
            if m is not None:
                m["steps"].inc_key(self._k_rank)
            if self._tokens_per_step and not first:
                self._tokens_total += self._tokens_per_step
                if m is not None:
                    m["tokens"].inc_key(self._k_rank, self._tokens_per_step)
            if self._collective_rates and not first and m is not None:
                for key, nbytes in self._collective_rates:
                    m["collective_bytes"].inc_key(key, nbytes)
            # running MFU: average token rate over the recent window
            # (running sum — O(1) per step, not O(window))
            if (self._flops_per_token and self._peak_flops
                    and self._tokens_per_step and self._step_walls):
                tok_s = self._tokens_per_step * len(self._step_walls) \
                    / max(self._wall_sum, 1e-9)
                self._mfu = tok_s * self._flops_per_token / self._peak_flops
            self._goodput = self._productive_s \
                / max(now - self._train_t0, 1e-9)
            self._last_step = {
                "step": self._steps - 1, "wall_s": wall,
                "compile": bool(first),
                "phases": dict(phases)}
            # full snapshot (percentile sort, device memory_stats, the
            # mfu/goodput/memory GAUGE sets, dict build) at most every
            # SNAPSHOT_PERIOD_S; in between report() piggybacks None —
            # the reply frame carries no snapshot bytes and the driver
            # keeps each rank's last rollup.  Gauges are scraped on a
            # multi-second cadence, so setting them per step buys nothing.
            snap = None
            if (self._snap_cache is None
                    or now - self._snap_ts >= self.SNAPSHOT_PERIOD_S):
                if m is not None:
                    if self._mfu is not None:
                        m["mfu"].set_key(self._k_rank, self._mfu)
                    m["goodput"].set_key(self._k_rank, self._goodput)
                self._sample_memory_locked(m)
                snap = self._snap_cache = self._snapshot_locked()
                self._snap_ts = now
        self._maybe_record_step_spans(now, noww - wall, wall, spans, first)
        return snap

    def _sample_memory_locked(self, m) -> None:
        mem = _device_memory_stats()
        if mem is None:
            return
        self._memory = mem
        if m is not None:
            if "bytes_in_use" in mem:
                m["mem_used"].set_key(self._k_rank, mem["bytes_in_use"])
            if "peak_bytes_in_use" in mem:
                m["mem_peak"].set_key(self._k_rank,
                                      mem["peak_bytes_in_use"])
            if "bytes_limit" in mem:
                m["mem_limit"].set_key(self._k_rank, mem["bytes_limit"])

    def on_resume(self) -> None:
        """The driver released the barrier — the next step starts now
        (the barrier wait counts against goodput, not against any step)."""
        with self._lock:
            self._step_t0 = time.monotonic()

    def _maybe_record_step_spans(self, now: float, t0: float, wall: float,
                                 spans: List[Tuple[str, float, float]],
                                 first: bool) -> None:
        """One ``train_step`` span per step, chained to the ambient trace
        context (the ``start_training`` task's span — see
        ``TrainWorker.start_training``), with the recorded phases nested
        under it so ``raytpu timeline --breakdown`` shows where each
        step's wall clock went.

        Rate-capped per second (``train_step_spans_per_s``, PR-2's
        STAGES-event discipline): the step/stage HISTOGRAMS observe every
        step regardless — only the per-step timeline payload samples
        under a small-step flood, bounding the event-pipeline cost.  The
        compile step always records (there is exactly one)."""
        if not first:
            cap = getattr(_get_config(), "train_step_spans_per_s", 100)
            if cap and cap > 0:
                if now - self._span_window_ts >= 1.0:
                    self._span_window_ts = now
                    self._span_window_n = 0
                if self._span_window_n >= cap:
                    return
                self._span_window_n += 1
        try:
            from ray_tpu_torch.util import tracing
            name = "train_compile" if first else "train_step"
            step_span = tracing.record_span(
                name, t0, wall, rank=str(self.rank),
                step=str(self._steps - 1))
            for pname, pt0, pdur in spans:
                tracing.record_span(pname, pt0, pdur, parent_id=step_span,
                                    rank=str(self.rank))
        except Exception:
            pass

    # ---------------------------------------------------------- snapshot

    def _snapshot_locked(self) -> dict:
        return {
            "rank": self.rank,
            "steps": self._steps,
            # raw goodput numerator/denominator: the executor sums
            # productive seconds ACROSS elastic resizes (each generation's
            # tracker restarts its clocks), which a pre-divided fraction
            # can't support
            "productive_s": self._productive_s,
            "wall_s": max(time.monotonic() - self._train_t0, 0.0),
            "compile_s": self._compile_s,
            "step_time_s": latency_summary(list(self._step_walls)),
            "stage_totals_s": dict(self._stage_totals),
            "mfu": self._mfu,
            "goodput": self._goodput,
            "tokens_total": self._tokens_total,
            "memory": self._memory,
            "collective_bytes_per_step": self._collective_per_step,
            "opt_state_bytes": self._opt_state_bytes,
            "last_step": self._last_step,
        }

    def snapshot(self) -> Optional[dict]:
        """Fresh (not cached) snapshot — the final-rollup path.  Also
        refreshes the mfu/goodput/memory gauges: a run shorter than
        SNAPSHOT_PERIOD_S would otherwise leave them at the compile
        step's values (mfu unset, goodput 0) in the final metrics flush."""
        if not enabled():
            return None
        with self._lock:
            m = _metrics()
            if m is not None:
                if self._mfu is not None:
                    m["mfu"].set_key(self._k_rank, self._mfu)
                if self._goodput is not None:
                    m["goodput"].set_key(self._k_rank, self._goodput)
            self._sample_memory_locked(m)
            return self._snapshot_locked()


# ----------------------------------------------------------- driver side

def aggregate(snaps: Dict[int, Optional[dict]]) -> Optional[dict]:
    """Roll per-rank snapshots into the per-run summary that lands in
    ``train.Result.train_obs`` / ``train.status()``: worst-case compile,
    mean MFU/goodput (each chip's utilization — a mean, not a sum), the
    mean of per-rank step-time medians, and the raw per-rank snapshots
    for drill-down."""
    live = {r: s for r, s in (snaps or {}).items() if s}
    if not live:
        return None

    def vals(key):
        return [s[key] for s in live.values() if s.get(key) is not None]

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    p50s = [s["step_time_s"]["p50"] for s in live.values()
            if s.get("step_time_s")]
    out = {
        "ts": time.time(),
        "n_workers": len(live),
        "steps": max(s["steps"] for s in live.values()),
        "compile_s": max(vals("compile_s"), default=None),
        "step_time_p50_s": mean(p50s),
        "mfu": mean(vals("mfu")),
        "goodput": mean(vals("goodput")),
        "productive_s": mean(vals("productive_s")),
        "tokens_total": sum(vals("tokens_total")) or 0,
        # fleet-total resident optimizer HBM: the ZeRO win reads directly
        # off this (replicated: n_ranks * full state; sharded: ~1x)
        "opt_state_bytes": sum(vals("opt_state_bytes")) or None,
        "workers": {int(r): s for r, s in live.items()},
    }
    return out


def record_resize(direction: str) -> None:
    """Bump ``raytpu_train_resizes_total{direction}`` (direction is the
    closed up/down vocabulary — never a node id or world size)."""
    if not enabled():
        return
    m = _metrics()
    if m is not None:
        m["resizes"].inc_key((("direction", str(direction)),))


#: trial name -> latest rollup, updated by BackendExecutor.fetch_next on
#: every barrier round — the live ``train.status()`` surface.
_status_lock = threading.Lock()
_status: Dict[str, dict] = {}


def publish_status(trial: str, rollup: Optional[dict]) -> None:
    if rollup is None:
        return
    with _status_lock:
        _status[trial or "train"] = rollup


def status(trial: Optional[str] = None):
    """Driver-side rollup of every training run this process has
    observed: ``{trial_name: rollup}`` (or one trial's rollup when
    ``trial`` is given; None if unknown)."""
    with _status_lock:
        if trial is not None:
            return _status.get(trial)
        return dict(_status)


def flush_task_events(timeout: float = 5.0) -> int:
    """Synchronously push this process's buffered task events (incl. the
    per-step spans above) to the GCS.  Train workers are KILLED by the
    executor moments after their loop finishes — without this the last
    flush-cadence window of step spans dies with the process and the
    step trace ends mid-run.  Called by ``TrainWorker.next_result`` on
    the done/error rounds; best-effort (an unreachable GCS re-buffers)."""
    try:
        from ray_tpu_torch.core.core_worker import global_worker_or_none
        from ray_tpu_torch.core.rpc import run_async

        w = global_worker_or_none()
        if w is None or not getattr(w, "gcs", None):
            return 0

        async def _drain():
            # swap ON the worker's IO loop — the periodic flush loop swaps
            # there too, so the two can never double-ship or drop a batch
            batch, w._task_events = w._task_events, []
            if not batch:
                return 0
            try:
                await w.gcs.call("add_task_events", events=batch)
                return len(batch)
            except Exception:
                w._task_events = batch + w._task_events
                return 0

        return run_async(_drain(), timeout=timeout)
    except Exception:
        return 0


# ------------------------------------------------------- loop monitor

def ensure_loop_monitor(holder, source: str):
    """Install the event-loop stall detector on the train worker's RPC
    loop, once per holder (the TrainWorker actor) — the user loop runs
    in a side thread, but a report/checkpoint callback that blocks the
    worker's IO loop freezes every RPC the process serves, including the
    driver's ``next_result`` poll.  Config-gated like every other
    install (``loop_monitor_enabled``); tagged
    ``process="train_worker:<rank>"``."""
    if getattr(holder, "_train_loop_monitor", None) is not None:
        return holder._train_loop_monitor
    holder._train_loop_monitor = False  # tried; don't retry per call
    try:
        from ray_tpu_torch.core.core_worker import global_worker_or_none
        from ray_tpu_torch.core.rpc import get_loop
        from ray_tpu_torch.util.loop_monitor import install

        w = global_worker_or_none()
        gcs_call = w.gcs.call if w is not None and w.gcs else None
        mon = install(get_loop(), source, gcs_call=gcs_call)
        if mon is not None:
            holder._train_loop_monitor = mon
        return mon
    except Exception:
        return None
