"""Open-loop load-storm harness: arrival schedules, heavy-tailed request
shapes, and per-request capture for serve benchmarks and the autoscaler
acceptance tests.

Open-loop is the load-bearing property: arrivals fire on a PRECOMPUTED
schedule regardless of how fast the system answers, so queueing delay is
*measured* instead of hidden (a closed-loop client slows its own arrival
rate exactly when the server degrades — the coordinated-omission trap).
Every sample's TTFT/latency is measured from the request's SCHEDULED
arrival time: client-side dispatch lag and server queueing both count.

Three schedule shapes (all seeded -> deterministic):

* :func:`poisson_arrivals` — steady open-loop traffic at a target rate
  (exponential inter-arrivals).
* :func:`ramp_arrivals` — linear rate ramp (inhomogeneous Poisson via
  thinning against the peak rate).
* :func:`burst_arrivals` — the storm: base rate with a ``spike_mult``x
  window in the middle (the 10x arrival spike of the acceptance test).

:class:`StormRunner` walks a schedule on a dispatch thread and fires each
request on a worker pool; :class:`SignalSampler` concurrently samples
``serve.slo_signal()`` into the {arrival rate, TTFT-p95, replica count}
time series the storm benchmarks commit.  Rollups reuse
``bench_llm.request_rollup`` (same schema as the headline LLM numbers) —
the callers own that import; this module only produces samples.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence


# ------------------------------------------------------ arrival schedules

def poisson_arrivals(rate_per_s: float, duration_s: float,
                     rng: random.Random) -> List[float]:
    """Exponential inter-arrival times at ``rate_per_s`` for
    ``duration_s`` seconds; returns sorted arrival offsets."""
    out, t = [], 0.0
    if rate_per_s <= 0:
        return out
    while True:
        t += rng.expovariate(rate_per_s)
        if t >= duration_s:
            return out
        out.append(t)


def ramp_arrivals(rate0_per_s: float, rate1_per_s: float, duration_s: float,
                  rng: random.Random) -> List[float]:
    """Linear rate ramp from ``rate0`` to ``rate1`` over ``duration_s``
    (inhomogeneous Poisson by thinning against the peak rate)."""
    peak = max(rate0_per_s, rate1_per_s, 1e-9)
    out = []
    for t in poisson_arrivals(peak, duration_s, rng):
        rate_t = rate0_per_s + (rate1_per_s - rate0_per_s) * (t / duration_s)
        if rng.random() < rate_t / peak:
            out.append(t)
    return out


def burst_arrivals(base_rate_per_s: float, spike_mult: float,
                   spike_start_s: float, spike_end_s: float,
                   duration_s: float, rng: random.Random) -> List[float]:
    """The storm shape: ``base_rate`` everywhere, ``base_rate *
    spike_mult`` inside [spike_start, spike_end) — piecewise-homogeneous
    Poisson, one sorted offset list."""
    out = list(poisson_arrivals(base_rate_per_s, duration_s, rng))
    extra_rate = base_rate_per_s * max(spike_mult - 1.0, 0.0)
    spike_len = max(spike_end_s - spike_start_s, 0.0)
    out.extend(spike_start_s + t for t in
               poisson_arrivals(extra_rate, spike_len, rng))
    out.sort()
    return out


def heavy_tail_len(rng: random.Random, median: int, sigma: float = 0.8,
                   lo: int = 1, hi: int = 1 << 16) -> int:
    """Heavy-tailed (lognormal) length sample clamped to [lo, hi] —
    prompt/decode lengths in production LLM traffic are long-tailed, and
    the tail is what fills batches unevenly and stresses paged KV."""
    n = int(round(median * math.exp(rng.gauss(0.0, sigma))))
    return max(lo, min(hi, n))


def llm_payload(seed: int, idx: int, *, prompt_median: int, prompt_lo: int,
                prompt_hi: int, decode_median: int, decode_lo: int = 4,
                decode_hi: int = 64, vocab: int = 1000,
                prefix_pool: int = 0, prefix_len: int = 0) -> dict:
    """One LLM storm request — heavy-tailed prompt + decode lengths as a
    PURE function of (seed, idx), so per-request shapes are reproducible
    no matter how the firing pool's threads interleave (int-derived
    seed: tuple seeding is a TypeError from Python 3.11).

    ``prefix_pool``/``prefix_len`` model multi-turn / system-prompt
    traffic: each request draws one of ``prefix_pool`` shared prefixes
    (``prefix_len`` tokens, a pure function of seed + pool index) and
    appends its unique heavy-tailed tail.  Requests sharing a prefix hit
    the paged prefix cache — and give cache-aware routing something to
    route ON (the storm A/B's hit-rate lift comes from exactly this)."""
    rng = random.Random(seed * 1_000_003 + idx)
    head: list = []
    if prefix_pool > 0 and prefix_len > 0:
        prng = random.Random(seed * 7_368_787 + rng.randrange(prefix_pool))
        head = [prng.randint(1, vocab) for _ in range(prefix_len)]
    return {
        "tokens": head + [rng.randint(1, vocab) for _ in range(
            heavy_tail_len(rng, prompt_median, lo=prompt_lo,
                           hi=prompt_hi))],
        "max_tokens": heavy_tail_len(rng, decode_median, lo=decode_lo,
                                     hi=decode_hi),
    }


# ------------------------------------------------------- request capture

@dataclasses.dataclass
class RequestSample:
    """One completed (or failed) request, all times relative to the run's
    epoch.  ``ttft_s``/``latency_s`` are measured from ``t_sched`` — the
    scheduled arrival — so dispatch lag and queueing both count."""
    t_sched: float
    t_fired: float
    ttft_s: Optional[float]
    latency_s: float
    ntokens: int
    ok: bool
    error: str = ""

    def rollup_tuple(self):
        """(ttft_s, latency_s, ntokens) — the bench_llm.request_rollup
        input shape."""
        return (self.ttft_s if self.ttft_s is not None else self.latency_s,
                self.latency_s, self.ntokens)


class StormRunner:
    """Open-loop driver: a dispatch thread walks the arrival schedule and
    fires each request on a worker pool, never blocking an arrival on a
    completion.  ``fire(epoch, t_sched, idx) -> RequestSample`` owns the
    request (submit, stream, measure); ``idx`` is the arrival's schedule
    index, so payload generation can be a pure function of (seed, idx)
    even with hundreds of pool threads racing (a shared RNG would make
    per-request shapes run-order-dependent).  The pool is sized for the
    worst concurrent-outstanding burst — an exhausted pool queues the
    fire and the sample's from-schedule timing charges that delay
    honestly."""

    def __init__(self, fire: Callable[[float, float, int], RequestSample],
                 max_outstanding: int = 512):
        self._fire = fire
        self._pool = ThreadPoolExecutor(max_workers=max_outstanding,
                                        thread_name_prefix="loadgen")
        self.samples: List[RequestSample] = []
        self._lock = threading.Lock()
        self.fired = 0
        self.epoch: Optional[float] = None

    def _one(self, epoch: float, t_sched: float, idx: int):
        try:
            s = self._fire(epoch, t_sched, idx)
        except Exception as e:  # noqa: BLE001 — a failed request is a sample
            s = RequestSample(t_sched, time.monotonic() - epoch, None,
                              time.monotonic() - epoch - t_sched, 0,
                              ok=False, error=repr(e))
        with self._lock:
            self.samples.append(s)

    def run(self, arrivals: Sequence[float],
            epoch: Optional[float] = None) -> List[RequestSample]:
        """Fire the whole schedule, wait for every request to finish,
        return the samples sorted by scheduled arrival."""
        epoch = time.monotonic() if epoch is None else epoch
        self.epoch = epoch
        futs = []
        for i, t in enumerate(arrivals):
            delay = epoch + t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            futs.append(self._pool.submit(self._one, epoch, t, i))
            self.fired += 1
        for f in futs:
            f.result()
        with self._lock:
            return sorted(self.samples, key=lambda s: s.t_sched)

    def shutdown(self):
        self._pool.shutdown(wait=False)


def unary_fire(handle, make_payload: Callable[[int], object],
               timeout_s: float = 120.0) -> Callable[[float, float, int],
                                                     RequestSample]:
    """Fire one unary handle request per arrival; TTFT == full latency
    (the first response byte IS the response).  ``make_payload(idx)``
    must be a pure function of the arrival index (determinism under
    concurrent fires)."""

    def fire(epoch: float, t_sched: float, idx: int) -> RequestSample:
        t_fired = time.monotonic() - epoch
        try:
            handle.remote(make_payload(idx)).result(timeout_s=timeout_s)
            dt = time.monotonic() - epoch - t_sched
            return RequestSample(t_sched, t_fired, dt, dt, 1, ok=True)
        except Exception as e:  # noqa: BLE001
            return RequestSample(t_sched, t_fired, None,
                                 time.monotonic() - epoch - t_sched, 0,
                                 ok=False, error=repr(e))

    return fire


def stream_fire(handle, make_payload: Callable[[int], dict],
                timeout_s: float = 600.0) -> \
        Callable[[float, float, int], RequestSample]:
    """Fire one streaming request per arrival (the LLM path): TTFT at the
    first chunk, one token per chunk.  ``timeout_s`` bounds the whole
    stream (a replica that stops yielding without erroring must fail the
    sample, not hang the storm run past its checkpoints)."""

    def fire(epoch: float, t_sched: float, idx: int) -> RequestSample:
        t_fired = time.monotonic() - epoch
        first, n = None, 0
        try:
            for _chunk in handle.stream(make_payload(idx),
                                        timeout_s=timeout_s):
                if first is None:
                    first = time.monotonic() - epoch - t_sched
                n += 1
            return RequestSample(t_sched, t_fired, first,
                                 time.monotonic() - epoch - t_sched, n,
                                 ok=True)
        except Exception as e:  # noqa: BLE001
            return RequestSample(t_sched, t_fired, first,
                                 time.monotonic() - epoch - t_sched, n,
                                 ok=False, error=repr(e))

    return fire


# ------------------------------------------------------ signal timeline

class SignalSampler(threading.Thread):
    """Samples ``serve.slo_signal()`` every ``period_s`` into the storm
    time series: per tick {t, queue_depth, ttft_p95_ms, running/target
    replicas, stale_replicas, fired-so-far}.  A sampling FAILURE is
    recorded as a gap tick ({"gap": ...}) — the chaos acceptance test
    asserts there are none while a node dies mid-storm."""

    def __init__(self, deployment: str, period_s: float = 0.25,
                 runner: Optional[StormRunner] = None):
        super().__init__(daemon=True, name="loadgen-signal-sampler")
        self.deployment = deployment
        self.period_s = period_s
        self.runner = runner
        self.series: List[dict] = []
        self._stop_ev = threading.Event()
        self._t0: Optional[float] = None

    def run(self):
        from ray_tpu_torch import serve
        self._t0 = time.monotonic()
        while not self._stop_ev.is_set():
            t = round(time.monotonic() - self._t0, 3)
            tick = {"t": t}
            if self.runner is not None:
                tick["fired"] = self.runner.fired
            try:
                row = serve.slo_signal().get(self.deployment)
                if row is None:
                    tick["gap"] = "deployment missing from slo_signal"
                else:
                    tick.update(
                        queue_depth=row.get("queue_depth", 0),
                        ttft_p95_ms=row.get("ttft_p95_ms"),
                        running=row.get("running_replicas"),
                        target=row.get("target_replicas"),
                        stale_replicas=row.get("stale_replicas", 0))
            except Exception as e:  # noqa: BLE001 — a gap IS the finding
                tick["gap"] = repr(e)
            self.series.append(tick)
            self._stop_ev.wait(self.period_s)

    def stop(self) -> List[dict]:
        self._stop_ev.set()
        self.join(timeout=10)
        return self.series

    def gaps(self) -> List[dict]:
        return [s for s in self.series if "gap" in s]


def arrival_rate_series(arrivals: Sequence[float], bucket_s: float = 1.0) \
        -> List[dict]:
    """Arrivals/s per time bucket — the committed storm shape."""
    if not len(arrivals):
        return []
    buckets: dict = {}
    for t in arrivals:
        buckets[int(t // bucket_s)] = buckets.get(int(t // bucket_s), 0) + 1
    return [{"t": b * bucket_s, "arrivals_per_s": n / bucket_s}
            for b, n in sorted(buckets.items())]


def windowed_p95_series(samples: Sequence[RequestSample],
                        window_s: float = 2.0) -> List[dict]:
    """TTFT-p95 over sliding completion windows — how the latency tail
    moved THROUGH the storm (the phase rollup hides the recovery)."""
    done = sorted((s for s in samples if s.ok and s.ttft_s is not None),
                  key=lambda s: s.t_sched + s.latency_s)
    if not done:
        return []
    out = []
    end = done[0].t_sched + done[0].latency_s + window_s
    horizon = done[-1].t_sched + done[-1].latency_s
    while end <= horizon + window_s:
        w = [s.ttft_s for s in done
             if end - window_s <= s.t_sched + s.latency_s < end]
        if w:
            w.sort()
            out.append({"t": round(end, 3),
                        "ttft_p95_ms": round(
                            w[min(len(w) - 1, int(len(w) * 0.95))] * 1000, 2),
                        "n": len(w)})
        end += window_s
    return out
