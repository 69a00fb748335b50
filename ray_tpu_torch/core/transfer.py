"""Chunk-ledger transfer plane: pipelined multi-source object pulls.

The cross-host byte path of a broadcast (reference: ``push_manager.h``
chunked parallel push + ``pull_manager.h`` admission control) rebuilt as a
pull-side **chunk ledger**:

* **Multi-source striping** — the chunks of ONE object are scheduled across
  every known source concurrently (per-source in-flight windows under one
  global per-pull window), instead of a whole-object pull from a single
  randomly chosen candidate.
* **Work stealing** — a source with no claimable pending chunk hedges the
  slowest in-flight chunk of another source (duplicate fetch; both land the
  same bytes at the same offset, the first completion wins the ledger).
* **Partial-object serving** — every landed chunk is published to the local
  store as a sealed *range*, so this puller becomes a source after one
  chunk-time, not one object-time; an N-node broadcast forms a pipeline.
* **Mid-pull source refresh** — the owner's location view is re-polled
  while the pull is in flight and newly registered (possibly partial)
  sources are folded into the stripe.
* **Chunk-granular failure handling** — a failed/short/corrupt chunk goes
  back to PENDING and is retried on another source against the ledger; a
  source is dropped only after repeated failures, and the pull survives any
  strict subset of its sources dying.

The engine is transport-agnostic (callbacks for fetch/probe/refresh) so the
striping, stealing and resume logic unit-test without a cluster; the node
agent supplies RPC-backed callbacks (see ``NodeAgent._pull_object``).

Sources are opaque ADDRESS strings to the engine — the agent's callbacks
route ``host:port`` addresses over RPC and **external-tier URIs**
(``gs://...``, ``file://...`` — see ``core/external_spill.py``) through
fsspec range reads, so an object spilled to the external tier by a node
that later died participates in the stripe exactly like a live peer:
claimable chunk-by-chunk, hedgeable, retried, folded in by the mid-pull
owner refresh when its registration lands mid-broadcast.
"""

from __future__ import annotations

import asyncio
import bisect
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional

from .object_store import ChunkNotAvailable, range_covers

PENDING, INFLIGHT, DONE = 0, 1, 2


class ChunkShortError(RuntimeError):
    """A ``read_chunk`` reply carried fewer (or more) bytes than requested —
    slice-assigning it silently would seal a corrupt object."""


class ChunkCrcError(RuntimeError):
    """Optional per-chunk checksum mismatch (object_transfer_checksum)."""


class TransferStalled(RuntimeError):
    """No chunk landed within the stall window and no live source remains."""


# ------------------------------------------------------------- self-metrics

def _build_transfer_metrics():
    from ray_tpu_torch.util.metrics import Counter, Histogram
    return {
        "bytes": Counter(
            "raytpu_transfer_bytes_total",
            "object-plane payload bytes moved, by kind and direction",
            tag_keys=("kind", "direction")),
        "chunk_seconds": Histogram(
            "raytpu_transfer_chunk_seconds",
            "per-chunk transfer latency (request sent -> bytes landed)",
            boundaries=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0, 30.0],
            tag_keys=("status",)),
        "pull_sources": Histogram(
            "raytpu_transfer_pull_sources",
            "distinct sources a completed chunked pull drew bytes from",
            boundaries=[1, 2, 3, 4, 6, 8, 12, 16, 24, 32]),
    }


_transfer_metrics_get = None

# precomputed sorted tag-key tuples (see Counter.inc_key): the chunk path
# runs per 8 MB of every cross-host transfer
KEY_CHUNK_IN = (("direction", "in"), ("kind", "chunk"))
KEY_CHUNK_OUT = (("direction", "out"), ("kind", "chunk"))
KEY_PROXY_IN = (("direction", "in"), ("kind", "proxy"))
KEY_OK = (("status", "ok"),)
KEY_FAIL = (("status", "failed"),)


def transfer_metrics():
    global _transfer_metrics_get
    if _transfer_metrics_get is None:
        from ray_tpu_torch.util.metrics import lazy
        _transfer_metrics_get = lazy(_build_transfer_metrics)
    return _transfer_metrics_get()


# ------------------------------------------------------------- chunk ledger

class ChunkLedger:
    """Per-pull bookkeeping: which byte ranges are PENDING / INFLIGHT / DONE,
    who is fetching what, and the counters the timeline artifact reports."""

    def __init__(self, size: int, chunk_bytes: int,
                 order: Optional[List[int]] = None):
        self.size = size
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.offsets = list(range(0, size, self.chunk_bytes)) or [0]
        n = len(self.offsets)
        #: claim scan order.  Pullers in one broadcast should each use a
        #: DIFFERENT permutation (rarest-first in spirit): with everyone
        #: claiming 0..N in lockstep, peers only ever hold the prefix the
        #: others already landed and partial serving relays nothing —
        #: permuted orders make peers' ranges complementary.
        self.order = list(order) if order is not None else list(range(n))
        self.state = [PENDING] * n
        self.assigned: List[Optional[str]] = [None] * n
        self.started = [0.0] * n
        self.fetchers = [0] * n          # concurrent attempts (steal hedges)
        self.done_n = 0
        self.retries = 0                 # chunk attempts that failed
        self.steals = 0                  # hedged duplicate fetches issued
        self.short_chunks = 0            # length-mismatch replies rejected
        self.chunk_times: List[float] = []

    def __len__(self) -> int:
        return len(self.offsets)

    def chunk_len(self, i: int) -> int:
        return min(self.chunk_bytes, self.size - self.offsets[i])

    @property
    def done(self) -> bool:
        return self.done_n == len(self.offsets)

    def sealed_ranges(self) -> List[List[int]]:
        """Merged [start, end) byte ranges of DONE chunks (what object_info
        advertises while this pull is still in flight)."""
        out: List[List[int]] = []
        for i, st in enumerate(self.state):
            if st != DONE:
                continue
            s, e = self.offsets[i], self.offsets[i] + self.chunk_len(i)
            if out and out[-1][1] == s:
                out[-1][1] = e
            else:
                out.append([s, e])
        return out

    def claim(self, source: str, covered: Callable[[int, int], bool],
              rank: Optional[Callable[[int], int]] = None) -> Optional[int]:
        """Next PENDING chunk (in this ledger's claim order) this source
        can serve; marks it INFLIGHT.

        ``rank`` (lower = claim first) implements rarest-first proper: the
        engine ranks each chunk by how many OTHER live sources could serve
        it, so a full source (the origin) works the chunks only it holds
        and leaves commonly-held ranges to the relays — raising the relay
        fraction AND taking load off the origin."""
        best = best_rank = None
        examined = 0
        for i in self.order:
            if self.state[i] != PENDING:
                continue
            if covered(self.offsets[i], self.chunk_len(i)):
                if rank is None:
                    best = i
                    break
                r = rank(i)
                if best_rank is None or r < best_rank:
                    best, best_rank = i, r
                    if r == 0:
                        break  # nobody else can serve it: claim now
                examined += 1
                if examined >= 64:
                    break  # cap the scan: huge pulls stay O(64 x sources)
        if best is None:
            return None
        self.state[best] = INFLIGHT
        self.assigned[best] = source
        self.started[best] = time.monotonic()
        self.fetchers[best] += 1
        return best

    def claim_run(self, source: str, covered: Callable[[int, int], bool],
                  rank: Optional[Callable[[int], int]] = None,
                  max_chunks: int = 1) -> Optional[List[int]]:
        """Claim a RUN: :meth:`claim`'s pick plus up to ``max_chunks - 1``
        offset-consecutive PENDING chunks the source also covers, all
        marked INFLIGHT as one fetch unit (one request on the wire).

        This is the adaptive chunk-growth substrate: the LEDGER keeps its
        fixed base-chunk bookkeeping (steal, retry, partial publishing
        stay chunk-granular), while the per-request size on the wire
        grows to the run — fewer round trips, same failure granularity:
        a failed run requeues per base chunk."""
        first = self.claim(source, covered, rank)
        if first is None or max_chunks <= 1:
            return None if first is None else [first]
        run = [first]
        t0 = self.started[first]
        # STAGGER the per-chunk start stamps across the run by the median
        # completed-chunk time: the steal clock compares per-chunk ages
        # against a per-base-chunk threshold, and a healthy 32-chunk run
        # stamped wholesale at t0 would look 32 chunk-times "slow" by its
        # tail — systematically hedged and its source shrunk for being
        # fast.  Staggered, chunk k of a run only ages once its expected
        # service time has actually passed.
        per = (self.chunk_times[len(self.chunk_times) // 2]
               if self.chunk_times else 0.25)
        i = first + 1
        n = len(self.offsets)
        while len(run) < max_chunks and i < n and self.state[i] == PENDING \
                and covered(self.offsets[i], self.chunk_len(i)):
            self.state[i] = INFLIGHT
            self.assigned[i] = source
            self.started[i] = t0 + len(run) * per
            self.fetchers[i] += 1
            run.append(i)
            i += 1
        return run

    def run_span(self, run: List[int]) -> tuple:
        """(offset, length) of one offset-consecutive claimed run."""
        off = self.offsets[run[0]]
        end = self.offsets[run[-1]] + self.chunk_len(run[-1])
        return off, end - off

    def complete_run(self, run: List[int], elapsed_s: float) -> bool:
        """Mark every chunk of a run DONE (per-chunk time = the run's
        mean).  True if ANY chunk was first-landed by this run."""
        per = elapsed_s / max(1, len(run))
        first = False
        for i in run:
            if self.complete(i, per):
                first = True
        return first

    def fail_run(self, run: List[int]):
        for i in run:
            self.fail(i)

    def steal(self, source: str, covered: Callable[[int, int], bool],
              threshold_s: float) -> Optional[int]:
        """Hedge the SLOWEST in-flight chunk another source has held longer
        than ``threshold_s`` (and that nobody hedges yet).  The duplicate
        fetch lands the same bytes at the same offset — first completion
        wins the ledger, the straggler's completion is a no-op."""
        now = time.monotonic()
        best, best_age = None, threshold_s
        for i, st in enumerate(self.state):
            if st != INFLIGHT or self.assigned[i] == source \
                    or self.fetchers[i] > 1:
                continue
            age = now - self.started[i]
            if age >= best_age and covered(self.offsets[i],
                                           self.chunk_len(i)):
                best, best_age = i, age
        if best is not None:
            self.fetchers[best] += 1
            self.steals += 1
        return best

    def steal_threshold(self, configured_s: float) -> float:
        """Fixed when configured > 0; otherwise adaptive — twice the median
        completed-chunk time, floored so a warm-up blip can't trigger a
        hedge storm.  ``chunk_times`` is kept sorted (insort on complete),
        so this is O(1) — idle slots poll it every cycle."""
        if configured_s > 0:
            return configured_s
        if not self.chunk_times:
            return 1.0
        med = self.chunk_times[len(self.chunk_times) // 2]
        return max(0.25, 2.0 * med)

    def complete(self, i: int, elapsed_s: float) -> bool:
        """Mark chunk ``i`` DONE.  False if a duplicate already landed it."""
        self.fetchers[i] = max(0, self.fetchers[i] - 1)
        if self.state[i] == DONE:
            return False
        self.state[i] = DONE
        self.done_n += 1
        bisect.insort(self.chunk_times, elapsed_s)
        return True

    def fail(self, i: int):
        """A fetch attempt died: requeue unless a duplicate already won."""
        self.fetchers[i] = max(0, self.fetchers[i] - 1)
        if self.state[i] == DONE:
            return
        self.retries += 1
        if self.fetchers[i] == 0:
            self.state[i] = PENDING
            self.assigned[i] = None

    def stats(self) -> dict:
        return {"chunks": len(self.offsets), "chunks_done": self.done_n,
                "retried": self.retries, "stolen": self.steals,
                "short": self.short_chunks}


# ---------------------------------------------------------- source tracking

@dataclass
class SourceState:
    addr: str
    #: None = assumed full object; else merged [start, end) ranges held
    ranges: Optional[List[List[int]]] = None
    inflight: int = 0
    #: CONSECUTIVE failure events (reset by any success): one aborted
    #: connection fails every windowed chunk on it at the same instant, so
    #: failures landing within ``FAIL_DEBOUNCE_S`` count as ONE event — a
    #: 5% frame-drop link survives, a dead host still dies in ~3 events
    failures: int = 0
    last_fail_t: float = 0.0
    dead: bool = False
    #: set after ChunkNotAvailable: don't re-claim against stale ranges
    #: until a re-probe refreshes them (event-driven when a prober
    #: exists — see StripedPull._probe_soon — else the refresh tick)
    wait_probe: bool = False
    #: monotonic time of the last issued probe (the event-driven probe's
    #: debounce clock) and whether one is currently in flight
    last_probe_t: float = 0.0
    probe_inflight: bool = False
    chunks: int = 0
    bytes: int = 0
    t_first: float = 0.0
    t_last: float = 0.0
    #: adaptive per-request size, in base chunks: grows geometrically
    #: under clean completions (see StripedPull._grow/_shrink), shrinks
    #: on failure/timeout and when another source steals this one's
    #: in-flight work (slowness evidence)
    run_len: int = 1
    clean: int = 0

    FAIL_DEBOUNCE_S = 0.1

    def covers(self, offset: int, length: int) -> bool:
        if self.ranges is None:
            return True
        return range_covers(self.ranges, offset, offset + length)

    def note_failure(self) -> int:
        now = time.monotonic()
        if now - self.last_fail_t > self.FAIL_DEBOUNCE_S:
            self.failures += 1
        self.last_fail_t = now
        return self.failures


# -------------------------------------------------------------- the engine

class StripedPull:
    """Drive one object pull across many sources against a ChunkLedger.

    Callbacks (all coroutines):

    * ``fetch_chunk(addr, offset, length)`` — land [offset, offset+length)
      from ``addr`` into the destination and return the byte count landed.
      Raise :class:`ChunkNotAvailable` when the source doesn't hold the
      range (partial holder), anything else for a transport/content fault.
    * ``probe_source(addr)`` — ``None`` (unusable now) or
      ``{"full": bool, "ranges": [[s, e), ...]}``.
    * ``refresh_sources()`` — current full location list from the owner
      (may include partial holders that registered mid-broadcast).
    * ``on_chunk(i, offset, length, addr, t0, t1, stolen)`` — optional sync
      hook per FIRST landing of a chunk (trace/metrics/partial publish).
    """

    def __init__(self, ledger: ChunkLedger, *,
                 fetch_chunk: Callable[[str, int, int], Awaitable[int]],
                 probe_source: Optional[Callable[
                     [str], Awaitable[Optional[dict]]]] = None,
                 refresh_sources: Optional[Callable[
                     [], Awaitable[List[str]]]] = None,
                 on_chunk: Optional[Callable] = None,
                 per_source_window: int = 4,
                 total_window: int = 16,
                 steal_after_s: float = 0.0,
                 max_source_failures: int = 3,
                 refresh_period_s: float = 0.5,
                 stall_timeout_s: float = 60.0,
                 run_max_chunks: int = 1,
                 clamp_run_chunks: Optional[Callable[[], int]] = None):
        self.ledger = ledger
        self._fetch_chunk = fetch_chunk
        self._probe_source = probe_source
        self._refresh_sources = refresh_sources
        self._on_chunk = on_chunk
        self.per_source_window = max(1, per_source_window)
        self._window = asyncio.Semaphore(max(1, total_window))
        self.steal_after_s = steal_after_s
        self.max_source_failures = max(1, max_source_failures)
        self.refresh_period_s = refresh_period_s
        self.stall_timeout_s = stall_timeout_s
        #: adaptive chunk growth: per-request runs of base chunks grow
        #: toward this many chunks under clean completions (1 = fixed
        #: chunks, the pre-adaptive behavior)
        self.run_max_chunks = max(1, run_max_chunks)
        #: receiver-side clamp, re-queried per claim: the largest run (in
        #: base chunks) the receiving arena can absorb — grown requests
        #: must never outgrow the receiver's largest free block, or a
        #: landing could force a spill mid-pull
        self._clamp_run_chunks = clamp_run_chunks
        self.sources: Dict[str, SourceState] = {}
        self._slots: List[asyncio.Task] = []
        #: ephemeral event-driven probe tasks (self-pruning; separate
        #: from _slots so fetch-slot bookkeeping stays bounded)
        self._probes: set = set()
        self._last_progress = time.monotonic()
        self._done = asyncio.Event()
        #: wakes idle slots when claimable work may exist (chunk requeued,
        #: ranges widened, new source) — idle slots park on this instead
        #: of busy-polling; the wait's timeout is the steal-age clock
        self._kick = asyncio.Event()
        self._fatal: Optional[BaseException] = None

    # -- source management -------------------------------------------------

    def add_source(self, addr: str) -> Optional[SourceState]:
        s = self.sources.get(addr)
        if s is not None:
            return s
        s = SourceState(addr)
        self.sources[addr] = s
        self._spawn_slots(s)
        return s

    def _spawn_slots(self, s: SourceState):
        for _ in range(self.per_source_window):
            self._slots.append(asyncio.ensure_future(self._slot(s)))

    def _resurrect(self, s: SourceState):
        """Last-resort second life: the stripe has NO live source but the
        owner still lists this one — a spurious death (burst of transient
        faults) must not strand the pull when the holder is reachable."""
        s.dead = False
        s.failures = 0
        # re-probe before claiming against stale state (only meaningful
        # when a prober exists — it is what clears wait_probe)
        s.wait_probe = self._probe_source is not None
        self._spawn_slots(s)

    def _live_sources(self) -> List[SourceState]:
        return [s for s in self.sources.values() if not s.dead]

    # -- slots -------------------------------------------------------------

    def _coverage_rank(self, s: SourceState):
        """rank(i) = how many OTHER live sources could serve chunk i (the
        rarest-first claim key).  None when ranking cannot change the
        outcome — no other live source, or every other source is full
        (rank would be a constant) — so the common all-full case (one big
        pull from N complete holders) keeps O(1) claims instead of
        scanning every pending chunk per claim."""
        others = [o for o in self.sources.values()
                  if o is not s and not o.dead and not o.wait_probe]
        if not others or all(o.ranges is None for o in others):
            return None
        ledger = self.ledger

        def rank(i: int) -> int:
            off, ln = ledger.offsets[i], ledger.chunk_len(i)
            return sum(1 for o in others if o.covers(off, ln))

        return rank

    def _run_budget(self, s: SourceState) -> int:
        """Chunks this source's next claim may take: its adaptive run
        length, bounded by the engine max and the receiver-side clamp."""
        n = min(s.run_len, self.run_max_chunks)
        if self._clamp_run_chunks is not None:
            try:
                n = min(n, self._clamp_run_chunks())
            except Exception:
                n = 1
        return max(1, n)

    def _grow(self, s: SourceState):
        s.clean += 1
        if s.clean >= 2 and s.run_len < self.run_max_chunks:
            s.run_len = min(self.run_max_chunks, s.run_len * 2)
            s.clean = 0

    def _shrink(self, s: SourceState):
        s.clean = 0
        s.run_len = max(1, s.run_len // 2)

    async def _slot(self, s: SourceState):
        ledger = self.ledger
        while not ledger.done and not s.dead and self._fatal is None:
            worked = False
            async with self._window:
                run = None
                stolen = False
                if not s.wait_probe:
                    run = ledger.claim_run(s.addr, s.covers,
                                           self._coverage_rank(s),
                                           self._run_budget(s))
                    if run is None:
                        i = ledger.steal(
                            s.addr, s.covers,
                            ledger.steal_threshold(self.steal_after_s))
                        if i is not None:
                            run, stolen = [i], True
                            # slowness evidence against the victim: its
                            # next requests should shrink, not grow
                            victim = self.sources.get(ledger.assigned[i])
                            if victim is not None and victim is not s:
                                self._shrink(victim)
                if run is not None:
                    worked = True
                    await self._fetch_one(s, run, stolen)
            if ledger.done:
                break
            if not worked:
                # nothing claimable right now (all pending chunks outside
                # this source's ranges, or everything in flight): park on
                # the kick event — requeues/range-widening/new-source wake
                # us; the timeout is only the steal-age clock (hedging
                # needs time to pass, not an event)
                self._kick.clear()
                try:
                    await asyncio.wait_for(self._kick.wait(), 0.2)
                except asyncio.TimeoutError:
                    pass
        if ledger.done:
            self._done.set()

    async def _fetch_one(self, s: SourceState, run: List[int],
                         stolen: bool):
        ledger = self.ledger
        off, n = ledger.run_span(run)
        t0 = time.time()
        tm0 = time.monotonic()
        s.inflight += 1
        m = transfer_metrics()
        try:
            landed = await self._fetch_chunk(s.addr, off, n)
            if landed != n:
                ledger.short_chunks += 1
                raise ChunkShortError(
                    f"source {s.addr} returned {landed} B for a {n} B chunk "
                    f"at offset {off}")
        except ChunkNotAvailable:
            # partial holder that doesn't (yet) cover this range: requeue
            # the chunks and — when a prober exists to clear the flag —
            # stop claiming against its stale range map until a re-probe
            # widens it.  The re-probe is EVENT-DRIVEN (debounced), not
            # left to the refresh tick: in a fast broadcast a relay's
            # ranges widen every few chunk-times, and a tick-period pause
            # would idle the relay for most of the transfer (without a
            # prober the pause would be permanent, so just back off
            # briefly instead).
            if self._probe_source is not None:
                s.wait_probe = True
                self._probe_soon(s)
            ledger.fail_run(run)
            self._kick.set()  # the requeued chunks are claimable elsewhere
            await asyncio.sleep(0.01)
        except asyncio.CancelledError:
            ledger.fail_run(run)
            raise
        except BaseException:
            ledger.fail_run(run)
            self._shrink(s)  # timeout/transport fault: smaller requests
            if m is not None:
                m["chunk_seconds"].observe_key(KEY_FAIL,
                                               time.monotonic() - tm0)
            if s.note_failure() >= self.max_source_failures:
                s.dead = True
            self._kick.set()  # the requeued chunks are claimable elsewhere
            # brief backoff so a fast-failing source can't hot-spin the
            # claim/fail cycle on the event loop
            await asyncio.sleep(0.01)
        else:
            elapsed = time.monotonic() - tm0
            s.failures = 0  # consecutive-failure semantics
            first = ledger.complete_run(run, elapsed)
            self._grow(s)
            if first:
                self._last_progress = time.monotonic()
                s.chunks += len(run)
                s.bytes += n
                if not s.t_first:
                    s.t_first = t0
                s.t_last = time.time()
                if m is not None:
                    m["bytes"].inc_key(KEY_CHUNK_IN, n)
                    m["chunk_seconds"].observe_key(KEY_OK, elapsed)
                if self._on_chunk is not None:
                    try:
                        self._on_chunk(run[0], off, n, s.addr, t0,
                                       time.time(), stolen)
                    except Exception:
                        pass
            if ledger.done:
                self._done.set()
        finally:
            s.inflight -= 1

    #: event-driven probe debounce: a paused source is re-probed at most
    #: this often (a relay lands ~one chunk per chunk-time; probing much
    #: faster than that only burns RPCs)
    PROBE_DEBOUNCE_S = 0.05

    def _probe_soon(self, s: SourceState):
        """Schedule one debounced probe of a paused (wait_probe) source so
        its range map widens at chunk-time granularity instead of
        refresh-tick granularity."""
        if self._probe_source is None or s.probe_inflight or s.dead:
            return
        s.probe_inflight = True

        async def _go():
            try:
                delay = (s.last_probe_t + self.PROBE_DEBOUNCE_S
                         - time.monotonic())
                if delay > 0:
                    await asyncio.sleep(delay)
                s.last_probe_t = time.monotonic()
                try:
                    info = await self._probe_source(s.addr)
                except Exception:
                    info = None
                if info is not None:
                    s.ranges = (None if info.get("full")
                                else [list(r) for r in
                                      info.get("ranges", [])])
                    s.wait_probe = False
                    self._kick.set()  # widened ranges: wake idle slots
            finally:
                s.probe_inflight = False

        t = asyncio.ensure_future(_go())
        self._probes.add(t)
        t.add_done_callback(self._probes.discard)

    # -- refresh / stall watchdog ------------------------------------------

    async def _refresh_loop(self):
        empty_rounds = 0
        while not self.ledger.done and self._fatal is None:
            await asyncio.sleep(self.refresh_period_s)
            if self.ledger.done:
                break
            # fold newly registered sources into the stripe
            if self._refresh_sources is not None:
                try:
                    addrs = await self._refresh_sources()
                except Exception:
                    addrs = []
                for addr in addrs:
                    s = self.sources.get(addr)
                    if s is None:
                        s = self.add_source(addr)
                        # a mid-pull source is usually a PARTIAL holder:
                        # probe it this tick (below) before it claims
                        # against an assumed-full range map
                        if self._probe_source is not None:
                            s.wait_probe = True
                    elif s.dead and not self._live_sources():
                        self._resurrect(s)
            # re-probe partial / paused sources so their range maps grow —
            # CONCURRENTLY: one hung peer must not stall every other
            # source's refresh (or the watchdog) for its probe timeout
            if self._probe_source is not None:
                targets = [s for s in self.sources.values()
                           if not s.dead
                           and not (s.ranges is None and not s.wait_probe)]

                async def _probe_one(s):
                    try:
                        return s, await self._probe_source(s.addr)
                    except Exception:
                        return s, None

                for s, info in await asyncio.gather(
                        *(_probe_one(s) for s in targets)):
                    if info is None:
                        s.wait_probe = True
                        continue
                    s.ranges = (None if info.get("full")
                                else [list(r) for r in
                                      info.get("ranges", [])])
                    s.wait_probe = False
            # sources added/resurrected or ranges widened: wake idle slots
            self._kick.set()
            live = self._live_sources()
            stalled_s = time.monotonic() - self._last_progress
            if not live:
                empty_rounds += 1
            else:
                empty_rounds = 0
            if (not live and empty_rounds >= 3
                    and (self._refresh_sources is None or stalled_s > 5.0)) \
                    or stalled_s > self.stall_timeout_s:
                self._fatal = TransferStalled(
                    f"pull stalled: {self.ledger.done_n}/{len(self.ledger)} "
                    f"chunks after {stalled_s:.1f}s, "
                    f"{len(live)} live sources")
                self._done.set()
                return

    # -- run ---------------------------------------------------------------

    async def run(self, initial_sources: List[str]) -> dict:
        """Pull until the ledger is complete.  Returns per-source stats.
        Raises the first fatal error (stall / cancellation) after all slot
        tasks have been torn down — the caller may then free the
        destination segment safely (no fetch can land into it afterwards)."""
        for addr in initial_sources:
            self.add_source(addr)
        if not self.sources and self._refresh_sources is None:
            raise TransferStalled("no sources to pull from")
        refresher = asyncio.ensure_future(self._refresh_loop())
        try:
            await self._done.wait()
        finally:
            refresher.cancel()
            probes = list(self._probes)  # snapshot: done-callbacks mutate
            for t in probes + self._slots:
                t.cancel()
            await asyncio.gather(refresher, *probes, *self._slots,
                                 return_exceptions=True)
        if self._fatal is not None and not self.ledger.done:
            raise self._fatal
        used = [s for s in self.sources.values() if s.chunks > 0]
        m = transfer_metrics()
        if m is not None:
            m["pull_sources"].observe(len(used))
        total_b = sum(s.bytes for s in used) or 0
        relay_b = sum(s.bytes for s in used if s.ranges is not None)
        return {
            "sources_used": sorted(s.addr for s in used),
            "per_source": {
                s.addr: {"chunks": s.chunks, "bytes": s.bytes,
                         "failures": s.failures, "dead": s.dead,
                         # partial holder = a relay of the broadcast (it
                         # advertised ranges, not a full copy)
                         "partial": s.ranges is not None}
                for s in self.sources.values()},
            # fraction of chunk bytes served by partial (relay) holders —
            # the pipeline-efficiency number the broadcast bench reports
            # offline, now on every pull record
            "relay_fraction": round(relay_b / total_b, 4) if total_b else 0.0,
            **self.ledger.stats(),
        }


# ------------------------------------------------------------ chunk checksum

def chunk_checksum(buf) -> tuple:
    """(crc, algo) over a chunk — native CRC-32C when the extension builds
    (``test_native_crc`` covers the primitive), zlib.crc32 otherwise.  Both
    ends compare algos before comparing sums, so a mixed deployment (one
    side without g++) degrades to skip, never to a false mismatch."""
    try:
        from ray_tpu_torch.native import load_crc32c
        fn = load_crc32c()
    except Exception:
        fn = None
    if fn is not None:
        try:
            return fn(buf), "crc32c"
        except Exception:
            pass
    import zlib
    return zlib.crc32(buf) & 0xFFFFFFFF, "zlib"
