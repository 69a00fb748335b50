"""CoreWorker — the per-process runtime embedded in the driver and every worker.

Equivalent of the reference's ``CoreWorker`` (``src/ray/core_worker/core_worker.h:285``),
the single façade behind the public API:

* **Ownership** — every object created here is owned by this process; the owner is the
  source of truth for the value (small objects), its locations (large objects), and its
  lifetime via distributed refcounting (reference: ``reference_count.h:61``,
  ``ownership_based_object_directory.h``).
* **Task submission** — lease-based direct task transport: pick a node from the gossiped
  cluster view, request a worker lease (with spillback), push tasks straight to the
  leased worker over RPC, reuse leases per scheduling key (reference:
  ``direct_task_transport.h:75``, ``SchedulingKey`` lease reuse :151).
* **Task management** — pending-task table with automatic retries and lineage kept for
  reconstruction of lost objects (reference: ``task_manager.h``,
  ``object_recovery_manager.h:41``).
* **Actor calls** — direct peer-to-peer RPC to the actor's worker with per-handle
  sequence numbers; restart-aware resubmission (reference:
  ``direct_actor_task_submitter.h:68``).
* **Execution** — in worker processes, tasks run on the *main* thread (important for
  torch/CUDA: the runtime owns the device in one thread); async actors run on a private
  event loop; threaded actors use a bounded pool (reference: scheduling queues +
  ``BoundedExecutor``/fiber concurrency groups, ``thread_pool.h:36``).
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import os
import pickle
import queue as _queue
import random
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import object_explain, sched_explain, serialization, spec_cache
from .object_explain import ObjectEvent
from .sched_explain import PendingReason
from .common import (STREAMING_RETURNS, ActorDiedError, GetTimeoutError,
                     NodeAffinitySchedulingStrategy, ObjectLostError,
                     OutOfMemoryError, PlacementGroupSchedulingStrategy,
                     RayTpuError, TaskError, TaskSpec, WorkerCrashedError,
                     _TopLevelRef, recycle_spec, session_root)
from . import common as _common
from .config import get_config
from .generator import ObjectRefGenerator, StreamState
from .ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from .object_ref import ObjectRef
from .object_store import ErrorRecord, MemoryStore, PlasmaRecord, ShmReader, ShmSegment
from .rpc import (ClientPool, ConnectionLost, RemoteError, RpcClient,
                  RpcError, RpcServer, get_loop, run_async)
from .runtime_context import _task_context
from .scheduling import NodeView, pick_node
from ray_tpu_torch.util import tracing as _tracing

_global_worker: Optional["CoreWorker"] = None
_global_lock = threading.Lock()

# Canonical serialized-empty-args blob, bound on first executor use (the
# per-task compare in _resolve_args must not re-derive it per call).
_EMPTY_ARGS_BLOB: Optional[bytes] = None

# Lazy singleton: the task-lifecycle stage histogram (submit->dispatch
# queueing on the owner side; dep-fetch / arg-deserialize / execute /
# result-put on the executor side).  Shared by every CoreWorker in the
# process; the registry flush ships it to the node agent's /metrics.
_stage_keys: Dict[str, tuple] = {}


def _build_stage_hist():
    from ray_tpu_torch.util.metrics import Histogram
    return Histogram("raytpu_task_stage_seconds",
                     "task lifecycle stage wall-clock seconds by stage",
                     tag_keys=("stage",))


_stage_hist_get: Any = None


def _task_stage_seconds():
    global _stage_hist_get
    if _stage_hist_get is None:
        # deferred to first call: importing util.metrics at module import
        # time re-enters the ray_tpu_torch package init (circular import)
        from ray_tpu_torch.util.metrics import lazy
        _stage_hist_get = lazy(_build_stage_hist)
    return _stage_hist_get()


def _observe_stage(stage: str, dur: float):
    """Observe one stage duration with a precomputed tags key — this is on
    the per-task hot path (several observations per task)."""
    hist = _task_stage_seconds()
    if hist is None:
        return
    key = _stage_keys.get(stage)
    if key is None:
        key = _stage_keys[stage] = (("stage", stage),)
    hist.observe_key(key, max(0.0, dur))


class _ReadPin:
    """Consumer-side half of the store's pin/release protocol: one pin taken
    by ``fetch_object(pin=True)``, released when the LAST zero-copy buffer
    view deserialized over the pinned mapping is garbage-collected (the
    lease-carrying buffer exporters in ``serialization._attach_lease`` hold
    the only other references).  Release is idempotent and GC-safe: it only
    schedules a fire-and-forget notify onto the IO loop."""

    __slots__ = ("_worker", "_oid", "_released")

    def __init__(self, worker: "CoreWorker", oid: ObjectID):
        self._worker = worker
        self._oid = oid
        self._released = False

    def release(self):
        if self._released:
            return
        self._released = True
        self._worker.release_read_pin(self._oid)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


def global_worker() -> "CoreWorker":
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_worker


def global_worker_or_none() -> Optional["CoreWorker"]:
    return _global_worker


def set_global_worker(w: Optional["CoreWorker"]):
    global _global_worker
    with _global_lock:
        _global_worker = w


def _task_retry_delay(retry_count: int) -> float:
    """Exponential backoff with a cap and jitter for task retries
    (reference: the ``task_retry_delay_ms`` family).  Retry n sleeps
    ~``base * backoff**(n-1)`` capped at ``task_retry_max_delay_s``;
    the 50-100% jitter keeps a node loss from synchronizing every owner's
    retry storm onto the survivors at the same instant."""
    cfg = get_config()
    delay = min(cfg.task_retry_max_delay_s,
                cfg.task_retry_delay_s
                * (cfg.task_retry_backoff ** max(0, retry_count - 1)))
    return delay * random.uniform(0.5, 1.0)


class _AdmissionGate:
    """Owner-side submission admission control (the scale-envelope gate).

    Bounds tasks in flight (submitted, not yet finished/failed) per
    CoreWorker at ``submit_inflight_limit``: a driver firing 1M
    ``.remote()`` calls degrades to smooth pipelining at the window
    instead of building a million specs of owner-side state and flooding
    every agent's lease queue.  The gate is WAITABLE — a full window
    parks the submitting thread until completions drain below the limit —
    and thread-aware: a submitter already running on an asyncio loop
    (the RPC IO loop processes the very completions that would free the
    window; actor loops must stay live) is never parked, only counted.
    """

    __slots__ = ("_cond", "_inflight", "_waiting", "blocked_total")

    def __init__(self):
        self._cond = threading.Condition()
        self._inflight = 0
        self._waiting = 0
        #: times a submission had to park (observability / tests)
        self.blocked_total = 0

    @property
    def inflight(self) -> int:
        return self._inflight

    def acquire(self, worker: "CoreWorker",
                spec: Optional[TaskSpec] = None) -> None:
        limit = get_config().submit_inflight_limit
        with self._cond:
            if limit <= 0 or self._inflight < limit:
                self._inflight += 1
                return
        # Window full.  Parking an event-loop thread would deadlock (the
        # loop processes the completions that drain the window) — count
        # and proceed; backpressure still lands on plain driver threads,
        # which is where million-task bursts come from.
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            with self._cond:
                self._inflight += 1
            return
        # About to park: stamp the typed reason onto the event plane so
        # "why is my .remote() slow" is answerable from raytpu explain /
        # summarize_tasks (the happy path above stamps nothing).
        if spec is not None:
            worker.pending_reason(spec, PendingReason.ADMISSION_GATE)
        # Worker-mode submitters release their lease's resources while
        # parked (same contract as blocking in ray.get) so nested tasks
        # can still run on the node.
        worker._on_block()
        try:
            with self._cond:
                self._waiting += 1
                self.blocked_total += 1
                try:
                    while (self._inflight >= limit
                           and not worker._shutdown):
                        self._cond.wait(timeout=0.2)
                finally:
                    self._waiting -= 1
                self._inflight += 1
        finally:
            worker._on_unblock()

    def release(self, n: int = 1) -> None:
        with self._cond:
            self._inflight -= n
            if self._waiting:
                self._cond.notify_all()


# ---------------------------------------------------------------------------
# Reference counting (reference: src/ray/core_worker/reference_count.h:61)
# ---------------------------------------------------------------------------

class ReferenceCounter:
    def __init__(self, worker: "CoreWorker"):
        self._w = worker
        self._lock = threading.Lock()
        self.local: Dict[ObjectID, int] = collections.defaultdict(int)
        self.submitted: Dict[ObjectID, int] = collections.defaultdict(int)
        self.borrowers: Dict[ObjectID, int] = collections.defaultdict(int)
        # Borrowed refs for which we told the owner we hold a copy; one
        # add/remove note pair per 0->N->0 cycle of our local count
        # (reference: borrower bookkeeping in reference_count.cc).
        self._borrow_noted: set = set()

    def add_local_ref(self, oid: ObjectID, owner: str = ""):
        notify = False
        with self._lock:
            self.local[oid] += 1
            if (owner and owner != self._w.address
                    and oid not in self._borrow_noted):
                self._borrow_noted.add(oid)
                notify = True
        if notify:
            self._w.send_borrower_note(oid, owner, add=True)

    def remove_local_ref(self, oid: ObjectID, owner: str):
        with self._lock:
            self.local[oid] -= 1
            dead = self.local[oid] <= 0 and self.submitted.get(oid, 0) <= 0
            noted = False
            if dead:
                self.local.pop(oid, None)
                noted = oid in self._borrow_noted
                self._borrow_noted.discard(oid)
        if dead:
            self._dead(oid, owner, noted)

    def add_submitted(self, oid: ObjectID):
        with self._lock:
            self.submitted[oid] += 1

    def add_submitted_many(self, oids) -> None:
        """Batch increment: ONE lock acquire for a whole arg list (the warm
        submit path pays this per task; per-ref locking was ~3 acquires on
        a typical spec)."""
        with self._lock:
            submitted = self.submitted
            for oid in oids:
                submitted[oid] += 1

    def remove_submitted(self, oid: ObjectID, owner: str):
        with self._lock:
            self.submitted[oid] -= 1
            dead = self.submitted[oid] <= 0 and self.local.get(oid, 0) <= 0
            noted = False
            if dead:
                self.submitted.pop(oid, None)
                noted = oid in self._borrow_noted
                self._borrow_noted.discard(oid)
        if dead:
            self._dead(oid, owner, noted)

    def remove_submitted_many(self, pairs) -> None:
        """Batch decrement of ``(oid, owner)`` pairs under one lock acquire;
        ``_dead`` notifications fire after the lock drops (same ordering as
        the scalar path — dead refs are already popped from the maps)."""
        dead_refs = []
        with self._lock:
            submitted, local = self.submitted, self.local
            for oid, owner in pairs:
                submitted[oid] -= 1
                if submitted[oid] <= 0 and local.get(oid, 0) <= 0:
                    submitted.pop(oid, None)
                    noted = oid in self._borrow_noted
                    self._borrow_noted.discard(oid)
                    dead_refs.append((oid, owner, noted))
        for oid, owner, noted in dead_refs:
            self._dead(oid, owner, noted)

    def _dead(self, oid: ObjectID, owner: str, noted: bool):
        if owner and owner != self._w.address:
            if noted:
                self._w.send_borrower_note(oid, owner, add=False)
        else:
            self._w.on_ref_count_zero(oid, owner)

    def add_borrower(self, oid: ObjectID):
        with self._lock:
            self.borrowers[oid] += 1

    def remove_borrower(self, oid: ObjectID):
        with self._lock:
            self.borrowers[oid] -= 1
            dead = self.borrowers[oid] <= 0
            if dead:
                self.borrowers.pop(oid, None)
        if dead:
            self._w.on_ref_count_zero(oid, "")

    def has_any_ref(self, oid: ObjectID) -> bool:
        with self._lock:
            return (self.local.get(oid, 0) > 0 or self.submitted.get(oid, 0) > 0
                    or self.borrowers.get(oid, 0) > 0)

    def summary(self) -> Dict[str, dict]:
        """Per-object refcount snapshot (the ``raytpu memory`` data source):
        {object_id_hex: {local, submitted, borrowers}}."""
        with self._lock:
            oids = set(self.local) | set(self.submitted) | set(self.borrowers)
            return {oid.hex(): {"local": self.local.get(oid, 0),
                                "submitted": self.submitted.get(oid, 0),
                                "borrowers": self.borrowers.get(oid, 0)}
                    for oid in oids}


# ---------------------------------------------------------------------------
# Task manager (reference: src/ray/core_worker/task_manager.h)
# ---------------------------------------------------------------------------

@dataclass
class PendingTask:
    spec: TaskSpec
    retries_left: int
    arg_refs: List[ObjectRef] = field(default_factory=list)
    #: holds one admission-gate slot (public submit entry points); internal
    #: resubmissions (reconstruction) bypass the gate and must not release
    gated: bool = False


def _result_contained_refs(res: tuple) -> list:
    """Contained-ref descriptors [(id_bytes, owner_addr), ...] of a result
    tuple, if the producing worker attached them.

    Result tuple shapes: ("inline", bytes[, contained]),
    ("plasma", size, locations[, contained]), ("error", blob).
    """
    if res[0] == "inline" and len(res) >= 3:
        return res[2]
    if res[0] == "plasma" and len(res) >= 4:
        return res[3]
    return []


class TaskManager:
    def __init__(self, worker: "CoreWorker"):
        self._w = worker
        self.pending: Dict[TaskID, PendingTask] = {}
        self.lineage: "collections.OrderedDict[TaskID, TaskSpec]" = collections.OrderedDict()
        self.num_finished = 0
        self.num_failed = 0
        #: memory-monitor kills per task (reference task_oom_retries budget)
        self.oom_kill_counts: Dict[TaskID, int] = {}

    def note_oom_kill(self, task_id: TaskID) -> int:
        n = self.oom_kill_counts.get(task_id, 0) + 1
        self.oom_kill_counts[task_id] = n
        return n

    def add_pending(self, spec: TaskSpec, arg_refs: List[ObjectRef],
                    gated: bool = False):
        self.pending[spec.task_id] = PendingTask(spec, spec.max_retries,
                                                 arg_refs, gated=gated)
        if arg_refs:
            self._w.reference_counter.add_submitted_many(
                [r.id for r in arg_refs])

    def _release_args(self, pt: PendingTask):
        if pt.arg_refs:
            self._w.reference_counter.remove_submitted_many(
                [(r.id, r.owner) for r in pt.arg_refs])
        pt.arg_refs = ()

    def register_result_borrows(self, oid: ObjectID, res: tuple):
        """Register borrows for ObjectRefs serialized inside a result NOW
        (at receipt), not when the user eventually deserializes them in
        ray.get: the producer's counts may hit zero right after it
        replies, and the escrow grace must only have to cover RPC
        latency — not user think-time (reference: reference_count.cc
        borrower bookkeeping; the round-1 grace-only scheme lost objects
        gotten later than ref_escrow_grace_s after production)."""
        for desc in _result_contained_refs(res):
            idbin, owner = desc[0], desc[1]
            hold_id = desc[2] if len(desc) > 2 else None
            if owner and owner != self._w.address:
                self._w.register_contained_borrow(oid, ObjectID(idbin),
                                                  owner, hold_id)
            else:
                # Our own object round-tripped through the result: pin
                # it for the RESULT's lifetime (the caller may have
                # dropped its original handle already), then drop the
                # producer's hold.
                self._w.register_contained_borrow(oid, ObjectID(idbin),
                                                  "", None)
                if hold_id:
                    self._w.release_local_hold(ObjectID(idbin), hold_id)

    def complete(self, task_id: TaskID, results: List[tuple]):
        if self._complete_one(task_id, results):
            self._w.admission_gate.release()

    def complete_many(self, pairs) -> None:
        """Batch completion: the whole result batch settles with ONE
        admission-gate release (one lock acquire + one notify) instead of
        a release per task — gate wakeups coalesce with the peer's
        completion batching the same way the memory store's batch waiters
        coalesce get() wakeups."""
        gated = 0
        for task_id, results in pairs:
            gated += self._complete_one(task_id, results)
        if gated:
            self._w.admission_gate.release(gated)

    def _complete_one(self, task_id: TaskID, results: List[tuple]) -> int:
        """Settle one task; returns the number of admission-gate slots the
        CALLER must release (0 or 1) — deferred so ``complete_many`` can
        coalesce a batch's releases into one."""
        pt = self.pending.pop(task_id, None)
        self.oom_kill_counts.pop(task_id, None)
        if pt is None:
            return 0
        gated = 1 if pt.gated else 0
        self._release_args(pt)
        spec = pt.spec
        if results and results[0][0] in ("gen_done", "gen_buffered"):
            self._complete_stream(task_id, spec, results[0])
            return gated
        if spec.num_returns == STREAMING_RETURNS and results \
                and results[0][0] == "error":
            # The generator body raised: the error is the stream's last item
            # (any yields that streamed before the raise stay consumable).
            st = self._w.streams.get(task_id)
            if st is not None:
                self._w.memory_store.put(
                    ObjectID.for_task_return(task_id, st.available),
                    # third element marks runtime-recorded faults (e.g. an
                    # exit_actor inside a generator) — keep them typed
                    ErrorRecord(results[0][1],
                                results[0][2] if len(results[0]) > 2
                                else False))
                st.available += 1
                st.total = st.available
                st.signal()
                if st.replay:
                    # Failed reconstruction replay: no consumer to pop it
                    # (same cleanup as the success and fail() paths).
                    self._w.streams.pop(task_id, None)
            self.num_failed += 1
            self._w.task_event(spec, "FAILED")
            return gated
        for i, res in enumerate(results):
            oid = ObjectID.for_task_return(task_id, i)
            self._w.store_task_result(oid, res)
            self.register_result_borrows(oid, res)
        self.num_finished += 1
        in_lineage = False
        if get_config().lineage_reconstruction_enabled and any(
                r[0] == "plasma" for r in results):
            self.lineage[task_id] = spec
            in_lineage = True
            while len(self.lineage) > 10000:
                self.lineage.popitem(last=False)
        self._w.task_event(spec, "FINISHED")
        # Spec recycling: settled, out of every owner-side structure, never
        # referenced again past this point — back to the free list for the
        # next submission to reuse (only plain pooled task specs; lineage
        # holds the spec for reconstruction, streams/actor-creation specs
        # have longer lives).
        cfg = get_config()
        if (cfg.submit_plane_native_enabled and cfg.spec_freelist_max > 0
                and not in_lineage and not spec.is_actor_creation
                and spec.num_returns != STREAMING_RETURNS):
            recycle_spec(spec, cfg.spec_freelist_max)
        return gated

    def _complete_stream(self, task_id: TaskID, spec: TaskSpec, res: tuple):
        """A streaming task finished: fix the stream's final length.
        ("gen_buffered", [...]) is the no-live-writer fallback — yields
        arrive here all at once instead of having streamed."""
        st = self._w.streams.get(task_id)
        if res[0] == "gen_buffered":
            for i, r in enumerate(res[1]):
                self._w._on_gen_yield(task_id, i, r, "")
            total = len(res[1])
        else:
            total = res[1]
        self.num_finished += 1
        if st is not None:
            st.total = total
            st.signal()
            if st.any_plasma and get_config().lineage_reconstruction_enabled:
                self.lineage[task_id] = spec
                while len(self.lineage) > 10000:
                    self.lineage.popitem(last=False)
            if st.replay:
                # Reconstruction replay: no consumer will ever pop it.
                self._w.streams.pop(task_id, None)
        self._w.task_event(spec, "FINISHED")

    def fail(self, task_id: TaskID, exc: BaseException, tb: str = ""):
        pt = self.pending.pop(task_id, None)
        self.oom_kill_counts.pop(task_id, None)
        if pt is None:
            return
        if pt.gated:
            self._w.admission_gate.release()
        self._release_args(pt)
        # fail() is only reached for runtime-detected faults (worker death,
        # OOM kill, retries exhausted) — never for a task body's own raise,
        # which ships through the ("error", blob) result path.
        err = ErrorRecord(pickle.dumps((exc, tb)), system=True)
        for i in range(pt.spec.num_returns):
            self._w.memory_store.put(ObjectID.for_task_return(task_id, i), err)
        st = self._w.streams.get(task_id)
        if st is not None:
            # Streaming semantics: the error becomes the stream's LAST item —
            # next() returns a ref whose get raises, then StopIteration
            # (matches the reference's generator error delivery).
            self._w.memory_store.put(
                ObjectID.for_task_return(task_id, st.available), err)
            st.available += 1
            st.total = st.available
            st.signal()
            if st.replay:
                # Failed reconstruction replay: no consumer exists to pop it.
                self._w.streams.pop(task_id, None)
        self.num_failed += 1
        self._w.task_event(pt.spec, "FAILED", error=repr(exc))

    def can_retry(self, task_id: TaskID) -> bool:
        pt = self.pending.get(task_id)
        return pt is not None and pt.retries_left != 0

    def use_retry(self, task_id: TaskID,
                  consume: bool = True) -> Optional[TaskSpec]:
        """Negative retries_left means retry forever (max_retries=-1, same
        semantics as the reference's infinite task/actor retries).

        ``consume=False`` re-queues without spending the generic budget —
        used for memory-monitor kills, which have their own bounded
        ``task_oom_retries`` budget (reference: OOM retries are counted
        separately from application failures)."""
        pt = self.pending.get(task_id)
        if pt is None or pt.retries_left == 0:
            return None
        if consume and pt.retries_left > 0:
            pt.retries_left -= 1
        pt.spec.retry_count += 1
        st = self._w.streams.get(task_id)
        if st is not None:
            # The retried generator replays from yield 0; unconsumed indexes
            # will be overwritten as the fresh run re-produces them.
            st.reset_for_retry()
        return pt.spec


# ---------------------------------------------------------------------------
# Lease pools (reference: CoreWorkerDirectTaskSubmitter)
# ---------------------------------------------------------------------------

@dataclass
class LeasedWorker:
    address: str
    worker_id: str
    lease_id: str
    node_id: str
    agent_address: str
    busy: bool = False
    idle_since: float = field(default_factory=time.monotonic)
    return_scheduled: bool = False
    #: tasks completed under this lease (``lease_reuse_max_tasks`` bound)
    tasks_done: int = 0


class LeasePool:
    """One per scheduling key: queue of tasks + leased workers executing them."""

    MAX_LEASES = 64

    def __init__(self, worker: "CoreWorker", key: tuple, resources: Dict[str, float],
                 strategy, bundle: Optional[Tuple[str, int]],
                 runtime_env: Optional[dict] = None):
        self.w = worker
        self.key = key
        self.resources = resources or {"CPU": 1.0}
        self.strategy = strategy
        self.bundle = bundle
        self.runtime_env = runtime_env
        self.queue: collections.deque[TaskSpec] = collections.deque()
        self.leased: Dict[str, LeasedWorker] = {}
        self.requesting = 0
        # Hard node affinity (soft=False) pins execution to ONE node: the
        # lease request must PARK at that agent when it is saturated, never
        # accept a spillback target — following one would silently run the
        # task on the wrong node (e.g. another pool's pipelined spare lease
        # transiently holding the target's last CPU).
        self.hard_affinity = (isinstance(strategy,
                                         NodeAffinitySchedulingStrategy)
                              and not strategy.soft)
        #: human label for decision records (first submitted task's name —
        #: the scheduling key itself is an opaque fn-id hash)
        self.label: Optional[str] = None
        # decision-record rate limiting: identical consecutive outcomes
        # (a stuck pool re-picking every 0.5 s) record the transition plus
        # a periodic heartbeat, not one record per attempt
        self._last_outcome: Optional[str] = None
        self._outcome_repeats = 0

    def submit(self, spec: TaskSpec):
        self.queue.append(spec)
        self._pump()

    # ---------------------------------------------------- explain plane

    def _note_reason(self, reason: str, **detail):
        """Stamp the typed pending reason onto (a bounded prefix of) the
        queued specs — called on TRANSITIONS only (per-task dedup lives in
        pending_reason), so the happy path never sees this."""
        cap = get_config().sched_explain_stamp_max
        for i, spec in enumerate(self.queue):
            if cap > 0 and i >= cap:
                break
            self.w.pending_reason(spec, reason, **detail)

    def _decision(self, outcome: str, explain: Optional[dict] = None,
                  node: Optional[str] = None, **extra):
        """Append one structured decision record to the owner's bounded
        buffer (flushed to the GCS ring with the task-event cadence).
        Consecutive identical outcomes are coalesced: the transition
        records, repeats keep a periodic heartbeat (every 10th)."""
        if not get_config().task_events_enabled:
            return
        if outcome == self._last_outcome:
            self._outcome_repeats += 1
            if self._outcome_repeats % 10:
                return
        else:
            self._last_outcome = outcome
            self._outcome_repeats = 0
        rec = {
            "ts": time.time(), "kind": "task",
            "label": self.label or "?",
            "demand": dict(self.resources),
            "strategy": str(self.strategy),
            "outcome": outcome, "node": node,
            "task_ids": [s.task_id.hex() for s in
                         itertools.islice(self.queue, 5)],
            "task_count": len(self.queue),
            **extra}
        if explain:
            rec["candidates"] = explain.get("candidates")
            rec.update(sched_explain.bound_rejected(
                explain.get("rejected")))
        self.w._sched_decisions.append(rec)

    def _stamp_lease_queued(self, node: Optional[str], addr: str):
        """call_later callback: the lease request has been outstanding past
        ``sched_pending_stamp_after_s`` — it is parked in the agent's lease
        queue (or the agent is saturated), so the queued tasks are now
        observably LEASE_QUEUED rather than in a fast grant."""
        if not self.queue:
            return
        self._note_reason(PendingReason.LEASE_QUEUED, node=node or addr)
        self._decision("queued", node=node or addr)

    def _pump(self):
        # Dispatch queued tasks to idle leased workers.  Multiple queued
        # tasks ride one push RPC (up to max_tasks_in_flight_per_worker),
        # split evenly across idle workers so batching never costs
        # parallelism (reference: direct_task_transport.h:151 pipelining).
        idle = [lw for lw in self.leased.values() if not lw.busy]
        cfg = get_config()
        # submit_batching_enabled=False is the scale-envelope A/B off arm:
        # one task per push RPC, one lease per request RPC.
        max_batch = (cfg.max_tasks_in_flight_per_worker
                     if cfg.submit_batching_enabled else 1)
        while self.queue and idle:
            # Split the queue over EXPECTED capacity (idle workers + leases
            # still being granted), not just current idle workers: batching
            # must never serialize onto one worker what in-flight leases
            # would have parallelized (long tasks would lose whole-node
            # parallelism; reference work-stealing solves the same hazard,
            # direct_task_transport.h:151).  Intra-batch dependencies are
            # fine: each task's result is STREAMED back as it completes
            # (handle_push_task_batch), so a consumer later in the batch
            # resolves its producer without waiting for the batch reply.
            avail = len(idle) + self.requesting
            share = min(max_batch,
                        -(-len(self.queue) // max(1, avail)))  # ceil div
            lw = idle.pop()
            batch = [self.queue.popleft()
                     for _ in range(min(share, len(self.queue)))]
            lw.busy = True
            asyncio.ensure_future(self._run_on(lw, batch))
        # Request more leases only for demand not already covered by idle
        # leased workers or in-flight lease requests.  When there IS unmet
        # demand, pipeline: ask for ``lease_pipeline_window`` leases beyond
        # the deficit so the next burst finds a granted worker instead of
        # paying a lease round trip.  Same-tick demand coalesces into
        # batched ``request_worker_leases`` RPCs of up to submit_batch_max.
        deficit = len(self.queue) - len(idle) - self.requesting
        if deficit > 0:
            deficit += max(0, cfg.lease_pipeline_window)
        want = min(deficit, self.MAX_LEASES - len(self.leased) - self.requesting)
        lease_batch_max = (max(1, cfg.submit_batch_max)
                           if cfg.submit_batching_enabled else 1)
        while want > 0:
            batch = min(want, lease_batch_max)
            want -= batch
            self.requesting += batch
            asyncio.ensure_future(self._acquire_leases(batch))
        # Return leases that ended up idle with nothing queued (covers leases
        # granted after the queue drained).
        if not self.queue:
            for lw in idle:
                if not lw.return_scheduled:
                    lw.return_scheduled = True
                    asyncio.ensure_future(self._maybe_return(lw))

    async def _acquire_leases(self, count: int):
        """Acquire up to ``count`` leases with ONE batched
        ``request_worker_leases`` RPC per attempt — a same-tick submission
        burst's whole lease demand rides a single control-plane round trip
        instead of one RPC per lease.  Spillback/infeasible replies
        retarget exactly like the old single-lease loop; a partial grant
        returns what it got and lets the next ``_pump`` re-evaluate the
        remaining deficit against the (possibly drained) queue."""
        granted = 0
        try:
            target_addr = None
            target_nid = None
            hops = 0
            while not self.w._shutdown and granted < count:
                if not self.queue:
                    # Demand drained (idle workers ate the queue, or a grant
                    # that parked at the agent came back late): STOP
                    # acquiring.  Without this exit a batch that can never
                    # fill its count keeps cycling grant->idle-return->grant
                    # forever, pinning the node's capacity.
                    return
                try:
                    view = await self.w.get_cluster_view()
                except Exception:
                    if self.w._shutdown:
                        return
                    await asyncio.sleep(0.2)
                    continue
                if target_addr is None:
                    # explain only when the event plane will carry it —
                    # the None path keeps pick_node's promise that
                    # un-observed picks pay nothing extra
                    explain = ({} if get_config().task_events_enabled
                               else None)
                    nid = pick_node(view, self.resources, self.strategy,
                                    local_node_id=self.w.node_id,
                                    explain=explain)
                    if nid is None:
                        # Infeasible right now: stamp the typed reason
                        # (NO_RESOURCES, or NODE_DRAINING when the only
                        # would-be hosts are draining), record the
                        # decision with its per-node rejection causes, and
                        # surface the demand shape to the GCS so the
                        # autoscaler can see it (reference: infeasible
                        # tasks show up in cluster load) — then wait.
                        reason = sched_explain.reason_for_no_node(explain)
                        self._note_reason(reason)
                        self._decision("no_node", explain=explain,
                                       reason=reason)
                        try:
                            await self.w.gcs.call(
                                "report_pending_demand",
                                reporter=self.w.address,
                                shape=self.resources,
                                count=max(len(self.queue), 1))
                        except Exception:
                            pass
                        await asyncio.sleep(0.5)
                        if not self.queue:
                            return
                        continue
                    target_addr = view[nid].address
                    target_nid = nid
                agent = self.w.agent_clients.get(target_addr)
                # LEASE_QUEUED is stamped LAZILY: only a request still
                # unanswered after sched_pending_stamp_after_s marks the
                # queue as parked at the agent — a fast grant pays one
                # timer arm/cancel, never a per-task event.
                stamp_h = None
                stamp_after = get_config().sched_pending_stamp_after_s
                if stamp_after > 0 and get_config().task_events_enabled:
                    stamp_h = asyncio.get_event_loop().call_later(
                        stamp_after, self._stamp_lease_queued,
                        target_nid, target_addr)
                try:
                    # Idempotent retrying lease request: a grant whose
                    # reply was lost comes back from the agent's dedup
                    # window on retry instead of leasing a SECOND worker
                    # that nothing would ever return.
                    res = await agent.call_retry(
                        "request_worker_leases",
                        count=count - granted,
                        resources=self.resources,
                        bundle=self.bundle,
                        runtime_env=self.runtime_env,
                        allow_spillback=(hops < 4
                                         and not self.hard_affinity),
                        owner=self.w.address,
                        task_label=str(self.key[0]),
                        _timeout=3600.0, _attempts=8)
                except RemoteError as e:
                    from .common import RuntimeEnvSetupError
                    if isinstance(e.cause, RuntimeEnvSetupError):
                        # Deterministic: the pool's pip env cannot be built;
                        # every queued task shares it — fail them all with
                        # the real error instead of retrying pip forever
                        # while ray.get hangs (reference:
                        # RuntimeEnvSetupError fails the task).
                        while self.queue:
                            spec = self.queue.popleft()
                            self.w.task_manager.fail(spec.task_id, e.cause,
                                                     e.remote_traceback)
                        return
                    # transient agent-side failure (register timeout etc.):
                    # back off and retry the lease
                    target_addr = target_nid = None
                    await asyncio.sleep(0.5)
                    continue
                except (RpcError, OSError):
                    # RemoteError (a subclass) is handled above; this
                    # covers ConnectionLost AND "client closed" from a
                    # pool entry force-closed under us
                    target_addr = target_nid = None
                    await asyncio.sleep(0.2)
                    continue
                finally:
                    if stamp_h is not None:
                        stamp_h.cancel()
                grants = res.get("grants") if isinstance(res, dict) else None
                if grants:
                    self._decision("granted", node=target_nid,
                                   granted=len(grants))
                    for grant in grants:
                        lw = LeasedWorker(grant["worker_address"],
                                          grant["worker_id"],
                                          grant["lease_id"],
                                          grant["node_id"], target_addr)
                        self.leased[lw.lease_id] = lw
                        granted += 1
                    if granted < count:
                        # Partial grant: the node saturated mid-batch.  Pump
                        # NOW so the granted workers start, then keep
                        # acquiring the remainder — the saturated node's
                        # slow path answers with a spillback target, which
                        # is what spreads a burst across the cluster.
                        self._pump()
                        if not self.queue:
                            return
                        continue
                    return
                if "spillback" in res:
                    self._decision("spillback", node=target_nid,
                                   spill_to=res["spillback"].get("node_id"))
                    target_addr = res["spillback"]["address"]
                    target_nid = res["spillback"].get("node_id")
                    hops += 1
                    continue
                if res.get("infeasible"):
                    self._note_reason(PendingReason.NO_RESOURCES,
                                      node=target_nid)
                    self._decision("infeasible", node=target_nid)
                    target_addr = target_nid = None
                    await asyncio.sleep(0.5)
                    continue
                if res.get("backpressure"):
                    # The agent's lease queue is at its depth bound (or the
                    # node is draining): stamp the transition, record the
                    # decision, back off for the advertised interval, then
                    # re-pick a node (the fresh cluster view may route
                    # around the hot agent; spillback spreads the rest).
                    self._note_reason(PendingReason.BACKPRESSURED,
                                      node=target_nid)
                    self._decision("backpressure", node=target_nid,
                                   retry_after_s=res.get("retry_after_s"))
                    target_addr = target_nid = None
                    await asyncio.sleep(res.get(
                        "retry_after_s",
                        get_config().lease_backpressure_retry_s))
                    continue
                # unrecognized reply shape: back off rather than spin
                target_addr = target_nid = None
                await asyncio.sleep(0.2)
        finally:
            self.requesting -= count
            self._pump()

    async def _push_specs(self, client, specs: List[TaskSpec]):
        """Ship one batch to a leased worker, wire-encoding each spec
        through the template cache (invariant portion by hash; args + ids
        per call).  The connection is established FIRST so the encoder's
        delivered-set tracks the connection these frames ride."""
        await client.ensure_connected()
        # serialization-time attribution (sched_metrics_enabled) rides
        # _timed_encode: the owner-side pickling cost per push batch is
        # one of the candidate ceilings on the single-loop submit path
        # (ROADMAP 5).  With owner_serialize_threads the encode runs on
        # the serialization pool instead of blocking this loop.
        payloads = await self.w._encode_offloaded(client, specs)
        if (len(specs) == 1
                and specs[0].num_returns != STREAMING_RETURNS):
            return [await client.call("push_task", spec=payloads[0],
                                      _timeout=86400.0)]
        # Batch RPC even for one task when it streams: only the batch
        # handler has the live writer that yield frames ride on.
        return await client.call("push_task_batch", specs=payloads,
                                 _timeout=86400.0)

    async def _run_on(self, lw: LeasedWorker, specs: List[TaskSpec]):
        client = self.w.worker_clients.get(lw.address)
        for spec in specs:
            self.w.task_event(spec, "RUNNING", node_id=lw.node_id)
        try:
            try:
                results_list = await self._push_specs(client, specs)
            except RemoteError as e:
                if not isinstance(e.cause, spec_cache.SpecCacheMiss):
                    raise
                # The worker evicted a template we thought delivered (its
                # decode raised before dispatching anything): resend once
                # with full templates.
                for spec in specs:
                    self.w.pending_reason(spec,
                                          PendingReason.SPEC_CACHE_RESEND,
                                          node=lw.node_id)
                spec_cache.SpecEncoder.forget_client(client)
                results_list = await self._push_specs(client, specs)
        except (RpcError, RemoteError, OSError) as e:
            # RpcError covers ConnectionLost AND "client closed" (the
            # pooled client force-closed by a worker-killed notification
            # racing this push) — both mean the worker is unusable
            await self._on_worker_failure(lw, specs, e)
            return
        for spec, results in zip(specs, results_list):
            if results != "__streamed__":  # else completed via push already
                self.w.task_manager.complete(spec.task_id, results)
        lw.tasks_done += len(specs)
        reuse_cap = get_config().lease_reuse_max_tasks
        if (reuse_cap > 0 and lw.tasks_done >= reuse_cap
                and lw.lease_id in self.leased):
            # Reuse bound hit: hand the worker back so one pool cannot
            # monopolise a node; the pump re-leases for remaining demand.
            self.leased.pop(lw.lease_id, None)
            try:
                agent = self.w.agent_clients.get(lw.agent_address)
                await agent.call_retry("return_worker_lease",
                                       lease_id=lw.lease_id,
                                       worker_id=lw.worker_id,
                                       worker_alive=True)
            except Exception:
                pass
        else:
            lw.busy = False
            lw.idle_since = time.monotonic()
        self._pump()

    async def _on_worker_failure(self, lw: LeasedWorker, specs: List[TaskSpec],
                                 err: Exception):
        self.leased.pop(lw.lease_id, None)
        death_cause = None
        try:
            agent = self.w.agent_clients.get(lw.agent_address)
            res = await agent.call_retry("return_worker_lease",
                                         lease_id=lw.lease_id,
                                         worker_id=lw.worker_id,
                                         worker_alive=False)
            if isinstance(res, dict):
                death_cause = res.get("death_cause")
        except Exception:
            pass
        # backstop: the killing agent may have pushed the cause directly
        # (handle_worker_killed) if the lease return raced the kill
        death_cause = death_cause or self.w._kill_causes.pop(
            lw.worker_id, None)
        retries: List[TaskSpec] = []
        oom_limit = get_config().task_oom_retries
        for spec in specs:
            if death_cause:
                # The agent killed this worker deliberately (memory
                # monitor).  OOM kills have their OWN bounded budget
                # (task_oom_retries) and do not consume the generic retry
                # budget — but an always-OOM task must FAIL with advice
                # rather than loop forever (reference: task_oom_retries +
                # the group-by-owner policy's infeasible-task escape).
                n = self.w.task_manager.note_oom_kill(spec.task_id)
                if oom_limit < 0 or n <= oom_limit:
                    retry_spec = self.w.task_manager.use_retry(
                        spec.task_id, consume=False)
                    if retry_spec is not None:
                        retries.append(retry_spec)
                        continue
                self.w.task_manager.fail(
                    spec.task_id,
                    OutOfMemoryError(
                        f"task {spec.name} was killed by the memory monitor "
                        f"{n} time(s) ({death_cause}); no retries remain "
                        f"(task_oom_retries={oom_limit}, "
                        f"max_retries={spec.max_retries}). The task's "
                        "working set appears to exceed what this node can "
                        "admit — reduce its memory footprint, raise its "
                        "resource request so fewer tasks run concurrently, "
                        "or add memory/nodes."), "")
                continue
            retry_spec = self.w.task_manager.use_retry(spec.task_id)
            if retry_spec is not None:
                retries.append(retry_spec)
            else:
                self.w.task_manager.fail(
                    spec.task_id,
                    WorkerCrashedError(f"worker {lw.worker_id[:12]} died running "
                                       f"{spec.name}: {err}"), "")
        if retries:
            # Keep ORIGINAL submission order at the queue head: batching
            # assumes queue order == dependency order (a reversed requeue
            # could batch a consumer ahead of its producer).
            self.queue.extendleft(reversed(retries))
            await asyncio.sleep(_task_retry_delay(
                max(s.retry_count for s in retries)))
            self._pump()

    async def _maybe_return(self, lw: LeasedWorker):
        try:
            await asyncio.sleep(get_config().lease_idle_return_ms / 1000.0)
        finally:
            lw.return_scheduled = False
        if lw.busy or self.queue or lw.lease_id not in self.leased:
            return
        self.leased.pop(lw.lease_id, None)
        try:
            agent = self.w.agent_clients.get(lw.agent_address)
            # token'd retry: a double-applied return would release the
            # lease's resources twice and inflate the node's capacity
            await agent.call_retry("return_worker_lease",
                                   lease_id=lw.lease_id,
                                   worker_id=lw.worker_id, worker_alive=True)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Actor submission state (per ActorHandle target)
# ---------------------------------------------------------------------------

@dataclass
class ActorTarget:
    actor_id: str
    address: Optional[str] = None
    seq: int = 0
    state: str = "PENDING"
    # Submission-ordered outbox drained by a single pump coroutine per
    # target: ordering comes from the pump being the only sender, and
    # batching comes for free (reference: per-handle sequence numbers +
    # client queueing in CoreWorkerDirectActorTaskSubmitter).
    outbox: "collections.deque[TaskSpec]" = field(
        default_factory=collections.deque)
    pump_running: bool = False


# ---------------------------------------------------------------------------
# The CoreWorker
# ---------------------------------------------------------------------------

class CoreWorker:
    def __init__(self, mode: str, gcs_address: str, agent_address: Optional[str],
                 node_id: Optional[str], job_id: Optional[JobID] = None,
                 session_dir: Optional[str] = None):
        self.mode = mode  # "driver" | "worker"
        self.worker_id = WorkerID.from_random()
        self.job_id = job_id or JobID(b"\x00\x00\x00\x01")
        self.gcs_address = gcs_address
        self.agent_address = agent_address
        self.node_id = node_id
        self.session_dir = session_dir or session_root()
        self.server = RpcServer(self, "127.0.0.1", 0)
        self.gcs: Optional[RpcClient] = None
        self.agent: Optional[RpcClient] = None
        cfg_boot = get_config()
        # Submission lanes (ROADMAP 5): worker/agent connections spread
        # (sticky per address) over agent_client_connections IO-loop
        # threads, so different peers' frame codecs and socket syscalls
        # overlap on separate OS threads.  Owner STATE stays lane-0
        # confined: laned clients' pushes hop back via _on_peer_push_routed.
        lanes = max(1, cfg_boot.agent_client_connections)
        self.agent_clients = ClientPool(lanes=lanes)
        # Worker peers stream per-task results as pushes on the batch
        # connection (see handle_push_task_batch): route them straight into
        # the task manager so a consumer elsewhere in the same batch can
        # resolve its dependency without waiting for the batch reply.
        # Single-lane pools skip the thread-routing shim entirely.
        self.worker_clients = ClientPool(
            push_handler=(self._on_peer_push if lanes == 1
                          else self._on_peer_push_routed),
            lanes=lanes)
        # Owner-side serialization pool (owner_serialize_threads): spec
        # wire-encoding for push batches runs here instead of on the RPC
        # loop, overlapping pickle time with the loop's socket work.
        if cfg_boot.owner_serialize_threads > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._ser_pool = ThreadPoolExecutor(
                cfg_boot.owner_serialize_threads,
                thread_name_prefix="raytpu-ser")
        else:
            self._ser_pool = None
        self.memory_store = MemoryStore()
        self.reference_counter = ReferenceCounter(self)
        # result-object id -> [(contained oid, owner)] borrows registered at
        # task-result receipt; released when the result object is freed.
        self._contained_borrows: Dict[ObjectID, list] = {}
        # Owner-side escrow holds: oid -> {hold_id: expiry_deadline}.  Placed
        # by producers shipping our refs inside results, released by the
        # consumers that register the borrow (WaitForRefRemoved-equivalent).
        self._escrow_holds: Dict[ObjectID, Dict[str, float]] = {}
        self._hold_seq = itertools.count()
        # In-flight ADD borrower notes awaiting owner acks (see
        # flush_borrower_notes).
        self._pending_notes: set = set()
        self.task_manager = TaskManager(self)
        self.shm_reader = ShmReader()
        self.lease_pools: Dict[tuple, LeasePool] = {}
        self.actor_targets: Dict[str, ActorTarget] = {}
        # Submission coalescing: bursts of .remote() calls from the user
        # thread buffer here and drain in ONE loop callback, so the IO loop
        # wakes once per burst (not per call) and lease pools see the whole
        # burst at _pump time — which is what makes push batching effective.
        self._submit_buffer: collections.deque = collections.deque()
        self._submit_lock = threading.Lock()
        self._submit_flush_scheduled = False
        # Bounded flush window state: an armed call_later handle
        # (submit_flush_window_ms) and whether a buffer-full promotion
        # already scheduled an immediate flush for this window.
        self._submit_timer = None
        self._submit_flush_promoted = False
        # Ref-death coalescing (submit plane): dead oids buffer here and
        # drain in ONE loop callback + ONE task, so a burst of ObjectRef
        # finalizers costs one self-pipe wakeup instead of one per ref.
        self._free_buffer: list = []
        self._free_lock = threading.Lock()
        self._free_scheduled = False
        # Executor->loop reply coalescing (worker side of the same plane):
        # completed results buffer here; one loop callback resolves the
        # whole burst's futures.
        self._reply_buffer: list = []
        self._reply_lock = threading.Lock()
        self._reply_scheduled = False
        # Admission control: the waitable in-flight window every public
        # submission passes through (see _AdmissionGate).
        self.admission_gate = _AdmissionGate()
        self.fn_cache: Dict[bytes, Any] = {}
        # Submission fast path: per-(function, options) spec template
        # encoder (core/spec_cache.py) — invariant spec portions wire-encode
        # once per peer connection, each call ships only args + ids.
        self.spec_encoder = spec_cache.SpecEncoder()
        # In-flight inline->shm promotions (oid -> future): concurrent
        # borrowers of one inlined result share a single store_create.
        self._promotions: Dict[ObjectID, "asyncio.Future"] = {}
        # Streaming-generator state: owner side (task_id -> StreamState for
        # tasks WE submitted) and executor side (task_id -> _GenEmitter for
        # streaming tasks we are currently RUNNING).
        #: worker_id -> typed death cause pushed by the killing agent
        self._kill_causes: Dict[str, str] = {}
        self.streams: Dict[TaskID, "StreamState"] = {}
        self._gen_emitters: Dict[TaskID, "_GenEmitter"] = {}
        self._view_cache: Tuple[float, Dict[str, NodeView]] = (0.0, {})
        self._task_events: List[dict] = []
        #: events shed because the owner buffer hit task_events_max_buffer
        #: between flushes (a 1M-task drain must not hold 3M event dicts);
        #: _dropped is the since-last-flush delta (shipped to the GCS and
        #: reset), _shed_total the process-lifetime cumulative count
        self._task_events_dropped = 0
        self.task_events_shed_total = 0
        #: submission-plane observability: event dicts actually emitted vs
        #: suppressed by task_event_sample_n (exact counters — the sampled
        #: payload stream is a view, these are the ground truth)
        self._sp_events_emitted = 0
        self._sp_events_sampled = 0
        #: owner-side submit timestamps: the "queue" (submit->dispatch) and
        #: "total" (submit->terminal) stage durations are computed from these
        self._submit_ts: Dict[TaskID, float] = {}
        # Scheduler explain plane (core/sched_explain.py): the last typed
        # pending reason stamped per task (dedup — a backpressure retry
        # loop stamps one transition, not one event per attempt; entries
        # clear on RUNNING/terminal) and the bounded buffer of structured
        # lease-acquisition decision records flushed to the GCS ring
        # alongside task events.
        self._last_reason: Dict[TaskID, str] = {}
        self._sched_decisions: collections.deque = collections.deque(
            maxlen=512)
        # Object-plane flight recorder (core/object_explain.py): bounded
        # buffer of owner-side lifecycle transitions (CREATED/INLINED/
        # FREED) flushed to the GCS object-event ring alongside task
        # events.  Never written when object_metrics_enabled is off.
        self._object_events: collections.deque = collections.deque(
            maxlen=4096)
        # STAGES-event rate cap bookkeeping (see _record_stages)
        self._stage_event_window = 0
        self._stage_event_count = 0
        self._bg: List[asyncio.Task] = []
        # executor state (worker mode)
        self.exec_queue: "_queue.Queue[tuple]" = _queue.Queue()
        self.actor_instance: Any = None
        self.actor_spec: Optional[TaskSpec] = None
        self._actor_threadpool = None
        self._actor_async_loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown = False
        self._blocked_depth = 0

    # ------------------------------------------------------------------ boot

    async def _start(self):
        await self.server.start()
        # Shard-aware control-plane client (core/gcs_router.py): hot
        # per-task traffic (kv, task/object/sched event flushes) goes
        # client->shard direct by key once the shard map arrives; the
        # globally-ordered methods go to the router.  With sharding off
        # this degrades to exactly the old single connection.
        from .gcs_router import ShardedGcsClient
        self.gcs = ShardedGcsClient(self.gcs_address,
                                    identity=self.worker_id.hex())
        if self.agent_address:
            self.agent = self.agent_clients.get(self.agent_address)
        if get_config().task_events_enabled or object_explain.enabled():
            # the flush loop also carries owner-side object events and
            # sched decisions, so the object plane alone keeps it alive
            self._bg.append(asyncio.ensure_future(self._flush_task_events_loop()))
        from ray_tpu_torch.util.usage_stats import usage_stats_enabled
        if usage_stats_enabled():
            self._bg.append(asyncio.ensure_future(self._usage_flush_loop()))
        # Config-gated stall detector on the shared IO loop: driver/worker
        # asyncio stalls surface as raytpu_event_loop_lag_seconds alongside
        # the agent's and GCS's (see util/loop_monitor.install).
        from ray_tpu_torch.util.loop_monitor import install as _install_loop_mon
        self._loop_monitor = _install_loop_mon(
            asyncio.get_event_loop(),
            f"{self.mode}:{self.worker_id.hex()[:12]}",
            gcs_call=self.gcs.call)
        return self

    async def _usage_flush_loop(self):
        """Periodically push this process's usage records to the GCS KV —
        the path by which WORKER-side library imports (a task body's
        ``import ray_tpu_torch.train``) reach the cluster usage report
        (reference: usage_lib's worker-side record propagation).  The
        flush is a no-op unless records changed since the last push."""
        from ray_tpu_torch.util import usage_stats
        while not self._shutdown:
            await asyncio.sleep(30.0)
            try:
                await usage_stats.flush_via(self.gcs.call, self.gcs_address)
            except Exception:
                pass

    def start(self):
        run_async(self._start())
        set_global_worker(self)
        # spans recorded before this process had a worker (driver pre-init)
        # were buffered locally — drain them into the event stream now
        from ray_tpu_torch.util.tracing import flush_pending_spans
        flush_pending_spans()
        return self

    @property
    def address(self) -> str:
        return self.server.address

    def shutdown(self):
        self._shutdown = True
        if getattr(self, "_loop_monitor", None):
            self._loop_monitor.stop()
        if self._ser_pool is not None:
            self._ser_pool.shutdown(wait=False)

        async def _stop():
            for t in self._bg:
                t.cancel()
            await self.server.stop()
            await self.agent_clients.close_all()
            await self.worker_clients.close_all()
            if self.gcs:
                await self.gcs.close()
        try:
            run_async(_stop(), timeout=5)
        except Exception:
            pass
        self.shm_reader.close()
        if global_worker_or_none() is self:
            set_global_worker(None)

    # -------------------------------------------------------------- telemetry

    def task_event(self, spec: TaskSpec, state: str, **extra):
        cfg = get_config()
        if not cfg.task_events_enabled:
            return
        now = time.time()
        # Owner-side stage stamps: SUBMITTED->RUNNING is the scheduling/
        # queueing stage (lease acquisition + dispatch), SUBMITTED->terminal
        # is the task's whole wall clock.  Durations ride the events (the
        # timeline and summarize_tasks read them there) and feed the stage
        # histogram (the /metrics percentiles).
        if cfg.task_stage_breakdown_enabled:
            if state == "SUBMITTED":
                self._submit_ts[spec.task_id] = now
                while len(self._submit_ts) > cfg.task_events_max_buffer:
                    self._submit_ts.pop(next(iter(self._submit_ts)))
            elif state == "RUNNING":
                t0 = self._submit_ts.get(spec.task_id)
                if t0 is not None:
                    extra.setdefault("queue_s", now - t0)
                    _observe_stage("queue", now - t0)
            elif state in ("FINISHED", "FAILED"):
                t0 = self._submit_ts.pop(spec.task_id, None)
                if t0 is not None:
                    extra.setdefault("total_s", now - t0)
                    _observe_stage("total", now - t0)
        if state in ("RUNNING", "FINISHED", "FAILED"):
            # next pending episode (a retry re-queued by a worker death)
            # gets a fresh reason transition
            self._last_reason.pop(spec.task_id, None)
        # Sampled event payloads: the histograms and stage stamps above
        # observed EVERY task; the per-task SUBMITTED/RUNNING event dicts
        # ship 1-in-N when task_event_sample_n > 1.  Terminal states
        # (FINISHED/FAILED) and typed PENDING reasons always emit — so
        # summarize_tasks still counts every task (it keys on the NEWEST
        # event per task) and `raytpu explain` answers for any task that
        # reached a terminal or stuck state.  The coin is the task id's
        # last byte (the 8-byte incrementing counter tail — uniform), so a
        # task's trail is all-or-nothing, never half-sampled.
        n = cfg.task_event_sample_n
        if (n > 1 and state in ("SUBMITTED", "RUNNING")
                and spec.task_id._bin[-1] % n):
            self._sp_events_sampled += 1
            return
        self._sp_events_emitted += 1
        ev = {
            "task_id": spec.task_id.hex(), "name": spec.name, "state": state,
            "job_id": spec.job_id.hex(), "ts": now,
            "actor_id": spec.actor_id.hex() if spec.actor_id else None,
            **extra}
        if spec.trace_ctx:
            # the task's slice joins the submitter's trace: its own span id
            # derives from the task id so parent/child arrows line up
            ev.setdefault("trace_id", spec.trace_ctx[0])
            ev.setdefault("parent_id", spec.trace_ctx[1])
            ev.setdefault("span_id", spec.task_id.hex()[:12])
        self._append_task_event(ev)

    def _timed_encode(self, client, specs: List[TaskSpec]) -> list:
        """Wire-encode specs through the template cache, attributing the
        pickling time to ``raytpu_sched_owner_serialize_seconds`` (one
        observation per batch) — the owner-loop cost the saturation plane
        must separate from dispatch/flush time."""
        om = sched_explain.owner_metrics()
        t0 = time.perf_counter() if om is not None else 0.0
        payloads = None
        if len(specs) > 1:
            # Warm batches collapse into ONE packed binary frame (native
            # submission plane) — the RPC pickle sees a single bytes blob
            # instead of N nested tuples.  Ineligible batches (big args,
            # actor creations, cache off) fall back to per-spec encode.
            packed = self.spec_encoder.encode_batch(client, specs)
            if packed is not None:
                payloads = packed
        if payloads is None:
            payloads = [self.spec_encoder.encode(client, s) for s in specs]
        if om is not None:
            om["serialize"].observe(time.perf_counter() - t0)
        return payloads

    async def _encode_offloaded(self, client, specs: List[TaskSpec]) -> list:
        """Wire-encode a push batch, on the serialization pool when
        configured (owner_serialize_threads — the submission-lane split:
        pickling overlaps the loop's socket work) or inline otherwise.
        Single-spec batches stay inline: the executor hop costs more than
        a warm one-spec encode."""
        if self._ser_pool is not None and len(specs) > 1:
            return await asyncio.get_event_loop().run_in_executor(
                self._ser_pool, self._timed_encode, client, specs)
        return self._timed_encode(client, specs)

    def pending_reason(self, spec: TaskSpec, reason: str, **detail):
        """Stamp a typed pending-reason transition onto the task-event
        plane: one ``state="PENDING"`` event carrying ``reason=<constant
        from PendingReason>`` plus optional bounded detail (node id,
        cause).  Deduped per task — re-entering the same reason (a
        backpressure retry loop, repeated infeasible picks) records
        nothing, so the trail is the TRANSITION history, with timestamps.

        Reasons MUST be ``PendingReason.*`` constants (AST lint in
        tests/test_metric_naming.py): they become event fields and rollup
        keys, and a free-form string here would be an unbounded label."""
        if not get_config().task_events_enabled:
            return
        if self._last_reason.get(spec.task_id) == reason:
            return
        self._last_reason[spec.task_id] = reason
        # same ceiling discipline as _submit_ts: a flood of stuck tasks
        # must not grow this map without bound.  Unlike _submit_ts this
        # map has TWO writer threads (a gate-parked driver thread and the
        # IO loop), so eviction must tolerate losing the race for the
        # front key — never raise into a lease-acquisition task.
        while len(self._last_reason) > get_config().task_events_max_buffer:
            try:
                self._last_reason.pop(next(iter(self._last_reason)), None)
            except (StopIteration, RuntimeError, KeyError):
                break
        self.task_event(spec, "PENDING", reason=reason, **detail)

    def object_event(self, oid: ObjectID, event: str, **extra):
        """Stamp one owner-side object lifecycle transition (a constant
        from ``ObjectEvent``) onto the flight-recorder plane.  One cached
        boolean when the object plane is off; the deque bounds memory."""
        if not object_explain.enabled():
            return
        self._object_events.append({
            "object_id": oid.hex(), "event": event, "ts": time.time(),
            "owner": self.address, **extra})

    def _append_task_event(self, ev: dict):
        """Bounded owner-side event buffer: beyond task_events_max_buffer
        unflushed events, new ones are SHED (drop-newest, O(1)) and counted
        — a million-task drain keeps a flat event-memory ceiling instead of
        holding millions of dicts between flush ticks.  The shed count
        rides the next flush so the GCS can surface the gap."""
        if len(self._task_events) >= get_config().task_events_max_buffer:
            self._task_events_dropped += 1
            self.task_events_shed_total += 1
            return
        self._task_events.append(ev)

    def _record_stages(self, spec: TaskSpec, stages: Dict[str, list]):
        """Executor-side per-stage breakdown of one completed task: appends
        a STAGES task event (the timeline renders these as nested sub-slices
        inside the task's slice) and observes each duration into
        ``raytpu_task_stage_seconds``.  Runs on the executor thread;
        list.append is atomic under the GIL (same contract as span())."""
        cfg = get_config()
        if (not stages or not cfg.task_events_enabled
                or not cfg.task_stage_breakdown_enabled):
            return
        payload: Dict[str, tuple] = {}
        for name, (t0, t1) in stages.items():
            dur = max(0.0, t1 - t0)
            payload[name] = (t0, dur)
            _observe_stage(name, dur)
        # Per-task event payloads are rate-capped (histograms above are
        # not): under a small-task flood the timeline samples, instead of
        # the event pipeline eating the throughput it is measuring.
        cap = cfg.task_stage_events_per_s
        if cap > 0:
            now_s = int(time.time())
            if now_s != self._stage_event_window:
                self._stage_event_window = now_s
                self._stage_event_count = 0
            if self._stage_event_count >= cap:
                return
            self._stage_event_count += 1
        # deliberately slim (no job/actor ids): one of these ships per task
        self._append_task_event({
            "task_id": spec.task_id.hex(), "name": spec.name,
            "state": "STAGES",
            "ts": min(t0 for t0, _ in payload.values()),
            "worker": self.worker_id.hex()[:12],
            "stages": payload})

    def _submit_plane_counters(self) -> dict:
        """Exact submission-plane counters that piggyback the task-event
        flush (no extra RPC): the GCS folds the latest snapshot per owner
        into sched_stats, so ``raytpu status`` shows what sampling hid."""
        from ..native import submit_plane_loaded
        cfg = get_config()
        return {
            "owner": self.address,
            "events_emitted": self._sp_events_emitted,
            "events_sampled": self._sp_events_sampled,
            "events_shed": self.task_events_shed_total,
            "freelist_hits": _common.spec_freelist_hits,
            "freelist_misses": _common.spec_freelist_misses,
            "native_enabled": bool(cfg.submit_plane_native_enabled),
            "native_loaded": submit_plane_loaded(),
            "sample_n": int(cfg.task_event_sample_n),
        }

    async def _flush_task_events_loop(self):
        CHUNK = 10_000  # bound the per-RPC frame, not one giant pickle
        while not self._shutdown:
            await asyncio.sleep(1.0)
            if self._task_events and self.gcs:
                batch, self._task_events = self._task_events, []
                dropped, self._task_events_dropped = \
                    self._task_events_dropped, 0
                try:
                    # token'd retry: a lost reply must not double-record
                    # the batch (duplicate events skew summarize_tasks)
                    for i in range(0, len(batch), CHUNK):
                        await self.gcs.call_retry(
                            "add_task_events", events=batch[i:i + CHUNK],
                            dropped=dropped if i == 0 else 0,
                            counters=self._submit_plane_counters()
                            if i == 0 else None)
                except Exception:
                    pass
            if self._object_events and self.gcs:
                # owner-side object lifecycle events (CREATED/INLINED/
                # FREED) piggyback the task-event cadence into the GCS
                # object ring (best effort, same as decisions below)
                events = list(self._object_events)
                self._object_events.clear()
                try:
                    await self.gcs.call("add_object_events", events=events,
                                        _timeout=10)
                except Exception:
                    pass
            if self._sched_decisions and self.gcs:
                # owner-side scheduling decision records ride the same
                # cadence into the GCS ring (best effort: a lost batch
                # costs explain detail, never correctness)
                records = list(self._sched_decisions)
                self._sched_decisions.clear()
                try:
                    await self.gcs.call(
                        "add_sched_decisions", records=records, _timeout=10)
                except Exception:
                    pass

    # ---------------------------------------------------------- cluster view

    async def get_cluster_view(self) -> Dict[str, NodeView]:
        now = time.monotonic()
        ts, view = self._view_cache
        if now - ts < 0.1 and view:
            return view
        payload = await self.gcs.call_retry("get_cluster_view",
                                            _idempotent=False)
        # draining rides the view so OWNER-side pick_node routes around a
        # preempted node up front (it used to be dropped here, and clients
        # only learned via a backpressure round trip to the draining agent)
        view = {nid: NodeView(nid, d["address"], d["total"], d["available"],
                              d.get("labels", {}), d.get("alive", True),
                              d.get("queue_len", 0),
                              draining=d.get("draining", False),
                              task_leased=d.get("task_leased", {}))
                for nid, d in payload.items()}
        self._view_cache = (now, view)
        return view

    # ------------------------------------------------------------------- put

    def put(self, value: Any) -> ObjectRef:
        return run_async(self.put_async(value))

    async def put_async(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random()
        if await self._try_zero_copy_put(oid, value):
            return ObjectRef(oid, owner=self.address)
        so = serialization.serialize(value)
        await self._store_serialized(oid, so)
        return ObjectRef(oid, owner=self.address)

    async def _try_zero_copy_put(self, oid: ObjectID, value: Any) -> bool:
        """Reserve-then-write put (the ledger's ``put/copies=0`` class):
        estimate the flat size WITHOUT pickling, reserve the arena range,
        and serialize straight into it — the pickler's out-of-band
        buffers land by parallel gather-write, the inband stream and
        header follow, and seal happens in place (no intermediate bytes,
        no serial post-hoc memcpy; see core/serialization.py).

        False when the value is small / not estimable / not
        buffer-dominated, when ``zero_copy_put_enabled`` is off, or on a
        size-estimate miss (the reservation is released) — the caller
        then takes the classic 1-copy path unchanged."""
        cfg = get_config()
        if not cfg.zero_copy_put_enabled or self.agent is None:
            return False
        bounds = serialization.estimate_flat_size(value)
        # the inline-vs-plasma threshold compares the LOWER bound: a value
        # whose exact flat size would still inline must not be pushed into
        # the shm store by a pessimistic reservation estimate
        if bounds is None or bounds[1] <= cfg.max_direct_call_object_size:
            return False
        est = bounds[0]
        res = await self.agent.call_retry("store_create", object_id=oid,
                                          size=est, owner=self.address)
        seg = ShmSegment(res["path"], est, create=False)
        try:
            landed = serialization.serialize_into(value, seg.view())
        finally:
            seg.close()
        if landed is None:
            # estimate miss: release the reservation; nothing depends on
            # the partial landing (the entry was never sealed)
            try:
                await self.agent.call_retry("store_free", object_ids=[oid])
            except Exception:
                pass
            return False
        object_explain.ledger_record(object_explain.KEY_PUT_ZC, landed.used)
        self.object_event(oid, ObjectEvent.CREATED, size=landed.used,
                          node=(self.node_id or "")[:12] or None,
                          zero_copy=True)
        # seal TRUNCATES to the exact bytes written: readers/transfers/
        # spills must never touch the reservation's slack tail (recycled
        # arena memory — another object's stale bytes)
        await self.agent.notify("store_seal", object_id=oid,
                                size=landed.used)
        self.memory_store.put(
            oid, PlasmaRecord(landed.used,
                              [(self.node_id, self.agent_address)]))
        return True

    async def _store_serialized(self, oid: ObjectID, so: serialization.SerializedObject):
        cfg = get_config()
        size = so.flat_size()
        if size <= cfg.max_direct_call_object_size or self.agent is None:
            self.memory_store.put(oid, so.to_bytes())
            object_explain.ledger_record(object_explain.KEY_PUT_INLINE,
                                         size)
            self.object_event(oid, ObjectEvent.INLINED, size=size)
        else:
            res = await self.agent.call_retry("store_create", object_id=oid,
                                              size=size, owner=self.address)
            # CREATED is stamped BEFORE the seal notify: the agent's SEALED
            # event must never carry an earlier timestamp than the owner's
            # CREATED (explain_object sorts by ts — an inverted trail would
            # render an impossible lifecycle).  The ledger's headline row
            # rides along: the put path declares ONE payload copy
            # (serialize straight into the arena mapping); the
            # zero-copy-put rewrite must move this to copies=0.
            object_explain.ledger_record(object_explain.KEY_PUT, size)
            self.object_event(oid, ObjectEvent.CREATED, size=size,
                              node=(self.node_id or "")[:12] or None)
            seg = ShmSegment(res["path"], size, create=False)
            try:
                so.write_into(seg.view())
            finally:
                seg.close()
            # One-way seal: saves a round trip per put.  Readers that race it
            # park on wait_sealed at the agent (fetch_object), and this
            # process's own later agent calls are ordered behind it on the
            # same connection.
            await self.agent.notify("store_seal", object_id=oid)
            self.memory_store.put(
                oid, PlasmaRecord(size, [(self.node_id, self.agent_address)]))

    def store_task_result(self, oid: ObjectID, res: tuple):
        """Record a task's return descriptor into the owner's memory store."""
        kind = res[0]
        if kind == "inline":
            self.memory_store.put(oid, res[1])
        elif kind == "plasma":
            self.memory_store.put(oid, PlasmaRecord(res[1], res[2]))
        elif kind == "error":
            # optional third element marks a RUNTIME-recorded fault (e.g.
            # exit_actor's intended-death record) so get raises it typed
            self.memory_store.put(oid, ErrorRecord(
                res[1], res[2] if len(res) > 2 else False))
        else:
            raise ValueError(f"bad result kind {kind}")

    # ------------------------------------------------------------------- get

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        # Fast path: every ref already resolved to an inline/error record in
        # the local memory store — deserialize on the calling thread, no IO
        # loop round trip, no block/unblock protocol (nothing waits).
        records = []
        for r in refs:
            rec = self.memory_store.get_if_exists(r.id)
            if rec is None or isinstance(rec, PlasmaRecord):
                records = None
                break
            records.append(rec)
        if records is not None:
            values = [self._inline_record_to_value(r, rec)
                      for r, rec in zip(refs, records)]
            return values[0] if single else values
        self._on_block()
        try:
            values = run_async(self.get_async_many(refs, timeout),
                               timeout=None if timeout is None else timeout + 10)
        finally:
            self._on_unblock()
        return values[0] if single else values

    def _inline_record_to_value(self, ref: ObjectRef, record):
        if isinstance(record, ErrorRecord):
            exc, tb = pickle.loads(record.error)
            if isinstance(exc, TaskError):
                raise exc
            if record.system and isinstance(exc, RayTpuError):
                # Runtime-recorded faults (OutOfMemoryError, WorkerCrashed,
                # ActorDied, …) surface typed, not wrapped — matches
                # ray.exceptions semantics.  A task BODY that lets a
                # RayTpuError propagate still wraps in TaskError below, so
                # the failure stays attributed to the raising task.
                raise exc
            raise TaskError(exc, ref.hex()[:12], tb) from None
        if record == serialization.none_bytes():
            return None
        return serialization.loads(record)

    async def get_async_many(self, refs: List[ObjectRef],
                             timeout: Optional[float] = None) -> List[Any]:
        # Batched wait for OWNED refs (the drain hot path): one shared
        # future wakes when the last result lands (MemoryStore.wait_many)
        # instead of a gather over per-ref coroutines + Events — the
        # owner-loop get machinery was one of the measured single-loop
        # ceilings (ROADMAP 5).  Borrowed refs keep the per-ref path
        # (owner round trips are genuinely per-ref).
        if (get_config().completion_batching_enabled
                and all(r.owner in ("", self.address) for r in refs)):
            ok = await self.memory_store.wait_many(
                [r.id for r in refs], timeout)
            if not ok:
                raise GetTimeoutError(
                    f"timed out waiting for {len(refs)} objects")
            records = [self.memory_store.get_if_exists(r.id) for r in refs]
            if any(isinstance(rec, PlasmaRecord) for rec in records):
                return list(await asyncio.gather(
                    *[self._record_to_value(r, rec)
                      for r, rec in zip(refs, records)]))
            return [self._inline_record_to_value(r, rec)
                    for r, rec in zip(refs, records)]
        return list(await asyncio.gather(*[self.get_async(r, timeout) for r in refs]))

    async def get_async(self, ref: ObjectRef, timeout: Optional[float] = None) -> Any:
        record = await self._resolve_record(ref, timeout)
        return await self._record_to_value(ref, record)

    async def _resolve_record(self, ref: ObjectRef, timeout: Optional[float]):
        oid = ref.id
        if self.memory_store.contains(oid):
            return self.memory_store.get_if_exists(oid)
        if ref.owner in ("", self.address):
            ok = await self.memory_store.wait_ready(oid, timeout)
            if not ok:
                raise GetTimeoutError(f"timed out waiting for {ref}")
            return self.memory_store.get_if_exists(oid)
        # Borrowed ref: ask the owner (it blocks until the producing task finishes).
        owner = self.worker_clients.get(ref.owner)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 30.0 if deadline is None else max(0.0, deadline - time.monotonic())
            if deadline is not None and step <= 0:
                raise GetTimeoutError(f"timed out waiting for {ref}")
            try:
                # bounded retry first: a transient drop on the owner link
                # must not masquerade as owner death (ObjectLostError)
                rec = await owner.call_retry(
                    "locate_object", object_id=oid,
                    timeout=min(step, 30.0) if deadline else 30.0,
                    _timeout=(min(step, 30.0) if deadline else 30.0) + 15,
                    _attempts=3, _idempotent=False)
            except asyncio.TimeoutError:
                # slow-but-alive owner (on 3.11+ TimeoutError is an
                # OSError subclass — it must NOT read as owner death)
                raise
            except (ConnectionLost, ConnectionError, OSError):
                raise ObjectLostError(oid, f"owner {ref.owner} of {ref} died") from None
            if rec is not None:
                if rec[0] == "plasma":
                    return PlasmaRecord(rec[1], rec[2])
                if rec[0] == "inline":
                    return rec[1]
                return ErrorRecord(rec[1], rec[2] if len(rec) > 2 else False)

    async def _record_to_value(self, ref: ObjectRef, record) -> Any:
        if isinstance(record, PlasmaRecord):
            data, pin = await self._fetch_plasma(ref, record)
            so = serialization.SerializedObject.from_buffer(data)
            return serialization.deserialize(so, pin_lease=pin)
        return self._inline_record_to_value(ref, record)

    async def _fetch_plasma(self, ref: ObjectRef, record: PlasmaRecord):
        """-> (buffer, pin | None): the flattened object bytes, zero-copy
        over the pinned store mapping when the agent granted a read pin."""
        if self.agent is None:
            return await self._driver_fetch_plasma(ref, record)
        return await self._agent_fetch_plasma(ref, record)

    async def _driver_fetch_plasma(self, ref: ObjectRef,
                                   record: PlasmaRecord):
        """Agent-less driver fetch (a driver not colocated with a node
        agent): pull the whole object over RPC, landing every chunk
        readinto-style into ONE preallocated buffer via ``call_into`` —
        the reply's out-of-band bytes drain from the stream buffer
        straight into their final resting place instead of accumulating a
        ``bytes`` per reply and paying a full extra copy per object.

        The location list may contain PARTIAL holders (they register
        after their first chunk; their uncovered ranges raise a typed
        ChunkNotAvailable) and can shrink (failed pulls deregister): try
        every location, skip the unusable, reject short replies (silent
        corruption otherwise)."""
        last: Optional[BaseException] = None
        from . import external_spill
        buf = bytearray(record.size)
        mv = memoryview(buf)
        chunk = max(1, get_config().object_transfer_chunk_bytes)
        for node_id, addr in list(record.locations):
            if external_spill.is_external_address(addr):
                try:
                    data = await asyncio.get_event_loop() \
                        .run_in_executor(None, external_spill.timed_read,
                                         addr)
                except Exception as e:  # noqa: BLE001 — try next
                    last = e
                    continue
                if len(data) != record.size:
                    last = ObjectLostError(
                        ref.id, f"external copy at {addr} has "
                                f"{len(data)} of {record.size} B")
                    continue
                return data, None
            client = self.agent_clients.get(addr)
            try:
                off = 0
                while off < record.size:
                    n = min(chunk, record.size - off)
                    got = await client.call_into(
                        "read_chunk", mv[off:off + n], object_id=ref.id,
                        offset=off, length=n)
                    landed = got.nbytes if isinstance(got, memoryview) \
                        else len(got)
                    if landed != n:
                        raise ObjectLostError(
                            ref.id, f"short read_chunk reply: {landed} of "
                                    f"{n} B at offset {off} from {addr}")
                    if not isinstance(got, memoryview):
                        mv[off:off + landed] = got  # small in-band reply
                    off += n
            except Exception as e:  # noqa: BLE001 — try next holder
                last = e
                continue
            return buf, None
        raise ObjectLostError(
            ref.id, f"no usable location for {ref.id}: {last}")

    async def _agent_fetch_plasma(self, ref: ObjectRef,
                                  record: PlasmaRecord):
        try:
            # idempotent retry: a pin GRANTED on an attempt whose reply was
            # lost must come back as the same grant (one ledger entry), not
            # a second pin nobody will ever release
            res = await self.agent.call_retry("fetch_object",
                                              object_id=ref.id,
                                              size=record.size,
                                              locations=record.locations,
                                              owner=ref.owner or self.address,
                                              pin=True,
                                              pinner=self.address)
            return await self._read_fetched(ref.id, res)
        except (RemoteError, ConnectionLost):
            return await self._try_reconstruct(ref, record)

    async def _read_fetched(self, object_id: ObjectID, res: dict):
        """Read a fetched object from the local store -> (buffer, pin|None).

        Pinned fast path (the plasma-client protocol): the agent pinned the
        object before replying, so the mapping cannot be evicted or its
        arena offset recycled under us — attach a ZERO-COPY readonly view
        and hand back a pin lease that the deserialized buffers release on
        GC.  Unpinned fallback: copy out, then re-validate with the agent
        (whose loop serializes with eviction) that the object still lives
        at that path; a recycled slot re-fetches instead of returning
        another object's bytes."""
        for _ in range(3):
            if res.get("pinned"):
                # Construct the pin guard BEFORE attaching: if view() fails
                # (pool unlinked across an agent restart, mmap error), the
                # agent-side pin must still be released or the object stays
                # unevictable forever.  On failure, fall through to the
                # copy+verify path.
                pin = _ReadPin(self, object_id)
                try:
                    view = self.shm_reader.view(res["path"], res["size"])
                except OSError:
                    pin.release()
                else:
                    # copy ledger: the pinned same-host get is the plane's
                    # declared ZERO-copy path (plasma-client contract)
                    object_explain.ledger_record(object_explain.KEY_GET,
                                                 res["size"])
                    return view, pin
            try:
                data = self.shm_reader.read(res["path"], res["size"])
            except OSError:
                # Stale path — e.g. the pool file was unlinked across an
                # agent restart.  The same OSError that broke view() above
                # breaks this read too; treat it like a failed verify and
                # refetch rather than leaking a raw FileNotFoundError.
                ok = False
            else:
                if "#" not in res["path"]:
                    object_explain.ledger_record(
                        object_explain.KEY_GET, res["size"])
                    return data, None  # file-backed: unlink keeps views safe
                ok = await self.agent.call_retry("store_verify",
                                                 object_id=object_id,
                                                 path=res["path"],
                                                 _idempotent=False)
            if ok:
                object_explain.ledger_record(object_explain.KEY_GET_COPY,
                                             res["size"])
                return data, None
            res = await self.agent.call_retry("fetch_object",
                                              object_id=object_id,
                                              size=res["size"], locations=[],
                                              pin=True,
                                              pinner=self.address)
        # Retries exhausted: the FINAL refetch above may have granted a pin
        # nothing will ever view — release it or the object (and the agent's
        # ledger entry) stays pinned until this whole process exits.
        if res.get("pinned"):
            self.release_read_pin(object_id)
        raise ObjectLostError(object_id)

    def release_read_pin(self, oid: ObjectID):
        """Fire-and-forget ``store_unpin_read`` to our agent (called from
        ``_ReadPin``, possibly on a GC/finalizer thread)."""
        if self._shutdown or self.agent is None:
            return
        try:
            loop = get_loop()
        except Exception:
            return

        async def _send():
            try:
                await self.agent.notify("store_unpin_read", object_id=oid,
                                        pinner=self.address)
            except Exception:
                pass

        try:
            asyncio.run_coroutine_threadsafe(_send(), loop)
        except Exception:
            pass

    async def _try_reconstruct(self, ref: ObjectRef, record: PlasmaRecord):
        """Lineage reconstruction (reference: object_recovery_manager.h:41)."""
        if not get_config().lineage_reconstruction_enabled:
            raise ObjectLostError(ref.id)
        if ref.owner not in ("", self.address):
            owner = self.worker_clients.get(ref.owner)
            # token'd retry: a reconstruct whose reply was lost must not
            # resubmit the producing task a second time
            ok = await owner.call_retry("reconstruct_object",
                                        object_id=ref.id)
            if not ok:
                raise ObjectLostError(ref.id)
            rec = await self._resolve_record(
                ObjectRef(ref.id, owner=ref.owner, _register=False), None)
            if isinstance(rec, PlasmaRecord):
                # owner= so the pull registers this node as a NEW location:
                # without it the owner's view omits post-reconstruction
                # holders and a later loss can't find the live copy
                res = await self.agent.call_retry(
                    "fetch_object", object_id=ref.id, size=rec.size,
                    locations=rec.locations, owner=ref.owner,
                    pin=True, pinner=self.address)
                return await self._read_fetched(ref.id, res)
            raise ObjectLostError(ref.id)
        spec = self.task_manager.lineage.get(ref.id.task_id())
        if spec is None:
            raise ObjectLostError(ref.id)
        self.memory_store.free(ref.id)
        resub = pickle.loads(pickle.dumps(spec))  # fresh copy
        resub.retry_count += 1
        # Re-register as pending so the re-run's results are stored (complete()
        # drops results for unknown tasks).
        self.task_manager.add_pending(resub, [])
        self._submit_spec(resub)
        rec = await self._resolve_record(
            ObjectRef(ref.id, owner=self.address, _register=False), None)
        if isinstance(rec, PlasmaRecord):
            res = await self.agent.call_retry(
                "fetch_object", object_id=ref.id, size=rec.size,
                locations=rec.locations, owner=self.address,
                pin=True, pinner=self.address)
            return await self._read_fetched(ref.id, res)
        if isinstance(rec, ErrorRecord):
            exc, tb = pickle.loads(rec.error)
            raise TaskError(exc, "reconstruction", tb)
        return rec, None  # inline flat bytes — caller deserializes

    # ------------------------------------------------------------------ wait

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        self._on_block()
        try:
            return run_async(self.wait_async(refs, num_returns, timeout))
        finally:
            self._on_unblock()

    async def wait_async(self, refs: List[ObjectRef], num_returns: int,
                         timeout: Optional[float]):
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        ready_set: set = set()
        deadline = None if timeout is None else time.monotonic() + timeout

        async def check_one(r: ObjectRef) -> bool:
            if self.memory_store.contains(r.id):
                return True
            if r.owner in ("", self.address):
                return False
            try:
                owner = self.worker_clients.get(r.owner)
                rec = await owner.call_retry("locate_object", object_id=r.id,
                                             timeout=0, _attempts=3,
                                             _idempotent=False)
                if rec is not None:
                    return True
            except Exception:
                return True  # owner dead => resolved (to an error) on get
            return False

        while True:
            for r in refs:
                if r not in ready_set and await check_one(r):
                    ready_set.add(r)
            if len(ready_set) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            await asyncio.sleep(0.005)
        ready = [r for r in refs if r in ready_set][:num_returns]
        ready_ids = set(ready)
        not_ready = [r for r in refs if r not in ready_ids]
        return ready, not_ready

    # ------------------------------------------------------------ submission

    def submit_task(self, spec: TaskSpec, arg_refs: List[ObjectRef]):
        """Fire-and-forget: bookkeeping happens on the calling thread (dict
        ops under the GIL), dispatch hops to the IO loop without waiting for
        it.  Blocking the caller on a cross-thread round trip per submission
        capped async task throughput at ~1k/s (reference: task submission is
        likewise a non-blocking enqueue, direct_task_transport.h:75).

        Returns a list of ObjectRefs, or an ObjectRefGenerator for
        ``num_returns="streaming"`` tasks."""
        self.admission_gate.acquire(self, spec)
        if spec.num_returns == STREAMING_RETURNS:
            self.streams[spec.task_id] = StreamState(
                spec.task_id, spec.generator_backpressure)
            ret = ObjectRefGenerator(self, spec.task_id)
        elif spec.num_returns == 1:
            # dominant case: one return — register against our own counter
            # directly (skips the per-ref global-worker lookup inside
            # _ref_created)
            r = ObjectRef(ObjectID.for_task_return(spec.task_id, 0),
                          self.address, _register=False)
            r._registered = True
            self.reference_counter.add_local_ref(r.id, r.owner)
            ret = [r]
        else:
            ret = [ObjectRef(oid, owner=self.address)
                   for oid in spec.return_ids()]
        self.task_manager.add_pending(spec, arg_refs, gated=True)
        self.task_event(spec, "SUBMITTED")
        self._enqueue_submit(("task", spec))
        return ret

    def _enqueue_submit(self, item: tuple):
        promote = False
        with self._submit_lock:
            self._submit_buffer.append(item)
            need_flush = not self._submit_flush_scheduled
            self._submit_flush_scheduled = True
            if (not need_flush and not self._submit_flush_promoted
                    and len(self._submit_buffer)
                    >= get_config().submit_flush_max):
                # An armed flush window already exists but the buffer hit
                # the size bound: promote to an immediate flush.
                promote = self._submit_flush_promoted = True
        if need_flush:
            get_loop().call_soon_threadsafe(self._arm_submit_flush)
        elif promote:
            get_loop().call_soon_threadsafe(self._flush_submits)

    def _arm_submit_flush(self):
        """On the IO loop: flush now, or arm the bounded flush window
        (``submit_flush_window_ms``) so a burst's stragglers coalesce into
        the same batch.  A window only ever delays by the configured bound;
        ``submit_flush_max`` promotes a full buffer to an immediate flush."""
        cfg = get_config()
        window = (cfg.submit_flush_window_ms
                  if cfg.submit_batching_enabled else 0.0)
        if window > 0 and len(self._submit_buffer) < cfg.submit_flush_max:
            self._submit_timer = asyncio.get_event_loop().call_later(
                window / 1000.0, self._flush_submits)
        else:
            self._flush_submits()

    def _flush_submits(self):
        timer, self._submit_timer = self._submit_timer, None
        if timer is not None:
            timer.cancel()  # no-op when we ARE the timer callback
        om = sched_explain.owner_metrics()
        t0 = time.perf_counter() if om is not None else 0.0
        with self._submit_lock:
            items = list(self._submit_buffer)
            self._submit_buffer.clear()
            self._submit_flush_scheduled = False
            self._submit_flush_promoted = False
        if not items:
            return  # a promoted flush raced the window timer's flush
        pools: Dict[int, LeasePool] = {}
        pumped_actors: Dict[str, ActorTarget] = {}
        for kind, *rest in items:
            if kind == "task":
                (spec,) = rest
                pool = self._pool_for(spec)
                pool.queue.append(spec)
                pools[id(pool)] = pool
            else:  # actor call
                actor_id, spec = rest
                tgt = self.actor_targets.setdefault(actor_id,
                                                    ActorTarget(actor_id))
                tgt.outbox.append(spec)
                pumped_actors[actor_id] = tgt
        for pool in pools.values():
            pool._pump()
        for actor_id, tgt in pumped_actors.items():
            if not tgt.pump_running:
                tgt.pump_running = True
                asyncio.ensure_future(self._actor_pump(actor_id, tgt))
        if om is not None:
            # flush-time attribution: routing + pump work this IO-loop
            # callback spent on the burst (serialization is separate —
            # raytpu_sched_owner_serialize_seconds)
            om["flush"].observe(time.perf_counter() - t0)

    def _pool_for(self, spec: TaskSpec) -> LeasePool:
        bundle = None
        strategy = spec.scheduling_strategy
        if isinstance(strategy, tuple) and strategy and strategy[0] == "_pg":
            bundle = (strategy[1], strategy[2])
            strategy = NodeAffinitySchedulingStrategy(strategy[3], soft=False)
        key = spec.scheduling_key() + ((bundle,) if bundle else ())
        pool = self.lease_pools.get(key)
        if pool is None:
            pool = LeasePool(self, key, spec.resources, strategy, bundle,
                             spec.runtime_env)
            self.lease_pools[key] = pool
        if pool.label is None:
            pool.label = spec.name
        return pool

    def _submit_spec(self, spec: TaskSpec):
        self._pool_for(spec).submit(spec)

    # -------------------------------------------------------------- actors

    def create_actor(self, spec: TaskSpec, get_if_exists: bool = False) -> str:
        return run_async(self._create_actor_async(spec, get_if_exists))

    async def _create_actor_async(self, spec: TaskSpec,
                                  get_if_exists: bool = False) -> str:
        # Exactly-once registration: the idempotency token dedups a retry
        # whose original reply was lost, so a flaky GCS link can never
        # register (and schedule) the same actor twice.
        aid = await self.gcs.call_retry("register_actor", spec=spec,
                                        get_if_exists=get_if_exists)
        self.actor_targets.setdefault(aid, ActorTarget(aid))
        return aid

    def submit_actor_task(self, actor_id: str, spec: TaskSpec,
                          arg_refs: List[ObjectRef]):
        """Fire-and-forget like submit_task: enqueue into the target's
        ordered outbox on the IO loop; the per-target pump batches and
        sends.  Streaming methods return an ObjectRefGenerator."""
        self.admission_gate.acquire(self, spec)
        if spec.num_returns == STREAMING_RETURNS:
            self.streams[spec.task_id] = StreamState(
                spec.task_id, spec.generator_backpressure)
            ret = ObjectRefGenerator(self, spec.task_id)
        elif spec.num_returns == 1:
            # dominant case: one return — register against our own counter
            # directly (skips the per-ref global-worker lookup inside
            # _ref_created)
            r = ObjectRef(ObjectID.for_task_return(spec.task_id, 0),
                          self.address, _register=False)
            r._registered = True
            self.reference_counter.add_local_ref(r.id, r.owner)
            ret = [r]
        else:
            ret = [ObjectRef(oid, owner=self.address)
                   for oid in spec.return_ids()]
        self.task_manager.add_pending(spec, arg_refs, gated=True)
        self.task_event(spec, "SUBMITTED")
        self._enqueue_submit(("actor", actor_id, spec))
        return ret

    async def _actor_pump(self, actor_id: str, tgt: ActorTarget):
        try:
            while tgt.outbox:
                batch: List[TaskSpec] = []
                cfg = get_config()
                limit = (cfg.actor_call_pipeline
                         if cfg.submit_batching_enabled else 1)
                # Intra-batch dependencies are safe: per-call results are
                # streamed back as they land (handle_actor_task_batch).
                while tgt.outbox and len(batch) < limit:
                    batch.append(tgt.outbox.popleft())
                await self._run_actor_batch(actor_id, tgt, batch)
        finally:
            tgt.pump_running = False
            if tgt.outbox:  # raced with a late enqueue during unwinding
                tgt.pump_running = True
                asyncio.ensure_future(self._actor_pump(actor_id, tgt))

    async def _resolve_actor(self, actor_id: str, timeout: float = 120.0) -> ActorTarget:
        tgt = self.actor_targets.setdefault(actor_id, ActorTarget(actor_id))
        if tgt.state == "ALIVE" and tgt.address:
            return tgt
        # Poll in SHORT long-poll chunks under one deadline: a single
        # timeout-length park on the shared GCS connection loses the whole
        # wait whenever any unrelated frame on that link dies (chaos drop,
        # GCS restart) — short chunks bound the loss to one chunk and the
        # loop absorbs transport faults until the deadline.
        deadline = time.monotonic() + timeout
        while True:
            step = min(10.0, max(0.5, deadline - time.monotonic()))
            try:
                info = await self.gcs.call_retry(
                    "wait_actor_alive", actor_id=actor_id, timeout=step,
                    _timeout=step + 10, _idempotent=False)
            except (ConnectionLost, ConnectionError, OSError,
                    asyncio.TimeoutError):
                info = {"state": "TIMEOUT"}  # transport fault: keep waiting
            if info is None or info.get("state") in ("DEAD",):
                # authoritative answer: unknown or dead
                tgt.state = "DEAD"
                raise ActorDiedError(
                    actor_id, f"actor {actor_id[:12]} is dead: "
                              f"{(info or {}).get('death_cause')}")
            if info.get("state") == "TIMEOUT":
                if time.monotonic() >= deadline:
                    raise ActorDiedError(
                        actor_id,
                        f"timed out resolving actor {actor_id[:12]}")
                await asyncio.sleep(0.2)
                continue
            tgt.address = info["address"]
            tgt.state = "ALIVE"
            return tgt

    async def _run_actor_batch(self, actor_id: str, tgt: ActorTarget,
                               specs: List[TaskSpec]):
        """Send a submission-ordered batch of calls in ONE RPC and complete
        each result.  The pump is the sole sender per target, so seq_nos and
        delivery order are preserved without a lock (reference:
        actor_scheduling_queue.h:40 sequencing)."""
        while specs:
            if tgt.state != "ALIVE" or not tgt.address:
                # the calls' dependency is the ACTOR itself — still being
                # placed or restarted; the typed reason makes a hung
                # handle call diagnosable (raytpu explain <actor id> then
                # shows the GCS-side placement trail)
                for s in specs:
                    self.pending_reason(s, PendingReason.WAITING_DEPS,
                                        actor=actor_id[:16])
            try:
                tgt = await self._resolve_actor(actor_id)
            except ActorDiedError as e:
                for s in specs:
                    self.task_manager.fail(s.task_id, e)
                return
            client = self.worker_clients.get(tgt.address)
            for s in specs:
                s.seq_no = tgt.seq = tgt.seq + 1
                self.task_event(s, "RUNNING")
            try:
                # Wire-encode through the spec template cache: the actor
                # METHOD descriptor (actor id, method name, options) interns
                # once per handle; each call ships args + ids.  Connect
                # first so the delivered-set tracks this connection.
                await client.ensure_connected()
                payloads = await self._encode_offloaded(client, specs)
                if (len(specs) == 1
                        and specs[0].num_returns != STREAMING_RETURNS):
                    # Single non-streaming call: token'd retry.  A reply
                    # lost to a transport fault replays the COMMITTED
                    # result from the worker's dedup window — the method
                    # runs exactly once and no actor-task retry budget is
                    # burned.  (Batches can't retry this way: their
                    # results stream as side-channel pushes that a dedup
                    # replay would not re-emit.)
                    results_list = [await client.call_retry(
                        "actor_task", spec=payloads[0],
                        _timeout=86400.0, _attempts=3)]
                else:
                    # Batch RPC even for one call when it streams: only the
                    # batch handler holds the writer yield frames ride on.
                    results_list = await client.call(
                        "actor_task_batch", specs=payloads,
                        _timeout=86400.0)
            except (RpcError, OSError) as e:
                from .chaos import ChaosFault
                from .rpc import TransientServerError
                if (isinstance(e, RemoteError)
                        and isinstance(e.cause, spec_cache.SpecCacheMiss)):
                    # The actor worker evicted a template we thought
                    # delivered; its decode raised before running anything.
                    # Resend with full templates on the next loop pass.
                    for s in specs:
                        self.pending_reason(
                            s, PendingReason.SPEC_CACHE_RESEND,
                            actor=actor_id[:16])
                    spec_cache.SpecEncoder.forget_client(client)
                    continue
                if (isinstance(e, RemoteError)
                        and not isinstance(e.cause, (ChaosFault,
                                                     TransientServerError))):
                    # app-level failure raised by the actor method
                    for s in specs:
                        self.task_manager.fail(s.task_id, e.cause,
                                               e.remote_traceback)
                    return
                # Transport-level failure — ConnectionLost, "client closed"
                # (pool entry force-closed under us), or a chaos-injected
                # fault (retryable by the harness contract, same
                # at-most-once budget as a lost connection).
                tgt.state = "RESTARTING"
                tgt.address = None
                try:
                    info = await self.gcs.call_retry("get_actor_info",
                                                     actor_id=actor_id,
                                                     _idempotent=False)
                except (ConnectionLost, ConnectionError, OSError,
                        asyncio.TimeoutError):
                    # GCS unreachable (blip/restart): don't let the pump
                    # die — treat as maybe-restarting and retry the batch
                    await asyncio.sleep(0.5)
                    continue
                if info is None or info["state"] == "DEAD":
                    cause = (info or {}).get("death_cause")
                    err = ActorDiedError(
                        actor_id,
                        f"actor {actor_id[:12]} died"
                        + (f": {cause}" if cause else ""))
                    for s in specs:
                        self.task_manager.fail(s.task_id, err)
                    return
                retry = []
                for s in specs:
                    rs = self.task_manager.use_retry(s.task_id)
                    if rs is not None:
                        retry.append(rs)
                    else:
                        self.task_manager.fail(
                            s.task_id,
                            ActorDiedError(
                                actor_id,
                                f"actor {actor_id[:12]} died while running "
                                f"{s.name} (set max_task_retries to retry)"))
                specs = retry
                if specs:
                    await asyncio.sleep(max(0.1, _task_retry_delay(
                        max(s.retry_count for s in specs))))
                continue
            for s, results in zip(specs, results_list):
                if results != "__streamed__":  # else completed via push
                    self.task_manager.complete(s.task_id, results)
            return

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        return run_async(self.gcs.call_retry("kill_actor", actor_id=actor_id,
                                             no_restart=no_restart))

    # ----------------------------------------------------------- ref counting

    def on_ref_count_zero(self, oid: ObjectID, owner: str):
        """All owner-side counts (local/submitted/borrowers) hit zero.

        The free happens immediately UNLESS an escrow hold is registered:
        when a producer serializes this ref into a task result, it places an
        acked hold with us BEFORE replying (``_package_returns``), and the
        consumer releases it AFTER registering its borrow
        (``register_contained_borrow``) — so the in-flight hand-off window is
        covered by explicit protocol, not a timing grace (the reference's
        WaitForRefRemoved bookkeeping, ``reference_count.cc``).  Hold expiry
        (``escrow_hold_expiry_s``) only bounds the leak when a consumer dies
        mid-handoff.
        """
        if self._shutdown:
            return
        try:
            loop = get_loop()
        except Exception:
            return
        if get_config().submit_plane_native_enabled:
            # Coalesced doorbell: run_coroutine_threadsafe costs a self-pipe
            # write (~40 µs of syscall on a busy loop) plus a Task per ref.
            # A drain burst of N ref deaths pays for ONE of each.
            with self._free_lock:
                self._free_buffer.append(oid)
                need_wake = not self._free_scheduled
                self._free_scheduled = True
            if need_wake:
                loop.call_soon_threadsafe(self._drain_frees)
            return
        asyncio.run_coroutine_threadsafe(self._free_owned(oid), loop)

    def _drain_frees(self):
        with self._free_lock:
            oids = self._free_buffer
            self._free_buffer = []
            self._free_scheduled = False
        if oids:
            asyncio.ensure_future(self._free_owned_many(oids))

    async def _free_owned_many(self, oids: list):
        for oid in oids:
            await self._free_owned(oid)

    async def handle_worker_killed(self, worker_id: str, address: str,
                                   cause: str):
        """Agent notification: a worker running OUR lease was deliberately
        killed (memory monitor).  Stash the typed cause and force-close our
        client to the dead worker so an in-flight push fails with
        ConnectionLost NOW — prompt typed-OOM delivery that does not
        depend on EOF timing (the lease-return death_cause remains the
        primary source; this is the backstop)."""
        self._kill_causes[worker_id] = cause
        while len(self._kill_causes) > 256:
            self._kill_causes.pop(next(iter(self._kill_causes)))
        try:
            await self.worker_clients.close(address)
        except Exception:
            pass
        return True

    async def handle_add_object_location(self, object_id: ObjectID,
                                         node_id: str, address: str):
        """A node finished pulling our object: record it as a source so later
        pullers fan out over all holders (tree-shaped broadcast; reference:
        ownership-based object directory location updates)."""
        rec = self.memory_store.get_if_exists(object_id)
        if isinstance(rec, PlasmaRecord):
            loc = (node_id, address)
            if loc not in rec.locations:
                rec.locations.append(loc)
        return True

    async def handle_remove_object_location(self, object_id: ObjectID,
                                            node_id: str, address: str):
        """A node dropped its (possibly partial) copy — e.g. a striped pull
        that registered after its first chunk then failed and freed the
        segment.  Without this, the append-only location list would forever
        route pullers at a holder with nothing to serve."""
        rec = self.memory_store.get_if_exists(object_id)
        if isinstance(rec, PlasmaRecord):
            loc = (node_id, address)
            if loc in rec.locations:
                rec.locations.remove(loc)
        return True

    async def handle_escrow_hold(self, object_id: ObjectID, hold_id: str):
        """A producer is about to ship a result containing our object: keep
        it alive until the consumer's release (or expiry)."""
        self._escrow_holds.setdefault(object_id, {})[hold_id] = (
            time.monotonic() + get_config().escrow_hold_expiry_s)
        return True

    def release_local_hold(self, object_id: ObjectID, hold_id: str):
        try:
            loop = get_loop()
        except Exception:
            return
        asyncio.run_coroutine_threadsafe(
            self.handle_escrow_release(object_id, hold_id), loop)

    async def handle_escrow_release(self, object_id: ObjectID, hold_id: str):
        holds = self._escrow_holds.get(object_id)
        if holds is not None:
            holds.pop(hold_id, None)
            if not holds:
                self._escrow_holds.pop(object_id, None)
        await self._free_owned(object_id)  # no-op while refs/holds remain

    def send_borrower_note(self, oid: ObjectID, owner: str, add: bool):
        """Borrower-side: tell the owner we hold / released a copy of its
        object.  ADD notes are acked calls tracked in _pending_notes so
        task execution can flush them before its results ship (see
        flush_borrower_notes); REMOVE notes stay fire-and-forget."""
        if self._shutdown:
            return
        try:
            loop = get_loop()
        except Exception:
            return

        async def _notify():
            try:
                if add:
                    # token'd retry: a double-applied ADD note would leave
                    # a phantom borrower that pins the object forever
                    await self.worker_clients.get(owner).call_retry(
                        "add_borrower_note", object_id=oid, _timeout=30.0)
                else:
                    await self.worker_clients.get(owner).notify(
                        "remove_borrower_note", object_id=oid)
            except Exception:
                pass

        fut = asyncio.run_coroutine_threadsafe(_notify(), loop)
        if add:
            self._pending_notes.add(fut)
            fut.add_done_callback(self._pending_notes.discard)

    def flush_borrower_notes(self, timeout: float = 10.0):
        """Block until every in-flight ADD borrower note is ACKED by its
        owner.  Called at the end of task execution, BEFORE results ship:
        the submitter releases its argument pins the moment it processes
        our results, so the owner must already know about any borrows this
        task registered — otherwise a ref kept by an actor/task could be
        freed in the note-vs-result race (reference: reference_count.cc
        WaitForRefRemoved ordering)."""
        import concurrent.futures
        pending = list(self._pending_notes)
        if pending:
            concurrent.futures.wait(pending, timeout=timeout)

    def register_contained_borrow(self, result_oid: ObjectID, cid: ObjectID,
                                  owner: str, hold_id: Optional[str] = None):
        """A task result we own contains a ref owned elsewhere: hold a borrow
        on it for as long as the result object itself is alive, then release
        the producer's escrow hold — ordered AFTER our borrower note on the
        same connection, so the owner always learns of the borrow before the
        hold drops."""
        self._contained_borrows.setdefault(result_oid, []).append((cid, owner))
        self.reference_counter.add_local_ref(cid, owner)
        if hold_id and owner and owner != self.address:
            try:
                loop = get_loop()
            except Exception:
                return

            async def _release():
                try:
                    await self.worker_clients.get(owner).notify(
                        "escrow_release", object_id=cid, hold_id=hold_id)
                except Exception:
                    pass  # expiry reclaims

            asyncio.run_coroutine_threadsafe(_release(), loop)

    async def _free_owned(self, oid: ObjectID):
        if self.reference_counter.has_any_ref(oid):
            return
        holds = self._escrow_holds.get(oid)
        if holds:
            now = time.monotonic()
            live = {h: d for h, d in holds.items() if d > now}
            if live:
                self._escrow_holds[oid] = live
                # consumer-death safety valve: retry at the earliest expiry
                delay = max(0.05, min(live.values()) - now)
                loop = asyncio.get_event_loop()
                loop.call_later(delay, lambda: asyncio.ensure_future(
                    self._free_owned(oid)))
                return
            self._escrow_holds.pop(oid, None)
        for cid, owner in self._contained_borrows.pop(oid, []):
            self.reference_counter.remove_local_ref(cid, owner)
        rec = self.memory_store.get_if_exists(oid)
        self.memory_store.free(oid)
        if rec is not None and not isinstance(rec, PlasmaRecord):
            # inline record: no store sees this free, stamp it here (the
            # plasma fan-out below is stamped by each store's own FREED)
            self.object_event(oid, ObjectEvent.FREED)
        if isinstance(rec, PlasmaRecord):
            from . import external_spill
            for node_id, addr in rec.locations:
                if external_spill.is_external_address(addr):
                    # external-tier copy: not an agent to RPC — the owner
                    # is its single deletion point (spilling nodes never
                    # delete it; they may already be gone)
                    try:
                        await asyncio.get_event_loop().run_in_executor(
                            None, external_spill.delete, addr)
                    except Exception:
                        pass
                    continue
                try:
                    await self.agent_clients.get(addr).call_retry(
                        "store_free", object_ids=[oid])
                except Exception:
                    pass

    def free(self, refs: List[ObjectRef]):
        async def _free():
            for r in refs:
                await self._free_owned(r.id)
        run_async(_free())

    # ----------------------------------------------------- blocked accounting

    def _on_block(self):
        """Called when user code blocks on get/wait inside a task — tells the
        agent to release the lease's resources so nested tasks can run
        (reference: raylet releases resources for blocked workers,
        ``local_task_manager.h``)."""
        if self.mode != "worker" or self.agent is None:
            return
        self._blocked_depth += 1
        if self._blocked_depth == 1:
            self._notify_agent("worker_blocked")

    def _on_unblock(self):
        if self.mode != "worker" or self.agent is None:
            return
        self._blocked_depth -= 1
        if self._blocked_depth == 0:
            self._notify_agent("worker_unblocked")

    def _notify_agent(self, method: str):
        wid = self.worker_id.hex()

        async def _send():
            try:
                await self.agent.notify(method, worker_id=wid)
            except Exception:
                pass

        try:
            asyncio.run_coroutine_threadsafe(_send(), get_loop())
        except Exception:
            pass

    # =========================================================== RPC handlers

    async def handle_dump_stacks(self) -> str:
        from ray_tpu_torch.util.debug import dump_all_stacks
        return dump_all_stacks()

    async def handle_profile(self, duration_s: float = 2.0,
                             out_dir: Optional[str] = None):
        """On-demand profiler capture (``raytpu profile``): torch.profiler
        when this process has initialised CUDA, thread-stack sampling
        to chrome-trace JSON otherwise.  The capture sleeps for the whole
        window, so it runs OFF the RPC loop."""
        from ray_tpu_torch.util import profiler
        loop = asyncio.get_event_loop()
        path, mode = await loop.run_in_executor(
            None, lambda: profiler.capture(
                duration_s, out_dir or os.path.join(session_root(), "profiles")))
        return {"path": path, "mode": mode,
                "process": f"worker-{self.worker_id.hex()[:12]}"}

    async def handle_chaos_update(self, spec: Optional[dict] = None):
        """Runtime chaos-spec propagation: the node agent forwards GCS
        chaos_set/chaos_clear broadcasts to every worker it manages."""
        from . import chaos
        chaos.install(spec)
        return True

    async def handle_ping(self):
        return "pong"

    async def handle_owned_object_count(self) -> int:
        """Number of live objects this process owns (idle-reap guard)."""
        return len(self.memory_store)

    async def handle_locate_object(self, object_id: ObjectID, timeout: float = 30.0):
        """Owner-side: return the record for an object, waiting for the producing
        task up to `timeout`. None => not ready yet."""
        if not self.memory_store.contains(object_id):
            ok = await self.memory_store.wait_ready(object_id,
                                                    timeout if timeout else 0.001)
            if not ok:
                return None
        rec = self.memory_store.get_if_exists(object_id)
        if isinstance(rec, PlasmaRecord):
            return ("plasma", rec.size, rec.locations)
        if isinstance(rec, ErrorRecord):
            return ("error", rec.error, rec.system)
        if (isinstance(rec, (bytes, bytearray)) and self.agent is not None
                and len(rec) > get_config().max_direct_call_object_size):
            # A result inlined under inline_result_max_bytes is being
            # borrowed cross-process and exceeds the direct-call size:
            # promote it to the shm store so borrowers ride the transfer
            # plane (chunked pulls, zero-copy same-host) instead of every
            # locate_object reply copying the payload.
            plas = await self._promote_inline(object_id, rec)
            if plas is not None:
                return ("plasma", plas.size, plas.locations)
            rec = self.memory_store.get_if_exists(object_id)
            if rec is None or isinstance(rec, PlasmaRecord):
                return None if rec is None else ("plasma", rec.size,
                                                 rec.locations)
        return ("inline", rec)

    async def _promote_inline(self, oid: ObjectID, data) -> Optional[PlasmaRecord]:
        """Spill one inlined result to the node's shm store (borrower
        appeared).  Deduped per object so concurrent borrowers share a
        single ``store_create``; ownership and refcounts do not move — the
        record simply becomes a PlasmaRecord whose free path is the
        standard ``store_free`` fan-out."""
        fut = self._promotions.get(oid)
        if fut is not None:
            return await asyncio.shield(fut)
        fut = asyncio.get_event_loop().create_future()
        self._promotions[oid] = fut
        rec: Optional[PlasmaRecord] = None
        try:
            try:
                res = await self.agent.call_retry("store_create",
                                                  object_id=oid,
                                                  size=len(data),
                                                  owner=self.address)
                # stamped before the seal notify so CREATED can never sort
                # after the agent's SEALED (see _store_serialized)
                object_explain.ledger_record(object_explain.KEY_PROMOTE,
                                             len(data))
                self.object_event(oid, ObjectEvent.CREATED, size=len(data),
                                  node=(self.node_id or "")[:12] or None,
                                  promoted=True)
                seg = ShmSegment(res["path"], len(data), create=False)
                try:
                    seg.view()[:len(data)] = data
                finally:
                    seg.close()
                await self.agent.notify("store_seal", object_id=oid)
            except Exception:
                fut.set_result(None)
                return None
            if not self.memory_store.contains(oid):
                # the last reference died mid-promotion: the inline record
                # is gone, so the shm copy must go too (nobody will free it)
                try:
                    await self.agent.call_retry("store_free",
                                                object_ids=[oid])
                except Exception:
                    pass
                fut.set_result(None)
                return None
            rec = PlasmaRecord(len(data),
                               [(self.node_id, self.agent_address)])
            self.memory_store.put(oid, rec)
            fut.set_result(rec)
            return rec
        finally:
            if not fut.done():
                fut.set_result(rec)
            self._promotions.pop(oid, None)

    async def handle_get_object(self, object_id: ObjectID):
        return await self.handle_locate_object(object_id, timeout=30.0)

    async def handle_reconstruct_object(self, object_id: ObjectID) -> bool:
        spec = self.task_manager.lineage.get(object_id.task_id())
        if spec is None:
            return False
        self.memory_store.free(object_id)
        resub = pickle.loads(pickle.dumps(spec))
        resub.retry_count += 1
        if resub.num_returns == STREAMING_RETURNS:
            live = self.streams.get(resub.task_id)
            if live is not None:
                # A consumer still holds this stream: keep its cursor and
                # let the replay overwrite unconsumed indexes (the task-retry
                # contract) — installing a replay state here would rewind the
                # consumer to index 0 and then vanish mid-iteration.
                live.reset_for_retry()
            else:
                # Consumer long gone; a fresh replay-mode StreamState so
                # _on_gen_yield re-stores every yield (only block refs live).
                st = StreamState(resub.task_id, resub.generator_backpressure)
                st.replay = True
                self.streams[resub.task_id] = st
        self.task_manager.add_pending(resub, [])
        self._submit_spec(resub)
        return True

    async def handle_remove_borrower_note(self, object_id: ObjectID):
        # Owner-side escrow: apply the removal only after the grace window, so
        # a ref the borrower *forwarded* (task result / actor reply) has time
        # to be re-registered by the receiver's add note.  Processing the
        # delay here (not at the sender) means a borrower exiting right after
        # sending cannot lose the note.
        await asyncio.sleep(get_config().ref_escrow_grace_s)
        self.reference_counter.remove_borrower(object_id)

    async def handle_add_borrower_note(self, object_id: ObjectID):
        self.reference_counter.add_borrower(object_id)

    # -- execution (worker mode) ------------------------------------------

    async def handle_push_task(self, spec):
        spec = spec_cache.decode(spec)
        fut = asyncio.get_event_loop().create_future()
        self.exec_queue.put(("task", spec, fut, asyncio.get_event_loop()))
        return await fut

    def register_gen_emitter(self, spec: TaskSpec, writer, loop):
        """Executor side: wire a streaming task to the live batch connection
        before it runs (called from the batch RPC handlers, on the IO loop)."""
        if spec.num_returns == STREAMING_RETURNS and writer is not None:
            self._gen_emitters[spec.task_id] = _GenEmitter(writer, loop)

    async def handle_generator_ack(self, task_id: TaskID, consumed: int):
        """Backpressure credit from the consuming owner (one-way notify)."""
        em = self._gen_emitters.get(task_id)
        if em is not None:
            em.ack(consumed)

    def _make_result_streamer(self, writer, task_id: TaskID):
        """Done-callback that pushes one task's results to the submitter the
        moment it finishes (req_id -1 frame on the batch connection).  This
        is what makes batching deadlock-free: a consumer later in the batch
        (or holding the producer's ref indirectly) can resolve it at the
        owner without waiting for the whole batch to reply.

        Results completing in the same loop tick COALESCE into one
        ``task_result_batch`` push frame (one pickle + one frame per tick
        instead of per task) — the per-result frame overhead was one of
        the measured owner/worker-loop ceilings on big drains."""
        from .rpc import _encode, coalesced_write

        def _flush():
            buf = getattr(writer, "_raytpu_result_buf", None)
            writer._raytpu_result_buf = None
            if not buf:
                return
            try:
                # Same coalescing as the reply path: every frame on this
                # writer must queue through coalesced_write or interleaved
                # direct writes would reorder against buffered ones.
                coalesced_write(writer, _encode(
                    (-1, "task_result_batch", {"results": buf})))
            except Exception:
                pass  # connection gone: the batch reply path handles it

        def _cb(fut):
            # A streaming task that failed before its generator body ran
            # never reaches _run_generator's finally: drop its emitter here
            # (the one chokepoint every batch-dispatched task passes).
            self._gen_emitters.pop(task_id, None)
            try:
                results = fut.result()
            except Exception:
                return
            if not get_config().completion_batching_enabled:
                # A/B off arm: one push frame per result, as before
                try:
                    coalesced_write(writer, _encode(
                        (-1, "task_result",
                         {"task_id": task_id, "results": results})))
                except Exception:
                    pass
                return
            buf = getattr(writer, "_raytpu_result_buf", None)
            if buf is None:
                buf = writer._raytpu_result_buf = []
                try:
                    asyncio.get_event_loop().call_soon(_flush)
                except RuntimeError:
                    writer._raytpu_result_buf = None
                    try:
                        coalesced_write(writer, _encode(
                            (-1, "task_result",
                             {"task_id": task_id, "results": results})))
                    except Exception:
                        pass
                    return
            buf.append((task_id, results))

        return _cb

    def _on_peer_push_routed(self, topic: str, payload: dict):
        """Push-handler shim for laned connections: completion bookkeeping
        (task manager, memory store, streams) is lane-0-confined state, so
        pushes arriving on a submission lane's read loop hop home first.
        call_soon_threadsafe is FIFO per calling thread, and a connection
        lives wholly on one lane — per-connection ordering (yield index
        order, yields-before-final-result) is preserved."""
        loop0 = get_loop()
        try:
            on_home = asyncio.get_running_loop() is loop0
        except RuntimeError:
            on_home = False
        if on_home:
            self._on_peer_push(topic, payload)
        else:
            loop0.call_soon_threadsafe(self._on_peer_push, topic, payload)

    def _on_peer_push(self, topic: str, payload: dict):
        if topic == "task_result":
            self.task_manager.complete(payload["task_id"],
                                       payload["results"])
        elif topic == "task_result_batch":
            # one admission-gate release for the whole batch (the gate's
            # lock/notify per completion was measurable at drain rates)
            self.task_manager.complete_many(payload["results"])
        elif topic == "gen_yield":
            self._on_gen_yield(payload["task_id"], payload["index"],
                               payload["result"], payload["worker"])

    def _on_gen_yield(self, task_id: TaskID, index: int, res: tuple,
                      worker_addr: str):
        """Owner side: one yield arrived from a running streaming task.
        Yields arrive in index order on the TCP stream (and before the final
        task_result frame)."""
        st = self.streams.get(task_id)
        if st is None or st.abandoned:
            return  # generator dropped: let the value die with the producer
        oid = ObjectID.for_task_return(task_id, index)
        self.store_task_result(oid, res)
        self.task_manager.register_result_borrows(oid, res)
        if res[0] == "plasma":
            st.any_plasma = True
        st.worker_addr = worker_addr
        st.available = index + 1
        if st.backpressure and worker_addr and index < st.next_read:
            # Replay of an already-consumed index (task retry): the consumer
            # won't call next() until production passes its cursor, so ack
            # proactively — otherwise the fresh producer parks at the
            # backpressure window with nobody left to drain it.
            try:
                client = self.worker_clients.get(worker_addr)
                asyncio.ensure_future(client.notify(
                    "generator_ack", task_id=task_id,
                    consumed=st.next_read))
            except Exception:
                pass
        st.signal()

    async def handle_push_task_batch(self, specs: List[TaskSpec],
                                     _writer=None):
        """Batched push: N tasks in one RPC, executed in submission order on
        the main thread, each result STREAMED back as it lands, one final
        reply as the completion barrier (reference counterpart:
        direct_task_transport.h:151 pipelining)."""
        # Template decode is all-or-nothing: a SpecCacheMiss raises BEFORE
        # any task is queued, so the sender's resend re-runs nothing.
        specs = spec_cache.decode_many(specs)
        loop = asyncio.get_event_loop()
        futs = []
        for spec in specs:
            fut = loop.create_future()
            if _writer is not None:
                fut.add_done_callback(
                    self._make_result_streamer(_writer, spec.task_id))
            self.register_gen_emitter(spec, _writer, loop)
            self.exec_queue.put(("task", spec, fut, loop))
            futs.append(fut)
        results = await asyncio.gather(*futs)
        if _writer is not None:
            # Results already streamed (and processed in-order before this
            # reply); don't pickle them all a second time.
            return ["__streamed__"] * len(results)
        return results

    handle_push_task_batch.rpc_pass_writer = True

    async def handle_actor_task_batch(self, specs: List[TaskSpec],
                                      _writer=None):
        """Batched ordered actor calls with the same per-call result
        streaming.  Async actors overlap the whole batch on their private
        loop; threaded actors keep per-call dispatch so the batch doesn't
        defeat max_concurrency."""
        specs = spec_cache.decode_many(specs)  # raises before any dispatch
        loop = asyncio.get_event_loop()
        futs = []
        for spec in specs:
            self.register_gen_emitter(spec, _writer, loop)
            if self.actor_spec is not None and self.actor_spec.is_async_actor:
                fut = asyncio.ensure_future(self._run_async_actor_task(spec))
            else:
                fut = loop.create_future()
                self.exec_queue.put(("task", spec, fut, loop))
            if _writer is not None:
                fut.add_done_callback(
                    self._make_result_streamer(_writer, spec.task_id))
            futs.append(fut)
        results = list(await asyncio.gather(*futs))
        if _writer is not None:
            return ["__streamed__"] * len(results)
        return results

    handle_actor_task_batch.rpc_pass_writer = True

    async def handle_create_actor(self, spec: TaskSpec):
        fut = asyncio.get_event_loop().create_future()
        self.exec_queue.put(("create_actor", spec, fut, asyncio.get_event_loop()))
        return await fut

    async def handle_actor_task(self, spec):
        spec = spec_cache.decode(spec)
        if self.actor_spec is not None and self.actor_spec.is_async_actor:
            return await self._run_async_actor_task(spec)
        fut = asyncio.get_event_loop().create_future()
        self.exec_queue.put(("task", spec, fut, asyncio.get_event_loop()))
        return await fut

    async def handle_exit_worker(self):
        self.exec_queue.put(("exit", None, None, None))
        return True

    # -- executor loop (runs on the worker's MAIN thread) ------------------

    def run_executor_loop(self):
        """Main loop of a worker process: execute tasks from the queue.

        Runs user code on the main thread so torch/CUDA state is thread-stable.
        Threaded actors (max_concurrency>1) fan out to a bounded pool
        (reference: BoundedExecutor, thread_pool.h:36).
        """
        while not self._shutdown:
            try:
                item = self.exec_queue.get(timeout=0.5)
            except _queue.Empty:
                continue
            kind, spec, fut, loop = item
            if kind == "exit":
                break
            if (kind == "task" and self.actor_instance is not None
                    and self.actor_spec.max_concurrency > 1):
                self._actor_threadpool.submit(self._execute_and_reply, spec, fut, loop)
            else:
                self._execute_and_reply(spec, fut, loop)

    def _execute_one(self, spec: TaskSpec) -> List[tuple]:
        try:
            if spec.is_actor_creation:
                return self._execute_actor_creation(spec)
            return self._execute_task(spec)
        except BaseException as e:  # noqa: BLE001
            from .actor import ActorExitRequest
            if isinstance(e, ActorExitRequest) and spec.is_actor_task:
                # exit_actor(): intended termination — pre-report the
                # expected death (GCS marks DEAD, no restart burn), answer
                # the in-flight call with a typed intended-exit error, and
                # leave the process once the reply flushes.
                self._begin_intended_exit(spec)
                err = ActorDiedError(
                    spec.actor_id.hex(),
                    f"actor {spec.actor_id.hex()[:12]} exited via "
                    "exit_actor() (intended)")
                return [("error", pickle.dumps((err, "")), True)
                        for _ in range(max(1, spec.num_returns))]
            tb = traceback.format_exc()
            return [("error", pickle.dumps((_strip_exc(e), tb)))
                    for _ in range(max(1, spec.num_returns))]

    def _begin_intended_exit(self, spec: TaskSpec):
        # Mark the exit intended at BOTH authorities: the agent flag makes
        # the process-exit backstop report expected=True (so a lost GCS
        # report cannot burn a restart), the direct GCS report makes the
        # death visible before the process is even gone.
        try:
            run_async(self.agent.call_retry("worker_intended_exit",
                                            worker_id=self.worker_id.hex(),
                                            _timeout=4), timeout=5)
        except Exception:
            pass
        try:
            run_async(self.gcs.call_retry(
                "report_actor_death", actor_id=spec.actor_id.hex(),
                reason="exit_actor() (intended)", expected=True,
                _timeout=8), timeout=10)
        except Exception:
            pass
        # Exit AFTER the typed reply has had time to flush.  Timers must be
        # armed from the loop thread (call_later off-thread races the
        # selector); 2s covers a loaded box's coalesced-write backlog, and
        # a dropped reply still surfaces typed via the caller's
        # ConnectionLost -> GCS death_cause fallback.
        loop = get_loop()
        loop.call_soon_threadsafe(lambda: loop.call_later(2.0, os._exit, 0))

    def _execute_and_reply(self, spec: TaskSpec, fut, loop):
        results = self._execute_one(spec)
        if get_config().submit_plane_native_enabled:
            # Coalesced reply doorbell: a burst of completions wakes the
            # worker's IO loop once, not once per task (each
            # call_soon_threadsafe costs a self-pipe write).
            with self._reply_lock:
                self._reply_buffer.append((fut, results))
                need_wake = not self._reply_scheduled
                self._reply_scheduled = True
            if need_wake:
                loop.call_soon_threadsafe(self._drain_replies)
            return
        loop.call_soon_threadsafe(
            lambda: fut.set_result(results) if not fut.done() else None)

    def _drain_replies(self):
        with self._reply_lock:
            pairs = self._reply_buffer
            self._reply_buffer = []
            self._reply_scheduled = False
        for fut, results in pairs:
            if not fut.done():
                fut.set_result(results)

    def _load_function(self, fn_id: bytes, job_id=None):
        if job_id is not None:
            # Materialize the job's runtime env (py_modules on sys.path, env
            # vars) BEFORE the function runs — unconditionally, not on cache
            # miss: fn_id is a content hash shared across jobs, so job B's
            # env must apply even when job A already cached the function.
            # ensure() is a set lookup after the first success.  Failures
            # FAIL the task (it would otherwise run with a missing env and
            # die with an unrelated-looking ImportError); the next attempt
            # retries materialization.
            from . import runtime_env
            try:
                runtime_env.ensure(self, job_id.hex())
            except Exception as e:
                raise RuntimeError(
                    f"runtime env materialization failed for job "
                    f"{job_id.hex()[:12]}: {e!r}") from e
        fn = self.fn_cache.get(fn_id)
        if fn is None:
            blob = run_async(self.gcs.call_retry(
                "kv_get", ns="funcs", key=fn_id.hex(), _idempotent=False))
            if blob is None:
                raise RuntimeError(f"function {fn_id.hex()[:12]} not found in registry")
            fn = serialization.loads_function(blob)
            self.fn_cache[fn_id] = fn
        return fn

    def _resolve_args(self, spec: TaskSpec,
                      stages: Optional[Dict[str, list]] = None):
        global _EMPTY_ARGS_BLOB
        if _EMPTY_ARGS_BLOB is None:
            from .remote_function import serialize_args
            _EMPTY_ARGS_BLOB = serialize_args((), {})[0]
        if spec.args == _EMPTY_ARGS_BLOB:  # canonical empty blob
            if stages is not None:
                now = time.time()
                stages["arg_deser"] = [now, now]
                stages["dep_fetch"] = [now, now]
            return [], {}
        t0 = time.time()
        so = serialization.SerializedObject.from_buffer(spec.args)
        args, kwargs = serialization.deserialize(so)
        t1 = time.time()

        def resolve(x):
            if isinstance(x, _TopLevelRef):
                return self.get(x.ref)
            return x

        out = ([resolve(a) for a in args],
               {k: resolve(v) for k, v in kwargs.items()})
        if stages is not None:
            stages["arg_deser"] = [t0, t1]
            stages["dep_fetch"] = [t1, time.time()]
        return out

    def _execute_task(self, spec: TaskSpec):
        if spec.is_actor_task:
            if self.actor_instance is None:
                raise RuntimeError("actor task on a non-actor worker")
            method = getattr(self.actor_instance, spec.actor_method)
            fn = method
        else:
            fn = self._load_function(spec.fn_id, spec.job_id)
        stages: Dict[str, list] = {}
        args, kwargs = self._resolve_args(spec, stages)
        ctx = {"task_id": spec.task_id, "job_id": spec.job_id,
               "actor_id": spec.actor_id, "name": spec.name}
        if spec.resources:
            # actor METHOD specs carry no resources — leaving the key out
            # lets get_assigned_resources fall through to the actor's
            # creation spec instead of reporting a bogus default
            ctx["resources"] = dict(spec.resources)
        token = _task_context.set(ctx)
        # Execution joins the submitter's trace: spans opened by the task and
        # any remote calls it makes chain under the task's span id.
        trace_id = (spec.trace_ctx[0] if spec.trace_ctx
                    else spec.task_id.hex()[:12])
        trace_token = _tracing.set_context((trace_id,
                                            spec.task_id.hex()[:12]))
        t_exec = time.time()
        try:
            out = fn(*args, **kwargs)
        finally:
            _tracing.reset_context(trace_token)
            _task_context.reset(token)
        t_put = time.time()
        stages["execute"] = [t_exec, t_put]
        results = self._package_returns(spec, out)
        stages["result_put"] = [t_put, time.time()]
        # Borrow notes for refs this task deserialized (and may retain, e.g.
        # actor state) must be ACKED before the results ship — the submitter
        # drops its argument pins as soon as it processes them.
        self.flush_borrower_notes()
        self._record_stages(spec, stages)
        return results

    def _package_returns(self, spec: TaskSpec, out) -> List[tuple]:
        if spec.num_returns == STREAMING_RETURNS:
            return self._run_generator(spec, out)
        n = spec.num_returns
        values = [out] if n == 1 else list(out) if n > 1 else []
        if n > 1 and len(values) != n:
            raise ValueError(f"task {spec.name} declared num_returns={n} but "
                             f"returned {len(values)} values")
        limit = get_config().inline_result_max_bytes
        return [self._package_one(spec, v, i, limit)
                for i, v in enumerate(values)]

    def _package_one(self, spec: TaskSpec, v, index: int,
                     inline_limit: Optional[int] = None) -> tuple:
        """Package one return/yield value as a result descriptor tuple.

        ``inline_limit`` is the result-inlining threshold: task/actor
        returns use ``inline_result_max_bytes`` (values at or under it ride
        back inside the reply frame — no ``store_create``, no caller-side
        fetch), while streaming-generator yields pass the plain
        ``max_direct_call_object_size`` so the yield pipeline bypasses the
        result-inlining knob unchanged."""
        cfg = get_config()
        if inline_limit is None:
            inline_limit = cfg.max_direct_call_object_size
        if v is None and inline_limit > 0:
            # ubiquitous for side-effect calls: skip the pickler
            return ("inline", serialization.none_bytes(), [])
        if cfg.zero_copy_put_enabled and self.agent is not None:
            bounds = serialization.estimate_flat_size(v)
            # floor comparison: an at-threshold value must still inline
            # (the reservation estimate is an upper bound)
            if bounds is not None and bounds[1] > max(
                    inline_limit, cfg.max_direct_call_object_size):
                desc = self._zero_copy_result(spec, v, index, bounds[0])
                if desc is not None:
                    return desc
        so = serialization.serialize(v)
        contained = self._escrow_contained(so.contained_refs)
        size = so.flat_size()
        if size <= inline_limit or self.agent is None:
            return ("inline", so.to_bytes(), contained)
        oid = ObjectID.for_task_return(spec.task_id, index)
        res = run_async(self.agent.call_retry("store_create", object_id=oid,
                                              size=size,
                                              owner=spec.owner or None))
        # A task result landing in plasma is the same serialize-into-arena
        # 1-copy write as a put — it must account the same ledger path and
        # stamp CREATED, or result-heavy workloads (the common case)
        # vanish from the copy-amplification gauge.
        object_explain.ledger_record(object_explain.KEY_PUT, size)
        self.object_event(oid, ObjectEvent.CREATED, size=size,
                          node=(self.node_id or "")[:12] or None,
                          task=spec.task_id.hex()[:16])
        seg = ShmSegment(res["path"], size, create=False)
        try:
            so.write_into(seg.view())
        finally:
            seg.close()
        run_async(self.agent.notify("store_seal", object_id=oid))
        return ("plasma", size,
                [(self.node_id, self.agent_address)], contained)

    def _escrow_contained(self, contained_refs) -> list:
        """Ship descriptors of any ObjectRefs inside a result value so the
        caller can register its borrows at receipt (see
        TaskManager.complete).  For refs owned ELSEWHERE, place an ACKED
        escrow hold with the owner before the result ships: our own
        counts may hit zero right after the reply, and the hold keeps the
        object alive until the consumer registers its borrow and releases
        (no timing window; reference: reference_count.cc
        WaitForRefRemoved)."""
        contained = []
        for r in contained_refs:
            r_owner = r.owner or self.address
            hold_id = f"{self.worker_id.hex()[:12]}:{next(self._hold_seq)}"
            if r_owner == self.address:
                # We own it: hold locally — our last local ref may die
                # the moment this function returns, and the consumer's
                # borrow note is still in flight.
                self._escrow_holds.setdefault(r.id, {})[hold_id] = (
                    time.monotonic()
                    + get_config().escrow_hold_expiry_s)
            else:
                try:
                    run_async(self.worker_clients.get(r_owner).call_retry(
                        "escrow_hold", object_id=r.id, hold_id=hold_id))
                except Exception:
                    hold_id = None  # owner gone: nothing to protect
            contained.append((r.id.binary(), r_owner, hold_id))
        return contained

    def _zero_copy_result(self, spec: TaskSpec, v, index: int,
                          est: int) -> Optional[tuple]:
        """Reserve-then-write landing of one large task result — the same
        zero-copy put pipeline as ``_try_zero_copy_put``, executor-side
        (sync thread, RPCs via run_async).  Returns the plasma descriptor,
        or None on a size-estimate miss (the reservation is released and
        the caller falls back to the classic serialize-then-copy path)."""
        oid = ObjectID.for_task_return(spec.task_id, index)
        res = run_async(self.agent.call_retry("store_create", object_id=oid,
                                              size=est,
                                              owner=spec.owner or None))
        seg = ShmSegment(res["path"], est, create=False)
        try:
            landed = serialization.serialize_into(v, seg.view())
        finally:
            seg.close()
        if landed is None:
            try:
                run_async(self.agent.call_retry("store_free",
                                                object_ids=[oid]))
            except Exception:
                pass
            return None
        contained = self._escrow_contained(landed.contained_refs)
        object_explain.ledger_record(object_explain.KEY_PUT_ZC, landed.used)
        self.object_event(oid, ObjectEvent.CREATED, size=landed.used,
                          node=(self.node_id or "")[:12] or None,
                          task=spec.task_id.hex()[:16], zero_copy=True)
        # seal-truncate to the exact bytes written (see _try_zero_copy_put)
        run_async(self.agent.notify("store_seal", object_id=oid,
                                    size=landed.used))
        return ("plasma", landed.used,
                [(self.node_id, self.agent_address)], contained)

    def _run_generator(self, spec: TaskSpec, out) -> List[tuple]:
        """Drive a streaming task's generator body: package each yield and
        ship it immediately through the batch connection's push channel
        (reference: _raylet.pyx:267 streaming generator protocol).

        Runs on the executor thread.  With no emitter (a dispatch path that
        has no live writer, e.g. spillback push), yields buffer and ship in
        the final reply instead — correct, just not streaming."""
        emitter = self._gen_emitters.get(spec.task_id)
        buffered: List[tuple] = []
        n = 0
        try:
            for v in iter(out) if not hasattr(out, "__next__") else out:
                res = self._package_one(spec, v, n)
                # Borrow notes for refs inside this yield must be acked
                # before it ships (same invariant as whole-task results).
                self.flush_borrower_notes()
                if emitter is not None:
                    emitter.wait_capacity(spec.generator_backpressure)
                    emitter.send(spec.task_id, n, res, self.address)
                else:
                    buffered.append(res)
                n += 1
        finally:
            self._gen_emitters.pop(spec.task_id, None)
        if emitter is None:
            return [("gen_buffered", buffered)]
        return [("gen_done", n)]

    async def _run_generator_async(self, spec: TaskSpec, gen) -> List[tuple]:
        """Async-actor variant of _run_generator: drives an async OR sync
        generator on the actor's private loop (Serve token streaming runs
        through here).  Sync generators still execute their body inline, but
        the backpressure wait is awaitable so only this task parks."""
        emitter = self._gen_emitters.get(spec.task_id)
        buffered: List[tuple] = []
        n = 0

        async def _aiter(g):
            if hasattr(g, "__anext__"):
                async for v in g:
                    yield v
            else:
                for v in iter(g):
                    yield v
                    await asyncio.sleep(0)  # keep the actor loop responsive

        try:
            async for v in _aiter(gen):
                res = self._package_one(spec, v, n)
                self.flush_borrower_notes()
                if emitter is not None:
                    await emitter.wait_capacity_async(spec.generator_backpressure)
                    emitter.send(spec.task_id, n, res, self.address)
                else:
                    buffered.append(res)
                n += 1
        finally:
            self._gen_emitters.pop(spec.task_id, None)
        if emitter is None:
            return [("gen_buffered", buffered)]
        return [("gen_done", n)]

    def _execute_actor_creation(self, spec: TaskSpec):
        cls = self._load_function(spec.fn_id, spec.job_id)
        args, kwargs = self._resolve_args(spec)
        ctx = {"task_id": spec.task_id, "job_id": spec.job_id,
               "actor_id": spec.actor_id, "name": spec.name}
        if spec.resources:
            # actor METHOD specs carry no resources — leaving the key out
            # lets get_assigned_resources fall through to the actor's
            # creation spec instead of reporting a bogus default
            ctx["resources"] = dict(spec.resources)
        token = _task_context.set(ctx)
        try:
            self.actor_instance = cls(*args, **kwargs)
        finally:
            _task_context.reset(token)
        self.actor_spec = spec
        if spec.max_concurrency > 1 and not spec.is_async_actor:
            from concurrent.futures import ThreadPoolExecutor
            self._actor_threadpool = ThreadPoolExecutor(spec.max_concurrency)
        if spec.is_async_actor:
            self._actor_async_loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._actor_async_loop.run_forever,
                                 name="actor-async", daemon=True)
            t.start()
        return [("inline", serialization.dumps(None))]

    async def _run_async_actor_task(self, spec: TaskSpec):
        """Async actors: run the coroutine on the actor's private loop with up to
        max_concurrency concurrent tasks (reference: fiber/asyncio actors).

        Arg resolution and result packaging must happen on the actor loop's
        thread too — they block on IO-loop round-trips (run_async), which would
        deadlock if done here on the IO loop thread itself."""

        async def runner():
            # getattr inside the per-spec error scope: a missing method must
            # fail only ITS call, not every call batched with it.
            method = getattr(self.actor_instance, spec.actor_method)
            stages: Dict[str, list] = {}
            args, kwargs = self._resolve_args(spec, stages)
            # Async actor methods join the submitter's trace exactly like
            # sync task execution (_execute_task): spans opened inside the
            # method — a serve replica's batch_wait/prefill/decode stamps —
            # chain under this task's span id, keeping a proxied request
            # ONE connected trace across processes.
            trace_id = (spec.trace_ctx[0] if spec.trace_ctx
                        else spec.task_id.hex()[:12])
            trace_token = _tracing.set_context((trace_id,
                                                spec.task_id.hex()[:12]))
            try:
                t_exec = time.time()
                res = method(*args, **kwargs)
                if asyncio.iscoroutine(res):
                    res = await res
                if spec.num_returns == STREAMING_RETURNS:
                    # Sync generators route through the async driver too —
                    # its backpressure wait is awaitable, so a slow consumer
                    # parks only this task, not the actor's whole event loop.
                    return await self._run_generator_async(spec, res)
                t_put = time.time()
                stages["execute"] = [t_exec, t_put]
                results = self._package_returns(spec, res)
            finally:
                _tracing.reset_context(trace_token)
            stages["result_put"] = [t_put, time.time()]
            self.flush_borrower_notes()  # see _execute_task
            self._record_stages(spec, stages)
            return results

        cfut = asyncio.run_coroutine_threadsafe(runner(), self._actor_async_loop)
        try:
            return await asyncio.wrap_future(cfut)
        except BaseException as e:  # noqa: BLE001
            tb = traceback.format_exc()
            return [("error", pickle.dumps((_strip_exc(e), tb)))
                    for _ in range(max(1, spec.num_returns))]


class _GenEmitter:
    """Executor-side channel for one RUNNING streaming task.

    ``send`` hops yield frames onto the IO loop for the owner's batch
    connection (same req_id -1 push channel as per-task result streaming, so
    yields and the final task_result frame share the TCP stream's ordering).
    ``wait_capacity``/``ack`` implement consumer-driven backpressure: the
    executor thread parks once `produced - consumed` hits the spec's limit and
    the owner's generator_ack notifies it forward."""

    #: give up waiting for acks after this long (owner died / dropped the
    #: generator mid-stream) — proceeding just buffers, it can't corrupt.
    STALL_TIMEOUT_S = 600.0

    def __init__(self, writer, loop):
        self._writer = writer
        self._loop = loop
        self._produced = 0
        self._consumed = 0
        self._cond = threading.Condition()

    def send(self, task_id: TaskID, index: int, res: tuple, worker_addr: str):
        from .rpc import _encode, coalesced_write
        frame = _encode((-1, "gen_yield", {
            "task_id": task_id, "index": index, "result": res,
            "worker": worker_addr}))

        def _write():
            try:
                coalesced_write(self._writer, frame)
            except Exception:
                pass  # connection gone: the batch reply path handles it

        self._loop.call_soon_threadsafe(_write)
        with self._cond:
            self._produced = index + 1

    def ack(self, consumed: int):
        with self._cond:
            self._consumed = max(self._consumed, consumed)
            self._cond.notify_all()

    def wait_capacity(self, backpressure: int):
        if not backpressure:
            return
        deadline = time.monotonic() + self.STALL_TIMEOUT_S
        with self._cond:
            while (self._produced - self._consumed >= backpressure
                   and time.monotonic() < deadline):
                self._cond.wait(timeout=1.0)

    async def wait_capacity_async(self, backpressure: int):
        """Async-actor variant: park in a thread so the actor loop stays live."""
        if not backpressure:
            return
        if self._produced - self._consumed < backpressure:
            return
        await asyncio.get_event_loop().run_in_executor(
            None, self.wait_capacity, backpressure)


def _strip_exc(e: BaseException) -> BaseException:
    """Make an exception picklable by dropping unpicklable attributes."""
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")
