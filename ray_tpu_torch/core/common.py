"""Common wire types: TaskSpec, resource sets, scheduling strategies, errors.

TaskSpec mirrors the reference's ``TaskSpecification``
(``src/ray/common/task/task_spec.h`` / ``src/ray/protobuf/common.proto``): one message
covers normal tasks, actor-creation tasks, and actor method calls.  Functions travel by
content hash through the GCS function registry (reference:
``python/ray/_private/function_manager.py`` — ships pickled defs via GCS KV; workers
lazy-import), so the spec itself stays small.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID


# ---------------------------------------------------------------------------
# Scheduling strategies (reference: python/ray/util/scheduling_strategies.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeAffinitySchedulingStrategy:
    node_id: str  # hex
    soft: bool = False


@dataclass(frozen=True)
class PlacementGroupSchedulingStrategy:
    placement_group: Any  # PlacementGroup handle
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass(frozen=True)
class NodeLabelSchedulingStrategy:
    hard: Dict[str, List[str]] = field(default_factory=dict)
    soft: Dict[str, List[str]] = field(default_factory=dict)


SchedulingStrategy = Any  # "DEFAULT" | "SPREAD" | one of the dataclasses above


# ---------------------------------------------------------------------------
# Task spec
# ---------------------------------------------------------------------------

# Sentinel num_returns for streaming-generator tasks (``num_returns="streaming"``):
# return count is dynamic; yields become owner-owned objects as they arrive.
STREAMING_RETURNS = -1

#: inlined-args blobs at least this large ship as pickle-5 out-of-band
#: buffers.  Tied to the RPC layer's vectored-frame threshold: a
#: PickleBuffer below rpc._VEC_MIN_BUF would be wrapped but still
#: serialized in-band, silently defeating the point.
from .rpc import _VEC_MIN_BUF as _VECTORED_ARGS_MIN


def _rebuild_task_spec(kw: dict, args_buf) -> "TaskSpec":
    # Out-of-band receive hands us the transport's bytes object directly
    # (zero-copy); in-band protocol-5 decodes to bytes as well.  Coerce any
    # other buffer type so later re-pickles (lineage copies at protocol 4)
    # keep working.
    kw["args"] = args_buf if isinstance(args_buf, bytes) else bytes(args_buf)
    return TaskSpec(**kw)


@dataclass(slots=True)
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    name: str
    # function: registered blob hash; actor methods reference the actor's class
    fn_id: Optional[bytes]
    # serialized (args, kwargs) — SerializedObject.to_bytes(); top-level refs
    # are wrapped in _TopLevelRef markers inside.
    args: bytes
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    owner: str = ""                 # rpc address of owner core worker
    scheduling_strategy: SchedulingStrategy = "DEFAULT"
    max_retries: int = 0
    retry_count: int = 0
    retry_exceptions: bool = False
    runtime_env: Optional[dict] = None
    # actor creation
    is_actor_creation: bool = False
    actor_id: Optional[ActorID] = None
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    is_async_actor: bool = False
    actor_name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None    # None (job-scoped) | "detached"
    # actor method call
    is_actor_task: bool = False
    actor_method: Optional[str] = None
    seq_no: int = 0
    #: streaming generators: pause the producer once this many yields are
    #: unconsumed (0 = unbounded; reference: _generator_backpressure_num_objects)
    generator_backpressure: int = 0
    #: propagated trace context (trace_id, parent_span_id) — reference:
    #: util/tracing/tracing_helper.py serialized span context in the spec
    trace_ctx: Optional[tuple] = None
    # bookkeeping
    submitted_at: float = field(default_factory=time.time)

    def scheduling_key(self) -> tuple:
        """Tasks with the same key can reuse the same leased worker
        (reference: SchedulingKey in direct_task_transport.h:151).  The
        runtime env is part of worker identity: a pip env means a dedicated
        interpreter, so different envs must never share a lease pool."""
        env_key = None
        if self.runtime_env:
            env_key = repr(sorted(
                (k, repr(v)) for k, v in self.runtime_env.items()))
        return (self.fn_id, tuple(sorted(self.resources.items())),
                repr(self.scheduling_strategy), env_key)

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)]

    def __reduce_ex__(self, protocol):
        # Large inlined args ride out-of-band at protocol 5+ so a
        # push_task_batch carrying a big serialized argument blob never
        # concatenates it through the frame's pickle stream (see the RPC
        # layer's vectored frames).  Protocol < 5 (lineage deep-copies via
        # pickle.dumps default) keeps the plain dataclass reduce.
        if protocol >= 5 and isinstance(self.args, bytes) \
                and len(self.args) >= _VECTORED_ARGS_MIN:
            import pickle as _pickle
            kw = {n: getattr(self, n) for n in SPEC_FIELDS if n != "args"}
            return (_rebuild_task_spec, (kw, _pickle.PickleBuffer(self.args)))
        # object., not super().: @dataclass(slots=True) rebuilds the class,
        # so the zero-arg super() closure would point at the discarded
        # pre-slots class and raise on every pickle.
        return object.__reduce_ex__(self, protocol)


#: TaskSpec field names in declaration order — the slotted class has no
#: ``__dict__``, so everything that used to iterate ``spec.__dict__``
#: (template split, prototype clone) iterates this tuple instead.
import dataclasses as _dataclasses
SPEC_FIELDS: Tuple[str, ...] = tuple(
    f.name for f in _dataclasses.fields(TaskSpec))

#: Fields that vary per call — everything else is template-invariant for
#: one (function, options) pair.  The template cache (spec_cache.py) and
#: the owner's template-clone fast path both key off this split.
VOLATILE_FIELDS: Tuple[str, ...] = (
    "task_id", "args", "retry_count", "seq_no", "trace_ctx", "submitted_at")

TEMPLATE_FIELDS: Tuple[str, ...] = tuple(
    n for n in SPEC_FIELDS if n not in VOLATILE_FIELDS)

# Generated field-by-field copies (slot loads/stores, no dict machinery) —
# the clone primitives under the receiver's prototype-interner decode and
# the owner's template-clone submission fast path.  copy_template_into
# skips the volatile fields its callers store immediately after.
_ns: Dict[str, Any] = {}
exec("def copy_spec_into(src, dst):\n"
     + "".join(f"    dst.{n} = src.{n}\n" for n in SPEC_FIELDS), _ns)
exec("def copy_template_into(src, dst):\n"
     + "".join(f"    dst.{n} = src.{n}\n" for n in TEMPLATE_FIELDS), _ns)
copy_spec_into = _ns["copy_spec_into"]
copy_template_into = _ns["copy_template_into"]
del _ns


# ---------------------------------------------------------------------------
# TaskSpec free-list (submission fast path)
#
# Submitted specs are recycled at terminal completion (TaskManager.complete,
# when the spec escaped into neither lineage nor a stream) and re-acquired
# by the next warm ``.remote()`` — a steady-state submission allocates no
# new spec object.  deque append/pop are single-bytecode atomic under the
# GIL, so the driver thread acquires while the IO loop recycles without a
# lock.  Templates cached on RemoteFunction/ActorMethod handles are built
# OUTSIDE the free-list and never submitted, so no live template can be
# handed out twice.
# ---------------------------------------------------------------------------

_SPEC_FREELIST: List[TaskSpec] = []
#: exact counters (submission-plane observability: free-list hit rate)
spec_freelist_hits = 0
spec_freelist_misses = 0


def spec_from_freelist() -> TaskSpec:
    """A recycled (stale-fielded) spec, or a fresh uninitialized one."""
    global spec_freelist_hits, spec_freelist_misses
    try:
        spec = _SPEC_FREELIST.pop()
        spec_freelist_hits += 1
        return spec
    except IndexError:
        spec_freelist_misses += 1
        return TaskSpec.__new__(TaskSpec)


def recycle_spec(spec: TaskSpec, limit: int) -> None:
    if len(_SPEC_FREELIST) < limit:
        _SPEC_FREELIST.append(spec)


def build_spec_from_template(tmpl: TaskSpec, task_id: TaskID, args: bytes,
                             trace_ctx: Optional[tuple]) -> TaskSpec:
    """Warm-path spec build: clone the handle's invariant template into a
    free-list spec and store only the per-call fields — the allocation-free
    replacement for the 28-kwarg dataclass ctor."""
    spec = spec_from_freelist()
    copy_template_into(tmpl, spec)
    spec.task_id = task_id
    spec.args = args
    spec.retry_count = 0
    spec.seq_no = 0
    spec.trace_ctx = trace_ctx
    spec.submitted_at = time.time()
    return spec


@dataclass
class _TopLevelRef:
    """Marker for a top-level ObjectRef argument: resolved to its value before the
    user function runs (nested refs are passed through as refs — ray semantics)."""
    ref: Any


# ---------------------------------------------------------------------------
# Errors (reference: python/ray/exceptions.py)
# ---------------------------------------------------------------------------

class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """Wraps an exception raised inside a task; re-raised at ray.get."""

    def __init__(self, cause: BaseException, task_name: str = "", remote_tb: str = ""):
        self.cause = cause
        self.task_name = task_name
        self.remote_traceback = remote_tb
        super().__init__(f"task {task_name!r} failed: {type(cause).__name__}: {cause}"
                         + (f"\n--- remote traceback ---\n{remote_tb}" if remote_tb else ""))

    def __reduce__(self):
        # args holds the formatted message, not the ctor signature — without
        # this, a pickle round-trip re-feeds the message as `cause`.
        return (type(self), (self.cause, self.task_name, self.remote_traceback))


class RuntimeEnvSetupError(RayTpuError):
    """The task's runtime environment could not be built (e.g. pip install
    failed) — deterministic, so the task fails instead of retrying
    (reference: ray.exceptions.RuntimeEnvSetupError)."""


class WorkerCrashedError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """The node's memory monitor killed the worker running this task
    (reference: ray.exceptions.OutOfMemoryError + memory_monitor.h:52).
    Retriable: the retry runs under relieved memory pressure."""


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id=None, msg: str = ""):
        self.actor_id = actor_id
        super().__init__(msg or f"actor {actor_id} died")

    def __reduce__(self):
        return (type(self), (self.actor_id, str(self)))


class ActorUnavailableError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_id, msg=""):
        self.object_id = object_id
        super().__init__(msg or f"object {object_id} lost and could not be reconstructed")

    def __reduce__(self):
        return (type(self), (self.object_id, str(self)))


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

def detect_node_resources(num_cpus: Optional[float] = None,
                          num_gpus: Optional[float] = None,
                          resources: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Autodetect CPU / GPU resources for a node.

    GPU detection follows the reference's approach
    (``python/ray/_private/accelerators/nvidia_gpu.py`` — honours
    ``CUDA_VISIBLE_DEVICES``, else asks NVML for the card count) without
    importing torch: a set ``CUDA_VISIBLE_DEVICES`` gives its ids (an empty
    one none), otherwise NVML's ``nvmlDeviceGetCount`` through ctypes.
    """
    import os
    out: Dict[str, float] = dict(resources or {})
    if num_cpus is None:
        num_cpus = os.cpu_count() or 1
    out["CPU"] = float(num_cpus)
    if num_gpus is None:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            num_gpus = len([c for c in visible.split(",") if c.strip()])
        else:
            num_gpus = _nvml_gpu_count()
    if num_gpus:
        out["GPU"] = float(num_gpus)
    try:
        mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        out.setdefault("memory", float(int(mem * 0.7)))
    except (ValueError, OSError):
        pass
    return out


def _nvml_gpu_count(load=None) -> int:
    """The cards NVML reports (0 where ``libnvidia-ml`` is absent or does
    not initialise).  ``load`` opens the library (default
    ``ctypes.CDLL``)."""
    import ctypes
    try:
        nvml = (load or ctypes.CDLL)("libnvidia-ml.so.1")
    except OSError:
        return 0
    if nvml.nvmlInit_v2() != 0:
        return 0
    try:
        count = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return 0
        return int(count.value)
    finally:
        nvml.nvmlShutdown()


def session_root() -> str:
    """Where sessions, profiles and the head's address file live:
    ``raytpu`` under the temporary directory (``TMPDIR``), as the spill
    directory is."""
    import os
    import tempfile
    return os.path.join(tempfile.gettempdir(), "raytpu")


class ResourceSet:
    """Float resource accounting with exact add/subtract semantics."""

    __slots__ = ("_r",)

    def __init__(self, amounts: Dict[str, float] | None = None):
        self._r = {k: float(v) for k, v in (amounts or {}).items() if v}

    def to_dict(self) -> Dict[str, float]:
        return dict(self._r)

    def get(self, k: str) -> float:
        return self._r.get(k, 0.0)

    def set(self, k: str, v: float):
        """Set one resource's amount; 0 removes the key (dynamic-resource
        deletion semantics)."""
        if v:
            self._r[k] = float(v)
        else:
            self._r.pop(k, None)

    def can_fit(self, demand: Dict[str, float]) -> bool:
        return all(self._r.get(k, 0.0) + 1e-9 >= v for k, v in demand.items() if v > 0)

    def acquire(self, demand: Dict[str, float]) -> bool:
        if not self.can_fit(demand):
            return False
        for k, v in demand.items():
            if v > 0:
                self._r[k] = self._r.get(k, 0.0) - v
        return True

    def release(self, demand: Dict[str, float]):
        for k, v in demand.items():
            if v > 0:
                self._r[k] = self._r.get(k, 0.0) + v

    def force_acquire(self, demand: Dict[str, float]):
        """Subtract without feasibility check — used when a blocked worker
        resumes and reclaims its released resources (temporary oversubscription,
        like the reference raylet's unblock path)."""
        for k, v in demand.items():
            if v > 0:
                self._r[k] = self._r.get(k, 0.0) - v

    def utilization(self, total: "ResourceSet") -> float:
        """Max utilization across resources present in `total` (critical resource)."""
        u = 0.0
        for k, tot in total._r.items():
            if tot > 0:
                u = max(u, 1.0 - self._r.get(k, 0.0) / tot)
        return u
