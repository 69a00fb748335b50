"""Physical operators for the streaming executor.

Reference: ``python/ray/data/_internal/execution/operators/`` — operators hold
input queues of ``RefBundle``s, dispatch distributed tasks over block refs, and
expose completed outputs for the executor loop to move downstream.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .. import core as _core_api  # noqa: F401  (ray_tpu_torch.core re-exports api)
from ..core.api import get as ray_get
from ..core.api import put as ray_put
from ..core.api import remote as ray_remote
from ..core.object_ref import ObjectRef
from .block import Block, BlockAccessor, BlockMetadata, DelegatingBlockBuilder
from .context import DataContext
from .datasource import ReadTask, write_block


@dataclass
class RefBundle:
    """A group of (block ref, metadata) pairs — the unit moved between
    operators (reference: ``_internal/execution/interfaces/ref_bundle.py``)."""

    blocks: List[Tuple[ObjectRef, BlockMetadata]]

    def num_rows(self) -> Optional[int]:
        total = 0
        for _, m in self.blocks:
            if m.num_rows is None:
                return None
            total += m.num_rows
        return total

    def size_bytes(self) -> int:
        return sum(m.size_bytes or 0 for _, m in self.blocks)

    def refs(self) -> List[ObjectRef]:
        return [r for r, _ in self.blocks]


# ---------------------------------------------------------------------------
# Map transformer: the fused chain of row/batch transforms run inside one task
# ---------------------------------------------------------------------------

@dataclass
class MapStage:
    kind: str  # "batches" | "rows" | "filter" | "flat_map" | "write"
    fn: Any  # callable, or class when constructor is not None
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    fn_args: Tuple = ()
    fn_kwargs: Dict[str, Any] = None
    is_class: bool = False
    fn_constructor_args: Tuple = ()


def _iter_batches_of(blocks: Iterable[Block], batch_size: Optional[int],
                     batch_format: str):
    """Re-batch a stream of blocks to `batch_size` rows (None = per-block)."""
    if batch_size is None:
        for b in blocks:
            acc = BlockAccessor.for_block(b)
            if acc.num_rows():
                yield acc.to_batch(batch_format)
        return
    builder = DelegatingBlockBuilder()
    for b in blocks:
        acc = BlockAccessor.for_block(b)
        n = acc.num_rows()
        i = 0
        while i < n:
            take = min(batch_size - builder.num_rows(), n - i)
            builder.add_block(acc.slice(i, i + take))
            i += take
            if builder.num_rows() >= batch_size:
                out = builder.build()
                builder = DelegatingBlockBuilder()
                yield BlockAccessor.for_block(out).to_batch(batch_format)
    if builder.num_rows():
        yield BlockAccessor.for_block(builder.build()).to_batch(batch_format)


def _instantiate(stage: MapStage, cache: dict):
    fn = stage.fn
    if stage.is_class:
        key = id(stage.fn)
        if key not in cache:
            cache[key] = stage.fn(*stage.fn_constructor_args)
        fn = cache[key]
    return fn


def apply_stages(stages: List[MapStage], blocks: Iterable[Block],
                 target_block_size: int, fn_cache: Optional[dict] = None
                 ) -> Iterable[Block]:
    """Run the fused stage chain over input blocks, yielding output blocks of
    bounded size."""
    from .block import batch_to_block
    fn_cache = fn_cache if fn_cache is not None else {}
    stream: Iterable[Block] = blocks
    for stage in stages:
        fn = _instantiate(stage, fn_cache)
        if stage.kind == "batches":
            def gen_batches(stream=stream, stage=stage, fn=fn):
                for batch in _iter_batches_of(stream, stage.batch_size,
                                              stage.batch_format):
                    out = fn(batch, *stage.fn_args, **(stage.fn_kwargs or {}))
                    if hasattr(out, "__next__"):  # generator UDF
                        for o in out:
                            yield batch_to_block(o)
                    else:
                        yield batch_to_block(out)
            stream = gen_batches()
        elif stage.kind in ("rows", "filter", "flat_map"):
            def gen_rows(stream=stream, stage=stage, fn=fn):
                builder = DelegatingBlockBuilder()
                for b in stream:
                    for row in BlockAccessor.for_block(b).iter_rows():
                        if stage.kind == "rows":
                            builder.add(fn(row, *stage.fn_args,
                                           **(stage.fn_kwargs or {})))
                        elif stage.kind == "filter":
                            if fn(row, *stage.fn_args, **(stage.fn_kwargs or {})):
                                builder.add(row)
                        else:
                            for o in fn(row, *stage.fn_args,
                                        **(stage.fn_kwargs or {})):
                                builder.add(o)
                        if builder.num_rows() >= 64 * 1024:
                            yield builder.build()
                            builder = DelegatingBlockBuilder()
                if builder.num_rows():
                    yield builder.build()
            stream = gen_rows()
        else:
            raise ValueError(f"unknown stage kind {stage.kind}")
    # Final size-bounded re-blocking.
    for b in stream:
        yield b


# ---------------------------------------------------------------------------
# Remote task bodies (module-level so the function registry ships them once)
# ---------------------------------------------------------------------------

def _bundle_of(blocks: Iterable[Block], input_files=None) -> List[tuple]:
    out = []
    for b in blocks:
        acc = BlockAccessor.for_block(b)
        if acc.num_rows() == 0:
            continue
        out.append((ray_put(b), acc.metadata(input_files)))
    return out


def _run_read_task(task: ReadTask) -> List[tuple]:
    return _bundle_of(task(), input_files=task.metadata.input_files)


def _run_map_task(stages: List[MapStage], target_block_size: int,
                  *blocks: Block) -> List[tuple]:
    return _bundle_of(apply_stages(stages, blocks, target_block_size))


def _yield_block_pairs(blocks: Iterable[Block], input_files=None):
    """Streaming body core: alternately yield block, then its metadata, per
    non-empty output block (reference:
    data/_internal/execution/operators/map_operator.py generator returns).

    The block ships as a streamed RETURN object (caller-owned) rather than a
    worker-side ray_put: a put inside the task leaves the transient worker
    (or pool actor) as the ref's owner, and its idle-reaping/shutdown would
    strand every block it produced ("owner died") before downstream
    consumed them."""
    for b in blocks:
        acc = BlockAccessor.for_block(b)
        if acc.num_rows() == 0:
            continue
        yield b
        yield acc.metadata(input_files)


def _stream_map_task(stages: List[MapStage], target_block_size: int,
                     *blocks: Block):
    yield from _yield_block_pairs(
        apply_stages(stages, blocks, target_block_size))


def _stream_read_task(task: ReadTask):
    yield from _yield_block_pairs(task(),
                                  input_files=task.metadata.input_files)


def _run_write_task(path: str, file_format: str, writer_args: dict,
                    index: int, *blocks: Block) -> List[tuple]:
    import pyarrow as pa
    paths = []
    for j, b in enumerate(blocks):
        paths.append(write_block(b, path, file_format, index * 1000 + j,
                                 **writer_args))
    t = pa.table({"path": pa.array(paths)})
    return [(ray_put(t), BlockAccessor.for_block(t).metadata())]


def _slice_block_task(block: Block, start: int, end: int) -> List[tuple]:
    out = BlockAccessor.for_block(block).slice(start, end)
    return [(ray_put(out), BlockAccessor.for_block(out).metadata())]


# ---------------------------------------------------------------------------
# Physical operators
# ---------------------------------------------------------------------------

class PhysicalOperator:
    def __init__(self, name: str, input_ops: List["PhysicalOperator"]):
        self.name = name
        self.input_ops = input_ops
        self.input_queue: collections.deque[RefBundle] = collections.deque()
        self.output_queue: collections.deque[RefBundle] = collections.deque()
        self._inputs_done = False
        self.in_flight: Dict[ObjectRef, Any] = {}
        # completed-but-unreleased task results (see on_task_done ordering)
        self._done_tasks: Dict[ObjectRef, Any] = {}
        # streaming-generator tasks currently producing for this operator
        self.gen_in_flight: List[Any] = []
        self.ctx = DataContext.get_current()
        self.metrics = collections.Counter()

    # input side
    def add_input(self, bundle: RefBundle):
        self.input_queue.append(bundle)

    def mark_inputs_done(self):
        self._inputs_done = True

    def queued_bytes(self) -> int:
        return sum(b.size_bytes() for b in self.input_queue)

    # work dispatch
    def can_dispatch(self) -> bool:
        return (bool(self.input_queue)
                and len(self.in_flight) + len(self.gen_in_flight)
                < self.ctx.max_tasks_in_flight_per_op)

    def dispatch_one(self):
        raise NotImplementedError

    def pending_refs(self) -> List[ObjectRef]:
        """Refs the executor should still wait on (completed-but-held results
        are excluded so they aren't re-delivered)."""
        return [r for r in self.in_flight if r not in self._done_tasks]

    def on_task_done(self, ref: ObjectRef):
        """Buffer out-of-order completions; release results in DISPATCH order
        (in_flight's insertion order), so downstream block order matches the
        input order instead of ray_wait readiness order."""
        self._done_tasks[ref] = ray_get(ref)
        while self.in_flight:
            first = next(iter(self.in_flight))
            if first not in self._done_tasks:
                break
            ctx = self.in_flight.pop(first)
            self._handle_result(ctx, self._done_tasks.pop(first))
            self.metrics["tasks_finished"] += 1

    def poll_streams(self) -> bool:
        """Drain whatever streaming tasks have yielded so far (non-blocking).
        Each yield is one (block_ref, metadata) pair — it becomes an output
        bundle immediately, while the producing task keeps running.

        Yields are released in task-DISPATCH order: only the head stream
        feeds the output queue; younger streams hold their yields (bounded
        by generator_backpressure) until the head completes.  Without this,
        whichever task yields first wins and take()/iteration order diverges
        from the buffered path."""
        progressed = False
        while self.gen_in_flight:
            g = self.gen_in_flight[0]
            while True:
                ref = g.try_next()
                if ref is None:
                    break
                # Yields alternate block, metadata (see _yield_block_pairs):
                # the block ref passes through un-fetched; only the small
                # metadata yield is materialized here.
                pending = getattr(g, "_pending_block", None)
                if pending is None:
                    g._pending_block = ref
                else:
                    g._pending_block = None
                    self._handle_result(None, [(pending, ray_get(ref))])
                progressed = True
            if not g.completed():
                break
            pending = getattr(g, "_pending_block", None)
            if pending is not None:
                # A lone trailing yield is the task's error item (pairs are
                # produced atomically): fetching it raises the task error.
                g._pending_block = None
                ray_get(pending)
            self.gen_in_flight.pop(0)
            self._on_stream_complete(g)
            self.metrics["tasks_finished"] += 1
            progressed = True  # next stream's buffered yields drain next pass
        return progressed

    def _on_stream_complete(self, g) -> None:
        """Hook: a streaming task finished and was released (ActorPool uses
        this to return the producing actor to the idle pool)."""

    def _handle_result(self, ctx, bundle_list):
        metas = [BlockMetadata(**m.__dict__) if not isinstance(m, BlockMetadata)
                 else m for _, m in bundle_list]
        bundle = RefBundle(list(zip([r for r, _ in bundle_list], metas)))
        if bundle.blocks:
            self.output_queue.append(bundle)
        self.metrics["rows_out"] += bundle.num_rows() or 0

    # completion
    def is_finished(self) -> bool:
        return (self._inputs_done and not self.input_queue
                and not self.in_flight and not self.gen_in_flight)

    def shutdown(self):
        pass


class InputDataBuffer(PhysicalOperator):
    """Holds pre-materialized bundles; no tasks."""

    def __init__(self, bundles: List[RefBundle]):
        super().__init__("Input", [])
        self.output_queue.extend(bundles)
        self._inputs_done = True

    def can_dispatch(self):
        return False

    def is_finished(self):
        return True


class ReadOperator(PhysicalOperator):
    def __init__(self, name: str, read_tasks: List[ReadTask]):
        super().__init__(name, [])
        self._tasks = collections.deque(read_tasks)
        self._inputs_done = True
        self._remote = ray_remote(_run_read_task)
        self._stream_remote = ray_remote(_stream_read_task).options(
            num_returns="streaming",
            # 2 yields per block: keep the backpressure knob block-denominated
            generator_backpressure=2 * self.ctx.generator_backpressure)

    def can_dispatch(self):
        return (bool(self._tasks)
                and len(self.in_flight) + len(self.gen_in_flight)
                < self.ctx.max_tasks_in_flight_per_op)

    def dispatch_one(self):
        task = self._tasks.popleft()
        if self.ctx.use_streaming_generators:
            self.gen_in_flight.append(self._stream_remote.remote(task))
            return
        ref = self._remote.remote(task)
        self.in_flight[ref] = task

    def is_finished(self):
        return (not self._tasks and not self.in_flight
                and not self.gen_in_flight)


class TaskPoolMapOperator(PhysicalOperator):
    def __init__(self, name: str, input_op: PhysicalOperator,
                 stages: List[MapStage], ray_remote_args: Dict[str, Any] = None):
        super().__init__(name, [input_op])
        self._stages = stages
        self._remote = ray_remote(_run_map_task).options(**(ray_remote_args or {}))
        self._stream_remote = ray_remote(_stream_map_task).options(
            num_returns="streaming",
            generator_backpressure=2 * self.ctx.generator_backpressure,
            **(ray_remote_args or {}))

    def dispatch_one(self):
        bundle = self.input_queue.popleft()
        if self.ctx.use_streaming_generators:
            gen = self._stream_remote.remote(self._stages,
                                             self.ctx.target_max_block_size,
                                             *bundle.refs())
            self.gen_in_flight.append(gen)
            return
        ref = self._remote.remote(self._stages,
                                  self.ctx.target_max_block_size,
                                  *bundle.refs())
        self.in_flight[ref] = bundle


class _MapWorker:
    """Actor hosting a constructed class-based UDF (reference:
    ``actor_pool_map_operator.py`` ``_MapWorker``)."""

    def __init__(self):
        self._fn_cache: dict = {}

    def ready(self):
        return "ok"

    def run(self, stages, target_block_size, *blocks):
        return _bundle_of(apply_stages(stages, blocks, target_block_size,
                                       fn_cache=self._fn_cache))

    def run_stream(self, stages, target_block_size, *blocks):
        yield from _yield_block_pairs(apply_stages(
            stages, blocks, target_block_size, fn_cache=self._fn_cache))


class ActorPoolMapOperator(PhysicalOperator):
    def __init__(self, name: str, input_op: PhysicalOperator,
                 stages: List[MapStage], min_size: int, max_size: int,
                 ray_remote_args: Dict[str, Any] = None):
        super().__init__(name, [input_op])
        self._stages = stages
        self._min, self._max = min_size, max_size
        self._remote_args = ray_remote_args or {}
        self._actors: List[Any] = []
        self._idle: collections.deque = collections.deque()
        self._gen_actor: Dict[int, Any] = {}  # id(gen) -> producing actor
        self._started = False

    def _ensure_actors(self):
        if self._started:
            return
        self._started = True
        from ..core.actor import ActorClass
        cls = ActorClass(_MapWorker, dict(self._remote_args))
        for _ in range(self._min):
            a = cls.remote()
            self._actors.append(a)
            self._idle.append(a)

    def can_dispatch(self):
        self._ensure_actors()
        if not self.input_queue:
            return False
        if self._idle:
            return True
        if len(self._actors) < self._max:
            from ..core.actor import ActorClass
            a = ActorClass(_MapWorker, dict(self._remote_args)).remote()
            self._actors.append(a)
            self._idle.append(a)
            return True
        return False

    def dispatch_one(self):
        bundle = self.input_queue.popleft()
        actor = self._idle.popleft()
        if self.ctx.use_streaming_generators:
            g = actor.run_stream.options(
                num_returns="streaming",
                generator_backpressure=2 * self.ctx.generator_backpressure,
            ).remote(self._stages, self.ctx.target_max_block_size,
                     *bundle.refs())
            self.gen_in_flight.append(g)
            self._gen_actor[id(g)] = actor
            return
        ref = actor.run.remote(self._stages, self.ctx.target_max_block_size,
                               *bundle.refs())
        self.in_flight[ref] = (bundle, actor)

    def on_task_done(self, ref: ObjectRef):
        if ref not in self._done_tasks:
            _, actor = self.in_flight[ref]
            self._idle.append(actor)  # free at completion, not release
        super().on_task_done(ref)

    def _on_stream_complete(self, g) -> None:
        actor = self._gen_actor.pop(id(g), None)
        if actor is not None:
            self._idle.append(actor)

    def shutdown(self):
        from ..core.api import kill
        for a in self._actors:
            try:
                kill(a)
            except Exception:
                pass


class WriteOperator(PhysicalOperator):
    def __init__(self, input_op: PhysicalOperator, path: str, file_format: str,
                 writer_args: Dict[str, Any]):
        super().__init__(f"Write({file_format})", [input_op])
        self._path, self._fmt, self._wargs = path, file_format, writer_args
        self._remote = ray_remote(_run_write_task)
        self._index = 0

    def dispatch_one(self):
        bundle = self.input_queue.popleft()
        ref = self._remote.remote(self._path, self._fmt, self._wargs,
                                  self._index, *bundle.refs())
        self._index += 1
        self.in_flight[ref] = bundle


class LimitOperator(PhysicalOperator):
    def __init__(self, input_op: PhysicalOperator, n: int):
        super().__init__(f"Limit({n})", [input_op])
        self._remaining = n
        self._slice = ray_remote(_slice_block_task)

    def can_dispatch(self):
        return bool(self.input_queue) and not self.in_flight

    def dispatch_one(self):
        bundle = self.input_queue.popleft()
        if self._remaining <= 0:
            return
        kept: List[Tuple[ObjectRef, BlockMetadata]] = []
        for ref, meta in bundle.blocks:
            if self._remaining <= 0:
                break
            rows = meta.num_rows
            if rows is None or rows <= self._remaining:
                kept.append((ref, meta))
                self._remaining -= rows or 0
            else:
                sref = self._slice.remote(ref, 0, self._remaining)
                self.in_flight[sref] = None
                self._remaining = 0
        if kept:
            self.output_queue.append(RefBundle(kept))
        if self._remaining <= 0:
            # swallow the rest of the stream
            self.input_queue.clear()
            self._inputs_done = True

    def add_input(self, bundle):
        if self._remaining > 0 or self.in_flight:
            super().add_input(bundle)

    def is_finished(self):
        return super().is_finished() or (self._remaining <= 0 and not self.in_flight)


class AllToAllOperator(PhysicalOperator):
    """Barrier operator: collects every input bundle, then runs ``bulk_fn``
    (which may submit its own tasks) to produce output bundles."""

    def __init__(self, name: str, input_op: PhysicalOperator,
                 bulk_fn: Callable[[List[RefBundle]], List[RefBundle]]):
        super().__init__(name, [input_op])
        self._bulk_fn = bulk_fn
        self._collected: List[RefBundle] = []
        self._ran = False

    def add_input(self, bundle):
        self._collected.append(bundle)

    def can_dispatch(self):
        return self._inputs_done and not self._ran

    def dispatch_one(self):
        self._ran = True
        for out in self._bulk_fn(self._collected):
            if out.blocks:
                self.output_queue.append(out)

    def is_finished(self):
        return self._ran


class UnionOperator(PhysicalOperator):
    """Pass-through over multiple inputs (streams interleave)."""

    def __init__(self, input_ops: List[PhysicalOperator]):
        super().__init__("Union", input_ops)

    def can_dispatch(self):
        return bool(self.input_queue)

    def dispatch_one(self):
        self.output_queue.append(self.input_queue.popleft())

    def is_finished(self):
        return self._inputs_done and not self.input_queue and not self.in_flight
