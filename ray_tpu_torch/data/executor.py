"""Streaming executor: pull-based pipelined execution with backpressure.

Reference: ``python/ray/data/_internal/execution/streaming_executor.py`` (:49
executor thread, ``run`` :180) and ``streaming_executor_state.py``
(``process_completed_tasks`` :313, ``select_operator_to_run`` :376). The loop:
move finished task outputs downstream, then dispatch new tasks preferring the
most-downstream operator with ready input, subject to per-op in-flight caps and
a global queued-bytes budget.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Iterator, List, Optional

from ..core.api import wait as ray_wait
from .context import DataContext
from .operators import PhysicalOperator, RefBundle

_SENTINEL = object()


class ExecutionError(RuntimeError):
    pass


def _toposort(out_op: PhysicalOperator) -> List[PhysicalOperator]:
    order: List[PhysicalOperator] = []
    seen = set()

    def visit(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        for i in op.input_ops:
            visit(i)
        order.append(op)

    visit(out_op)
    return order


class StreamingExecutor:
    """Executes an operator DAG, streaming final-op outputs to the consumer."""

    def __init__(self, output_op: PhysicalOperator, name: str = "dataset"):
        self._out_op = output_op
        self._topology = _toposort(output_op)
        self._outq: "queue.Queue" = queue.Queue(maxsize=64)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run_safe,
                                        name=f"StreamingExecutor-{name}",
                                        daemon=True)
        self.ctx = DataContext.get_current()

    # -- public -------------------------------------------------------------
    def start(self) -> Iterator[RefBundle]:
        self._thread.start()
        return self._iter_outputs()

    def stop(self):
        self._stop.set()

    def _iter_outputs(self) -> Iterator[RefBundle]:
        while True:
            item = self._outq.get()
            if item is _SENTINEL:
                if self._error is not None:
                    raise ExecutionError(
                        f"dataset execution failed: {self._error}") from self._error
                return
            yield item

    # -- loop ---------------------------------------------------------------
    def _run_safe(self):
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001
            self._error = e
            traceback.print_exc()
        finally:
            for op in self._topology:
                try:
                    op.shutdown()
                except Exception:
                    pass
            self._outq.put(_SENTINEL)

    def _downstream_of(self, op: PhysicalOperator) -> Optional[PhysicalOperator]:
        for other in self._topology:
            if op in other.input_ops:
                return other
        return None

    def _run(self):
        topo = self._topology
        while not self._stop.is_set():
            progressed = False

            # 1. Move outputs downstream; propagate done-ness.
            for op in topo:
                down = self._downstream_of(op)
                while op.output_queue:
                    bundle = op.output_queue.popleft()
                    progressed = True
                    if down is None:
                        self._outq.put(bundle)
                    else:
                        down.add_input(bundle)
                if down is not None and op.is_finished() and not op.output_queue:
                    if not down._inputs_done and all(
                            i.is_finished() and not i.output_queue
                            for i in down.input_ops):
                        down.mark_inputs_done()
                        progressed = True

            # 2. Check termination.
            if all(op.is_finished() and not op.output_queue for op in topo):
                return

            # 3. Dispatch, most-downstream first (keeps the pipeline draining).
            total_queued = sum(op.queued_bytes() for op in topo)
            over_budget = (total_queued
                           > self.ctx.streaming_output_backpressure_bytes)
            for op in reversed(topo):
                while op.can_dispatch():
                    op.dispatch_one()
                    progressed = True
                if over_budget and op.input_queue:
                    # Under pressure, only the most-downstream op with queued
                    # input gets to run; skip dispatching anything upstream.
                    break

            # 4. Drain streaming-generator yields (non-blocking): blocks
            # flow downstream while their producing tasks are still running.
            streams_live = False
            for op in topo:
                if op.gen_in_flight:
                    streams_live = True
                    if op.poll_streams():
                        progressed = True

            # 5. Wait for any in-flight task.
            in_flight = {}
            for op in topo:
                for ref in op.pending_refs():
                    in_flight[ref] = op
            if in_flight:
                ready, _ = ray_wait(list(in_flight), num_returns=1, timeout=0.1)
                for ref in ready:
                    in_flight[ref].on_task_done(ref)
                    progressed = True
            elif not progressed:
                # Nothing moved: park briefly (short tick while streams are
                # live so fresh yields are picked up promptly).
                self._stop.wait(0.005 if streams_live else 0.02)


def execute_to_bundles(output_op: PhysicalOperator, name: str = "dataset"
                       ) -> List[RefBundle]:
    ex = StreamingExecutor(output_op, name)
    return list(ex.start())
