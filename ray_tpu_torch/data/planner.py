"""Logical → physical lowering with map fusion.

Reference: ``python/ray/data/_internal/planner/planner.py`` plus the fusion
rule in ``_internal/logical/rules/operator_fusion.py``: consecutive map-type
operators with compatible compute strategies collapse into a single physical
operator so each block makes one task round-trip.
"""

from __future__ import annotations

from typing import List, Optional

from . import exchange, logical as L
from .context import DataContext
from .operators import (ActorPoolMapOperator, AllToAllOperator, InputDataBuffer,
                        LimitOperator, MapStage, PhysicalOperator, ReadOperator,
                        TaskPoolMapOperator, UnionOperator, WriteOperator)


def _stage_for(op: L.AbstractMap) -> MapStage:
    ctx = DataContext.get_current()
    is_class = isinstance(op.fn, type)
    if isinstance(op, L.MapBatches):
        fmt = op.batch_format
        if fmt in ("default", None):
            fmt = ctx.default_batch_format
        return MapStage("batches", op.fn, batch_size=op.batch_size,
                        batch_format=fmt, fn_args=op.fn_args,
                        fn_kwargs=op.fn_kwargs, is_class=is_class,
                        fn_constructor_args=op.fn_constructor_args)
    kind = {"MapRows": "rows", "Filter": "filter", "FlatMap": "flat_map"}[
        type(op).__name__]
    return MapStage(kind, op.fn, fn_args=op.fn_args, fn_kwargs=op.fn_kwargs,
                    is_class=is_class, fn_constructor_args=op.fn_constructor_args)


def _compute_of(op: L.AbstractMap):
    return op.compute


def plan(logical_tail: L.LogicalOp) -> PhysicalOperator:
    """Lower the logical chain ending at ``logical_tail`` to a physical DAG."""
    ctx = DataContext.get_current()
    chain = logical_tail.chain()
    phys: Optional[PhysicalOperator] = None
    i = 0
    while i < len(chain):
        op = chain[i]
        if isinstance(op, L.Read):
            parallelism = op.parallelism
            if parallelism in (-1, None):
                est = op.datasource.estimate_inmemory_data_size()
                if est:
                    parallelism = max(ctx.read_op_min_num_blocks,
                                      est // ctx.target_max_block_size)
                else:
                    parallelism = ctx.read_op_min_num_blocks
            tasks = op.datasource.get_read_tasks(int(parallelism))
            phys = ReadOperator(op.name(), tasks)
        elif isinstance(op, L.InputData):
            phys = InputDataBuffer(op.bundles)
        elif isinstance(op, L.AbstractMap):
            # Fuse the longest run of same-compute map ops.
            stages: List[MapStage] = []
            compute = _compute_of(op)
            names = []
            j = i
            while j < len(chain) and isinstance(chain[j], L.AbstractMap) \
                    and _compute_of(chain[j]) == compute:
                stages.append(_stage_for(chain[j]))
                names.append(chain[j].name())
                j += 1
            name = "->".join(names)
            if compute == "tasks":
                phys = TaskPoolMapOperator(name, phys, stages,
                                           op.ray_remote_args)
            else:
                _, mn, mx = compute
                phys = ActorPoolMapOperator(name, phys, stages, mn, mx,
                                            op.ray_remote_args)
            i = j
            continue
        elif isinstance(op, L.Limit):
            phys = LimitOperator(phys, op.n)
        elif isinstance(op, L.RandomShuffle):
            phys = AllToAllOperator(
                "RandomShuffle", phys,
                exchange.random_shuffle_fn(op.seed, op.num_outputs))
        elif isinstance(op, L.RandomizeBlockOrder):
            phys = AllToAllOperator(
                "RandomizeBlockOrder", phys,
                exchange.randomize_block_order_fn(op.seed))
        elif isinstance(op, L.Repartition):
            phys = AllToAllOperator(
                f"Repartition({op.num_outputs})", phys,
                exchange.repartition_fn(op.num_outputs, op.shuffle))
        elif isinstance(op, L.Sort):
            phys = AllToAllOperator(
                f"Sort({op.key})", phys, exchange.sort_fn(op.key, op.descending))
        elif isinstance(op, L.Aggregate):
            phys = AllToAllOperator(
                "Aggregate", phys, exchange.aggregate_fn(op.key, op.aggs))
        elif isinstance(op, L.Union):
            others = [plan(x) for x in op.extra_inputs]
            phys = UnionOperator([phys] + others)
        elif isinstance(op, L.Zip):
            other_tail = op.extra_inputs[0]

            def right_getter(other_tail=other_tail):
                from .executor import execute_to_bundles
                return execute_to_bundles(plan(other_tail), "zip-right")

            phys = AllToAllOperator("Zip", phys, exchange.zip_fn(right_getter))
        elif isinstance(op, L.Write):
            phys = WriteOperator(phys, op.path, op.file_format, op.writer_args)
        else:
            raise ValueError(f"cannot plan logical op {op}")
        i += 1
    assert phys is not None
    return phys
