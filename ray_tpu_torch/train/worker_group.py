"""Actor worker group — reference ``python/ray/train/_internal/worker_group.py:59``
(``WorkerGroup``), :101 (workers are actors with resources), placed via the
ScalingConfig placement group like ``backend_executor.py`` does.

The worker actor (``TrainWorker``) runs the user train loop in a side thread
and exposes a pull-based result channel (``next_result``) — the driver drains
one result per worker per round and then releases the barrier (``resume``),
mirroring the reference's session queue protocol (session.py:612).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import PlacementGroupSchedulingStrategy, placement_group

from .checkpoint import Checkpoint
from .context import SessionFinished, TrainContext, _set_context


class TrainWorker:
    """One rank of the training world (actor)."""

    def __init__(self, rank: int, env: Optional[Dict[str, str]] = None):
        self.rank = rank
        for k, v in (env or {}).items():
            os.environ[k] = v
        self._ctx: Optional[TrainContext] = None
        self._thread: Optional[threading.Thread] = None

    def node_info(self) -> Dict[str, Any]:
        import socket
        rtc = ray_tpu_torch.get_runtime_context()
        return {"rank": self.rank, "node_id": rtc.get_node_id(),
                "ip": socket.gethostbyname(socket.gethostname()),
                "pid": os.getpid()}

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process (setup hooks)."""
        return fn(*args, **kwargs)

    def init_session(self, *, world_rank: int, world_size: int,
                     local_rank: int, local_world_size: int, node_rank: int,
                     experiment_name: str, trial_name: str, trial_id: str,
                     trial_dir: str, checkpoint_path: Optional[str],
                     dataset_shards: Optional[Dict[str, Any]],
                     mesh_spec: Optional[Dict[str, int]]) -> None:
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        self._ctx = TrainContext(
            world_rank=world_rank, world_size=world_size,
            local_rank=local_rank, local_world_size=local_world_size,
            node_rank=node_rank, experiment_name=experiment_name,
            trial_name=trial_name, trial_id=trial_id, trial_dir=trial_dir,
            checkpoint=ckpt, dataset_shards=dataset_shards,
            mesh_spec=mesh_spec)
        # train-plane observability: the per-rank step tracker (created
        # eagerly so even un-instrumented loops get step wall/goodput) and
        # the event-loop stall monitor on this worker's RPC loop
        from . import observability as train_obs
        self._ctx._obs = train_obs.StepTracker(world_rank, trial=trial_name)
        train_obs.ensure_loop_monitor(self, f"train_worker:{world_rank}")

    def start_training(self, train_fn: Callable, config: Dict[str, Any]) -> None:
        """Launch the user loop in a side thread; returns immediately."""
        assert self._ctx is not None, "init_session first"
        ctx = self._ctx
        _set_context(ctx)

        import inspect

        # This sync actor task executes with the submitter's trace context
        # installed (core_worker); capture it so the side thread's per-step
        # spans chain under the start_training task slice — the
        # chief -> worker -> step chain `raytpu timeline` renders.
        from ray_tpu_torch.util import tracing
        trace_ctx = tracing.current_context()

        def run():
            if trace_ctx is not None:
                tracing.set_context(trace_ctx)
            if ctx._obs is not None:
                ctx._obs.start()  # goodput clock starts at loop entry
            try:
                sig = inspect.signature(train_fn)
                out = train_fn(config) if len(sig.parameters) >= 1 \
                    else train_fn()
                ctx._finish(out)
            except SessionFinished:
                ctx._finish(None)
            except BaseException as e:  # noqa: BLE001 — forwarded to driver
                ctx._fail(e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"train_loop_rank{self.rank}")
        self._thread.start()

    def next_result(self, timeout: float = 3600.0):
        """Block until the user loop reports / finishes / errors.

        Returns (kind, payload, checkpoint_path, obs_snapshot); kind in
        {"report", "done", "error"}.  Errors re-raise in the driver.  The
        observability snapshot (StepTracker rollup, None with the kill
        switch off) piggybacks on the existing channel — no extra RPC.
        """
        kind, payload, ckpt, obs = self._ctx._next_result(timeout=timeout)
        if kind != "report":
            # the executor kills this worker moments after done/error —
            # push the tail of buffered step spans and the final metric
            # snapshot out before that
            from ray_tpu_torch.util.metrics import flush_metrics

            from .observability import flush_task_events
            flush_task_events()
            try:
                flush_metrics()
            except Exception:
                pass
        if kind == "error":
            raise payload
        return kind, payload, ckpt, obs

    def resume(self) -> None:
        self._ctx._resume()

    def abort(self) -> None:
        if self._ctx is not None:
            self._ctx._abort()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def shutdown_session(self) -> None:
        _set_context(None)
        self._ctx = None


class WorkerGroup:
    """N TrainWorker actors placed by a placement group."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 worker_env: Optional[Dict[str, str]] = None,
                 bundle_offset: int = 0,
                 pg=None,
                 owns_pg: Optional[bool] = None,
                 pg_timeout_s: float = 120.0):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        self._own_pg = (pg is None) if owns_pg is None else owns_pg
        self.workers = []
        if pg is None:
            bundles = [dict(resources_per_worker) for _ in range(num_workers)]
            pg = placement_group(bundles, strategy=placement_strategy)
            bundle_offset = 0
        self.pg = pg
        try:
            if not pg.ready(timeout=pg_timeout_s):
                raise TimeoutError(
                    f"placement group for {num_workers} train workers "
                    f"({resources_per_worker} each) not ready after "
                    f"{pg_timeout_s:.0f}s — insufficient cluster resources?")
            cls = ray_tpu_torch.remote(TrainWorker)
            num_cpus = resources_per_worker.get("CPU", 1)
            extra = {k: v for k, v in resources_per_worker.items()
                     if k not in ("CPU", "GPU")}
            for i in range(num_workers):
                opts = dict(
                    num_cpus=num_cpus,
                    resources=extra or None,
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg,
                        placement_group_bundle_index=bundle_offset + i),
                )
                if resources_per_worker.get("GPU"):
                    opts["num_gpus"] = resources_per_worker["GPU"]
                self.workers.append(cls.options(**opts).remote(i, worker_env))
            # Gather topology → world/local/node ranks (reference sorts workers
            # by node to make local ranks contiguous).
            infos = ray_tpu_torch.get([w.node_info.remote() for w in self.workers],
                                timeout=60)
        except BaseException:
            self.shutdown()
            raise
        nodes: Dict[str, List[int]] = {}
        for info in infos:
            nodes.setdefault(info["node_id"], []).append(info["rank"])
        self.node_rank_of: Dict[int, int] = {}
        self.local_rank_of: Dict[int, int] = {}
        self.local_world_size_of: Dict[int, int] = {}
        for node_rank, (node_id, ranks) in enumerate(sorted(nodes.items())):
            for local_rank, rank in enumerate(sorted(ranks)):
                self.node_rank_of[rank] = node_rank
                self.local_rank_of[rank] = local_rank
                self.local_world_size_of[rank] = len(ranks)
        self.worker_infos = infos

    def __len__(self) -> int:
        return self.num_workers

    def workers_per_node(self) -> Dict[str, int]:
        """node_id -> how many of our ranks live there (the elastic
        watcher matches drain notices against this map)."""
        out: Dict[str, int] = {}
        for info in self.worker_infos:
            out[info["node_id"]] = out.get(info["node_id"], 0) + 1
        return out

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs),
                           timeout=300)

    def execute_single_async(self, index: int, fn: Callable, *args, **kwargs):
        return self.workers[index].execute.remote(fn, *args, **kwargs)

    def execute_single(self, index: int, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(self.execute_single_async(index, fn, *args,
                                                     **kwargs), timeout=300)

    def shutdown(self, kill: bool = True) -> None:
        for w in self.workers:
            try:
                if kill:
                    ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self._own_pg and self.pg is not None:
            try:
                ray_tpu_torch.remove_placement_group(self.pg)
            except Exception:
                pass
