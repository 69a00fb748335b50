"""Worker-side training session: ``report`` / ``get_checkpoint`` /
``get_dataset_shard`` / rank info.

Reference: ``python/ray/train/_internal/session.py:132`` (``_TrainSession``),
``report`` :612/:844, ``get_checkpoint`` :902.  The reference runs the user
loop in a side thread and shuttles results over a queue to the worker actor;
we do the same — ``report()`` enqueues, the driver drains via
``TrainWorker.next_result``.  The session also owns the rank's device mesh
(``mesh()``): the port's ``MeshSpec`` over the cards the worker holds, or
over the CPU in a worker that holds none.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint


class SessionFinished(BaseException):
    """Raised inside the user loop to unwind when the driver aborts a run.

    BaseException so user ``except Exception`` blocks don't swallow it.
    """


class TrainContext:
    """Per-worker session state; created by TrainWorker before the user loop."""

    def __init__(self, *, world_rank: int, world_size: int, local_rank: int,
                 local_world_size: int, node_rank: int,
                 experiment_name: str, trial_name: str, trial_id: str,
                 trial_dir: str, checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 mesh_spec: Optional[Dict[str, int]] = None):
        self._world_rank = world_rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._experiment_name = experiment_name
        self._trial_name = trial_name
        self._trial_id = trial_id
        self._trial_dir = trial_dir
        self._checkpoint = checkpoint
        self._dataset_shards = dataset_shards or {}
        self._mesh_spec = mesh_spec
        self._mesh = None
        self._result_queue: "queue.Queue" = queue.Queue()
        self._continue_evt = threading.Event()
        self._aborted = False
        self._reported_steps = 0
        #: StepTracker (train/observability.py) — created by
        #: TrainWorker.init_session; lazily here for session-less tests
        self._obs = None

    # rank info — reference session.py get_world_rank/get_world_size/...
    def get_world_rank(self) -> int: return self._world_rank
    def get_world_size(self) -> int: return self._world_size
    def get_local_rank(self) -> int: return self._local_rank
    def get_local_world_size(self) -> int: return self._local_world_size
    def get_node_rank(self) -> int: return self._node_rank
    def get_experiment_name(self) -> str: return self._experiment_name
    def get_trial_name(self) -> str: return self._trial_name
    def get_trial_id(self) -> str: return self._trial_id
    def get_trial_dir(self) -> str: return self._trial_dir

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._checkpoint

    def observability(self):
        """This rank's ``StepTracker`` (train/observability.py): phase
        timers, MFU/goodput arithmetic (``set_model``), and the per-step
        snapshot that rides ``report()`` to the driver."""
        if self._obs is None:
            from .observability import StepTracker
            self._obs = StepTracker(self._world_rank, trial=self._trial_name)
        return self._obs

    def get_dataset_shard(self, name: str = "train"):
        shard = self._dataset_shards.get(name)
        if shard is None:
            raise KeyError(
                f"no dataset shard named {name!r}; datasets passed to the "
                f"trainer: {sorted(self._dataset_shards)}")
        return shard

    def mesh(self):
        """This rank's device mesh, from ScalingConfig.mesh axis sizes.

        Built over the cards the worker holds (``_worker_cards``); a
        worker that holds none builds it over the CPU, named once per
        shard.
        """
        if self._mesh is None:
            import math

            from ..parallel.mesh import MeshSpec
            spec = MeshSpec(**(self._mesh_spec or {}))
            self._mesh = spec.build(
                _worker_cards(self._local_rank) or ["cpu"] * math.prod(
                    max(v, 1) for v in spec.sizes().values()))
        return self._mesh

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        """Report metrics (+ optional checkpoint) to the driver; blocks until
        the driver has consumed the result (sync barrier across workers, like
        the reference's session.report)."""
        if self._aborted:
            raise SessionFinished()
        self._reported_steps += 1
        # close the observability step AT the report call — the barrier
        # wait below counts against goodput wall, not against any step
        obs_snap = self._obs.on_report() if self._obs is not None else None
        self._continue_evt.clear()
        self._result_queue.put(
            ("report", dict(metrics),
             checkpoint.path if checkpoint else None, obs_snap))
        self._continue_evt.wait()
        if self._aborted:
            raise SessionFinished()
        if self._obs is not None:
            self._obs.on_resume()

    # --- driver-facing plumbing (used by TrainWorker) ---
    def _finish(self, value: Any) -> None:
        snap = self._obs.snapshot() if self._obs is not None else None
        self._result_queue.put(("done", value, None, snap))

    def _fail(self, err: BaseException) -> None:
        self._result_queue.put(("error", err, None, None))

    def _next_result(self, timeout: Optional[float] = None):
        return self._result_queue.get(timeout=timeout)

    def _resume(self) -> None:
        self._continue_evt.set()

    def _abort(self) -> None:
        self._aborted = True
        self._continue_evt.set()


def _worker_cards(local_rank: int) -> list:
    """The cards this worker's rank holds: its ``GPU`` share of the node's
    cards, counted from its local rank, since a lease names no card
    (ROADMAP A10); none outside a runtime or without a ``GPU`` share."""
    import math

    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        return []
    gpus = math.ceil(ray_tpu_torch.get_runtime_context()
                     .get_assigned_resources().get("GPU", 0))
    return [f"cuda:{local_rank * gpus + i}" for i in range(gpus)]


_context: Optional[TrainContext] = None


def _set_context(ctx: Optional[TrainContext]) -> None:
    global _context
    _context = ctx


def get_context() -> TrainContext:
    if _context is None:
        raise RuntimeError("ray_tpu_torch.train.get_context() called outside a "
                           "train worker session")
    return _context


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    get_context().report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_context().get_dataset_shard(name)
