"""Trainers — reference ``python/ray/train/base_trainer.py:607``
(``BaseTrainer.fit``), ``data_parallel_trainer.py:59,484``
(``DataParallelTrainer.training_loop``).

The reference routes ``fit()`` through a single-trial Tune run; here the
driver loop is direct (the JAX package's tune takes a trainer the other way;
the port has no tune yet, so ``as_trainable`` raises).  Fault tolerance
comes in two tiers:

* **Elastic resize** (``ScalingConfig.min_workers``): a preemption drain
  notice or worker death RESIZES the group in place — the executor
  checkpoints at the barrier, re-forms at the new world size, re-splits
  the data shards, and resumes; ``fit()`` never sees a failure and the
  resize ledger lands on ``Result.resizes``.
* **Restart from checkpoint** (FailureConfig): when the resize path is
  off — or a resize itself fails (capacity below ``min_workers``) — the
  group is torn down, re-created, and the loop restarts from the latest
  registered checkpoint, up to ``FailureConfig.max_failures`` times.

``TorchTrainer`` (``train/torch/torch_trainer.py``; the JAX package's
``JaxTrainer``) forms a ``torch.distributed`` process group over the workers
(see backend.py): NCCL on GPUs, gloo on the CPU.  The worker loop builds its
mesh over the cards it holds via ``train.get_context().mesh()`` and uses
ray_tpu_torch.parallel for sharded train steps.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

from .backend import BackendConfig, TorchBackendConfig
from .backend_executor import BackendExecutor, TrainingFailedError
from .checkpoint import Checkpoint
from .config import FailureConfig, RunConfig, ScalingConfig
from .result import Result


class BaseTrainer:
    _backend_config_cls = BackendConfig

    def __init__(self, *,
                 train_loop_per_worker: Optional[Callable] = None,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 metadata: Optional[Dict[str, Any]] = None,
                 worker_env: Optional[Dict[str, str]] = None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._backend_config_cls()
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}
        self.worker_env = worker_env
        self._report_callbacks = []

    # Overridable: per-trainer default loop (GBDT-style trainers override).
    def _train_fn(self) -> Callable:
        if self.train_loop_per_worker is None:
            raise ValueError("train_loop_per_worker is required")
        return self.train_loop_per_worker

    def fit(self) -> Result:
        name = self.run_config.name or f"{type(self).__name__}_{int(time.time())}"
        storage_root = self.run_config.resolved_storage_path()
        from .storage import is_uri
        if is_uri(storage_root):
            # checkpoints persist to the URI filesystem (StorageContext
            # layout); per-worker scratch stays local
            trial_dir = f"{storage_root.rstrip('/')}/{name}"
            from .storage import StorageContext
            StorageContext(storage_root, name)  # creates the experiment dir
        else:
            trial_dir = os.path.join(storage_root, name)
            os.makedirs(trial_dir, exist_ok=True)
        failure_cfg = self.run_config.failure_config or FailureConfig()
        max_failures = failure_cfg.max_failures
        failures = 0
        from .checkpoint import CheckpointManager
        ckpt_manager = CheckpointManager(self.run_config.checkpoint_config,
                                         trial_dir)
        checkpoint = self.resume_from_checkpoint
        history = []
        last_metrics: Optional[Dict[str, Any]] = None
        error: Optional[BaseException] = None

        while True:
            executor = BackendExecutor(
                self.backend_config, self.scaling_config, self.run_config,
                trial_name=name, trial_dir=trial_dir,
                worker_env=self.worker_env, ckpt_manager=ckpt_manager)
            try:
                executor.start()
                executor.start_training(self._train_fn(),
                                        self.train_loop_config,
                                        datasets=self.datasets,
                                        checkpoint=checkpoint)
                while True:
                    out = executor.fetch_next()
                    if out[0] == "done":
                        break
                    _, metrics, ckpt = out
                    last_metrics = metrics
                    history.append(metrics)
                    for cb in self._report_callbacks:
                        cb(metrics, ckpt)
                error = None
                break
            except TrainingFailedError as e:
                failures += 1
                checkpoint = executor.latest_checkpoint or checkpoint
                error = e
                retry = (max_failures == -1 or failures <= max_failures)
                if not retry:
                    break
            finally:
                executor.shutdown()

        latest = ckpt_manager.latest
        best = ckpt_manager.best
        result = Result(metrics=last_metrics,
                        checkpoint=best or latest or checkpoint,
                        path=trial_dir, error=error,
                        metrics_history=history,
                        train_obs=executor.train_obs,
                        resizes=list(executor.resize_records))
        if error is not None and not getattr(self, "_suppress_errors", False):
            raise TrainingFailedError(
                f"training failed after {failures} failure(s)") from error
        return result

    # Tune integration: a trainer is convertible to a trainable function.
    def as_trainable(self) -> Callable:
        """The reference wraps the trainer into a ``ray_tpu.tune``
        trainable; the port has no tune yet."""
        raise NotImplementedError(
            "as_trainable needs the tune library: ROADMAP A4 (e)")


class DataParallelTrainer(BaseTrainer):
    """SPMD over the batch axis; the worker loop owns the pjit program."""


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer + torch process-group setup (upstream Ray's
    ``TorchTrainer``, ``train/torch/config.py:63``)."""
    _backend_config_cls = TorchBackendConfig
