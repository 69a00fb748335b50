"""ray_tpu_torch.train — distributed training orchestration over the actor substrate.

Reference surface: ``python/ray/train`` (SURVEY.md §2.5).  The JAX package
joins its workers into one ``jax.distributed`` namespace; the port does what
upstream Ray does: ``TorchTrainer`` forms one ``torch.distributed`` process
group over the worker actors (NCCL when they hold GPUs, gloo otherwise),
and each rank runs the port's train step (ray_tpu_torch.parallel) on the
cards it holds.  Checkpoint IO for the port's trees is ``torch_utils``,
loaded at first use.
"""

from .checkpoint import Checkpoint, CheckpointConfig
from .config import FailureConfig, RunConfig, ScalingConfig
from .context import (TrainContext, get_checkpoint, get_context,
                      get_dataset_shard, report)
from .result import Result
from .backend import (Backend, BackendConfig, TorchBackendConfig,
                      prepare_torch_model)
from .worker_group import WorkerGroup
from .backend_executor import BackendExecutor, TrainingFailedError
from .elastic import ElasticWatcher, ResizeSignal
from .trainer import BaseTrainer, DataParallelTrainer, TorchTrainer
from .observability import StepTracker, status

__all__ = [
    "Checkpoint", "CheckpointConfig", "FailureConfig", "RunConfig",
    "ScalingConfig", "TrainContext", "get_context", "get_checkpoint",
    "get_dataset_shard", "report", "Result", "Backend", "BackendConfig",
    "TorchBackendConfig", "prepare_torch_model",
    "WorkerGroup", "BackendExecutor", "ElasticWatcher", "ResizeSignal",
    "TrainingFailedError", "BaseTrainer", "DataParallelTrainer",
    "TorchTrainer", "save_pytree", "load_pytree", "StepTracker", "status",
]


def __getattr__(name):
    # torch_utils imports torch: a train worker whose loop never touches a
    # tensor does not pay for it (the JAX package's jax_utils defers jax)
    if name in ("save_pytree", "load_pytree"):
        from . import torch_utils
        return getattr(torch_utils, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# Usage telemetry: which libraries a cluster actually uses (reference:
# usage_lib.record_library_usage at import time).  Never raises.
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("train")
del _rlu
