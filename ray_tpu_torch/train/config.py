"""Run-level configs — reference: ``python/ray/air/config.py``
(``ScalingConfig`` :94, ``FailureConfig`` :523, ``RunConfig`` :723).

``ScalingConfig`` carries the ``MeshSpec`` (dp/fsdp/tp/sp/ep/pp axis sizes)
that every worker builds over the cards it holds.  The accelerator flag is
upstream Ray's ``use_gpu`` (the JAX package's ``use_tpu``): it reserves one
``GPU`` per worker by default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many workers, with what resources, on what mesh.

    One *worker* = one process, one rank of the ``torch.distributed``
    process group (NCCL when the workers hold GPUs, gloo otherwise).
    """
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    trainer_resources: Optional[Dict[str, float]] = None
    # TPU-native: mesh axis sizes handed to every worker (ray_tpu_torch.parallel.MeshSpec
    # kwargs). -1 fills with remaining devices.
    mesh: Optional[Dict[str, int]] = None
    topology: Optional[str] = None  # e.g. "v5p-64"; informs ICI-aware placement
    # Elastic training: when set, a preemption drain notice resizes the
    # worker group in place (down to min_workers at worst, back up toward
    # num_workers when capacity returns) instead of failing the run.
    # None = rigid world size, any worker loss is a TrainingFailedError.
    min_workers: Optional[int] = None

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None

    @property
    def _resources_per_worker_not_none(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        return {"CPU": 1.0, "GPU": 1.0} if self.use_gpu else {"CPU": 1.0}

    def as_placement_group_bundles(
            self, num_workers: Optional[int] = None) -> List[Dict[str, float]]:
        """Bundle list for ``num_workers`` workers (default: the
        configured target — elastic re-forms pass the current world
        size)."""
        n = self.num_workers if num_workers is None else num_workers
        bundles = [self._resources_per_worker_not_none for _ in range(n)]
        trainer = self.trainer_resources
        if trainer:
            bundles = [dict(trainer)] + bundles
        return bundles

    @property
    def num_bundle_offset(self) -> int:
        return 1 if self.trainer_resources else 0


@dataclasses.dataclass
class FailureConfig:
    """Elastic restart policy — reference ``air/config.py:523``.

    max_failures: total worker-group failures tolerated before the run is
    declared failed (-1 = unlimited).  Recovery restores the latest checkpoint.
    """
    max_failures: int = 0
    fail_fast: bool = False


@dataclasses.dataclass
class RunConfig:
    """Where results/checkpoints go + failure/checkpoint policy —
    reference ``air/config.py:723``."""
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional["CheckpointConfig"] = None
    verbose: int = 1
    log_to_file: bool = False

    def resolved_storage_path(self) -> str:
        return os.path.expanduser(
            self.storage_path or os.environ.get("RAYTPU_RESULTS_DIR",
                                                "~/raytpu_results"))


# re-export for train.__init__ convenience
from .checkpoint import CheckpointConfig  # noqa: E402,F401
