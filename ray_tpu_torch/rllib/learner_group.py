"""Cross-process LearnerGroup: learner actors, one ``torch.distributed``
group.

Counterpart of ``ray_tpu/rllib/learner_group.py`` (reference:
``rllib/core/learner/learner_group.py:61``: N learner workers, each on its
own accelerators, DDP-synced with NCCL allreduce; the Algorithm ships
batches to the group and pulls weights back).  The JAX package's actors
form one ``jax.distributed`` namespace and run one jitted program over a
global mesh; the port's form one ``torch.distributed`` process group
through the train library's seam (``train/backend.py``'s
``_setup_torch_process_group`` / ``_teardown_torch_process_group``): NCCL
when the learners hold GPUs, gloo otherwise.  Each rank's ``Learner`` is
one rank of that group (``learner.py``): it updates on its slice of the
batch over its own devices, and ``all_reduce`` sums what the global
program sums.

``device`` (as ``build(device=...)`` takes it): ``None`` gives each
learner ``devices_per_learner`` GPUs (upstream's ``num_gpus_per_learner``)
and runs it on the cards its rank holds (``train/context.py``'s
``_worker_cards``: a lease names no card, so rank r takes cards
``r * n .. r * n + n - 1``); ``"cpu"`` gives it none and runs it on
``devices_per_learner`` CPU devices through the in-process dp split.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Type

import numpy as np


class LearnerWorker:
    """One learner process of the group (runs as a ray_tpu_torch actor).

    ``__init__`` stores config only; ``setup`` joins the process group and
    builds the learner: split so the group can first ask rank 0 for a
    rendezvous address, then set every rank up at once
    (``init_process_group`` blocks until all ranks connect).
    """

    def __init__(self, model_spec: Dict[str, Any], train_cfg: Dict[str, Any],
                 learner_cls: Optional[Type] = None, seed: int = 0,
                 devices_per_learner: int = 1, device=None):
        self._spec = dict(model_spec)
        self._cfg = dict(train_cfg)
        self._learner_cls = learner_cls
        self._seed = seed
        self._per = int(devices_per_learner)
        self._device = device
        self.learner = None
        self.rank = 0

    def pick_coordinator(self) -> str:
        from ..train.backend import _pick_coordinator

        return _pick_coordinator(0)

    def setup(self, coordinator: str, rank: int, world: int) -> Dict[str, Any]:
        import torch.distributed as dist

        import ray_tpu_torch
        from ..parallel.mesh import MeshSpec
        from ..train.backend import _setup_torch_process_group
        from ..train.context import _worker_cards
        from .learner import Learner
        from .models import build_model

        on_cpu = self._device is not None and str(self._device) == "cpu"
        backend = "gloo" if on_cpu else "nccl"
        # every rank runs on this node, so its local rank is its rank
        _setup_torch_process_group(f"tcp://{coordinator}", backend, rank,
                                   world, 120.0, rank)
        if on_cpu:
            devices = ["cpu"] * self._per
        else:
            devices = _worker_cards(rank)
            if len(devices) != self._per:
                raise RuntimeError(
                    f"learner rank {rank} holds cards {devices}, not "
                    f"devices_per_learner={self._per}")
        mesh = (MeshSpec(dp=self._per, fsdp=1).build(devices)
                if self._per > 1 else None)
        cls = self._learner_cls or Learner
        self.learner = cls(build_model(self._spec), self._cfg, mesh=mesh,
                           seed=self._seed, device=devices[0],
                           process_group=dist.group.WORLD)
        self.rank = rank
        return {"rank": rank, "num_devices": self._per * world,
                "num_processes": dist.get_world_size(),
                "backend": dist.get_backend(),
                "devices": [str(d) for d in self.learner.devices],
                "gpus": ray_tpu_torch.get_runtime_context()
                .get_assigned_resources().get("GPU", 0)}

    def update(self, shard: Dict[str, np.ndarray]) -> Optional[Dict[str, float]]:
        """Run the collective update on this rank's batch slice.  Every rank
        MUST be called with its slice of the same global batch (the group
        guarantees this); only rank 0 returns metrics."""
        metrics = self.learner.update(shard)
        return metrics if self.rank == 0 else None

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.learner.get_weights()

    def shutdown(self) -> bool:
        """Leave the process group (the group calls it on every rank
        before it kills the actors)."""
        from ..train.backend import _teardown_torch_process_group

        _teardown_torch_process_group()
        return True


class DistributedLearnerGroup:
    """N learner actors, one process group, same Learner interface.

    Drop-in for ``LearnerGroup``: ``update(rollout)`` splits the global
    batch's env axis across ranks and blocks on all of them (the
    all_reduce is a barrier anyway); ``get_weights`` reads rank 0's params,
    which every rank holds alike.  ``device`` and ``worker_env`` (the
    actors' environment, ``actors.actor_class``): see the module
    docstring.
    """

    def __init__(self, model_spec: Dict[str, Any], train_cfg: Dict[str, Any],
                 num_learners: int, seed: int = 0,
                 learner_cls: Optional[Type] = None,
                 devices_per_learner: int = 1, device=None,
                 worker_env: Optional[Dict[str, str]] = None):
        import ray_tpu_torch

        from .actors import actor_class

        self.world = int(num_learners)
        self.dp_shards = self.world * int(devices_per_learner)
        on_cpu = device is not None and str(device) == "cpu"
        options = dict(num_cpus=1)
        if not on_cpu:
            options["num_gpus"] = int(devices_per_learner)
        actor_cls = actor_class(LearnerWorker, worker_env)
        self.workers = [
            actor_cls.options(**options).remote(
                model_spec, train_cfg, learner_cls, seed,
                devices_per_learner, "cpu" if on_cpu else None)
            for _ in range(self.world)]
        try:
            coordinator = ray_tpu_torch.get(
                self.workers[0].pick_coordinator.remote(), timeout=120)
            self.info = ray_tpu_torch.get(
                [w.setup.remote(coordinator, i, self.world)
                 for i, w in enumerate(self.workers)], timeout=600)[0]
        except BaseException:
            # a rank failing setup leaves the others blocked inside
            # init_process_group: reap them all before raising
            self._kill()
            raise

    def _split(self, rollout: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
        shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(self.world)]
        for k, v in rollout.items():
            v = np.asarray(v)
            axis = 0 if v.ndim <= 1 else 1
            b = v.shape[axis]
            if b % self.dp_shards:
                raise ValueError(
                    f"batch axis {b} of '{k}' not divisible by the dp mesh "
                    f"({self.world} learners x devices_per_learner = "
                    f"{self.dp_shards} shards); size the per-update env "
                    f"axis (PPO: env_runners x num_envs; IMPALA: num_envs "
                    f"of ONE fragment) to a multiple of it")
            for i, piece in enumerate(np.split(v, self.world, axis=axis)):
                shards[i][k] = piece
        return shards

    def update(self, rollout: Dict[str, np.ndarray]) -> Dict[str, float]:
        import ray_tpu_torch

        shards = self._split(rollout)
        out = ray_tpu_torch.get(
            [w.update.remote(s) for w, s in zip(self.workers, shards)],
            timeout=600)
        return out[0]

    def get_weights(self) -> Dict[str, np.ndarray]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.workers[0].get_weights.remote(),
                                 timeout=300)

    def shutdown(self):
        """Each rank leaves the process group, then the actors go."""
        import ray_tpu_torch

        try:
            ray_tpu_torch.get([w.shutdown.remote() for w in self.workers],
                              timeout=60)
        except Exception:
            pass
        self._kill()

    def _kill(self):
        from .actors import kill_all

        kill_all(self.workers)
        self.workers = []
