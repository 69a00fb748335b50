"""Training backends: per-framework worker-group setup hooks.

Reference: ``python/ray/train/backend.py`` (``Backend``/``BackendConfig``) and
``train/torch/config.py:23,63,107`` (``_setup_torch_process_group`` — TCP
rendezvous + NCCL/Gloo).  The JAX package forms one ``jax.distributed``
namespace here; the port forms one ``torch.distributed`` process group over
the worker actors: rank 0's host serves the TCP store on a free port, and
every rank joins with its world rank.  The group is NCCL when the workers
hold GPUs and gloo otherwise, as upstream Ray's ``TorchConfig`` chooses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from .worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks around worker-group lifecycle."""

    def __init__(self, config: BackendConfig):
        self.config = config

    def on_start(self, worker_group: "WorkerGroup") -> None:
        pass

    def on_training_start(self, worker_group: "WorkerGroup") -> None:
        pass

    def on_shutdown(self, worker_group: "WorkerGroup") -> None:
        pass


def _pick_coordinator(port: int) -> str:
    import socket
    hostname = socket.gethostbyname(socket.gethostname())
    if port == 0:
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
    return f"{hostname}:{port}"


@dataclasses.dataclass
class TorchBackendConfig(BackendConfig):
    """Forms a ``torch.distributed`` process group across the worker actors.

    Reference: ``python/ray/train/torch/config.py:63-160``
    (``_setup_torch_process_group`` — TCP-store rendezvous, backend
    nccl/gloo).  ``backend=None`` picks NCCL when the workers hold GPUs
    (``ScalingConfig(use_gpu=True)``) and gloo otherwise.
    """
    backend: Optional[str] = None
    init_timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return TorchBackend


def _setup_torch_process_group(init_method: str, backend: str, rank: int,
                               world_size: int, timeout_s: float,
                               local_rank: int) -> None:
    import datetime
    import torch
    import torch.distributed as dist

    from .context import _worker_cards
    device = None
    if backend == "nccl":
        # the rank's first card, bound before the communicator forms
        cards = _worker_cards(local_rank)
        if not cards:
            raise RuntimeError("an NCCL process group needs a GPU; this "
                               "worker holds none")
        device = torch.device(cards[0])
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), device_id=device)


def _teardown_torch_process_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class TorchBackend(Backend):
    def on_start(self, worker_group: "WorkerGroup") -> None:
        cfg: TorchBackendConfig = self.config
        n = len(worker_group)
        backend = cfg.backend or (
            "nccl" if worker_group.resources_per_worker.get("GPU")
            else "gloo")
        coordinator = worker_group.execute_single(0, _pick_coordinator, 0)
        init_method = f"tcp://{coordinator}"
        futures = [
            worker_group.execute_single_async(
                i, _setup_torch_process_group, init_method, backend,
                i, n, cfg.init_timeout_s, worker_group.local_rank_of[i])
            for i in range(n)
        ]
        import ray_tpu_torch
        ray_tpu_torch.get(futures, timeout=cfg.init_timeout_s + 30)

    def on_shutdown(self, worker_group: "WorkerGroup") -> None:
        try:
            worker_group.execute(_teardown_torch_process_group)
        except Exception:
            pass


def prepare_torch_model(model):
    """Wrap a torch model in DistributedDataParallel when a process group is
    up (reference: ``train/torch/train_loop_utils.py:263`` prepare_model)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel
        return DistributedDataParallel(model)
    return model
