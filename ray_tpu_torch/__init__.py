"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A package of its own beside ``ray_tpu``: it imports ``torch`` and never
``jax`` or anything of ``ray_tpu``.  Module paths mirror ``ray_tpu/<path>``.
Entry points run on the card unless the caller passes ``device="cpu"``.
Kernels are CUDA C++ for Hopper (``csrc/``), built with nvcc at first use.

The runtime (``core``: tasks, actors, objects, placement groups) is the
JAX package's own, with GPUs as the accelerator resource: ``init`` counts
the node's cards as ``"GPU"`` and ``.options(num_gpus=1)`` reserves one.
Top-level import is lightweight (no torch): the compute-path modules
(``models``, ``ops``, ``parallel``, ``serve``, ``train``, ``rllib``) import
torch, and workers start from this package.
"""

from .core import (ActorDiedError, ActorUnavailableError, GetTimeoutError,
                   NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy,
                   ObjectLostError, ObjectRef, ObjectRefGenerator, OutOfMemoryError,
                   PlacementGroup,
                   PlacementGroupSchedulingStrategy, RayTpuError, TaskError,
                   WorkerCrashedError, as_future, available_resources, cancel,
                   cluster_resources, exit_actor, get, get_actor, get_async, get_runtime_context,
                   init, is_initialized, kill, method, nodes, placement_group,
                   placement_group_table, put, remote, remove_placement_group,
                   shutdown, timeline, wait)

from .core.ids import (ActorID, JobID, NodeID, ObjectID, PlacementGroupID,
                       TaskID, WorkerID)

__version__ = "0.1.0"


def get_gpu_ids():
    """Accelerator ids granted to this worker (reference:
    ``ray.get_gpu_ids``): the CUDA devices of CUDA_VISIBLE_DEVICES."""
    return get_runtime_context().get_accelerator_ids().get("GPU", [])


#: Library submodules resolve lazily (PEP 562) so ``import ray_tpu_torch``
#: stays light but ``ray_tpu_torch.serve`` etc. work as attributes, matching
#: the reference's top-level module surface (limited to what the port has).
_LAZY_SUBMODULES = ("train", "serve", "rllib", "util", "dag", "experimental")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "method", "get", "put", "wait",
    "kill", "cancel", "get_actor", "exit_actor", "get_async", "as_future", "nodes",
    "cluster_resources", "available_resources", "timeline", "ObjectRef",
    "placement_group", "remove_placement_group", "placement_group_table",
    "PlacementGroup", "ObjectRefGenerator", "get_runtime_context", "TaskError", "RayTpuError",
    "ActorDiedError", "ActorUnavailableError", "GetTimeoutError", "ObjectLostError",
    "OutOfMemoryError",
    "WorkerCrashedError", "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy", "PlacementGroupSchedulingStrategy",
    "ActorID", "TaskID", "NodeID", "JobID", "ObjectID", "PlacementGroupID",
    "WorkerID", "get_gpu_ids", "__version__",
]
