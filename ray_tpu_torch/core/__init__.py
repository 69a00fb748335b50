"""ray_tpu_torch.core — the distributed runtime substrate (tasks, actors, objects).

Layering mirrors SURVEY.md §1 L1-L3: rpc/object_store/gcs/node_agent are the
"native layer" services; core_worker is the per-process runtime; api is the
public verb surface.  Import stays light (no torch) so worker startup is fast.
"""

from .api import (as_future, available_resources, cancel, cluster_resources,
                  exit_actor, get, get_actor, get_async, init, is_initialized,
                  kill, method, nodes,
                  put, remote, shutdown, timeline, wait)
from .common import (ActorDiedError, ActorUnavailableError, GetTimeoutError,
                     NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy,
                     ObjectLostError, OutOfMemoryError,
                     PlacementGroupSchedulingStrategy, RayTpuError,
                     TaskError, WorkerCrashedError)
from .generator import ObjectRefGenerator
from .object_ref import ObjectRef
from .placement_group import (PlacementGroup, placement_group,
                              placement_group_table, remove_placement_group)
from .runtime_context import get_runtime_context

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "method", "get", "put", "wait",
    "kill", "cancel", "get_actor", "exit_actor", "get_async", "as_future", "nodes",
    "cluster_resources", "available_resources", "timeline", "ObjectRef",
    "ObjectRefGenerator", "OutOfMemoryError",
    "placement_group", "remove_placement_group", "placement_group_table",
    "PlacementGroup", "get_runtime_context", "TaskError", "RayTpuError",
    "ActorDiedError", "ActorUnavailableError", "GetTimeoutError", "ObjectLostError",
    "WorkerCrashedError", "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy", "PlacementGroupSchedulingStrategy",
]
