"""Dynamic custom resources (reference:
``python/ray/experimental/dynamic_resources.py``).

``set_resource(name, capacity, node_id=None)`` adjusts a node's capacity
for one custom resource at runtime — create, resize, or delete
(capacity 0).  The agent updates its local accounting, pushes the new
shape to the GCS view (so scheduling sees it immediately), and re-pumps
its lease queue (tasks waiting on the new resource dispatch at once).

Usage::

    from ray_tpu_torch.experimental import set_resource
    set_resource("accelerator_slices", 4)         # this node
    set_resource("accelerator_slices", 0, node)   # delete elsewhere
"""

from __future__ import annotations

from typing import Optional


def set_resource(resource_name: str, capacity: float,
                 node_id: Optional[str] = None) -> None:
    """Set ``resource_name``'s capacity on one node (default: the
    driver's local node, matching the reference's default of the calling
    raylet)."""
    if resource_name in ("CPU", "TPU", "GPU", "memory"):
        raise ValueError(
            f"{resource_name!r} is a built-in resource; dynamic updates "
            "are for CUSTOM resources (reference semantics)")
    from ray_tpu_torch.core.core_worker import global_worker
    from ray_tpu_torch.core.rpc import run_async

    w = global_worker()
    view = run_async(w.gcs.call("get_cluster_view"), timeout=10)
    target = node_id or w.node_id
    if target is None:
        # driver attached to an existing cluster (init(address=...)):
        # it has no node of its own — "local" means the agent it uses
        node = next((v for v in view.values()
                     if v.get("address") == w.agent_address), None)
    else:
        node = view.get(target)
    if node is None or not node.get("alive", True):
        raise ValueError(f"no live node {target!r}")
    agent = w.agent_clients.get(node["address"])
    run_async(agent.call("set_resource", name=resource_name,
                         capacity=float(capacity)), timeout=30)
