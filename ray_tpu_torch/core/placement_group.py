"""Placement groups (reference: ``python/ray/util/placement_group.py`` —
``placement_group()`` :146, strategies PACK/SPREAD/STRICT_PACK/STRICT_SPREAD :18-19).

Bundles are reserved across node agents with 2-phase prepare/commit by the GCS PG
manager.  For TPU pods, bundle packing is ICI-topology-aware (SURVEY §2.3 row
"Placement/locality"): nodes carry ``tpu_slice``/``ici_coord`` labels;
multi-node PACK spills onto same-slice nodes nearest in ICI hops, and
STRICT_SPREAD selects the node set with minimal ICI diameter (a contiguous
sub-torus when one is free) — see ``scheduling.pack_bundles``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .ids import PlacementGroupID
from .rpc import run_async

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self._placement: Optional[List[tuple]] = None

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self.bundles)

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def _gcs(self):
        from .core_worker import global_worker
        return global_worker().gcs

    def ready(self, timeout: float = 60.0) -> bool:
        if self._placement is not None:  # settled on the create reply
            return True
        info = run_async(self._gcs().call("wait_placement_group", pg_id=self.id,
                                          timeout=timeout, _timeout=timeout + 10))
        if info and info["state"] == "CREATED":
            self._placement = info["placement"]
            return True
        return False

    def wait(self, timeout_seconds: float = 60.0) -> bool:
        return self.ready(timeout_seconds)

    def bundle_placement(self) -> List[tuple]:
        """[(node_id_hex, agent_address)] per bundle."""
        if self._placement is None:
            if not self.ready():
                raise TimeoutError(f"placement group {self.id} not ready")
        return self._placement

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
    from .core_worker import global_worker
    w = global_worker()
    pg_id = PlacementGroupID.from_random().hex()
    reply = run_async(w.gcs.call("create_placement_group", pg_id=pg_id,
                                 bundles=[dict(b) for b in bundles],
                                 strategy=strategy,
                                 name=name, lifetime=lifetime))
    pg = PlacementGroup(pg_id, bundles, strategy)
    info = reply.get("info") if isinstance(reply, dict) else None
    if info and info["state"] == "CREATED":
        pg._placement = info["placement"]
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    from .core_worker import global_worker
    run_async(global_worker().gcs.call("remove_placement_group", pg_id=pg.id))


def placement_group_table(pg: Optional[PlacementGroup] = None):
    from .core_worker import global_worker
    g = global_worker().gcs
    if pg is not None:
        return run_async(g.call("get_placement_group", pg_id=pg.id))
    return run_async(g.call("list_placement_groups"))
