"""Cluster-level scheduling policies over the gossiped resource view.

Re-implements the behavior of the reference's pluggable policy set
(``src/ray/raylet/scheduling/policy/``):

* :func:`hybrid_policy` — the default (``hybrid_scheduling_policy.h:51``, doc comment
  :29-49): prefer the local node while its critical-resource utilization is below the
  spread threshold, then pick among the top-k least-utilized feasible nodes, breaking
  ties randomly to avoid herding.
* :func:`spread_policy` — round-robin over feasible nodes (``spread_scheduling_policy.h``).
* node-affinity / node-label / placement-group strategies are resolved before the
  policies run (reference: ``affinity_with_bundle_scheduling_policy.h``).

The *node view* is ``{node_id_hex: NodeView}`` maintained from GCS resource broadcasts
(reference analogue: RaySyncer gossip feeding ClusterResourceManager).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .common import (NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy,
                     PlacementGroupSchedulingStrategy)
from .config import get_config


@dataclass
class NodeView:
    node_id: str              # hex
    address: str              # agent rpc address
    total: Dict[str, float]
    available: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    queue_len: int = 0
    #: preemption notice received — still alive (finishing leases, spilling
    #: objects) but not schedulable: pick_node/pack_bundles skip it
    draining: bool = False
    #: resources currently held by short-lived TASK leases (non-actor,
    #: non-bundle) — capacity that returns to the pool within an idle-return
    #: window.  Elastic sizing counts it as reclaimable headroom: a node
    #: churning 1-CPU dataset tasks is not "full" to a worker-group probe.
    task_leased: Dict[str, float] = field(default_factory=dict)

    def feasible(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) + 1e-9 >= v for k, v in demand.items() if v > 0)

    def can_fit_now(self, demand: Dict[str, float]) -> bool:
        return all(self.available.get(k, 0.0) + 1e-9 >= v for k, v in demand.items() if v > 0)

    def utilization(self) -> float:
        u = 0.0
        for k, tot in self.total.items():
            if tot > 0:
                u = max(u, 1.0 - self.available.get(k, 0.0) / tot)
        return u


_spread_rr = {"i": 0}


def _note_rejections(explain: Optional[dict], view: Dict[str, NodeView],
                     demand: Dict[str, float]):
    """Fill an explain record's per-node rejection causes for the nodes the
    policy will never consider: dead, draining, or infeasible for the
    demand shape.  Causes use the bounded REJECT_CAUSES vocabulary
    (core/sched_explain.py) — they become event fields, never free-form."""
    if explain is None:
        return
    rejected = explain.setdefault("rejected", {})
    for nid, n in view.items():
        if not n.alive:
            rejected[nid] = "dead"
        elif not n.feasible(demand):
            # infeasible beats draining: a node that could NEVER host the
            # shape is a resource rejection whatever its drain state —
            # "draining" is reserved for nodes the drain is actually
            # costing us (feasible but routed around), which is what maps
            # a failed pick to NODE_DRAINING vs NO_RESOURCES
            rejected[nid] = "resources"
        elif n.draining:
            rejected[nid] = "draining"
    explain["candidates"] = len(view)


def pick_node(view: Dict[str, NodeView],
              demand: Dict[str, float],
              strategy="DEFAULT",
              local_node_id: Optional[str] = None,
              rng: random.Random | None = None,
              explain: Optional[dict] = None) -> Optional[str]:
    """Return the chosen node_id hex, or None if no feasible node exists.

    ``explain``, when a dict, is filled with the structured decision
    record: ``candidates`` (nodes in view), ``rejected`` ({node: cause}
    for every node the policy ruled out), ``chosen``.  The None-explain
    path pays nothing — the explain plane's callers (GCS scheduling
    loops, owner lease acquisition) opt in per decision."""
    rng = rng or random
    alive = {nid: n for nid, n in view.items()
             if n.alive and not n.draining}
    _note_rejections(explain, view, demand)

    def chose(nid: Optional[str]) -> Optional[str]:
        if explain is not None:
            explain["chosen"] = nid
        return nid

    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        n = alive.get(strategy.node_id)
        if n is not None and n.feasible(demand):
            return chose(strategy.node_id)
        if not strategy.soft:
            if explain is not None and strategy.node_id not in (
                    explain.get("rejected") or {}):
                # the pinned node exists but cannot take it — an affinity
                # miss, not a resource shortage
                explain.setdefault("rejected", {})[strategy.node_id] = \
                    "affinity"
            return chose(None)
        strategy = "DEFAULT"

    if isinstance(strategy, NodeLabelSchedulingStrategy):
        def match(n: NodeView, conds: Dict[str, List[str]]) -> bool:
            return all(n.labels.get(k) in vals for k, vals in conds.items())
        hard = [nid for nid, n in alive.items()
                if n.feasible(demand) and match(n, strategy.hard)]
        if not hard:
            if explain is not None:
                rej = explain.setdefault("rejected", {})
                for nid, n in alive.items():
                    if n.feasible(demand):
                        rej.setdefault(nid, "affinity")
            return chose(None)
        soft = [nid for nid in hard if match(alive[nid], strategy.soft)]
        pool = soft or hard
        return chose(rng.choice(pool))

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        # Resolved earlier into a NodeAffinity by the PG manager; reaching here
        # means the bundle lookup failed.
        return chose(None)

    feasible = [nid for nid, n in alive.items() if n.feasible(demand)]
    if not feasible:
        return chose(None)
    fit_now = [nid for nid in feasible if alive[nid].can_fit_now(demand)]

    if strategy == "SPREAD":
        pool = fit_now or feasible
        pool = sorted(pool)
        _spread_rr["i"] = (_spread_rr["i"] + 1) % len(pool)
        return chose(pool[_spread_rr["i"]])

    # DEFAULT: hybrid policy.
    cfg = get_config()
    if (local_node_id is not None and local_node_id in alive
            and alive[local_node_id].can_fit_now(demand)
            and alive[local_node_id].utilization() < cfg.scheduler_spread_threshold):
        return chose(local_node_id)

    pool = fit_now or feasible
    ranked = sorted(pool, key=lambda nid: (alive[nid].utilization(), alive[nid].queue_len))
    k = max(cfg.scheduler_top_k_absolute,
            int(len(ranked) * cfg.scheduler_top_k_fraction))
    return chose(rng.choice(ranked[:k]))


def _ici_coord(n: NodeView) -> Optional[tuple]:
    """Parse the node's ICI torus coordinate label ("x,y" / "x,y,z")."""
    raw = (n.labels or {}).get("ici_coord")
    if not raw:
        return None
    try:
        return tuple(int(p) for p in str(raw).split(","))
    except ValueError:
        return None


def _ici_distance(a: tuple, b: tuple) -> int:
    """Manhattan hop distance between two ICI coordinates (a proxy for the
    number of ICI links a collective must traverse)."""
    return sum(abs(x - y) for x, y in zip(a, b))


def _ici_span(coords: List[tuple]) -> int:
    """Max pairwise hop distance — the diameter of a placement.  Contiguous
    sub-tori minimize this, which is what keeps psum/all-gather on short ICI
    paths instead of crossing the slice."""
    return max((_ici_distance(a, b) for a in coords for b in coords),
               default=0)


def pack_bundles(view: Dict[str, NodeView], bundles: List[Dict[str, float]],
                 strategy: str,
                 explain: Optional[dict] = None) -> Optional[List[str]]:
    """Explain-aware wrapper over the packing policies: fills the decision
    record (``rejected`` causes, ``bundles``, ``chosen`` placement) when a
    dict is passed, at zero cost otherwise."""
    placement = _pack_bundles(view, bundles, strategy, explain)
    if explain is not None:
        explain["chosen"] = placement
    return placement


def _pack_bundles(view: Dict[str, NodeView], bundles: List[Dict[str, float]],
                  strategy: str,
                  explain: Optional[dict] = None) -> Optional[List[str]]:
    """Placement-group bundle packing (reference: bundle_scheduling_policy.h)
    with the TPU extension SURVEY §2.3 calls for: nodes carrying
    ``tpu_slice``/``ici_coord`` labels are packed ICI-contiguously.

    Returns a node_id per bundle or None if infeasible.  STRICT_PACK puts
    every bundle on one node; PACK prefers few nodes — and among multi-node
    spills, same-slice nodes nearest (in ICI hops) to the nodes already
    chosen; SPREAD prefers distinct nodes; STRICT_SPREAD requires distinct
    nodes and, when the candidates have ICI coordinates, picks the seed whose
    greedy nearest-neighbor set minimizes the placement's ICI diameter (a
    contiguous sub-torus when one is free).
    """
    alive = {nid: NodeView(n.node_id, n.address, dict(n.total), dict(n.available),
                           n.labels, n.alive, n.queue_len)
             for nid, n in view.items() if n.alive and not n.draining}
    if explain is not None:
        # per-node rejection causes against the largest single bundle: the
        # shape a node must at least be able to hold to host any of them
        biggest = max(bundles, key=lambda b: sum(b.values())) if bundles \
            else {}
        _note_rejections(explain, view, biggest)
        explain["bundles"] = len(bundles)

    def try_place(order_nodes_for_bundle) -> Optional[List[str]]:
        placement: List[str] = []
        for i, b in enumerate(bundles):
            placed = False
            for nid in order_nodes_for_bundle(i, placement):
                n = alive[nid]
                if n.can_fit_now(b):
                    for k, v in b.items():
                        n.available[k] = n.available.get(k, 0.0) - v
                    placement.append(nid)
                    placed = True
                    break
            if not placed:
                return None
        return placement

    if strategy == "STRICT_PACK":
        for nid in sorted(alive, key=lambda x: alive[x].utilization()):
            saved = {k: dict(v.available) for k, v in alive.items()}
            p = try_place(lambda i, pl, nid=nid: [nid])
            if p is not None:
                return p
            for k, v in saved.items():
                alive[k].available = v
        return None
    def ici_key(nid: str, placed: List[str]):
        """(slice mismatch, ICI hops to the nearest already-placed node) —
        zeros when topology labels are absent, so plain clusters keep the
        original ordering."""
        n = alive[nid]
        placed_nodes = [alive[p] for p in dict.fromkeys(placed)]
        if not placed_nodes:
            return (0, 0)
        slices = {(p.labels or {}).get("tpu_slice") for p in placed_nodes}
        my_slice = (n.labels or {}).get("tpu_slice")
        slice_penalty = 0 if (my_slice in slices or my_slice is None) else 1
        c = _ici_coord(n)
        pcoords = [pc for pc in (_ici_coord(p) for p in placed_nodes)
                   if pc is not None]
        hops = (min(_ici_distance(c, pc) for pc in pcoords)
                if c is not None and pcoords else 0)
        return (slice_penalty, hops)

    if strategy == "PACK":
        return try_place(lambda i, pl: sorted(
            alive, key=lambda nid: (nid not in pl, *ici_key(nid, pl),
                                    alive[nid].utilization())))
    if strategy == "SPREAD":
        return try_place(lambda i, pl: sorted(
            alive, key=lambda nid: (pl.count(nid), alive[nid].utilization())))
    if strategy == "STRICT_SPREAD":
        coords = {nid: _ici_coord(alive[nid]) for nid in alive}
        if len(bundles) > 1 and sum(c is not None
                                    for c in coords.values()) >= len(bundles):
            # Topology-aware: greedy nearest-neighbor growth from every seed;
            # keep the placement with the smallest ICI diameter.
            best, best_span = None, None
            for seed in alive:
                if coords[seed] is None:
                    continue
                saved = {k: dict(v.available) for k, v in alive.items()}
                order = sorted(
                    (nid for nid in alive if coords[nid] is not None),
                    key=lambda nid: (_ici_distance(coords[seed], coords[nid]),
                                     alive[nid].utilization()))
                p = try_place(lambda i, pl, order=order:
                              [nid for nid in order if nid not in pl])
                for k, v in saved.items():
                    alive[k].available = v
                if p is not None:
                    span = _ici_span([coords[nid] for nid in p])
                    if best_span is None or span < best_span:
                        best, best_span = p, span
            if best is not None:
                return best
        return try_place(lambda i, pl: [nid for nid in sorted(
            alive, key=lambda n2: alive[n2].utilization()) if nid not in pl])
    raise ValueError(f"unknown placement strategy {strategy}")
