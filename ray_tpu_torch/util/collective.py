"""ray_tpu_torch.util.collective — collective communication groups.

Reference: ``python/ray/util/collective/collective.py`` (``init_collective_group``
:120, ``allreduce`` :258, ``barrier`` :298, ``broadcast`` :373, ``allgather``
:423, ``reducescatter`` :472, ``send``/``recv`` :531/:594) with NCCL/Gloo
backends (``collective_group/nccl_collective_group.py``, ``gloo_…``).

The port's stance: *in-mesh* tensor collectives are not a runtime service —
one process runs a leaf's parts over a ``parallel/mesh.py`` ``Mesh`` and
moves them with that module's collectives (``all_reduce``, ``all_gather``,
``reduce_scatter``, ``all_to_all``, ``ring_shift``).  This module therefore
provides two things:

1. ``mesh_collectives`` — the collectives of one leaf's parts along a mesh
   axis, with the keywords and edge behaviour of the ``lax`` ops the JAX
   package wraps (its versions run inside ``shard_map`` on one device's
   block; these take every device's part at once).
2. A **host-side collective group** (the Gloo analogue) over the object store
   for control-plane coordination *between actor processes* — barrier,
   broadcast, allreduce of small host arrays (rendezvous state, metrics,
   elastic membership).  This is deliberately NOT a data-plane path: bulk
   tensors should live on the mesh, or move over NCCL in a process group.
   A torch tensor on any device goes in as host numpy (``.detach().cpu()``);
   results are numpy.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch


# ---------------------------------------------------------------------------
# 1. In-mesh collectives: one leaf's parts over a parallel.mesh Mesh
# ---------------------------------------------------------------------------

def _over_groups(parts, mesh, axis, fn) -> list:
    """``fn`` on the parts of each group of devices that differ only along
    ``axis`` (an axis name, or a tuple of names taken in the mesh's axis
    order), its results put back in mesh order."""
    from ray_tpu_torch.parallel.mesh import axis_groups
    if len(parts) != mesh.devices.size:
        raise ValueError(f"{len(parts)} parts for a mesh of "
                         f"{mesh.devices.size} devices")
    axes = [axis] if isinstance(axis, str) else list(axis)
    out = [None] * len(parts)
    for group in axis_groups(mesh, axes):
        for i, t in zip(group, fn([parts[i] for i in group])):
            out[i] = t
    return out


class mesh_collectives:
    """The ``lax`` collectives the JAX package wraps, on one leaf's
    ``parts``: one tensor per device of ``mesh``, in mesh order (as
    ``Sharded.parts``).  Each group of devices along ``axis`` does the
    collective among its parts; the result is one tensor per device, in
    mesh order, each on its part's device.  Sums run in part order on the
    group's first part's device (``parallel/mesh.py``), and the sums,
    gathers and scatters carry autograd."""

    @staticmethod
    def allreduce(parts, mesh, axis, op: str = "sum"):
        import torch
        from ray_tpu_torch.parallel import mesh as m

        def mean(group):
            # pmean: the sum over a divisor on its device (a CPU scalar
            # would make CUDA multiply by its reciprocal instead)
            return [t / torch.full((), len(group), dtype=t.dtype,
                                   device=t.device)
                    for t in m.all_reduce(group)]

        def extreme(reduce):
            def go(group):
                out = group[0]
                for p in group[1:]:
                    out = reduce(out, p.to(out.device))
                return m.replicate(out, [p.device for p in group])
            return go

        fns = {"sum": m.all_reduce, "mean": mean,
               "max": extreme(torch.maximum), "min": extreme(torch.minimum)}
        if op not in fns:
            raise ValueError(f"unsupported op {op}")
        return _over_groups(parts, mesh, axis, fns[op])

    @staticmethod
    def allgather(parts, mesh, axis, *, tiled: bool = False):
        """Untiled, the parts stacked on a new leading axis (``lax``'s);
        tiled, put together along axis 0."""
        from ray_tpu_torch.parallel import mesh as m
        if tiled:
            return _over_groups(parts, mesh, axis,
                                lambda g: m.all_gather(g, 0))
        return _over_groups(
            parts, mesh, axis,
            lambda g: m.all_gather([p.unsqueeze(0) for p in g], 0))

    @staticmethod
    def reducescatter(parts, mesh, axis, *, scatter_dimension: int = 0):
        from ray_tpu_torch.parallel import mesh as m
        return _over_groups(parts, mesh, axis,
                            lambda g: m.reduce_scatter(g, scatter_dimension))

    @staticmethod
    def alltoall(parts, mesh, axis, *, split_axis: int = 0,
                 concat_axis: int = 0):
        from ray_tpu_torch.parallel import mesh as m
        return _over_groups(
            parts, mesh, axis,
            lambda g: m.all_to_all(g, split_axis, concat_axis))

    @staticmethod
    def permute(parts, mesh, axis, perm: List[tuple]):
        """``lax.ppermute``: each ``(source, destination)`` pair of group
        positions copies the source's part to the destination; a position
        no pair sends to gets zeros."""
        import torch
        from ray_tpu_torch.parallel import mesh as m

        def go(group):
            n = len(group)
            dsts = [d for _, d in perm]
            srcs = [s for s, _ in perm]
            if not all(0 <= i < n for i in srcs + dsts):
                raise ValueError(f"permutation {perm} out of range for an "
                                 f"axis of size {n}")
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                raise ValueError(f"permutation {perm} repeats a source or "
                                 f"a destination")
            # ring_shift moves position i - 1 to position i: lay each
            # source out one step before its destination
            staged = [None] * n
            for s, d in perm:
                staged[(d - 1) % n] = group[s]
            moved = m.ring_shift(staged, [p.device for p in group])
            return [torch.zeros_like(p) if t is None else t
                    for p, t in zip(group, moved)]
        return _over_groups(parts, mesh, axis, go)

    @staticmethod
    def broadcast(parts, mesh, axis, root: int = 0):
        """Every part of the group becomes the ``root``-th's: its part
        gathered onto each device of the group."""
        from ray_tpu_torch.parallel import mesh as m
        return _over_groups(
            parts, mesh, axis,
            lambda g: [t[0] for t in m.all_gather(
                [g[root].unsqueeze(0)], 0, [p.device for p in g])])


# ---------------------------------------------------------------------------
# 2. Host-side collective group (control plane; Gloo analogue)
# ---------------------------------------------------------------------------

def _host(array):
    """A payload as host numpy: a torch tensor on any device through
    ``.detach().cpu().numpy()`` (``np.asarray`` of a CUDA tensor raises),
    anything else through ``np.asarray``.  A tensor whose dtype numpy lacks
    (bfloat16) raises ``TypeError`` naming it, never cast."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(array, torch.Tensor):
        return np.asarray(array)
    host = array.detach().cpu()
    try:
        return host.numpy()
    except TypeError as e:
        raise TypeError(f"a {array.dtype} tensor has no numpy dtype: cast "
                        f"it before the collective") from e


class _GroupState:
    """Named actor holding rendezvous + reduction state for one group."""

    def __init__(self, world_size: int):
        self.world = world_size
        self.rounds: Dict[str, Dict[int, Any]] = {}
        self.results: Dict[str, Any] = {}

    def contribute(self, op_id: str, rank: int, payload: Any,
                   kind: str = "") -> bool:
        # Divergent op sequences across ranks (rank A: barrier,allreduce;
        # rank B: allreduce,...) must fail fast with a clear error, not hang
        # all ranks until the timeout: the op kind is recorded per sequence
        # number and any mismatch raises at the second contributor.
        kinds = self.rounds.setdefault("\x00kinds", {})
        seq = op_id.rsplit(":", 1)[-1]
        if kind:
            prev = kinds.get(seq)
            if prev is not None and prev != kind:
                raise RuntimeError(
                    f"collective op sequence diverged: op #{seq} is "
                    f"{prev!r} on another rank but {kind!r} on rank {rank}")
            kinds[seq] = kind
        slot = self.rounds.setdefault(op_id, {})
        slot[rank] = payload
        return len(slot) == self.world

    def fetch(self, op_id: str):
        slot = self.rounds.get(op_id)
        if slot is None or len(slot) < self.world:
            return None
        return [slot[r] for r in range(self.world)]

    def finalize(self, op_id: str, result: Any) -> None:
        self.results[op_id] = result

    def result(self, op_id: str, rank: int):
        """Fetch the op result; auto-gc once every rank has fetched it."""
        if op_id not in self.results:
            return "\x00missing"
        out = self.results[op_id]
        acks = self.rounds.setdefault(op_id + ":ack", {})
        acks[rank] = True
        if len(acks) == self.world:
            self.rounds.pop(op_id, None)
            self.rounds.pop(op_id + ":ack", None)
            self.results.pop(op_id, None)
        return out

    # point-to-point mailbox
    def p2p_put(self, key: str, val: Any) -> None:
        self.results[key] = val

    def p2p_take(self, key: str):
        if key in self.results:
            return self.results.pop(key)
        return "\x00missing"


_groups: Dict[str, "CollectiveGroup"] = {}


class CollectiveGroup:
    def __init__(self, group_name: str, world_size: int, rank: int):
        self.name = group_name
        self.world = world_size
        self.rank = rank
        # Job-scoped (NOT detached): the state actor dies with the job instead
        # of leaking one per run; destroy_collective_group() removes it early.
        state_cls = ray_tpu_torch.remote(_GroupState)
        self.state = state_cls.options(
            name=f"_collective:{group_name}", get_if_exists=True,
            num_cpus=0.1).remote(world_size)
        self._seq = 0

    def _op_id(self, kind: str) -> str:
        self._seq += 1
        return f"{kind}:{self._seq}"

    def _sync(self, kind: str, payload: Any, reduce_fn) -> Any:
        """All ranks contribute; rank 0 reduces; everyone polls the result
        (which auto-gcs in the state actor after the last fetch)."""
        op = self._op_id(kind)
        ray_tpu_torch.get(self.state.contribute.remote(op, self.rank, payload,
                                                 kind=kind))
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if self.rank == 0:
                parts = ray_tpu_torch.get(self.state.fetch.remote(op))
                if parts is not None:
                    ray_tpu_torch.get(self.state.finalize.remote(op,
                                                           reduce_fn(parts)))
            res = ray_tpu_torch.get(self.state.result.remote(op, self.rank))
            if not (isinstance(res, str) and res == "\x00missing"):
                return res
            time.sleep(0.01)
        raise TimeoutError(f"collective {op} on group {self.name} timed out")

    def barrier(self) -> None:
        self._sync("barrier", None, lambda parts: True)

    def allreduce(self, array, op: str = "sum"):
        red = {"sum": lambda p: np.sum(p, axis=0),
               "max": lambda p: np.max(p, axis=0),
               "min": lambda p: np.min(p, axis=0),
               "mean": lambda p: np.mean(p, axis=0)}[op]
        return self._sync("allreduce", _host(array), red)

    def allgather(self, array) -> List[np.ndarray]:
        return self._sync("allgather", _host(array), lambda p: list(p))

    def broadcast(self, array, src_rank: int = 0):
        return self._sync("broadcast", _host(array),
                          lambda p: p[src_rank])

    def reducescatter(self, array, op: str = "sum"):
        summed = self.allreduce(array, op)
        chunks = np.array_split(summed, self.world)
        return chunks[self.rank]

    # Channel keys are (src,dst,sequence-per-pair): each side tracks how many
    # messages it has sent to / received from the peer.
    def send(self, array, dst_rank: int) -> None:
        seq = self._p2p_seq("send", dst_rank)
        key = f"p2p:{self.rank}->{dst_rank}:{seq}"
        ray_tpu_torch.get(self.state.p2p_put.remote(key, _host(array)))

    def recv(self, src_rank: int) -> np.ndarray:
        seq = self._p2p_seq("recv", src_rank)
        key = f"p2p:{src_rank}->{self.rank}:{seq}"
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            val = ray_tpu_torch.get(self.state.p2p_take.remote(key))
            if not (isinstance(val, str) and val == "\x00missing"):
                return val
            time.sleep(0.005)
        raise TimeoutError(f"recv from {src_rank} timed out")

    def _p2p_seq(self, kind: str, peer: int) -> int:
        if not hasattr(self, "_p2p_counters"):
            self._p2p_counters: Dict[tuple, int] = {}
        k = (kind, peer)
        self._p2p_counters[k] = self._p2p_counters.get(k, 0) + 1
        return self._p2p_counters[k]


def init_collective_group(world_size: int, rank: int,
                          backend: str = "objectstore",
                          group_name: str = "default") -> CollectiveGroup:
    """Reference ``collective.py:120``; backend is informational here — the
    host group always rides the object store, in-mesh collectives ride XLA."""
    g = CollectiveGroup(group_name, world_size, rank)
    _groups[group_name] = g
    return g


def get_group(group_name: str = "default") -> CollectiveGroup:
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default") -> None:
    g = _groups.pop(group_name, None)
    if g is not None:
        try:
            ray_tpu_torch.kill(g.state)
        except Exception:
            pass


def allreduce(array, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(array, op)


def barrier(group_name: str = "default") -> None:
    get_group(group_name).barrier()


def broadcast(array, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(array, src_rank)


def allgather(array, group_name: str = "default"):
    return get_group(group_name).allgather(array)


def reducescatter(array, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(array, op)
