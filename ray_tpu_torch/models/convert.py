"""Carry params and train states of the JAX package into the port, leaf by
leaf.

The JAX package's params are a nested dict of arrays with block weights
stacked ``[L, ...]``; the port keeps the same tree.  The caller hands the
tree over as numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module never imports JAX.

Under tensor parallelism (``tp`` shards) the tree is split as the JAX
engine's ``_apply_tp_sharding`` splits it (``tp_axis``): column-parallel
q/k/v, MLP and expert input weights and their biases on their last
dimension, row-parallel output weights on their second-to-last, the KV
cache on its KV-head axis, everything else replicated.  Each shard takes
one contiguous block of a split dimension, as JAX's even split does, so
shard s holds q heads and KV heads of the same GQA groups.

On a device mesh (``sharded_state_from_numpy``) a train state is cut by
its shardings (``parallel/train_step.state_shardings``): each numpy leaf
is cut on the host and each device's block goes straight to it, equal to
what JAX's ``addressable_shards`` hold for the same shardings.
``zero_state_from_numpy`` carries the state of the JAX package's ZeRO step
(``parallel/zero.py``: params replicated, Adam's mu and nu flat vectors
split over dp) into the port's, and ``pp_state_from_numpy`` the staged
state of its pipeline (``parallel/pipeline.py``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch


def _leaf(x: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16: widen exactly to f32, narrow again in torch
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Mapping[str, Any],
                      device: Union[str, torch.device],
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of numpy arrays -> the port's params on ``device``.
    ``dtype`` (optional) casts every floating leaf."""
    return {k: params_from_numpy(v, device, dtype) if isinstance(v, Mapping)
            else _leaf(v, device, dtype) for k, v in tree.items()}


def tp_axis(path: str, ndim: int) -> Optional[int]:
    """The axis a tp split cuts in the leaf at ``path`` ("/blocks/attn/wq",
    "/k"; block leaves carry a leading L), or None where every shard holds
    the whole leaf: the JAX engine's rule, substring for substring."""
    if any(n in path for n in ("wq", "wk", "wv", "w_in", "w_gate")):
        return ndim - 1                      # column parallel
    if "wo" in path or "w_out" in path:
        return ndim - 2                      # row parallel
    if any(n in path for n in ("bq", "bk", "bv", "b_in")):
        return ndim - 1
    if path.endswith("/k") or path.endswith("/v"):
        return 3                             # [L, P|S, len, NKV, D]
    return None


def tp_split(tree: Mapping[str, Any], n: int,
             place: Callable[[Any, int], Any], path: str = "") -> List[dict]:
    """One tree per shard: each leaf of ``tree`` (numpy arrays or tensors)
    cut by ``tp_axis`` into ``n`` contiguous blocks, or whole where it is
    replicated, and ``place(part, s)`` puts shard s's part where it lives.
    A split dimension ``n`` does not divide raises ValueError."""
    out: List[dict] = [{} for _ in range(n)]
    for key, leaf in tree.items():
        sub = f"{path}/{key}"
        if isinstance(leaf, Mapping):
            for shard, part in zip(out, tp_split(leaf, n, place, sub)):
                shard[key] = part
            continue
        axis = tp_axis(sub, leaf.ndim)
        if axis is not None and leaf.shape[axis] % n:
            raise ValueError(f"tp={n} does not divide {sub}'s dimension "
                             f"{axis} of {leaf.shape[axis]}")
        width = leaf.shape[axis] // n if axis is not None else 0
        for s, shard in enumerate(out):
            part = leaf if axis is None else leaf[
                (slice(None),) * axis + (slice(s * width, (s + 1) * width),)]
            shard[key] = place(part, s)
    return out


def tp_params_from_numpy(tree: Mapping[str, Any],
                         devices: Sequence[Union[str, torch.device]],
                         dtype: Optional[torch.dtype] = None) -> List[dict]:
    """``params_from_numpy`` for ``len(devices)`` tp shards: numpy leaves
    are cut on the host and each shard's part goes to its own device, so
    no device ever holds the whole tree."""
    return tp_split(tree, len(devices),
                    lambda a, s: _leaf(a, devices[s], dtype))


def train_state_from_numpy(params: Mapping[str, Any], mu: Mapping[str, Any],
                           nu: Mapping[str, Any], count: Any, step: Any,
                           device: Union[str, torch.device]):
    """A JAX ``TrainState`` -> the port's ``TrainState`` on ``device``, so a
    JAX run resumes in the port.  ``params`` is the param tree, ``mu`` and
    ``nu`` optax's adam moments (trees of the same shape) and ``count`` its
    step count (``ScaleByAdamState.count``), ``step`` the state's step; all
    as numpy.  Params become leaves that require grad."""
    from ..parallel.train_step import TrainState, _leaves

    p = params_from_numpy(params, device)
    for leaf in _leaves(p):
        leaf.requires_grad_(True)
    opt_state = {
        "mu": params_from_numpy(mu, device),
        "nu": params_from_numpy(nu, device),
        "count": torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                              device=device),
    }
    return TrainState(params=p, opt_state=opt_state,
                      step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32, device=device))


def sharded_state_from_numpy(params: Mapping[str, Any], mu: Mapping[str, Any],
                             nu: Mapping[str, Any], count: Any, step: Any,
                             shardings):
    """``train_state_from_numpy`` onto a mesh: a JAX ``TrainState`` (numpy
    leaves) -> the port's sharded ``TrainState`` placed by ``shardings``
    (a ``TrainState`` of ``NamedSharding`` trees, as ``state_shardings``
    gives).  Every leaf is cut on the host, so no device holds the whole
    tree; params require grad."""
    from ..parallel.mesh import device_put, split
    from ..parallel.train_step import TrainState

    def put(tree, sh, grad=False):
        return device_put(params_from_numpy(tree, "cpu"), sh,
                          requires_grad=grad)

    def scalar(x, sh):
        return split(_leaf(np.asarray(x, np.int32), "cpu", None), sh)

    return TrainState(
        params=put(params, shardings.params, True),
        opt_state={"mu": put(mu, shardings.opt_state["mu"]),
                   "nu": put(nu, shardings.opt_state["nu"]),
                   "count": scalar(count, shardings.opt_state["count"])},
        step=scalar(step, shardings.step))


def zero_state_from_numpy(params: Mapping[str, Any], mu_flat: Any,
                          nu_flat: Any, count: Any, step: Any, mesh):
    """A JAX ``init_zero_state`` state -> the port's (``parallel/zero.py``)
    on a dp-only ``mesh``: ``params`` (the param tree) replicated, each
    replica's leaves views of one flat buffer in ``ravel_pytree`` order;
    ``mu_flat`` and ``nu_flat`` (optax's flat [npad] moments) split
    ``P("dp")``, each device getting its chunk; ``count`` (the adam
    count) and ``step`` replicated.  All as numpy.  -> (state,
    shardings)."""
    from ..parallel.mesh import split
    from ..parallel.train_step import TrainState, _leaves
    from ..parallel.zero import (_flat_replicas, _spans, _validate_mesh,
                                 _zero_shardings)

    _validate_mesh(mesh)
    host = params_from_numpy(params, "cpu")
    spans = _spans(host)
    mu, nu = (_leaf(np.asarray(x, np.float32), "cpu", None)
              for x in (mu_flat, nu_flat))
    _, place = _flat_replicas(mesh, mu.shape[0], _leaves(host)[0].dtype,
                              spans)

    def rec(tree, prefix):
        return {k: rec(v, f"{prefix}{k}.") if isinstance(v, dict)
                else place(prefix + k, v) for k, v in tree.items()}

    def scalar(x, sharding):
        return split(_leaf(np.asarray(x, np.int32), "cpu", None), sharding)

    placed = rec(host, "")
    sh = _zero_shardings(placed, mesh)
    state = TrainState(
        params=placed,
        opt_state={"mu": split(mu, sh.opt_state["mu"]),
                   "nu": split(nu, sh.opt_state["nu"]),
                   "count": scalar(count, sh.opt_state["count"])},
        step=scalar(step, sh.step))
    return state, sh


def pp_state_from_numpy(cfg, mesh, numpy_state: Mapping[str, Any],
                        virtual_stages: int = 1):
    """A JAX ``init_pp_state`` state -> the port's staged, sharded state
    (``parallel/pipeline.py``) on ``mesh`` -> (state, shardings).

    ``numpy_state`` holds numpy leaves under ``params`` (the param tree),
    ``mu`` and ``nu`` (optax's adam moments, trees of the same shape),
    ``count`` (the adam count) and ``step``.  Block leaves come staged
    [P, V*Lc, ...], as the reference's ``init_pp_state`` holds them, or
    stacked [L, ...] and are then partitioned here over the mesh's pp with
    ``virtual_stages``.  Each leaf is cut on the host by
    ``pipeline.pp_state_shardings``; params require grad."""
    from ..parallel.mesh import device_put, split
    from ..parallel.pipeline import partition_layers, pp_state_shardings
    from ..parallel.train_step import TrainState

    sh = pp_state_shardings(cfg, mesh)
    pp = mesh.shape["pp"]

    def staged(tree):
        tree = params_from_numpy(tree, "cpu")
        blocks = tree["blocks"]
        stacked = (next(_leaves_of(blocks)).ndim
                   == next(_leaves_of(_block_shapes(cfg))).ndim)
        return partition_layers(tree, pp, virtual_stages) if stacked else tree

    def put(tree, shardings, grad=False):
        return device_put(staged(tree), shardings, requires_grad=grad)

    def scalar(x, sharding):
        return split(_leaf(np.asarray(x, np.int32), "cpu", None), sharding)

    state = TrainState(
        params=put(numpy_state["params"], sh.params, True),
        opt_state={"mu": put(numpy_state["mu"], sh.opt_state["mu"]),
                   "nu": put(numpy_state["nu"], sh.opt_state["nu"]),
                   "count": scalar(numpy_state["count"],
                                   sh.opt_state["count"])},
        step=scalar(numpy_state["step"], sh.step))
    return state, sh


def _leaves_of(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves_of(v)
        else:
            yield v


def _block_shapes(cfg):
    from .transformer import init_params
    return init_params(None, cfg)["blocks"]
