"""Checkpoint IO for the port's trees (params, a ``TrainState``).

Counterpart of ``ray_tpu/train/jax_utils.py`` (named for torch: the port has
no jax).  Where the reference writes msgpack for a host tree and orbax for
a sharded one, the port writes one file, ``state.pt``, with
``torch.save``: plain dicts of host tensors (a ``TrainState`` as a dict
with a kind tag, since a dataclass would not load under
``weights_only=True``), every ``Sharded`` leaf put back together on the
host, one leaf at a time.  So a checkpoint written on one mesh restores
onto another mesh, or onto one device: ``load_pytree`` cuts each leaf for
the target's shardings on the host and sends each device its block (the
counterpart of orbax's restore with target shardings).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import NamedSharding, Sharded, split
from ..parallel.train_step import TrainState

STATE_FILE = "state.pt"
_KIND = "__kind__"


def _as_dict(tree: Any) -> Any:
    if isinstance(tree, TrainState):
        return {_KIND: "TrainState", "params": tree.params,
                "opt_state": tree.opt_state, "step": tree.step}
    return tree


def _to_host(tree: Any) -> Any:
    tree = _as_dict(tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.full("cpu")
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, copy=True))
    return tree


def save_pytree(path: str, tree: Any, *,
                use_orbax: Optional[bool] = None) -> str:
    """Save a tree (a dict of tensors, ``Sharded`` leaves or a
    ``TrainState``) under ``path`` (a directory). Returns the path.
    The port writes one ``state.pt`` whatever the tree, so ``use_orbax``
    (the reference's choice of orbax for sharded trees) may be None or
    False; True raises ValueError."""
    if use_orbax:
        raise ValueError("the port writes one state.pt with torch.save; "
                         "it has no orbax path (use_orbax=True)")
    os.makedirs(path, exist_ok=True)
    dest = os.path.join(path, STATE_FILE)
    tmp = dest + ".tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, dest)
    return path


def _place(host: Any, like: Any, grad: bool) -> Any:
    """``host`` placed as ``like`` says: a ``NamedSharding`` or a
    ``Sharded`` leaf cuts it over its mesh, a tensor moves it to that
    tensor's device; None leaves it on the host."""
    if isinstance(host, dict):
        return {k: _place(v, None if like is None else like[k], grad)
                for k, v in host.items()}
    if not isinstance(host, torch.Tensor):
        return host
    if isinstance(like, Sharded):
        like = like.sharding
    if isinstance(like, NamedSharding):
        return split(host, like, requires_grad=grad)
    out = host if like is None else host.to(like.device)
    return out.requires_grad_(grad) if grad else out


def load_pytree(path: str, target: Any = None, *,
                shardings: Any = None) -> Any:
    """Load a tree saved by ``save_pytree``.  ``shardings`` (a tree of
    ``NamedSharding``s, e.g. ``state_shardings``'s ``TrainState``) restores
    every leaf cut onto its mesh, whatever mesh saved it; else ``target``
    (a tree of the same structure: tensors, or ``Sharded`` leaves) gives
    each leaf its device or sharding; with neither the leaves stay on the
    host.  A saved ``TrainState`` comes back as one, its params requiring
    grad."""
    src = os.path.join(path, STATE_FILE)
    if not os.path.exists(src):
        raise FileNotFoundError(f"no checkpoint state under {path}")
    host = torch.load(src, map_location="cpu", weights_only=True)
    like = _as_dict(shardings if shardings is not None else target)
    if host.get(_KIND) != "TrainState":
        return _place(host, like, False)

    def sub(key):
        return None if like is None else like[key]

    return TrainState(params=_place(host["params"], sub("params"), True),
                      opt_state=_place(host["opt_state"], sub("opt_state"),
                                       False),
                      step=_place(host["step"], sub("step"), False))
