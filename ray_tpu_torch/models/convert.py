"""Carry params and train states of the JAX package into the port, leaf by
leaf.

The JAX package's params are a nested dict of arrays with block weights
stacked ``[L, ...]``; the port keeps the same tree.  The caller hands the
tree over as numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

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
