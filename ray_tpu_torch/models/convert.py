"""Carry params of the JAX package into the port, leaf by leaf.

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
