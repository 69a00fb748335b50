"""optax's Adam for the RL learners, on flat lists of leaf tensors.

The JAX package's learners use ``optax.adam(lr)`` and, in PPO's learner,
``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``.  ``Adam`` follows
optax's formulas: the clip scales by ``max_norm / norm`` only when the
global norm is not below ``max_norm`` (``(t / norm) * max_norm``); the
moments are ``(1 - b) * g**k + b * m``; the bias corrections
``1 - b**count`` are taken in float32, as optax takes them; and ``eps`` is
added outside the square root.  The step runs in place with foreach
kernels and never waits for the device: the count lives on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.train_step import global_norm


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8), after
    ``clip_by_global_norm(grad_clip)`` when ``grad_clip`` is set.  ``init``
    takes the leaves a state covers (one list, in a fixed order); ``step_``
    moves them in place."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, grad_clip: Optional[float] = None):
        self.lr = lr
        self.grad_clip = grad_clip

    def init(self, leaves: Sequence[torch.Tensor]) -> Dict:
        return {"mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves],
                "count": 0}

    def _bias_correction(self, decay: float, count: int) -> float:
        return float(np.float32(1) - np.float32(decay) ** np.float32(count))

    @torch.no_grad()
    def step_(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict) -> None:
        """One step: ``grads`` (consumed) clipped, then mu, nu, the count
        and the leaves advance in place."""
        grads = list(grads)
        if self.grad_clip is not None:
            norm = global_norm(grads)
            keep = norm < self.grad_clip
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, self.grad_clip)))
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        state["count"] += 1
        count = state["count"]
        denom = torch._foreach_div(nu, self._bias_correction(self.b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, self._bias_correction(self.b1, count))
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(leaves, upd)
