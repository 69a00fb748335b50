"""The single-card train step: forward, backward and the optimizer update.

Counterpart of ``ray_tpu/parallel/train_step.py`` with the same entry points
(``make_optimizer``, ``init_sharded_state``, ``make_train_step``,
``make_eval_step``) and a ``mesh`` that must be ``None``: one card, no
sharding yet.  The optimizer is the JAX package's optax chain,
``clip_by_global_norm -> adamw(warmup_cosine_decay_schedule)``, written out
on tensors with ``torch._foreach_*`` (no optax, no ``torch.optim``), so the
two packages take the same steps:

* the clip scales the grads by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm``, with no epsilon;
* the schedule reads the step count before it increments, so the first
  step's learning rate is the warmup's start, 0;
* AdamW (eps 1e-8, eps_root 0) decays every leaf: there is no mask.

The step updates params and optimizer state in place (the JAX step donates
them) and never waits for the card: its metrics stay 0-d device tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import device as device_mod
from ..models import transformer
from ..models.config import TransformerConfig

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    params: Params
    #: {"mu": tree, "nu": tree, "count": int32 0-d tensor}: optax's adam
    #: moments and its count (the schedule's count equals it)
    opt_state: Dict[str, Any]
    step: torch.Tensor


def _leaves(tree: Params) -> List[torch.Tensor]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _map(fn, tree: Params) -> Params:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP: {item})")


_ADAM_EPS = 1e-8   # optax.adamw's default, which the JAX package keeps


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps=1e-8, weight_decay))`` with ``warmup_cosine_decay_schedule(0,
    learning_rate, warmup_steps, decay_steps)``."""
    learning_rate: float
    weight_decay: float
    warmup_steps: int
    decay_steps: int
    b1: float
    b2: float
    grad_clip: float

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``count`` (an int tensor), in f32 on its
        device, as optax computes it."""
        c = count.float()
        peak = self.learning_rate
        if self.warmup_steps > 0:
            frac = 1 - torch.clamp(c, 0, self.warmup_steps) / self.warmup_steps
            warm = (0.0 - peak) * frac + peak
        else:
            warm = torch.zeros_like(c)
        decay = float(self.decay_steps - self.warmup_steps)
        t = torch.clamp_max(c - self.warmup_steps, decay)
        cos = peak * (0.5 * (1 + torch.cos(math.pi * t / decay)))
        return torch.where(c < self.warmup_steps, warm, cos)

    def init(self, params: Params) -> Dict[str, Any]:
        return {"mu": _map(torch.zeros_like, params),
                "nu": _map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_leaves(params)[0].device)}

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], opt_state: Dict[str, Any],
                params: List[torch.Tensor]) -> torch.Tensor:
        """One step on the flat leaf lists (``_leaves`` order), in place:
        grads are clipped in place, then mu, nu, count and params advance.
        Returns the global norm of the unclipped grads."""
        mu, nu = _leaves(opt_state["mu"]), _leaves(opt_state["nu"])
        count = opt_state["count"]
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        clip = torch.where(g_norm < self.grad_clip, torch.ones_like(g_norm),
                           self.grad_clip / g_norm)
        torch._foreach_mul_(grads, clip)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        count_inc = (count + 1).float()
        bc1 = 1 - torch.pow(self.b1, count_inc)
        bc2 = 1 - torch.pow(self.b2, count_inc)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _ADAM_EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(count))
        torch._foreach_add_(params, upd)
        count.add_(1)
        return g_norm


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(learning_rate=learning_rate, weight_decay=weight_decay,
                     warmup_steps=warmup_steps,
                     decay_steps=max(total_steps, warmup_steps + 1),
                     b1=b1, b2=b2, grad_clip=grad_clip)


def _single_card(mesh, sp_axis: Optional[str] = None) -> None:
    if mesh is not None:
        raise _not_ported("a device mesh (mesh must be None: one card)",
                          "queue A5, DDP / FSDP")
    if sp_axis is not None:
        raise _not_ported("sequence parallelism (sp_axis)",
                          "queue A7, ring attention")


def init_sharded_state(cfg: TransformerConfig, mesh, optimizer: Optimizer,
                       seed: int = 0, param_dtype=torch.float32,
                       device: Optional[Union[str, torch.device]] = None):
    """Random params from ``seed`` and a fresh optimizer state on ``device``
    (default: the card) -> (state, None).  The second value stands where
    the JAX package returns the state's shardings."""
    _single_card(mesh)
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg, dtype=param_dtype)
    for p in _leaves(params):
        p.requires_grad_(True)
    state = TrainState(params=params, opt_state=optimizer.init(params),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    return state, None


def _to_device(batch: Dict[str, Any], dev: torch.device
               ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``dev``; for the card through pinned
    memory, so the copy does not wait for the work queued before it."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def make_train_step(cfg: TransformerConfig, mesh, optimizer: Optimizer,
                    state_sh=None, compute_dtype=torch.bfloat16,
                    sp_axis: Optional[str] = None,
                    remat: Union[bool, str, None] = True, *,
                    grad_quant_enabled: bool = False,
                    zero_sharded_update: bool = False,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds numpy arrays (``tokens`` [B, S+1], or ``tokens`` and
    ``targets``, and optionally ``loss_mask``); they move to ``device``
    (default: the card), which must be where the state lives.  The state is
    updated in place and returned.  Metrics: ``loss``, ``moe_aux_loss``,
    ``tokens``, ``grad_norm`` (of the unclipped grads) and ``total_loss``,
    as 0-d device tensors.
    """
    _single_card(mesh, sp_axis)
    if grad_quant_enabled:
        raise _not_ported("quantized gradient collectives",
                          "queue A9, parallel/quant_collectives.py")
    if zero_sharded_update:
        raise _not_ported("the ZeRO-sharded update",
                          "queue A9, parallel/zero.py")
    transformer.remat_policy(remat)  # unknown / unported policies raise now
    dev = device_mod.resolve(device)

    def step(state: TrainState, batch: Dict[str, Any]):
        leaves = _leaves(state.params)
        if leaves[0].device != dev:
            raise ValueError(f"the state lives on {leaves[0].device}, the "
                             f"step runs on {dev}")
        batch = _to_device(batch, dev)
        total, metrics = transformer.causal_lm_loss(
            state.params, batch, cfg, compute_dtype=compute_dtype,
            remat=remat)
        grads = list(torch.autograd.grad(total, leaves))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.update_(grads, state.opt_state,
                                                 leaves)
        metrics["total_loss"] = total.detach()
        state.step.add_(1)
        return state, metrics

    return step


def make_eval_step(cfg: TransformerConfig, mesh, state_sh=None,
                   compute_dtype=torch.bfloat16, sp_axis: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Callable:
    """Returns ``eval_fn(params, batch) -> metrics`` (no gradients)."""
    _single_card(mesh, sp_axis)
    dev = device_mod.resolve(device)

    @torch.no_grad()
    def eval_fn(params: Params, batch: Dict[str, Any]):
        _, metrics = transformer.causal_lm_loss(
            params, _to_device(batch, dev), cfg, compute_dtype=compute_dtype)
        return metrics

    return eval_fn
