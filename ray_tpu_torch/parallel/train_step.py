"""The train step: forward, backward and the optimizer update, on one card
or over a device mesh.

Counterpart of ``ray_tpu/parallel/train_step.py`` with the same entry points
(``make_optimizer``, ``state_shardings``, ``init_sharded_state``,
``make_train_step``, ``make_eval_step``).  The optimizer is the JAX
package's optax chain, ``clip_by_global_norm -> adamw(
warmup_cosine_decay_schedule)``, written out on tensors with
``torch._foreach_*`` (no optax, no ``torch.optim``), so the two packages
take the same steps:

* the clip scales the grads by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm``, with no epsilon;
* the schedule reads the step count before it increments, so the first
  step's learning rate is the warmup's start, 0;
* AdamW (eps 1e-8, eps_root 0) decays every leaf: there is no mask.

``mesh=None`` runs on one device.  With a mesh (``parallel/mesh.py``), the
state's leaves are ``Sharded`` by ``models/sharding.logical_param_specs``
(``state_shardings``: the adam moments like the param they track, the
counts replicated), one process drives every device
(``models/transformer.py``'s mesh section) and the step computes what the
reference's global step computes: the loss and its gradients over the
whole batch, whose rows are cut over dp x fsdp; every replicated block's
gradient summed over its copies, in device order on the first copy's
device, so every copy holds the same bits; one global gradient norm
(each element counted once) and clip; AdamW on each device's blocks.

The step updates params and optimizer state in place (the JAX step donates
them) and never waits for the card: its metrics stay 0-d device tensors.
With ``grad_quant_enabled`` or ``zero_sharded_update`` the step is
``zero.make_dp_train_step``'s, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import device as device_mod
from ..models import sharding as shard_rules
from ..models import transformer
from ..models.config import TransformerConfig
from .mesh import (Mesh, NamedSharding, PartitionSpec, Sharded,
                   named_sharding, split, sum_parts)

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


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of every leaf together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


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
        g_norm = global_norm(grads)
        self.apply_(grads, _leaves(opt_state["mu"]),
                    _leaves(opt_state["nu"]), opt_state["count"], params,
                    g_norm)
        return g_norm

    @torch.no_grad()
    def apply_(self, grads: List[torch.Tensor], mu: List[torch.Tensor],
               nu: List[torch.Tensor], count: torch.Tensor,
               params: List[torch.Tensor], g_norm: torch.Tensor) -> None:
        """The clip by ``g_norm`` (the global norm of the unclipped grads)
        and the AdamW step on flat leaf lists of one device, in place."""
        clip = torch.where(g_norm < self.grad_clip, torch.ones_like(g_norm),
                           self.grad_clip / g_norm)
        torch._foreach_mul_(grads, clip)
        self.adamw_(grads, mu, nu, count, params)

    @torch.no_grad()
    def adamw_(self, grads: List[torch.Tensor], mu: List[torch.Tensor],
               nu: List[torch.Tensor], count: torch.Tensor,
               params: List[torch.Tensor]) -> None:
        """The elementwise stage, everything but the clip: optax's
        ``adamw`` on flat leaf lists of one device, in place (mu, nu,
        count and params advance)."""
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


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(learning_rate=learning_rate, weight_decay=weight_decay,
                     warmup_steps=warmup_steps,
                     decay_steps=max(total_steps, warmup_steps + 1),
                     b1=b1, b2=b2, grad_clip=grad_clip)


def _check_mesh(cfg: TransformerConfig, mesh: Mesh,
                device=None) -> transformer.MeshLayout:
    """The mesh's layout; a mesh the step cannot run raises."""
    if device is not None:
        raise ValueError("with a mesh the step runs on the mesh's devices; "
                         "device must be None")
    layout = transformer.MeshLayout(mesh)
    tp = mesh.shape["tp"]
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} does not divide num_heads "
                         f"{cfg.num_heads} and num_kv_heads "
                         f"{cfg.num_kv_heads}")
    if cfg.num_experts % mesh.shape["ep"]:
        raise ValueError(f"ep={mesh.shape['ep']} does not divide "
                         f"num_experts {cfg.num_experts}")
    return layout


def _flat_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_paths(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def state_shardings(cfg: TransformerConfig, mesh: Mesh, optimizer=None,
                    example_state_shapes=None) -> TrainState:
    """The ``NamedSharding`` tree of a TrainState: the adam moments sharded
    like the param they track (ZeRO), the counts replicated.  The port's
    optimizer state has one fixed structure, so the reference's
    ``optimizer`` and ``example_state_shapes`` (which it walks to find
    that structure) are taken and not used."""
    param_sh = named_sharding(mesh, shard_rules.logical_param_specs(cfg))
    rep = NamedSharding(mesh, PartitionSpec())
    return TrainState(params=param_sh,
                      opt_state={"mu": param_sh, "nu": param_sh,
                                 "count": rep},
                      step=rep)


def _replicated_zero(sharding: NamedSharding) -> Sharded:
    return Sharded([torch.zeros((), dtype=torch.int32, device=d)
                    for d in sharding.mesh.device_list], sharding)


def init_sharded_state(cfg: TransformerConfig, mesh, optimizer: Optimizer,
                       seed: int = 0, param_dtype=torch.float32,
                       device: Optional[Union[str, torch.device]] = None):
    """Random params from ``seed`` and a fresh optimizer state -> (state,
    shardings).  ``mesh=None``: on ``device`` (default: the card), and the
    shardings are None.  With a mesh the params are drawn as ``mesh=None``
    draws them on the mesh's first device, leaf by leaf, and each leaf is
    cut into its devices' blocks and dropped at once, so no device ever
    holds the whole state."""
    if mesh is None:
        dev = device_mod.resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = transformer.init_params(gen, cfg, dtype=param_dtype)
        for p in _leaves(params):
            p.requires_grad_(True)
        state = TrainState(params=params, opt_state=optimizer.init(params),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=dev))
        return state, None
    _check_mesh(cfg, mesh, device)
    sh = state_shardings(cfg, mesh)
    at = _flat_paths(sh.params)
    gen = torch.Generator(device=mesh.device_list[0]).manual_seed(seed)
    params = transformer.init_params(
        gen, cfg, dtype=param_dtype,
        place=lambda path, leaf: split(leaf, at[path], requires_grad=True))

    def zeros(leaf: Sharded) -> Sharded:
        return Sharded([torch.zeros_like(p) for p in leaf.parts],
                       leaf.sharding)

    state = TrainState(
        params=params,
        opt_state={"mu": _map(zeros, params), "nu": _map(zeros, params),
                   "count": _replicated_zero(sh.opt_state["count"])},
        step=_replicated_zero(sh.step))
    return state, sh


def _to_device(batch: Dict[str, Any], dev: torch.device
               ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``dev``; for the card through pinned
    memory, so the copy does not wait for the work queued before it.  A
    tensor (``iter_torch_batches``'s) moves as it is."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(dev)
            continue
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
                    quant_block: Optional[int] = None,
                    quant_stochastic: bool = False,
                    zero_sharded_update: bool = False,
                    opt_spec=None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds numpy arrays or tensors (``tokens`` [B, S+1], or
    ``tokens`` and ``targets``, and optionally ``loss_mask``); they move to
    ``device`` (default: the card), which must be where the state lives.
    The state is updated in place and returned.  Metrics: ``loss``,
    ``moe_aux_loss``, ``tokens``, ``grad_norm`` (of the unclipped grads) and
    ``total_loss``, as 0-d device tensors.  ``remat``: False/None, True/"full",
    "save_acts", "save_mlp" or "dots" (``transformer.remat_policy``).
    With a ``mesh``, ``state`` is ``init_sharded_state``'s (or
    ``models.convert.sharded_state_from_numpy``'s, or ``load_pytree``'s
    with these shardings), and a state whose leaves are not sharded as
    ``state_sh`` (default: ``state_shardings(cfg, mesh)``) says raises; the
    batch's rows are cut over dp x fsdp (the batch size must divide by dp x
    fsdp), each row block moves to its leader device, and the metrics lie
    on the mesh's first device.  ``mesh=None`` ignores ``state_sh``.

    Sequence parallelism: on a mesh with ``sp > 1`` each row's sequence is
    cut over sp as well (``tokens`` and ``targets`` pre-shifted, each
    dividing by sp, as the reference takes them), every device's RoPE
    positions are its shard's global ones, and attention is ring attention
    over each sp group (``ops/ring_attention.py``), whether ``sp_axis``
    names the axis or is None: where it is None the reference's compiler
    gathers the sequence for plain attention instead, which computes the
    same attention.  ``mesh=None`` takes ``sp_axis`` and ignores it, as the
    reference's ``ParallelContext.use_ring`` does.  A mesh with ``pp > 1``
    holds a replica on each pp index, as the reference's step does
    (``parallel/pipeline.py`` is the step that runs stages).

    With ``grad_quant_enabled`` and/or ``zero_sharded_update`` the step is
    ``zero.make_dp_train_step``'s (a dp-only mesh: reduce-scatter, update,
    all-gather, the wire int8 block-scaled under ``grad_quant_enabled``;
    the ZeRO state from ``zero.init_zero_state`` and the update from
    ``opt_spec``).  With both off, ``quant_block``, ``quant_stochastic``
    and ``opt_spec`` are ignored, as the reference ignores them.

    The step carries the reference's accounting: ``batch_sharding`` (the
    batch's ``NamedSharding``; None without a mesh), ``collective_bytes``
    (``{(op, dtype): bytes}`` a device puts on the wire each step: a ring
    all-reduce of the f32 gradients moves twice their bytes when dp x fsdp
    > 1) and ``opt_state_bytes`` (the Adam moments and count a replica
    holds).
    """
    transformer.remat_policy(remat)  # an unknown policy raises now
    if grad_quant_enabled or zero_sharded_update:
        if mesh is None:
            raise ValueError("grad_quant_enabled / zero_sharded_update "
                             "shard over a mesh's dp axis; pass a mesh")
        if device is not None:
            raise ValueError("with a mesh the step runs on the mesh's "
                             "devices; device must be None")
        from . import zero
        return zero.make_dp_train_step(
            cfg, mesh, optimizer, state_sh, compute_dtype=compute_dtype,
            sp_axis=sp_axis, remat=remat, grad_quant=grad_quant_enabled,
            quant_block=quant_block or zero.DEFAULT_BLOCK,
            quant_stochastic=quant_stochastic,
            zero_update=zero_sharded_update, opt_spec=opt_spec)
    if mesh is not None:
        layout = _check_mesh(cfg, mesh, device)
        step = _mesh_train_step(cfg, optimizer, compute_dtype, remat, layout,
                                _sharded_as(cfg, layout, state_sh))
        return _accounted(step, cfg, mesh)
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

    return _accounted(step, cfg, None)


def _accounted(step: Callable, cfg: TransformerConfig, mesh) -> Callable:
    """``step`` with the reference's accounting attributes
    (``ray_tpu/parallel/train_step.py``'s ``make_train_step``): the
    compiler-placed f32 gradient all-reduce over dp x fsdp, counted as a
    ring's two passes, and fully replicated Adam state."""
    dp = 1 if mesh is None else mesh.shape["dp"] * mesh.shape["fsdp"]
    n = cfg.num_params()
    step.batch_sharding = (None if mesh is None else
                           NamedSharding(mesh, shard_rules.batch_spec()))
    step.collective_bytes = ({("all_reduce", "float32"): 2 * n * 4}
                             if dp > 1 else {})
    step.opt_state_bytes = 2 * n * 4 + 8
    return step


def make_eval_step(cfg: TransformerConfig, mesh, state_sh=None,
                   compute_dtype=torch.bfloat16, sp_axis: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Callable:
    """Returns ``eval_fn(params, batch) -> metrics`` (no gradients); with
    a ``mesh``, ``params`` is a sharded state's params, held to
    ``state_sh`` as ``make_train_step`` holds the state, and the batch is
    cut as it cuts it."""
    if mesh is not None:
        layout = _check_mesh(cfg, mesh, device)
        check = _sharded_as(cfg, layout, state_sh)

        @torch.no_grad()
        def mesh_eval(params: Params, batch: Dict[str, Any]):
            check(params)
            _, metrics = transformer.causal_lm_loss(
                params, _row_blocks(batch, layout), cfg,
                compute_dtype=compute_dtype, mesh=layout)
            return metrics

        return mesh_eval
    dev = device_mod.resolve(device)

    @torch.no_grad()
    def eval_fn(params: Params, batch: Dict[str, Any]):
        _, metrics = transformer.causal_lm_loss(
            params, _to_device(batch, dev), cfg, compute_dtype=compute_dtype)
        return metrics

    return eval_fn


def _sharded_as(cfg: TransformerConfig, layout: transformer.MeshLayout,
                state_sh: Optional[TrainState]) -> Callable[[Params], None]:
    """A check that a params tree lies on the layout's mesh, each leaf cut
    as ``state_sh`` (default: ``state_shardings``) says."""
    want = {path: s.spec for path, s in _flat_paths(
        (state_sh or state_shardings(cfg, layout.mesh)).params).items()}

    def check(params: Params) -> None:
        got = _flat_paths(params)
        mesh = next(iter(got.values())).sharding.mesh
        if (mesh.device_list != layout.mesh.device_list
                or mesh.shape != layout.mesh.shape):
            raise ValueError("the state lives on another mesh than the "
                             "step's")
        if {path: leaf.sharding.spec for path, leaf in got.items()} != want:
            raise ValueError("the state's leaves are not sharded as the "
                             "step's state_sh says")
    return check


def _row_blocks(batch: Dict[str, Any], layout: transformer.MeshLayout
                ) -> List[Dict[str, torch.Tensor]]:
    """A numpy batch cut into its tiles (``batch_spec``: the rows over dp
    x fsdp, the sequence over sp), each on its leader's device.  Under sp
    the batch holds pre-shifted ``tokens`` and ``targets`` (a ``tokens``
    [B, S+1] alone is shifted here first, as the reference's loss shifts
    the whole batch)."""
    n_rows, sp = len(layout.rows) // layout.sp, layout.sp
    if sp > 1 and "targets" not in batch:
        batch = {**batch, "tokens": batch["tokens"][:, :-1],
                 "targets": batch["tokens"][:, 1:]}
    rows, seq = next(iter(batch.values())).shape[:2]
    if rows % n_rows:
        raise ValueError(f"dp x fsdp = {n_rows} does not divide the batch's "
                         f"{rows} rows")
    if seq % sp:
        raise ValueError(f"sp = {sp} does not divide the batch's sequence "
                         f"of {seq}")
    w, c = rows // n_rows, seq // sp
    return [_to_device({k: v[r // sp * w:(r // sp + 1) * w,
                             r % sp * c:(r % sp + 1) * c]
                        for k, v in batch.items()}, layout.devices[lead])
            for r, lead in enumerate(layout.leaders)]


def _mesh_train_step(cfg: TransformerConfig, optimizer: Optimizer,
                     compute_dtype, remat, layout: transformer.MeshLayout,
                     check: Callable[[Params], None]) -> Callable:

    def step(state: TrainState, batch: Dict[str, Any]):
        check(state.params)
        total, metrics = transformer.causal_lm_loss(
            state.params, _row_blocks(batch, layout), cfg,
            compute_dtype=compute_dtype, remat=remat, mesh=layout)
        return sharded_update(state, total, metrics, optimizer)

    return step


def sharded_update(state: TrainState, total: torch.Tensor,
                   metrics: Dict[str, torch.Tensor], optimizer: Optimizer):
    """The update of a sharded state from the loss ``total`` over its
    mesh: the gradients of every part, each replicated block's summed over
    its copies, one global norm and clip, AdamW on each device's blocks,
    all in place.  -> (state, metrics with ``grad_norm`` and
    ``total_loss``)."""
    leaves = _leaves(state.params)
    devices = leaves[0].sharding.mesh.device_list
    got = torch.autograd.grad(total, [p for leaf in leaves
                                      for p in leaf.parts],
                              allow_unused=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    with torch.no_grad():
        grads, norms = _sum_copies(leaves, got, devices[0])
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
        mu, nu = _leaves(state.opt_state["mu"]), _leaves(
            state.opt_state["nu"])
        count = state.opt_state["count"].parts
        for i, dev in enumerate(devices):
            optimizer.apply_(
                [g[i] for g in grads], [m.parts[i] for m in mu],
                [v.parts[i] for v in nu], count[i],
                [p.parts[i] for p in leaves], g_norm.to(dev, copy=i > 0))
        for s in state.step.parts:
            s.add_(1)
    metrics["grad_norm"] = g_norm
    metrics["total_loss"] = total.detach()
    return state, metrics


def _sum_copies(leaves: List[Sharded], got, first: torch.device):
    """Each leaf's gradient per device: the sum of the gradients of every
    copy of its block (in device order, on the first copy's device; a copy
    nothing used adds nothing), one tensor per copy.  And the norm of each
    distinct block on ``first``, in leaf and block order."""
    grads, norms, k = [], [], 0
    for leaf in leaves:
        parts = list(got[k:k + len(leaf.parts)])
        k += len(leaf.parts)
        out: List[Optional[torch.Tensor]] = [None] * len(parts)
        for g in leaf.sharding.replica_groups():
            devs = [leaf.parts[j].device for j in g]
            summed = sum_parts([parts[j] for j in g], devs)
            if summed[0] is None:
                summed = [torch.zeros_like(leaf.parts[j]) for j in g]
            for j, t in zip(g, summed):
                out[j] = t
            norms.append(torch.linalg.vector_norm(summed[0]).to(first))
        grads.append(out)
    return grads, norms
