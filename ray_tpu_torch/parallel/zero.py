"""ZeRO-sharded weight update and quantized gradient reduction: the
dp-manual train step.

Counterpart of ``ray_tpu/parallel/zero.py``, with the same names and
arguments.  The default step (``train_step.make_train_step``) sums every
replica's gradients and keeps the full fp32 Adam state on every
data-parallel replica: 8 bytes a parameter each.  Two knobs change that:

* ``zero_update``: the all-reduce becomes reduce-scatter -> the update of
  one shard -> all-gather of the params.  Replica r owns chunk r of the
  flat parameter vector and keeps only that chunk's Adam moments (the
  state is dp times smaller), runs AdamW on it and sends the new params
  to every replica in fp32.  AdamW is elementwise, so the shard update is
  the replicated one restricted to the shard; the one cross-element op,
  the global-norm clip, takes the norm from the shards' square sums.
* ``grad_quant``: the reduce-scatter and (without ZeRO) the all-gather of
  the gradients go int8 block-scaled over the wire
  (``quant_collectives``).

The reference runs the step body in one full-manual ``shard_map`` over a
mesh whose axes other than dp have size 1.  The port runs the same body
over the dp replicas of the port's one-process mesh (``parallel/mesh.py``),
one replica after the other, and moves chunks between their devices
explicitly:

1. each replica differentiates its own loss, the mean over its row block
   (``_row_blocks``), as the reference's body does (the mesh loss, a mean
   over the whole batch, would weigh rows otherwise under a loss mask);
2. its gradients land in one flat f32 buffer in ``ravel_pytree``'s order
   (sorted keys, ``train_step._leaves``), zero-padded to ``npad``, through
   ``.grad`` views of it, so the ravel copies nothing;
3. the buffers are reduce-scattered (chunk r summed in rank order on
   replica r's device) and divided by dp;
4. the global norm is the square root of the shards' square sums, added
   in rank order;
5. ZeRO: each shard is clipped with the reference's select and updated by
   ``Optimizer.adamw_`` with its moment shards; each replica's params are
   views of one flat buffer (``init_zero_state``), so the update writes
   chunk r of replica r's buffer in place and the all-gather copies it
   into every other replica's: the unravel copies nothing either.
   Without ZeRO the mean gradients are all-gathered and every replica
   runs the stock optimizer (clip and AdamW) on its own state;
6. metrics: ``tokens`` summed over dp, the rest averaged, and
   ``grad_norm`` the global norm.

At most one flat gradient per replica is alive at a time, and none
outlives the step.  Stochastic rounding seeds one ``torch.Generator`` per
(step, rank, reduce-scatter or all-gather) from the reference's constant
0x0E0A: the streams are not JAX's, so only their properties carry over (a
rerun is bitwise equal).  It reads the step count on the host, one wait
for the card a step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ..models import sharding as shard_rules
from ..models import transformer
from ..models.config import TransformerConfig
from .mesh import (Mesh, NamedSharding, PartitionSpec as P, Sharded,
                   ordered_sum, reduce_scatter)
from .quant_collectives import (DEFAULT_BLOCK, quantized_all_gather,
                                quantized_psum_scatter)
from .train_step import (Optimizer, TrainState, _flat_paths, _leaves, _map,
                         _replicated_zero, _row_blocks, global_norm,
                         make_optimizer, state_shardings)

__all__ = ["OptimizerSpec", "init_zero_state", "make_dp_train_step",
           "zero_opt_state_bytes"]

#: the reference's base of the stochastic-rounding keys
_SEED = 0x0E0A


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """The hyperparameters behind ``train_step.make_optimizer``, reified.

    The ZeRO step applies the optimizer to a flat shard, so it needs the
    clip and the AdamW stage apart.  ``build()`` returns exactly what
    ``make_optimizer`` returns for the same arguments."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0

    def schedule(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """count -> learning rate (warmup, then cosine decay)."""
        return self.build().schedule

    def adamw(self) -> Callable[..., None]:
        """The elementwise stage (everything but the global-norm clip):
        ``(grads, mu, nu, count, params)`` on leaf lists, in place."""
        return self.build().adamw_

    def build(self) -> Optimizer:
        return make_optimizer(**dataclasses.asdict(self))


def _spans(tree) -> Dict[str, Tuple[int, int]]:
    """path -> (offset, numel) of each leaf in the flat vector, in
    ``ravel_pytree``'s order (sorted keys, ``_leaves``')."""
    out, at = {}, 0

    def rec(t, prefix):
        nonlocal at
        for k in sorted(t):
            if isinstance(t[k], dict):
                rec(t[k], f"{prefix}{k}.")
            else:
                num = math.prod(t[k].shape)
                out[prefix + k] = (at, num)
                at += num
    rec(tree, "")
    return out


def _param_count(cfg: TransformerConfig, param_dtype) -> int:
    shapes = transformer.init_params(None, cfg, dtype=param_dtype)
    return sum(p.numel() for p in _leaves(shapes))


def _padded(n: int, dp: int, block: int) -> int:
    """Flat length padded so both the dp split and the quant blocks tile."""
    unit = dp * block
    return -(-n // unit) * unit


def _validate_mesh(mesh: Mesh) -> int:
    dp = mesh.shape.get("dp", 1)
    extra = {a: s for a, s in mesh.shape.items() if a != "dp" and s > 1}
    if extra:
        raise ValueError(
            "grad_quant/zero_sharded_update shard over the dp axis only; "
            f"mesh has non-trivial axes {extra}")
    return dp


def zero_opt_state_bytes(cfg: TransformerConfig, mesh: Mesh,
                         quant_block: int = DEFAULT_BLOCK,
                         param_dtype=torch.float32) -> int:
    """Per-replica resident optimizer-state bytes under the ZeRO split
    (Adam mu+nu fp32 shards + counters)."""
    dp = mesh.shape.get("dp", 1)
    npad = _padded(_param_count(cfg, param_dtype), dp, quant_block)
    return 2 * (npad // dp) * 4 + 8


def _flat_replicas(mesh: Mesh, npad: int, dtype, spans):
    """One zeroed flat buffer [npad] per dp replica, and ``place(path,
    leaf)``: the leaf copied into every replica's buffer at its offset,
    returned as a replicated ``Sharded`` of views that require grad."""
    rep = NamedSharding(mesh, P())
    flats = [torch.zeros(npad, dtype=dtype, device=d)
             for d in mesh.device_list]

    def place(path, leaf):
        off, num = spans[path]
        views = []
        for flat in flats:
            v = flat[off:off + num].view(leaf.shape)
            v.copy_(leaf)
            views.append(v.requires_grad_(True))
        return Sharded(views, rep)
    return flats, place


def _zero_shardings(params_tree, mesh: Mesh) -> TrainState:
    rep = NamedSharding(mesh, P())
    split = NamedSharding(mesh, P("dp"))
    return TrainState(params=_map(lambda _: rep, params_tree),
                      opt_state={"mu": split, "nu": split, "count": rep},
                      step=rep)


def _moments(mesh: Mesh, npad: int) -> Sharded:
    """A flat f32 [npad] of zeros split P("dp"): each device makes only
    its own npad/dp chunk."""
    dp = mesh.shape["dp"]
    return Sharded([torch.zeros(npad // dp, dtype=torch.float32, device=d)
                    for d in mesh.device_list],
                   NamedSharding(mesh, P("dp")))


def init_zero_state(cfg: TransformerConfig, mesh: Mesh,
                    opt_spec: Optional[OptimizerSpec] = None, *,
                    quant_block: int = DEFAULT_BLOCK, seed: int = 0,
                    param_dtype=torch.float32) -> Tuple[TrainState,
                                                        TrainState]:
    """TrainState for the ZeRO step -> (state, shardings): params
    replicated (``P()``), drawn from ``seed`` as ``init_sharded_state``
    draws them, each replica's leaves views of one flat buffer [npad] in
    ``ravel_pytree`` order; the optimizer state a flat fp32 mu and nu
    [npad] split ``P("dp")`` (each device holds its npad/dp chunk) and
    the count, replicated.  mu = nu = 0 and count = 0, as the replicated
    path's ``optimizer.init``."""
    del opt_spec  # AdamW's state has one structure whatever its settings
    dp = _validate_mesh(mesh)
    shapes = transformer.init_params(None, cfg, dtype=param_dtype)
    spans = _spans(shapes)
    npad = _padded(sum(num for _, num in spans.values()), dp, quant_block)
    _, place = _flat_replicas(mesh, npad, param_dtype, spans)
    gen = torch.Generator(device=mesh.device_list[0]).manual_seed(seed)
    params = transformer.init_params(gen, cfg, dtype=param_dtype,
                                     place=place)
    sh = _zero_shardings(params, mesh)
    state = TrainState(
        params=params,
        opt_state={"mu": _moments(mesh, npad), "nu": _moments(mesh, npad),
                   "count": _replicated_zero(sh.opt_state["count"])},
        step=_replicated_zero(sh.step))
    return state, sh


def collective_bytes_per_step(cfg: TransformerConfig, mesh: Mesh, *,
                              grad_quant: bool, zero_update: bool,
                              quant_block: int = DEFAULT_BLOCK,
                              param_dtype=torch.float32
                              ) -> Dict[Tuple[str, str], int]:
    """Per-device wire bytes each step puts on the dp axis, by (op,
    dtype): flipping grad_quant moves the reduce bytes from float32 to
    int8 plus a small float32 scale stream."""
    dp = mesh.shape.get("dp", 1)
    if dp <= 1:
        return {}
    npad = _padded(_param_count(cfg, param_dtype), dp, quant_block)
    out: Dict[Tuple[str, str], int] = {}

    def add(op, dtype, nbytes):
        out[(op, dtype)] = out.get((op, dtype), 0) + nbytes

    if grad_quant:  # grads: int8 payload + fp32 scale stream
        add("reduce_scatter", "int8", npad)
        add("reduce_scatter", "float32", npad // quant_block * 4)
    else:
        add("reduce_scatter", "float32", npad * 4)
    if zero_update:
        # updated params all-gather fp32: weights stay lossless everywhere
        add("all_gather", "float32", npad * 4)
    elif grad_quant:
        add("all_gather", "int8", npad)
        add("all_gather", "float32", npad // quant_block * 4)
    else:
        add("all_gather", "float32", npad * 4)
    return out


def _flat_params(leaves: List[Sharded], i: int, spans: List[Tuple[int, int]],
                 npad: int) -> torch.Tensor:
    """Replica i's params as one flat buffer [npad]: the buffer its leaves
    view (``init_zero_state``'s layout), or else a new one that each leaf
    is copied into and replaced by its view (a state converted or loaded
    leaf by leaf), once."""
    parts = [leaf.parts[i] for leaf in leaves]
    base = parts[0]._base
    if (base is not None and base.numel() == npad and base.dim() == 1
            and all(p._base is base and p.is_contiguous()
                    and p.storage_offset() - base.storage_offset() == off
                    for p, (off, _) in zip(parts, spans))):
        return base
    flat = torch.zeros(npad, dtype=parts[0].dtype, device=parts[0].device)
    for leaf, p, (off, num) in zip(leaves, parts, spans):
        v = flat[off:off + num].view(p.shape)
        v.copy_(p.detach())
        leaf.parts[i] = v.requires_grad_(True)
    return flat


def _checker(state_sh: TrainState, mesh: Mesh, zero_update: bool,
             shard_len: int) -> Callable[[TrainState], None]:
    """A check that a state lies on ``mesh``, its params sharded as
    ``state_sh`` says, its moments the arm's: ZeRO's flat shards, or a
    tree like the params."""
    want = {path: s.spec for path, s in _flat_paths(state_sh.params).items()}

    def check(state: TrainState) -> None:
        got = _flat_paths(state.params)
        for leaf in got.values():
            m = leaf.sharding.mesh
            if m.device_list != mesh.device_list or m.shape != mesh.shape:
                raise ValueError("the state lives on another mesh than the "
                                 "step's")
        mu = state.opt_state["mu"]
        flat = isinstance(mu, Sharded)
        if flat != zero_update or (flat and mu.parts[0].numel() != shard_len):
            raise ValueError("the ZeRO step takes init_zero_state's state, "
                             "the grad_quant step init_sharded_state's")
        if {path: leaf.sharding.spec for path, leaf in got.items()} != want:
            raise ValueError("the state's leaves are not sharded as the "
                             "step's state_sh says")
    return check


def make_dp_train_step(cfg: TransformerConfig, mesh: Mesh,
                       optimizer: Optional[Optimizer],
                       state_sh: Optional[TrainState],
                       compute_dtype=torch.bfloat16,
                       sp_axis: Optional[str] = None,
                       remat: Union[bool, str, None] = True, *,
                       grad_quant: bool = False,
                       quant_block: int = DEFAULT_BLOCK,
                       quant_stochastic: bool = False,
                       zero_update: bool = False,
                       opt_spec: Optional[OptimizerSpec] = None,
                       param_dtype=torch.float32) -> Callable:
    """The dp-manual ``step(state, batch) -> (state, metrics)``.

    Drop-in for ``make_train_step`` when grad_quant and/or zero_update is
    on.  ``optimizer`` drives the update of the non-ZeRO arm (state from
    ``init_sharded_state``); the ZeRO arm uses ``opt_spec`` (state from
    ``init_zero_state``), because the update applies to a flat shard.
    ``state_sh`` (default: the arm's own) is what the state's leaves must
    be sharded as.  The batch (numpy, as ``make_train_step`` takes it) is
    cut over dp; the state is updated in place and returned; the metrics
    are 0-d tensors on the mesh's first device."""
    if sp_axis is not None and mesh.shape.get(sp_axis, 1) > 1:
        raise ValueError("sequence parallelism doesn't compose with the "
                         "dp-manual step; use the default train step")
    dp = _validate_mesh(mesh)
    if zero_update:
        opt_spec = opt_spec or OptimizerSpec()
    elif optimizer is None:
        raise ValueError("grad_quant without zero_update updates with the "
                         "stock optimizer; pass it")
    transformer.remat_policy(remat)  # an unknown policy raises now
    shapes = transformer.init_params(None, cfg, dtype=param_dtype)
    spans = list(_spans(shapes).values())
    n = sum(num for _, num in spans)
    npad = _padded(n, dp, quant_block)
    shard_len = npad // dp
    layout = transformer.MeshLayout(mesh)
    devices = mesh.device_list
    first = devices[0]
    check = _checker(state_sh or (_zero_shardings(shapes, mesh)
                                  if zero_update
                                  else state_shardings(cfg, mesh)),
                     mesh, zero_update, shard_len)
    adamw = opt_spec.adamw() if zero_update else None

    def generators(step_no: int, which: int):
        if not quant_stochastic:
            return None
        return [torch.Generator(device=d).manual_seed(
            ((_SEED * 1_000_003 + step_no) * 1_000_003 + r) * 2 + which)
            for r, d in enumerate(devices)]

    def local_grads(state: TrainState, blocks, leaves: List[Sharded]):
        """Each replica's loss on its rows and its gradients in one flat
        f32 buffer [npad], one replica after the other."""
        flat_g, metrics = [], []
        for i, dev in enumerate(devices):
            ps = [leaf.parts[i] for leaf in leaves]
            g = torch.zeros(npad, dtype=param_dtype, device=dev)
            for p, (off, num) in zip(ps, spans):
                p.grad = g[off:off + num].view(p.shape)
            total, m = transformer.causal_lm_loss(
                _map(lambda s, i=i: s.parts[i], state.params), blocks[i],
                cfg, compute_dtype=compute_dtype, remat=remat)
            total.backward(inputs=ps)
            for p in ps:
                p.grad = None
            m = {k: v.detach() for k, v in m.items()}
            m["total_loss"] = total.detach()
            metrics.append(m)
            flat_g.append(g.float())
        return flat_g, metrics

    def step(state: TrainState, batch: Dict[str, Any]):
        check(state)
        leaves = _leaves(state.params)
        blocks = _row_blocks(batch, layout)
        flat_p = ([_flat_params(leaves, i, spans, npad) for i in range(dp)]
                  if zero_update else None)
        step_no = int(state.step.parts[0]) if quant_stochastic else 0
        flat_g, local = local_grads(state, blocks, leaves)
        with torch.no_grad():
            # local grads are local-batch means; sum / dp = the global mean
            if grad_quant:
                shards = quantized_psum_scatter(
                    flat_g, block=quant_block, stochastic=quant_stochastic,
                    generator=generators(step_no, 0))
            else:
                shards = reduce_scatter(flat_g, 0)
            del flat_g
            shards = [s.div_(dp) for s in shards]
            gnorm = torch.sqrt(ordered_sum(
                [torch.sum(s * s).to(first) for s in shards]))
            if zero_update:
                zero_update_(state, shards, gnorm, flat_p)
            else:
                replicated_update_(state, shards, leaves,
                                   generators(step_no, 1))
            for s in state.step.parts:
                s.add_(1)
            metrics = {}
            for k in local[0]:
                total = ordered_sum([m[k].to(first) for m in local])
                metrics[k] = total if k == "tokens" else total / dp
            metrics["grad_norm"] = gnorm
        return state, metrics

    def zero_update_(state, shards, gnorm, flat_p):
        """Each replica's shard clipped and stepped by AdamW with its
        moment shards, then copied into every other replica's params."""
        mu, nu = state.opt_state["mu"].parts, state.opt_state["nu"].parts
        count = state.opt_state["count"].parts
        for r, g in enumerate(shards):
            gn = gnorm.to(g.device)
            # optax.clip_by_global_norm, shard-wise: the same select
            g = torch.where(gn < opt_spec.grad_clip, g,
                            (g / gn) * opt_spec.grad_clip)
            sl = slice(r * shard_len, (r + 1) * shard_len)
            own = flat_p[r][sl]
            p32 = own.float()
            adamw([g], [mu[r]], [nu[r]], count[r], [p32])
            if p32 is not own:
                own.copy_(p32)
            # the all-gather of the new params, lossless
            for j, flat in enumerate(flat_p):
                if j != r:
                    flat[sl].copy_(own)

    def replicated_update_(state, shards, leaves, gens):
        """The mean gradients all-gathered to every replica, which runs
        the stock optimizer (clip and AdamW) on its own state."""
        if grad_quant:
            full = quantized_all_gather(shards, block=quant_block,
                                        stochastic=quant_stochastic,
                                        generator=gens)
        else:
            full = [torch.cat([s.to(d) for s in shards]) for d in devices]
        mu, nu = _leaves(state.opt_state["mu"]), _leaves(state.opt_state["nu"])
        count = state.opt_state["count"].parts
        for i, flat in enumerate(full):
            ps = [leaf.parts[i] for leaf in leaves]
            grads = [flat[off:off + num].view(p.shape).to(p.dtype)
                     for p, (off, num) in zip(ps, spans)]
            optimizer.apply_(grads, [m.parts[i] for m in mu],
                             [v.parts[i] for v in nu], count[i], ps,
                             global_norm(grads))

    step.batch_sharding = NamedSharding(mesh, P(shard_rules.BATCH_AXES, None))
    step.collective_bytes = collective_bytes_per_step(
        cfg, mesh, grad_quant=grad_quant, zero_update=zero_update,
        quant_block=quant_block, param_dtype=param_dtype)
    step.opt_state_bytes = (
        zero_opt_state_bytes(cfg, mesh, quant_block, param_dtype)
        if zero_update else 2 * n * 4 + 8)
    return step
