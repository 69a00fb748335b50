"""Pipeline parallelism: the GPipe and the interleaved schedule over a mesh's
``pp`` axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``, with its entry points and
arguments.  The reference runs the whole pipeline inside one SPMD program
under ``shard_map``; the port runs it in one process over the mesh's
devices:

* the stacked layer params [L, ...] are reshaped to [P, V*Lc, ...]
  (``partition_layers``) and their stage dimension is cut over ``pp``:
  stage p holds its layers on ``mesh.devices[p]``, a sub-mesh with the
  dp x fsdp x sp x tp axes, and runs them with the mesh train step's
  layer (``models/transformer.py``'s ``_mesh_block``), so a stage is
  sharded over every axis the mesh step shards over; the embedding, the
  final norm and the head are replicated over pp (their gradients are
  summed over the copies, as the reference's in-spec transposes psum
  them);
* the schedules are static tick loops: at each tick every stage runs its
  resident microbatch, then the activations move one hop along the pp
  ring (``mesh.ring_shift``).  GPipe runs ``M + P - 1`` ticks; the
  interleaved schedule (``virtual_stages`` V > 1, Megatron-style: device d
  owns layer chunks d, P+d, 2P+d, ...) runs ``(M/P)·V·P + P - 1`` ticks
  with the reference's resident arithmetic.  Autograd over the loop gives
  the reverse schedule;
* every stage rematerialises each layer in full, as ``_stage_apply`` does
  whatever the remat policy;
* the loss is the last stage's (``_final_stage_loss``): final norm, head
  and cross entropy over every microbatch, averaged over all tokens.

Bubble ticks: a tick whose resident is no microbatch computes nothing the
loss reads, so the port skips it, which is exact, with one exception.
The reference's GPipe sums the MoE aux loss of *every* tick, bubble ticks
included, and at the drain stage 0 runs on the last stage's wrapped real
output, so for an MoE config the bubble ticks add to ``moe_aux`` and send
gradient into real activations (ROADMAP C7, a property of the reference):
for an MoE config under GPipe the port runs the bubble ticks too, carries
and all, and matches it.  The interleaved schedule masks its aux by the
resident's validity, so its bubble ticks are skipped for every config.

MoE routes per microbatch and per dp and sp shard (the reference runs the
block inside ``shard_map`` with dp and sp manual, fsdp and tp automatic),
not over the whole batch as the mesh step does.  The reference leaves
``ep`` out of its pipeline specs; the port refuses ``ep > 1`` here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import remat as rm
from ..models import sharding as shard_rules
from ..models import transformer
from ..models.config import TransformerConfig
from .mesh import (Mesh, NamedSharding, PartitionSpec, Sharded,
                   named_sharding, ordered_sum, ring_shift, split)
from .train_step import (Optimizer, TrainState, _flat_paths, _map,
                         _replicated_zero, _to_device, sharded_update)

Params = Dict[str, Any]
_FULL_REMAT = rm.SavePolicy()


def partition_layers(params: Params, num_stages: int,
                     virtual_stages: int = 1) -> Params:
    """Reshape every stacked-layer leaf [L, ...] -> [P, V*Lc, ...] (torch
    tensors or numpy arrays).

    With ``virtual_stages`` V > 1 the assignment is INTERLEAVED
    (Megatron-style): device d owns chunks d, P+d, 2P+d, … of the V*P
    total chunks, so layers [L] -> [V, P, Lc] -> transpose -> [P, V, Lc]
    -> flatten the local dims to [P, V*Lc]."""
    def fix(x):
        n_layers = x.shape[0]
        assert n_layers % (num_stages * virtual_stages) == 0, \
            (n_layers, num_stages, virtual_stages)
        lc = n_layers // (num_stages * virtual_stages)
        tail = tuple(x.shape[1:])
        if virtual_stages == 1:
            return x.reshape(num_stages, lc, *tail)
        x = x.reshape(virtual_stages, num_stages, lc, *tail).swapaxes(0, 1)
        return x.reshape(num_stages, virtual_stages * lc, *tail)
    return {**params, "blocks": _map(fix, params["blocks"])}


def merge_layers(params: Params, virtual_stages: int = 1) -> Params:
    """Inverse of partition_layers."""
    def fix(x):
        p_, vl = x.shape[0], x.shape[1]
        tail = tuple(x.shape[2:])
        if virtual_stages == 1:
            return x.reshape(p_ * vl, *tail)
        lc = vl // virtual_stages
        x = x.reshape(p_, virtual_stages, lc, *tail).swapaxes(0, 1)
        return x.reshape(p_ * vl, *tail)
    return {**params, "blocks": _map(fix, params["blocks"])}


def pipeline_param_specs(cfg: TransformerConfig,
                         auto_axes: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """PartitionSpec tree for stage-partitioned params: blocks get a
    leading pp stage dim; embed/head/final-norm replicated across stages.
    ``auto_axes`` keeps those mesh axes from the logical specs (the
    state's sharding keeps tp and fsdp where they are > 1); with the
    default empty tuple everything but pp is replicated."""
    base = shard_rules.logical_param_specs(cfg)

    def keep(d):
        return d if d in auto_axes else None

    def add_stage_dim(spec):
        return PartitionSpec("pp", *[keep(d) for d in spec])

    def outer(spec):
        return PartitionSpec(*[keep(d) for d in spec])

    return {k: _map(add_stage_dim if k == "blocks" else outer, v)
            if isinstance(v, dict) else outer(v) for k, v in base.items()}


def _auto_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("tp", "fsdp") if mesh.shape[a] > 1)


def pp_state_shardings(cfg: TransformerConfig, mesh: Mesh) -> TrainState:
    """The ``NamedSharding`` tree of a staged TrainState: params as
    ``pipeline_param_specs(cfg, auto_axes=(tp, fsdp where > 1))``, the adam
    moments like their params, the counts replicated."""
    param_sh = named_sharding(
        mesh, pipeline_param_specs(cfg, auto_axes=_auto_axes(mesh)))
    rep = NamedSharding(mesh, PartitionSpec())
    return TrainState(params=param_sh,
                      opt_state={"mu": param_sh, "nu": param_sh,
                                 "count": rep}, step=rep)


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------

class _Stages:
    """Stage p of a mesh: the sub-mesh ``mesh.devices[p]`` with its
    ``MeshLayout`` (MoE routing per dp and sp shard), and views of a
    staged params tree on it."""

    def __init__(self, cfg: TransformerConfig, mesh: Mesh,
                 virtual_stages: int):
        if mesh.shape["ep"] > 1:
            raise ValueError("the pipeline does not shard experts (the "
                             "reference's pipeline specs leave ep out); "
                             "use a mesh with ep=1")
        self.cfg, self.mesh = cfg, mesh
        self.P, self.V = mesh.shape["pp"], virtual_stages
        if cfg.num_layers % (self.P * self.V):
            raise ValueError(f"pp x virtual_stages = {self.P * self.V} does "
                             f"not divide {cfg.num_layers} layers")
        self.meshes = [Mesh(mesh.devices[p:p + 1], mesh.axis_names)
                       for p in range(self.P)]
        self.layouts = [transformer.MeshLayout(m, route_axes=("fsdp",))
                        for m in self.meshes]
        self.n = len(self.layouts[0].devices)

    def view(self, leaf: Sharded, p: int) -> Sharded:
        """Stage p's blocks of a staged leaf, on stage p's sub-mesh (a
        block leaf loses its stage dimension)."""
        spec = tuple(leaf.sharding.spec)
        parts = leaf.parts[p * self.n:(p + 1) * self.n]
        if spec[:1] == ("pp",):
            parts, spec = [x[0] for x in parts], spec[1:]
        return Sharded(parts, NamedSharding(self.meshes[p],
                                            PartitionSpec(*spec)))

    def params(self, params: Params, p: int) -> Params:
        return _map(lambda leaf: self.view(leaf, p), params)

    def runner(self, params: Params, p: int, positions) -> Callable:
        """``run(chunk, xs) -> (xs, aux)``: stage p's layer chunk (0 ..
        V-1) on its devices' activations, each layer rematerialised in
        full; aux is the chunk's summed MoE aux loss (None without MoE)."""
        view = self.params(params["blocks"], p)
        lc = self.cfg.num_layers // (self.P * self.V)
        layers = self.layouts[p].layers(view, self.V * lc)
        specs = {path: leaf.sharding.spec[1:] for path, leaf in
                 _flat_paths(view).items()}
        layout, cfg = self.layouts[p], self.cfg
        moe = cfg.num_experts > 1

        def run(chunk: int, xs):
            aux = []
            for lps in layers[chunk * lc:(chunk + 1) * lc]:
                xs, a = transformer._mesh_block(xs, lps, specs, cfg,
                                                positions, _FULL_REMAT,
                                                layout)
                aux.append(a)
            return xs, (ordered_sum(aux) if moe else None)
        return run

    def rotate(self, outs: List[Optional[List[torch.Tensor]]]):
        """Every stage's output one hop along the pp ring (stage p's to
        stage p + 1's devices, the last stage's to stage 0's)."""
        cols = [ring_shift([None if o is None else o[i] for o in outs],
                           [self.layouts[p].devices[i]
                            for p in range(self.P)])
                for i in range(self.n)]
        return [None if outs[(p - 1) % self.P] is None
                else [cols[i][p] for i in range(self.n)]
                for p in range(self.P)]


def _split_batch(batch) -> Tuple[np.ndarray, np.ndarray]:
    b = {k: np.asarray(v) for k, v in batch.items()}
    if "targets" in b:
        return b["tokens"], b["targets"]
    return b["tokens"][:, :-1], b["tokens"][:, 1:]


def _tiles(arr: np.ndarray, layout: transformer.MeshLayout, m: int,
           num_microbatches: int) -> List[torch.Tensor]:
    """Microbatch m's tiles of a [B, S] array, on the layout's leaders:
    the reference's microbatch m of dp shard d is rows [m·mb, (m+1)·mb) of
    the shard's B/dp rows; the port cuts those rows over fsdp and the
    sequence over sp."""
    sh = layout.shape
    b_dp = arr.shape[0] // sh["dp"]
    mb = b_dp // num_microbatches
    w, c = mb // sh["fsdp"], arr.shape[1] // sh["sp"]
    out = []
    for r, lead in enumerate(layout.leaders):
        si, rb = r % sh["sp"], r // sh["sp"]
        d, f = divmod(rb, sh["fsdp"])
        r0 = d * b_dp + m * mb + f * w
        out.append(_to_device({"x": arr[r0:r0 + w, si * c:(si + 1) * c]},
                              layout.devices[lead])["x"])
    return out


def _check_batch(tokens: np.ndarray, layout: transformer.MeshLayout,
                 num_microbatches: int) -> None:
    sh = layout.shape
    b, s = tokens.shape
    if b % sh["dp"] or (b // sh["dp"]) % num_microbatches or (
            (b // sh["dp"] // num_microbatches) % sh["fsdp"]):
        raise ValueError(
            f"the batch's {b} rows do not cut into dp = {sh['dp']} shards "
            f"of {num_microbatches} microbatches, each over fsdp = "
            f"{sh['fsdp']}")
    if s % sh["sp"]:
        raise ValueError(f"sp = {sh['sp']} does not divide the batch's "
                         f"sequence of {s}")


def _final_stage_loss(finals, view: Params, targets: np.ndarray,
                      cfg: TransformerConfig, loss_chunk: Optional[int],
                      layout: transformer.MeshLayout, num_microbatches: int,
                      dev: torch.device) -> torch.Tensor:
    """Loss head shared by both schedules: final norm, head and (chunked)
    cross entropy on the last stage over every microbatch's tiles, the
    NLL summed in (microbatch, tile) order and averaged over all tokens
    (every shard holds as many tokens, so the reference's mean of means
    is the same)."""
    head = (view["embed"]["tokens"] if cfg.tied_embeddings
            else view["lm_head"])
    heads = layout.gather_to(head, layout.leaders)
    sums = []
    for m, xs in enumerate(finals):
        for lead, tgt in zip(layout.leaders,
                             _tiles(targets, layout, m, num_microbatches)):
            x = transformer._norm(xs[lead], transformer._part(
                view["final_norm"], lead), cfg)
            s = x.shape[1]
            chunk = loss_chunk
            if chunk == 0:
                chunk = 512 if s * cfg.vocab_size > 2 ** 25 else None
            w = heads[lead].T if cfg.tied_embeddings else heads[lead]
            nll = transformer._nll(x, w.to(x.dtype), tgt, chunk)
            sums.append(nll.sum().to(dev))
    return ordered_sum(sums) / targets.size


def _check_axes(mesh: Mesh, cfg: TransformerConfig, pp_axis: str,
                dp_axes, sp_axis) -> None:
    if pp_axis != "pp" or tuple(dp_axes) != ("dp", "fsdp") or sp_axis not in (
            "sp", None):
        raise ValueError("the port's mesh names its axes pp, dp, fsdp and "
                         "sp; pass the reference's defaults")
    if mesh.shape["sp"] > 1 and not cfg.use_rope:
        raise ValueError("pp x sp needs RoPE positions (learned positional "
                         "embeddings are not sequence-shard aware)")


def _pipeline_loss(cfg: TransformerConfig, mesh: Mesh, num_microbatches: int,
                   virtual_stages: int, compute_dtype, loss_chunk,
                   schedule: Callable) -> Callable:
    """loss(params_staged, batch) -> (total, metrics) around a schedule
    ``schedule(stages, embed, runners) -> (finals, aux sum)``: ``embed(m)``
    gives microbatch m's embedded tiles on stage 0, ``runners[p](chunk,
    xs)`` runs stage p's layer chunk, and ``finals[m]`` is the last
    stage's output for microbatch m."""
    stages = _Stages(cfg, mesh, virtual_stages)
    first = mesh.device_list[0]
    M = num_microbatches

    def loss_fn(params: Params, batch):
        tokens, targets = _split_batch(batch)
        _check_batch(tokens, stages.layouts[0], M)
        s_loc = tokens.shape[1] // mesh.shape["sp"]
        embed_view = stages.params(params, 0)
        lay0 = stages.layouts[0]

        def embed(m: int):
            return lay0.embed_rows(embed_view, _tiles(tokens, lay0, m, M),
                                   cfg, compute_dtype)

        runners = [stages.runner(params, p,
                                 stages.layouts[p].positions(s_loc))
                   for p in range(stages.P)]
        finals, aux = schedule(stages, embed, runners)
        last = stages.P - 1
        loss = _final_stage_loss(finals, stages.params(params, last),
                                 targets, cfg, loss_chunk,
                                 stages.layouts[last], M, first)
        moe_aux = (torch.zeros((), dtype=torch.float32, device=first)
                   if aux is None else aux.to(first) / (M * stages.P))
        total = loss + 0.01 * moe_aux
        return total, {"loss": loss, "moe_aux_loss": moe_aux,
                       "tokens": torch.full((), tokens.size,
                                            dtype=torch.int32, device=first)}
    return loss_fn


def pipeline_loss_fn(cfg: TransformerConfig, mesh: Mesh,
                     num_microbatches: int, compute_dtype=torch.bfloat16,
                     loss_chunk: Optional[int] = 0, pp_axis: str = "pp",
                     dp_axes: Tuple[str, ...] = ("dp", "fsdp"),
                     sp_axis: Optional[str] = "sp") -> Callable:
    """GPipe: returns ``loss(params_staged, batch) -> (total, metrics)``
    over the mesh's pp stages (params as ``init_pp_state`` gives them,
    batch numpy ``tokens`` [B, S+1] or ``tokens`` and ``targets``, its rows
    cut over dp into microbatches).  ``pp_axis``, ``dp_axes`` and
    ``sp_axis`` are the reference's axis names, which the port's mesh
    fixes; a mesh with sp > 1 runs ring attention in every stage."""
    _check_axes(mesh, cfg, pp_axis, dp_axes, sp_axis)
    M = num_microbatches
    bubbles = cfg.num_experts > 1      # C7: the bubble ticks' aux counts

    def gpipe(stages: _Stages, embed, runners):
        P = stages.P
        acts: List[Optional[List[torch.Tensor]]] = [None] * P
        finals: List[Optional[List[torch.Tensor]]] = [None] * M
        aux = []
        for t in range(M + P - 1):
            outs: List[Optional[List[torch.Tensor]]] = [None] * P
            for p in range(P):
                m = t - p
                if not (0 <= m < M or bubbles):
                    continue
                inp = embed(t) if p == 0 and t < M else acts[p]
                if t == 0 and p == 0:
                    # every other stage's carry at tick 0: zeros
                    zeros = [torch.zeros_like(x) for x in inp]
                if inp is None:
                    inp = [z.to(d) for z, d in
                           zip(zeros, stages.layouts[p].devices)]
                outs[p], a = runners[p](0, inp)
                if a is not None:
                    aux.append(a.to(stages.mesh.device_list[0]))
                if p == P - 1 and 0 <= m < M:
                    finals[m] = outs[p]
                    if not bubbles:
                        outs[p] = None   # read only by bubble ticks
            acts = stages.rotate(outs)
        return finals, (ordered_sum(aux) if aux else None)

    return _pipeline_loss(cfg, mesh, M, 1, compute_dtype, loss_chunk, gpipe)


def interleaved_pipeline_loss_fn(cfg: TransformerConfig, mesh: Mesh,
                                 num_microbatches: int, virtual_stages: int,
                                 compute_dtype=torch.bfloat16,
                                 loss_chunk: Optional[int] = 0,
                                 pp_axis: str = "pp",
                                 dp_axes: Tuple[str, ...] = ("dp", "fsdp"),
                                 sp_axis: Optional[str] = "sp") -> Callable:
    """The interleaved (virtual-stage) schedule, Megatron-style: device d
    owns V layer chunks (global chunks d, P+d, 2P+d, …); a microbatch makes
    V circuits of the pp ring, running one chunk per visit, and
    microbatches inject in waves of P every V·P ticks.  A resident's
    identity is a function of (device, tick), as in the reference: device
    p at tick t holds circuit c = ((t - p) mod VP) // P of the resident
    injected at t0 = t - (c·P + p), microbatch m = (t0 div VP)·P + t0 mod
    VP, valid when t0 >= 0 and m < M."""
    _check_axes(mesh, cfg, pp_axis, dp_axes, sp_axis)
    M, V = num_microbatches, virtual_stages
    P = mesh.shape["pp"]
    assert M % P == 0, \
        (f"interleaved schedule injects waves of P: num_microbatches {M} "
         f"must be a multiple of pp={P}")
    n_ticks = (M // P) * V * P + P - 1

    def interleaved(stages: _Stages, embed, runners):
        VP = V * P
        acts: List[Optional[List[torch.Tensor]]] = [None] * P
        finals: List[Optional[List[torch.Tensor]]] = [None] * M
        aux = []
        for t in range(n_ticks):
            outs: List[Optional[List[torch.Tensor]]] = [None] * P
            for p in range(P):
                c = ((t - p) % VP) // P
                t0 = t - (c * P + p)
                m = (t0 // VP) * P + t0 % VP
                if not (t0 >= 0 and m < M):
                    continue
                inp = embed(m) if p == 0 and c == 0 else acts[p]
                out, a = runners[p](c, inp)
                if a is not None:
                    aux.append(a.to(stages.mesh.device_list[0]))
                if p == P - 1 and c == V - 1:
                    finals[m] = out
                else:
                    outs[p] = out
            acts = stages.rotate(outs)
        return finals, (ordered_sum(aux) if aux else None)

    return _pipeline_loss(cfg, mesh, M, V, compute_dtype, loss_chunk,
                          interleaved)


# ---------------------------------------------------------------------------
# State and step
# ---------------------------------------------------------------------------

def _partition_leaf(x: torch.Tensor, num_stages: int,
                    virtual_stages: int) -> torch.Tensor:
    return partition_layers({"blocks": {"x": x}}, num_stages,
                            virtual_stages)["blocks"]["x"]


def init_pp_state(cfg: TransformerConfig, mesh: Mesh, optimizer: Optimizer,
                  seed: int = 0, param_dtype=torch.float32,
                  virtual_stages: int = 1) -> Tuple[TrainState, TrainState]:
    """A stage-partitioned TrainState on the mesh -> (state, shardings).
    The params are what ``init_sharded_state(cfg, None, ...)`` draws from
    ``seed`` on the mesh's first device, each block leaf partitioned
    (``partition_layers``) and every leaf cut into its devices' blocks as
    soon as it is drawn; the moments start at 0."""
    num_stages = mesh.shape["pp"]
    sh = pp_state_shardings(cfg, mesh)
    at = _flat_paths(sh.params)
    gen = torch.Generator(device=mesh.device_list[0]).manual_seed(seed)

    def place(path, leaf):
        if path.startswith("blocks."):
            leaf = _partition_leaf(leaf, num_stages, virtual_stages)
        return split(leaf, at[path], requires_grad=True)

    params = transformer.init_params(gen, cfg, dtype=param_dtype, place=place)

    def zeros(leaf: Sharded) -> Sharded:
        return Sharded([torch.zeros_like(p) for p in leaf.parts],
                       leaf.sharding)

    state = TrainState(
        params=params,
        opt_state={"mu": _map(zeros, params), "nu": _map(zeros, params),
                   "count": _replicated_zero(sh.opt_state["count"])},
        step=_replicated_zero(sh.step))
    return state, sh


def make_pp_train_step(cfg: TransformerConfig, mesh: Mesh,
                       optimizer: Optimizer, state_sh: Optional[TrainState],
                       num_microbatches: int = 4,
                       compute_dtype=torch.bfloat16,
                       loss_chunk: Optional[int] = 0,
                       virtual_stages: int = 1) -> Callable:
    """``step(state, batch) -> (state, metrics)`` over a mesh with a pp
    axis (and any of dp, fsdp, sp, tp).  ``virtual_stages`` > 1 selects the
    interleaved schedule (the state must be initialised with the same
    value).  The state (``init_pp_state``'s) is updated in place, as the
    mesh step updates its own (``train_step.sharded_update``); a state not
    sharded as ``state_sh`` (default ``pp_state_shardings``) raises.
    Metrics: ``loss``, ``moe_aux_loss``, ``tokens``, ``grad_norm``,
    ``total_loss``, 0-d tensors on the mesh's first device."""
    if virtual_stages > 1:
        loss_fn = interleaved_pipeline_loss_fn(
            cfg, mesh, num_microbatches, virtual_stages, compute_dtype,
            loss_chunk)
    else:
        loss_fn = pipeline_loss_fn(cfg, mesh, num_microbatches,
                                   compute_dtype, loss_chunk)
    want = {path: s.spec for path, s in _flat_paths(
        (state_sh or pp_state_shardings(cfg, mesh)).params).items()}

    def step(state: TrainState, batch):
        got = _flat_paths(state.params)
        if {path: leaf.sharding.spec for path, leaf in got.items()} != want:
            raise ValueError("the state's leaves are not sharded as the "
                             "step's state_sh says")
        if next(iter(got.values())).sharding.mesh.device_list != \
                mesh.device_list:
            raise ValueError("the state lives on another mesh than the "
                             "step's")
        total, metrics = loss_fn(state.params, batch)
        return sharded_update(state, total, metrics, optimizer)

    return step
