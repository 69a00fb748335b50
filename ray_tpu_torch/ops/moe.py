"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Counterpart of ``ray_tpu/ops/moe.py``, with the same semantics:
* router logits are ``tokens @ router_w`` in the tokens' dtype, the softmax
  runs in f32, the top-k takes the lower expert index on a tie (as
  ``lax.top_k`` does) and its weights are renormalised with
  ``max(sum, 1e-9)``;
* every expert takes at most ``capacity = max(1, int(capacity_factor * k *
  b * s / E))`` tokens.  A (token, choice) pair's position in its expert's
  buffer counts the earlier tokens (row-major over ``b * s``) that made the
  same choice, plus the tokens earlier choices admitted to that expert:
  choice 0 is filled for every token before choice 1.  A pair whose
  position is ``>= capacity`` is dropped, so which tokens are dropped
  depends on every row of the call's batch;
* the aux loss is ``E * sum(mean(probs) * mean(onehot(choice 0)))``.

The JAX package dispatches and combines with einsums against one-hot
``[T, E, C]`` tensors, which keeps XLA's shapes static.  ``moe_mlp`` here
works on indices instead: routing gives each (token, choice) its buffer
slot, the dispatch writes the kept tokens' rows into an ``[E, C, H]``
buffer (a slot nobody fills stays zero, and SwiGLU without bias maps a zero
row to zero), the three expert products are batched matmuls, and the
combine gathers ``[T, k, H]`` rows and sums them with the routing weights,
cast to the compute dtype first as the reference casts its combine tensor.
It never builds ``[T, E, C]`` (671 M entries at one 8 x 2048 prefill batch
of Mixtral, and 5.5 TFLOP per one-hot einsum).  ``moe_mlp_onehot`` keeps
the reference's einsums as the plain version that tests hold it against.

The JAX package has no Pallas kernel here (XLA fuses its einsums), so
neither has the port: the products are library matmuls, as the reference's
are.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F


class Routing(NamedTuple):
    """Where each (token, choice) pair goes; every field is [T, k] but
    ``aux``."""
    expert: torch.Tensor    # int64 expert index
    slot: torch.Tensor      # int64 expert * C + position in its buffer
    kept: torch.Tensor      # bool: position < C
    weight: torch.Tensor    # f32 renormalised top-k prob, 0 where dropped
    aux: torch.Tensor       # f32 load-balancing loss, 0-d


def capacity(capacity_factor: float, k: int, b: int, s: int, e: int) -> int:
    """Slots per expert, as the reference computes it in Python floats."""
    return max(1, int(capacity_factor * k * b * s / e))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, and on a tie
    the lower index first (a stable sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _choices(router_logits: torch.Tensor, k: int):
    """router_logits [T, E] -> (the renormalised top-k probs [T, k] f32,
    their experts [T, k], the aux loss)."""
    e = router_logits.shape[-1]
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, top_idx = _top_k(probs, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # load-balancing aux loss (Switch Transformer style)
    me = probs.mean(0)                                  # mean router prob
    ce = F.one_hot(top_idx[:, 0], e).float().mean(0)    # fraction routed
    return top_p, top_idx, e * torch.sum(me * ce)


def route(router_logits: torch.Tensor, k: int, cap: int) -> Routing:
    """router_logits [T, E] -> each (token, choice)'s expert, buffer slot,
    kept flag and weight, and the aux loss."""
    e = router_logits.shape[-1]
    top_p, top_idx, aux = _choices(router_logits, k)
    experts = torch.arange(e, device=top_idx.device)[:, None]
    counts = torch.zeros((e, 1), dtype=torch.int32, device=top_idx.device)
    pos = []
    for choice in range(k):
        # [E, T], scanned along the tokens (a scan along the outer axis of
        # [T, E] runs one thread per expert on the card)
        onehot = (top_idx[:, choice] == experts).int()
        prior = onehot.cumsum(1, dtype=torch.int32) - onehot
        p = (onehot * (prior + counts)).sum(0)                    # [T]
        pos.append(p)
        counts = counts + (onehot * (p < cap)).sum(1, keepdim=True,
                                                   dtype=torch.int32)
    pos = torch.stack(pos, 1)
    kept = pos < cap
    return Routing(top_idx, top_idx * cap + pos, kept, top_p * kept, aux)


def _top_k_by_argmax(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis as k rounds of ``argmax``, which
    returns the first of equal maxima (the lower index), each round masking
    out what it took: the plain version's own top-k, independent of
    ``_top_k``'s sort."""
    left = probs.clone()
    idx = []
    for _ in range(k):
        i = left.argmax(-1, keepdim=True)
        idx.append(i)
        left.scatter_(-1, i, -1.0)          # probs are >= 0
    idx = torch.cat(idx, -1)
    return probs.gather(-1, idx), idx


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """router_logits [T, E] -> (dispatch [T, E, C] f32, combine [T, E, C]
    f32, aux_loss): the reference's loop over choices on one-hot tensors,
    the plain version of ``route`` (sharing none of its code).
    ``moe_mlp`` never builds these."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, top_idx = _top_k_by_argmax(probs, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    aux = e * torch.sum(probs.mean(0)
                        * F.one_hot(top_idx[:, 0], e).float().mean(0))
    dev = top_idx.device
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=torch.int64, device=dev)
    slots = torch.arange(capacity, device=dev)
    for choice in range(k):
        onehot = F.one_hot(top_idx[:, choice], e)                 # [T, E]
        prior = onehot.cumsum(0) - onehot
        pos = (onehot * (prior + counts[None, :])).sum(-1)        # [T]
        ok = pos < capacity
        # jax.nn.one_hot(pos, C): all zeros where pos >= C
        disp = (onehot.float()[:, :, None]
                * (pos[:, None] == slots).float()[:, None, :]
                * ok.float()[:, None, None])
        dispatch = dispatch + disp
        combine = combine + disp * top_p[:, choice][:, None, None]
        counts = counts + (onehot * ok[:, None]).sum(0)
    return dispatch, combine, aux


def experts(xs: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: xs [E, C, H] -> [E, C, H] in xs's dtype."""
    dt = xs.dtype
    act = F.silu(torch.bmm(xs, w_gate.to(dt))) * torch.bmm(xs, w_in.to(dt))
    return torch.bmm(act, w_out.to(dt))


def moe_route(x: torch.Tensor, router_w: torch.Tensor,
              experts_per_token: int, capacity_factor: float
              ) -> Tuple[int, Routing]:
    """Routing of x [B, S, H] through router_w [H, E]: (the capacity, every
    (token, choice) pair's ``Routing``)."""
    b, s, h = x.shape
    cap = capacity(capacity_factor, experts_per_token, b, s,
                   router_w.shape[-1])
    tokens = x.reshape(b * s, h)
    return cap, route(tokens @ router_w.to(tokens.dtype), experts_per_token,
                      cap)


def dispatch(x: torch.Tensor, dest: torch.Tensor, e: int, cap: int
             ) -> torch.Tensor:
    """x [B, S, H] into an [e, cap, H] buffer: each (token, choice) pair's
    token row into its row ``dest`` [T, k]; pairs with ``dest == e * cap``
    all land in one spare row past the buffer, which is cut off.  A row no
    pair fills stays zero."""
    b, s, h = x.shape
    tokens = x.reshape(b * s, h)
    xs = tokens.new_zeros((e * cap + 1, h)).index_put(
        (dest,), tokens[:, None, :].expand(-1, dest.shape[1], -1))
    return xs[:-1].view(e, cap, h)


def combine(out_e: torch.Tensor, src: torch.Tensor, weight: torch.Tensor,
            lead: Tuple[int, int]) -> torch.Tensor:
    """Each token's sum of its pairs' expert rows ``src`` [T, k] of out_e
    [E, C, H], weighted by ``weight`` [T, k] (cast to out_e's dtype first,
    as the reference casts its combine tensor; summed in f32) -> [*lead,
    H].  A pair that adds nothing reads any row with weight 0."""
    h = out_e.shape[-1]
    rows = out_e.reshape(-1, h)[src]
    wts = weight.to(out_e.dtype).float()
    out = (rows.float() * wts[..., None]).sum(1).to(out_e.dtype)
    return out.view(*lead, h)


def moe_experts(x: torch.Tensor, r: Routing, cap: int, w_gate: torch.Tensor,
                w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on x [B, S, H] routed by ``r``, combined with the
    routing weights -> [B, S, H].  The result is linear in ``w_out``'s
    rows: experts split on M (tensor parallelism) give partial sums of it."""
    b, s, _ = x.shape
    e = w_gate.shape[0]
    xs = dispatch(x, torch.where(r.kept, r.slot, e * cap), e, cap)
    out_e = experts(xs, w_gate, w_in, w_out)
    # a dropped pair reads slot 0 with weight 0
    return combine(out_e, torch.where(r.kept, r.slot, 0), r.weight, (b, s))


def route_rows(logits: Sequence[torch.Tensor], k: int, cap: int) -> Routing:
    """The row blocks' router logits ([b_i, S, E] each, in batch order)
    routed once, as one batch, on the first block's device: the global
    capacity and the positions counted over every block's tokens."""
    first = logits[0]
    flat = torch.cat([lg.reshape(-1, lg.shape[-1]).to(first.device)
                      for lg in logits])
    return route(flat, k, cap)


def local_slots(r: Routing, cap: int, e0: int, e_loc: int, c_pad: int):
    """For the experts [e0, e0 + e_loc) of one expert shard, whose buffer
    holds ``c_pad >= cap`` rows an expert: (each pair's row there, or
    ``e_loc * c_pad`` for a pair the shard does not compute; each pair's
    row to read back, 0 for those; whether the shard computes the pair)."""
    here = r.kept & (r.expert >= e0) & (r.expert < e0 + e_loc)
    row = (r.expert - e0) * c_pad + (r.slot - r.expert * cap)
    return (torch.where(here, row, e_loc * c_pad), torch.where(here, row, 0),
            here)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_in: torch.Tensor, w_out: torch.Tensor, experts_per_token: int,
            capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse SwiGLU MLP. x: [B, S, H]; router_w: [H, E]; w_gate/w_in:
    [E, H, M]; w_out: [E, M, H].  Returns (out [B, S, H], aux_loss)."""
    cap, r = moe_route(x, router_w, experts_per_token, capacity_factor)
    return moe_experts(x, r, cap, w_gate, w_in, w_out), r.aux


def moe_mlp_onehot(x: torch.Tensor, router_w: torch.Tensor,
                   w_gate: torch.Tensor, w_in: torch.Tensor,
                   w_out: torch.Tensor, experts_per_token: int,
                   capacity_factor: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's formulation, einsum for einsum against the one-hot
    dispatch and combine tensors: the plain version ``moe_mlp`` is held
    against; of its code it shares only ``capacity``."""
    b, s, h = x.shape
    e = router_w.shape[-1]
    tokens = x.reshape(b * s, h)
    cap = capacity(capacity_factor, experts_per_token, b, s, e)
    logits = tokens @ router_w.to(tokens.dtype)
    dispatch, combine, aux = top_k_routing(logits, experts_per_token, cap)
    xs = torch.einsum("tec,th->ech", dispatch.to(tokens.dtype), tokens)
    gate = torch.einsum("ech,ehm->ecm", xs, w_gate.to(xs.dtype))
    up = torch.einsum("ech,ehm->ecm", xs, w_in.to(xs.dtype))
    act = F.silu(gate) * up
    out_e = torch.einsum("ecm,emh->ech", act, w_out.to(act.dtype))
    out = torch.einsum("tec,ech->th", combine.to(out_e.dtype), out_e)
    return out.reshape(b, s, h), aux
