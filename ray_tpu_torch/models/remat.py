"""Rematerialization of a transformer layer: what its backward keeps and what
it recomputes, as the JAX package's ``jax.checkpoint`` policies decide it.

The JAX package wraps each layer in ``jax.checkpoint(policy=...)``: a value
the policy saves is kept for the backward, every other value the backward
needs is recomputed from the kept ones, and nothing else runs again (XLA
drops the rest of the replay).  ``torch.utils.checkpoint`` replays a whole
function instead, and its selective policies see kernel launches made
through ``ctypes`` not at all.  So the port writes a layer as a list of
``Step``s over named values and runs its backward itself:

* a ``DOT`` step is one matrix product ``a @ w``; its backward is written
  out (dA = dY·wᵀ, dW = aᵀ·dY) and needs the value ``a``, never the
  product's output;
* a ``LINEAR`` step (bias, RoPE, reshapes, residual adds) has a backward
  that needs no activation, written out as its ``bwd``;
* a ``LOCAL`` step (norms, the MLP's activation, attention) is run under
  autograd in isolation; its graph is kept from the forward when the
  policy saves every residual it holds (``residual_names``), else it is
  run again in the backward from its inputs.

A value needed by the backward is kept when the policy saves it (by name,
or as a product's output under ``dots``) and recomputed otherwise, once,
from its producer step (recursively).  Every policy runs the same steps
with the same backward arithmetic, so on the CPU every policy gives the
gradients of ``remat=False`` bit for bit; only what is kept differs.
``replays`` counts the steps each backward ran again, by step name.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import (Any, Callable, Dict, FrozenSet, List, NamedTuple,
                    Optional, Sequence, Tuple)

import torch

DOT, LINEAR, LOCAL = "dot", "linear", "local"

#: step name -> times a backward ran the step again (recompute or replay)
replays: collections.Counter = collections.Counter()


class Step(NamedTuple):
    name: str
    fn: Callable[..., Any]          # tensors -> a tensor or a tuple of them
    ins: Tuple[str, ...]            # value names (a DOT step: (a, w))
    outs: Tuple[str, ...]
    kind: str = LOCAL
    #: a LINEAR step's backward: output grads -> input grads (None for an
    #: input that gets none)
    bwd: Optional[Callable[..., Sequence[Optional[torch.Tensor]]]] = None
    #: names the residuals of a LOCAL step's graph carry (JAX's
    #: checkpoint_name inside the op); None: the residuals are unnamed
    residual_names: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class SavePolicy:
    """What a layer keeps for its backward (everything else it needs is
    recomputed): the named values ``names``, and with ``dots`` every
    matrix product's output."""
    names: FrozenSet[str] = frozenset()
    dots: bool = False


def base_name(n: str) -> str:
    """A value's name without its device suffix (``"attn_q@3"`` is device
    3's ``"attn_q"``): the name a save policy matches."""
    return n.split("@", 1)[0]


def on_device(steps: Sequence[Step], i: int,
              shared: FrozenSet[str] = frozenset()) -> List[Step]:
    """Device i's copy of a layer's steps: every value name but those in
    ``shared`` gets the suffix ``@i``."""
    def ren(names):
        return tuple(n if n in shared else f"{n}@{i}" for n in names)
    return [st._replace(ins=ren(st.ins), outs=ren(st.outs)) for st in steps]


def dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, ...] @ w -> [B, S, N] in a's dtype (w cast to it)."""
    a2 = a.reshape(a.shape[0] * a.shape[1], -1)
    return (a2 @ w.to(a.dtype)).view(*a.shape[:2], -1)


def _dot_backward(a, w, g):
    wc = w.to(a.dtype)
    a2 = a.reshape(a.shape[0] * a.shape[1], -1)
    g2 = g.reshape(a2.shape[0], -1)
    return (g2 @ wc.t()).view(a.shape), (a2.t() @ g2).to(w.dtype)


def _outs(res) -> Tuple[torch.Tensor, ...]:
    return res if isinstance(res, tuple) else (res,)


def forward(steps: Sequence[Step], values: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Run the steps in order on ``values`` (updated and returned)."""
    for st in steps:
        values.update(zip(st.outs, _outs(st.fn(*(values[n] for n in st.ins)))))
    return values


def run(steps: Sequence[Step], values: Dict[str, torch.Tensor],
        outs: Tuple[str, ...], policy: Optional[SavePolicy]
        ) -> Tuple[torch.Tensor, ...]:
    """The values named ``outs`` of the steps run on ``values`` (the
    layer's input and params), differentiable in every input.  ``policy``
    None keeps everything the backward needs; a ``SavePolicy`` keeps what
    it saves."""
    tensors = list(values.values())
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        vals = forward(steps, dict(values))
        return tuple(vals[n] for n in outs)
    return _Layer.apply(_Plan(steps, tuple(values), outs, policy), *tensors)


class _Plan:
    """The steps, and per policy which graphs and values the forward
    keeps."""

    def __init__(self, steps, inputs, outs, policy):
        self.steps, self.inputs, self.outs = list(steps), inputs, tuple(outs)
        self.producer = {n: i for i, st in enumerate(self.steps)
                         for n in st.outs}
        self.keep_graph = [
            st.kind == LOCAL and (policy is None or (
                st.residual_names is not None and all(
                    n in policy.names for n in st.residual_names)))
            for st in self.steps]
        needed = set()
        for st, keep in zip(self.steps, self.keep_graph):
            if st.kind == DOT:
                needed.update(st.ins)       # a weight may be computed too
            elif st.kind == LOCAL and not keep:
                needed.update(st.ins)

        def saved(n):
            st = self.steps[self.producer[n]]
            return policy is None or base_name(n) in policy.names or (
                policy.dots and st.kind == DOT)

        # what the backward reads, and what recomputing it reads in turn
        required, todo = set(), list(needed)
        while todo:
            n = todo.pop()
            if n in required or n in inputs:
                continue
            required.add(n)
            i = self.producer[n]
            if not saved(n) and not self.keep_graph[i]:
                todo.extend(self.steps[i].ins)
        self.kept = sorted(n for n in required if saved(n))


class _Layer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plan: _Plan, *tensors):
        vals = dict(zip(plan.inputs, tensors))
        graphs = {}
        for i, st in enumerate(plan.steps):
            args = [vals[n] for n in st.ins]
            if plan.keep_graph[i]:
                graphs[i] = _trace(st, args)
                outs = tuple(o.detach() for o in graphs[i][1])
            else:
                outs = _outs(st.fn(*args))
            vals.update(zip(st.outs, outs))
        ctx.save_for_backward(*tensors)
        ctx.plan, ctx.graphs = plan, graphs
        ctx.kept = {n: vals[n] for n in plan.kept}
        return tuple(vals[n] for n in plan.outs)

    @staticmethod
    def backward(ctx, *grad_outs):
        plan = ctx.plan
        vals = dict(zip(plan.inputs, ctx.saved_tensors))
        vals.update(ctx.kept)
        rec = _Recompute(plan, vals, ctx.graphs)
        ctx.graphs = ctx.kept = None
        grads: Dict[str, torch.Tensor] = dict(zip(plan.outs, grad_outs))
        for i in reversed(range(len(plan.steps))):
            st = plan.steps[i]
            gouts = [grads.pop(n, None) for n in st.outs]
            if all(g is None for g in gouts):
                continue
            if st.kind == DOT:
                gins = _dot_backward(rec.value(st.ins[0]), rec.value(st.ins[1]),
                                     gouts[0])
            elif st.kind == LINEAR:
                gins = st.bwd(*gouts)
            else:
                if i not in rec.graphs:
                    rec.replay(i)
                gins = _graph_backward(*rec.graphs.pop(i), gouts)
            for n, g in zip(st.ins, gins):
                if g is not None:
                    grads[n] = grads[n] + g if n in grads else g
        return (None, *(grads.get(n) for n in plan.inputs))


class _Recompute:
    """The values and graphs a layer's backward has, and the recompute of
    the rest.  (An object, not closures that call each other: such a cycle
    would keep every layer's recomputed values alive until the garbage
    collector ran.)"""

    def __init__(self, plan: _Plan, vals, graphs):
        self.plan, self.vals, self.graphs = plan, vals, graphs

    def value(self, n: str) -> torch.Tensor:
        if n not in self.vals:
            self.replay(self.plan.producer[n])
        return self.vals[n]

    def replay(self, i: int) -> None:
        """Run step i again: a LOCAL one under autograd, so its own
        backward can use the graph later."""
        st = self.plan.steps[i]
        if i in self.graphs:   # a kept graph holds the outputs already
            outs = tuple(o.detach() for o in self.graphs[i][1])
        else:
            replays[st.name] += 1
            args = [self.value(n) for n in st.ins]
            if st.kind == LOCAL:
                self.graphs[i] = _trace(st, args)
                outs = tuple(o.detach() for o in self.graphs[i][1])
            else:
                with torch.no_grad():
                    outs = _outs(st.fn(*args))
        self.vals.update(zip(st.outs, outs))


def _trace(st: Step, args: List[Any]):
    """(leaves, outputs) of step ``st`` run under autograd on detached
    copies of its inputs."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() if torch.is_floating_point(a)
                  else a for a in args]
        return leaves, _outs(st.fn(*leaves))


def _graph_backward(leaves, outs, gouts):
    pairs = [(o, g) for o, g in zip(outs, gouts) if g is not None]
    wrt = [x for x in leaves if torch.is_tensor(x) and x.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return [next(got) if torch.is_tensor(x) and x.requires_grad else None
            for x in leaves]
