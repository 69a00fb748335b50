"""Ring attention and Ulysses attention over a sequence-sharded mesh axis.

Counterpart of ``ray_tpu/ops/ring_attention.py``.  Each device of the
``sp`` axis holds a contiguous sequence shard of q, k and v.  The K/V
shards go round the ring one step a hop (``parallel.mesh.ring_shift``: in
one process a hop is a copy of k and v to the next device of the group),
and every hop folds the block a shard holds into its queries' attention.
The S×S score matrix is never written out.

Two routes compute one hop, chosen per call as ``mha`` chooses (no
fallback from one to the other; a kernel that refuses a shape raises):

* **The kernels** (``ring_kernel_takes``: bf16 CUDA tensors, or any CPU
  tensors, with a head dim the kernels have and no softcap).  Shard i
  against the K/V block of shard j runs B1 causal when j == i, B1 with no
  mask (``causal=False``) when j < i, and nothing when j > i, whose block
  the causal mask hides whole.  Each hop's (out, lse) is merged in f32 by
  log-sum-exp (lse is the natural log of the sum of the scaled scores'
  exponentials).  One ``torch.autograd.Function`` owns the whole sp
  group: its backward takes Δ = rowsum(dO∘O) once per q shard from the
  final output, runs B2 and B3 for each pair the forward ran with the
  merged lse and that Δ, and sums dq on the q shard's device and dk/dv on
  the K/V shard's device in f32, hop by hop in a fixed order, so a rerun
  gives the same bits.  On CPU tensors the same code runs the kernels'
  plain versions, as ``flash_attention`` does.
* **The recurrence** (every other call: a softcap, f16 or f32 on the card,
  a head dim the kernels lack): ``attend_blockwise`` / ``finalize_blockwise``
  under autograd, as the reference runs every call.  Blocks the causal
  mask hides whole are skipped; the reference folds them in, and they add
  exactly nothing (their probabilities are exp(-1e30 - m) = 0 and their
  rescale exp(0) = 1).

``ulysses_attention`` regroups heads and sequence with an all-to-all, runs
``mha`` (B1-B3 for bf16 CUDA tensors at S >= 1024) on the whole sequence
for its heads, and regroups back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..parallel import mesh as pm
from .attention import attend_blockwise, finalize_blockwise, mha
from .flash_attention import (KERNEL_HEAD_DIMS, _delta, _flash_bwd_stats,
                              _flash_fwd)


def ring_kernel_takes(is_cuda: bool, head_dim: int, logit_softcap: float,
                      dtype: torch.dtype) -> bool:
    """Whether the ring runs its hops through the kernels B1-B3 (their
    plain versions for CPU tensors): bf16 on the card, a head dim the
    kernels have, no softcap.  The kernels take f16 and f32 too, but the
    reference's ring runs no kernel at all (``attend_blockwise``), so those
    types keep the recurrence here, as there."""
    return ((not is_cuda or dtype == torch.bfloat16)
            and head_dim in KERNEL_HEAD_DIMS and logit_softcap == 0.0)


def _pairs(n: int, causal: bool):
    """(hop, q shard, K/V shard) in the reference's order: at hop t shard
    i holds the block of shard (i - t) mod n; blocks the causal mask hides
    whole are left out."""
    for t in range(n):
        for i in range(n):
            src = (i - t) % n
            if not (causal and src > i):
                yield t, i, src


def _merge(o_acc, lse_acc, o, lse):
    """Two partial attentions over disjoint K/V blocks, merged in f32 by
    their log-sum-exps -> (out f32 [B, S, H, D], lse [B, H, S])."""
    if o_acc is None:
        return o.float(), lse
    new = torch.logaddexp(lse_acc, lse)
    a = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
    b = torch.exp(lse - new).transpose(1, 2)[..., None]
    return o_acc * a + o.float() * b, new


def _add_f32(acc: Optional[torch.Tensor], g: torch.Tensor,
             dev: torch.device) -> torch.Tensor:
    g = g.to(dev).float()
    return g if acc is None else acc + g


class _RingFlash(torch.autograd.Function):
    """The sp group's ring through B1-B3: inputs q shards, then k shards,
    then v shards (sp order); outputs each q shard's attention."""

    @staticmethod
    def forward(ctx, causal, n, *qkv):
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        o_acc: List[Optional[torch.Tensor]] = [None] * n
        lse: List[Optional[torch.Tensor]] = [None] * n
        k_cur, v_cur, hop = list(ks), list(vs), 0
        for t, i, src in _pairs(n, causal):
            while hop < t:
                k_cur, v_cur, hop = (pm.ring_shift(k_cur),
                                     pm.ring_shift(v_cur), hop + 1)
            o, l = _flash_fwd(qs[i], k_cur[i], v_cur[i],
                              causal and src == i)
            o_acc[i], lse[i] = _merge(o_acc[i], lse[i], o, l)
        outs = [o.to(q.dtype) for o, q in zip(o_acc, qs)]
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lse)
        ctx.causal, ctx.n = causal, n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        n, causal = ctx.n, ctx.causal
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lse = (saved[j * n:(j + 1) * n] for j in range(5))
        delta = [_delta(o, g) for o, g in zip(outs, douts)]
        dq: List[Optional[torch.Tensor]] = [None] * n
        dk: List[Optional[torch.Tensor]] = [None] * n
        dv: List[Optional[torch.Tensor]] = [None] * n
        k_cur, v_cur, hop = list(ks), list(vs), 0
        for t, i, src in _pairs(n, causal):
            while hop < t:
                k_cur, v_cur, hop = (pm.ring_shift(k_cur),
                                     pm.ring_shift(v_cur), hop + 1)
            gq, gk, gv = _flash_bwd_stats(qs[i], k_cur[i], v_cur[i],
                                          douts[i], lse[i], delta[i],
                                          causal and src == i)
            dq[i] = _add_f32(dq[i], gq, qs[i].device)
            dk[src] = _add_f32(dk[src], gk, ks[src].device)
            dv[src] = _add_f32(dv[src], gv, vs[src].device)
        grads = ([g.to(x.dtype) for g, x in zip(dq, qs)]
                 + [g.to(x.dtype) for g, x in zip(dk, ks)]
                 + [g.to(x.dtype) for g, x in zip(dv, vs)])
        return (None, None, *grads)


def _ring_blockwise(qs, ks, vs, causal: bool, logit_softcap: float):
    """The reference's recurrence over the group, under autograd."""
    n = len(qs)
    b, s_local, h, d = qs[0].shape
    state = [(torch.full((b, h, s_local), float("-inf"), dtype=torch.float32,
                         device=q.device),
              torch.zeros((b, h, s_local), dtype=torch.float32,
                          device=q.device),
              torch.zeros((b, s_local, h, d), dtype=torch.float32,
                          device=q.device)) for q in qs]
    k_cur, v_cur, hop = list(ks), list(vs), 0
    for t, i, src in _pairs(n, causal):
        while hop < t:
            k_cur, v_cur, hop = (pm.ring_shift(k_cur), pm.ring_shift(v_cur),
                                 hop + 1)
        state[i] = attend_blockwise(qs[i], k_cur[i], v_cur[i], *state[i],
                                    causal=causal, q_offset=i * s_local,
                                    kv_offset=src * s_local,
                                    logit_softcap=logit_softcap)
    return [finalize_blockwise(*st).to(q.dtype) for st, q in zip(state, qs)]


def _ring_attn_shard(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                     v: Sequence[torch.Tensor], axis_name: Optional[str] = None,
                     causal: bool = True, logit_softcap: float = 0.0
                     ) -> List[torch.Tensor]:
    """The body over one sp group: q, k, v are the group's shards in sp
    order ([B, S_local, H|KV, D] each, on its device), where the
    reference's body under ``shard_map`` sees one shard and its axis
    (``axis_name`` is taken for that signature and not used).  -> each q
    shard's attention, on its device."""
    del axis_name
    q, k, v = list(q), list(k), list(v)
    if ring_kernel_takes(q[0].is_cuda, q[0].shape[-1], logit_softcap,
                         q[0].dtype):
        return list(_RingFlash.apply(causal, len(q), *q, *k, *v))
    return _ring_blockwise(q, k, v, causal, logit_softcap)


def _cut(x, sharding: "pm.NamedSharding") -> "pm.Sharded":
    """``x`` as a ``Sharded`` of ``sharding`` (cut differentiably when it
    is one tensor)."""
    if isinstance(x, pm.Sharded):
        return x
    return pm.Sharded([x[sl].to(d) for sl, d in
                       zip(sharding.slices(x.shape),
                           sharding.mesh.device_list)], sharding)


def _seq_sharding(mesh, axis_name: str, batch_axes) -> "pm.NamedSharding":
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    return pm.NamedSharding(mesh, pm.PartitionSpec(axes or None, axis_name))


def _per_group(fn, q, k, v, mesh, axis_name, batch_axes) -> "pm.Sharded":
    sh = _seq_sharding(mesh, axis_name, batch_axes)
    q, k, v = (_cut(x, sh) for x in (q, k, v))
    outs: List[Optional[torch.Tensor]] = [None] * len(q.parts)
    for g in pm.axis_groups(mesh, (axis_name,)):
        for j, o in zip(g, fn([q.parts[j] for j in g],
                              [k.parts[j] for j in g],
                              [v.parts[j] for j in g])):
            outs[j] = o
    return pm.Sharded(outs, q.sharding)


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   batch_axes: tuple = ("dp",), logit_softcap: float = 0.0
                   ) -> "pm.Sharded":
    """Ring attention over ``axis_name`` of ``mesh``.

    q: [B, S, H, D], k/v: [B, S, KV, D], whole tensors (cut here) or
    ``Sharded`` with S over ``axis_name`` and B over ``batch_axes``.
    Returns the ``Sharded`` [B, S, H, D] output cut the same way; devices
    that differ on other axes hold replicas and each runs its own ring.
    """
    return _per_group(
        lambda qs, ks, vs: _ring_attn_shard(qs, ks, vs, causal=causal,
                                            logit_softcap=logit_softcap),
        q, k, v, mesh, axis_name, batch_axes)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True, batch_axes: tuple = ("dp",)
                      ) -> "pm.Sharded":
    """DeepSpeed-Ulysses sequence parallelism: an all-to-all gives each
    device the whole sequence for H/n of the heads (and KV/n of the KV
    heads, the same GQA groups), ``mha`` attends, and an all-to-all
    returns each device its sequence shard of every head.  Inputs and
    output as ``ring_attention``'s.  With fewer KV heads than the sp
    degree divides, it is the ring, as in the reference."""
    sp = mesh.shape[axis_name]
    if k.shape[2] % sp != 0:
        return ring_attention(q, k, v, mesh, axis_name, causal, batch_axes)

    def body(qs, ks, vs):
        qf, kf, vf = (pm.all_to_all(x, split_dim=2, concat_dim=1)
                      for x in (qs, ks, vs))
        out = [mha(a, b, c, causal=causal) for a, b, c in zip(qf, kf, vf)]
        return pm.all_to_all(out, split_dim=1, concat_dim=2)

    return _per_group(body, q, k, v, mesh, axis_name, batch_axes)
