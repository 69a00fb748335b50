"""Learner + LearnerGroup: the PPO update.

Counterpart of ``ray_tpu/rllib/learner.py`` (reference:
``rllib/core/learner/learner.py:229`` and ``learner_group.py:61``).  The
reference compiles the whole update (GAE, advantage normalisation,
minibatch epochs, the clipped loss, Adam) into one jitted program,
data-parallel over a device mesh.  Here the same steps run eagerly on the
learner's device: GAE is a loop over T where JAX scans, and the minibatch
epochs are Python loops of autograd steps, each ending in optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))`` (``optim.Adam``).

Data parallelism (``LearnerGroup(num_learners=N > 1)``) is one process
over a device list, the port's counterpart of the reference's ``dp``
mesh: the batch axis (axis 1 of ``[T, B, ...]``, axis 0 of
``last_values``) is split into N contiguous blocks, one per device; each
device computes GAE on its columns; the advantage normalisation and each
epoch's permutation stay global, as XLA computes them on the sharded
arrays.  Each device takes the minibatch rows it holds, and its loss is
its rows' share of the minibatch mean (a sum over its rows divided by the
minibatch size), so the shards' losses and gradients add up, in device
order on the first device, to the single-device ones.  The params and
Adam's state live on the first device, and every step copies the params
to the others.

A learner can also be one rank of a ``torch.distributed`` group
(``process_group``; ``learner_group.py``'s learner actors), the port's
counterpart of the reference's mesh over every process's devices.  Its
``update`` then takes the rank's slice of the global batch, and the dp
blocks are process-major: rank r's devices hold global blocks
``r * N .. r * N + N - 1``.  Each rank runs the same update on its own
blocks, and one ``all_reduce`` (SUM) combines what the device sum
combines: the gradients and the metrics, after the device sum.  Two more
keep the normalisation global, its mean and then its sum of squared
deviations (``jnp.std``'s two passes).  Every rank draws each epoch's
permutation from its own ``seed + 1`` generator, so the draws agree
without a message, and a rank that holds none of a minibatch's rows
still enters every collective, with zeros.  The ranks add the same sums
and step Adam alike, so their params stay equal.

The one random draw of an update, each epoch's permutation, goes through
``_permutation``, which a test can replace with JAX's.  The learner draws
it on the host from a ``torch.Generator`` seeded with ``seed + 1`` (the
reference's key), so a run on the card draws what a CPU run draws.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from ..parallel import mesh as mesh_mod
from .optim import Adam


def _permutation(gen: torch.Generator, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``'s role: a permutation of
    ``range(n)`` on the host (int64)."""
    return torch.randperm(n, generator=gen)


def leaves(tree: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """A flat param dict's leaves in sorted key order (JAX's leaf order)."""
    return [tree[k] for k in sorted(tree)]


def to_device(params_blob: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A dict of numpy arrays (``get_weights()``) as tensors on ``device``."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in params_blob.items()}


def to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A snapshot of ``params`` as numpy arrays that own their memory.
    ``.cpu()`` of a CPU tensor is the tensor itself, and ``.numpy()``
    shares its storage, so without the copy the optimizer's in-place
    steps would change a blob already handed out (the reference's
    ``get_weights`` reads immutable arrays)."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in params.items()}


def dp_mesh(num_learners: int, device=None) -> mesh_mod.Mesh:
    """A dp mesh of ``num_learners`` devices: ``None`` puts learner i on
    ``cuda:i`` (as the reference takes ``jax.devices()[:num_learners]``),
    one device puts every learner on it (``"cuda:0"``, or ``"cpu"`` in
    tests)."""
    if device is None:
        device_mod.resolve(None)
        devices = mesh_mod.cuda_devices()[:num_learners]
    else:
        devices = [device] * num_learners
    return mesh_mod.MeshSpec(dp=num_learners, fsdp=1).build(devices)


class Learner:
    """Owns params + optimizer state; ``update()`` runs the PPO update on
    the learner's device (or over ``mesh``'s ``dp`` devices), as one rank
    of ``process_group`` when one is given (see the module docstring)."""

    def __init__(self, model, config: Dict[str, Any],
                 mesh: Optional[mesh_mod.Mesh] = None, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 process_group=None):
        self.model = model
        self.cfg = dict(config)
        self.mesh = mesh
        self.devices: List[torch.device] = (
            [device_mod.resolve(device)] if mesh is None
            else list(mesh.devices.flat))
        self.device = self.devices[0]
        self.group = process_group
        self.rank = 0 if process_group is None else dist.get_rank(
            process_group)
        self.world = 1 if process_group is None else dist.get_world_size(
            process_group)
        # params drawn on the host: the same seed gives the same params on
        # every device
        params = model.init(torch.Generator().manual_seed(seed))
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.opt = Adam(self.cfg.get("lr", 3e-4),
                        grad_clip=self.cfg.get("grad_clip", 0.5))
        self.opt_state = self.opt.init(leaves(self.params))
        self._gen = torch.Generator().manual_seed(seed + 1)

    # ------------------------------------------------------------- the math

    def _gae(self, rewards, values, dones, last_values):
        """Generalized advantage estimation, the reference's reverse scan as
        a loop over T.  rewards/values/dones: [T, B]; last_values: [B]."""
        gamma = self.cfg.get("gamma", 0.99)
        lam = self.cfg.get("lambda", 0.95)
        nonterm = 1.0 - dones
        v_next = torch.cat([values[1:], last_values[None]], 0)
        delta = rewards + gamma * v_next * nonterm - values
        coef = gamma * lam * nonterm
        advs = torch.empty_like(rewards)
        adv = torch.zeros_like(last_values)
        for t in reversed(range(rewards.shape[0])):
            adv = torch.addcmul(delta[t], coef[t], adv, out=advs[t])
        return advs

    def _loss(self, params, batch, key=None, count: Optional[int] = None):
        """The clipped PPO loss and its metrics.  ``count`` (default: the
        batch's rows) is what every mean divides by: a dp shard passes the
        whole minibatch's size, so the shards' terms add up to the means."""
        cfg = self.cfg
        n = batch["logp"].shape[0] if count is None else count

        def mean(x):
            return x.sum() / n

        pi_out, value = self.model.apply(params, batch["obs"])
        logp = self.model.log_prob(pi_out, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        clip = cfg.get("clip_param", 0.2)
        adv = batch["advantages"]
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pi_loss = -mean(surr)
        vf_clip = cfg.get("vf_clip_param", 10.0)
        vf_err = torch.clamp(value - batch["returns"], -vf_clip, vf_clip)
        vf_loss = mean(vf_err ** 2)
        ent = mean(self.model.entropy(pi_out))
        total = (pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.0) * ent)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent, "kl": mean(batch["logp"] - logp)}

    # ------------------------------------------------------------ the shards

    def _place_batch(self, rollout) -> List[Dict[str, torch.Tensor]]:
        """Each device's block of the batch axis (axis 1 of [T, B, ...],
        axis 0 of 1-D ``last_values``), as tensors on that device."""
        nd = len(self.devices)
        B = np.asarray(rollout["rewards"]).shape[1]
        if B % nd:
            raise ValueError(f"batch axis {B} does not split over {nd} "
                             f"learners")
        bl = B // nd
        out = []
        for d, dev in enumerate(self.devices):
            part = {}
            for k, v in rollout.items():
                v = np.asarray(v)
                blk = (v[d * bl:(d + 1) * bl] if v.ndim <= 1
                       else v[:, d * bl:(d + 1) * bl])
                # a copy: the object store hands out read-only arrays
                part[k] = torch.tensor(blk, device=dev)
            out.append(part)
        return out

    def _route(self, idx: torch.Tensor, B: int) -> List[torch.Tensor]:
        """Global flat rows ``idx`` (row t * B + b of the global [T, B])
        -> each of this rank's devices' local flat rows (t * bl + b - k *
        bl for global block k = rank * N + d of width bl) on that device."""
        nd = len(self.devices)
        if nd * self.world == 1:
            return [idx.to(self.device)]
        bl = B // (nd * self.world)
        col, row = idx % B, idx // B
        shard = col // bl
        local = row * bl + col - shard * bl
        return [local[shard == self.rank * nd + d].to(dev)
                for d, dev in enumerate(self.devices)]

    def _sum_ranks(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor summed over the process group's ranks, through one
        ``all_reduce`` of their concatenation (as they are without a
        group).  The sums come back as tensors of their own, not views at
        odd offsets of one buffer: the optimizer's foreach norm may sum a
        misaligned tensor in another order."""
        if self.group is None:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return [part.view_as(t).clone() for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    # -------------------------------------------------------------- public

    def update(self, rollout: Dict[str, np.ndarray]) -> Dict[str, float]:
        cfg = self.cfg
        epochs = cfg.get("num_epochs", 4)
        minibatches = cfg.get("num_minibatches", 4)
        shards = self._place_batch(rollout)
        T, B = np.asarray(rollout["rewards"]).shape[:2]
        B *= self.world  # the global batch's columns
        flats = []
        for r in shards:
            advs = self._gae(r["rewards"], r["values"], r["dones"],
                             r["last_values"])
            returns = advs + r["values"]
            flats.append({
                "obs": r["obs"].reshape(-1, *r["obs"].shape[2:]),
                "actions": r["actions"].reshape(-1,
                                                *r["actions"].shape[2:]),
                "logp": r["logp"].reshape(-1),
                "advantages": advs.reshape(-1),
                "returns": returns.reshape(-1),
            })
        n = T * B
        # the normalisation is global: sums over every shard, in order,
        # then over the ranks
        adv_mean = self._sum_ranks([mesh_mod.ordered_sum(
            [f["advantages"].sum() for f in flats])])[0] / n
        var = self._sum_ranks([mesh_mod.ordered_sum(
            [((f["advantages"] - adv_mean.to(f["advantages"].device)) ** 2)
             .sum() for f in flats])])[0] / n
        std = torch.sqrt(var)
        for f in flats:
            a = f["advantages"]
            f["advantages"] = ((a - adv_mean.to(a.device))
                               / (std.to(a.device) + 1e-8))

        keys = sorted(self.params)
        mb_size = n // minibatches
        aux = None
        for _ in range(epochs):
            perm = _permutation(self._gen, n)
            idxs = perm[:mb_size * minibatches].reshape(minibatches, mb_size)
            for m in range(minibatches):
                mbs = [{k: v[idx] for k, v in flat.items()}
                       for flat, idx in zip(flats,
                                            self._route(idxs[m], B))]
                grads, aux = self._shard_grads(mbs, keys, mb_size)
                self.opt.step_(leaves(self.params), grads, self.opt_state)
        values = torch.stack(list(aux.values())).tolist()
        return dict(zip(aux, values))

    def _shard_grads(self, batches, keys, count):
        """The loss gradients and metrics of one global batch given as
        each device's part (``batches[d]`` on device d, every mean divided
        by the global ``count``), summed over the devices in order on the
        first, then over the ranks."""
        per_grads, per_aux = [], []
        for d, (dev, mb) in enumerate(zip(self.devices, batches)):
            src = {k: (self.params[k] if d == 0
                       else self.params[k].to(dev, copy=True))
                   for k in keys}
            p = {k: v.detach().requires_grad_() for k, v in src.items()}
            loss, aux = self._loss(p, mb, None, count=count)
            per_grads.append(torch.autograd.grad(loss,
                                                 [p[k] for k in keys]))
            per_aux.append({k: v.detach() for k, v in aux.items()})
        if len(per_grads) == 1:
            grads, aux = list(per_grads[0]), per_aux[0]
        else:
            grads = [mesh_mod.ordered_sum([g[i] for g in per_grads])
                     for i in range(len(keys))]
            aux = {k: mesh_mod.ordered_sum([a[k] for a in per_aux])
                   for k in per_aux[0]}
        summed = self._sum_ranks(grads + list(aux.values()))
        return summed[:len(grads)], dict(zip(aux, summed[len(grads):]))

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.params)


class LearnerGroup:
    """Data-parallel learner over a device list.

    The reference drives its local devices through a ``dp`` mesh in one
    process, the allreduce compiled; the port drives the same split from
    one process and sums the gradients in device order (``Learner``).
    ``device``: see ``dp_mesh`` (one learner: the device, ``None`` for the
    card)."""

    def __init__(self, model, config: Dict[str, Any],
                 num_learners: int = 1, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.mesh = None
        if num_learners > 1:
            self.mesh = dp_mesh(num_learners, device)
        self.learner = Learner(model, config, mesh=self.mesh, seed=seed,
                               device=device)

    def update(self, rollout: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self.learner.update(rollout)

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.learner.get_weights()
