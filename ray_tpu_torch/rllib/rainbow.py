"""Rainbow-style distributional DQN: C51 categorical head + dueling.

Counterpart of ``ray_tpu/rllib/rainbow.py`` (reference:
``rllib/algorithms/dqn/dqn.py``'s ``num_atoms`` / ``dueling`` / ``n_step``
knobs).  The C51 projection of ``Tz = r + discounts * z`` onto the support
is two one-hot products (floor and ceil neighbours), as in the reference,
and stays products here: a scatter-add would sum in another order.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .dqn import DQN, DQNConfig
from .models import normal_init

__all__ = ["Rainbow", "RainbowConfig", "DistQNetwork"]


class DistQNetwork:
    """MLP torso -> (dueling) categorical head over a fixed support.

    ``apply`` returns expected Q [B, A] (so epsilon-greedy rollout code is
    head-agnostic); ``log_probs`` exposes the full distribution
    [B, A, atoms] for the learner's cross-entropy."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(64, 64),
                 num_atoms: int = 51, v_min: float = -10.0,
                 v_max: float = 10.0, dueling: bool = True):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)
        self.num_atoms = int(num_atoms)
        self.v_min = float(v_min)
        self.v_max = float(v_max)
        self.dueling = bool(dueling)

    def support_on(self, device) -> torch.Tensor:
        return torch.linspace(self.v_min, self.v_max, self.num_atoms,
                              device=device)

    @property
    def support(self) -> torch.Tensor:
        return self.support_on("cpu")

    def init(self, gen: torch.Generator):
        sizes = (self.obs_dim,) + self.hidden
        params: Dict[str, Any] = {}
        dev = gen.device
        for i in range(len(sizes) - 1):
            params[f"w{i}"] = normal_init(gen, (sizes[i], sizes[i + 1]),
                                          (2.0 / sizes[i]) ** 0.5)
            params[f"b{i}"] = torch.zeros(sizes[i + 1], device=dev)
        h = sizes[-1]
        params["adv_w"] = normal_init(
            gen, (h, self.action_dim * self.num_atoms), 0.01)
        params["adv_b"] = torch.zeros(self.action_dim * self.num_atoms,
                                      device=dev)
        if self.dueling:
            params["val_w"] = normal_init(gen, (h, self.num_atoms), 0.01)
            params["val_b"] = torch.zeros(self.num_atoms, device=dev)
        return params

    def _logits(self, params, obs):
        x = obs
        for i in range(len(self.hidden)):
            x = torch.relu(x @ params[f"w{i}"] + params[f"b{i}"])
        adv = (x @ params["adv_w"] + params["adv_b"]).reshape(
            x.shape[0], self.action_dim, self.num_atoms)
        if self.dueling:
            val = (x @ params["val_w"] + params["val_b"])[:, None, :]
            # dueling in distribution space: center the advantage stream
            return val + adv - adv.mean(dim=1, keepdim=True)
        return adv

    def log_probs(self, params, obs):
        return torch.log_softmax(self._logits(params, obs), dim=-1)

    def probs(self, params, obs):
        return torch.softmax(self._logits(params, obs), dim=-1)

    def apply(self, params, obs):
        """Expected Q values [B, A] under the categorical distribution."""
        p = self.probs(params, obs)
        return (p * self.support_on(p.device)).sum(dim=-1)


class RainbowConfig(DQNConfig):
    """DQNConfig pinned to the distributional regime (reference DQN
    defaults for Rainbow runs: 51 atoms, dueling, n-step 3, PER)."""

    def __init__(self):
        super().__init__()
        self.model.update(num_atoms=51, v_min=-10.0, v_max=10.0,
                          dueling=True)
        self.train.update(n_step=3)
        self.replay.update(prioritized=True)

    def build(self, device=None) -> "Rainbow":
        if not self.env_name:
            raise ValueError("call .environment(env_name) first")
        return Rainbow(self, device=device)


class Rainbow(DQN):
    """DQN driver with the C51 cross-entropy update swapped in."""

    def _build_update(self):
        cfg = self.config.train
        double_q = cfg["double_q"]
        model = self.model
        atoms = model.num_atoms
        z = model.support_on(self.device)                   # [atoms]
        dz = (model.v_max - model.v_min) / (atoms - 1)

        def loss_fn(params, target_params, batch):
            logp = model.log_probs(params, batch["obs"])     # [B, A, M]
            a = batch["actions"].long()
            logp_a = torch.gather(
                logp, 1, a[:, None, None].expand(-1, 1, atoms))[:, 0]

            with torch.no_grad():
                # next-action selection on expected Q
                next_q = model.apply(params if double_q else target_params,
                                     batch["next_obs"])
                next_a = next_q.argmax(dim=-1)
                p_next = torch.gather(
                    model.probs(target_params, batch["next_obs"]), 1,
                    next_a[:, None, None].expand(-1, 1, atoms))[:, 0]
                # categorical projection of Tz = r + gamma^k * z onto the
                # support: two one-hot products, no scatter
                tz = torch.clamp(batch["rewards"][:, None]
                                 + batch["discounts"][:, None] * z,
                                 model.v_min, model.v_max)     # [B, M]
                b = (tz - model.v_min) / dz
                low = torch.clamp(torch.floor(b), 0, atoms - 1)
                up = torch.clamp(low + 1, 0, atoms - 1)
                w_up = b - low                         # 0 when b integral
                w_low = 1.0 - w_up
                onehot_l = F.one_hot(low.long(), atoms).to(p_next.dtype)
                onehot_u = F.one_hot(up.long(), atoms).to(p_next.dtype)
                m = (torch.einsum("bm,bmn->bn", p_next * w_low, onehot_l)
                     + torch.einsum("bm,bmn->bn", p_next * w_up, onehot_u))

            ce = -(m * logp_a).sum(dim=-1)                   # [B]
            w = batch.get("weights")
            if w is None:
                w = torch.ones_like(ce)
            # the per-sample cross-entropy doubles as the PER priority
            return (w * ce).mean(), ce

        def update(params, target_params, opt_state, batch):
            return self._step(loss_fn, params, target_params, opt_state,
                              batch)

        return update
