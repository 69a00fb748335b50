"""Ape-X DQN: distributed prioritized experience replay.

Counterpart of ``ray_tpu/rllib/apex.py`` (reference:
``rllib/algorithms/apex_dqn/apex_dqn.py``; Horgan et al.: many samplers
with a per-actor exploration ladder, replay sharded across dedicated
actors, a learner that consumes shard samples and pushes refreshed
priorities back).  The double-DQN update and the n-step runner are the
port's ``dqn.py``; ``ReplayShard`` wraps the port's
``PrioritizedReplayBuffer``.  The samplers and the shards are held
in-process (the reference's are actors; ROADMAP A4): each sampler keeps
one batch in flight, submitted with the weights snapshot of the
iteration that submitted it and sampled when the next iteration harvests
it, so inserts lag the learner by one iteration, as the reference's
resubmit-on-arrival loop does.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .dqn import DQN, DQNConfig

__all__ = ["APEX", "APEXConfig", "ReplayShard"]


class ReplayShard:
    """One slice of the replay tier (reference: ApexDQN's replay actors
    over utils/replay_buffers)."""

    def __init__(self, capacity: int, alpha: float, beta: float,
                 seed: int = 0):
        from .replay_buffer import PrioritizedReplayBuffer
        self.buf = PrioritizedReplayBuffer(capacity, alpha=alpha,
                                           beta=beta, seed=seed)

    def add(self, batch: Dict[str, np.ndarray],
            priorities: Optional[np.ndarray] = None) -> int:
        idx = self.buf.add(batch)
        if priorities is not None:
            # replace the default max-priority with the caller's |TD|
            self.buf.update_priorities(idx, priorities)
        return len(self.buf)

    def sample(self, batch_size: int):
        """The sampled dict (fields + _indices/_weights), or None while the
        shard holds less than one batch."""
        if len(self.buf) < batch_size:
            return None
        return self.buf.sample(batch_size)

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> bool:
        self.buf.update_priorities(indices, priorities)
        return True

    def size(self) -> int:
        return len(self.buf)


class APEXConfig(DQNConfig):
    """DQNConfig plus the Ape-X distribution knobs."""

    def __init__(self):
        super().__init__()
        self.num_env_runners = 4
        self.num_replay_shards = 2
        # per-actor exploration ladder: eps_i = base ** (1 + i/(N-1)*alpha)
        # (the paper's schedule: a spread of exploration temperaments in
        # place of one annealed epsilon)
        self.epsilon_base = 0.4
        self.epsilon_alpha = 7.0
        self.replay.update(prioritized=True, learn_starts=500)

    def env_runners(self, num_env_runners: int = 4, **kw):
        return super().env_runners(num_env_runners, **kw)

    def sharding(self, num_replay_shards: int = 2,
                 epsilon_base: float = 0.4, epsilon_alpha: float = 7.0):
        self.num_replay_shards = num_replay_shards
        self.epsilon_base = epsilon_base
        self.epsilon_alpha = epsilon_alpha
        return self


class APEX(DQN):
    """Driver: sampler fleet -> sharded prioritized replay -> learner.

    One ``train()`` iteration: harvest every sampler's batch in flight
    (resubmitting each sampler with this iteration's weights), insert with
    fresh |TD| priorities into a round-robin shard, then run
    ``train_iters`` learner updates pulling from random shards and pushing
    refreshed priorities back.
    """

    def _make_buffer(self):
        return None  # replay lives in the shards

    def __init__(self, config: APEXConfig, device=None):
        super().__init__(config, device=device)
        r = config.replay
        per_shard = max(1, r["capacity"] // config.num_replay_shards)
        self.shards = [
            ReplayShard(per_shard, r["alpha"], r["beta"],
                        seed=config.seed + i)
            for i in range(config.num_replay_shards)]
        n = max(2, config.num_env_runners)
        self._actor_eps = [
            float(config.epsilon_base
                  ** (1.0 + i / (n - 1) * config.epsilon_alpha))
            for i in range(config.num_env_runners)]
        #: (runner index, weights snapshot it was submitted with)
        self._inflight: List[tuple] = []
        self._next_shard = 0
        self._rng = np.random.default_rng(config.seed)

    @torch.no_grad()
    def _td_abs(self, params, target_params, batch) -> torch.Tensor:
        """|TD error| under ``params``, the initial priority of a batch
        (device tensors).  It mirrors the learner's target in ``dqn.py``,
        the ``double_q`` branch included: a priority computed against
        another target than training optimizes skews PER."""
        model = self.model
        q = model.apply(params, batch["obs"])
        qa = torch.gather(q, 1, batch["actions"][:, None].long())[:, 0]
        nq_t = model.apply(target_params, batch["next_obs"])
        if self.config.train["double_q"]:
            sel = model.apply(params, batch["next_obs"]).argmax(-1)
            boot = torch.gather(nq_t, 1, sel[:, None])[:, 0]
        else:
            boot = nq_t.max(-1).values
        target = batch["rewards"] + batch["discounts"] * boot
        return (qa - target).abs()

    def _harvest_and_insert(self) -> int:
        """Sample every in-flight batch, resubmit its sampler, insert into
        the shards with fresh priorities.  Returns env steps inserted."""
        cfg = self.config
        per_runner = max(1, cfg.rollout_steps // cfg.num_env_runners)
        weights = self.get_weights()
        if not self._inflight:
            self._inflight = [(i, weights) for i in range(len(self.runners))]
        steps = 0
        harvest, self._inflight = self._inflight, []
        for i, submitted in harvest:
            batch = self.runners[i].sample(
                submitted, per_runner, self._actor_eps[i],
                cfg.train["n_step"], cfg.train["gamma"])
            prios = self._td_abs(self.params, self.target_params,
                                 self._device_batch(batch)).cpu().numpy()
            shard = self.shards[self._next_shard]
            self._next_shard = (self._next_shard + 1) % len(self.shards)
            shard.add(batch, prios + 1e-6)
            steps += len(batch["rewards"])
            # resubmitted at once: the sampler never idles
            self._inflight.append((i, weights))
        return steps

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        cfg = self.config
        self._env_steps += self._harvest_and_insert()

        sizes = [s.size() for s in self.shards]
        losses: List[torch.Tensor] = []
        if sum(sizes) >= cfg.replay["learn_starts"]:
            for _ in range(cfg.train["train_iters"]):
                order = self._rng.permutation(len(self.shards))
                picked = None
                for j in order:  # the first shard deep enough this pull
                    picked = self.shards[j].sample(cfg.train["batch_size"])
                    if picked is not None:
                        break
                if picked is None:
                    break
                (self.params, self.target_params, self.opt_state, loss,
                 td) = self._update(self.params, self.target_params,
                                    self.opt_state,
                                    self._device_batch(picked))
                losses.append(loss)
                self.shards[int(j)].update_priorities(
                    picked["_indices"], td.abs().cpu().numpy() + 1e-6)

        rets = [x for r in self.runners for x in r.episode_returns()]
        self._recent_returns.extend(rets)
        self._recent_returns = self._recent_returns[-100:]
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else
                                    float("nan")),
            "episodes_this_iter": len(rets),
            "timesteps_total": self._env_steps,
            "replay_shard_sizes": sizes,
            "actor_epsilons": self._actor_eps,
            "loss": (float(torch.stack(losses).cpu().double().mean())
                     if losses else float("nan")),
            "num_updates": len(losses),
            "time_this_iter_s": time.time() - t0,
        }


APEXConfig._algo_cls = APEX
