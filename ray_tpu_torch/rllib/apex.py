"""Ape-X DQN: distributed prioritized experience replay.

Counterpart of ``ray_tpu/rllib/apex.py`` (reference:
``rllib/algorithms/apex_dqn/apex_dqn.py``; Horgan et al.: many samplers
with a per-actor exploration ladder, replay sharded across dedicated
actors, a learner that consumes shard samples and pushes refreshed
priorities back).  The double-DQN update and the n-step runner are the
port's ``dqn.py``; ``ReplayShard`` wraps the port's
``PrioritizedReplayBuffer``.  As in the reference, the samplers
(``DQNRunner``) and the shards are actors of the port's runtime (the
shards at half a CPU each): each sampler keeps one batch in flight and
is resubmitted the moment its batch is harvested, so samplers never wait
on the learner; a batch goes to a round-robin shard with |TD| priorities
computed on the driver's device, and the learner pulls from random
shards and pushes refreshed priorities back.
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
        import ray_tpu_torch

        super().__init__(config, device=device)
        shard_cls = ray_tpu_torch.remote(ReplayShard)
        r = config.replay
        per_shard = max(1, r["capacity"] // config.num_replay_shards)
        self.shards = [
            shard_cls.options(num_cpus=0.5).remote(
                per_shard, r["alpha"], r["beta"], seed=config.seed + i)
            for i in range(config.num_replay_shards)]
        n = max(2, config.num_env_runners)
        self._actor_eps = [
            float(config.epsilon_base
                  ** (1.0 + i / (n - 1) * config.epsilon_alpha))
            for i in range(config.num_env_runners)]
        self._inflight: Dict[Any, int] = {}   # sample ref -> runner index
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

    def _harvest_and_insert(self, timeout: float) -> int:
        """Collect arrived sampler batches, resubmit samplers, insert
        into shards with fresh priorities.  Returns env steps inserted."""
        import ray_tpu_torch

        cfg = self.config
        per_runner = max(1, cfg.rollout_steps // cfg.num_env_runners)
        weights_ref = ray_tpu_torch.put(self.get_weights())
        if not self._inflight:
            for i, r in enumerate(self.runners):
                ref = r.sample.remote(weights_ref, per_runner,
                                      self._actor_eps[i],
                                      cfg.train["n_step"],
                                      cfg.train["gamma"])
                self._inflight[ref] = i
        ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                      num_returns=len(self._inflight),
                                      timeout=timeout)
        if not ready and self._inflight:
            # the decoupled tier may lag the learner; block for one batch
            # so an iteration always makes replay progress
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=600)
        steps = 0
        add_refs = []
        for ref in ready:
            i = self._inflight.pop(ref)
            batch = ray_tpu_torch.get(ref, timeout=60)
            prios = self._td_abs(self.params, self.target_params,
                                 self._device_batch(batch)).cpu().numpy()
            shard = self.shards[self._next_shard]
            self._next_shard = (self._next_shard + 1) % len(self.shards)
            add_refs.append(shard.add.remote(batch, prios + 1e-6))
            steps += len(batch["rewards"])
            # resubmitted at once: the sampler never idles
            nref = self.runners[i].sample.remote(
                weights_ref, per_runner, self._actor_eps[i],
                cfg.train["n_step"], cfg.train["gamma"])
            self._inflight[nref] = i
        if add_refs:
            ray_tpu_torch.get(add_refs, timeout=60)
        return steps

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        t0 = time.time()
        cfg = self.config
        self._env_steps += self._harvest_and_insert(timeout=0.05)

        sizes = ray_tpu_torch.get([s.size.remote() for s in self.shards],
                                  timeout=60)
        losses: List[torch.Tensor] = []
        if sum(sizes) >= cfg.replay["learn_starts"]:
            for _ in range(cfg.train["train_iters"]):
                order = self._rng.permutation(len(self.shards))
                picked = None
                for j in order:  # the first shard deep enough this pull
                    picked = ray_tpu_torch.get(
                        self.shards[j].sample.remote(
                            cfg.train["batch_size"]), timeout=60)
                    if picked is not None:
                        break
                if picked is None:
                    break
                (self.params, self.target_params, self.opt_state, loss,
                 td) = self._update(self.params, self.target_params,
                                    self.opt_state,
                                    self._device_batch(picked))
                losses.append(loss)
                self.shards[int(j)].update_priorities.remote(
                    picked["_indices"], td.abs().cpu().numpy() + 1e-6)

        rets = [x for per in ray_tpu_torch.get(
            [r.episode_returns.remote() for r in self.runners], timeout=60)
            for x in per]
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

    def stop(self):
        from .actors import kill_all

        super().stop()
        kill_all(getattr(self, "shards", []))
        self.shards = []


APEXConfig._algo_cls = APEX
