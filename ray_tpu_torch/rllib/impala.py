"""IMPALA / APPO: V-trace actor-critic over stale fragments.

Counterpart of ``ray_tpu/rllib/impala.py`` (reference:
``rllib/algorithms/impala/impala.py:68`` and ``:552``; V-trace from
Espeholt et al. 2018).  ``ImpalaLearner`` does one pass per fragment: the
clipped importance weights, the reverse V-trace recurrence for the value
targets ``vs`` (a loop over T where JAX scans), the policy gradient on
the corrected advantage (APPO: PPO's clipped surrogate against the
behaviour policy), the value regression to ``vs`` and the entropy bonus,
then optax's clip + Adam (``optim.Adam``).  Under
``num_devices_per_learner > 1`` the fragment's B columns split over the
devices, which is exact since V-trace runs per column; each device's sums
are divided by the global T·B and the gradients summed in device order.

The driver keeps the reference's asynchronous contract in-process: each
runner has one fragment in flight, recorded with the weights snapshot and
policy version it was submitted under; fragments are consumed first in,
first out; a runner is resubmitted before the update that consumes its
fragment, under a snapshot refreshed every ``broadcast_interval``
updates.  So a fragment is sampled under stale weights and
``version_lags`` is real (``num_env_runners`` in steady state at
``broadcast_interval`` 1).  What changed is time: the reference's runners
are actors that sample while the learner updates; until the port reaches
the runtime (ROADMAP A4) there are no actors, and a runner samples its
fragment, under the snapshot it was submitted with, when the driver
consumes it, so sampling and the update take turns.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from .learner import Learner, dp_mesh, leaves


class IMPALAConfig:
    """Builder, same surface shape as PPOConfig."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 1
        self.rollout_len = 64
        self.num_learners = 0
        self.num_devices_per_learner = 1
        self.seed = 0
        self.model: Dict[str, Any] = {"hidden": (64, 64)}
        self.train: Dict[str, Any] = {
            "lr": 5e-4, "gamma": 0.99, "grad_clip": 40.0,
            "vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
            "vtrace_rho_clip": 1.0, "vtrace_c_clip": 1.0,
            "use_appo_clip": False, "clip_param": 0.3,
        }
        self.updates_per_iter = 8
        self.broadcast_interval = 1

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 1,
                    rollout_fragment_length: int = 64):
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_len = rollout_fragment_length
        return self

    def learners(self, num_learners: int = 0,
                 num_devices_per_learner: int = 1):
        """0 = the driver's learner (``num_devices_per_learner > 1``: an
        in-process dp split); N >= 1 = learner actors, which the port does
        not have yet (``build`` raises)."""
        self.num_learners = num_learners
        self.num_devices_per_learner = num_devices_per_learner
        return self

    def training(self, **kwargs):
        if "model" in kwargs:
            self.model.update(kwargs.pop("model"))
        if "updates_per_iter" in kwargs:
            self.updates_per_iter = kwargs.pop("updates_per_iter")
        if "broadcast_interval" in kwargs:
            self.broadcast_interval = kwargs.pop("broadcast_interval")
        self.train.update(kwargs)
        return self

    def debugging(self, seed: int = 0, worker_env: Optional[dict] = None):
        """``worker_env`` sets the reference's actor environment; runners
        are in-process here, so it is not used."""
        self.seed = seed
        return self

    def build(self, device=None) -> "IMPALA":
        return IMPALA(self, device=device)


class APPOConfig(IMPALAConfig):
    """APPO: IMPALA's loop with the clipped PPO surrogate."""

    def __init__(self):
        super().__init__()
        self.train["use_appo_clip"] = True


class ImpalaLearner(Learner):
    """V-trace actor-critic update: ONE pass per fragment, no epoch loop."""

    def vtrace(self, tgt_logp, behavior_logp, values, rewards, dones,
               last_values):
        """V-trace over [T, B] (``values`` detached; ``last_values`` [B]):
        ``(vs, pg_adv, rho)``, the value targets, the corrected advantage
        and the unclipped importance weights."""
        cfg = self.cfg
        gamma = cfg.get("gamma", 0.99)
        rho = torch.exp(tgt_logp - behavior_logp)
        rho_cl = torch.clamp(rho, max=cfg.get("vtrace_rho_clip", 1.0))
        c_cl = torch.clamp(rho, max=cfg.get("vtrace_c_clip", 1.0))
        nt = 1.0 - dones
        v_next = torch.cat([values[1:], last_values[None]], 0)
        delta = rho_cl * (rewards + gamma * nt * v_next - values)
        coef = gamma * nt * c_cl
        # vs_t - V_t = delta_t + gamma * nt_t * c_t * (vs_{t+1} - V_{t+1})
        vs_minus_v = torch.empty_like(delta)
        acc = torch.zeros_like(last_values)
        for t in reversed(range(delta.shape[0])):
            acc = torch.addcmul(delta[t], coef[t], acc, out=vs_minus_v[t])
        vs = vs_minus_v + values
        vs_next = torch.cat([vs[1:], last_values[None]], 0)
        pg_adv = rho_cl * (rewards + gamma * nt * vs_next - values)
        return vs, pg_adv, rho

    def _loss(self, params, batch, key=None, count: Optional[int] = None):
        """The V-trace loss of a fragment [T, B, ...] and its metrics;
        ``count`` (default T·B) is what every mean divides by."""
        cfg = self.cfg
        obs = batch["obs"]
        T, B = obs.shape[0], obs.shape[1]
        n = T * B if count is None else count

        def mean(x):
            return x.sum() / n

        pi_out, values = self.model.apply(params, obs.reshape(
            (T * B,) + obs.shape[2:]))
        acts = batch["actions"].reshape((T * B,)
                                        + batch["actions"].shape[2:])
        tgt_logp = self.model.log_prob(pi_out, acts).reshape(T, B)
        ent = mean(self.model.entropy(pi_out))
        values = values.reshape(T, B)
        behavior_logp = batch["logp"]
        with torch.no_grad():
            vs, pg_adv, rho = self.vtrace(
                tgt_logp.detach(), behavior_logp, values.detach(),
                batch["rewards"], batch["dones"], batch["last_values"])
        if cfg.get("use_appo_clip", False):
            clip = cfg.get("clip_param", 0.3)
            ratio = torch.exp(tgt_logp - behavior_logp)
            surr = torch.minimum(
                ratio * pg_adv, torch.clamp(ratio, 1 - clip, 1 + clip)
                * pg_adv)
            pi_loss = -mean(surr)
        else:
            pi_loss = -mean(tgt_logp * pg_adv)
        vf_loss = mean((values - vs) ** 2)
        total = (pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.0) * ent)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent, "mean_rho": mean(rho)}

    def update(self, rollout: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One Adam step on the fragment's V-trace loss (split over the dp
        devices by column), metrics read in one copy."""
        T, B = np.asarray(rollout["rewards"]).shape[:2]
        grads, aux = self._shard_grads(self._place_batch(rollout),
                                       sorted(self.params), T * B)
        self.opt.step_(leaves(self.params), grads, self.opt_state)
        values = torch.stack(list(aux.values())).tolist()
        return dict(zip(aux, values))


class IMPALA:
    """Driver: one fragment in flight per runner, consumed first in, first
    out, each runner resubmitted before the update (see the module
    docstring)."""

    def __init__(self, config: IMPALAConfig, device=None):
        import gymnasium as gym

        from .env_runner import EnvRunner
        from .models import build_model

        if config.num_learners >= 1:
            raise NotImplementedError(
                "learner actors (num_learners >= 1, DistributedLearnerGroup "
                "in rllib/learner_group.py) wait for ROADMAP A4 or A10; use "
                "learners(num_learners=0, num_devices_per_learner=N) for an "
                "in-process dp split")
        self.config = config
        self.device = device_mod.resolve(device)
        probe = gym.make(config.env_name, **config.env_config)
        obs_shape = probe.observation_space.shape
        continuous = not hasattr(probe.action_space, "n")
        action_dim = (probe.action_space.shape[0] if continuous
                      else int(probe.action_space.n))
        probe.close()
        self.model_spec = dict(obs_dim=int(np.prod(obs_shape)),
                               action_dim=action_dim,
                               hidden=tuple(config.model["hidden"]),
                               continuous=continuous)
        n_dp = max(1, config.num_devices_per_learner)
        self.learner = ImpalaLearner(
            build_model(self.model_spec), config.train,
            mesh=dp_mesh(n_dp, device) if n_dp > 1 else None,
            seed=config.seed, device=self.device)
        self.runners = [
            EnvRunner(config.env_name, self.model_spec,
                      num_envs=config.num_envs_per_runner,
                      seed=config.seed + 1000 * i,
                      env_config=config.env_config, device=self.device)
            for i in range(config.num_env_runners)]
        self._iteration = 0
        self._recent_returns: List[float] = []
        self.policy_version = 0
        self._weights: Optional[Dict[str, np.ndarray]] = None
        self._weights_version = -1
        #: (runner, weights snapshot, version it was submitted under),
        #: oldest first
        self._in_flight: collections.deque = collections.deque()
        #: diagnostic: version lag of consumed fragments
        self.version_lags: List[int] = []

    def _fresh_weights(self) -> Dict[str, np.ndarray]:
        """The snapshot new fragments sample under: refreshed once
        ``broadcast_interval`` updates have passed since the last one."""
        if (self._weights is None
                or self.policy_version - self._weights_version
                >= self.config.broadcast_interval):
            self._weights = self.learner.get_weights()
            self._weights_version = self.policy_version
        return self._weights

    def _submit(self, runner) -> None:
        self._in_flight.append((runner, self._fresh_weights(),
                                self._weights_version))

    def train(self) -> Dict[str, Any]:
        """One iteration = ``updates_per_iter`` learner steps, each on the
        oldest fragment in flight; its runner is resubmitted first."""
        t0 = time.time()
        for r in self.runners:
            if not any(rn is r for rn, _, _ in self._in_flight):
                self._submit(r)
        metrics: Dict[str, float] = {}
        for _ in range(self.config.updates_per_iter):
            runner, weights, version = self._in_flight.popleft()
            batch = runner.sample(weights, self.config.rollout_len)
            self._submit(runner)
            self.version_lags.append(self.policy_version - version)
            if len(self.version_lags) > 64:
                del self.version_lags[:-64]
            metrics = self.learner.update(batch)
            self.policy_version += 1
        rets = [x for r in self.runners for x in r.episode_returns()]
        self._recent_returns.extend(rets)
        self._recent_returns = self._recent_returns[-100:]
        self._iteration += 1
        steps = (self.config.rollout_len * self.config.num_envs_per_runner
                 * self.config.updates_per_iter)
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else float("nan")),
            "episodes_this_iter": len(rets),
            "num_env_steps_sampled": steps * self._iteration,
            "mean_version_lag": float(np.mean(self.version_lags[-64:])),
            "time_this_iter_s": time.time() - t0,
            **metrics,
        }

    def stop(self):
        for r in self.runners:
            for env in r.envs:
                env.close()
        self.runners = []
        self._in_flight.clear()

    def get_weights(self):
        return self.learner.get_weights()


APPO = IMPALA  # the class is shared; APPOConfig flips the surrogate
