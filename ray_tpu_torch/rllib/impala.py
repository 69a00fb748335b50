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

The driver is the reference's asynchronous loop on the port's runtime:
the runners are ``EnvRunner`` actors (one CPU each, their policy on the
CPU), each with one fragment in flight, recorded with the policy version
its weights snapshot (one ``put``, refreshed every ``broadcast_interval``
updates) was taken at.  Each update consumes the first fragment to land
(``wait``) and resubmits its runner before the update, so sampling
overlaps the learner and a fragment lands a few versions stale
(``version_lags``).  ``num_learners >= 1`` runs the update in learner
actors (``DistributedLearnerGroup`` with ``learner_cls=ImpalaLearner``):
the fragment's columns split over the ranks, so ``num_envs_per_runner``
must divide by them.
"""

from __future__ import annotations

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
        self.worker_env: Optional[Dict[str, str]] = None
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
        in-process dp split); N >= 1 = N learner actors on one process
        group (learner_group.py): the decoupled actor/learner split the
        IMPALA paper describes."""
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
        """``worker_env``: environment variables each runner and learner
        actor sets before it builds (``actors.actor_class``)."""
        self.seed = seed
        self.worker_env = worker_env
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
        devices, and the ranks of a process group, by column), metrics
        read in one copy."""
        T, B = np.asarray(rollout["rewards"]).shape[:2]
        grads, aux = self._shard_grads(self._place_batch(rollout),
                                       sorted(self.params),
                                       T * B * self.world)
        self.opt.step_(leaves(self.params), grads, self.opt_state)
        values = torch.stack(list(aux.values())).tolist()
        return dict(zip(aux, values))


class IMPALA:
    """Async driver: one in-flight sample per runner, resubmit-on-arrival."""

    def __init__(self, config: IMPALAConfig, device=None):
        import gymnasium as gym

        from .actors import actor_class
        from .env_runner import EnvRunner
        from .models import build_model

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
        if config.num_learners >= 1:
            from .learner_group import DistributedLearnerGroup

            self.learner = DistributedLearnerGroup(
                self.model_spec, config.train,
                num_learners=config.num_learners, seed=config.seed,
                learner_cls=ImpalaLearner,
                devices_per_learner=config.num_devices_per_learner,
                device=device, worker_env=config.worker_env)
        else:
            n_dp = max(1, config.num_devices_per_learner)
            self.learner = ImpalaLearner(
                build_model(self.model_spec), config.train,
                mesh=dp_mesh(n_dp, device) if n_dp > 1 else None,
                seed=config.seed, device=self.device)
        runner_cls = actor_class(EnvRunner, config.worker_env)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                config.env_name, self.model_spec,
                num_envs=config.num_envs_per_runner,
                seed=config.seed + 1000 * i,
                env_config=config.env_config, device="cpu")
            for i in range(config.num_env_runners)]
        self._iteration = 0
        self._recent_returns: List[float] = []
        self.policy_version = 0
        self._weights_ref = None
        self._weights_version = -1
        #: ref -> (runner, version the fragment was sampled under)
        self._in_flight: Dict[Any, tuple] = {}
        #: diagnostic: version lag of consumed fragments (proof of async)
        self.version_lags: List[int] = []

    def _fresh_weights_ref(self):
        import ray_tpu_torch

        if (self._weights_ref is None
                or self.policy_version - self._weights_version
                >= self.config.broadcast_interval):
            self._weights_ref = ray_tpu_torch.put(self.learner.get_weights())
            self._weights_version = self.policy_version
        return self._weights_ref

    def _submit(self, runner):
        ref = runner.sample.remote(self._fresh_weights_ref(),
                                   self.config.rollout_len)
        self._in_flight[ref] = (runner, self._weights_version)

    def train(self) -> Dict[str, Any]:
        """One iteration = updates_per_iter learner steps, each consuming the
        first fragment to land; its runner is resubmitted IMMEDIATELY, so
        sampling continues while the learner's update runs."""
        import ray_tpu_torch

        t0 = time.time()
        for r in self.runners:
            if not any(rn is r for rn, _ in self._in_flight.values()):
                self._submit(r)
        metrics: Dict[str, float] = {}
        for _ in range(self.config.updates_per_iter):
            ready, _ = ray_tpu_torch.wait(list(self._in_flight),
                                          num_returns=1, timeout=600)
            runner, version = self._in_flight.pop(ready[0])
            batch = ray_tpu_torch.get(ready[0])
            # resubmit BEFORE updating: the runner samples the next fragment
            # while the learner computes, the decoupling IMPALA is about
            self._submit(runner)
            self.version_lags.append(self.policy_version - version)
            if len(self.version_lags) > 64:
                del self.version_lags[:-64]
            metrics = self.learner.update(batch)
            self.policy_version += 1
        rets = [x for per in ray_tpu_torch.get(
            [r.episode_returns.remote() for r in self.runners], timeout=60)
            for x in per]
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
        from .actors import kill_all

        kill_all(self.runners)
        self.runners = []
        self._in_flight.clear()
        if hasattr(self.learner, "shutdown"):
            self.learner.shutdown()

    def get_weights(self):
        return self.learner.get_weights()


APPO = IMPALA  # the class is shared; APPOConfig flips the surrogate
