"""PPO: config builder + algorithm driver.

Counterpart of ``ray_tpu/rllib/ppo.py`` (reference:
``rllib/algorithms/ppo/ppo.py`` over ``algorithms/algorithm.py:191``): the
config builder, the rollout fan-out, the learner update and the weight
broadcast, with the update on the card (``learner.py``).

The reference places its runners as actors and gathers their samples in
runner order.  The port builds the same ``EnvRunner`` objects in-process
(seeds ``seed + 1000 * i``) and calls ``sample`` on each in turn; what
sits on the runtime raises ``NotImplementedError``: learner actors
(``num_learners >= 1``, ROADMAP A8's second part, which waits for A4 or
A10), the external-env policy server (A8's second part) and the Tune
trainable (A4).  ``build(device=None)`` runs the learner and the runners'
policies on the card, and raises without one; tests pass ``"cpu"``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np


class PPOConfig:
    """Builder (reference: AlgorithmConfig fluent API)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 1
        self.rollout_len = 128
        self.num_learners = 0
        self.num_devices_per_learner = 1
        self.train: Dict[str, Any] = dict(
            lr=3e-4, gamma=0.99, clip_param=0.2, vf_loss_coeff=0.5,
            entropy_coeff=0.0, num_epochs=4, num_minibatches=4,
            grad_clip=0.5)
        self.model: Dict[str, Any] = dict(hidden=(64, 64))
        self.seed = 0
        self.observation_space = None
        self.action_space = None

    def environment(self, env: Optional[str] = None, *,
                    env_config: Optional[dict] = None,
                    observation_space=None, action_space=None):
        """``env=None`` with explicit spaces is the reference's external-env
        mode, which ``build`` refuses until it is ported."""
        self.env_name = env
        self.env_config = env_config or {}
        self.observation_space = observation_space
        self.action_space = action_space
        return self

    def external(self, *args, **kwargs):
        """The reference serves the policy to external simulators over
        HTTP (``PolicyServerInput``); not ported yet."""
        raise NotImplementedError(
            "external envs (PolicyServerInput, rllib/external.py) are "
            "ROADMAP A8's second part")

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 1,
                    rollout_fragment_length: int = 128):
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_len = rollout_fragment_length
        return self

    def learners(self, num_learners: int = 0,
                 num_devices_per_learner: int = 1):
        """Reference semantics (AlgorithmConfig.learners): 0 = update in the
        driver process on its local devices (``num_devices_per_learner > 1``
        = an in-process dp split); N >= 1 = learner actors, which the port
        does not have yet (``build`` raises)."""
        self.num_learners = num_learners
        self.num_devices_per_learner = num_devices_per_learner
        return self

    def training(self, **kwargs):
        model = kwargs.pop("model", None)
        if model:
            self.model.update(model)
        for k, v in kwargs.items():
            if k == "lambda_":
                k = "lambda"
            self.train[k] = v
        return self

    def debugging(self, seed: int = 0, worker_env: Optional[dict] = None):
        """``worker_env`` sets the reference's actor environment; runners
        are in-process here, so it is not used."""
        self.seed = seed
        return self

    #: algorithm class this config builds — subclasses (A2CConfig) override
    _algo_cls: Optional[type] = None

    def build(self, device=None) -> "PPO":
        if not self.env_name and self.observation_space is None:
            raise ValueError("call .environment(env_name) first")
        return (self._algo_cls or PPO)(self, device=device)


class PPO:
    """The algorithm driver: rollouts from in-process runners -> the update
    -> weights back to the runners.

    ``train()`` returns the reference's result dict (episode_return_mean,
    num_env_steps_sampled and the learner's metrics)."""

    def __init__(self, config: PPOConfig, device=None):
        import gymnasium as gym

        from .. import device as device_mod
        from .env_runner import EnvRunner
        from .learner import LearnerGroup
        from .models import build_model

        if config.num_learners >= 1:
            raise NotImplementedError(
                "learner actors (num_learners >= 1, DistributedLearnerGroup "
                "in rllib/learner_group.py) are ROADMAP A8's second part and "
                "wait for A4 or A10; use learners(num_learners=0, "
                "num_devices_per_learner=N) for an in-process dp split")
        if config.env_name is None:
            raise NotImplementedError(
                "external-env mode (no env) is ROADMAP A8's second part")
        self.config = config
        self.device = device_mod.resolve(device)
        probe = gym.make(config.env_name, **config.env_config)
        obs_space, act_space = probe.observation_space, probe.action_space
        probe.close()
        obs_shape = obs_space.shape
        continuous = not hasattr(act_space, "n")
        action_dim = (act_space.shape[0] if continuous
                      else int(act_space.n))
        if config.model.get("conv") or len(obs_shape) == 3:
            # pixel obs: Nature-CNN torso; filters / torso width
            # overridable for small test grids
            self.model_spec = dict(obs_shape=tuple(obs_shape),
                                   action_dim=action_dim,
                                   continuous=continuous)
            if config.model.get("filters"):
                self.model_spec["filters"] = tuple(
                    tuple(f) for f in config.model["filters"])
            if config.model.get("conv_hidden"):
                self.model_spec["hidden"] = int(config.model["conv_hidden"])
        else:
            self.model_spec = dict(obs_dim=int(np.prod(obs_shape)),
                                   action_dim=action_dim,
                                   hidden=tuple(config.model["hidden"]),
                                   continuous=continuous)
        n_dp = max(1, config.num_devices_per_learner)
        self.learner_group = LearnerGroup(
            build_model(self.model_spec), config.train, num_learners=n_dp,
            seed=config.seed, device=device if n_dp > 1 else self.device)
        self.runners = [
            EnvRunner(config.env_name, self.model_spec,
                      num_envs=config.num_envs_per_runner,
                      seed=config.seed + 1000 * i,
                      env_config=config.env_config, device=self.device)
            for i in range(config.num_env_runners)]
        self._iteration = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        """One iteration: sample on every runner in turn, one update."""
        t0 = time.time()
        weights = self.learner_group.get_weights()
        batches = [r.sample(weights, self.config.rollout_len)
                   for r in self.runners]
        # concat along the env axis: [T, sum(B_i), ...]
        rollout = {
            k: np.concatenate([b[k] for b in batches],
                              axis=0 if k == "last_values" else 1)
            for k in batches[0]}
        metrics = self.learner_group.update(rollout)
        rets = [x for r in self.runners for x in r.episode_returns()]
        steps = (self.config.rollout_len * self.config.num_env_runners
                 * self.config.num_envs_per_runner)
        self._recent_returns.extend(rets)
        self._recent_returns = self._recent_returns[-100:]
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else float("nan")),
            "episodes_this_iter": len(rets),
            "num_env_steps_sampled": steps * self._iteration,
            "time_this_iter_s": time.time() - t0,
            **metrics,
        }

    def stop(self):
        for r in self.runners:
            for env in r.envs:
                env.close()
        self.runners = []

    def get_weights(self):
        return self.learner_group.get_weights()

    @staticmethod
    def as_tune_trainable(config_builder):
        """The reference wraps the driver into a ``ray_tpu.tune`` trainable,
        which is the runtime."""
        raise NotImplementedError(
            "as_tune_trainable needs ray_tpu.tune, the runtime: ROADMAP A4")
