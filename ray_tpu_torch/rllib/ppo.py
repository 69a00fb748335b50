"""PPO: config builder + algorithm driver.

Counterpart of ``ray_tpu/rllib/ppo.py`` (reference:
``rllib/algorithms/ppo/ppo.py`` over ``algorithms/algorithm.py:191``): the
config builder, the rollout fan-out, the learner update and the weight
broadcast, with the update on the card (``learner.py``).

As in the reference, the runners are actors of the runtime
(``ray_tpu_torch.init()`` first): ``EnvRunner`` actors (seeds ``seed +
1000 * i``, one CPU each, their policy on the CPU), fed the learner's
weights through one ``put`` an iteration and gathered in runner order.
``num_learners >= 1`` runs the update in that many learner actors
(``learner_group.DistributedLearnerGroup``); 0 runs it in the driver.  In
external-env mode (``.external(port)``, spaces from ``.environment``)
there are no runners: samples arrive over the policy server
(``external.py``), whose forward runs on the driver's device.
``debugging(worker_env=...)`` sets the actors' environment.  The Tune
trainable raises until tune is ported (ROADMAP A4 (e)).
``build(device=None)`` runs the update (the driver's, or the learner
actors' on a ``GPU`` each) on the card, and raises without one; tests
pass ``"cpu"``.
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
        self.worker_env: Optional[Dict[str, str]] = None
        self.observation_space = None
        self.action_space = None
        self.external_port: Optional[int] = None
        self.external_address = "127.0.0.1"
        self.external_fragment_len = 64

    def environment(self, env: Optional[str] = None, *,
                    env_config: Optional[dict] = None,
                    observation_space=None, action_space=None):
        """``env=None`` with explicit spaces is the external-env mode:
        there is no simulator here to probe (reference:
        AlgorithmConfig.environment(env=None, observation_space=...,
        action_space=...) for policy-server setups).  A space needs only
        ``.shape``, and a discrete one ``.n``."""
        self.env_name = env
        self.env_config = env_config or {}
        self.observation_space = observation_space
        self.action_space = action_space
        return self

    def external(self, port: int = 9900, address: str = "127.0.0.1",
                 fragment_len: int = 64):
        """Serve the policy to external simulators instead of running
        runners here (reference: policy_server_input.py wired via
        ``config.offline_data(input_=...)``).  ``port=0`` takes a free
        port; the server's ``address`` says which."""
        self.external_port = port
        self.external_address = address
        self.external_fragment_len = fragment_len
        return self

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
        = an in-process dp split); N >= 1 = N learner actors forming one
        process group (learner_group.py), each on
        ``num_devices_per_learner`` devices."""
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
        """``worker_env``: environment variables each runner and learner
        actor sets before it builds (``actors.actor_class``)."""
        self.seed = seed
        self.worker_env = worker_env
        return self

    #: algorithm class this config builds — subclasses (A2CConfig) override
    _algo_cls: Optional[type] = None

    def build(self, device=None) -> "PPO":
        if not self.env_name and self.external_port is None:
            raise ValueError("call .environment(env_name) first "
                             "(or .external(port) with explicit spaces)")
        return (self._algo_cls or PPO)(self, device=device)


class PPO:
    """The algorithm driver: rollouts from the runner actors (or the
    policy server) -> the update -> weights back to them.

    ``train()`` returns the reference's result dict (episode_return_mean,
    num_env_steps_sampled and the learner's metrics)."""

    def __init__(self, config: PPOConfig, device=None):
        from .. import device as device_mod
        from .actors import actor_class
        from .env_runner import EnvRunner
        from .learner import LearnerGroup
        from .models import build_model

        self.config = config
        self.device = device_mod.resolve(device)
        if config.env_name is not None:
            import gymnasium as gym

            probe = gym.make(config.env_name, **config.env_config)
            obs_space, act_space = (probe.observation_space,
                                    probe.action_space)
            probe.close()
        else:  # external-env mode: the spaces come from the config
            obs_space, act_space = (config.observation_space,
                                    config.action_space)
            if obs_space is None or act_space is None:
                raise ValueError(
                    "external mode needs .environment(observation_space=..., "
                    "action_space=...): there is no env to probe")
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
        if config.num_learners >= 1:
            from .learner_group import DistributedLearnerGroup

            self.learner_group = DistributedLearnerGroup(
                self.model_spec, config.train,
                num_learners=config.num_learners, seed=config.seed,
                devices_per_learner=config.num_devices_per_learner,
                device=device, worker_env=config.worker_env)
        else:
            # driver-local: num_devices_per_learner > 1 maps to an
            # in-process dp split over that many devices
            n_dp = max(1, config.num_devices_per_learner)
            self.learner_group = LearnerGroup(
                build_model(self.model_spec), config.train,
                num_learners=n_dp, seed=config.seed,
                device=device if n_dp > 1 else self.device)
        self.policy_server = None
        self.runners = []
        if config.external_port is not None:
            from .external import PolicyServerInput

            self.policy_server = PolicyServerInput(
                build_model(self.model_spec),
                self.learner_group.get_weights(),
                address=config.external_address, port=config.external_port,
                gamma=config.train.get("gamma", 0.99),
                fragment_len=config.external_fragment_len,
                device=self.device)
        else:
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

    def train(self) -> Dict[str, Any]:
        """One iteration: sample on all runners (or take ``rollout_len``
        steps from the policy server), one update."""
        import ray_tpu_torch

        t0 = time.time()
        if self.policy_server is not None:
            rollout = self.policy_server.next(self.config.rollout_len)
            metrics = self.learner_group.update(rollout)
            self.policy_server.set_weights(self.learner_group.get_weights())
            rets = self.policy_server.episode_returns()
            steps = self.config.rollout_len
        else:
            weights_ref = ray_tpu_torch.put(self.learner_group.get_weights())
            batches = ray_tpu_torch.get(
                [r.sample.remote(weights_ref, self.config.rollout_len)
                 for r in self.runners], timeout=600)
            # concat along the env axis: [T, sum(B_i), ...]
            rollout = {
                k: np.concatenate([b[k] for b in batches],
                                  axis=0 if k == "last_values" else 1)
                for k in batches[0]}
            metrics = self.learner_group.update(rollout)
            rets = [x for per in ray_tpu_torch.get(
                [r.episode_returns.remote() for r in self.runners],
                timeout=60) for x in per]
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
        from .actors import kill_all

        if self.policy_server is not None:
            self.policy_server.stop()
            self.policy_server = None
        kill_all(self.runners)
        self.runners = []
        if hasattr(self.learner_group, "shutdown"):
            self.learner_group.shutdown()

    def get_weights(self):
        return self.learner_group.get_weights()

    @staticmethod
    def as_tune_trainable(config_builder):
        """The reference wraps the driver into a ``ray_tpu.tune`` trainable;
        the port has no tune yet."""
        raise NotImplementedError(
            "as_tune_trainable needs ray_tpu_torch.tune: ROADMAP A4 (e)")
