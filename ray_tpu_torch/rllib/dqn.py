"""DQN: off-policy Q-learning with replay + target network.

Counterpart of ``ray_tpu/rllib/dqn.py`` (reference:
``rllib/algorithms/dqn/``).  Double-DQN or max targets over n-step
transitions, a Huber loss, optional prioritized replay weights, Adam and a
Polyak target with ``target_update_tau``: the reference jits the update
into one program; here it runs eagerly on the driver's device, and the
replay ring stays on the host (each sample is one transfer).

The runners are actors of the port's runtime (``ray_tpu_torch.init()``
first), as the reference's are: one CPU each, their policy on the CPU,
the weights through one ``put`` an iteration, the batches gathered in
runner order.  ``DQNRunner``'s epsilon-greedy draws and n-step
aggregation are the reference's numpy, so with the same params it gives
the reference's transitions.  ``DQN.learner_only`` builds the update
alone from the observation and action sizes, with no env, no runner and
no gymnasium.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from .learner import leaves, to_device, to_numpy
from .models import mlp_init, polyak_, relu_mlp
from .optim import Adam


class QNetwork:
    """MLP Q(s,·) head, same functional style as ActorCriticMLP."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(64, 64)):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)

    def init(self, gen: torch.Generator):
        return mlp_init(gen, (self.obs_dim,) + self.hidden
                        + (self.action_dim,), last_scale=0.01)

    def apply(self, params, obs):
        return relu_mlp(params, obs, len(self.hidden))


def build_q_model(spec: Dict[str, Any]):
    """Factory over the Q-head family: any distributional/dueling knob
    (``num_atoms``/``v_min``/``v_max``/``dueling``) selects the C51 head
    (rainbow.py), else the plain QNetwork.  Both expose
    ``apply(params, obs) -> [B, A]`` expected-Q."""
    if any(k in spec for k in ("num_atoms", "v_min", "v_max", "dueling")):
        from .rainbow import DistQNetwork
        return DistQNetwork(**spec)
    return QNetwork(**spec)


class DQNRunner:
    """Epsilon-greedy rollout worker producing replay transitions."""

    def __init__(self, env_name: str, model_spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0,
                 env_config: Optional[dict] = None, device=None):
        import gymnasium as gym

        self.device = device_mod.resolve(device)
        self.envs = [gym.make(env_name, **(env_config or {}))
                     for _ in range(num_envs)]
        self.model = build_q_model(model_spec)
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self.obs = np.stack([e.reset(seed=seed + i)[0]
                             for i, e in enumerate(self.envs)],
                            dtype=np.float32)
        self._ep_returns = np.zeros(num_envs)
        self._done_returns: List[float] = []

    @torch.no_grad()
    def sample(self, params_blob, steps: int, epsilon: float,
               n_step: int = 1, gamma: float = 0.99) -> Dict[str, np.ndarray]:
        """Roll out ``steps`` env steps, return n-step transitions: each
        carries the n-step discounted reward sum and a ``discounts`` factor
        (gamma^k, zeroed at termination), so the learner's bootstrap is
        ``R + discounts * maxQ(next_obs)`` in every case."""
        params = to_device(params_blob, self.device)
        N = self.num_envs
        T = max(1, steps // N)
        shp = self.obs.shape[1:]
        obs_t = np.zeros((T, N) + shp, np.float32)
        act_t = np.zeros((T, N), np.int32)
        rew_t = np.zeros((T, N), np.float32)
        nobs_t = np.zeros((T, N) + shp, np.float32)
        term_t = np.zeros((T, N), bool)
        stop_t = np.zeros((T, N), bool)  # term OR trunc: n-step window ends
        for t in range(T):
            q = self.model.apply(
                params, torch.as_tensor(self.obs).to(self.device)
            ).cpu().numpy()
            greedy = q.argmax(axis=-1)
            explore = self._rng.random(N) < epsilon
            random_a = self._rng.integers(0, q.shape[-1], N)
            actions = np.where(explore, random_a, greedy)
            for i, env in enumerate(self.envs):
                nobs, rew, term, trunc, _ = env.step(int(actions[i]))
                obs_t[t, i] = self.obs[i]
                act_t[t, i] = actions[i]
                rew_t[t, i] = rew
                # the stored successor is the actual next observation: at
                # truncation the target still bootstraps from it
                nobs_t[t, i] = np.asarray(nobs, np.float32)
                term_t[t, i] = term
                stop_t[t, i] = term or trunc
                self._ep_returns[i] += rew
                if term or trunc:
                    self._done_returns.append(self._ep_returns[i])
                    self._ep_returns[i] = 0.0
                    nobs, _ = env.reset()
                self.obs[i] = np.asarray(nobs, np.float32)
        # n-step aggregation per env column (windows never cross episode
        # boundaries; windows clipped by the rollout end bootstrap early
        # with discount gamma^k, k < n)
        out = {
            "obs": obs_t.reshape((T * N,) + shp),
            "actions": act_t.reshape(-1),
            "rewards": np.zeros((T * N,), np.float32),
            "next_obs": np.zeros((T * N,) + shp, np.float32),
            "discounts": np.zeros((T * N,), np.float32),
        }
        k = 0
        for t in range(T):
            for i in range(N):
                acc, g = 0.0, 1.0
                j = t
                while True:
                    acc += g * rew_t[j, i]
                    g *= gamma
                    if stop_t[j, i] or j - t + 1 >= n_step or j + 1 >= T:
                        break
                    j += 1
                out["rewards"][k] = acc
                out["next_obs"][k] = nobs_t[j, i]
                out["discounts"][k] = 0.0 if term_t[j, i] else g
                k += 1
        return out

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._done_returns)
        if clear:
            self._done_returns.clear()
        return out

    def ping(self) -> bool:
        return True


class DQNConfig:
    """Builder (reference: DQNConfig fluent API)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 1
        self.num_envs_per_runner = 1
        self.rollout_steps = 256          # env steps sampled per iteration
        self.train: Dict[str, Any] = dict(
            lr=1e-3, gamma=0.99, batch_size=128, train_iters=8,
            target_update_tau=0.01, double_q=True, huber_delta=1.0,
            n_step=1)
        self.model: Dict[str, Any] = dict(hidden=(64, 64))
        self.replay: Dict[str, Any] = dict(
            capacity=50_000, prioritized=False, alpha=0.6, beta=0.4,
            learn_starts=1_000)
        self.exploration: Dict[str, Any] = dict(
            epsilon_start=1.0, epsilon_end=0.05, epsilon_decay_steps=10_000)
        self.seed = 0

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = env_config or {}
        return self

    def env_runners(self, num_env_runners: int = 1,
                    num_envs_per_env_runner: int = 1,
                    rollout_steps: int = 256):
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_steps = rollout_steps
        return self

    def training(self, **kwargs):
        model = kwargs.pop("model", None)
        if model:
            self.model.update(model)
        replay = kwargs.pop("replay", None)
        if replay:
            self.replay.update(replay)
        self.train.update(kwargs)
        return self

    def exploring(self, **kwargs):
        self.exploration.update(kwargs)
        return self

    def debugging(self, seed: int = 0):
        self.seed = seed
        return self

    _algo_cls: Optional[type] = None

    def build(self, device=None) -> "DQN":
        if not self.env_name:
            raise ValueError("call .environment(env_name) first")
        return (self._algo_cls or DQN)(self, device=device)


class DQN:
    """Driver: epsilon-greedy sampling -> replay -> double-DQN update on the
    driver's device (``device=None``: the card)."""

    def __init__(self, config: DQNConfig, device=None):
        import gymnasium as gym

        import ray_tpu_torch

        probe = gym.make(config.env_name, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        action_dim = int(probe.action_space.n)
        probe.close()
        self._setup(config, obs_dim, action_dim, device)
        self.buffer = self._make_buffer()
        runner_cls = ray_tpu_torch.remote(DQNRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                config.env_name, self.model_spec,
                num_envs=config.num_envs_per_runner,
                seed=config.seed + 1000 * i,
                env_config=config.env_config, device="cpu")
            for i in range(config.num_env_runners)]
        self._iteration = 0
        self._env_steps = 0
        self._recent_returns: List[float] = []

    @classmethod
    def learner_only(cls, config: DQNConfig, obs_dim: int, action_dim: int,
                     device=None) -> "DQN":
        """The params, the target, the optimizer and ``_update`` alone, for
        these sizes: no env, no runner, no replay (``train`` needs them)."""
        self = cls.__new__(cls)
        self._setup(config, obs_dim, action_dim, device)
        return self

    def _setup(self, config, obs_dim: int, action_dim: int, device):
        self.config = config
        self.device = device_mod.resolve(device)
        self.model_spec = dict(obs_dim=obs_dim, action_dim=action_dim,
                               hidden=tuple(config.model["hidden"]))
        for k in ("num_atoms", "v_min", "v_max", "dueling"):
            if k in config.model:  # distributional/dueling heads (rainbow)
                self.model_spec[k] = config.model[k]
        self.model = build_q_model(self.model_spec)
        params = self.model.init(torch.Generator().manual_seed(config.seed))
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.target_params = {k: v.clone() for k, v in self.params.items()}
        self.opt = Adam(config.train["lr"])
        self.opt_state = self.opt.init(leaves(self.params))
        self._update = self._build_update()

    def _make_buffer(self):
        from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer

        r = self.config.replay
        if r.get("prioritized"):
            return PrioritizedReplayBuffer(r["capacity"], alpha=r["alpha"],
                                           beta=r["beta"],
                                           seed=self.config.seed)
        return ReplayBuffer(r["capacity"], seed=self.config.seed)

    def _step(self, loss_fn, params, target_params, opt_state, batch):
        """One Adam step on ``loss_fn``'s loss and the Polyak target, in
        place: (params, target_params, opt_state, loss, per-sample aux)."""
        tau = self.config.train["target_update_tau"]
        keys = sorted(params)
        p = {k: params[k].detach().requires_grad_() for k in keys}
        loss, aux = loss_fn(p, target_params, batch)
        grads = torch.autograd.grad(loss, [p[k] for k in keys])
        self.opt.step_(leaves(params), grads, opt_state)
        polyak_(target_params, params, tau)
        return params, target_params, opt_state, loss.detach(), aux.detach()

    def _build_update(self):
        cfg = self.config.train
        double_q = cfg["double_q"]
        delta = cfg["huber_delta"]
        model = self.model

        def loss_fn(params, target_params, batch):
            q = model.apply(params, batch["obs"])
            qa = torch.gather(q, 1, batch["actions"][:, None].long())[:, 0]
            with torch.no_grad():
                q_next_t = model.apply(target_params, batch["next_obs"])
                if double_q:
                    next_a = model.apply(params, batch["next_obs"]).argmax(-1)
                    q_next = torch.gather(q_next_t, 1, next_a[:, None])[:, 0]
                else:
                    q_next = q_next_t.max(-1).values
                # discounts = gamma^k with 0 at termination (the runner's
                # n-step aggregation): one expression for every sample
                target = batch["rewards"] + batch["discounts"] * q_next
            td = qa - target
            huber = torch.where(td.abs() <= delta, 0.5 * td ** 2,
                                delta * (td.abs() - 0.5 * delta))
            w = batch.get("weights")
            if w is None:
                w = torch.ones_like(td)
            return (w * huber).mean(), td

        def update(params, target_params, opt_state, batch):
            return self._step(loss_fn, params, target_params, opt_state,
                              batch)

        return update

    def _epsilon(self) -> float:
        e = self.config.exploration
        frac = min(1.0, self._env_steps / max(1, e["epsilon_decay_steps"]))
        return e["epsilon_start"] + frac * (e["epsilon_end"]
                                            - e["epsilon_start"])

    def _device_batch(self, sample) -> Dict[str, torch.Tensor]:
        # copies: a sample from a runner or a shard actor is read-only
        batch = {k: torch.tensor(sample[k], device=self.device)
                 for k in ("obs", "actions", "rewards", "next_obs",
                           "discounts")}
        if "_weights" in sample:
            batch["weights"] = torch.tensor(sample["_weights"],
                                            device=self.device)
        return batch

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        t0 = time.time()
        cfg = self.config
        eps = self._epsilon()
        weights_ref = ray_tpu_torch.put(self.get_weights())
        per_runner = max(1, cfg.rollout_steps // cfg.num_env_runners)
        batches = ray_tpu_torch.get(
            [r.sample.remote(weights_ref, per_runner, eps,
                             cfg.train["n_step"], cfg.train["gamma"])
             for r in self.runners], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self._env_steps += len(b["rewards"])

        losses = []
        if len(self.buffer) >= cfg.replay["learn_starts"]:
            for _ in range(cfg.train["train_iters"]):
                sample = self.buffer.sample(cfg.train["batch_size"])
                (self.params, self.target_params, self.opt_state, loss,
                 td) = self._update(self.params, self.target_params,
                                    self.opt_state,
                                    self._device_batch(sample))
                self.buffer.update_priorities(sample["_indices"],
                                              td.cpu().numpy())
                losses.append(float(loss))

        rets = [x for per in ray_tpu_torch.get(
            [r.episode_returns.remote() for r in self.runners], timeout=60)
            for x in per]
        self._recent_returns.extend(rets)
        self._recent_returns = self._recent_returns[-100:]
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else float("nan")),
            "episodes_this_iter": len(rets),
            "num_env_steps_sampled": self._env_steps,
            "epsilon": eps,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "replay_size": len(self.buffer),
            "time_this_iter_s": time.time() - t0,
        }

    def stop(self):
        from .actors import kill_all

        kill_all(getattr(self, "runners", []))
        self.runners = []

    def get_weights(self):
        return to_numpy(self.params)
