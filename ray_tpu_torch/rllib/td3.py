"""TD3: twin-delayed deterministic policy gradient for continuous control.

Counterpart of ``ray_tpu/rllib/td3.py`` (reference:
``rllib/algorithms/td3/``, DDPG plus its three fixes): twin critics with
clipped double-Q targets, target policy smoothing (clipped Gaussian noise
on the target action) and delayed actor and target updates (every
``policy_delay`` critic steps).  ``do_actor`` is a Python bool, as the
reference's static argument is; ``twin_q=False`` is DDPG's single critic.
The update runs on the driver's device; its one draw, the smoothing noise,
goes through ``_normal`` (a test can replace it with JAX's), drawn on the
host from a ``torch.Generator`` seeded from the config's seed.  Shares
``QNetworkSA`` and the replay buffer with SAC; the runners are actors of
the port's runtime with their policy on the CPU, as the reference's are,
and ``TD3.learner_only`` builds the update alone.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from .learner import leaves, to_device, to_numpy
# the update's draw function, which a test can replace with JAX's draws
from .models import _standard_normal as _normal
from .models import mlp_init, polyak_, relu_mlp
from .optim import Adam
from .sac import QNetworkSA


class DeterministicPolicy:
    """MLP -> tanh action in [-1, 1]^A (DDPG/TD3 actor)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 256)):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)

    def init(self, gen: torch.Generator):
        return mlp_init(gen, (self.obs_dim,) + self.hidden
                        + (self.action_dim,), last_scale=0.01)

    def apply(self, params, obs):
        return torch.tanh(relu_mlp(params, obs, len(self.hidden)))


class TD3Runner:
    """Rollout worker: deterministic policy + exploration noise.
    ``steps`` is the total transition budget (T = steps // num_envs)."""

    def __init__(self, env_name: str, spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0,
                 env_config: Optional[dict] = None,
                 explore_noise: float = 0.1, device=None):
        import gymnasium as gym

        self.device = device_mod.resolve(device)
        self._envs = [gym.make(env_name, **(env_config or {}))
                      for _ in range(num_envs)]
        self._policy = DeterministicPolicy(
            spec["obs_dim"], spec["action_dim"], spec["hidden"])
        self.num_envs = num_envs
        self._obs = np.stack([e.reset(seed=seed + i)[0] for i, e in
                              enumerate(self._envs)], dtype=np.float32)
        self._rng = np.random.default_rng(seed)
        self._noise = explore_noise
        low = self._envs[0].action_space.low
        high = self._envs[0].action_space.high
        self._mid, self._half = (high + low) / 2.0, (high - low) / 2.0
        self._returns: List[float] = []
        self._ep_ret = np.zeros(num_envs)

    def _scale(self, a: np.ndarray) -> np.ndarray:
        return self._mid + self._half * a

    @torch.no_grad()
    def sample(self, params_blob, steps: int, random_actions: bool = False
               ) -> Dict[str, np.ndarray]:
        params = to_device(params_blob, self.device)
        N = self.num_envs
        T = max(1, steps // N)
        A = self._policy.action_dim
        obs_l, act_l, rew_l, done_l, next_l = [], [], [], [], []
        for _ in range(T):
            if random_actions:
                acts = self._rng.uniform(-1.0, 1.0, (N, A)).astype(
                    np.float32)
            else:
                acts = self._policy.apply(
                    params, torch.as_tensor(self._obs).to(self.device)
                ).cpu().numpy()
                acts = np.clip(
                    acts + self._rng.normal(0.0, self._noise, acts.shape),
                    -1.0, 1.0).astype(np.float32)
            for i, env in enumerate(self._envs):
                nxt, r, term, trunc, _ = env.step(self._scale(acts[i]))
                self._ep_ret[i] += float(r)
                obs_l.append(self._obs[i].copy())
                act_l.append(acts[i])
                rew_l.append(float(r))
                done_l.append(float(term))
                next_l.append(np.asarray(nxt, np.float32).reshape(-1))
                if term or trunc:
                    self._returns.append(float(self._ep_ret[i]))
                    self._ep_ret[i] = 0.0
                    nxt = env.reset()[0]
                self._obs[i] = np.asarray(nxt, np.float32).reshape(-1)
        return {"obs": np.stack(obs_l), "actions": np.stack(act_l),
                "rewards": np.asarray(rew_l, np.float32),
                "dones": np.asarray(done_l, np.float32),
                "next_obs": np.stack(next_l)}

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._returns)
        if clear:
            self._returns.clear()
        return out


class TD3Config:
    """Builder, same surface shape as SACConfig."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.num_env_runners = 1
        self.num_envs_per_runner = 1
        self.rollout_steps = 256
        self.model: Dict[str, Any] = {"hidden": (256, 256)}
        self.train: Dict[str, Any] = {
            "actor_lr": 3e-4, "critic_lr": 3e-4, "gamma": 0.99,
            "tau": 0.005, "policy_noise": 0.2, "noise_clip": 0.5,
            "policy_delay": 2, "explore_noise": 0.1,
            "batch_size": 256, "train_iters": 32,
            "twin_q": True,  # False = single-critic DDPG semantics
        }
        self.replay: Dict[str, Any] = {
            "capacity": 100_000, "learn_starts": 1000,
            "random_warmup": True,
        }
        self.seed = 0

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def env_runners(self, num_env_runners: int = 1,
                    num_envs_per_env_runner: int = 1,
                    rollout_steps: int = 256):
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_steps = rollout_steps
        return self

    def training(self, **kwargs):
        if "model" in kwargs:
            self.model.update(kwargs.pop("model"))
        if "replay" in kwargs:
            self.replay.update(kwargs.pop("replay"))
        self.train.update(kwargs)
        return self

    def debugging(self, seed: int = 0):
        self.seed = seed
        return self

    #: algorithm class this config builds — subclasses (DDPGConfig) override
    _algo_cls: Optional[type] = None

    def build(self, device=None) -> "TD3":
        if not self.env_name:
            raise ValueError("call .environment(env_name) first")
        return (self._algo_cls or TD3)(self, device=device)


class TD3:
    """Driver: noisy rollouts -> replay -> delayed twin-critic updates on
    the driver's device (``device=None``: the card)."""

    def __init__(self, config: TD3Config, device=None):
        import gymnasium as gym

        import ray_tpu_torch

        from .replay_buffer import ReplayBuffer

        probe = gym.make(config.env_name, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        action_dim = int(np.prod(probe.action_space.shape))
        probe.close()
        self._setup(config, obs_dim, action_dim, device)
        self.buffer = ReplayBuffer(config.replay["capacity"],
                                   seed=config.seed)
        runner_cls = ray_tpu_torch.remote(TD3Runner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                config.env_name, self.spec,
                num_envs=config.num_envs_per_runner,
                seed=config.seed + 1000 * i,
                env_config=config.env_config,
                explore_noise=config.train["explore_noise"],
                device="cpu")
            for i in range(config.num_env_runners)]
        self._iteration = 0
        self._env_steps = 0
        self._updates = 0
        self._recent_returns: List[float] = []

    @classmethod
    def learner_only(cls, config: TD3Config, obs_dim: int, action_dim: int,
                     device=None) -> "TD3":
        """The state, the optimizers and ``_update`` alone, for these sizes:
        no env, no runner, no replay (``train`` needs them)."""
        self = cls.__new__(cls)
        self._setup(config, obs_dim, action_dim, device)
        return self

    def _setup(self, config, obs_dim: int, action_dim: int, device):
        self.config = config
        self.device = device_mod.resolve(device)
        hidden = tuple(config.model["hidden"])
        self.spec = dict(obs_dim=obs_dim, action_dim=action_dim,
                         hidden=hidden)
        self.policy = DeterministicPolicy(**self.spec)
        self.q1 = QNetworkSA(obs_dim, action_dim, hidden)
        self.q2 = QNetworkSA(obs_dim, action_dim, hidden)
        gen = torch.Generator().manual_seed(config.seed)
        state = {"pi": self.policy.init(gen), "q1": self.q1.init(gen),
                 "q2": self.q2.init(gen)}
        self.state = {name: {k: v.to(self.device) for k, v in p.items()}
                      for name, p in state.items()}
        for name in ("pi", "q1", "q2"):
            self.state[f"{name}_t"] = {k: v.clone()
                                       for k, v in self.state[name].items()}
        t = config.train
        self.opt = {"pi": Adam(t["actor_lr"]), "q": Adam(t["critic_lr"])}
        self.opt_state = self.init_opt_state(self.state)
        self._gen = torch.Generator().manual_seed(config.seed)
        self._update = self._build_update()

    def init_opt_state(self, state) -> Dict[str, Any]:
        """Fresh Adam states for ``state``: the actor's and the two
        critics' together (q1's leaves, then q2's)."""
        return {"pi": self.opt["pi"].init(leaves(state["pi"])),
                "q": self.opt["q"].init(leaves(state["q1"])
                                        + leaves(state["q2"]))}

    def _build_update(self):
        cfg = self.config.train
        gamma, tau = cfg["gamma"], cfg["tau"]
        pnoise, nclip = cfg["policy_noise"], cfg["noise_clip"]
        twin = bool(cfg.get("twin_q", True))
        policy, q1, q2 = self.policy, self.q1, self.q2
        opt = self.opt

        def update(state, opt_state, batch, gen: torch.Generator,
                   do_actor: bool):
            obs, act = batch["obs"], batch["actions"]
            # --- Q target with target policy smoothing; twin_q=False is
            # plain DDPG (single critic, no clipped double-Q)
            with torch.no_grad():
                noise = torch.clamp(
                    pnoise * _normal(gen, act.shape).to(act.device),
                    -nclip, nclip)
                next_a = torch.clamp(
                    policy.apply(state["pi_t"], batch["next_obs"]) + noise,
                    -1.0, 1.0)
                q1_next = q1.apply(state["q1_t"], batch["next_obs"], next_a)
                q_next = (torch.minimum(
                    q1_next, q2.apply(state["q2_t"], batch["next_obs"],
                                      next_a))
                    if twin else q1_next)
                target = (batch["rewards"]
                          + gamma * (1 - batch["dones"]) * q_next)

            k1, k2 = sorted(state["q1"]), sorted(state["q2"])
            p1 = {k: state["q1"][k].detach().requires_grad_() for k in k1}
            p2 = {k: state["q2"][k].detach().requires_grad_() for k in k2}
            e1 = q1.apply(p1, obs, act) - target
            closs = (e1 ** 2).mean()
            if twin:
                e2 = q2.apply(p2, obs, act) - target
                closs = closs + (e2 ** 2).mean()
            # the single critic leaves q2 zero gradients, as JAX's grad does
            wrt = [p1[k] for k in k1] + [p2[k] for k in k2]
            cgrads = [torch.zeros_like(p) if g is None else g
                      for g, p in zip(torch.autograd.grad(
                          closs, wrt, allow_unused=True), wrt)]
            opt["q"].step_(leaves(state["q1"]) + leaves(state["q2"]),
                           cgrads, opt_state["q"])
            aloss = torch.zeros((), device=obs.device)

            if do_actor:
                kp = sorted(state["pi"])
                pp = {k: state["pi"][k].detach().requires_grad_()
                      for k in kp}
                a = policy.apply(pp, obs)
                aloss = -q1.apply(state["q1"], obs, a).mean()
                agrads = torch.autograd.grad(aloss, [pp[k] for k in kp])
                opt["pi"].step_(leaves(state["pi"]), agrads,
                                opt_state["pi"])
                for name in ("pi", "q1", "q2"):
                    polyak_(state[f"{name}_t"], state[name], tau)
            return state, opt_state, closs.detach(), aloss.detach()

        return update

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        t0 = time.time()
        cfg = self.config
        warm = (cfg.replay.get("random_warmup", True)
                and self._env_steps < cfg.replay["learn_starts"])
        weights_ref = ray_tpu_torch.put(self.get_weights())
        per_runner = max(1, cfg.rollout_steps // cfg.num_env_runners)
        batches = ray_tpu_torch.get(
            [r.sample.remote(weights_ref, per_runner, warm)
             for r in self.runners], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self._env_steps += len(b["rewards"])

        closs = aloss = float("nan")
        delay = cfg.train["policy_delay"]
        if len(self.buffer) >= cfg.replay["learn_starts"]:
            for _ in range(cfg.train["train_iters"]):
                s = self.buffer.sample(cfg.train["batch_size"])
                batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in s.items() if not k.startswith("_")}
                self._updates += 1
                self.state, self.opt_state, closs, aloss = self._update(
                    self.state, self.opt_state, batch, self._gen,
                    do_actor=(self._updates % delay == 0))
            closs, aloss = float(closs), float(aloss)

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
            "critic_loss": closs, "actor_loss": aloss,
            "replay_size": len(self.buffer),
            "time_this_iter_s": time.time() - t0,
        }

    def stop(self):
        from .actors import kill_all

        kill_all(getattr(self, "runners", []))
        self.runners = []

    def get_weights(self):
        return to_numpy(self.state["pi"])
