"""SAC: off-policy maximum-entropy actor-critic for continuous control.

Counterpart of ``ray_tpu/rllib/sac.py`` (reference:
``rllib/algorithms/sac/``): twin Q networks with target smoothing, a
tanh-squashed Gaussian policy, and automatic entropy-temperature tuning.
The update runs in the reference's order, on the driver's device: the
critics, then the actor against the new critics, then the temperature from
the actor's log-probs, then Polyak on both targets; three Adam states, one
of them over both critics together.

The update's two normal draws (next actions, then actions) go through
``_normal``, which a test can replace with JAX's; the driver draws them on
the host from a ``torch.Generator`` seeded from the config's seed.  The
runners are actors of the port's runtime with their policy on the CPU,
as the reference's are; ``SAC.learner_only`` builds the update alone,
with no env and no gymnasium.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as device_mod
from .learner import leaves, to_device, to_numpy
# the update's draw function, which a test can replace with JAX's draws
from .models import _standard_normal as _normal
from .models import mlp_init, polyak_, relu_mlp
from .optim import Adam

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0
_LOG_2PI = math.log(2 * math.pi)
_LOG_2 = math.log(2.0)


class SquashedGaussianPolicy:
    """MLP -> (mean, log_std) -> tanh-squashed action in [-1, 1]^A."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 256)):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)

    def init(self, gen: torch.Generator):
        return mlp_init(gen, (self.obs_dim,) + self.hidden
                        + (2 * self.action_dim,), last_scale=0.01)

    def forward(self, params, obs):
        out = relu_mlp(params, obs, len(self.hidden))
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample(self, params, obs, gen: torch.Generator):
        """Reparameterized squashed sample -> (action, log_prob)."""
        mean, log_std = self.forward(params, obs)
        std = torch.exp(log_std)
        eps = _normal(gen, mean.shape).to(mean.device)
        pre = mean + std * eps
        act = torch.tanh(pre)
        # log prob with tanh change-of-variables (numerically stable form)
        lp = (-0.5 * (eps ** 2 + 2 * log_std + _LOG_2PI)).sum(-1)
        lp = lp - (2 * (_LOG_2 - pre - F.softplus(-2 * pre))).sum(-1)
        return act, lp


class QNetworkSA:
    """Q(s, a) MLP (concatenated input)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 256)):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)

    def init(self, gen: torch.Generator):
        return mlp_init(gen, (self.obs_dim + self.action_dim,) + self.hidden
                        + (1,))

    def apply(self, params, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return relu_mlp(params, x, len(self.hidden))[..., 0]


class SACRunner:
    """Rollout worker: squashed-Gaussian exploration, env-scaled actions."""

    def __init__(self, env_name: str, spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0,
                 env_config: Optional[dict] = None, device=None):
        import gymnasium as gym

        self.device = device_mod.resolve(device)
        self.envs = [gym.make(env_name, **(env_config or {}))
                     for _ in range(num_envs)]
        self.policy = SquashedGaussianPolicy(**spec)
        self.num_envs = num_envs
        space = self.envs[0].action_space
        self.act_low = np.asarray(space.low, np.float32)
        self.act_high = np.asarray(space.high, np.float32)
        self._seed = seed
        self._calls = 0
        self.obs = np.stack([e.reset(seed=seed + i)[0]
                             for i, e in enumerate(self.envs)],
                            dtype=np.float32)
        self._ep_returns = np.zeros(num_envs)
        self._done_returns: List[float] = []

    def _scale(self, a: np.ndarray) -> np.ndarray:
        return self.act_low + (a + 1.0) * 0.5 * (self.act_high - self.act_low)

    @torch.no_grad()
    def sample(self, params_blob, steps: int, random_actions: bool = False
               ) -> Dict[str, np.ndarray]:
        params = to_device(params_blob, self.device)
        N = self.num_envs
        T = max(1, steps // N)
        A = self.policy.action_dim
        rng = np.random.default_rng(self._seed * 7919 + self._calls)
        self._calls += 1
        buf = {
            "obs": np.zeros((T * N,) + self.obs.shape[1:], np.float32),
            "actions": np.zeros((T * N, A), np.float32),
            "rewards": np.zeros((T * N,), np.float32),
            "next_obs": np.zeros((T * N,) + self.obs.shape[1:], np.float32),
            "dones": np.zeros((T * N,), np.float32),
        }
        k = 0
        for t in range(T):
            if random_actions:  # warmup: uniform in the squashed range
                acts = rng.uniform(-1, 1, (N, A)).astype(np.float32)
            else:
                gen = torch.Generator().manual_seed(
                    (self._seed << 18) ^ self._calls ^ (t << 1))
                acts, _ = self.policy.sample(
                    params, torch.as_tensor(self.obs).to(self.device), gen)
                acts = acts.cpu().numpy()
            for i, env in enumerate(self.envs):
                nobs, rew, term, trunc, _ = env.step(self._scale(acts[i]))
                buf["obs"][k] = self.obs[i]
                buf["actions"][k] = acts[i]
                buf["rewards"][k] = rew
                buf["next_obs"][k] = np.asarray(nobs, np.float32)
                buf["dones"][k] = float(term)
                self._ep_returns[i] += rew
                if term or trunc:
                    self._done_returns.append(self._ep_returns[i])
                    self._ep_returns[i] = 0.0
                    nobs, _ = env.reset()
                self.obs[i] = np.asarray(nobs, np.float32)
                k += 1
        return buf

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._done_returns)
        if clear:
            self._done_returns.clear()
        return out

    def ping(self) -> bool:
        return True


class SACConfig:
    """Builder (reference: SACConfig fluent API)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 1
        self.num_envs_per_runner = 1
        self.rollout_steps = 256
        self.train: Dict[str, Any] = dict(
            actor_lr=3e-4, critic_lr=3e-4, alpha_lr=3e-4, gamma=0.99,
            tau=0.005, batch_size=256, train_iters=8,
            target_entropy=None, init_alpha=0.1)
        self.model: Dict[str, Any] = dict(hidden=(256, 256))
        self.replay: Dict[str, Any] = dict(capacity=100_000,
                                           learn_starts=1_000,
                                           random_warmup=True)
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

    def debugging(self, seed: int = 0):
        self.seed = seed
        return self

    def build(self, device=None) -> "SAC":
        if not self.env_name:
            raise ValueError("call .environment(env_name) first")
        return SAC(self, device=device)


class SAC:
    """Driver: stochastic rollouts -> replay -> the SAC update on the
    driver's device (``device=None``: the card)."""

    def __init__(self, config: SACConfig, device=None):
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
        runner_cls = ray_tpu_torch.remote(SACRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                config.env_name, self.spec,
                num_envs=config.num_envs_per_runner,
                seed=config.seed + 1000 * i,
                env_config=config.env_config, device="cpu")
            for i in range(config.num_env_runners)]
        self._iteration = 0
        self._env_steps = 0
        self._recent_returns: List[float] = []

    @classmethod
    def learner_only(cls, config: SACConfig, obs_dim: int, action_dim: int,
                     device=None) -> "SAC":
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
        self.policy = SquashedGaussianPolicy(**self.spec)
        self.q1 = QNetworkSA(obs_dim, action_dim, hidden)
        self.q2 = QNetworkSA(obs_dim, action_dim, hidden)
        gen = torch.Generator().manual_seed(config.seed)
        state = {"pi": self.policy.init(gen), "q1": self.q1.init(gen),
                 "q2": self.q2.init(gen)}
        self.state = {name: {k: v.to(self.device) for k, v in p.items()}
                      for name, p in state.items()}
        t = config.train
        self.state["log_alpha"] = torch.tensor(
            np.log(t["init_alpha"]), dtype=torch.float32, device=self.device)
        self.state["q1_t"] = {k: v.clone()
                              for k, v in self.state["q1"].items()}
        self.state["q2_t"] = {k: v.clone()
                              for k, v in self.state["q2"].items()}
        self.opt = {"pi": Adam(t["actor_lr"]), "q": Adam(t["critic_lr"]),
                    "alpha": Adam(t["alpha_lr"])}
        self.opt_state = self.init_opt_state(self.state)
        self.target_entropy = (t["target_entropy"]
                               if t["target_entropy"] is not None
                               else -float(action_dim))
        self._gen = torch.Generator().manual_seed(config.seed)
        self._update = self._build_update()

    def init_opt_state(self, state) -> Dict[str, Any]:
        """Fresh Adam states for ``state``: the actor's, the two critics'
        together (q1's leaves, then q2's) and the temperature's."""
        return {"pi": self.opt["pi"].init(leaves(state["pi"])),
                "q": self.opt["q"].init(leaves(state["q1"])
                                        + leaves(state["q2"])),
                "alpha": self.opt["alpha"].init([state["log_alpha"]])}

    def _build_update(self):
        cfg = self.config.train
        gamma, tau = cfg["gamma"], cfg["tau"]
        policy, q1, q2 = self.policy, self.q1, self.q2
        target_entropy = self.target_entropy
        opt = self.opt

        def update(state, opt_state, batch, gen: torch.Generator):
            alpha = torch.exp(state["log_alpha"])
            obs, act = batch["obs"], batch["actions"]

            # --- critics
            with torch.no_grad():
                next_a, next_lp = policy.sample(state["pi"],
                                                batch["next_obs"], gen)
                q_next = torch.minimum(
                    q1.apply(state["q1_t"], batch["next_obs"], next_a),
                    q2.apply(state["q2_t"], batch["next_obs"], next_a))
                target = batch["rewards"] + gamma * (1 - batch["dones"]) * (
                    q_next - alpha * next_lp)
            k1, k2 = sorted(state["q1"]), sorted(state["q2"])
            p1 = {k: state["q1"][k].detach().requires_grad_() for k in k1}
            p2 = {k: state["q2"][k].detach().requires_grad_() for k in k2}
            e1 = q1.apply(p1, obs, act) - target
            e2 = q2.apply(p2, obs, act) - target
            closs = (e1 ** 2).mean() + (e2 ** 2).mean()
            cgrads = torch.autograd.grad(
                closs, [p1[k] for k in k1] + [p2[k] for k in k2])
            opt["q"].step_(leaves(state["q1"]) + leaves(state["q2"]),
                           cgrads, opt_state["q"])

            # --- actor (reparameterized), against the new critics
            kp = sorted(state["pi"])
            pp = {k: state["pi"][k].detach().requires_grad_() for k in kp}
            a, lp = policy.sample(pp, obs, gen)
            q = torch.minimum(q1.apply(state["q1"], obs, a),
                              q2.apply(state["q2"], obs, a))
            aloss = (alpha * lp - q).mean()
            agrads = torch.autograd.grad(aloss, [pp[k] for k in kp])
            opt["pi"].step_(leaves(state["pi"]), agrads, opt_state["pi"])

            # --- temperature
            la = state["log_alpha"].detach().requires_grad_()
            alpha_loss = -(torch.exp(la) * (lp.detach()
                                            + target_entropy)).mean()
            algrad = torch.autograd.grad(alpha_loss, [la])
            opt["alpha"].step_([state["log_alpha"]], algrad,
                               opt_state["alpha"])

            polyak_(state["q1_t"], state["q1"], tau)
            polyak_(state["q2_t"], state["q2"], tau)
            return state, opt_state, closs.detach(), aloss.detach(), alpha

        return update

    def _device_batch(self, sample) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in sample.items() if not k.startswith("_")}

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

        closs = aloss = alpha_v = float("nan")
        if len(self.buffer) >= cfg.replay["learn_starts"]:
            for _ in range(cfg.train["train_iters"]):
                s = self.buffer.sample(cfg.train["batch_size"])
                (self.state, self.opt_state, closs, aloss,
                 alpha_v) = self._update(self.state, self.opt_state,
                                         self._device_batch(s), self._gen)
            closs, aloss, alpha_v = (float(closs), float(aloss),
                                     float(alpha_v))

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
            "critic_loss": closs, "actor_loss": aloss, "alpha": alpha_v,
            "replay_size": len(self.buffer),
            "time_this_iter_s": time.time() - t0,
        }

    def stop(self):
        from .actors import kill_all

        kill_all(getattr(self, "runners", []))
        self.runners = []

    def get_weights(self):
        return to_numpy(self.state["pi"])
