"""ES + ARS: derivative-free policy search over a worker fan-out.

Counterpart of ``ray_tpu/rllib/es.py`` (reference:
``rllib/algorithms/es/es.py``, Salimans et al.'s evolution strategies with
antithetic gaussian perturbations and centred-rank fitness shaping, and
``rllib/algorithms/ars/ars.py``, Augmented Random Search: top-k
directions, reward-std step scaling, MeanStdFilter normalisation).

Workers regenerate each perturbation from a 64-bit seed (``_noise``), so
a direction costs one int on the wire and the driver rebuilds the same
noise for the update; that seed-replicated noise is the algorithm, so
``_noise``, ``centered_rank`` and ``_RunningStat`` are the reference's
numpy, kept as copies of their own.  ``ESPolicy`` keeps the reference's
flat parameter vector: ``ravel_pytree`` of a list of ``{"w", "b"}`` dicts,
per layer ``b`` then ``w`` (sorted keys), so a JAX ``theta`` is the same
policy here.  Its forward runs on the policy's device (``device=None``:
the card), one observation per env step; the rank-weighted update
``theta + lr * (w @ eps) / denom - lr * l2 * theta`` runs on the driver's
device.  The workers are actors of the port's runtime (one CPU each,
their policy on the CPU), as the reference's are: ``theta`` goes to them
through one ``put`` an iteration, and they evaluate their chunks of
seeds at once.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from .models import _standard_normal

__all__ = ["ES", "ESConfig", "ARS", "ARSConfig"]


def _noise(seed: int, dim: int) -> np.ndarray:
    """The perturbation for a seed: identical on worker and driver."""
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def centered_rank(x: np.ndarray) -> np.ndarray:
    """Map fitnesses to centred ranks in [-0.5, 0.5] (fitness shaping: the
    update is invariant to reward scale and outliers)."""
    flat = x.ravel()
    ranks = np.empty(len(flat), dtype=np.float32)
    ranks[flat.argsort()] = np.arange(len(flat), dtype=np.float32)
    ranks = ranks / (len(flat) - 1) - 0.5
    return ranks.reshape(x.shape)


class _RunningStat:
    """Chan-merge running mean/std for observation filtering (reference:
    ray/rllib/utils/filter.py MeanStdFilter semantics)."""

    def __init__(self, dim: int):
        self.count = 0.0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def merge(self, count: float, mean: np.ndarray, m2: np.ndarray):
        if count == 0:
            return
        delta = mean - self.mean
        tot = self.count + count
        self.mean += delta * (count / tot)
        self.m2 += m2 + delta * delta * (self.count * count / tot)
        self.count = tot

    def stats(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.count < 2:
            return self.mean.astype(np.float32), np.ones_like(
                self.mean, dtype=np.float32)
        std = np.sqrt(np.maximum(self.m2 / (self.count - 1), 1e-8))
        return self.mean.astype(np.float32), std.astype(np.float32)


class ESPolicy:
    """Deterministic MLP policy over a flat parameter vector ``theta``
    (tanh hidden layers, a linear output)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(64, 64),
                 continuous: bool = False, seed: int = 0, device=None):
        self.continuous = continuous
        self.device = device_mod.resolve(device)
        sizes = (obs_dim,) + tuple(hidden) + (action_dim,)
        self.sizes = sizes
        gen = torch.Generator().manual_seed(seed)
        flat = []
        for i in range(len(sizes) - 1):
            w = _standard_normal(gen, (sizes[i], sizes[i + 1])) / np.sqrt(
                sizes[i])
            # ravel_pytree's order: per layer the sorted keys, b then w
            flat += [torch.zeros(sizes[i + 1]), w.reshape(-1)]
        self.theta0 = torch.cat(flat).numpy().astype(np.float32)
        self.dim = int(self.theta0.shape[0])

    def as_theta(self, theta) -> torch.Tensor:
        """``theta`` (numpy or a tensor) as f32 on the policy's device."""
        if isinstance(theta, torch.Tensor):
            return theta.to(self.device, torch.float32)
        return torch.tensor(np.asarray(theta, np.float32), device=self.device)

    def forward(self, theta: torch.Tensor, obs: torch.Tensor
                ) -> torch.Tensor:
        """The network's output for ``obs`` [..., obs_dim] under the flat
        ``theta`` (both on the policy's device)."""
        h, off = obs, 0
        last = len(self.sizes) - 2
        for i in range(last + 1):
            n_in, n_out = self.sizes[i], self.sizes[i + 1]
            b = theta[off:off + n_out]
            w = theta[off + n_out:off + n_out + n_in * n_out].reshape(
                n_in, n_out)
            off += n_out + n_in * n_out
            h = h @ w + b
            if i < last:
                h = torch.tanh(h)
        return h

    @torch.no_grad()
    def act(self, theta, obs: np.ndarray):
        """The action for one observation: the argmax (discrete) or
        ``tanh`` of the output (continuous)."""
        out = self.forward(self.as_theta(theta), torch.as_tensor(
            np.asarray(obs, np.float32)).to(self.device)).cpu().numpy()
        if self.continuous:
            return np.tanh(out)
        return int(out.argmax())


class ESWorker:
    """Evaluation worker: regenerates each direction's noise from its seed,
    rolls the antithetic pair, returns (ret+, ret-, len+, len-) per seed
    plus batched observation statistics for the driver's filter merge."""

    def __init__(self, env_name: str, spec: Dict[str, Any], seed: int = 0,
                 env_config: Optional[dict] = None,
                 episode_horizon: int = 1000, device=None):
        import gymnasium as gym

        from . import examples_env  # noqa: F401 (registers Bandit-v0)
        self.env = gym.make(env_name, **(env_config or {}))
        self.policy = ESPolicy(**spec, seed=seed, device=device)
        self.horizon = episode_horizon
        self._ep_seed = seed

    def _rollout(self, theta: np.ndarray, mean: np.ndarray,
                 std: np.ndarray, collect) -> Tuple[float, int]:
        theta = self.policy.as_theta(theta)   # one copy per episode
        obs, _ = self.env.reset(seed=self._ep_seed)
        self._ep_seed += 1
        total, steps = 0.0, 0
        for _ in range(self.horizon):
            flat = np.asarray(obs, np.float32).ravel()
            if collect is not None:
                collect.append(flat)
            a = self.policy.act(theta, (flat - mean) / std)
            obs, r, term, trunc, _ = self.env.step(a)
            total += float(r)
            steps += 1
            if term or trunc:
                break
        return total, steps

    def evaluate(self, theta_blob, seeds: List[int], sigma: float,
                 mean: np.ndarray, std: np.ndarray) -> Dict[str, Any]:
        theta = np.asarray(theta_blob, np.float32)
        rets, lens, obs_acc = [], [], []
        for s in seeds:
            eps = _noise(int(s), self.policy.dim)
            rp, lp = self._rollout(theta + sigma * eps, mean, std, obs_acc)
            rn, ln = self._rollout(theta - sigma * eps, mean, std, obs_acc)
            rets.append((rp, rn))
            lens.append((lp, ln))
        if obs_acc:
            batch = np.stack(obs_acc).astype(np.float64)
            stats = (float(len(batch)), batch.mean(0),
                     ((batch - batch.mean(0)) ** 2).sum(0))
        else:
            stats = (0.0, 0.0, 0.0)
        return {"returns": np.asarray(rets, np.float32),
                "lengths": np.asarray(lens, np.int64),
                "obs_stats": stats}

    def rollout_current(self, theta_blob, mean, std) -> float:
        """Unperturbed evaluation episode (reference: eval_prob rollouts)."""
        ret, _ = self._rollout(np.asarray(theta_blob, np.float32),
                               mean, std, None)
        return ret

    def ping(self) -> bool:
        return True


class ESConfig:
    """Builder (reference: ESConfig fluent API)."""

    _algo_cls: Optional[type] = None

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 2
        self.cfg: Dict[str, Any] = dict(
            num_perturbations=32,   # antithetic pairs per iteration
            sigma=0.02,             # noise stddev (reference: noise_stdev)
            lr=0.01,                # step size
            l2_coeff=0.005,         # weight decay toward 0
            hidden=(64, 64),
            episode_horizon=1000,
            observation_filter="MeanStdFilter",
            eval_episodes=4,        # unperturbed rollouts per iteration
        )
        self.seed = 0

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = env_config or {}
        return self

    def env_runners(self, num_env_runners: int = 2, **_):
        self.num_env_runners = num_env_runners
        return self

    def training(self, **kwargs):
        self.cfg.update(kwargs)
        return self

    def debugging(self, seed: int = 0):
        self.seed = seed
        return self

    def build(self, device=None) -> "ES":
        if not self.env_name:
            raise ValueError("call .environment(env_name) first")
        return (self._algo_cls or ES)(self, device=device)


class ES:
    """Driver: seed fan-out -> antithetic evaluation -> the rank-weighted
    update on the driver's device.

    ``train()`` returns the usual result dict (episode_return_mean, ...).
    """

    def __init__(self, config: ESConfig, device=None):
        import gymnasium as gym

        import ray_tpu_torch

        from . import examples_env  # noqa: F401

        probe = gym.make(config.env_name, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        continuous = not hasattr(probe.action_space, "n")
        action_dim = (probe.action_space.shape[0] if continuous
                      else int(probe.action_space.n))
        probe.close()
        self._setup(config, obs_dim, action_dim, continuous, device)
        cfg = config.cfg
        worker_cls = ray_tpu_torch.remote(ESWorker)
        self.workers = [
            worker_cls.options(num_cpus=1).remote(
                config.env_name, self.spec, seed=config.seed + 1000 * i,
                env_config=config.env_config,
                episode_horizon=cfg["episode_horizon"], device="cpu")
            for i in range(config.num_env_runners)]

    @classmethod
    def learner_only(cls, config: ESConfig, obs_dim: int, action_dim: int,
                     continuous: bool = False, device=None) -> "ES":
        """The policy, ``theta``, the filter and the update alone, for these
        sizes: no env, no worker and no gymnasium (``train`` needs them)."""
        self = cls.__new__(cls)
        self._setup(config, obs_dim, action_dim, continuous, device)
        return self

    def _setup(self, config, obs_dim, action_dim, continuous, device):
        self.config = config
        cfg = config.cfg
        self.device = device_mod.resolve(device)
        self.spec = dict(obs_dim=obs_dim, action_dim=action_dim,
                         hidden=tuple(cfg["hidden"]), continuous=continuous)
        self._policy = ESPolicy(**self.spec, seed=config.seed,
                                device=self.device)
        self.dim = self._policy.dim
        self.theta = self._policy.theta0.copy()
        self.filter = _RunningStat(obs_dim)
        self._use_filter = cfg["observation_filter"] == "MeanStdFilter"
        self._seed_seq = np.random.SeedSequence(config.seed)
        self.workers: List[Any] = []
        self._iteration = 0
        self._timesteps = 0

    @torch.no_grad()
    def _apply_update(self, theta: np.ndarray, eps: np.ndarray,
                      w: np.ndarray, denom: float) -> np.ndarray:
        """The rank-weighted matvec and the weight decay, on the driver's
        device, in f32."""
        cfg = self.config.cfg
        lr, l2 = float(cfg["lr"]), float(cfg["l2_coeff"])
        t = torch.as_tensor(theta, dtype=torch.float32).to(self.device)
        e = torch.as_tensor(eps, dtype=torch.float32).to(self.device)
        # a tensor divisor: CUDA turns division by a Python number into a
        # multiply by its reciprocal, one rounding off the reference's
        g = (torch.as_tensor(w, dtype=torch.float32).to(self.device) @ e
             ) / torch.tensor(denom, dtype=torch.float32, device=self.device)
        return (t + lr * g - lr * l2 * t).cpu().numpy()

    # -- one iteration -----------------------------------------------------
    def _direction_weights(self, rets: np.ndarray) -> Tuple[np.ndarray,
                                                            np.ndarray,
                                                            float]:
        """ES weighting: centred-rank-shape all 2n returns, weight each
        direction by rank(ret+) - rank(ret-).  Returns (weights, used-return
        mask over directions, denominator)."""
        shaped = centered_rank(rets)
        w = shaped[:, 0] - shaped[:, 1]
        n = float(len(rets))
        return w, np.ones(len(rets), bool), n * float(self.config.cfg["sigma"])

    def update_from_returns(self, seeds: List[int], rets: np.ndarray) -> None:
        """The driver's update from the directions' returns ``rets`` [n, 2]
        (one row per seed): the weights, then ``theta``'s step."""
        w, used, denom = self._direction_weights(rets)
        idx = np.flatnonzero(used)
        eps = np.stack([_noise(seeds[i], self.dim) for i in idx])
        self.theta = self._apply_update(
            self.theta, eps, w[idx].astype(np.float32), float(denom))

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        cfg = self.config.cfg
        t0 = time.time()
        n = int(cfg["num_perturbations"])
        seeds = [int(s.generate_state(1)[0]) for s in
                 self._seed_seq.spawn(n)]
        mean, std = (self.filter.stats() if self._use_filter else
                     (np.zeros(self.spec["obs_dim"], np.float32),
                      np.ones(self.spec["obs_dim"], np.float32)))
        theta_ref = ray_tpu_torch.put(self.theta)
        chunks = np.array_split(np.asarray(seeds), len(self.workers))
        futs = [w.evaluate.remote(theta_ref, [int(x) for x in chunk],
                                  float(cfg["sigma"]), mean, std)
                for w, chunk in zip(self.workers, chunks) if len(chunk)]
        outs = ray_tpu_torch.get(futs, timeout=600)
        rets = np.concatenate([o["returns"] for o in outs])     # [n, 2]
        lens = np.concatenate([o["lengths"] for o in outs])
        if self._use_filter:
            for o in outs:
                c, m, m2 = o["obs_stats"]
                if c:
                    self.filter.merge(c, m, m2)
        self.update_from_returns(seeds, rets)

        # unperturbed evaluation rollouts for the reported return
        eval_rets = ray_tpu_torch.get(
            [self.workers[i % len(self.workers)].rollout_current.remote(
                self.theta, mean, std)
             for i in range(int(cfg["eval_episodes"]))], timeout=600)
        self._iteration += 1
        self._timesteps += int(lens.sum())
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": float(np.mean(eval_rets)),
            "perturbed_return_mean": float(rets.mean()),
            "timesteps_total": self._timesteps,
            "num_perturbations": n,
            "theta_norm": float(np.linalg.norm(self.theta)),
            "time_this_iter_s": time.time() - t0,
        }

    # -- checkpoint surface (Tune trainable protocol) ----------------------
    def get_weights(self) -> Dict[str, Any]:
        return {"theta": self.theta.copy(),
                "filter": (self.filter.count, self.filter.mean.copy(),
                           self.filter.m2.copy())}

    def set_weights(self, blob: Dict[str, Any]):
        self.theta = np.asarray(blob["theta"], np.float32).copy()
        c, m, m2 = blob["filter"]
        self.filter.count = c
        self.filter.mean = np.asarray(m, np.float64).copy()
        self.filter.m2 = np.asarray(m2, np.float64).copy()

    def compute_single_action(self, obs: np.ndarray):
        mean, std = (self.filter.stats() if self._use_filter else
                     (0.0, 1.0))
        flat = np.asarray(obs, np.float32).ravel()
        return self._policy.act(self.theta, (flat - mean) / std)

    def stop(self):
        from .actors import kill_all

        kill_all(self.workers)
        self.workers = []


class ARSConfig(ESConfig):
    """ARS (reference: ARSConfig): fewer, bigger steps: top-k direction
    selection and reward-std scaling instead of rank shaping."""

    def __init__(self):
        super().__init__()
        self.cfg.update(
            num_perturbations=16,
            top_k=8,            # reference: num_top_directions
            sigma=0.03,
            lr=0.02,
            l2_coeff=0.0,       # ARS does not regularise
        )


class ARS(ES):
    """ARS-v2: keep the top-k directions by best-of-pair return, step by
    the raw return difference scaled by the std of the used returns."""

    def _direction_weights(self, rets: np.ndarray):
        cfg = self.config.cfg
        k = min(int(cfg.get("top_k", len(rets))), len(rets))
        order = np.argsort(rets.max(axis=1))[::-1][:k]
        used = np.zeros(len(rets), bool)
        used[order] = True
        sigma_r = float(rets[order].std()) + 1e-8
        w = np.zeros(len(rets), np.float32)
        w[order] = rets[order, 0] - rets[order, 1]
        return w, used, k * sigma_r


ESConfig._algo_cls = ES
ARSConfig._algo_cls = ARS
