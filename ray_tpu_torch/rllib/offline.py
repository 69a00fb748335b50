"""Offline RL: episode datasets + BC / MARWIL / CQL training.

Counterpart of ``ray_tpu/rllib/offline.py`` (reference: ``rllib/offline/``,
``rllib/algorithms/marwil``, ``bc`` and ``cql``).  The episode IO and the
datasets are the reference's numpy, kept as copies of their own, and the
minibatch draws are the reference's ``np.random.default_rng(seed)``, so
the same corpus and seed give the same minibatches.  The reference jits
each update; here it runs eagerly on the learner's device (``device=None``:
the card), ending in optax's ``chain(clip_by_global_norm, adam)``
(``optim.Adam``).  The dataset is copied to the device once, and each
update copies only its row indices there.  ``train()`` keeps its
per-update losses on the device and reads them once at the end.

The drivers probe their env with gymnasium (imported by the
constructors); ``MARWIL.learner_only`` / ``CQL.learner_only`` build the
learner from the observation and action sizes and a dataset alone, with
no gymnasium.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from .learner import leaves, to_numpy
from .optim import Adam


# ---------------------------------------------------------------------------
# episode IO (reference: offline/json_reader.py / json_writer.py)
# ---------------------------------------------------------------------------

def write_episodes(path: str, episodes: List[Dict[str, Any]]) -> int:
    """Append episodes ({obs, actions, rewards} lists) as JSON lines."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        for ep in episodes:
            f.write(json.dumps({
                "obs": np.asarray(ep["obs"]).tolist(),
                "actions": np.asarray(ep["actions"]).tolist(),
                "rewards": np.asarray(ep["rewards"]).tolist(),
            }) + "\n")
    return len(episodes)


def collect_episodes(env_name: str, policy_fn: Callable[[np.ndarray], int],
                     num_episodes: int, path: Optional[str] = None,
                     env_config: Optional[dict] = None,
                     seed: int = 0) -> List[Dict[str, Any]]:
    """Roll a (scripted or learned) policy and optionally persist the
    episodes: the offline corpus generator for tests and demos."""
    import gymnasium as gym
    env = gym.make(env_name, **(env_config or {}))
    episodes = []
    try:
        for i in range(num_episodes):
            obs, _ = env.reset(seed=seed + i)
            ep = {"obs": [], "actions": [], "rewards": []}
            done = False
            while not done:
                a = int(policy_fn(np.asarray(obs)))
                ep["obs"].append(np.asarray(obs).tolist())
                ep["actions"].append(a)
                obs, r, term, trunc, _ = env.step(a)
                ep["rewards"].append(float(r))
                done = term or trunc
            episodes.append(ep)
    finally:
        env.close()
    if path:
        write_episodes(path, episodes)
    return episodes


class OfflineDataset:
    """Flattened (obs, action, mc_return) transitions from episode files."""

    def __init__(self, obs: np.ndarray, actions: np.ndarray,
                 returns: np.ndarray):
        self.obs = obs
        self.actions = actions
        self.returns = returns

    def __len__(self):
        return len(self.obs)

    @classmethod
    def from_jsonl(cls, path: str, gamma: float = 0.99) -> "OfflineDataset":
        obs, acts, rets = [], [], []
        with open(path) as f:
            for line in f:
                ep = json.loads(line)
                r = np.asarray(ep["rewards"], np.float32)
                # discounted Monte-Carlo return-to-go per step
                g = np.zeros_like(r)
                acc = 0.0
                for t in range(len(r) - 1, -1, -1):
                    acc = r[t] + gamma * acc
                    g[t] = acc
                obs.append(np.asarray(ep["obs"], np.float32))
                acts.append(np.asarray(ep["actions"]))
                rets.append(g)
        return cls(np.concatenate(obs), np.concatenate(acts),
                   np.concatenate(rets))


class TransitionDataset:
    """(obs, action, reward, next_obs, done) tuples for Q-learning.

    Same JSONL wire shape as OfflineDataset; the episode's last transition
    bootstraps to a terminal next state (done=1)."""

    def __init__(self, obs, actions, rewards, next_obs, dones):
        self.obs = obs
        self.actions = actions
        self.rewards = rewards
        self.next_obs = next_obs
        self.dones = dones

    def __len__(self):
        return len(self.obs)

    @classmethod
    def from_jsonl(cls, path: str) -> "TransitionDataset":
        obs, acts, rews, nxt, dones = [], [], [], [], []
        with open(path) as f:
            for line in f:
                ep = json.loads(line)
                o = np.asarray(ep["obs"], np.float32)
                if len(o) == 0:
                    continue
                obs.append(o)
                acts.append(np.asarray(ep["actions"]))
                rews.append(np.asarray(ep["rewards"], np.float32))
                # next_obs: shift; the last step re-uses its own obs but is
                # masked by done=1 so the bootstrap term vanishes
                nxt.append(np.concatenate([o[1:], o[-1:]], axis=0))
                d = np.zeros(len(o), np.float32)
                d[-1] = 1.0
                dones.append(d)
        return cls(np.concatenate(obs), np.concatenate(acts),
                   np.concatenate(rews), np.concatenate(nxt),
                   np.concatenate(dones))


# ---------------------------------------------------------------------------
# MARWIL / BC
# ---------------------------------------------------------------------------

class MARWILConfig:
    """Builder mirroring the on-policy config style (reference:
    algorithms/marwil/marwil.py MARWILConfig).  beta=0.0 is exact behavior
    cloning (the advantage weight collapses to 1)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.input_path: Optional[str] = None
        self.cfg: Dict[str, Any] = {
            "lr": 1e-3, "beta": 1.0, "vf_coeff": 1.0, "grad_clip": 10.0,
            "train_batch_size": 512, "gamma": 0.99, "hidden": (64, 64),
            "advantage_clip": 10.0, "updates_per_iter": 50, "seed": 0,
        }

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = env_config or {}
        return self

    def offline_data(self, input_path: str):
        self.input_path = input_path
        return self

    def training(self, **kwargs):
        self.cfg.update(kwargs)
        return self

    _algo_cls: Optional[type] = None

    def build(self, device=None):
        if not (self.env_name and self.input_path):
            raise ValueError("need .environment(...) and .offline_data(...)")
        return (self._algo_cls or MARWIL)(self, device=device)


class BCConfig(MARWILConfig):
    """Behavior cloning = MARWIL with beta=0 (reference: algorithms/bc)."""

    def __init__(self):
        super().__init__()
        self.cfg["beta"] = 0.0


class _OfflineLearner:
    """What MARWIL and CQL share: the env probe, ``learner_only``, the
    dataset on the device, the minibatch loop and the greedy evaluation.
    A subclass sets ``_dataset`` / ``_fields`` / ``_metrics`` and defines
    ``_build(obs_dim, action_dim)``, ``_loss`` and ``_greedy``."""

    _fields: tuple = ()
    _metrics: tuple = ()

    def __init__(self, config: MARWILConfig, device=None):
        import gymnasium as gym

        env = gym.make(config.env_name, **config.env_config)
        obs_dim = int(np.prod(env.observation_space.shape))
        action_dim = int(env.action_space.n)
        env.close()
        self._setup(config, obs_dim, action_dim, None, device)

    @classmethod
    def learner_only(cls, config: MARWILConfig, obs_dim: int,
                     action_dim: int, device=None, data=None):
        """The learner alone, for these sizes, on ``data`` (default: the
        config's ``offline_data`` path read as the driver reads it): no env
        and no gymnasium (``evaluate`` needs them)."""
        self = cls.__new__(cls)
        self._setup(config, obs_dim, action_dim, data, device)
        return self

    def _setup(self, config, obs_dim: int, action_dim: int, data, device):
        self.config = config
        cfg = config.cfg
        self.device = device_mod.resolve(device)
        self.data = data if data is not None else self._read(config)
        # the whole dataset on the device once; an update copies its indices
        self._data = {k: torch.as_tensor(getattr(self.data, k)).to(
            self.device) for k in self._fields}
        self.model = self._build(obs_dim, action_dim)
        params = self.model.init(torch.Generator().manual_seed(cfg["seed"]))
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.opt = Adam(cfg["lr"], grad_clip=cfg["grad_clip"])
        self.opt_state = self.opt.init(leaves(self.params))
        self._rng = np.random.default_rng(cfg["seed"])
        self.iteration = 0

    def _step(self, batch) -> torch.Tensor:
        """One Adam step on ``_loss``, in place: [loss, *aux] on the
        device.  A leaf the loss does not reach (the value head under
        BC) gets a zero gradient, as JAX gives it."""
        keys = sorted(self.params)
        p = {k: self.params[k].detach().requires_grad_() for k in keys}
        loss, aux = self._loss(p, batch)
        grads = torch.autograd.grad(loss, [p[k] for k in keys],
                                    allow_unused=True)
        grads = [torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(keys, grads)]
        self.opt.step_(leaves(self.params), grads, self.opt_state)
        return torch.stack([loss.detach(), *(a.detach() for a in aux)])

    def _after_update(self) -> None:
        """Hook after each update (CQL's target copy)."""

    def train(self) -> Dict[str, Any]:
        cfg = self.config.cfg
        n = len(self.data)
        bs = min(cfg["train_batch_size"], n)
        rows = []
        for _ in range(cfg["updates_per_iter"]):
            idx = torch.from_numpy(self._rng.integers(0, n, bs)).to(
                self.device)
            rows.append(self._step({k: v[idx]
                                    for k, v in self._data.items()}))
            self._after_update()
        # one read of every update's losses; means in float64, as the
        # reference's np.mean of Python floats
        means = torch.stack(rows).cpu().double().mean(0).tolist()
        self.iteration += 1
        return {"training_iteration": self.iteration,
                **dict(zip(self._metrics, means)),
                "num_transitions": n}

    @torch.no_grad()
    def compute_action(self, obs: np.ndarray) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32))[None].to(
            self.device)
        return int(self._greedy(x).argmax(-1)[0])

    def evaluate(self, num_episodes: int = 5, seed: int = 10_000) -> float:
        """Greedy-policy mean episode return in the real env."""
        eps = collect_episodes(self.config.env_name, self.compute_action,
                               num_episodes,
                               env_config=self.config.env_config, seed=seed)
        return float(np.mean([sum(ep["rewards"]) for ep in eps]))

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.params)


class MARWIL(_OfflineLearner):
    """Offline learner: the advantage-weighted NLL and the value regression
    over sampled minibatches (beta=0: plain behavior cloning)."""

    _fields = ("obs", "actions", "returns")
    _metrics = ("loss", "policy_loss", "vf_loss")

    @staticmethod
    def _read(config) -> OfflineDataset:
        return OfflineDataset.from_jsonl(config.input_path,
                                         gamma=config.cfg["gamma"])

    def _build(self, obs_dim: int, action_dim: int):
        from .models import ActorCriticMLP
        return ActorCriticMLP(obs_dim, action_dim,
                              hidden=tuple(self.config.cfg["hidden"]))

    def _loss(self, params, batch):
        cfg = self.config.cfg
        beta = float(cfg["beta"])
        aclip = float(cfg["advantage_clip"])
        returns = batch["returns"]
        pi_out, value = self.model.apply(params, batch["obs"])
        logp = self.model.log_prob(pi_out, batch["actions"])
        if beta > 0:
            adv = returns - value.detach()
            # RMS-normalised before exponentiating (the reference MARWIL's
            # running moment): beta's meaning does not depend on the env's
            # reward scale
            adv = adv / (torch.sqrt((adv ** 2).mean()) + 1e-8)
            w = torch.exp(torch.clamp(beta * adv, -aclip, aclip)).detach()
            vf_loss = ((value - returns) ** 2).mean()
            total_vf = float(cfg["vf_coeff"]) * vf_loss
        else:
            # pure BC: no advantage weight and no value term at all (its
            # early regression gradients would eat the global-norm clip)
            w = 1.0
            vf_loss = torch.zeros((), device=logp.device)
            total_vf = 0.0
        pi_loss = -(w * logp).mean()
        return pi_loss + total_vf, (pi_loss, vf_loss)

    def _greedy(self, obs):
        return self.model.apply(self.params, obs)[0]


MARWILConfig._algo_cls = MARWIL


# ---------------------------------------------------------------------------
# CQL: conservative Q-learning from the same JSONL corpora
# ---------------------------------------------------------------------------

class CQLConfig(MARWILConfig):
    """Conservative Q-Learning (reference: ``rllib/algorithms/cql/cql.py``,
    there SAC-based for continuous control; here the discrete-action CQL(H)
    of the JAX package: the penalty ``logsumexp_a Q(s,a) - Q(s, a_data)``
    needs no action sampling when the action set is enumerable)."""

    def __init__(self):
        super().__init__()
        self.cfg.update(
            lr=3e-4, cql_alpha=1.0, target_update_every=100,
            train_batch_size=256, updates_per_iter=100, gamma=0.99,
        )


class CQL(_OfflineLearner):
    """Offline Q-learner: a double-Q TD loss plus the conservative penalty;
    the target network is copied every ``target_update_every`` updates."""

    _fields = ("obs", "actions", "rewards", "next_obs", "dones")
    _metrics = ("loss", "td_loss", "cql_gap")

    def _setup(self, config, obs_dim, action_dim, data, device):
        super()._setup(config, obs_dim, action_dim, data, device)
        self.target_params = {k: v.clone() for k, v in self.params.items()}
        self._updates = 0

    @staticmethod
    def _read(config) -> TransitionDataset:
        return TransitionDataset.from_jsonl(config.input_path)

    def _build(self, obs_dim: int, action_dim: int):
        from .dqn import QNetwork
        return QNetwork(obs_dim, action_dim,
                        hidden=tuple(self.config.cfg["hidden"]))

    def _loss(self, params, batch):
        cfg = self.config.cfg
        model = self.model
        actions = batch["actions"][:, None].long()
        q = model.apply(params, batch["obs"])                    # [B, A]
        q_data = torch.gather(q, 1, actions)[:, 0]
        with torch.no_grad():
            # double-Q target: select with the online net, evaluate with
            # the target net
            sel = model.apply(params, batch["next_obs"]).argmax(1)
            boot = torch.gather(model.apply(self.target_params,
                                            batch["next_obs"]),
                                1, sel[:, None])[:, 0]
            target = (batch["rewards"]
                      + float(cfg["gamma"]) * (1.0 - batch["dones"]) * boot)
        td = ((q_data - target) ** 2).mean()
        # the conservative term: push the value estimate down everywhere,
        # up only on the dataset's actions
        gap = (torch.logsumexp(q, dim=1) - q_data).mean()
        return td + float(cfg["cql_alpha"]) * gap, (td, gap)

    def _after_update(self) -> None:
        self._updates += 1
        if self._updates % int(self.config.cfg["target_update_every"]) == 0:
            self.target_params = {k: v.detach().clone()
                                  for k, v in self.params.items()}

    def _greedy(self, obs):
        return self.model.apply(self.params, obs)


CQLConfig._algo_cls = CQL


__all__ = ["BCConfig", "MARWIL", "MARWILConfig", "OfflineDataset",
           "collect_episodes", "write_episodes",
           "CQL", "CQLConfig", "TransitionDataset"]
