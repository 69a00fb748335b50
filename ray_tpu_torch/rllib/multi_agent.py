"""Multi-agent environments + multi-policy training.

Counterpart of ``ray_tpu/rllib/multi_agent.py`` (reference:
``rllib/env/multi_agent_env.py``, the dict-keyed step/reset API with the
``"__all__"`` termination sentinel, and the policy mapping of
``rllib/policy/policy_map.py``).  ``MultiAgentEnv`` and
``RockPaperScissors`` are the reference's numpy, kept as copies of their
own.  ``MultiAgentEnvRunner`` batches each agent's transitions under its
mapped policy, each policy's model on the runner's device; its draws come
from one host ``torch.Generator`` per ``sample``, seeded from
``(seed << 20) ^ calls`` as the reference seeds its key, through the
models' draw functions (``models._gumbel``), so a test can feed JAX's.
``MultiAgentPPO`` owns one PPO ``Learner`` per policy; its runners are
actors of the port's runtime (one CPU each, their policies on the CPU),
as the reference's are.  None of it needs gymnasium.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from .learner import to_device


class MultiAgentEnv:
    """Dict-keyed multi-agent environment contract.

    ``reset()`` -> (obs_dict, info_dict); ``step(action_dict)`` ->
    (obs_dict, reward_dict, terminated_dict, truncated_dict, info_dict).
    ``terminated["__all__"]`` ends the episode for everyone.  Only agents
    present in the returned obs dict act next step."""

    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        raise NotImplementedError

    @property
    def num_actions(self) -> int:
        raise NotImplementedError


class RockPaperScissors(MultiAgentEnv):
    """Two-agent repeated RPS (the reference's canonical multi-agent
    example): the observation is the one-hot of the opponent's previous
    move, reward +1/-1/0."""

    possible_agents = ["player_0", "player_1"]

    def __init__(self, episode_len: int = 10):
        self.episode_len = episode_len
        self._t = 0

    @property
    def observation_size(self) -> int:
        return 4  # one-hot prev opponent move + "start" slot

    @property
    def num_actions(self) -> int:
        return 3

    def reset(self, *, seed: Optional[int] = None):
        self._t = 0
        start = np.array([0, 0, 0, 1], np.float32)
        return ({a: start.copy() for a in self.possible_agents}, {})

    def step(self, action_dict):
        a0 = int(action_dict["player_0"])
        a1 = int(action_dict["player_1"])
        self._t += 1
        # 0=rock, 1=paper, 2=scissors; (a - b) % 3 == 1 -> a wins
        if a0 == a1:
            r0 = r1 = 0.0
        elif (a0 - a1) % 3 == 1:
            r0, r1 = 1.0, -1.0
        else:
            r0, r1 = -1.0, 1.0
        obs = {
            "player_0": np.eye(4, dtype=np.float32)[a1],
            "player_1": np.eye(4, dtype=np.float32)[a0],
        }
        done = self._t >= self.episode_len
        term = {"player_0": done, "player_1": done, "__all__": done}
        trunc = {"player_0": False, "player_1": False, "__all__": False}
        return obs, {"player_0": r0, "player_1": r1}, term, trunc, {}


class MultiAgentEnvRunner:
    """Rollout collector: steps ONE multi-agent env, batching each agent's
    transitions under its mapped policy (reference:
    ``rllib/env/multi_agent_env_runner.py``).  The policies run on
    ``device`` (``None``: the card)."""

    def __init__(self, env_ctor, model_specs: Dict[str, Dict[str, Any]],
                 policy_mapping: Dict[str, str], seed: int = 0,
                 device=None):
        from .models import build_model

        self.device = device_mod.resolve(device)
        self.env: MultiAgentEnv = env_ctor()
        self.mapping = dict(policy_mapping)
        self.models = {pid: build_model(spec)
                       for pid, spec in model_specs.items()}
        self._seed = seed
        self._calls = 0
        self.obs, _ = self.env.reset(seed=seed)
        self._ep_return: Dict[str, float] = {}
        self._done_returns: Dict[str, List[float]] = {
            pid: [] for pid in self.models}

    def _obs(self, ob) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ob, np.float32))[None].to(
            self.device)

    @torch.no_grad()
    def sample(self, weights: Dict[str, Dict[str, Any]],
               rollout_len: int = 64) -> Dict[str, Dict[str, np.ndarray]]:
        """Collect ``rollout_len`` env steps; returns per-policy batches in
        the [T, B, ...] layout the single-agent Learner consumes (B = the
        agents mapped to that policy and alive that step)."""
        params = {pid: to_device(w, self.device)
                  for pid, w in weights.items()}
        self._calls += 1
        gen = torch.Generator().manual_seed((self._seed << 20)
                                            ^ self._calls)
        buf: Dict[str, Dict[str, list]] = {
            pid: {k: [] for k in ("obs", "actions", "logp", "values",
                                  "rewards", "dones")}
            for pid in self.models}

        for _ in range(rollout_len):
            acts: Dict[str, Any] = {}
            step_rec: Dict[str, Dict[str, list]] = {
                pid: {k: [] for k in ("obs", "actions", "logp", "values")}
                for pid in self.models}
            for aid, ob in self.obs.items():
                pid = self.mapping[aid]
                model = self.models[pid]
                pi_out, value = model.apply(params[pid], self._obs(ob))
                action = model.sample_action(pi_out, gen)
                logp = model.log_prob(pi_out, action)
                # one copy of the step's three numbers
                a, lp, v = torch.stack([action.to(logp.dtype), logp,
                                        value]).cpu()[:, 0].tolist()
                acts[aid] = int(a)
                step_rec[pid]["obs"].append(np.asarray(ob, np.float32))
                step_rec[pid]["actions"].append(a)
                step_rec[pid]["logp"].append(lp)
                step_rec[pid]["values"].append(v)
            nobs, rews, terms, truncs, _ = self.env.step(acts)
            done_all = terms.get("__all__", False) or truncs.get("__all__",
                                                                 False)
            for aid in acts:
                self._ep_return[aid] = (self._ep_return.get(aid, 0.0)
                                        + rews.get(aid, 0.0))
            for pid in self.models:
                aids = [a for a in acts if self.mapping[a] == pid]
                if not aids:
                    continue
                rec = step_rec[pid]
                buf[pid]["obs"].append(np.stack(rec["obs"]))
                for k in ("actions", "logp", "values"):
                    buf[pid][k].append(np.array(rec[k], np.float32))
                buf[pid]["rewards"].append(np.array(
                    [rews.get(a, 0.0) for a in aids], np.float32))
                buf[pid]["dones"].append(np.array(
                    [float(done_all or terms.get(a, False)) for a in aids],
                    np.float32))
            if done_all:
                for aid, ret in self._ep_return.items():
                    self._done_returns[self.mapping[aid]].append(ret)
                self._ep_return.clear()
                nobs, _ = self.env.reset()
            self.obs = nobs

        out: Dict[str, Dict[str, np.ndarray]] = {}
        for pid, b in buf.items():
            batch = {k: np.stack(v) for k, v in b.items()}   # [T, B, ...]
            # bootstrap values for GAE
            last = [float(self.models[pid].apply(params[pid],
                                                 self._obs(ob))[1][0])
                    for aid, ob in self.obs.items()
                    if self.mapping[aid] == pid]
            batch["last_values"] = np.array(last, np.float32)
            out[pid] = batch
        return out

    def episode_returns(self, clear: bool = True) -> Dict[str, List[float]]:
        out = {pid: list(v) for pid, v in self._done_returns.items()}
        if clear:
            for v in self._done_returns.values():
                v.clear()
        return out

    def ping(self) -> bool:
        return True


class MultiAgentPPO:
    """One PPO Learner per policy over shared rollout actors (reference:
    multi-policy training in ``Algorithm`` with a PolicyMap).  The learners
    run on ``device`` (``None``: the card), the runners' policies on the
    CPU."""

    def __init__(self, env_ctor: Callable[[], MultiAgentEnv],
                 policy_mapping_fn: Callable[[str], str],
                 num_runners: int = 2, rollout_len: int = 64,
                 train_config: Optional[Dict[str, Any]] = None,
                 hidden: Tuple[int, ...] = (32, 32), seed: int = 0,
                 device=None):
        import ray_tpu_torch

        from .learner import Learner
        from .models import build_model

        self.device = device_mod.resolve(device)
        probe = env_ctor()
        self.policy_ids = sorted({policy_mapping_fn(a)
                                  for a in probe.possible_agents})
        mapping = {a: policy_mapping_fn(a) for a in probe.possible_agents}
        spec = dict(obs_dim=probe.observation_size,
                    action_dim=probe.num_actions,
                    hidden=tuple(hidden), continuous=False)
        self.model_specs = {pid: dict(spec) for pid in self.policy_ids}
        cfg = dict({"lr": 5e-4, "num_epochs": 2, "num_minibatches": 2,
                    "entropy_coeff": 0.01}, **(train_config or {}))
        self.learners = {
            pid: Learner(build_model(self.model_specs[pid]), cfg,
                         seed=seed + i, device=self.device)
            for i, pid in enumerate(self.policy_ids)}
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                env_ctor, self.model_specs, mapping, seed=seed + 7 * i,
                device="cpu")
            for i in range(num_runners)]
        self.rollout_len = rollout_len
        self._iteration = 0
        self._recent: Dict[str, List[float]] = {p: [] for p in self.policy_ids}

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        t0 = time.time()
        wref = ray_tpu_torch.put(self.get_weights())
        samples = ray_tpu_torch.get(
            [r.sample.remote(wref, self.rollout_len) for r in self.runners],
            timeout=600)
        metrics: Dict[str, Any] = {}
        for pid, learner in self.learners.items():
            per = [s[pid] for s in samples if pid in s]
            if not per:
                continue
            rollout = {
                k: np.concatenate([b[k] for b in per],
                                  axis=0 if k == "last_values" else 1)
                for k in per[0]}
            m = learner.update(rollout)
            metrics.update({f"{pid}/{k}": v for k, v in m.items()})
        for rets in ray_tpu_torch.get(
                [r.episode_returns.remote() for r in self.runners],
                timeout=60):
            for pid, vals in rets.items():
                self._recent[pid].extend(vals)
                self._recent[pid] = self._recent[pid][-100:]
        self._iteration += 1
        for pid in self.policy_ids:
            if self._recent[pid]:
                metrics[f"{pid}/episode_return_mean"] = float(
                    np.mean(self._recent[pid]))
        metrics["training_iteration"] = self._iteration
        metrics["time_this_iter_s"] = time.time() - t0
        return metrics

    def get_weights(self):
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def stop(self):
        from .actors import kill_all

        kill_all(self.runners)
        self.runners = []
