"""EnvRunner: the rollout worker.

Counterpart of ``ray_tpu/rllib/env_runner.py`` (reference:
``rllib/env/env_runner.py:9`` and ``rllib/evaluation/rollout_worker.py:159``):
it owns gymnasium envs, takes policy weights, and returns fixed-length
sample batches.  The drivers run it as an actor of the port's runtime, as
the reference does, with ``device="cpu"``: the reference's runners run
their policy on the worker's CPU devices.  Stepping is Python on the
host; the policy runs on the runner's ``device``.  Each
``sample`` reseeds its draws from ``(seed << 20) ^ calls``, as the
reference reseeds its key, here a ``torch.Generator`` on the host.
gymnasium is imported by the constructor, so the module imports without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from .learner import to_device


class EnvRunner:
    """Collects rollout fragments from N vectorized gymnasium envs."""

    def __init__(self, env_name: str, model_spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0,
                 env_config: Optional[dict] = None, device=None):
        import gymnasium as gym

        from .models import build_model

        self.device = device_mod.resolve(device)
        self.envs = [gym.make(env_name, **(env_config or {}))
                     for _ in range(num_envs)]
        self.model = build_model(model_spec)
        self.num_envs = num_envs
        self._seed = seed
        self._rng_calls = 0
        self.obs = np.stack([e.reset(seed=seed + i)[0]
                             for i, e in enumerate(self.envs)])
        self._ep_returns = np.zeros(num_envs)
        self._done_returns: List[float] = []

    @torch.no_grad()
    def sample(self, params_blob: Dict[str, Any],
               rollout_len: int = 128) -> Dict[str, np.ndarray]:
        """Run `rollout_len` steps per env under the given weights; returns
        the batch plus bootstrap values (the learner computes GAE)."""
        params = to_device(params_blob, self.device)
        self._rng_calls += 1
        gen = torch.Generator().manual_seed(
            (self._seed << 20) ^ self._rng_calls)

        T, N = rollout_len, self.num_envs
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_shape = ((N,) if not self.model.continuous
                     else (N, self.model.action_dim))
        acts_buf = np.zeros((T,) + act_shape, np.float32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)

        for t in range(T):
            pi_out, value = self.model.apply(params, self._obs_tensor())
            action = self.model.sample_action(pi_out, gen)
            logp = self.model.log_prob(pi_out, action)
            action_np = action.cpu().numpy()
            obs_buf[t] = self.obs
            acts_buf[t] = action_np
            logp_buf[t] = logp.cpu().numpy()
            val_buf[t] = value.cpu().numpy()
            for i, env in enumerate(self.envs):
                a = action_np[i]
                if not self.model.continuous:
                    a = int(a)
                nobs, rew, term, trunc, _ = env.step(a)
                rew_buf[t, i] = rew
                self._ep_returns[i] += rew
                if term or trunc:
                    done_buf[t, i] = 1.0
                    self._done_returns.append(self._ep_returns[i])
                    self._ep_returns[i] = 0.0
                    nobs, _ = env.reset()
                self.obs[i] = nobs
        _, last_val = self.model.apply(params, self._obs_tensor())
        return {
            "obs": obs_buf, "actions": acts_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "last_values": last_val.cpu().numpy().astype(np.float32),
        }

    def _obs_tensor(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.obs, np.float32)).to(
            self.device)

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._done_returns)
        if clear:
            self._done_returns.clear()
        return out

    def ping(self) -> bool:
        return True
