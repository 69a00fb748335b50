"""Tiny example environments (reference: rllib/examples/envs).

Counterpart of ``ray_tpu/rllib/examples_env.py``, kept as a copy of its
own.  ``Catch-v0`` is a 12x12x1 pixel env, a minimal Atari stand-in for
CI: a ball falls one row per step from a random column; the agent moves a
3-pixel paddle on the bottom row (actions: left/stay/right); +1 for
catching, -1 for missing, episode length = grid height.  ``Bandit-v0`` is
an 8-step two-armed bandit.  Importing this module registers both ids
with gymnasium (``gym.make("ray_tpu_torch.rllib.examples_env:Catch-v0")``
imports it first); the reference registers the same ids with classes
that behave the same, so whichever registered last serves either.
Without gymnasium the module imports and registers nothing.
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:  # only the runners need gymnasium
    gym = None


if gym is not None:
    class CatchEnv(gym.Env):
        SIZE = 12

        def __init__(self, render_mode=None):
            n = self.SIZE
            self.observation_space = spaces.Box(0.0, 1.0, (n, n, 1),
                                                np.float32)
            self.action_space = spaces.Discrete(3)
            self._rng = np.random.default_rng(0)

        def _obs(self):
            n = self.SIZE
            frame = np.zeros((n, n, 1), np.float32)
            frame[self.ball_y, self.ball_x, 0] = 1.0
            lo = max(0, self.paddle - 1)
            hi = min(n, self.paddle + 2)
            frame[n - 1, lo:hi, 0] = 1.0
            return frame

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self.ball_x = int(self._rng.integers(0, self.SIZE))
            self.ball_y = 0
            self.paddle = self.SIZE // 2
            return self._obs(), {}

        def step(self, action):
            self.paddle = int(np.clip(self.paddle + int(action) - 1,
                                      0, self.SIZE - 1))
            self.ball_y += 1
            done = self.ball_y >= self.SIZE - 1
            reward = 0.0
            if done:
                reward = 1.0 if abs(self.ball_x - self.paddle) <= 1 else -1.0
            return self._obs(), reward, done, False, {}

    gym.register(id="Catch-v0", entry_point=CatchEnv)

    class BiasBanditEnv(gym.Env):
        """8-step two-armed bandit with a constant observation: reward
        equals the chosen action. The smallest env whose optimum a policy
        must LEARN (bias toward arm 1) — CI smoke target for the
        derivative-free algorithms (es.py), where a few iterations must
        visibly move the policy."""

        HORIZON = 8

        def __init__(self, render_mode=None):
            self.observation_space = spaces.Box(-1.0, 1.0, (2,), np.float32)
            self.action_space = spaces.Discrete(2)
            self._t = 0

        def _obs(self):
            return np.array([1.0, -1.0], np.float32)

        def reset(self, *, seed=None, options=None):
            self._t = 0
            return self._obs(), {}

        def step(self, action):
            self._t += 1
            return (self._obs(), float(action), self._t >= self.HORIZON,
                    False, {})

    gym.register(id="Bandit-v0", entry_point=BiasBanditEnv)
