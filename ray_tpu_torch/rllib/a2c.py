"""A2C: synchronous advantage actor-critic.

Counterpart of ``ray_tpu/rllib/a2c.py`` (reference:
``rllib/algorithms/a2c/a2c.py``).  A2C is the PPO driver degenerated to
one on-policy pass: with ``num_epochs=1`` and one minibatch the importance
ratio is identically 1 at the update point, so PPO's clipped surrogate's
gradient reduces exactly to the vanilla policy gradient
``adv * grad(logp)``; one update serves both algorithms (learner.py), and
the config is the axis between them.
"""

from __future__ import annotations

from .ppo import PPO, PPOConfig

__all__ = ["A2C", "A2CConfig"]


class A2C(PPO):
    """Driver: synchronous rollouts -> one policy-gradient pass."""


class A2CConfig(PPOConfig):
    """PPOConfig pinned to the single-pass on-policy regime (reference
    defaults: entropy bonus on, one SGD pass per batch)."""

    _algo_cls = A2C

    def __init__(self):
        super().__init__()
        self.train.update(
            num_epochs=1,        # one on-policy pass: ratio == 1
            num_minibatches=1,   # whole-batch gradient
            clip_param=1e9,      # clipping never binds at ratio 1
            entropy_coeff=0.01,  # A2C's exploration bonus (reference default)
        )
