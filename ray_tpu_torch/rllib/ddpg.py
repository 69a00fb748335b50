"""DDPG: deterministic policy gradient for continuous control.

Counterpart of ``ray_tpu/rllib/ddpg.py`` (reference:
``rllib/algorithms/ddpg/``).  TD3 is DDPG plus three fixes (twin critics,
target smoothing, delayed actor), so DDPG is the TD3 driver with those
fixes switched off: one update either way (td3.py).

Usage::

    algo = (DDPGConfig()
            .environment("Pendulum-v1")
            .training(train_iters=16)
            .build(device="cpu"))
    algo.train()
"""

from __future__ import annotations

from .td3 import TD3, TD3Config

__all__ = ["DDPG", "DDPGConfig"]


class DDPG(TD3):
    """Driver: noisy rollouts -> replay -> single-critic updates."""


class DDPGConfig(TD3Config):
    """TD3Config with the TD3-specific fixes disabled by default (callers
    can re-enable any of them individually: the DDPG->TD3 ablation axis)."""

    _algo_cls = DDPG

    def __init__(self):
        super().__init__()
        self.train.update(
            twin_q=False,       # single critic, no clipped double-Q
            policy_noise=0.0,   # no target policy smoothing
            policy_delay=1,     # actor + targets update every step
        )
