"""RL policy/value networks as functional modules over flat param dicts.

Counterpart of ``ray_tpu/rllib/models.py`` (reference analogue:
``rllib/core/rl_module/rl_module.py``): ``(params, obs) -> outputs``, so
one ``apply`` serves a runner's policy and the learner's update.  Params
are the JAX package's tree, a flat dict with the same keys and layouts
(``[in, out]`` weights), so ``models.convert.params_from_numpy`` carries
its ``init`` over unchanged and ``get_weights()`` dicts apply in either
package.

Random draws take a ``torch.Generator`` where the reference takes a key,
and go through ``_standard_normal`` and ``_gumbel``: a test can replace
them with the numbers JAX drew.  They draw on the generator's device (the
port seeds CPU generators, so a run on the card draws what a CPU run
draws) and the caller's tensor decides where the result goes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]

_LOG_2PI = math.log(2 * math.pi)
_LOG_2PI_E = math.log(2 * math.pi * math.e)


def _standard_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """``jax.random.normal``'s role: standard normal f32 draws."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """``jax.random.gumbel``'s role: -log(-log(u)), u uniform in
    [tiny, 1), as JAX clips it."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def normal_init(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """A weight drawn as the reference draws it: N(0, 1) * scale."""
    return _standard_normal(gen, shape) * scale


def mlp_init(gen: torch.Generator, sizes, last_scale=None) -> Params:
    """``w{i}`` [in, out] and ``b{i}`` of an MLP over ``sizes``, drawn as the
    reference draws them: scale (2 / fan_in) ** 0.5, ``last_scale`` (when
    given) on the output layer."""
    params = {}
    for i in range(len(sizes) - 1):
        scale = (2.0 / sizes[i]) ** 0.5
        if last_scale is not None and i == len(sizes) - 2:
            scale = last_scale
        params[f"w{i}"] = normal_init(gen, (sizes[i], sizes[i + 1]), scale)
        params[f"b{i}"] = torch.zeros(sizes[i + 1], device=gen.device)
    return params


def relu_mlp(params: Params, x, n_hidden: int):
    """``n_hidden`` relu layers, then the linear output layer."""
    for i in range(n_hidden):
        x = torch.relu(x @ params[f"w{i}"] + params[f"b{i}"])
    return x @ params[f"w{n_hidden}"] + params[f"b{n_hidden}"]


def polyak_(target: Params, params: Params, tau: float) -> None:
    """target <- (1 - tau) * target + tau * params, in place."""
    with torch.no_grad():
        for k in target:
            target[k].mul_(1 - tau).add_(params[k], alpha=tau)


def build_model(spec: Dict):
    """Model factory (reference: rllib's catalog): a spec with
    ``obs_shape`` builds the conv net (pixel obs); ``obs_dim`` builds the
    MLP."""
    if "obs_shape" in spec:
        from .conv import ActorCriticConv
        return ActorCriticConv(**spec)
    return ActorCriticMLP(**spec)


class ActorCriticMLP:
    """Shared-nothing actor-critic MLP: policy logits (discrete) or
    mean/log_std (continuous) + value head."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(64, 64),
                 continuous: bool = False):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)
        self.continuous = continuous

    def init(self, gen: torch.Generator) -> Params:
        """Params on ``gen``'s device, drawn in the reference's order."""
        sizes = (self.obs_dim,) + self.hidden
        params: Params = {}
        dev = gen.device
        for tower in ("pi", "vf"):
            for i in range(len(self.hidden)):
                params[f"{tower}_w{i}"] = normal_init(
                    gen, (sizes[i], sizes[i + 1]), (2.0 / sizes[i]) ** 0.5)
                params[f"{tower}_b{i}"] = torch.zeros(sizes[i + 1],
                                                      device=dev)
        out_dim = self.action_dim * (2 if self.continuous else 1)
        params["pi_out_w"] = normal_init(gen, (self.hidden[-1], out_dim),
                                         0.01)
        params["pi_out_b"] = torch.zeros(out_dim, device=dev)
        params["vf_out_w"] = normal_init(gen, (self.hidden[-1], 1),
                                         1.0 / self.hidden[-1] ** 0.5)
        params["vf_out_b"] = torch.zeros(1, device=dev)
        return params

    def _tower(self, params: Params, obs, tower: str):
        x = obs
        for i in range(len(self.hidden)):
            x = torch.tanh(x @ params[f"{tower}_w{i}"]
                           + params[f"{tower}_b{i}"])
        return x

    def apply(self, params: Params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [B, obs_dim] -> (pi_out [B, A or 2A], value [B])."""
        pi = (self._tower(params, obs, "pi") @ params["pi_out_w"]
              + params["pi_out_b"])
        v = (self._tower(params, obs, "vf") @ params["vf_out_w"]
             + params["vf_out_b"])[..., 0]
        return pi, v

    # ------------------------------------------------------ distributions

    def dist(self, pi_out):
        if self.continuous:
            mean, log_std = torch.chunk(pi_out, 2, dim=-1)
            return ("gaussian", mean, torch.clamp(log_std, -5.0, 2.0))
        return ("categorical", pi_out, None)

    def sample_action(self, pi_out, gen: torch.Generator):
        kind, a, b = self.dist(pi_out)
        if kind == "gaussian":
            eps = _standard_normal(gen, a.shape).to(a.device)
            return a + torch.exp(b) * eps
        g = _gumbel(gen, a.shape).to(a.device)
        return torch.argmax(a + g, dim=-1)

    def log_prob(self, pi_out, action):
        kind, a, b = self.dist(pi_out)
        if kind == "gaussian":
            var = torch.exp(2 * b)
            lp = -0.5 * (((action - a) ** 2) / var + 2 * b + _LOG_2PI)
            return lp.sum(-1)
        logp = torch.log_softmax(a, dim=-1)
        # rollouts store discrete actions as f32: gather by their integer
        return torch.gather(logp, -1, action[..., None].long())[..., 0]

    def entropy(self, pi_out):
        kind, a, b = self.dist(pi_out)
        if kind == "gaussian":
            return (b + 0.5 * _LOG_2PI_E).sum(-1)
        logp = torch.log_softmax(a, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)
