"""Convolutional actor-critic for pixel observations (Atari-class).

Counterpart of ``ray_tpu/rllib/conv.py`` (reference:
``rllib/models/torch/visionnet.py``, the Nature CNN filter stack).  The
params keep the JAX package's layouts: ``conv_w{i}`` is HWIO and
``torso_w``'s rows are in NHWC flatten order (h, w, c).  ``F.conv2d``
takes NCHW input and OIHW weights, so ``_torso`` permutes the weights on
the fly and brings the activations back to NHWC before the flatten;
otherwise ``torso_w`` would multiply the wrong features.  The
convolutions are PyTorch's (the reference's are XLA's
``conv_general_dilated``; no kernel of its own is ported here).  On the
card cuDNN may compute float32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; this module sets no global
flag.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .models import ActorCriticMLP, Params, normal_init

# The Nature-CNN stack (Mnih et al. 2015): (out_channels, kernel, stride)
NATURE_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


class ActorCriticConv(ActorCriticMLP):
    """Shared conv torso + separate pi/value dense heads.

    ``obs_shape`` is HWC (e.g. (84, 84, 4) stacked Atari frames); uint8
    inputs are scaled to [0, 1] inside apply, so runners ship raw frames."""

    def __init__(self, obs_shape: Sequence[int], action_dim: int,
                 filters=NATURE_FILTERS, hidden: int = 512,
                 continuous: bool = False):
        self.obs_shape = tuple(obs_shape)
        self.filters = tuple(filters)
        self.hidden_size = hidden
        super().__init__(obs_dim=int(math.prod(self.obs_shape)),
                         action_dim=action_dim, hidden=(hidden,),
                         continuous=continuous)

    # ----------------------------------------------------------- params

    def _conv_out_hw(self) -> Tuple[int, int]:
        h, w = self.obs_shape[0], self.obs_shape[1]
        for _c, k, s in self.filters:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
        return h, w

    def init(self, gen: torch.Generator) -> Params:
        params: Params = {}
        dev = gen.device
        in_c = self.obs_shape[-1]
        for i, (out_c, k, _s) in enumerate(self.filters):
            params[f"conv_w{i}"] = normal_init(
                gen, (k, k, in_c, out_c), (2.0 / (k * k * in_c)) ** 0.5)
            params[f"conv_b{i}"] = torch.zeros(out_c, device=dev)
            in_c = out_c
        h, w = self._conv_out_hw()
        flat = h * w * in_c
        params["torso_w"] = normal_init(gen, (flat, self.hidden_size),
                                        (2.0 / flat) ** 0.5)
        params["torso_b"] = torch.zeros(self.hidden_size, device=dev)
        out_dim = self.action_dim * (2 if self.continuous else 1)
        params["pi_out_w"] = normal_init(gen, (self.hidden_size, out_dim),
                                         0.01)
        params["pi_out_b"] = torch.zeros(out_dim, device=dev)
        params["vf_out_w"] = normal_init(gen, (self.hidden_size, 1),
                                         1.0 / self.hidden_size ** 0.5)
        params["vf_out_b"] = torch.zeros(1, device=dev)
        return params

    # ------------------------------------------------------------ apply

    def _torso(self, params: Params, obs) -> torch.Tensor:
        x = obs.to(torch.float32)
        if obs.dtype == torch.uint8:
            x = x / 255.0
        if x.dim() == len(self.obs_shape):  # unbatched
            x = x[None]
        x = x.permute(0, 3, 1, 2)                          # NHWC -> NCHW
        for i, (_c, _k, s) in enumerate(self.filters):
            w = params[f"conv_w{i}"].permute(3, 2, 0, 1)   # HWIO -> OIHW
            x = torch.relu(F.conv2d(x, w, params[f"conv_b{i}"], stride=s))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return torch.relu(x @ params["torso_w"] + params["torso_b"])

    def apply(self, params: Params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [B, H, W, C] (uint8 or float) -> (pi_out, value [B])."""
        z = self._torso(params, obs)
        pi = z @ params["pi_out_w"] + params["pi_out_b"]
        v = (z @ params["vf_out_w"] + params["vf_out_b"])[..., 0]
        return pi, v
