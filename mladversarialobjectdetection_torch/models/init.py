"""Seeded random initialisation of the port's detector and U-Net.

The same families as the Flax initializers of the JAX package, drawn from a
`torch.Generator` (so not bit-equal to Flax's draws):

- `fan_out_normal`: variance scaling 2.0, fan_out, normal — the backbone
  convs (efficientnet.py:168);
- `fan_in_truncated`: variance scaling 1.0, fan_in, normal truncated at two
  standard deviations (Flax's `lecun_normal`) — the BiFPN and separable
  head convs (bifpn.py:22, heads.py:19) and the U-Net's attention convs;
- `he_truncated`: variance scaling 2.0, fan_in, truncated normal — the
  U-Net's ConvBlock, transposed and output convs (unet.py:19);
- `normal_0.01`: normal with stddev 0.01 — the plain head convs
  (heads.py:20);
- biases take the conv's `bias_value` (0, or -log(99) for the class head);
  BatchNorm starts at scale 1, bias 0, mean 0, var 1; fusion weights at 1.

Each `Conv2d` names its family in `init`, where the Flax module names its
`kernel_init`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .efficientnet import BatchNorm, Conv2d

# stddev of a standard normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNCATED_STD = 0.87962566103423978
_TRUNCATED_SCALE = {"fan_in_truncated": 1.0, "he_truncated": 2.0}


def _truncated(weight: torch.Tensor, scale: float, fan_in: int,
               generator: torch.Generator) -> None:
    std = math.sqrt(scale / fan_in) / _TRUNCATED_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _fans(weight: torch.Tensor):
    out_ch, in_ch, kh, kw = weight.shape  # OIHW; Flax HWIO has the same fans
    return in_ch * kh * kw, out_ch * kh * kw


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` in place; returns `module`.

    Draw on the CPU (a CPU generator), then move the module to its device.
    """
    for sub in module.modules():
        if isinstance(sub, Conv2d):
            fan_in, fan_out = _fans(sub.weight)
            if sub.init == "fan_out_normal":
                nn.init.normal_(sub.weight, 0.0, math.sqrt(2.0 / fan_out),
                                generator=generator)
            elif sub.init in _TRUNCATED_SCALE:
                _truncated(sub.weight, _TRUNCATED_SCALE[sub.init], fan_in,
                           generator)
            elif sub.init == "normal_0.01":
                nn.init.normal_(sub.weight, 0.0, 0.01, generator=generator)
            else:
                raise ValueError(f"unknown init family {sub.init!r}")
            if sub.bias is not None:
                sub.bias.fill_(sub.bias_value)
        elif isinstance(sub, BatchNorm):
            sub.weight.fill_(1.0)
            sub.bias.fill_(0.0)
            sub.running_mean.fill_(0.0)
            sub.running_var.fill_(1.0)
        wsm = getattr(sub, "WSM", None)
        if isinstance(wsm, nn.Parameter):
            wsm.fill_(1.0)
    return module
