"""ClassNet / BoxNet prediction heads in PyTorch (NCHW inside; `training`
as Flax's: train-mode BatchNorm).

Port of `mladversarialobjectdetection_tpu/models/heads.py:23-103,139-148`:
`repeats` separable convs whose weights are SHARED across pyramid levels,
with a BatchNorm PER LEVEL (`bn_{i}_l{level}`), and a class-head bias of
-log((1 - 0.01) / 0.01). The segmentation head is not ported yet.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from .efficientnet import BatchNorm, Conv2d, activation, set_compute_dtype


class _SharedConv(nn.Module):
    """Separable or plain 3x3 conv shared across levels (heads.py:23-45)."""

    def __init__(self, in_channels: int, features: int, separable: bool,
                 bias_value: float = 0.0):
        super().__init__()
        self.separable = separable
        if separable:
            self.dw = Conv2d(in_channels, in_channels, 3, groups=in_channels,
                             bias=False, init="fan_in_truncated")
            self.pw = Conv2d(in_channels, features, 1,
                             init="fan_in_truncated", bias_value=bias_value)
        else:
            self.conv = Conv2d(in_channels, features, 3, init="normal_0.01",
                               bias_value=bias_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.separable:
            return self.pw(self.dw(x))
        return self.conv(x)


class PredictionNet(nn.Module):
    """Shared-conv / per-level-BN head body + prediction layer (heads.py:48-90),
    in the compute dtype `dtype` (`efficientnet.set_compute_dtype`)."""

    def __init__(self, output_features: int, num_filters: int,
                 num_levels: int, repeats: int = 4, act_type: str = "swish",
                 separable_conv: bool = True, head_bias_init: float = 0.0,
                 survival_prob: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_levels = num_levels
        self.repeats = repeats
        self.act_type = act_type
        self.survival_prob = survival_prob
        for i in range(repeats):
            self.add_module(f"conv_{i}", _SharedConv(
                num_filters, num_filters, separable_conv))
        self.predict = _SharedConv(num_filters, output_features,
                                   separable_conv, bias_value=head_bias_init)
        for level_id in range(num_levels):
            for i in range(repeats):
                self.add_module(f"bn_{i}_l{level_id}", BatchNorm(num_filters))
        set_compute_dtype(self, dtype)

    def forward(self, inputs: Sequence[torch.Tensor],
                training: bool = False) -> List[torch.Tensor]:
        outputs = []
        for level_id in range(self.num_levels):
            x = inputs[level_id]
            for i in range(self.repeats):
                original = x
                x = getattr(self, f"conv_{i}")(x)
                x = getattr(self, f"bn_{i}_l{level_id}")(x, training)
                x = activation(x, self.act_type)
                if i > 0 and self.survival_prob:
                    x = x + original  # no drop-connect, as heads.py:86-88
            outputs.append(self.predict(x))
        return outputs


def class_net(num_classes: int, num_anchors: int, num_filters: int,
              num_levels: int, repeats: int, act_type: str,
              separable_conv: bool, survival_prob=None, dtype=None) -> PredictionNet:
    return PredictionNet(
        output_features=num_classes * num_anchors,
        num_filters=num_filters, num_levels=num_levels, repeats=repeats,
        act_type=act_type, separable_conv=separable_conv,
        head_bias_init=-math.log((1 - 0.01) / 0.01),
        survival_prob=survival_prob, dtype=dtype)


def box_net(num_anchors: int, num_filters: int, num_levels: int,
            repeats: int, act_type: str, separable_conv: bool,
            survival_prob=None, dtype=None) -> PredictionNet:
    return PredictionNet(
        output_features=4 * num_anchors,
        num_filters=num_filters, num_levels=num_levels, repeats=repeats,
        act_type=act_type, separable_conv=separable_conv,
        survival_prob=survival_prob, dtype=dtype)
