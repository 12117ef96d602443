"""ClassNet / BoxNet prediction heads and the segmentation head in PyTorch
(NCHW inside; `training` as Flax's: train-mode BatchNorm).

Port of `mladversarialobjectdetection_tpu/models/heads.py`: `repeats`
separable convs whose weights are SHARED across pyramid levels, with a
BatchNorm PER LEVEL (`bn_{i}_l{level}`), and a class-head bias of
-log((1 - 0.01) / 0.01); `grad_checkpoint` recomputes each shared conv
`conv_{i}` in the backward pass (JAX heads.py:63-69, `nn.remat(_SharedConv)`;
the convs hold no BatchNorm and draw nothing). `SegmentationHead`
(heads.py:106-136) upsamples the pyramid from its coarsest level with
Flax's stride-2 `ConvTranspose` (`models/unet.ConvTranspose`, not
`F.conv_transpose2d`'s padding), crops each upsample to its skip before
BatchNorm, and predicts per-pixel classes at half the min_level stride.
It has no `dtype` in JAX, so it computes in float32 whatever the net's
compute dtype (a bf16 pyramid is promoted, as `jnp.concatenate` does).
Under a spatial mesh every module takes its level's global height
(`parallel/spatial.py`): the transposed convs read one row above their
shard, the crop to a skip's rows is taken on global heights, and the
statistics of a row-sharded level reduce over data x spatial.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..parallel import spatial
from .efficientnet import (BatchNorm, Conv2d, activation, checkpointed,
                           set_compute_dtype)
from .unet import ConvTranspose

LECUN_INIT = "fan_in_truncated"  # Flax ConvTranspose's default lecun_normal


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

    def forward(self, x: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
        """`height`: x's global height under a spatial mesh (`Conv2d`)."""
        if self.separable:
            return self.pw(self.dw(x, height))
        return self.conv(x, height)


class PredictionNet(nn.Module):
    """Shared-conv / per-level-BN head body + prediction layer (heads.py:48-90),
    in the compute dtype `dtype` (`efficientnet.set_compute_dtype`).
    `heights` (forward): each level's global height under a spatial mesh."""

    def __init__(self, output_features: int, num_filters: int,
                 num_levels: int, repeats: int = 4, act_type: str = "swish",
                 separable_conv: bool = True, head_bias_init: float = 0.0,
                 survival_prob: Optional[float] = None,
                 grad_checkpoint: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.grad_checkpoint = grad_checkpoint
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

    def forward(self, inputs: Sequence[torch.Tensor], training: bool = False,
                heights: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        outputs = []
        for level_id in range(self.num_levels):
            x = inputs[level_id]
            h = None if heights is None else heights[level_id]
            for i in range(self.repeats):
                original = x
                conv = functools.partial(getattr(self, f"conv_{i}"), height=h)
                if self.grad_checkpoint and torch.is_grad_enabled():
                    x = checkpointed(conv, x)
                else:
                    x = conv(x)
                x = getattr(self, f"bn_{i}_l{level_id}")(x, training, h)
                x = activation(x, self.act_type)
                if i > 0 and self.survival_prob:
                    x = x + original  # no drop-connect, as heads.py:86-88
            outputs.append(self.predict(x, h))
        return outputs


def class_net(num_classes: int, num_anchors: int, num_filters: int,
              num_levels: int, repeats: int, act_type: str,
              separable_conv: bool, survival_prob=None, grad_checkpoint=False,
              dtype=None) -> PredictionNet:
    return PredictionNet(
        output_features=num_classes * num_anchors,
        num_filters=num_filters, num_levels=num_levels, repeats=repeats,
        act_type=act_type, separable_conv=separable_conv,
        head_bias_init=-math.log((1 - 0.01) / 0.01),
        survival_prob=survival_prob, grad_checkpoint=grad_checkpoint,
        dtype=dtype)


def box_net(num_anchors: int, num_filters: int, num_levels: int,
            repeats: int, act_type: str, separable_conv: bool,
            survival_prob=None, grad_checkpoint=False,
            dtype=None) -> PredictionNet:
    return PredictionNet(
        output_features=4 * num_anchors,
        num_filters=num_filters, num_levels=num_levels, repeats=repeats,
        act_type=act_type, separable_conv=separable_conv,
        survival_prob=survival_prob, grad_checkpoint=grad_checkpoint,
        dtype=dtype)


class SegmentationHead(nn.Module):
    """Semantic-segmentation head over the FPN pyramid (JAX heads.py:106-136,
    reference tf2/efficientdet_keras.py:635-697): from the coarsest level,
    repeatedly upsample by a stride-2 transposed conv (`up_{i}`, no bias:
    BatchNorm `bn_{i}` follows), crop to the next finer level's shape, and
    concat it; a last stride-2 transposed conv (`predict`, with a bias)
    gives per-pixel class logits at half the min_level stride, in its
    parameters' dtype (float32: a bf16 pyramid is promoted, as Flax's
    `ConvTranspose` and `jnp.concatenate` promote it)."""

    def __init__(self, num_classes: int, num_filters: int,
                 in_channels: Sequence[int], act_type: str = "swish"):
        super().__init__()
        self.act_type = act_type
        chans = in_channels[-1]
        for i, skip_ch in enumerate(reversed(in_channels[:-1])):
            self.add_module(f"up_{i}", ConvTranspose(
                chans, num_filters, bias=False, init=LECUN_INIT))
            self.add_module(f"bn_{i}", BatchNorm(num_filters))
            chans = num_filters + skip_ch
        self.predict = ConvTranspose(chans, num_classes, init=LECUN_INIT)

    def forward(self, feats: Sequence[torch.Tensor], training: bool = False,
                heights: Optional[Sequence[int]] = None) -> torch.Tensor:
        """NCHW features of levels min..max -> NCHW logits. `heights`: each
        level's global height under a spatial mesh; the logits are then in
        the layout of their global height, twice the first level's."""
        dtype = self.predict.weight.dtype
        x = feats[-1].to(dtype)
        heights = [None] * len(feats) if heights is None else list(heights)
        h = heights[-1]
        for i, (skip, hs) in enumerate(zip(reversed(feats[:-1]), reversed(heights[:-1]))):
            x = getattr(self, f"up_{i}")(x, h)
            # the (s-1)//2+1 pyramid is not an exact power-of-two chain at
            # small sizes: crop the upsample to the skip's shape (its global
            # rows under a spatial mesh)
            x = x[..., :skip.shape[3]]
            if hs is None:
                x = x[:, :, :skip.shape[2]]
            elif 2 * h != hs:
                x = _crop_rows(x, 2 * h, hs)
            x = getattr(self, f"bn_{i}")(x, training, hs)
            x = activation(x, self.act_type)
            x = torch.cat([x, skip.to(dtype)], dim=1)
            h = hs
        return self.predict(x, h)


def _crop_rows(x: torch.Tensor, height: int, rows: int) -> torch.Tensor:
    """The first `rows` global rows of x (global height `height`, in its
    layout), in their own layout: under a spatial mesh the two heights
    differ by a row, so at most one of them is row-sharded."""
    x = spatial.whole(x, height)[:, :, :rows]
    return spatial.local_rows(x) if spatial.sharded(rows) else x
