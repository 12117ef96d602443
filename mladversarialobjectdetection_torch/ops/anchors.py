"""Multiscale anchor generation and box decoding.

Port of `mladversarialobjectdetection_tpu/ops/anchors.py`. `_anchor_boxes_np`
is a numpy copy of the JAX package's (tests hold the two bit-equal);
`decode_box_outputs` is the same arithmetic in torch.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.image import get_feat_sizes, parse_image_size


@functools.lru_cache(maxsize=32)
def _anchor_boxes_np(min_level: int, max_level: int, num_scales: int,
                     aspect_ratios: Tuple[float, ...],
                     anchor_scales: Tuple[float, ...],
                     image_size: Tuple[int, int]) -> np.ndarray:
    """All anchor boxes [A, 4] as (ymin, xmin, ymax, xmax) in pixels."""
    feat_sizes = get_feat_sizes(image_size, max_level)
    boxes_all: List[np.ndarray] = []
    for level in range(min_level, max_level + 1):
        boxes_level = []
        stride_y = feat_sizes[0]["height"] / float(feat_sizes[level]["height"])
        stride_x = feat_sizes[0]["width"] / float(feat_sizes[level]["width"])
        anchor_scale = anchor_scales[level - min_level]
        for scale_octave in range(num_scales):
            for aspect in aspect_ratios:
                octave = scale_octave / float(num_scales)
                base_x = anchor_scale * stride_x * 2.0 ** octave
                base_y = anchor_scale * stride_y * 2.0 ** octave
                aspect_x = np.sqrt(aspect)
                aspect_y = 1.0 / aspect_x
                half_x = base_x * aspect_x / 2.0
                half_y = base_y * aspect_y / 2.0

                x = np.arange(stride_x / 2, image_size[1], stride_x)
                y = np.arange(stride_y / 2, image_size[0], stride_y)
                xv, yv = np.meshgrid(x, y)
                xv, yv = xv.reshape(-1), yv.reshape(-1)
                boxes = np.vstack((yv - half_y, xv - half_x,
                                   yv + half_y, xv + half_x)).T
                boxes_level.append(boxes[:, None, :])
        # [HW, num_scales*len(aspects), 4] -> [-1, 4], anchor-minor layout
        boxes_all.append(np.concatenate(boxes_level, axis=1).reshape(-1, 4))
    return np.vstack(boxes_all).astype(np.float32)


class Anchors:
    """Static multiscale anchors for an EfficientDet config."""

    def __init__(self, min_level: int, max_level: int, num_scales: int,
                 aspect_ratios: Sequence[float], anchor_scale, image_size):
        self.min_level = min_level
        self.max_level = max_level
        self.num_scales = num_scales
        self.aspect_ratios = tuple(aspect_ratios)
        n_levels = max_level - min_level + 1
        if isinstance(anchor_scale, (list, tuple)):
            if len(anchor_scale) != n_levels:
                raise ValueError(f"{len(anchor_scale)} anchor scales for "
                                 f"{n_levels} levels")
            self.anchor_scales = tuple(anchor_scale)
        else:
            self.anchor_scales = (float(anchor_scale),) * n_levels
        self.image_size = parse_image_size(image_size)
        self.feat_sizes = get_feat_sizes(self.image_size, max_level)
        self.boxes = _anchor_boxes_np(min_level, max_level, num_scales,
                                      self.aspect_ratios, self.anchor_scales,
                                      self.image_size)

    @classmethod
    def from_config(cls, config) -> "Anchors":
        return cls(config.min_level, config.max_level, config.num_scales,
                   config.aspect_ratios, config.anchor_scale, config.image_size)


def decode_box_outputs(pred_boxes: torch.Tensor,
                       anchor_boxes: torch.Tensor) -> torch.Tensor:
    """Decode (ty, tx, th, tw) regression targets against anchors.

    Parity with reference tf2/anchors.py:30-58. Shapes broadcast:
    pred_boxes [..., 4], anchor_boxes [..., 4] -> [..., 4] (ymin,xmin,ymax,xmax).
    """
    anchor_boxes = anchor_boxes.to(pred_boxes.dtype)
    ycenter_a = (anchor_boxes[..., 0] + anchor_boxes[..., 2]) / 2
    xcenter_a = (anchor_boxes[..., 1] + anchor_boxes[..., 3]) / 2
    ha = anchor_boxes[..., 2] - anchor_boxes[..., 0]
    wa = anchor_boxes[..., 3] - anchor_boxes[..., 1]
    ty, tx, th, tw = (pred_boxes[..., 0], pred_boxes[..., 1],
                      pred_boxes[..., 2], pred_boxes[..., 3])
    w = torch.exp(tw) * wa
    h = torch.exp(th) * ha
    ycenter = ty * ha + ycenter_a
    xcenter = tx * wa + xcenter_a
    return torch.stack([ycenter - h / 2.0, xcenter - w / 2.0,
                        ycenter + h / 2.0, xcenter + w / 2.0], dim=-1)
