"""Anchor labelling: assign ground-truth boxes to anchors for supervised
detector training.

Port of `mladversarialobjectdetection_tpu/train/labeler.py:27-88`
(reference tf2/anchors.py:171-250 `AnchorLabeler` and argmax_matcher.py):
per-anchor argmax-IoU matching at threshold .5, every valid ground-truth
row force-matched to its best anchor, and Faster-RCNN box encoding (the
inverse of `ops/anchors.decode_box_outputs`). Vectorised over leading batch
dimensions on a static [G] slot layout with validity masks.

Where two ground-truth rows force-match the same anchor, the JAX scatter
(`.at[].set`) keeps the last row's write on the CPU; the port keeps the row
of the highest index the same way (a max-reduce, deterministic on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import nms as nms_ops


class AnchorLabels(NamedTuple):
    cls_targets: torch.Tensor    # [..., A] int32 class id, -1 negative, -2 ignored
    box_targets: torch.Tensor    # [..., A, 4] encoded regression targets
    num_positives: torch.Tensor  # [...] float32


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Box corners -> (ty, tx, th, tw) against anchors (faster_rcnn_box_coder)."""
    anchors = anchors.to(boxes.dtype)
    ycenter_a = (anchors[..., 0] + anchors[..., 2]) / 2
    xcenter_a = (anchors[..., 1] + anchors[..., 3]) / 2
    ha = anchors[..., 2] - anchors[..., 0]
    wa = anchors[..., 3] - anchors[..., 1]
    ycenter = (boxes[..., 0] + boxes[..., 2]) / 2
    xcenter = (boxes[..., 1] + boxes[..., 3]) / 2
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    eps = 1e-8
    ty = (ycenter - ycenter_a) / (ha + eps)
    tx = (xcenter - xcenter_a) / (wa + eps)
    th = torch.log(torch.clamp_min(h, eps) / (ha + eps))
    tw = torch.log(torch.clamp_min(w, eps) / (wa + eps))
    return torch.stack([ty, tx, th, tw], dim=-1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., G, *rest] at idx [..., A] along the G axis -> [..., A, *rest]."""
    rest = x.shape[idx.dim():]
    index = idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest)
    return torch.gather(x, idx.dim() - 1, index)


def label_anchors(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
                  match_threshold: float = 0.5,
                  unmatched_threshold: float = 0.5) -> AnchorLabels:
    """Label the anchors of a batch of images.

    Args:
      anchor_boxes: [A, 4].
      gt_boxes: [..., G, 4] padded; gt_classes: [..., G] integer;
        gt_valid: [..., G] bool.
    """
    g = gt_boxes.shape[-2]
    iou = nms_ops.iou(anchor_boxes, gt_boxes)              # [..., A, G]
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))

    best_gt = torch.argmax(iou, dim=-1)                    # [..., A], the first max
    best_iou = torch.amax(iou, dim=-1)
    best_anchor_per_gt = torch.argmax(iou, dim=-2)         # [..., G]

    # force-match: every valid gt claims its best anchor; of several rows on
    # one anchor the last one's write stands (see the module notes)
    gt_ids = torch.arange(g, device=iou.device).expand(best_anchor_per_gt.shape)
    winner = torch.full(best_iou.shape, -1, dtype=torch.long, device=iou.device)
    winner = winner.scatter_reduce(-1, best_anchor_per_gt, gt_ids, reduce="amax")
    claimed = winner >= 0
    winner_c = torch.clamp_min(winner, 0)
    winner_valid = _gather(gt_valid, winner_c)
    forced = claimed & winner_valid
    forced_gt = torch.where(forced, winner_c, torch.zeros_like(winner_c))

    matched = (best_iou >= match_threshold) | forced
    assigned_gt = torch.where(forced, forced_gt, best_gt)

    neg = torch.full_like(assigned_gt, -1)
    cls_targets = torch.where(matched, _gather(gt_classes.long(), assigned_gt),
                              neg)
    # anchors in [unmatched_threshold, match_threshold) would be ignored
    # (-2); with both thresholds at .5 (the automl default) none exist
    ignored = (~matched) & (best_iou >= unmatched_threshold)
    cls_targets = torch.where(ignored, torch.full_like(neg, -2), cls_targets)

    box_targets = encode_boxes(_gather(gt_boxes, assigned_gt), anchor_boxes)
    box_targets = torch.where(matched[..., None], box_targets,
                              torch.zeros_like(box_targets))
    num_positives = torch.sum(matched.to(torch.float32), dim=-1)
    return AnchorLabels(cls_targets.to(torch.int32), box_targets, num_positives)
