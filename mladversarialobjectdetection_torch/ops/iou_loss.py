"""IoU-family losses: iou / giou / diou / ciou + the inverse-DIoU
"push boxes away" loss, in PyTorch.

Port of `mladversarialobjectdetection_tpu/ops/iou_loss.py` (reference
iou_utils.py:27-191, `iou_loss` of automl's BoxIouLoss, and
regression_loss.py:16-142, `InverseDIOULoss`), the same formulas in the
same order of operations. Boxes are (ymin, xmin, ymax, xmax).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _areas(b):
    return (torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
            * torch.clamp_min(b[..., 3] - b[..., 1], 0.0))


def _pairwise_parts(pred, target):
    inter_ymin = torch.maximum(pred[..., 0], target[..., 0])
    inter_xmin = torch.maximum(pred[..., 1], target[..., 1])
    inter_ymax = torch.minimum(pred[..., 2], target[..., 2])
    inter_xmax = torch.minimum(pred[..., 3], target[..., 3])
    inter = (torch.clamp_min(inter_ymax - inter_ymin, 0.0)
             * torch.clamp_min(inter_xmax - inter_xmin, 0.0))
    union = _areas(pred) + _areas(target) - inter
    iou = inter / (union + _EPS)

    hull_ymin = torch.minimum(pred[..., 0], target[..., 0])
    hull_xmin = torch.minimum(pred[..., 1], target[..., 1])
    hull_ymax = torch.maximum(pred[..., 2], target[..., 2])
    hull_xmax = torch.maximum(pred[..., 3], target[..., 3])
    return iou, union, (hull_ymin, hull_xmin, hull_ymax, hull_xmax)


def iou(pred, target):
    return _pairwise_parts(pred, target)[0]


def giou(pred, target):
    v, union, hull = _pairwise_parts(pred, target)
    hull_area = (hull[2] - hull[0]) * (hull[3] - hull[1])
    return v - (hull_area - union) / (hull_area + _EPS)


def _diou_terms(pred, target):
    v, _, hull = _pairwise_parts(pred, target)
    pc_y = (pred[..., 0] + pred[..., 2]) / 2
    pc_x = (pred[..., 1] + pred[..., 3]) / 2
    tc_y = (target[..., 0] + target[..., 2]) / 2
    tc_x = (target[..., 1] + target[..., 3]) / 2
    center_dist = (pc_y - tc_y) ** 2 + (pc_x - tc_x) ** 2
    diag = (hull[2] - hull[0]) ** 2 + (hull[3] - hull[1]) ** 2
    return v, center_dist / (diag + _EPS)


def diou(pred, target):
    v, penalty = _diou_terms(pred, target)
    return v - penalty


def ciou(pred, target):
    v, penalty = _diou_terms(pred, target)
    ph = torch.clamp_min(pred[..., 2] - pred[..., 0], _EPS)
    pw = torch.clamp_min(pred[..., 3] - pred[..., 1], _EPS)
    th = torch.clamp_min(target[..., 2] - target[..., 0], _EPS)
    tw = torch.clamp_min(target[..., 3] - target[..., 1], _EPS)
    ar = (4.0 / math.pi ** 2) * (torch.atan(tw / th) - torch.atan(pw / ph)) ** 2
    alpha = ar / (1.0 - v + ar + _EPS)
    return v - penalty - alpha * ar


def iou_loss(pred, target, loss_type: str = "iou"):
    """1 - iou_variant, zero where the target box is all-zero padding."""
    fn = {"iou": iou, "giou": giou, "diou": diou, "ciou": ciou}[loss_type]
    val = fn(pred, target)
    is_pad = torch.all(target == 0.0, dim=-1)
    return torch.where(is_pad, torch.zeros_like(val), 1.0 - val)


def _ref_quirk_diou(gt, pred):
    """Pairwise DIoU with the reference's quirks (regression_loss.py:101-142,
    returned as diou = 1 - loss): the "centre" is the bottom-right corner
    (ymin + height, xmin + width); gt height, width and area are not clamped
    while pred's are; exact-zero denominators give 0 (divide_no_nan)."""
    gt_h = gt[..., 2] - gt[..., 0]
    gt_w = gt[..., 3] - gt[..., 1]
    gt_area = gt_h * gt_w
    pr_h = torch.clamp_min(pred[..., 2] - pred[..., 0], 0.0)
    pr_w = torch.clamp_min(pred[..., 3] - pred[..., 1], 0.0)
    pr_area = pr_h * pr_w

    inter_h = torch.clamp_min(torch.minimum(gt[..., 2], pred[..., 2])
                              - torch.maximum(gt[..., 0], pred[..., 0]), 0.0)
    inter_w = torch.clamp_min(torch.minimum(gt[..., 3], pred[..., 3])
                              - torch.maximum(gt[..., 1], pred[..., 1]), 0.0)
    inter = inter_h * inter_w
    union = gt_area + pr_area - inter
    zero = torch.zeros_like(union)
    v = torch.where(union == 0.0, zero,
                    inter / torch.where(union == 0.0, torch.ones_like(union),
                                        union))

    corner_dist = ((gt[..., 0] + gt_h - pred[..., 0] - pr_h) ** 2
                   + (gt[..., 1] + gt_w - pred[..., 1] - pr_w) ** 2)
    enc_h = torch.clamp_min(torch.maximum(gt[..., 2], pred[..., 2])
                            - torch.minimum(gt[..., 0], pred[..., 0]), 0.0)
    enc_w = torch.clamp_min(torch.maximum(gt[..., 3], pred[..., 3])
                            - torch.minimum(gt[..., 1], pred[..., 1]), 0.0)
    diag = enc_h ** 2 + enc_w ** 2
    pen = torch.where(diag == 0.0, zero,
                      corner_dist / torch.where(diag == 0.0,
                                                torch.ones_like(diag), diag))
    return v - pen


def inverse_diou_loss(pred_boxes, pred_valid, gt_boxes, gt_valid):
    """Reward predictions that move away from ground-truth persons
    (regression_loss.py:16-142): per image, the sum over ground-truth boxes
    of the max diou over valid predictions, plus keras' epsilon; summed over
    the batch. Images with no valid prediction contribute the epsilon only.

    Args:
      pred_boxes: [B, P, 4]; pred_valid: [B, P] bool.
      gt_boxes: [B, G, 4]; gt_valid: [B, G] bool.
    Returns the scalar batch loss.
    """
    keras_eps = 1e-7
    g, p = torch.broadcast_tensors(gt_boxes[:, None, :, :],
                                   pred_boxes[:, :, None, :])
    d = _ref_quirk_diou(g, p)                                 # [B, P, G]
    d = torch.where(pred_valid[:, :, None], d,
                    torch.full_like(d, float("-inf")))
    has_pred = torch.any(pred_valid, dim=1)                   # [B]
    per_gt = torch.amax(d, dim=1)                             # [B, G]
    per_gt = torch.where(gt_valid & has_pred[:, None], per_gt,
                         torch.zeros_like(per_gt))
    per_image = torch.sum(per_gt, dim=1) + keras_eps
    return torch.sum(per_image)
