"""Detection losses: focal classification + huber box regression, in PyTorch.

Port of `mladversarialobjectdetection_tpu/train/losses.py` (reference
tf2/train_lib.py:357-464: `FocalLoss` alpha / gamma with label smoothing,
`BoxLoss` huber, `BoxIouLoss`), normalised by the positive-anchor count,
the same formulas in the same order of operations.

`l2_regularization` sums the leaves whose Flax name is `kernel` (JAX
losses.py:147-156): every conv kernel, the depthwise ones included; not
BatchNorm scale or bias, conv biases or the BiFPN `WSM` weights. The port
picks them through the weight bridge's name map (`ckpt/bridge.py`), not by
torch's parameter names.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ckpt import bridge
from ..ops import anchors as anchors_lib
from ..ops import iou_loss as iou_lib
from . import labeler as labeler_lib


def _softplus_neg_abs(logits: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-torch.abs(logits)))


def focal_loss(logits: torch.Tensor, targets_one_hot: torch.Tensor,
               alpha: float, gamma: float, normalizer,
               label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-element focal loss / normalizer (train_lib.py:357-406). The focal
    multipliers come from the unsmoothed targets; label smoothing applies
    only inside the cross-entropy (train_lib.py:394-403)."""
    y = targets_one_hot
    pred_prob = torch.sigmoid(logits)
    p_t = y * pred_prob + (1 - y) * (1 - pred_prob)
    alpha_factor = y * alpha + (1 - y) * (1 - alpha)
    modulating = (1.0 - p_t) ** gamma
    if label_smoothing:
        y = y * (1 - label_smoothing) + 0.5 * label_smoothing
    ce = torch.clamp_min(logits, 0) - logits * y + _softplus_neg_abs(logits)
    return alpha_factor * modulating * ce / normalizer


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float) -> torch.Tensor:
    err = target - pred
    abs_err = torch.abs(err)
    quad = torch.clamp_max(abs_err, delta)
    return 0.5 * quad ** 2 + delta * (abs_err - quad)


def detection_loss(cls_outputs: Sequence[torch.Tensor],
                   box_outputs: Sequence[torch.Tensor],
                   labels: labeler_lib.AnchorLabels,
                   *, num_classes: int, num_anchors: int,
                   alpha: float = 0.25, gamma: float = 1.5,
                   delta: float = 0.1, box_loss_weight: float = 50.0,
                   label_smoothing: float = 0.0,
                   anchor_boxes: torch.Tensor | None = None,
                   iou_loss_type: str | None = None,
                   iou_loss_weight: float = 1.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total per-batch detection loss (train_lib.py:530-729).

    cls_outputs / box_outputs: per level [B, H, W, A*C] / [B, H, W, A*4];
    labels: batched AnchorLabels ([B, A] / [B, A, 4] / [B]). Under an active
    mesh (`parallel.use_mesh`) these are this rank's rows: the normaliser is
    the global batch's, and the loss is this rank's share of the global one
    (the ranks' losses sum to it).
    """
    del num_anchors
    b = cls_outputs[0].shape[0]
    cls_flat = torch.cat([c.reshape(b, -1, num_classes) for c in cls_outputs],
                         dim=1)
    box_flat = torch.cat([x.reshape(b, -1, 4) for x in box_outputs], dim=1)

    cls_t = labels.cls_targets.long()                   # [B, A]
    positives = cls_t >= 0
    ignored = cls_t == -2
    one_hot = F.one_hot(torch.clamp_min(cls_t, 0), num_classes).to(cls_flat.dtype)
    one_hot = one_hot * positives[..., None]

    # the global batch's positives under an active mesh (JAX's SPMD sum), so
    # that the ranks' losses sum to the global batch's
    normalizer = parallel.reduce_sum(
        torch.sum(labels.num_positives)) + 1.0
    cls_l = focal_loss(cls_flat, one_hot, alpha, gamma, normalizer,
                       label_smoothing)
    cls_l = torch.where(ignored[..., None], torch.zeros_like(cls_l), cls_l)
    cls_loss = torch.sum(cls_l)

    box_l = huber_loss(box_flat, labels.box_targets, delta)
    box_l = box_l * positives[..., None]
    # BoxLoss normalises by num_positives * 4 (train_lib.py:441-447)
    box_loss = torch.sum(box_l) / (normalizer * 4.0)

    total = cls_loss + box_loss_weight * box_loss
    parts = {"cls_loss": cls_loss, "box_loss": box_loss}

    if iou_loss_type:
        # BoxIouLoss (train_lib.py:450-464): predictions and targets decoded
        # against the anchors, both zeroed where the target coordinate is 0
        if anchor_boxes is None:
            raise ValueError("iou_loss_type requires anchor_boxes")
        mask4 = (labels.box_targets != 0.0).to(box_flat.dtype)
        dec_pred = anchors_lib.decode_box_outputs(
            box_flat, anchor_boxes[None]) * mask4
        dec_tgt = anchors_lib.decode_box_outputs(
            labels.box_targets, anchor_boxes[None]) * mask4
        iou_l = iou_lib.iou_loss(dec_pred, dec_tgt, iou_loss_type)
        box_iou_loss = torch.sum(iou_l) / (normalizer * 4.0)
        total = total + iou_loss_weight * box_iou_loss
        parts["box_iou_loss"] = box_iou_loss

    return total, parts


def class_weighted_bce(logits: torch.Tensor, labels: torch.Tensor,
                       pos_weight: float = 1.0,
                       neg_weight: float = 1.0) -> torch.Tensor:
    """Per-element binary cross-entropy in logit space with explicit
    positive / negative weights."""
    ce = torch.clamp_min(logits, 0) - logits * labels + _softplus_neg_abs(logits)
    weights = labels * pos_weight + (1.0 - labels) * neg_weight
    return weights * ce


def self_weighted_binary_ce(y_true: torch.Tensor,
                            y_pred: torch.Tensor) -> torch.Tensor:
    """Reference util.py:192-213 `self_weightd_binary_ce`: probability-space
    BCE whose positive weight is 1 - the batch's positive fraction; the
    per-example mean over axis 1, summed over the batch.

    Args: y_true [B, N] in {0, 1}; y_pred [B, N] probabilities.
    """
    eps = 1e-7  # keras epsilon
    one, zero = torch.ones_like(y_true), torch.zeros_like(y_true)
    false_targets = torch.where(y_true != 0.0, one, zero)
    alpha_factor = 1.0 - torch.mean(false_targets)
    y_pred = torch.clamp(y_pred, eps, 1.0 - eps)
    p_t = torch.where(y_true == 1.0, y_pred, 1.0 - y_pred)
    alpha_t = torch.where(y_true == 1.0, alpha_factor * one,
                          (1.0 - alpha_factor) * one)
    loss = alpha_t * (-torch.log(p_t))
    return torch.sum(torch.mean(loss, dim=1))


def l2_regularization(net: nn.Module, weight_decay: float) -> torch.Tensor:
    """weight_decay * sum(w^2) / 2 over the parameters of `net` whose Flax
    name is `kernel` (tf.nn.l2_loss's /2 kept, train_lib.py:617-623)."""
    total = 0.0
    for param in bridge.kernel_parameters(net):
        total = total + 0.5 * torch.sum(param.to(torch.float32) ** 2)
    return weight_decay * total
