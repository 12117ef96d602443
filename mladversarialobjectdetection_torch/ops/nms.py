"""Fixed-shape greedy (soft-)NMS: the plain PyTorch version and its dispatch.

Port of `mladversarialobjectdetection_tpu/ops/nms.py`. Same semantics: hard
NMS or gaussian soft-NMS (decay = exp(-iou^2 / sigma), the paper's sigma)
over a static candidate set, `max_output_size` greedy steps, outputs padded
with a validity mask.

`batched_nms` is the plain version: the same arithmetic, in the same order,
as `nms.py:93-124`, written over a leading batch dim. It runs on any device
and is what the CUDA kernel (`ops/nms_cuda.py`, `csrc/nms.cu`) is held
against. `batched_nms_auto` sends CUDA tensors to the kernel and CPU tensors
to the plain version, as `nms.py:133-142` sends TPU arrays to Pallas.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

NEG_INF = -1.0e9


class NMSResult(NamedTuple):
    boxes: torch.Tensor      # [B, M, 4] selected boxes, 0-padded
    scores: torch.Tensor     # [B, M] selected (possibly decayed) scores
    indices: torch.Tensor    # [B, M] int32 indices into the candidates
    valid: torch.Tensor      # [B, M] bool validity mask
    valid_len: torch.Tensor  # [B] int32 number of valid outputs


def iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. boxes1 [..., N, 4], boxes2 [..., K, 4] -> [..., N, K]."""
    ymin1, xmin1, ymax1, xmax1 = (v[..., :, None] for v in boxes1.unbind(-1))
    ymin2, xmin2, ymax2, xmax2 = (v[..., None, :] for v in boxes2.unbind(-1))
    inter_h = torch.clamp_min(torch.minimum(ymax1, ymax2)
                              - torch.maximum(ymin1, ymin2), 0.0)
    inter_w = torch.clamp_min(torch.minimum(xmax1, xmax2)
                              - torch.maximum(xmin1, xmin2), 0.0)
    inter = inter_h * inter_w
    area1 = torch.clamp_min(ymax1 - ymin1, 0.0) * torch.clamp_min(xmax1 - xmin1, 0.0)
    area2 = torch.clamp_min(ymax2 - ymin2, 0.0) * torch.clamp_min(xmax2 - xmin2, 0.0)
    union = area1 + area2 - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def nms_thresholds(method: str, iou_thresh, score_thresh, sigma
                   ) -> Tuple[float, float, float]:
    """(sigma, iou threshold, score threshold) after the reference's defaulting.

    hard -> iou .5, score -inf; gaussian -> no hard suppression, score .001,
    sigma .5; 0.0 thresholds fall back too (the reference's `or`,
    nms.py:73-87). Each value is rounded to float32, the type it is
    compared in.
    """
    if method == "hard":
        sigma_v = 0.0
        iou_t = iou_thresh if iou_thresh is not None else 0.5
        score_t = score_thresh if score_thresh is not None else NEG_INF
    elif method == "gaussian":
        sigma_v = sigma if sigma is not None else 0.5
        iou_t = 1.0
        score_t = score_thresh if score_thresh is not None else 0.001
    else:
        raise ValueError(f"invalid nms method {method}")
    if not score_t:
        score_t = NEG_INF if method == "hard" else 0.001
    if method == "hard" and not iou_t:
        iou_t = 0.5
    return tuple(float(np.float32(v)) for v in (sigma_v, iou_t, score_t))


def inverse_sigma(sigma_v: float) -> float:
    """float32 reciprocal of sigma: the decay multiplies by it.

    XLA rewrites `-(iou * iou) / sigma` (a division by a constant) into a
    multiply by the float32 reciprocal, and ATen does the same for a CUDA
    tensor divided by a Python scalar (BinaryDivTrueKernel.cu). The plain
    version and the kernel therefore both compute
    `exp((-(iou * iou)) * inverse_sigma(sigma))`.
    """
    return float(np.float32(1.0) / np.float32(sigma_v))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, *,
                method: str = "gaussian", iou_thresh: float | None = None,
                score_thresh: float | None = None, sigma: float | None = None,
                max_output_size: int = 100) -> NMSResult:
    """Plain greedy (soft-)NMS. boxes [B, N, 4], scores [B, N] -> NMSResult.

    Each step: winner = argmax of the live scores (lowest index on ties);
    it is valid if its score passes the threshold and is not a masked
    (NEG_INF) candidate; the winner is killed, then the live scores decay
    (gaussian) or are suppressed (hard) by the winner's IoU row.
    """
    sigma_v, iou_t, score_t = nms_thresholds(method, iou_thresh,
                                             score_thresh, sigma)
    b, n, _ = boxes.shape
    m = max_output_size
    dev = boxes.device
    boxes = boxes.to(torch.float32)
    rows = torch.arange(b, device=dev)
    live = scores.to(torch.float32).clone()
    out_idx = torch.zeros((b, m), dtype=torch.int64, device=dev)
    out_scores = torch.zeros((b, m), dtype=torch.float32, device=dev)
    out_valid = torch.zeros((b, m), dtype=torch.bool, device=dev)
    for i in range(m):
        best = torch.argmax(live, dim=1)
        best_score = live[rows, best]
        ok = (best_score >= score_t) & (best_score > 0.5 * NEG_INF)
        out_idx[:, i] = torch.where(ok, best, 0)
        out_scores[:, i] = torch.where(ok, best_score, 0.0)
        out_valid[:, i] = ok
        row = iou(boxes[rows, best][:, None, :], boxes)[:, 0, :]  # [B, N]
        live[rows, best] = NEG_INF  # kill the winner before the decay
        if sigma_v > 0.0:
            decay = torch.exp(-(row * row) * inverse_sigma(sigma_v))
            live = torch.where(ok[:, None], live * decay, live)
        else:
            live = torch.where(ok[:, None] & (row > iou_t), NEG_INF, live)
    out_boxes = boxes[rows[:, None], out_idx] * out_valid[..., None].to(
        torch.float32)
    return NMSResult(out_boxes, out_scores, out_idx.to(torch.int32),
                     out_valid, out_valid.sum(dim=1, dtype=torch.int32))


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, **kwargs
               ) -> NMSResult:
    """One image: boxes [N, 4], scores [N] -> NMSResult without the batch dim."""
    res = batched_nms(boxes[None], scores[None], **kwargs)
    return NMSResult(*(t[0] for t in res))


def batched_nms_auto(boxes: torch.Tensor, scores: torch.Tensor,
                     **kwargs) -> NMSResult:
    """batched_nms through the CUDA kernel for CUDA tensors.

    CUDA tensors go to `nms_cuda.batched_nms_cuda`, which launches the
    kernel or raises; CPU tensors go to the plain version. Nothing falls
    back from the card to the CPU.
    """
    if boxes.is_cuda:
        from . import nms_cuda
        return nms_cuda.batched_nms_cuda(boxes, scores, **kwargs)
    if boxes.device.type != "cpu":
        raise ValueError(f"no NMS for device {boxes.device}")
    return batched_nms(boxes, scores, **kwargs)
