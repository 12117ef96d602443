"""Pure-numpy NMS family for host-side and offline use.

Copy of `mladversarialobjectdetection_tpu/ops/nms_np.py` (reference
nms_np.py:1-265: `per_class_nms` with hard, gaussian and linear soft, and
diou methods; the `nms_configs.pyfunc` path, postprocess.py:542-558). The
device NMS is `ops/nms.py` with its CUDA kernel; this host mirror serves
`ops/wbf.py`, offline evaluation and cross-checks.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def iou_np(box: np.ndarray, boxes: np.ndarray,
           plus_one: bool = False) -> np.ndarray:
    """IoU of one box [4] against boxes [N, 4] (ymin, xmin, ymax, xmax).

    plus_one=True uses the reference nms_np.py's legacy pixel-inclusive
    convention (side + 1 in every extent, nms_np.py:51,64-65) — the
    pyfunc NMS path; the default matches the device NMS exactly.
    """
    p1 = 1.0 if plus_one else 0.0
    ymin = np.maximum(box[0], boxes[:, 0])
    xmin = np.maximum(box[1], boxes[:, 1])
    ymax = np.minimum(box[2], boxes[:, 2])
    xmax = np.minimum(box[3], boxes[:, 3])
    inter = (np.maximum(0, ymax - ymin + p1)
             * np.maximum(0, xmax - xmin + p1))
    area1 = max(0.0, (box[2] - box[0] + p1) * (box[3] - box[1] + p1))
    areas = np.maximum(0, boxes[:, 2] - boxes[:, 0] + p1) * np.maximum(
        0, boxes[:, 3] - boxes[:, 1] + p1)
    union = area1 + areas - inter
    return np.where(union > 0, inter / union, 0.0)


def diou_np(box: np.ndarray, boxes: np.ndarray,
            plus_one: bool = False) -> np.ndarray:
    """Distance-IoU of one box against boxes (for diou-nms)."""
    v = iou_np(box, boxes, plus_one)
    cy1, cx1 = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
    cy2 = (boxes[:, 0] + boxes[:, 2]) / 2
    cx2 = (boxes[:, 1] + boxes[:, 3]) / 2
    center = (cy1 - cy2) ** 2 + (cx1 - cx2) ** 2
    hy1 = np.minimum(box[0], boxes[:, 0])
    hx1 = np.minimum(box[1], boxes[:, 1])
    hy2 = np.maximum(box[2], boxes[:, 2])
    hx2 = np.maximum(box[3], boxes[:, 3])
    diag = (hy2 - hy1) ** 2 + (hx2 - hx1) ** 2
    return v - center / np.maximum(diag, 1e-8)


def nms_np(boxes: np.ndarray, scores: np.ndarray, *, method: str = "hard",
           iou_thresh: float | None = None, score_thresh: float | None = None,
           sigma: float | None = None, max_output_size: int = 100,
           plus_one: bool = False
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy (soft-)NMS. Returns (indices, scores, valid_len-trimmed).

    Methods mirror reference nms_np.py: 'hard' (nms_np.py:89), 'diou'
    (nms_np.py:28), and the soft_nms family 'gaussian'/'linear'
    (nms_np.py:129-193). plus_one=True reproduces the reference's legacy
    pixel-inclusive areas exactly.
    """
    linear = False
    if method == "hard":
        sigma_v, iou_t = 0.0, iou_thresh if iou_thresh is not None else 0.5
        score_t = score_thresh if score_thresh else -np.inf
        similarity = iou_np
    elif method == "gaussian":
        sigma_v = sigma if sigma is not None else 0.5
        iou_t = 1.0
        score_t = score_thresh if score_thresh else 0.001
        similarity = iou_np
    elif method == "linear":
        # soft-NMS linear decay: weight = 1 - iou where iou > thresh
        # (nms_np.py:178-180)
        linear = True
        sigma_v = 0.0
        iou_t = iou_thresh if iou_thresh is not None else 0.3
        score_t = score_thresh if score_thresh else 0.001
        similarity = iou_np
    elif method == "diou":
        sigma_v, iou_t = 0.0, iou_thresh if iou_thresh is not None else 0.5
        score_t = score_thresh if score_thresh else -np.inf
        similarity = diou_np
    else:
        raise ValueError(method)

    scores = scores.astype(np.float64).copy()
    picked, picked_scores = [], []
    while len(picked) < max_output_size:
        best = int(np.argmax(scores))
        if scores[best] < score_t or scores[best] == -np.inf:
            break
        picked.append(best)
        picked_scores.append(scores[best])
        sim = similarity(boxes[best], boxes, plus_one)
        scores[best] = -np.inf
        if sigma_v > 0:
            scores = scores * np.exp(-(sim ** 2) / sigma_v)
            scores[np.asarray(picked)] = -np.inf
        elif linear:
            decay = np.where(sim > iou_t, 1.0 - sim, 1.0)
            finite = np.isfinite(scores)
            scores[finite] = scores[finite] * decay[finite]
            scores[np.asarray(picked)] = -np.inf
        else:
            scores[sim > iou_t] = -np.inf
    return (np.asarray(picked, np.int64), np.asarray(picked_scores),
            np.asarray([boxes[i] for i in picked]).reshape(-1, 4))


def per_class_nms(boxes: np.ndarray, scores: np.ndarray,
                  classes: np.ndarray, **kwargs
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run NMS independently per class, merge by score (nms_np.py parity).

    Returns (boxes [M,4], scores [M], classes [M]) sorted by score."""
    out_boxes, out_scores, out_classes = [], [], []
    for c in np.unique(classes):
        mask = classes == c
        idx, sc, bx = nms_np(boxes[mask], scores[mask], **kwargs)
        out_boxes.append(bx)
        out_scores.append(sc)
        out_classes.append(np.full(len(sc), c))
    if not out_scores:
        return (np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,)))
    bx = np.concatenate(out_boxes)
    sc = np.concatenate(out_scores)
    cl = np.concatenate(out_classes)
    order = np.argsort(-sc)
    m = kwargs.get("max_output_size", 100)
    return bx[order][:m], sc[order][:m], cl[order][:m]
