"""Weighted Boxes Fusion (model-ensembling postprocess).

Copy of `mladversarialobjectdetection_tpu/ops/wbf.py` (the reference's
tf2/wbf.py, the ensemble path of the vendored automl tree): fuse detections
from several models by clustering boxes with IoU > threshold and averaging
their coordinates weighted by score. Host numpy.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .nms_np import iou_np


def weighted_boxes_fusion(boxes_list: Sequence[np.ndarray],
                          scores_list: Sequence[np.ndarray],
                          classes_list: Sequence[np.ndarray], *,
                          iou_thresh: float = 0.55,
                          score_thresh: float = 0.0,
                          max_output_size: int = 100
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse detections from N models.

    Args: per-model boxes [Mi, 4], scores [Mi], classes [Mi].
    Returns fused (boxes, scores, classes) sorted by score.
    """
    n_models = len(boxes_list)
    boxes = np.concatenate([np.asarray(b, np.float64) for b in boxes_list])
    scores = np.concatenate([np.asarray(s, np.float64) for s in scores_list])
    classes = np.concatenate([np.asarray(c) for c in classes_list])
    keep = scores >= score_thresh
    boxes, scores, classes = boxes[keep], scores[keep], classes[keep]
    order = np.argsort(-scores)
    boxes, scores, classes = boxes[order], scores[order], classes[order]

    clusters: List[dict] = []
    for b, s, c in zip(boxes, scores, classes):
        matched = None
        for cl in clusters:
            if cl["class"] != c:
                continue
            if iou_np(cl["box"], b[None])[0] > iou_thresh:
                matched = cl
                break
        if matched is None:
            clusters.append({"class": c, "box": b.copy(), "score": s,
                             "members": [(b, s)]})
        else:
            matched["members"].append((b, s))
            ws = np.asarray([m[1] for m in matched["members"]])
            bs = np.asarray([m[0] for m in matched["members"]])
            matched["box"] = (bs * ws[:, None]).sum(0) / ws.sum()
            matched["score"] = ws.mean()

    if not clusters:
        return np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,))
    out_boxes = np.stack([cl["box"] for cl in clusters])
    # rescale scores by the fraction of models that voted (standard WBF)
    out_scores = np.asarray([
        cl["score"] * min(len(cl["members"]), n_models) / n_models
        for cl in clusters])
    out_classes = np.asarray([cl["class"] for cl in clusters])
    order = np.argsort(-out_scores)[:max_output_size]
    return out_boxes[order], out_scores[order], out_classes[order]
