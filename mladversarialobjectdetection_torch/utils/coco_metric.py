"""COCO-style detection evaluation, dependency-free, full 12-metric suite.

Port of `mladversarialobjectdetection_tpu/utils/coco_metric.py` (numpy on
the host, the same code): the reference's coco_metric.py
(EvaluationMetric, 50-280) defers to pycocotools COCOeval and reports the
standard 12 metrics (AP / AP50 / AP75 / APs / APm / APl / ARmax1 / ARmax10 /
ARmax100 / ARs / ARm / ARl) plus optional per-class AP.

COCOeval's semantics, exactly: greedy per-(image, class) matching in global
score order at each IoU threshold in .5:.95:.05, area-range gt/det ignoring
(bounds INCLUSIVE on both ends, as COCOeval's aRng check), crowd ground
truths as multi-matchable ignore regions with intersection-over-det-area
IoU (maskUtils.iou iscrowd semantics), maxDets capping, 101-point precision
interpolation, and the -1 convention for absent categories. IoU matrices
are computed once per (image, class) and shared across the (area, maxDets)
cells; only the six cells the 12 metrics read are accumulated. The box IoU
is the port's own `ops/nms_np.iou_np`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.nms_np import iou_np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES: Dict[str, Tuple[float, float]] = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}
MAX_DETS = (1, 10, 100)


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    return (np.maximum(0.0, boxes[:, 2] - boxes[:, 0])
            * np.maximum(0.0, boxes[:, 3] - boxes[:, 1]))


def _crowd_iou(det_box: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """iscrowd IoU: intersection over DET area (maskUtils.iou with
    iscrowd=1 — the crowd region is treated as unbounded ground truth)."""
    yy0 = np.maximum(det_box[0], gt_boxes[:, 0])
    xx0 = np.maximum(det_box[1], gt_boxes[:, 1])
    yy1 = np.minimum(det_box[2], gt_boxes[:, 2])
    xx1 = np.minimum(det_box[3], gt_boxes[:, 3])
    inter = (np.maximum(0.0, yy1 - yy0) * np.maximum(0.0, xx1 - xx0))
    d_area = max((det_box[2] - det_box[0]) * (det_box[3] - det_box[1]), 0.0)
    return inter / max(d_area, np.finfo(np.float64).eps)


class COCOEvaluator:
    """Accumulate per-image detections + ground truths, compute the full
    COCO metric suite."""

    def __init__(self, iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
                 max_dets: Sequence[int] = MAX_DETS):
        self.iou_thresholds = np.asarray(iou_thresholds, np.float64)
        self.max_dets = tuple(max_dets)
        self._images: List[dict] = []

    def add_image(self, det_boxes, det_scores, det_classes,
                  gt_boxes, gt_classes, gt_is_crowd=None) -> None:
        """Add one image. Boxes are [N, 4] (ymin, xmin, ymax, xmax) in
        pixels; classes are int ids (any consistent labeling).
        `gt_is_crowd` (optional bool [G]) marks crowd annotations: a
        multi-matchable ignore region — detections matching it are
        dropped from scoring instead of counted as false positives
        (COCOeval gtIg / iscrowd semantics)."""
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        crowd = (np.zeros(len(gt_boxes), bool) if gt_is_crowd is None
                 else np.asarray(gt_is_crowd).reshape(-1).astype(bool))
        self._images.append(dict(
            det_boxes=np.asarray(det_boxes, np.float64).reshape(-1, 4),
            det_scores=np.asarray(det_scores, np.float64).reshape(-1),
            det_classes=np.asarray(det_classes).reshape(-1).astype(int),
            gt_boxes=gt_boxes,
            gt_classes=np.asarray(gt_classes).reshape(-1).astype(int),
            gt_crowd=crowd))

    # -- per-(image, class) selection + IoU, shared across cells ----------
    def _img_cls_cache(self, img: dict, cls: int):
        """None if the image has nothing of this class, else a dict with
        score-sorted dets, gts, and the [D, G] IoU matrix (crowd columns
        use intersection-over-det-area, maskUtils.iou iscrowd=1)."""
        d_sel = img["det_classes"] == cls
        g_sel = img["gt_classes"] == cls
        if not d_sel.any() and not g_sel.any():
            return None
        dt_boxes = img["det_boxes"][d_sel]
        dt_scores = img["det_scores"][d_sel]
        d_order = np.argsort(-dt_scores, kind="stable")
        dt_boxes = dt_boxes[d_order]
        dt_scores = dt_scores[d_order]
        gt_boxes = img["gt_boxes"][g_sel]
        gt_crowd = img["gt_crowd"][g_sel]
        n_d, n_g = len(dt_boxes), len(gt_boxes)
        if n_d and n_g:
            ious = np.stack([iou_np(db, gt_boxes) for db in dt_boxes])
            if gt_crowd.any():
                crowd_ious = np.stack([_crowd_iou(db, gt_boxes[gt_crowd])
                                       for db in dt_boxes])
                ious[:, gt_crowd] = crowd_ious
        else:
            ious = np.zeros((n_d, n_g))
        return dict(dt_boxes=dt_boxes, dt_scores=dt_scores,
                    dt_areas=_box_areas(dt_boxes),
                    gt_crowd=gt_crowd, gt_areas=_box_areas(gt_boxes),
                    ious=ious)

    # -- per-(image, class, area, maxdet) matching (COCOeval.evaluateImg) --
    def _evaluate_img(self, cache: dict, area: Tuple[float, float],
                      max_det: int):
        """Returns (det_scores, det_matched[T, D], det_ignored[T, D],
        n_nonignored_gt)."""
        # gt ignore = crowd OR area out of range; bounds inclusive
        # (COCOeval: a < aRng[0] or a > aRng[1])
        gt_ig = (cache["gt_crowd"] | (cache["gt_areas"] < area[0])
                 | (cache["gt_areas"] > area[1]))
        gt_crowd = cache["gt_crowd"]
        # non-ignored gt first (COCOeval sorts by _ignore)
        g_order = np.argsort(gt_ig, kind="stable")
        gt_ig = gt_ig[g_order]
        gt_crowd = gt_crowd[g_order]

        dt_boxes = cache["dt_boxes"][:max_det]
        dt_scores = cache["dt_scores"][:max_det]
        d_areas = cache["dt_areas"][:max_det]
        dt_out_of_range = (d_areas < area[0]) | (d_areas > area[1])
        ious = cache["ious"][:max_det][:, g_order]

        n_t = len(self.iou_thresholds)
        n_d = len(dt_boxes)
        n_g = len(gt_ig)
        matched = np.zeros((n_t, n_d), bool)
        ignored = np.zeros((n_t, n_d), bool)
        if n_g:
            for ti, t in enumerate(self.iou_thresholds):
                gt_used = np.zeros(n_g, bool)
                for di in range(n_d):
                    best, best_iou = -1, min(float(t), 1.0 - 1e-10)
                    for gi in range(n_g):
                        # crowd gts are multi-matchable ignore regions
                        if gt_used[gi] and not gt_crowd[gi]:
                            continue
                        # once we reach ignored gts, stop if we already
                        # matched a non-ignored one (COCOeval rule)
                        if best >= 0 and not gt_ig[best] and gt_ig[gi]:
                            break
                        if ious[di, gi] >= best_iou:
                            best, best_iou = gi, ious[di, gi]
                    if best >= 0:
                        gt_used[best] = True
                        matched[ti, di] = True
                        ignored[ti, di] = gt_ig[best]
                    else:
                        ignored[ti, di] = dt_out_of_range[di]
        else:
            ignored[:] = dt_out_of_range[None, :]
        n_pig = int((~gt_ig).sum())
        return dt_scores, matched, ignored, n_pig

    def _accumulate(self, caches: List[dict], area: Tuple[float, float],
                    max_det: int):
        """(precision[T, 101], recall[T]) for one cell, or None if the class
        has no non-ignored gt anywhere (pycocotools -1 convention)."""
        scores, matched, ignored = [], [], []
        n_pig = 0
        for cache in caches:
            s, m, ig, npg = self._evaluate_img(cache, area, max_det)
            scores.append(s)
            matched.append(m)
            ignored.append(ig)
            n_pig += npg
        if n_pig == 0:
            return None
        if scores:
            scores = np.concatenate(scores)
            matched = np.concatenate(matched, axis=1)
            ignored = np.concatenate(ignored, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            matched = matched[:, order]
            ignored = ignored[:, order]
        else:
            matched = np.zeros((len(self.iou_thresholds), 0), bool)
            ignored = np.zeros_like(matched)

        n_t = len(self.iou_thresholds)
        precision = np.zeros((n_t, len(RECALL_POINTS)))
        recall = np.zeros(n_t)
        for ti in range(n_t):
            keep = ~ignored[ti]
            tp = np.cumsum(matched[ti][keep].astype(np.float64))
            fp = np.cumsum((~matched[ti][keep]).astype(np.float64))
            if len(tp) == 0:
                continue
            rc = tp / n_pig
            pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            recall[ti] = rc[-1]
            # monotone envelope
            for i in range(len(pr) - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            idx = np.searchsorted(rc, RECALL_POINTS, side="left")
            valid = idx < len(pr)
            precision[ti][valid] = pr[np.minimum(idx[valid], len(pr) - 1)]
        return precision, recall

    def result(self, per_class: bool = False) -> Dict[str, float]:
        """The 12 standard metrics (reference coco_metric.py:186-201), plus
        'AP_/<cls>' per-class entries when per_class=True (the label_map
        branch at 203-214)."""
        classes = sorted({int(c) for img in self._images
                          for c in np.concatenate([img["gt_classes"],
                                                   img["det_classes"]])})
        # per-(image, class) dets/gts/IoUs computed ONCE, shared by cells
        cls_caches: Dict[int, List[dict]] = {}
        for c in classes:
            caches = [self._img_cls_cache(img, c) for img in self._images]
            cls_caches[c] = [cc for cc in caches if cc is not None]

        md = max(self.max_dets)
        # only the cells the 12 metrics read (COCOeval computes all
        # area x maxDets combinations; half are never summarized)
        needed = ({("all", m) for m in self.max_dets}
                  | {(a, md) for a in AREA_RANGES})
        cells: Dict[Tuple[str, int], dict] = {}
        for aname, m in needed:
            cells[(aname, m)] = {c: self._accumulate(
                cls_caches[c], AREA_RANGES[aname], m) for c in classes}

        def mean_ap(aname: str, max_det: int,
                    thresh: Optional[float] = None,
                    only_cls: Optional[int] = None) -> float:
            vals = []
            for c, acc in cells[(aname, max_det)].items():
                if acc is None or (only_cls is not None and c != only_cls):
                    continue
                precision, _ = acc
                if thresh is None:
                    vals.append(precision.mean())
                else:
                    ti = int(np.argmin(np.abs(self.iou_thresholds - thresh)))
                    vals.append(precision[ti].mean())
            return float(np.mean(vals)) if vals else -1.0

        def mean_ar(aname: str, max_det: int) -> float:
            vals = [acc[1].mean()
                    for acc in cells[(aname, max_det)].values()
                    if acc is not None]
            return float(np.mean(vals)) if vals else -1.0

        out = {
            "AP": mean_ap("all", md),
            "AP50": mean_ap("all", md, thresh=0.5),
            "AP75": mean_ap("all", md, thresh=0.75),
            "APs": mean_ap("small", md),
            "APm": mean_ap("medium", md),
            "APl": mean_ap("large", md),
            "ARmax1": mean_ar("all", self.max_dets[0]),
            "ARmax10": mean_ar("all", self.max_dets[1]),
            "ARmax100": mean_ar("all", md),
            "ARs": mean_ar("small", md),
            "ARm": mean_ar("medium", md),
            "ARl": mean_ar("large", md),
        }
        if per_class:
            for c in classes:
                out[f"AP_/{c}"] = mean_ap("all", md, only_cls=c)
        return out
