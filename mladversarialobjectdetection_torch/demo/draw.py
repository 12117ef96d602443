"""Drawing utilities: score-coloured boxes, shadowed text overlays,
threshold filtering.

Copy of `mladversarialobjectdetection_tpu/demo/draw.py` (reference
util.py:104-174: draw_boxes through automl's vis_utils, puttext_blk_bg,
filter_by_thresh) in plain cv2 primitives. cv2 is imported where a frame
is drawn on, so the module imports without it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def filter_by_thresh(boxes: Sequence, scores: Sequence, thresh: float
                     ) -> Tuple[List, List]:
    """Keep detections with score >= thresh (util.py:163-174)."""
    bb, sc = [], []
    for b, s in zip(boxes, scores):
        if s >= thresh:
            bb.append(b)
            sc.append(s)
    return bb, sc


def _score_color(score: float) -> Tuple[int, int, int]:
    """Green for confident, red for weak (score-colored boxes)."""
    g = int(255 * min(max(score, 0.0), 1.0))
    return (255 - g, g, 0)


def draw_boxes(frame: np.ndarray, boxes: Sequence, scores: Sequence,
               thickness: int = 2,
               labels: Sequence[str] | None = None) -> np.ndarray:
    """Draw boxes with score labels (util.py:104-128). `labels` gives a
    class name per box (inspector all-class mode); default 'person'."""
    import cv2
    frame = np.ascontiguousarray(frame)
    if not frame.flags.writeable:  # e.g. np.frombuffer-backed decode
        frame = frame.copy()
    for i, (box, score) in enumerate(zip(boxes, scores)):
        ymin, xmin, ymax, xmax = [int(v) for v in box]
        color = _score_color(float(score))
        cv2.rectangle(frame, (xmin, ymin), (xmax, ymax), color, thickness)
        name = labels[i] if labels is not None else "person"
        label = f"{name}: {int(round(float(score) * 100))}%"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(frame, (xmin, ymin - th - 6), (xmin + tw + 2, ymin),
                      color, -1)
        cv2.putText(frame, label, (xmin + 1, ymin - 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    return frame


def put_text(frame: np.ndarray, text: str, org: Tuple[int, int], *,
             color=(255, 255, 255), scale: float = 0.7) -> np.ndarray:
    """Text with a dark shadow for legibility (util.py:131-160)."""
    import cv2
    frame = np.ascontiguousarray(frame)
    if not frame.flags.writeable:  # e.g. np.frombuffer-backed decode
        frame = frame.copy()
    cv2.putText(frame, text, (org[0] + 2, org[1] + 2),
                cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), 3)
    cv2.putText(frame, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, 2)
    return frame
