"""TFRecord dataset inspection tooling.

Port of `mladversarialobjectdetection_tpu/data/inspect_tfrecords.py`
(reference dataset/inspect_tfrecords.py): read a detection TFRecord file
pattern, print a summary (examples, boxes per image, class histogram,
image sizes), and save N annotated sample images (boxes drawn by the
port's `demo/draw.py`) for eyeballing the pipeline.

Decoding the images needs PIL and drawing needs cv2, both imported inside
the functions: they run on the host CPU only.
"""
from __future__ import annotations

import os
from collections import Counter
from typing import Optional

import numpy as np

from ..utils.log import get_logger
from .tfrecord import decode_detection_example, parse_example, \
    read_tfrecord_file

logger = get_logger(__name__)


def summarize(file_pattern: str, max_examples: Optional[int] = None) -> dict:
    """Stats over a tfrecord pattern: counts, class histogram, size range."""
    import glob
    n, n_boxes, cls_hist = 0, 0, Counter()
    hs, ws = [], []
    for path in sorted(glob.glob(file_pattern)):
        for payload in read_tfrecord_file(path):
            ex = decode_detection_example(parse_example(payload))
            n += 1
            n_boxes += len(ex["boxes"])
            cls_hist.update(ex["classes"].tolist())
            hs.append(ex["image"].shape[0])
            ws.append(ex["image"].shape[1])
            if max_examples is not None and n >= max_examples:
                break
        if max_examples is not None and n >= max_examples:
            break
    return dict(
        examples=n, boxes=n_boxes,
        boxes_per_image=(n_boxes / n if n else 0.0),
        class_histogram=dict(sorted(cls_hist.items())),
        min_hw=(min(hs), min(ws)) if hs else None,
        max_hw=(max(hs), max(ws)) if hs else None)


def save_samples(file_pattern: str, save_dir: str, samples: int = 10,
                 seed: int = 0) -> int:
    """Save `samples` annotated images (reference RecordInspect.visualize);
    returns the number written."""
    import glob

    from PIL import Image

    from ..demo import draw

    rng = np.random.default_rng(seed)
    os.makedirs(save_dir, exist_ok=True)
    paths = sorted(glob.glob(file_pattern))
    written = 0
    for path in paths:
        for payload in read_tfrecord_file(path):
            if written >= samples:
                return written
            if rng.random() > 0.5 and written < samples - 1:
                continue  # subsample
            ex = decode_detection_example(parse_example(payload))
            h, w = ex["image"].shape[:2]
            px = ex["boxes"] * np.asarray([h, w, h, w], np.float32)
            img = draw.draw_boxes(ex["image"],
                                  [tuple(b) for b in px],
                                  [1.0] * len(px))
            Image.fromarray(np.asarray(img, np.uint8)).save(
                os.path.join(save_dir, f"sample_{written:03d}.png"))
            written += 1
    return written


def main():
    import argparse
    import json
    p = argparse.ArgumentParser(description="inspect detection tfrecords")
    p.add_argument("--file-pattern", required=True)
    p.add_argument("--save-samples-dir", default="tfrecord_samples")
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--max-examples", type=int, default=None)
    a = p.parse_args()
    stats = summarize(a.file_pattern, a.max_examples)
    print(json.dumps(stats, indent=2))
    n = save_samples(a.file_pattern, a.save_samples_dir, a.samples)
    logger.info(f"saved {n} annotated samples to {a.save_samples_dir}")


if __name__ == "__main__":
    main()
