"""Optional training augmentations: GridMask and Mosaic.

Port of `mladversarialobjectdetection_tpu/data/augment.py` (the reference's
automl `aug/` gridmask.py and mosaic.py as wired at dataloader.py:308-319).
GridMask runs on tensors (on the card where the images are): it draws each
image's period `d` and offsets `off_y`, `off_x` from an explicit
`torch.Generator`, and its mask is JAX's function of those draws
(`gridmask_from_draws`). Mosaic runs on the host (numpy, cv2 imported
inside it) where images are still individually sized.

The AutoAugment / RandAugment policy engine lives in `data/autoaugment.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def gridmask_from_draws(images: torch.Tensor, d: torch.Tensor,
                        off_y: torch.Tensor, off_x: torch.Tensor, *,
                        ratio: float = 0.6, fill_value: float = 0.0
                        ) -> torch.Tensor:
    """GridMask of NHWC `images` given each image's period `d` and offsets
    (int tensors of [B] or [B, 1, 1]): a pixel stays where its row or its
    column lies in the kept `int(d * ratio)` of its period."""
    b, h, w, _ = images.shape
    dev = images.device
    d, off_y, off_x = (t.to(dev, torch.int64).reshape(b, 1, 1)
                       for t in (d, off_y, off_x))
    yy = torch.arange(h, device=dev).view(1, h, 1)
    xx = torch.arange(w, device=dev).view(1, 1, w)
    keep_len = (d.to(torch.float32) * ratio).to(torch.int64)
    my = torch.remainder(yy + off_y, d) < keep_len
    mx = torch.remainder(xx + off_x, d) < keep_len
    mask = (my | mx)[..., None]
    return torch.where(mask, images, torch.as_tensor(fill_value,
                                                     dtype=images.dtype,
                                                     device=dev))


def gridmask(generator: Optional[torch.Generator], images: torch.Tensor, *,
             ratio: float = 0.6, fill_value: float = 0.0,
             d_range: Tuple[int, int] = (32, 96)) -> torch.Tensor:
    """GridMask augmentation (arXiv 2001.04086; automl aug/gridmask.py):
    mask a periodic grid of squares, with a period `d` in `d_range` and
    offsets in [0, d_range[1]) drawn per image from `generator` (on the
    images' device), keep-ratio `ratio`."""
    b = images.shape[0]
    dev = images.device
    draw = lambda lo, hi: torch.randint(lo, hi, (b,), generator=generator,
                                        device=dev)
    d = draw(d_range[0], d_range[1])
    off_y = draw(0, d_range[1])
    off_x = draw(0, d_range[1])
    return gridmask_from_draws(images, d, off_y, off_x, ratio=ratio,
                               fill_value=fill_value)


def mosaic(rng: np.random.Generator, images: Sequence[np.ndarray],
           boxes: Sequence[np.ndarray], classes: Sequence[np.ndarray],
           out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mosaic augmentation (YOLOv4-style; automl aug/mosaic.py role):
    tile 4 images around a random center, remap + clip their boxes.

    Args: 4 raw images [Hi, Wi, 3]; per-image boxes [Ni, 4] in pixels;
    classes [Ni]. Returns (image [S,S,3], boxes [N,4], classes [N]).
    """
    assert len(images) == 4
    s = out_size
    cy = int(rng.uniform(0.25, 0.75) * s)
    cx = int(rng.uniform(0.25, 0.75) * s)
    canvas = np.zeros((s, s, 3), images[0].dtype)
    quads = [(0, 0, cy, cx), (0, cx, cy, s), (cy, 0, s, cx), (cy, cx, s, s)]
    out_boxes, out_classes = [], []
    import cv2
    for (y0, x0, y1, x1), img, bxs, cls in zip(quads, images, boxes, classes):
        th, tw = y1 - y0, x1 - x0
        if th <= 0 or tw <= 0:
            continue
        ih, iw = img.shape[:2]
        scale = max(th / ih, tw / iw)
        rh, rw = int(round(ih * scale)), int(round(iw * scale))
        resized = cv2.resize(img, (rw, rh))
        crop = resized[:th, :tw]
        canvas[y0:y1, x0:x1] = crop
        if len(bxs):
            remapped = np.asarray(bxs, np.float64) * scale
            remapped += np.asarray([y0, x0, y0, x0], np.float64)
            remapped[:, 0::2] = remapped[:, 0::2].clip(y0, y1)
            remapped[:, 1::2] = remapped[:, 1::2].clip(x0, x1)
            area = ((remapped[:, 2] - remapped[:, 0])
                    * (remapped[:, 3] - remapped[:, 1]))
            keep = area > 4.0
            out_boxes.append(remapped[keep])
            out_classes.append(np.asarray(cls)[keep])
    if out_boxes:
        return (canvas, np.concatenate(out_boxes).astype(np.float32),
                np.concatenate(out_classes))
    return canvas, np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
