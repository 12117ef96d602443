"""Input preprocessing: aspect-preserving resize, normalize, zero-pad.

A numpy copy of `preprocess_host`, its resize taps and the dense
`linear_resize_matrix` from
`mladversarialobjectdetection_tpu/ops/preprocess.py:28-111`, so that both
packages feed their networks (and the EOT canvas resize) bit-identical
values; and `preprocess_device`, the port of `preprocess_jax` (:114-129)
for a batch of frames of one shape on the card.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..utils.image import parse_image_size


@functools.lru_cache(maxsize=64)
def linear_resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] antialiased linear-resize matrix (half-pixel centers).

    The dense form of `_resize_taps`: a triangle filter whose support widens
    with the downscale ratio, weights normalized per output pixel. Callers
    must not write into the cached array.
    """
    ratio = n_in / n_out
    radius = max(ratio, 1.0)
    out_centers = (np.arange(n_out) + 0.5) * ratio - 0.5
    dist = np.abs(out_centers[:, None] - np.arange(n_in)[None, :])
    w = np.maximum(0.0, 1.0 - dist / radius)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-8)
    return w.astype(np.float32)


def _resize_taps(n_out: int, n_in: int):
    """Antialiased linear-resize taps: (idx [n_out, T], w [n_out, T]).

    Matches tf.image.resize(method=BILINEAR, antialias=True), the resize
    the reference serving path uses (dataloader.py:130-136
    `resize_and_crop_image`): a triangle filter with half-pixel centers
    whose support widens with the downscale ratio, weights normalized per
    output pixel. It has at most ceil(2*radius)+1 nonzeros per output
    pixel, and only those are enumerated."""
    ratio = n_in / n_out
    radius = max(ratio, 1.0)
    taps = int(np.ceil(2 * radius)) + 1
    out_centers = (np.arange(n_out) + 0.5) * ratio - 0.5
    first = np.clip(np.ceil(out_centers - radius).astype(np.int64),
                    0, max(n_in - taps, 0))
    idx = first[:, None] + np.arange(taps)[None, :]          # [n_out, T]
    idx = np.minimum(idx, n_in - 1)
    dist = np.abs(out_centers[:, None] - idx)
    w = np.maximum(0.0, 1.0 - dist / radius)
    # duplicate clamped indices must not double-count
    dup = np.zeros_like(w, dtype=bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    w[dup] = 0.0
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-8)
    return idx, w.astype(np.float32)


def resize_linear_np(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable antialiased linear resize of an [H, W, C] float image."""
    image = image.astype(np.float32)
    iy, wy = _resize_taps(out_h, image.shape[0])
    t = np.einsum("ot,otwc->owc", wy, image[iy], optimize=True)
    ix, wx = _resize_taps(out_w, image.shape[1])
    return np.einsum("ot,hotc->hoc", wx, t[:, ix], optimize=True)


def preprocess_host(image: np.ndarray, output_size, mean_rgb, stddev_rgb
                    ) -> Tuple[np.ndarray, float]:
    """Normalize, resize (aspect preserving) and zero-pad one raw frame.

    Args:
      image: [H, W, 3] uint8/float RGB.
      output_size: int or (h, w).
      mean_rgb / stddev_rgb: scalar or per-channel normalization constants.

    Returns: (padded [h, w, 3] float32 in normalized space, scale_to_original).
    """
    output_size = parse_image_size(output_size)
    h, w = image.shape[:2]

    scale = min(output_size[1] / w, output_size[0] / h)
    scaled_h, scaled_w = int(h * scale), int(w * scale)
    # normalize AFTER the resize: the per-output-normalized linear filter
    # commutes with the affine normalization (weights sum to 1), and the
    # scaled image is (1/scale)^2 x smaller to normalize
    scaled = resize_linear_np(image.astype(np.float32), scaled_h, scaled_w)
    scaled -= np.asarray(mean_rgb, np.float32)
    scaled /= np.asarray(stddev_rgb, np.float32)
    out = np.zeros((*output_size, 3), np.float32)
    out[:scaled_h, :scaled_w, :] = scaled
    return out, 1.0 / scale


@functools.lru_cache(maxsize=16)
def _resize_matrix_on(n_out: int, n_in: int, device: str) -> torch.Tensor:
    return torch.from_numpy(linear_resize_matrix(n_out, n_in)).to(device)


def preprocess_device(images: torch.Tensor, output_size, mean_rgb, stddev_rgb
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`preprocess_jax` over a batch: [B, H, W, 3] frames of one shape (uint8
    or float) on any device -> (padded [B, h, w, 3] float32, scales [B]).

    Normalize, then the antialiased bilinear resize of
    `jax.image.resize(..., "bilinear", antialias=True)` as two products with
    `linear_resize_matrix` (its triangle filter with half-pixel centers; the
    tests hold it to `preprocess_jax`), then zero-pad bottom and right."""
    output_size = parse_image_size(output_size)
    b, h, w = images.shape[:3]
    dev = images.device
    x = images.to(torch.float32)
    x = ((x - torch.as_tensor(mean_rgb, dtype=torch.float32, device=dev))
         / torch.as_tensor(stddev_rgb, dtype=torch.float32, device=dev))
    scale = min(output_size[1] / w, output_size[0] / h)
    scaled_h, scaled_w = int(h * scale), int(w * scale)
    rows = _resize_matrix_on(scaled_h, h, str(dev))
    cols = _resize_matrix_on(scaled_w, w, str(dev))
    scaled = torch.einsum("pw,bowc->bopc", cols,
                          torch.einsum("oh,bhwc->bowc", rows, x))
    out = torch.zeros((b, *output_size, 3), dtype=torch.float32, device=dev)
    out[:, :scaled_h, :scaled_w] = scaled
    return out, torch.full((b,), 1.0 / scale, dtype=torch.float32, device=dev)
