"""Differentiable colour ops: RGB<->YUV, scene-brightness and histogram matching.

Port of `mladversarialobjectdetection_tpu/ops/color.py`. Images are
[..., H, W, 3] in [-1, 1], so a batch is matched image by image. The colour
matrix is applied as per-channel FMAs, as in the JAX module, not as a 3x3
matrix product (which would run in TF32 on a card that allows it).

`random_print_adjust` draws its gain and bias from an explicit
`torch.Generator`, or takes them as arguments (the parity tests feed in the
JAX package's draws).
"""
from __future__ import annotations

import numpy as np
import torch

# tf.image.rgb_to_yuv coefficients (images are row vectors: img @ M)
_RGB2YUV = np.array([
    [0.299, -0.14714119, 0.61497538],
    [0.587, -0.28886916, -0.51496512],
    [0.114, 0.43601035, -0.10001026],
], dtype=np.float32)

# the exact inverse, rounded to float32 (tf's published yuv_to_rgb is only a
# three-decimal approximation of it)
_YUV2RGB = np.linalg.inv(np.asarray(_RGB2YUV, np.float64)).astype(np.float32)


def _apply_color_matrix(img: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    c0, c1, c2 = img[..., 0], img[..., 1], img[..., 2]
    return torch.stack([
        c0 * float(m[0, j]) + c1 * float(m[1, j]) + c2 * float(m[2, j])
        for j in range(3)], dim=-1)


def rgb_to_yuv(img: torch.Tensor) -> torch.Tensor:
    return _apply_color_matrix(img, _RGB2YUV)


def yuv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    return _apply_color_matrix(img, _YUV2RGB)


def _rescale_0_1(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] with the reference's 127/255 convention."""
    return (img + 1.0) * (127.0 / 255.0)


def _rescale_back(img: torch.Tensor) -> torch.Tensor:
    return img * (255.0 / 127.0) - 1.0


def brightness_match(src: torch.Tensor, tgt: torch.Tensor,
                     group_sum=None) -> torch.Tensor:
    """Shift `src`'s Y-channel mean to `tgt`'s, per image ([..., H, W, 3]).
    `group_sum` (a tensor's sum over the ranks that hold the other rows of
    `tgt`, equal shards) makes the mean the whole image's."""
    src_yuv = rgb_to_yuv(_rescale_0_1(src))
    tgt_yuv = rgb_to_yuv(_rescale_0_1(tgt))
    y = src_yuv[..., 0]
    tgt_y = tgt_yuv[..., 0]
    if group_sum is None:
        tgt_mean = torch.mean(tgt_y, dim=(-2, -1), keepdim=True)
    else:
        n = group_sum(torch.ones((), dtype=tgt_y.dtype, device=tgt_y.device))
        tgt_mean = group_sum(torch.sum(tgt_y, dim=(-2, -1), keepdim=True)) / (
            n * tgt_y.shape[-2] * tgt_y.shape[-1])
    shift = tgt_mean - torch.mean(y, dim=(-2, -1), keepdim=True)
    y = torch.clamp(y + shift, 0.0, 1.0)
    out = torch.stack([y, src_yuv[..., 1], src_yuv[..., 2]], dim=-1)
    return _rescale_back(torch.clamp(yuv_to_rgb(out), 0.0, 1.0))


def _equalize_histogram(y: torch.Tensor, group_sum=None) -> torch.Tensor:
    """256-bin CDF of one Y channel in [0, 1], binned as `jnp.histogram`
    (`group_sum`: the counts summed with the other rows' ranks)."""
    y = torch.clamp(y, 0.0, 1.0).reshape(-1)
    edges = torch.linspace(0.0, 1.0, 257, dtype=y.dtype, device=y.device)
    idx = torch.searchsorted(edges, y, right=True)
    idx = torch.where(y == edges[-1], edges.numel() - 1, idx)
    hist = torch.zeros(edges.numel(), dtype=torch.int64, device=y.device)
    hist = hist.index_add(0, idx, torch.ones_like(idx))[1:]
    numel = y.numel()
    if group_sum is not None:
        hist = group_sum(hist)
        numel = int(hist.sum())
    cdf = torch.cumsum(hist, 0)
    return (cdf - cdf.min()).to(torch.float32) / float(numel - 1)


def _interp(dx: torch.Tensor, dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of (dx, dy) at points x."""
    idx1 = torch.clamp(torch.searchsorted(dx, x, right=False), 1, dx.shape[0] - 1)
    idx0 = idx1 - 1
    x0, x1 = dx[idx0], dx[idx1]
    y0, y1 = dy[idx0], dy[idx1]
    denom = torch.where(x1 - x0 > 0, x1 - x0, torch.ones_like(x1))
    vals = y0 + (y1 - y0) * (x - x0) / denom
    vals = torch.where(x <= dx[0], dy[0], vals)
    return torch.where(x >= dx[-1], dy[-1], vals)


def _histogram_match_one(src: torch.Tensor, tgt: torch.Tensor,
                         group_sum=None) -> torch.Tensor:
    src_yuv = rgb_to_yuv(_rescale_0_1(src))
    tgt_yuv = rgb_to_yuv(_rescale_0_1(tgt))
    y_src = src_yuv[..., 0]
    h, w = y_src.shape
    floating = torch.from_numpy(np.clip(np.arange(
        0.0, 1.00001, 1.0 / 255.0, dtype=np.float32), 0.0, 1.0)).to(src.device)
    cdf_src = _equalize_histogram(y_src)
    cdf_tgt = _equalize_histogram(tgt_yuv[..., 0], group_sum)
    pxmap = _interp(cdf_tgt, floating, cdf_src)
    pxmap = _interp(floating, pxmap, y_src.reshape(-1).contiguous()).reshape(h, w)
    out = torch.stack([pxmap, src_yuv[..., 1], src_yuv[..., 2]], dim=-1)
    return _rescale_back(torch.clamp(yuv_to_rgb(out), 0.0, 1.0))


def histogram_match(src: torch.Tensor, tgt: torch.Tensor,
                    group_sum=None) -> torch.Tensor:
    """Full histogram specification on the Y channel, per image
    (`group_sum` as in `brightness_match`: the whole image's histogram)."""
    if src.dim() == 3:
        return _histogram_match_one(src, tgt, group_sum)
    return torch.stack([histogram_match(s, t, group_sum) for s, t in zip(src, tgt)])


def random_print_adjust(patch: torch.Tensor, generator: torch.Generator | None
                        = None, *, gain: torch.Tensor | None = None,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Print + re-imaging colour variation (reference attacker.py:365-372).

    Per image and channel, gain w ~ N(.5, .1) and bias b ~ N(0, .01), then
    clip to [-1, 1]. patch [..., P, P, 3]; gain and bias, when given, are
    [..., 3] (the drawn values, gain already including the .5 mean).
    """
    shape = patch.shape[:-3] + (3,)
    if gain is None:
        gain = 0.5 + 0.1 * torch.randn(shape, generator=generator,
                                       device=patch.device, dtype=patch.dtype)
    if bias is None:
        bias = 0.01 * torch.randn(shape, generator=generator,
                                  device=patch.device, dtype=patch.dtype)
    gain = gain.to(patch)[..., None, None, :]
    bias = bias.to(patch)[..., None, None, :]
    return torch.clamp(gain * patch + bias, -1.0, 1.0)
