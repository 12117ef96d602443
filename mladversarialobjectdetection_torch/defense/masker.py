"""Masker: plant patches and emit self-supervised recovery targets.

Port of `mladversarialobjectdetection_tpu/defense/masker.py` (reference
attack_detection.py:321-498, `Masker`):

- training mode: the patches are 240x240 top-left crops of a shuffled copy
  of the batch, randomly flipped; per-box scale ~ U(.3, .5); centre jitter
  tolerance .5;
- eval mode: the learned adversarial patch at its learned scale, tolerance 0;
- sensor noise +-.1;
- targets = original - patched inside the patched regions, 0 elsewhere.

Built on the attack's EOT compositor (`ops/eot.apply_patches`), so on the
card the windows go through the CUDA warp kernels (forward passes only: the
images need no gradient). The random draws come from an explicit
`torch.Generator`, or are fed in as `MaskerDraws` (the parity tests replay
the JAX package's threefry draws).

Under a spatial mesh (`height`: the images' global height, which the layout
rule row-shards), images are this rank's rows: each rank fetches the train
crops' rows from their owners (`spatial.rows`) before the batch's crops are
gathered, and `eot.apply_patches` composites every window into this rank's
rows, so the patched images, targets and region are this rank's rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import parallel
from ..ops import eot
from ..parallel import spatial
from ..utils.device import resolve_device

TRAIN_CROP = 240
TRAIN_SCALE_RANGE = (0.3, 0.5)
TRAIN_TOLERANCE = 0.5
NOISE_MAG = 0.1


class MaskerDraws(NamedTuple):
    """Random draws of `apply_masker`, fed in instead of drawn.

    perm [B] int: the batch permutation of the train crops; flip_lr, flip_ud
    [B] bool: their flips (training mode only); eot: the draws of
    `eot.apply_patches` (`eot.EOTDraws`)."""
    perm: Optional[torch.Tensor] = None
    flip_lr: Optional[torch.Tensor] = None
    flip_ud: Optional[torch.Tensor] = None
    eot: Optional[eot.EOTDraws] = None


def make_train_patches(images: torch.Tensor, crop: int = TRAIN_CROP, *,
                       generator: torch.Generator | None = None,
                       perm: torch.Tensor | None = None,
                       flip_lr: torch.Tensor | None = None,
                       flip_ud: torch.Tensor | None = None,
                       height: int | None = None) -> torch.Tensor:
    """Self-supervised patch sources: shuffled batch crops with random flips
    (attack_detection.py:487-492). images [B, H, W, 3] -> [B, c, c, 3].

    The crops are of a permutation of the whole batch. Under an active mesh
    (`parallel.use_mesh`) images is this rank's rows of the global batch:
    every rank's crops are gathered, `perm` and the flips are drawn at the
    global batch's shape, and this rank keeps its rows, so the ranks plant
    what one process plants for the global batch. Fed-in draws are this
    rank's rows (`perm`'s entries index the global batch). Under a spatial
    mesh that row-shards the images' global `height`, each rank fetches the
    crops' rows [0, crop) first, so every rank of a spatial group holds the
    same crops."""
    b, h, w, _ = images.shape
    dev = images.device
    if spatial.sharded(height):
        crop = min(crop, height, w)
        n = spatial.active().size
        top = spatial.rows(images, [0] * n, [crop] * n, dim=1)
    else:
        crop = min(crop, h, w)
        top = images
    if perm is None:
        perm = parallel.draw_rows(
            lambda n: torch.randperm(n, generator=generator, device=dev), b)
    coin = lambda n: torch.rand((n,), generator=generator, device=dev) < 0.5
    if flip_lr is None:
        flip_lr = parallel.draw_rows(coin, b)
    if flip_ud is None:
        flip_ud = parallel.draw_rows(coin, b)
    crops = parallel.all_gather_rows(top[:, :crop, :crop, :].contiguous())
    crops = crops[perm.to(dev)]
    col = lambda m: m.to(dev).reshape(b, 1, 1, 1)
    crops = torch.where(col(flip_lr), crops.flip(2), crops)
    return torch.where(col(flip_ud), crops.flip(1), crops)


def apply_masker(images, boxes, boxes_valid, *, training: bool,
                 adv_patch=None, adv_scale=0.4, return_region: bool = False,
                 generator: torch.Generator | None = None,
                 draws: MaskerDraws | None = None, device=None,
                 **eot_kwargs) -> Tuple[torch.Tensor, ...]:
    """Plant patches; return (patched images, targets[, region]).

    images [B, H, W, 3]; boxes [B, K, 4], boxes_valid [B, K]. targets[b] =
    images[b] - patched[b] inside the patched regions, else 0;
    `return_region=True` adds the [B, H, W] bool region mask. `eot_kwargs`
    pass through to `eot.apply_patches` (`height` too: under a spatial mesh
    the images' global height, images and results this rank's rows), with
    the JAX package's training hooks `train_patches` and
    `adv_scale_override`."""
    dev = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32).to(dev)
    draws = draws or MaskerDraws()
    if training:
        train_patches = eot_kwargs.pop("train_patches", None)
        if train_patches is None:
            train_patches = make_train_patches(
                images, generator=generator, perm=draws.perm,
                flip_lr=draws.flip_lr, flip_ud=draws.flip_ud,
                height=eot_kwargs.get("height"))
        patched, region = eot.apply_patches(
            images, boxes, boxes_valid,
            torch.zeros_like(train_patches[0]),  # unused placeholder
            eot_kwargs.pop("adv_scale_override", 0.0),
            generator=generator, draws=draws.eot, device=dev,
            tolerance=eot_kwargs.pop("tolerance", TRAIN_TOLERANCE),
            noise_mag=eot_kwargs.pop("noise_mag", NOISE_MAG),
            random_scale_range=eot_kwargs.pop("random_scale_range",
                                              TRAIN_SCALE_RANGE),
            per_image_patches=train_patches, **eot_kwargs)
    else:
        if adv_patch is None:
            raise ValueError("eval mode needs the adversarial patch")
        eot_kwargs.pop("train_patches", None)
        eot_kwargs.pop("adv_scale_override", None)
        patched, region = eot.apply_patches(
            images, boxes, boxes_valid, adv_patch, adv_scale,
            generator=generator, draws=draws.eot, device=dev,
            tolerance=eot_kwargs.pop("tolerance", 0.0),
            noise_mag=eot_kwargs.pop("noise_mag", NOISE_MAG), **eot_kwargs)
    targets = torch.where(region[..., None], images - patched, 0.0)
    if return_region:
        return patched, targets, region
    return patched, targets
