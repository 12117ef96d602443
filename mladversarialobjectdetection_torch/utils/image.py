"""Image-size utilities shared by the model, anchors and preprocessing.

A copy of `mladversarialobjectdetection_tpu/utils/image.py` (the port imports
nothing of the JAX package).

Parity with reference automl utils.py:484-526 (`parse_image_size`,
`get_feat_sizes` — the (s-1)//2+1 downsampling chain that anchors and the
FPN depend on; an off-by-one here silently breaks detection).
"""
from __future__ import annotations

from typing import Tuple, Union

ImageSize = Union[int, str, Tuple[int, int]]


def parse_image_size(image_size: ImageSize) -> Tuple[int, int]:
    """Parse int / 'WxH' string / (H, W) tuple into (height, width)."""
    if isinstance(image_size, int):
        return (image_size, image_size)
    if isinstance(image_size, str):
        width, height = image_size.lower().split("x")
        return (int(height), int(width))
    if isinstance(image_size, tuple):
        return image_size
    raise ValueError(
        f"image_size must be int, WxH string or (height, width) tuple: {image_size!r}")


def get_feat_sizes(image_size: ImageSize, max_level: int):
    """Feature map (height, width) per level 0..max_level.

    Level L has size ceil(size / 2) applied L times, i.e. the
    (s - 1) // 2 + 1 chain of the reference.
    """
    image_size = parse_image_size(image_size)
    feat_sizes = [{"height": image_size[0], "width": image_size[1]}]
    feat = image_size
    for _ in range(1, max_level + 1):
        feat = ((feat[0] - 1) // 2 + 1, (feat[1] - 1) // 2 + 1)
        feat_sizes.append({"height": feat[0], "width": feat[1]})
    return feat_sizes
