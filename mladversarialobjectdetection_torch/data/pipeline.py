"""Host-side input pipeline of the attack driver (synthetic data).

Port of the parts of `mladversarialobjectdetection_tpu/data/pipeline.py`
that the attack driver runs on synthetic data: `synthetic_batches` (a numpy
copy, so both packages see the same images for a seed), `augment_batch`
(PyTorch, draws from an explicit `torch.Generator` or passed in),
`skip_batches` and `prefetch`. `ImageFolderSource` and `partition` (real
image folders) are not ported yet.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..utils.image import parse_image_size

PUT_POLL_S = 0.05  # how often a blocked prefetch worker looks for a stop


def augment_batch(images: torch.Tensor, generator: torch.Generator | None = None,
                  *, flip: torch.Tensor | None = None,
                  factor: torch.Tensor | None = None,
                  delta: torch.Tensor | None = None) -> torch.Tensor:
    """Train-time augmentations (reference train_data_generator.py:201-226).

    Random horizontal flip (p .5), RandomContrast(.2) as (x - channel mean)
    * factor + channel mean with factor ~ U(.8, 1.2), random_brightness(.2)
    as + delta with delta ~ U(-.2, .2), clip to [-1, 1]. images [B, H, W, 3];
    the draws flip [B] bool, factor [B] and delta [B] are fed in or drawn
    from `generator`.
    """
    b = images.shape[0]
    dev = images.device
    if flip is None:
        flip = torch.rand((b,), generator=generator, device=dev) < 0.5
    if factor is None:
        factor = 0.8 + 0.4 * torch.rand((b,), generator=generator, device=dev)
    if delta is None:
        delta = -0.2 + 0.4 * torch.rand((b,), generator=generator, device=dev)
    col = lambda v: v.to(dev).reshape(b, 1, 1, 1)
    images = torch.where(col(flip), torch.flip(images, dims=(2,)), images)
    mean = torch.mean(images, dim=(1, 2), keepdim=True)
    images = (images - mean) * col(factor).to(images.dtype) + mean
    return torch.clamp(images + col(delta).to(images.dtype), -1.0, 1.0)


def skip_batches(iterator: Iterator[np.ndarray], n: int) -> Iterator[np.ndarray]:
    """Consume and discard the first n items; returns the iterator."""
    for _ in range(n):
        next(iterator)
    return iterator


def prefetch(iterator: Iterator, *, size: int = 2, device_put_fn=None) -> Iterator:
    """Background-thread prefetch with an optional device copy (double buffering).

    An exception in the producer is raised in the consumer. When the
    consumer is closed or dropped (a driver returns while its endless
    synthetic iterator still has batches to give), the worker stops within
    `PUT_POLL_S` and releases the batches it holds: a worker left blocked on
    a full queue would keep `size` + 1 batches, on the card with a device
    copy, for the rest of the process."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=PUT_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if device_put_fn is not None:
                    item = device_put_fn(item)
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def synthetic_batches(batch_size: int, image_size, *, seed: int = 0,
                      n_boxes: int = 2) -> Iterator[np.ndarray]:
    """Endless [B, H, W, 3] float32 batches: random backgrounds with
    high-contrast rectangles (pipeline.py:242-258, the same draws)."""
    hw = parse_image_size(image_size)
    rng = np.random.default_rng(seed)
    while True:
        imgs = rng.uniform(-1, 1, size=(batch_size, *hw, 3)).astype(np.float32)
        for b in range(batch_size):
            for _ in range(n_boxes):
                y0 = rng.integers(0, hw[0] // 2)
                x0 = rng.integers(0, hw[1] // 2)
                h = rng.integers(hw[0] // 8, hw[0] // 2)
                w = rng.integers(hw[1] // 8, hw[1] // 2)
                imgs[b, y0:y0 + h, x0:x0 + w] = rng.uniform(-1, 1, size=3)
        yield imgs
