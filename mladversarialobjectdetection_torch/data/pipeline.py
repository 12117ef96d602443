"""Input pipeline of the drivers and the trainer (synthetic data).

Port of the parts of `mladversarialobjectdetection_tpu/data/pipeline.py`
that the drivers run on synthetic data: `synthetic_batches` (a numpy
copy, so both packages see the same images for a seed), `augment_batch`
(PyTorch, draws from an explicit `torch.Generator` or passed in),
`skip_batches` (the resume fast-forward) and `prefetch`. Also the port's
copy of the labelled scene generator that trains the synthetic-scene victim
(`examples/production_soak.py:40-118`): `synthetic_person_batch` and
`ScenePool`. `ImageFolderSource` and `partition` (real image folders) are
not ported yet.
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


def synthetic_person_batch(rng: np.random.Generator, batch: int, hw: int = 640,
                           min_boxes: int = 1, max_boxes: int = 5,
                           slots: int = 16):
    """Labelled scenes (examples/production_soak.py:40-71, the same draws):
    a smooth background with a vertical lighting gradient and tiled noise,
    and 1-5 person-shaped rectangles an image (heights 150-400 px, aspect
    .3-.5, a darker head band). Returns (images [B, hw, hw, 3] in [-1, 1],
    boxes [B, slots, 4] (ymin, xmin, ymax, xmax) px, classes [B, slots]
    int32 (0, person), valid [B, slots] bool), numpy."""
    bg = rng.uniform(-0.7, -0.1, (batch, 1, 1, 3)).astype(np.float32)
    gy = np.linspace(-0.15, 0.15, hw, dtype=np.float32)[None, :, None, None]
    imgs = np.broadcast_to(bg, (batch, hw, hw, 3)).copy()
    imgs += gy
    # float32 noise tiled from a small panel: a full-size float64 normal
    # draw per batch would cost seconds on the host
    panel = rng.standard_normal((hw // 4, hw // 4, 3),
                                dtype=np.float32) * 0.03
    imgs += np.tile(panel, (4, 4, 1))[None]
    boxes = np.zeros((batch, slots, 4), np.float32)
    valid = np.zeros((batch, slots), bool)
    classes = np.zeros((batch, slots), np.int32)
    for b in range(batch):
        n = rng.integers(min_boxes, max_boxes + 1)
        for k in range(n):
            h = rng.integers(150, 400)
            w = int(h * rng.uniform(0.3, 0.5))
            y0 = rng.integers(0, hw - h)
            x0 = rng.integers(0, hw - w)
            color = rng.uniform(0.3, 1.0, 3)
            imgs[b, y0:y0 + h, x0:x0 + w] = color
            head_h = max(8, h // 5)
            imgs[b, y0:y0 + head_h, x0:x0 + w] = color * 0.6
            boxes[b, k] = (y0, x0, y0 + h, x0 + w)
            valid[b, k] = True
    return np.clip(imgs, -1, 1), boxes, classes, valid


class ScenePool:
    """A pool of `synthetic_person_batch` scenes resident on the device
    (examples/production_soak.py:74-118): rendered and copied once, so a
    step's batch is a gather and a mirror on the device, and only the index
    and flip vectors come from the host. `sample` draws them from a numpy
    generator as the JAX pool does, and mirrors the boxes on the host."""

    def __init__(self, rng: np.random.Generator, n_batches: int = 12,
                 batch: int = 24, hw: int = 640, device=None):
        parts = [synthetic_person_batch(rng, batch, hw)
                 for _ in range(n_batches)]
        self.images = torch.from_numpy(
            np.concatenate([p[0] for p in parts])).to(device)
        self.n = int(self.images.shape[0])
        self.boxes = np.concatenate([p[1] for p in parts])
        self.classes = np.concatenate([p[2] for p in parts])
        self.valid = np.concatenate([p[3] for p in parts])
        self.hw = hw

    def sample(self, rng: np.random.Generator, batch: int):
        """(images [B, hw, hw, 3] on the device, boxes, classes, valid)."""
        idx = rng.choice(self.n, batch, replace=False)
        flip = rng.random(batch) < 0.5
        dev = self.images.device
        imgs = self.images.index_select(0, torch.from_numpy(idx).to(dev))
        flip_d = torch.from_numpy(flip).to(dev).view(-1, 1, 1, 1)
        imgs = torch.where(flip_d, torch.flip(imgs, dims=(2,)), imgs)
        boxes = self.boxes[idx].copy()
        w = float(self.hw)
        xmin = boxes[..., 1].copy()
        xmax = boxes[..., 3].copy()
        boxes[..., 1] = np.where(flip[:, None], w - xmax, xmin)
        boxes[..., 3] = np.where(flip[:, None], w - xmin, xmax)
        return imgs, boxes, self.classes[idx], self.valid[idx]
