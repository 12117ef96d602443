"""Input pipeline of the drivers and the trainer.

Port of `mladversarialobjectdetection_tpu/data/pipeline.py`:
- real image folders (JAX pipeline.py:38-183, the reference's
  DataSequence and partition): `ImageFolderSource` (read, normalize,
  aspect-preserving resize and zero-pad through the port's own
  `ops/preprocess.preprocess_host`; shuffled epochs from a numpy generator,
  wrap-padded last batch, `repeat_batches(skip_batches=)` that fast-forwards
  without reading a skipped image), `filter_by_dims` and `partition`. The
  batches are host numpy [B, H, W, 3] float32, bit-equal to JAX's; the
  drivers' `prefetch` puts them on the device. Reading an image needs PIL,
  imported where an image is read;
- synthetic data: `synthetic_batches` (a numpy copy, so both packages see
  the same images for a seed);
- `augment_batch` (PyTorch, draws from an explicit `torch.Generator` or
  passed in), `skip_batches` (the resume fast-forward) and `prefetch`.
Also the port's copy of the labelled scene generator that trains the
synthetic-scene victim (`examples/production_soak.py:40-118`):
`synthetic_person_batch` and `ScenePool`.
"""
from __future__ import annotations

import functools
import math
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import parallel
from ..parallel import spatial
from ..ops.preprocess import preprocess_host
from ..utils.image import parse_image_size
from ..utils.log import get_logger

logger = get_logger(__name__)

PUT_POLL_S = 0.05  # how often a blocked prefetch worker looks for a stop


def _read_image(img_dir: str, filename: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of one image file."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading an image folder needs PIL (Pillow), "
                          "which is not installed") from e
    im = Image.open(os.path.join(img_dir, filename))
    if im.mode != "RGB":
        im = im.convert("RGB")
    return np.asarray(im)


def _parse_label_line(line: str) -> Optional[List[float]]:
    """'cls ymin xmin ymax xmax' -> [ymin, xmin, ymax, xmax]; None for a
    blank or malformed line."""
    parts = line.split()
    if len(parts) != 5:
        return None
    try:
        return [float(v) for v in parts[1:]]
    except ValueError:
        return None


def filter_by_dims(img_dir: str, label_dir: str, max_area_ratio: float,
                   filename: str) -> bool:
    """Keep an image only if none of its boxes touches a 20 px border margin
    or covers max_area_ratio of the image (train_data_generator.py:135-158)."""
    im = _read_image(img_dir, filename)
    h, w, _ = im.shape
    label_file = os.path.splitext(filename)[0] + ".txt"
    with open(os.path.join(label_dir, label_file)) as f:
        for line in f.readlines():
            parsed = _parse_label_line(line)
            if parsed is None:
                continue
            ymin, xmin, ymax, xmax = parsed
            if ymin < 20 or xmin < 20 or ymax > h - 20 or xmax > w - 20:
                return False
            if ((ymax - ymin) * (xmax - xmin)) / (h * w) >= max_area_ratio:
                return False
    return True


class ImageFolderSource:
    """Reads and preprocesses the images of a directory (the reference's
    DataSequence)."""

    def __init__(self, img_dir: str, output_size, mean_rgb, stddev_rgb, *,
                 file_list: Optional[Sequence[str]] = None,
                 shuffle: bool = True, seed: int = 0):
        self.img_dir = img_dir
        self.output_size = parse_image_size(output_size)
        self.mean_rgb = mean_rgb
        self.stddev_rgb = stddev_rgb
        self.files = list(file_list if file_list is not None
                          else sorted(os.listdir(img_dir)))
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def shard(self, index: int, count: int) -> "ImageFolderSource":
        """Keep the index-th of `count` disjoint slices of the files (one
        process's share); returns self. Call before iterating."""
        if not (0 <= index < count):
            raise ValueError(f"bad shard ({index}, {count})")
        self.files = self.files[index::count]
        return self

    def __getitem__(self, idx: int) -> np.ndarray:
        im = _read_image(self.img_dir, self.files[idx])
        out, _ = preprocess_host(im, self.output_size, self.mean_rgb,
                                 self.stddev_rgb)
        return out

    def batches(self, batch_size: int, *, drop_remainder: bool = False,
                start_batch: int = 0) -> Iterator[np.ndarray]:
        """One epoch of [B, H, W, 3] float32 batches, the short last one
        padded by wrapping to the epoch's first images. `start_batch` skips
        the first batches of the epoch without reading their images."""
        order = np.arange(len(self.files))
        if self.shuffle:
            self.rng.shuffle(order)
        n = len(order)
        for start in range(start_batch * batch_size, n, batch_size):
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size:
                if drop_remainder:
                    return
                idxs = np.concatenate([idxs, order[: batch_size - len(idxs)]])
            yield np.stack([self[i] for i in idxs])

    def repeat_batches(self, batch_size: int, *, skip_batches: int = 0
                       ) -> Iterator[np.ndarray]:
        """Endless epochs of batches. `skip_batches` fast-forwards the stream
        (resume): each skipped full epoch advances the shuffle generator as
        an iterated epoch does (one shuffle of an equal-length permutation),
        and the rest of the skip is by index, so no skipped image is read."""
        if not self.files:
            # an empty source would otherwise loop forever without a batch
            raise ValueError(
                f"no images in {self.img_dir!r} (empty dataset, "
                f"everything filtered out, or a too-small train split)")
        per_epoch = -(-len(self.files) // batch_size)  # wrap-padded
        full, rem = divmod(skip_batches, per_epoch)
        for _ in range(full):
            if self.shuffle:
                self.rng.shuffle(np.arange(len(self.files)))
        first = True
        while True:
            yield from self.batches(batch_size,
                                    start_batch=rem if first else 0)
            first = False


def partition(config, img_dir: str, label_dir: Optional[str],
              max_area_ratio: float = 0.1, train_split: float = 0.9, *,
              batch_size: int = 2, shuffle: bool = True,
              filter_data: bool = False, seed: int = 0) -> dict:
    """The sorted folder split into train (shuffled) and val sources
    (train_data_generator.py:161-234), with their lengths in batches."""
    file_list = sorted(os.listdir(img_dir))
    if filter_data:
        if label_dir is None:
            logger.warning("no filtering done since label_dir is not provided")
        else:
            logger.info("filtering dataset by label constraints...")
            keep = functools.partial(filter_by_dims, img_dir, label_dir,
                                     max_area_ratio)
            file_list = [f for f in file_list if keep(f)]
            logger.info(f"done. data size is {len(file_list)}")
    ds_size = len(file_list)
    train_size = int(train_split * ds_size)
    mk = functools.partial(ImageFolderSource, img_dir, config.image_size,
                           config.mean_rgb, config.stddev_rgb, seed=seed)
    return {
        "train": {"source": mk(file_list=file_list[:train_size],
                               shuffle=shuffle),
                  "length": math.ceil(max(train_size, 1) / batch_size)},
        "val": {"source": mk(file_list=file_list[train_size:], shuffle=False),
                "length": math.ceil(max(ds_size - train_size, 1) / batch_size)},
    }


def augment_batch(images: torch.Tensor, generator: torch.Generator | None = None,
                  *, flip: torch.Tensor | None = None,
                  factor: torch.Tensor | None = None,
                  delta: torch.Tensor | None = None,
                  height: int | None = None) -> torch.Tensor:
    """Train-time augmentations (reference train_data_generator.py:201-226).

    Random horizontal flip (p .5), RandomContrast(.2) as (x - channel mean)
    * factor + channel mean with factor ~ U(.8, 1.2), random_brightness(.2)
    as + delta with delta ~ U(-.2, .2), clip to [-1, 1]. images [B, H, W, 3];
    the draws flip [B] bool, factor [B] and delta [B] are fed in or drawn
    from `generator` (under an active mesh, this rank's rows of the global
    batch's draws). `height`: the images' global height; under a spatial
    mesh that row-shards it, images are this rank's rows and the contrast's
    channel mean sums over the spatial group.
    """
    b = images.shape[0]
    dev = images.device
    rand = lambda: parallel.draw_rows(
        lambda n: torch.rand((n,), generator=generator, device=dev), b)
    if flip is None:
        flip = rand() < 0.5
    if factor is None:
        factor = 0.8 + 0.4 * rand()
    if delta is None:
        delta = -0.2 + 0.4 * rand()
    col = lambda v: v.to(dev).reshape(b, 1, 1, 1)
    images = torch.where(col(flip), torch.flip(images, dims=(2,)), images)
    if spatial.sharded(height):
        mean = parallel.reduce_sum(images.sum(dim=(1, 2), keepdim=True),
                                   parallel.SPATIAL_AXIS) / (height * images.shape[2])
    else:
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
