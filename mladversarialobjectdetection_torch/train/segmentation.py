"""Semantic-segmentation training (the reference's tf2/segmentation.py analog), PyTorch.

Port of `mladversarialobjectdetection_tpu/train/segmentation.py`: the
reference trains the EfficientDet SegmentationHead on oxford_iiit_pet
(tf2/segmentation.py:60-97: ``config.heads = ['segmentation']``, sparse
categorical cross-entropy from logits, accuracy, adam). As JAX's, this
module trains on a deterministic synthetic dataset with pet-style 3-class
masks (background / object / object border) whose labels are a pure
function of the image (`synthetic_seg_batches`, the same numpy draws as
JAX's), so the task is learnable end to end without a download.

`SegmentationTrainer` holds an `EfficientDetNet` with the segmentation
head only; `train_step` runs train-mode BatchNorm (Flax's: batch
statistics, the biased variance clipped at 0, running statistics moved at
momentum .99) and torch's Adam at optax.adam's defaults (b1 .9, b2 .999,
eps 1e-8). The backbone runs unfused (cuDNN) while training; `eval_step`
and `predict_mask` run the frozen net, whose fuseable blocks are the fused
MBConv kernels on the card. Masks are consumed at the head's output
resolution (`output_size`: half the min_level stride). Entry points run on
the card unless `device="cpu"`.

Data parallelism (`parallel.use_mesh`, JAX's step on a batch-sharded
array): each rank steps on its rows of the global batch; train-mode
BatchNorm normalises by the global batch's statistics (over
`bn_axis_name`, or every data axis), each rank's loss is its share of the
global mean, the gradients are summed over the ranks, and the metrics are
the global batch's. Under a ('data', 'spatial') mesh
(`make_train_mesh(b, spatial)`, `parallel/spatial.py`) the images are this
rank's rows and the masks its data shard's whole masks (JAX's
`shard_batch` routes no 3-D leaf by rows): the net gathers its logits, so
the loss is the data shard's on each rank of a spatial group and enters
the backward once in it (`spatial.count_once`), the gradients are summed
over data x spatial and the statistics of row-sharded levels reduce over
both. `train` runs on `make_mesh_for_batch` with JAX's seeds, and only the
main process writes `segmentation.pkl`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_lib
from .. import parallel
from ..ckpt import bridge
from ..ckpt import io as ckpt_io
from ..data import pipeline
from ..models.efficientdet import EfficientDetNet, spec_from_config
from ..models.init import init_weights
from ..parallel import spatial
from ..utils.device import resolve_device
from ..utils.log import get_logger
from ..utils.train_loop import MetricLogger, Throughput

logger = get_logger(__name__)


def output_size(image_size: int, min_level: int) -> int:
    """Segmentation-logit resolution for a square input: the pyramid's
    (s-1)//2+1 chain (automl utils.py:509-526) down to min_level, doubled by
    the head's last stride-2 transposed conv (efficientdet_keras.py:682-697)."""
    s = image_size
    for _ in range(min_level):
        s = (s - 1) // 2 + 1
    return s * 2


def synthetic_seg_batches(batch_size: int, image_size: int, mask_size: int,
                          *, seed: int = 0,
                          num_objects: int = 3) -> Iterator[Dict[str, Any]]:
    """Deterministic (image, mask) stream with 3 classes (JAX's draws).

    Class 0 = background, 1 = object interior, 2 = object border, the
    oxford_iiit_pet label structure the reference demo trains on: bright
    axis-aligned rectangles over a dark textured background, so the mask is
    recoverable from local image evidence."""
    rng = np.random.default_rng(seed)
    border = max(2, image_size // 32)
    while True:
        imgs = rng.normal(-0.8, 0.08,
                          (batch_size, image_size, image_size, 3))
        masks = np.zeros((batch_size, image_size, image_size), np.int32)
        for b in range(batch_size):
            for _ in range(int(rng.integers(1, num_objects + 1))):
                h = int(rng.integers(image_size // 4, image_size // 2))
                w = int(rng.integers(image_size // 4, image_size // 2))
                y = int(rng.integers(0, image_size - h))
                x = int(rng.integers(0, image_size - w))
                color = rng.uniform(0.4, 0.9, (3,))
                imgs[b, y:y + h, x:x + w] = color + rng.normal(
                    0, 0.05, (h, w, 3))
                masks[b, y:y + h, x:x + w] = 2  # border ring...
                yi, xi = y + border, x + border
                masks[b, yi:y + h - border, xi:x + w - border] = 1  # interior
        # nearest-neighbor downsample to the logits grid
        idx = (np.arange(mask_size) * (image_size / mask_size)).astype(int)
        masks = masks[:, idx][:, :, idx]
        yield {"images": np.clip(imgs, -1, 1).astype(np.float32),
               "masks": masks}


@dataclasses.dataclass
class SegTrainState:
    """The net being trained (parameters and BatchNorm statistics), its
    Adam and the step; `train_step` updates it in place."""
    net: EfficientDetNet
    optimizer: torch.optim.Adam
    step: int


class SegmentationTrainer:
    """Train and eval steps of a segmentation-headed EfficientDet."""

    def __init__(self, config, *, learning_rate: float = 1e-3,
                 bn_axis_name: str | None = None, device=None):
        config = config_lib.Config(config.as_dict())
        config.heads = ["segmentation"]
        self.config = config
        self.spec = spec_from_config(config)
        self.learning_rate = learning_rate
        self.num_classes = self.spec.seg_num_classes
        self.bn_axis_name = bn_axis_name
        self.device = resolve_device(device)

    def init_state(self, seed: int = 0, variables=None) -> SegTrainState:
        """A net drawn from `seed` (Flax's initializer families) or loaded
        from Flax `variables`, and a fresh Adam (the reference compiles
        with optimizer='adam', keras Adam at 1e-3, tf2/segmentation.py:79)."""
        net = EfficientDetNet(self.spec, bn_axis_name=self.bn_axis_name)
        if variables is not None:
            bridge.load_flax_variables(net, variables)
        else:
            init_weights(net, torch.Generator().manual_seed(seed))
        net.to(self.device)
        opt = torch.optim.Adam(net.parameters(), lr=self.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        return SegTrainState(net, opt, 0)

    def _loss(self, logits: torch.Tensor, masks: torch.Tensor):
        """Mean per-pixel cross-entropy of NHWC logits and the accuracy;
        under an active mesh, this rank's shares of the global batch's means
        (the ranks' shares sum to them)."""
        ce = F.cross_entropy(logits.permute(0, 3, 1, 2), masks)
        acc = (logits.argmax(-1) == masks).to(torch.float32).mean()
        b = masks.shape[0]
        global_b = parallel.global_rows(b)[0]
        if global_b != b:
            ce, acc = ce * (b / global_b), acc * (b / global_b)
        return ce, acc

    def _inputs(self, images, masks):
        return (torch.as_tensor(images).to(self.device),
                torch.as_tensor(masks).to(self.device, torch.int64))

    def train_step(self, state: SegTrainState, images, masks
                   ) -> Tuple[SegTrainState, Dict[str, torch.Tensor]]:
        """One step: images [B, H, W, 3] (under a spatial mesh, this rank's
        rows), masks [B, h, w] class ids at the head's resolution. Metrics:
        loss, accuracy (device tensors)."""
        images, masks = self._inputs(images, masks)
        state.optimizer.zero_grad(set_to_none=True)
        (seg,) = state.net(images, training=True)
        loss, acc = self._loss(seg, masks)
        spatial.count_once(loss).backward()
        parallel.all_reduce_grads(state.net.parameters())
        state.optimizer.step()
        state.step += 1
        loss, acc = parallel.reduce_sum(torch.stack([loss.detach(), acc])).unbind()
        return state, {"loss": loss, "accuracy": acc}

    @torch.no_grad()
    def eval_step(self, state: SegTrainState, images, masks):
        images, masks = self._inputs(images, masks)
        (seg,) = state.net(images)
        loss, acc = parallel.reduce_sum(torch.stack(self._loss(seg, masks))).unbind()
        return {"val_loss": loss, "val_accuracy": acc}

    @torch.no_grad()
    def predict_mask(self, state: SegTrainState, images) -> torch.Tensor:
        """Class-id mask for a batch (reference create_mask,
        tf2/segmentation.py:25-28)."""
        (seg,) = state.net(torch.as_tensor(images).to(self.device))
        return seg.argmax(-1)


def train(model_name: str = "efficientdet-d0", *, image_size: int = 128,
          batch_size: int = 8, steps: int = 200, log_every: int = 50,
          learning_rate: float = 1e-3, model_dir: str | None = None,
          seed: int = 0, config_override=None, device=None):
    """Train `steps` steps on synthetic masks; returns (state, the metrics
    of the last log, floats). With `model_dir`, logs to
    `logs/metrics.jsonl` and the main process saves the Flax variables as
    `segmentation.pkl`.

    Across the ranks of a process group (`parallel.initialize`), each rank
    loads `batch_size / world` examples of its own stream, seeded
    `seed + 1000 * rank` (JAX's seeds), on `make_mesh_for_batch`."""
    config = config_lib.get_efficientdet_config(model_name)
    config.image_size = image_size
    if config_override:
        config.update(config_override)
    mesh = parallel.make_mesh_for_batch(batch_size, device=device)
    trainer = SegmentationTrainer(config, learning_rate=learning_rate,
                                  device=device)
    state = trainer.init_state(seed=seed)
    parallel.replicate(mesh, state.net)
    mask_size = output_size(image_size, config.min_level)
    local_bs = parallel.local_batch_size(batch_size)
    pseed = seed + 1000 * parallel.process_index()
    batches = pipeline.prefetch(
        synthetic_seg_batches(local_bs, image_size, mask_size, seed=pseed),
        device_put_fn=lambda b: parallel.shard_batch_auto(mesh, b))
    val_batch = next(synthetic_seg_batches(local_bs, image_size, mask_size,
                                           seed=pseed + 1))

    mlog = MetricLogger(os.path.join(model_dir, "logs")) if model_dir else None
    thr = Throughput()
    thr.start()
    metrics = {}
    for step in range(1, steps + 1):
        batch = next(batches)
        with parallel.use_mesh(mesh):
            state, metrics = trainer.train_step(state, batch["images"],
                                                batch["masks"])
        if step % log_every == 0 or step == steps:
            with parallel.use_mesh(mesh):
                val = trainer.eval_step(state, val_batch["images"],
                                        val_batch["masks"])
            metrics = {k: float(v) for k, v in {**metrics, **val}.items()}
            thr.count(batch_size * log_every)
            logger.info(
                f"step {step}: loss={metrics['loss']:.4f} "
                f"acc={metrics['accuracy']:.3f} "
                f"val_acc={metrics['val_accuracy']:.3f} "
                f"({thr.rate():.1f} img/s)")
            if mlog:
                mlog.log(step, metrics, prefix="seg/")
    if model_dir and parallel.is_main_process():
        os.makedirs(model_dir, exist_ok=True)
        ckpt_io.save_pytree(os.path.join(model_dir, "segmentation"),
                            bridge.torch_to_flax(state.net))
    if mlog:
        mlog.close()
    return state, metrics


def main(argv=None):
    p = argparse.ArgumentParser(
        description="segmentation training (tf2/segmentation.py analog)")
    p.add_argument("--model", default="efficientdet-d0")
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--model-dir", default="seg_out")
    p.add_argument("--hparams", default=None,
                   help="config override 'k=v,...' or yaml path")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    parallel.initialize(a.device)
    state, metrics = train(a.model, image_size=a.image_size,
                           batch_size=a.batch_size, steps=a.steps,
                           learning_rate=a.lr, model_dir=a.model_dir,
                           config_override=a.hparams, device=a.device)
    logger.info(f"final: {metrics}")


if __name__ == "__main__":
    main()
