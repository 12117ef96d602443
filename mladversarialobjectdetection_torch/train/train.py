"""Supervised EfficientDet training CLI (PyTorch).

Port of `mladversarialobjectdetection_tpu/train/train.py` (reference
tf2/train.py:151-307): TFRecord or synthetic input, the configured LR
schedule, EMA, magnitude pruning during training, fine-tuning from a
pretrained detector, periodic COCO mAP (the COCOCallback of
train_lib.py:202-248) and checkpoints:

- every epoch, `ckpt-{epoch}` (a pytree file of the inference net's Flax
  variables, `ckpt/io.save_pytree(bridge.torch_to_flax(...))`, which
  `Detector(ckpt_path=)` and `train/eval.py` read) and
  `state-latest.msgpack` (the JAX `TrainState`'s flax msgpack bytes,
  `DetectorTrainer.state_dict`: either package's driver resumes from
  either's file);
- every `map_freq` epochs, the COCO metrics on `val_pattern`
  (`evaluate_map`: the frozen inference net, whose backbone runs the fused
  MBConv kernels on the card, and `postprocess_per_class`, whose NMS is
  the CUDA kernel; the evaluator on host numpy).

The train step is `DetectorTrainer`'s: train-mode BatchNorm and every
block unfused (cuDNN). TFRecord images decode on the host with PIL (CPU
only); the synthetic branch needs neither PIL nor cv2. Entry points run
on the card unless `device="cpu"`. JAX's persistent compilation cache has
no counterpart.

Across processes (`torchrun --nproc_per_node N -m
mladversarialobjectdetection_torch.train.train ...`; `main` calls
`parallel.initialize`), the driver runs JAX's data-parallel program (JAX
train.py:84-213) on `make_train_mesh`: `batch_size / N` examples a rank,
the TFRecord reader's file shard `(rank, N)` seeded `seed + rank` (the
synthetic stream `seed + 1000 * rank`), the net from rank 0, the step
reduced over the ranks (`train/trainer.py`), each rank's COCO evaluation on
its own validation shard, and only the main process writing checkpoints.
`spatial > 1` (JAX train.py:84-91) lays the ranks out as a ('data',
'spatial') mesh whose 'spatial' axis row-shards each image
(`parallel/spatial.py`): the ranks of one spatial group load the same
examples (their data shard's: reader shard and seeds by data index) and
each keeps its rows; the COCO evaluation runs each rank's validation shard
whole, outside the mesh.

Usage:
    python -m mladversarialobjectdetection_torch.train.train \
        --train-pattern 'data/train-*.tfrecord' --model efficientdet-d0
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import config as config_lib
from .. import parallel
from ..ckpt import bridge
from ..ckpt import io as ckpt_io
from ..data import pipeline
from ..data.tfrecord import DetectionTFRecordReader
from ..ops import postprocess
from ..utils.coco_metric import COCOEvaluator
from ..utils.image import parse_image_size
from ..utils.log import get_logger
from ..utils.train_loop import MetricLogger, Throughput
from .trainer import DetectorTrainer, TrainState

logger = get_logger(__name__)


@torch.no_grad()
def evaluate_map(trainer: DetectorTrainer, state: TrainState, batches,
                 n_batches: int, score_thresh: float = 0.05) -> dict:
    """COCO mAP over `n_batches` of `batches` (COCOCallback parity): dicts
    of images [B, H, W, 3] (numpy or a tensor, on any device), boxes
    [B, G, 4] px, classes [B, G] 0-based, valid [B, G] and optionally
    is_crowd [B, G]."""
    evaluator = COCOEvaluator()
    net = trainer.eval_variables(state)
    params = trainer.config.as_dict()
    for _ in range(n_batches):
        batch = next(batches)
        images = torch.as_tensor(batch["images"]).to(trainer.device)
        cls_out, box_out = net(images)
        det = postprocess.postprocess_per_class(params, cls_out, box_out)
        boxes, scores, classes, valid = (t.cpu().numpy() for t in det[:4])
        gt_boxes, gt_classes = np.asarray(batch["boxes"]), np.asarray(batch["classes"])
        gt_valid = np.asarray(batch["valid"], bool)
        crowd = batch.get("is_crowd")
        for i in range(boxes.shape[0]):
            keep = valid[i] & (scores[i] >= score_thresh)
            gt_keep = gt_valid[i]
            evaluator.add_image(
                boxes[i][keep], scores[i][keep], classes[i][keep].astype(int),
                gt_boxes[i][gt_keep],
                gt_classes[i][gt_keep] + postprocess.CLASS_OFFSET,
                gt_is_crowd=(np.asarray(crowd[i])[gt_keep] if crowd is not None
                             else None))
    return evaluator.result()


def _synthetic(batch_size: int, config, seed: int):
    """Synthetic batches (JAX train.py:171-185): random images, one valid
    box [10, 10, 50, 50] of class 0 an image."""
    g = config.max_instances_per_image
    for img in pipeline.synthetic_batches(batch_size, config.image_size,
                                          seed=seed):
        yield {"images": img,
               "boxes": np.tile(np.array([[10, 10, 50, 50]], np.float32),
                                (batch_size, g, 1)),
               "classes": np.zeros((batch_size, g), np.int32),
               "valid": np.pad(np.ones((batch_size, 1), bool),
                               ((0, 0), (0, g - 1)))}


def train(model_name: str = "efficientdet-d0", *,
          train_pattern: str | None = None, val_pattern: str | None = None,
          model_dir: str = "detector_out", batch_size: int = 8,
          num_epochs: int | None = None, steps_per_epoch: int = 1000,
          eval_batches: int = 50, map_freq: int = 5, image_size=None,
          seed: int = 0, resume: bool = False, config_override=None,
          prune_sparsity: float | None = None, prune_begin: int = 0,
          prune_end: int | None = None, spatial: int = 1,
          grad_accum: int = 1, pretrained_ckpt: str | None = None,
          finetune_mode: str = "backbone", device=None) -> TrainState:
    config = config_lib.get_efficientdet_config(model_name)
    if image_size is not None:
        config.image_size = image_size
    if num_epochs is not None:
        config.num_epochs = num_epochs
    if config_override:
        # --hparams (reference tf2/train.py): dict, 'k=v,k=v' or yaml path
        config.update(config_override)

    mesh = parallel.make_train_mesh(
        batch_size, spatial, parse_image_size(config.image_size)[0], device=device)
    trainer = DetectorTrainer(config, steps_per_epoch=steps_per_epoch,
                              grad_accum=grad_accum, device=device)
    state = trainer.init_state(seed=seed)
    start_epoch = 0
    latest = os.path.join(model_dir, "state-latest.msgpack")
    if resume and os.path.exists(latest):
        # resume-from-latest (tf2/train.py:247-252 parity)
        trainer.load_state_dict(
            state, ckpt_io.load_state_bytes(latest, trainer.state_dict(state)))
        start_epoch = state.step // steps_per_epoch
        logger.info(f"resumed from {latest} at epoch {start_epoch}")
    elif pretrained_ckpt:
        # fine-tune init. As JAX's (a deliberate deviation from the
        # reference, which prefers latest_checkpoint(model_dir)
        # unconditionally, tf2/train.py:249-261): latest wins only with
        # --resume, so warn before overwriting a populated model_dir
        if os.path.exists(latest):
            logger.warning(
                f"{latest} exists but --resume was not given: "
                f"re-initializing from --pretrained-ckpt and OVERWRITING "
                f"the previous run's progress (the reference would resume "
                f"from latest here; pass --resume for that behavior)")
        # backbone: fresh heads; trunk: fresh predict layers only
        from ..ckpt import finetune
        variables = finetune.restore_pretrained(
            bridge.torch_to_flax(state.net), pretrained_ckpt, config,
            trainer.spec, mode=finetune_mode)
        state = trainer.init_state(variables=variables)
        logger.info(f"fine-tune init ({finetune_mode}) from {pretrained_ckpt}")
    elif os.path.exists(latest):
        logger.warning(
            f"{latest} exists but --resume was not given: training starts "
            f"from scratch (the reference resumes from latest_checkpoint "
            f"unconditionally, tf2/train.py:249-261; pass --resume)")

    parallel.replicate(mesh, state.net)
    if state.ema is not None:
        parallel.replicate(mesh, state.ema)

    pruner = None
    if prune_sparsity:
        # prune during training (tf2/tfmot.py 'prune'): re-mask the kernels
        # by magnitude after each update, at tfmot's PolynomialDecay ramp
        from ..utils import sparsity as sparsity_lib
        pruner = sparsity_lib.MagnitudePruner(
            sparsity_lib.PolynomialDecaySchedule(
                final_sparsity=prune_sparsity, begin_step=prune_begin,
                end_step=(prune_end if prune_end is not None
                          else config.num_epochs * steps_per_epoch)))

    local_bs, rank = parallel.data_shard(mesh, batch_size)
    n_shards = batch_size // local_bs
    shard = (rank, n_shards) if n_shards > 1 else None
    if train_pattern:
        reader = DetectionTFRecordReader(
            train_pattern, image_size=config.image_size,
            mean_rgb=config.mean_rgb, stddev_rgb=config.stddev_rgb,
            max_instances=config.max_instances_per_image, seed=seed + rank,
            shard=shard, autoaugment_policy=config.get("autoaugment_policy"))
        batches = reader.batches(local_bs)
    else:
        logger.warning("no --train-pattern: using synthetic batches")
        batches = _synthetic(local_bs, config, seed + 1000 * rank)
    batches = pipeline.prefetch(batches, device_put_fn=lambda b: {
        **b, "images": parallel.shard_batch_local(mesh, b["images"])})

    os.makedirs(model_dir, exist_ok=True)
    mlog = MetricLogger(os.path.join(model_dir, "logs"))
    thr = Throughput()
    for epoch in range(start_epoch, config.num_epochs):
        thr.start()
        metrics = None
        for _ in range(steps_per_epoch):
            batch = next(batches)
            with parallel.use_mesh(mesh):
                state, metrics = trainer.train_step(
                    state, batch["images"], batch["boxes"], batch["classes"],
                    batch["valid"])
            if pruner is not None:
                pruner.prune(state.net, state.step)
                if state.ema is not None:  # the EMA follows the mask
                    sparsity_lib.mask_like(state.net, state.ema)
            thr.count(batch_size)
        metrics = {k: float(v) for k, v in metrics.items()}
        if pruner is not None:
            metrics["sparsity"] = sparsity_lib.sparsity_report(
                state.net)["overall"]
        mlog.log(state.step, metrics, prefix="train/")
        logger.info(f"epoch {epoch}: loss={metrics['loss']:.4f} "
                    f"{thr.rate():.1f} img/s")
        if parallel.is_main_process():  # one writer in a shared directory
            ckpt_io.save_pytree(os.path.join(model_dir, f"ckpt-{epoch}"),
                                bridge.torch_to_flax(trainer.eval_variables(state)))
            # full-state checkpoint for resume (optimizer and EMA included)
            ckpt_io.save_state_bytes(latest, trainer.state_dict(state))
        if val_pattern and (epoch + 1) % map_freq == 0:
            # skip_crowd=False: crowds ride the batch as ignore regions
            # (COCOeval semantics), as in train/eval.py; each process
            # scores its own validation shard, as JAX's
            val_reader = DetectionTFRecordReader(
                val_pattern, image_size=config.image_size,
                mean_rgb=config.mean_rgb, stddev_rgb=config.stddev_rgb,
                max_instances=config.max_instances_per_image, shuffle=False,
                skip_crowd=False, shard=shard)
            res = evaluate_map(trainer, state, val_reader.batches(local_bs),
                               eval_batches)
            mlog.log(state.step, res, prefix="eval/")
            logger.info(f"epoch {epoch}: {res}")
    mlog.close()
    return state


def main(argv=None):
    p = argparse.ArgumentParser(description="supervised detector training")
    p.add_argument("--model", default="efficientdet-d0")
    p.add_argument("--train-pattern", default=None)
    p.add_argument("--val-pattern", default=None)
    p.add_argument("--model-dir", default="detector_out")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from model_dir/state-latest.msgpack")
    p.add_argument("--hparams", default=None,
                   help="config override: 'k=v,k=v' string or yaml path "
                        "(reference tf2/train.py --hparams)")
    p.add_argument("--prune-sparsity", type=float, default=None,
                   help="magnitude-prune kernels during training to this "
                        "final sparsity (tf2/tfmot.py 'prune' method)")
    p.add_argument("--prune-begin", type=int, default=0)
    p.add_argument("--prune-end", type=int, default=None,
                   help="step at which the sparsity ramp ends "
                        "(default: last training step)")
    p.add_argument("--spatial", type=int, default=1,
                   help="shard each image's rows over this many ranks (a "
                        "('data', 'spatial') mesh)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each step's batch into this many sequential "
                        "microbatches, one mean-gradient update per step "
                        "(BN stats are per-microbatch ghost batches)")
    p.add_argument("--pretrained-ckpt", default=None,
                   help="fine-tune from this detector checkpoint (a pytree "
                        "file; reference tf2/train.py --pretrained_ckpt)")
    p.add_argument("--finetune-mode", default="backbone",
                   choices=("backbone", "trunk"),
                   help="backbone: fresh class/box heads (exclude_layers "
                        "parity, tf2/train.py:255-261); trunk: pretrained "
                        "head convs too, fresh predict layers only (the "
                        "TF-Hub fine-tune analog, train_lib.py:732-766)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    parallel.initialize(a.device)
    train(a.model, train_pattern=a.train_pattern, val_pattern=a.val_pattern,
          model_dir=a.model_dir, batch_size=a.batch_size,
          num_epochs=a.num_epochs, steps_per_epoch=a.steps_per_epoch,
          image_size=a.image_size, resume=a.resume,
          config_override=a.hparams, prune_sparsity=a.prune_sparsity,
          prune_begin=a.prune_begin, prune_end=a.prune_end,
          spatial=a.spatial, grad_accum=a.grad_accum,
          pretrained_ckpt=a.pretrained_ckpt, finetune_mode=a.finetune_mode,
          device=a.device)


if __name__ == "__main__":
    main()
