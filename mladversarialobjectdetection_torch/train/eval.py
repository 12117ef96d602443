"""Standalone COCO evaluation CLI over validation TFRecords (PyTorch).

Port of `mladversarialobjectdetection_tpu/train/eval.py` (reference
tf2/eval.py:47-126): build the detector from a checkpoint (the port's
`Detector(post_mode="per_class", ckpt_path=)`: the fused MBConv kernels
and the NMS kernel on the card), stream `--val-file-pattern` TFRecords
through it, and print the 12-metric COCO suite (and per-class AP, the
reference's `AP_/<name>` entries through `utils/label_util`, eval.py:
121-125). Crowd annotations are kept (skip_crowd=False) and are COCOeval
ignore regions (`utils/coco_metric.py`). `follow` is the continuous-eval
mode (tf2/train.py:271-297): evaluate each new `ckpt-{epoch}`, archive the
best by AP, tolerate a checkpoint deleted mid-eval, stop after
`idle_timeout` seconds without a new one or at `until_epoch`.

TFRecord images decode on the host with PIL (CPU only). Evaluating an
exported artifact (`artifact=`, `--artifact`) is ROADMAP Queue 1 item 5
(export and quantize) and raises.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from ..utils.log import get_logger

logger = get_logger(__name__)

ARTIFACT_NOT_PORTED = ("evaluating an exported artifact is not ported yet "
                       "(ROADMAP Queue 1 item 5, export and quantize)")


def count_examples(file_pattern: str) -> int:
    """Number of records across the shard glob (for the default 'evaluate
    everything once' behavior, eval.py:108-110)."""
    import glob

    from ..data.tfrecord import read_tfrecord_file

    n = 0
    for path in sorted(glob.glob(file_pattern)):
        for _ in read_tfrecord_file(path):
            n += 1
    return n


def evaluate(model_name: str, val_file_pattern: str, *,
             ckpt: Optional[str] = None, batch_size: int = 8,
             eval_samples: Optional[int] = None,
             hparams: Optional[str] = None,
             image_size: Optional[int] = None,
             score_thresh: float = 0.0, per_class: bool = False,
             max_instances: Optional[int] = None,
             artifact: Optional[str] = None, device=None) -> dict:
    """Run COCO eval; returns the metric dict (eval.py:115-125)."""
    if artifact:
        raise NotImplementedError(ARTIFACT_NOT_PORTED)
    from .. import config as config_lib
    from ..data.tfrecord import DetectionTFRecordReader
    from ..inference.detector import Detector
    from ..ops import postprocess
    from ..utils import label_util
    from ..utils.coco_metric import COCOEvaluator

    cfg = config_lib.get_efficientdet_config(model_name)
    if hparams:
        cfg.override(hparams)
    if image_size:
        cfg.image_size = image_size

    total = count_examples(val_file_pattern)
    n_eval = min(eval_samples, total) if eval_samples else total
    n_batches = n_eval // batch_size
    dropped = n_eval - n_batches * batch_size
    if n_batches == 0:
        raise ValueError(
            f"eval needs >= batch_size ({batch_size}) samples; "
            f"{n_eval} available under {val_file_pattern!r}")
    if dropped:
        logger.warning(f"evaluating {n_batches * batch_size}/{n_eval} "
                       f"samples ({dropped} dropped by batching)")

    # per-class NMS, the reference eval's generate_detections path
    # (eval.py:84-88 -> postprocess per_class)
    det = Detector(model_name=model_name, params=cfg.as_dict(),
                   ckpt_path=ckpt, post_mode="per_class", device=device)
    cfg = det.config
    reader = DetectionTFRecordReader(
        val_file_pattern, image_size=cfg.image_size,
        mean_rgb=cfg.mean_rgb, stddev_rgb=cfg.stddev_rgb,
        max_instances=max_instances or cfg.max_instances_per_image,
        skip_crowd=False, shuffle=False)

    evaluator = COCOEvaluator()
    ones = torch.ones((batch_size,), dtype=torch.float32, device=det.device)
    batches = reader.batches(batch_size)
    for b in range(n_batches):
        batch = next(batches)
        images = torch.from_numpy(batch["images"]).to(det.device)
        detections = [t.cpu().numpy()
                      for t in det.serve_tensors(images, ones)[:4]]
        boxes, scores, classes, valid = detections
        for i in range(batch_size):
            keep = valid[i] & (scores[i] >= score_thresh)
            gt_keep = batch["valid"][i]
            evaluator.add_image(
                boxes[i][keep], scores[i][keep], classes[i][keep].astype(int),
                batch["boxes"][i][gt_keep],
                batch["classes"][i][gt_keep] + postprocess.CLASS_OFFSET,
                gt_is_crowd=batch["is_crowd"][i][gt_keep])
        logger.info(f"batch {b + 1}/{n_batches}")

    metrics = evaluator.result(per_class=per_class)
    if per_class:
        # raw ids to names, the reference's 'AP_/<name>' entries
        label_map = label_util.get_label_map(getattr(cfg, "label_map", None))
        metrics = {
            (f"AP_/{label_map.get(int(k[4:]), k[4:])}"
             if k.startswith("AP_/") and k[4:].lstrip("-").isdigit()
             else k): v
            for k, v in metrics.items()}
    return metrics


def follow(model_name: str, val_file_pattern: str, model_dir: str, *,
           min_interval: float = 180.0, idle_timeout: Optional[float] = None,
           until_epoch: Optional[int] = None, archive: bool = True,
           **eval_kw) -> dict:
    """Continuous evaluation: watch `model_dir` for new `ckpt-{epoch}`
    checkpoints (the `ckpt-{epoch}.pkl` pytree files `train.train` writes),
    evaluate each as it appears, and archive the best by AP: a copy as
    `model_dir/archive.pkl` (read with `ckpt=model_dir/archive`) and its
    epoch and AP in `model_dir/best_eval.txt` (JAX copies an orbax directory
    to `archive/`, with `best_eval.txt` inside).

    Parity with the reference's continuous-eval mode (tf2/train.py:271-297:
    checkpoints_iterator at min_interval_secs=180, deletion tolerance,
    archive_ckpt on AP improvement, termination at num_epochs); as JAX's,
    `idle_timeout` (seconds with no new checkpoint) replaces waiting
    forever. Returns {epoch: metrics} for every checkpoint evaluated."""
    import re
    import shutil
    import time

    evaluated = set()
    best_ap = float("-inf")
    results: dict = {}
    last_new = time.time()
    while True:
        found = []
        if os.path.isdir(model_dir):
            for name in os.listdir(model_dir):
                m = re.fullmatch(r"ckpt-(\d+)\.pkl", name)
                if m and name[:-4] not in evaluated:
                    found.append((int(m.group(1)), name[:-4]))
        for epoch, name in sorted(found):
            path = os.path.join(model_dir, name)
            evaluated.add(name)
            last_new = time.time()
            logger.info(f"evaluating {path}")
            try:
                metrics = evaluate(model_name, val_file_pattern, ckpt=path,
                                   **eval_kw)
            except Exception:
                if not os.path.exists(path + ".pkl"):
                    # the trainer may delete old checkpoints while they are
                    # read (tf2/train.py:292-296 NotFoundError)
                    logger.info(f"{path} deleted mid-eval, skipping")
                    continue
                raise
            results[epoch] = metrics
            logger.info(f"eval results for {path}: AP={metrics['AP']:.5f}")
            if archive and metrics["AP"] > best_ap:
                best_ap = metrics["AP"]
                if os.path.exists(path + ".pkl"):  # may race with the trainer
                    shutil.copy(path + ".pkl",
                                os.path.join(model_dir, "archive.pkl"))
                    with open(os.path.join(model_dir, "best_eval.txt"), "w") as f:
                        f.write(f"{epoch} {metrics['AP']:.6f}\n")
            if until_epoch is not None and epoch >= until_epoch:
                logger.info(f"final epoch {epoch} reached; stopping")
                return results
        if idle_timeout is not None and time.time() - last_new > idle_timeout:
            logger.info(f"no new checkpoint for {idle_timeout:.0f}s; stopping")
            return results
        time.sleep(min_interval)


def main(argv=None):
    p = argparse.ArgumentParser(description="COCO evaluation over TFRecords")
    p.add_argument("--model", default="efficientdet-d0")
    p.add_argument("--val-file-pattern", required=True,
                   help="glob for eval tfrecords, e.g. coco/val-*.tfrecord")
    p.add_argument("--ckpt", default=None,
                   help="pytree checkpoint path (<ckpt>.pkl)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--eval-samples", type=int, default=None,
                   help="cap on evaluated examples (default: all)")
    p.add_argument("--hparams", default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--score-thresh", type=float, default=0.0)
    p.add_argument("--per-class", action="store_true",
                   help="also report AP_/<class> entries")
    p.add_argument("--artifact", default=None,
                   help="evaluate an exported artifact (not ported yet)")
    p.add_argument("--follow", default=None, metavar="MODEL_DIR",
                   help="continuous eval: watch MODEL_DIR for new "
                        "ckpt-{epoch} checkpoints and evaluate each "
                        "(tf2/train.py:271-297 continuous-eval mode)")
    p.add_argument("--min-interval", type=float, default=180.0,
                   help="--follow poll interval seconds (reference "
                        "checkpoints_iterator min_interval_secs)")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="--follow: stop after this many seconds without a "
                        "new checkpoint (default: wait forever)")
    p.add_argument("--until-epoch", type=int, default=None,
                   help="--follow: stop once this epoch is evaluated "
                        "(reference config.num_epochs termination)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    eval_kw = dict(batch_size=args.batch_size, eval_samples=args.eval_samples,
                   hparams=args.hparams, image_size=args.image_size,
                   score_thresh=args.score_thresh, per_class=args.per_class,
                   device=args.device)
    if args.follow:
        results = follow(args.model, args.val_file_pattern, args.follow,
                         min_interval=args.min_interval,
                         idle_timeout=args.idle_timeout,
                         until_epoch=args.until_epoch, **eval_kw)
        for epoch in sorted(results):
            print(args.model, f"ckpt-{epoch}",
                  {k: round(float(v), 5) for k, v in results[epoch].items()})
        return
    metrics = evaluate(args.model, args.val_file_pattern, ckpt=args.ckpt,
                       artifact=args.artifact, **eval_kw)
    print(args.model, {k: round(float(v), 5) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
