"""End-to-end workflow at small scale: train a detector, attack it, defend it.

Port of `examples/end_to_end_attack.py:33-144`, self-contained on synthetic
rectangle scenes:

1. train a small EfficientDet (lite0 at `--image-size`, 4 classes with
   class 0 the "person", fpn 32, 2 cell and 2 head repeats) on scenes where
   the persons are bright rectangles with known boxes;
2. count its detections on clean scenes, then train a patch against the
   frozen detector and report the mean max score and ASR of the first and
   last steps;
3. train the U-Net defender briefly and report its eval recovery loss.

`synthetic_scene_batch` draws from the numpy generator in the JAX
example's order, so the scenes equal JAX's for a seed; the detector, the
patch and the U-Net are drawn by the port's `init_state(seed)` from `seed`,
`seed + 1` and `seed + 2` where JAX draws from `PRNGKey` of the same
numbers, so they are not JAX's.

Usage:
    python -m mladversarialobjectdetection_torch.examples.end_to_end_attack \\
        --image-size 128 --det-steps 300 [--bf16] [--device cpu]
"""
from __future__ import annotations

import argparse
import gc
import time

import numpy as np
import torch

from .. import config as config_lib
from ..attack.attacker import PatchAttacker
from ..defense.defender import PatchAttackDefender
from ..train.trainer import DetectorTrainer
from ..utils.device import resolve_device


def synthetic_scene_batch(rng: np.random.Generator, batch: int, hw: int,
                          n_boxes: int = 2):
    """Scenes: a smooth background and solid bright rectangles ("persons").
    Returns (images [B, hw, hw, 3] in [-1, 1], boxes [B, n_boxes, 4]
    (ymin, xmin, ymax, xmax) px, valid [B, n_boxes]), numpy."""
    imgs = np.full((batch, hw, hw, 3),
                   rng.uniform(-0.6, -0.2, (batch, 1, 1, 3)), np.float32)
    imgs += rng.normal(0, 0.03, imgs.shape).astype(np.float32)
    boxes = np.zeros((batch, n_boxes, 4), np.float32)
    valid = np.zeros((batch, n_boxes), bool)
    for b in range(batch):
        for k in range(n_boxes):
            h = rng.integers(hw // 4, hw // 2)
            w = rng.integers(hw // 6, hw // 3)
            y0 = rng.integers(0, hw - h)
            x0 = rng.integers(0, hw - w)
            color = rng.uniform(0.4, 1.0, 3)
            imgs[b, y0:y0 + h, x0:x0 + w] = color
            boxes[b, k] = (y0, x0, y0 + h, x0 + w)
            valid[b, k] = True
    return np.clip(imgs, -1, 1), boxes, valid


def make_config(image_size: int = 128, bf16: bool = False):
    """lite0 at `image_size` with a 4-class head, fpn 32, 2 repeats, the
    attack driver's NMS (256 candidates, 25 outputs), 8 boxes an image,
    SGD .08 from a warmup of .004, no EMA."""
    cfg = config_lib.get_efficientdet_config("efficientdet-lite0")
    cfg.image_size = image_size
    cfg.fpn_num_filters = 32
    cfg.fpn_cell_repeats = 2
    cfg.box_class_repeats = 2
    cfg.num_classes = 4  # a tiny head; class 0 is the "person"
    cfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5,
                            "pre_nms_topk": 256, "max_output_size": 25})
    cfg.max_boxes_per_image = 8
    cfg.mixed_precision = bf16
    cfg.learning_rate = 0.08
    cfg.lr_warmup_init = 0.004
    cfg.optimizer = "sgd"
    cfg.moving_average_decay = 0.0
    return cfg


def main(image_size=128, det_steps=300, attack_steps=150, defend_steps=60,
         batch=8, seed=0, bf16=False, device=None):
    """The workflow; returns the attack's first and last step metrics."""
    device = resolve_device(device)
    cfg = make_config(image_size, bf16)
    rng = np.random.default_rng(seed)

    # -- 1. supervised detector training ---------------------------------
    trainer = DetectorTrainer(cfg, steps_per_epoch=det_steps, device=device)
    state = trainer.init_state(seed=seed)
    t0 = time.time()
    for i in range(det_steps):
        imgs, boxes, valid = synthetic_scene_batch(rng, batch, image_size)
        classes = np.zeros(valid.shape, np.int32)
        state, metrics = trainer.train_step(state, imgs, boxes, classes, valid)
        if (i + 1) % 50 == 0:
            print(f"[detector] step {i+1}: loss={float(metrics['loss']):.3f} "
                  f"cls={float(metrics['cls_loss']):.3f} "
                  f"box={float(metrics['box_loss']):.4f} "
                  f"({(i+1)*batch/(time.time()-t0):.1f} img/s)", flush=True)
    net = trainer.eval_variables(state, use_ema=False)
    del trainer, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- quality gate: does it detect the rectangles? ---------------------
    attacker = PatchAttacker(cfg, net, patch_size=image_size,
                             learning_rate=1e-2, device=device)
    imgs, _, _ = synthetic_scene_batch(rng, batch, image_size)
    _, scores, valid = attacker.first_pass(torch.from_numpy(imgs).to(device))
    n_det = int(valid.sum())
    mean_score = float((scores.float() * valid).sum() / max(1, n_det))
    print(f"[detector] detections on clean scenes: {n_det} "
          f"(mean score {mean_score:.3f})")

    # -- 2. adversarial patch training ------------------------------------
    astate = attacker.init_state(seed + 1)
    first = m = None
    for i in range(attack_steps):
        imgs, _, _ = synthetic_scene_batch(rng, batch, image_size)
        astate, m = attacker.train_step(astate, torch.from_numpy(imgs).to(device))
        if i == 0:
            first = {k: float(v) for k, v in m._asdict().items()}
        if (i + 1) % 30 == 0:
            print(f"[attack] step {i+1}: mean_max_score="
                  f"{float(m.mean_max_score):.3f} asr={float(m.asr):.3f} "
                  f"scale={float(m.scale):.3f}", flush=True)
    last = {k: float(v) for k, v in m._asdict().items()}
    print(f"[attack] mean_max_score {first['mean_max_score']:.3f} -> "
          f"{last['mean_max_score']:.3f}; asr {first['asr']:.3f} -> "
          f"{last['asr']:.3f}")

    # -- 3. defender training ---------------------------------------------
    defender = PatchAttackDefender(cfg, net,
                                   eval_patch=astate.patch.detach().cpu().numpy(),
                                   eval_scale=float(astate.scale.detach()),
                                   learning_rate=1e-2, n_filters=8,
                                   device=device)
    dstate = defender.init_state(seed + 2)
    for i in range(defend_steps):
        imgs, _, _ = synthetic_scene_batch(rng, batch, image_size)
        dstate, dm = defender.train_step(dstate, torch.from_numpy(imgs).to(device))
        if (i + 1) % 20 == 0:
            print(f"[defense] step {i+1}: loss={float(dm.loss):.4f}",
                  flush=True)
    imgs, _, _ = synthetic_scene_batch(rng, batch, image_size)
    ev = defender.eval_step(dstate, torch.from_numpy(imgs).to(device))
    print(f"[defense] eval recovery loss={float(ev.loss):.4f} "
          f"adv mean score={float(ev.mean_adv_score):.3f}")
    return first, last


def cli(argv=None):
    p = argparse.ArgumentParser(description="train a detector, attack it, "
                                "defend it (small scale)")
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--det-steps", type=int, default=300)
    p.add_argument("--attack-steps", type=int, default=150)
    p.add_argument("--defend-steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    return main(a.image_size, a.det_steps, a.attack_steps, a.defend_steps,
                a.batch, bf16=a.bf16, device=a.device)


if __name__ == "__main__":
    cli()
