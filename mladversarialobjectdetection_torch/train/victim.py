"""Train the synthetic-scene victim on the card, save it, and attack it.

Port of `examples/northstar_soak.py:52-96` (`build_victim`, `make_config`):
efficientdet-lite4 at 640 trained with `DetectorTrainer` at the attack
driver's operating point (bf16, SGD at lr .08 from a warmup of .004, no
EMA) on labelled scenes (`data/pipeline.ScenePool`, 12 batches as the
example renders), saved with `ckpt/io.save_pytree` as the Flax variables of
`trainer.eval_variables(state, use_ema=False)`. Then it reports what a
trained victim is for:

- the max person score of each held-out scene (4 batches from another
  seed, as the example's validation pool), before and after training;
- the COCO metrics of the trained victim on those scenes and their person
  boxes (`train.evaluate_map`: the frozen net with the fused MBConv
  kernels, per-class NMS, score .05);
- the attack driver (`attack.train.train` with `victim_ckpt`, its defaults:
  bf16, batch 12) for a few epochs of 50 steps: val loss, ASR and
  asr_to_scale per epoch, read from its metrics log.

Usage:
    python -m mladversarialobjectdetection_torch.train.victim \\
        --save-dir /tmp/victim --steps 800 --attack-epochs 3

(`--attack-epochs 0` skips the attack.)

It prints one JSON object with the numbers as its last line, and writes it
to `<save-dir>/victim.json`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import config as config_lib
from ..ckpt import bridge
from ..ckpt import io as ckpt_io
from ..data.pipeline import ScenePool, synthetic_person_batch
from ..utils.device import resolve_device
from ..utils.log import get_logger
from .train import evaluate_map
from .trainer import DetectorTrainer, TrainState

logger = get_logger(__name__)


def make_config(mixed_precision: bool = True):
    """examples/northstar_soak.py:make_config: lite4@640, the attack driver's
    NMS (iou .5, score .5, 256 candidates), SGD at lr .08 from a warmup of
    .004, no EMA."""
    cfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    cfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5,
                            "pre_nms_topk": 256})
    cfg.mixed_precision = mixed_precision
    cfg.learning_rate = 0.08
    cfg.lr_warmup_init = 0.004
    cfg.optimizer = "sgd"
    cfg.moving_average_decay = 0.0
    return cfg


@torch.no_grad()
def max_person_scores(net, images: torch.Tensor, num_classes: int) -> np.ndarray:
    """The highest class-0 (person) score over every anchor, per image."""
    cls_out, _ = net(images)
    b = images.shape[0]
    logits = torch.cat([c.reshape(b, -1, num_classes)[..., 0] for c in cls_out], 1)
    return torch.sigmoid(logits.amax(dim=1)).cpu().numpy()


def build_victim(cfg, pool: ScenePool, rng: np.random.Generator, steps: int,
                 path: str, *, batch: int = 24, seed: int = 0, device=None,
                 log_every: int = 100):
    """Train `steps` steps on scenes from `pool` and save the victim's Flax
    variables to `<path>.pkl`; returns (the frozen net, the losses logged)."""
    trainer = DetectorTrainer(cfg, steps_per_epoch=steps, device=device)
    state = trainer.init_state(seed=seed)
    t0 = time.perf_counter()
    log = []
    for i in range(steps):
        state, metrics = trainer.train_step(state, *pool.sample(rng, batch))
        if (i + 1) % log_every == 0 or i + 1 == steps:
            loss = float(metrics["loss"])
            log.append({"step": i + 1, "loss": loss,
                        "images_per_s": (i + 1) * batch / (time.perf_counter() - t0)})
            logger.info(f"[victim] step {i + 1}: loss={loss:.3f} "
                        f"({log[-1]['images_per_s']:.1f} img/s)")
    net = trainer.eval_variables(state, use_ema=False)
    ckpt_io.save_pytree(path, bridge.torch_to_flax(net))
    return net, log


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="train and attack the "
                                "synthetic-scene victim")
    p.add_argument("--save-dir", default="victim_run")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pool-batches", type=int, default=12)
    p.add_argument("--val-batches", type=int, default=4)
    p.add_argument("--attack-epochs", type=int, default=3)
    p.add_argument("--attack-steps", type=int, default=50)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    os.makedirs(a.save_dir, exist_ok=True)
    cfg = make_config()
    rng = np.random.default_rng(a.seed)
    pool = ScenePool(rng, n_batches=a.pool_batches, batch=a.batch, device=device)
    rng_val = np.random.default_rng(a.seed + 777)
    val = [synthetic_person_batch(rng_val, a.batch) for _ in range(a.val_batches)]

    def val_scores(net):
        return np.concatenate([max_person_scores(
            net, torch.from_numpy(v[0]).to(device), cfg.num_classes) for v in val])

    path = os.path.join(a.save_dir, "victim")
    t0 = time.perf_counter()
    init = DetectorTrainer(cfg, device=device).init_state(seed=a.seed).net.eval()
    before = val_scores(init)
    del init
    net, log = build_victim(cfg, pool, rng, a.steps, path, batch=a.batch,
                            seed=a.seed, device=device)
    train_s = time.perf_counter() - t0
    after = val_scores(net)
    t0 = time.perf_counter()
    coco = evaluate_map(DetectorTrainer(cfg, device=device), TrainState(net, None, None, 0),
                        iter({"images": torch.from_numpy(v[0]).to(device), "boxes": v[1],
                              "classes": v[2], "valid": v[3]} for v in val), len(val))
    eval_s = time.perf_counter() - t0
    del net, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()

    epochs, attack_s = [], 0.0
    if a.attack_epochs:
        from ..attack.train import train as attack_train
        attack_dir = os.path.join(a.save_dir, "attack")
        t0 = time.perf_counter()
        attack_train("efficientdet-lite4", synthetic=True, victim_ckpt=path,
                     epochs=a.attack_epochs, steps_per_epoch=a.attack_steps,
                     save_dir=attack_dir, device=device)
        attack_s = time.perf_counter() - t0
        with open(os.path.join(attack_dir, "logs", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        epochs = [{k[len("val/"):]: r[k] for k in r if k.startswith("val/")}
                  for r in recs if "val/loss" in r]
    summary = {
        "steps": a.steps, "batch": a.batch, "train_s": train_s,
        "train_log": log,
        "val_max_person_score": {
            "before": {"mean": float(before.mean()), "min": float(before.min())},
            "after": {"mean": float(after.mean()), "min": float(after.min()),
                      "share_at_or_above_0.5": float((after >= 0.5).mean())}},
        "val_coco": coco, "val_coco_seconds": eval_s,
        "attack": {"epochs": a.attack_epochs, "steps_per_epoch": a.attack_steps,
                   "seconds": attack_s, "val": epochs}}
    with open(os.path.join(a.save_dir, "victim.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
