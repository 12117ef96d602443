"""North-star soak: the reference-shaped epoch attack run, or the frontier.

Port of `examples/northstar_soak.py:93-278`. The reference's headline
artifact, `patch_434_2.1692`, came from 500 epochs with
ReduceLROnPlateau(.5, patience 50, min 1e-4) on the validation loss and a
per-epoch ModelCheckpoint (attacker_train.py:54-72). This runs the attack
driver's operating point (lite4@640, batch 24, bf16, 256 NMS candidates,
window 320; `train/victim.make_config`) in that shape:

- the victim: trained on the scene pool (`train/victim.build_victim`, saved
  as `<save-dir>/victim_ckpt.pkl`) or `--victim-ckpt`; the trainer is freed
  before anything else goes onto the card;
- a fixed validation pool from another generator (`seed + 777`,
  `--val-batches` batches), put on the card only after the victim stage;
- epochs of `--steps-per-epoch` steps, the ASR pass on the last step of
  each; after each, `eval_step` on every val batch and `--eot-draws`
  draws (`batch_idx = i * 7 + d`), the plateau controller on the val loss
  (the lr printed is the optimizer's after the update), and the best
  `val_asr_to_scale = val_asr / (scale + 1e-7)` saved as
  `patch_{epoch}_{val_asr_to_scale:.4f}`;
- `northstar.json` flushed every epoch; `stopped` set at the `--max-hours`
  wall-clock cap.

A soak restarts as the JAX script's does, with `--initial-patch <best
artifact>` and `--initial-lr <the annealed lr>`: patch and scale only.

`--frontier "0.3,0.45,0.6"` runs the ASR-vs-scale frontier instead: per
scale a fresh patch (`init_state(seed + 11, initial_scale=scale)`) trains
`--frontier-steps` steps with `freeze_scale=True` at window 448, logged
every 100 steps, and its converged val ASR is the mean over the val
batches x 4 EOT draws (`frontier.json`).

The scenes and their order equal the JAX script's for a seed (the same
numpy generators); the patches are drawn by the port's `init_state(seed)`
from `seed + 1` and `seed + 11` where JAX draws from `PRNGKey` of the same
numbers, so they are not JAX's.

Usage:
    python -m mladversarialobjectdetection_torch.examples.northstar_soak \\
        --save-dir /tmp/northstar --max-hours 0.5
    python -m mladversarialobjectdetection_torch.examples.northstar_soak \\
        --save-dir /tmp/northstar --victim-ckpt /tmp/northstar/victim_ckpt \\
        --frontier 0.3,0.45,0.6
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..attack import artifacts
from ..attack.attacker import PatchAttacker
from ..data.pipeline import ScenePool, synthetic_person_batch
from ..train.victim import make_config
from ..utils.device import resolve_device
from ..utils.train_loop import ReduceLROnPlateau
from .production_soak import victim, write_json

PLATEAU = {"factor": 0.5, "patience": 50, "min_lr": 1e-4}
FRONTIER_WINDOW = 448  # un-clamped up to scale * box <= 448 / sqrt(2) px
FRONTIER_DRAWS = 4


def val_pool(seed: int, val_batches: int, batch: int, device, hw: int = 640):
    """The fixed held-out scenes: `val_batches` batches from `seed + 777`,
    on the device."""
    rng_val = np.random.default_rng(seed + 777)
    return [torch.from_numpy(synthetic_person_batch(rng_val, batch, hw)[0])
            .to(device) for _ in range(val_batches)]


def frontier(cfg, victim_net, pool, rng, val_imgs, scales, *, steps: int,
             batch: int, seed: int, record: dict, out_json: str,
             device=None) -> dict:
    """Per pinned scale, a fresh frozen-scale patch trained `steps` steps;
    the record's `frontier` rows (scale, val ASR over the val batches x 4
    draws, val mean max score, val_asr_to_scale, the trajectory)."""
    record["frontier"] = []
    for sc in scales:
        attacker = PatchAttacker(cfg, victim_net, window=FRONTIER_WINDOW,
                                 freeze_scale=True, device=device)
        st = attacker.init_state(seed + 11, initial_scale=sc)
        t0 = time.time()
        rows = []
        for i in range(steps):
            imgs, _, _, _ = pool.sample(rng, batch)
            logged = (i + 1) % 100 == 0
            st, m = attacker.train_step(st, imgs, with_asr=logged)
            if logged:
                rows.append({"step": i + 1, "asr": float(m.asr),
                             "mean_max_score": float(m.mean_max_score)})
                print(f"[frontier s={sc}] step {i+1}: "
                      f"asr={rows[-1]['asr']:.3f} "
                      f"ms={rows[-1]['mean_max_score']:.3f} "
                      f"({(i+1)*batch/(time.time()-t0):.1f} img/s)",
                      flush=True)
        evs = [attacker.eval_step(st, val_imgs[i], batch_idx=i * 7 + d)
               for i in range(len(val_imgs)) for d in range(FRONTIER_DRAWS)]
        val_asr = float(np.mean([float(e.asr) for e in evs]))
        val_ms = float(np.mean([float(e.mean_max_score) for e in evs]))
        record["frontier"].append({
            "scale": sc, "val_asr": val_asr, "val_mean_max_score": val_ms,
            "val_asr_to_scale": val_asr / sc, "trajectory": rows})
        print(f"[frontier] scale {sc}: val_asr={val_asr:.3f} "
              f"asr/scale={val_asr/sc:.3f}", flush=True)
        write_json(out_json, record)
        del attacker, st
    print(f"[frontier] record: {out_json}", flush=True)
    return record


def epoch_soak(cfg, victim_net, pool, rng, val_imgs, save_dir: str, *,
               epochs: int, steps_per_epoch: int, batch: int, seed: int,
               window: int, eot_draws: int, max_hours: float,
               initial_patch=None, initial_lr: float = 1e-2, record: dict,
               out_json: str, device=None):
    """The epoch loop; fills the record's `attack_trajectory`, `best` and
    (at the cap) `stopped`, flushing `out_json` every epoch. Returns the
    attack state."""
    attacker = PatchAttacker(cfg, victim_net, window=window,
                             learning_rate=initial_lr, device=device)
    if initial_patch:
        patch_np, scale0 = artifacts.load_patch_dir(
            initial_patch, cfg.mean_rgb, cfg.stddev_rgb)
        astate = attacker.init_state(seed + 1, initial_patch=patch_np,
                                     initial_scale=scale0)
    else:
        astate = attacker.init_state(seed + 1)
    plateau = ReduceLROnPlateau(**PLATEAU)
    traj = []
    best = None
    t0 = time.time()
    deadline = t0 + max_hours * 3600.0
    for epoch in range(1, epochs + 1):
        tm = None
        for s in range(steps_per_epoch):
            imgs, _, _, _ = pool.sample(rng, batch)
            astate, tm = attacker.train_step(
                astate, imgs, with_asr=s == steps_per_epoch - 1)
        evs = [attacker.eval_step(astate, val_imgs[i], batch_idx=i * 7 + d)
               for i in range(len(val_imgs)) for d in range(eot_draws)]
        val_loss = float(np.mean([float(e.loss) for e in evs]))
        val_asr = float(np.mean([float(e.asr) for e in evs]))
        scale = float(astate.scale.detach())
        val_s2s = val_asr / (scale + 1e-7)
        plateau.update(val_loss, astate.optimizer)
        lr = float(astate.optimizer.param_groups[0]["lr"])
        row = {"epoch": epoch, "step": epoch * steps_per_epoch,
               "val_loss": val_loss, "val_asr": val_asr, "scale": scale,
               "val_asr_to_scale": val_s2s, "lr": lr,
               "train_asr": float(tm.asr),
               "train_mean_max_score": float(tm.mean_max_score),
               "train_loss": float(tm.loss),
               "img_per_sec": epoch * steps_per_epoch * batch /
                              (time.time() - t0)}
        traj.append(row)
        print(f"[attack] epoch {epoch}: val_loss={val_loss:.3f} "
              f"val_asr={val_asr:.3f} scale={scale:.3f} "
              f"asr/scale={val_s2s:.3f} lr={lr:.2e} "
              f"({row['img_per_sec']:.1f} img/s)", flush=True)
        if best is None or val_s2s > best["val_asr_to_scale"]:
            best = dict(row)
            pd = os.path.join(save_dir, f"patch_{epoch}_{val_s2s:.4f}")
            artifacts.save_patch_dir(pd, astate.patch.detach().cpu().numpy(),
                                     scale)
            best["artifact"] = pd
            print(f"[attack] new best asr/scale -> {pd}", flush=True)
        record["attack_trajectory"] = traj
        record["best"] = best
        write_json(out_json, record)
        if time.time() > deadline:
            record["stopped"] = f"wall-clock cap {max_hours}h at epoch {epoch}"
            print(f"[attack] {record['stopped']}", flush=True)
            break
    write_json(out_json, record)
    print(f"[soak] best: {json.dumps(best)}", flush=True)
    print(f"[soak] record: {out_json}", flush=True)
    return astate


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="north-star epoch soak, or the "
                                "ASR-vs-scale frontier")
    p.add_argument("--save-dir", default="/tmp/northstar")
    p.add_argument("--det-steps", type=int, default=800)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--victim-ckpt", default=None)
    p.add_argument("--max-hours", type=float, default=3.0,
                   help="wall-clock cap on the attack stage")
    p.add_argument("--val-batches", type=int, default=4)
    p.add_argument("--eot-draws", type=int, default=2,
                   help="EOT draws per val batch per epoch")
    p.add_argument("--window", type=int, default=320)
    p.add_argument("--frontier", default="",
                   help="comma-separated pinned scales: run the "
                        "ASR-vs-scale frontier instead of the epoch soak")
    p.add_argument("--frontier-steps", type=int, default=1500)
    p.add_argument("--initial-patch", default=None,
                   help="patch dir to warm-start from")
    p.add_argument("--initial-lr", type=float, default=1e-2,
                   help="restart a soak at the lr the plateau controller "
                        "had annealed to")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def config_record(cfg, a) -> dict:
    """The record's `config`: the model and the parsed arguments `a`."""
    return {"model": cfg.name, "image_size": cfg.image_size,
            "batch": a.batch, "window": a.window,
            "bf16": bool(cfg.mixed_precision),
            "pre_nms_topk": cfg.nms_configs.pre_nms_topk, "epochs": a.epochs,
            "steps_per_epoch": a.steps_per_epoch,
            "val_batches": a.val_batches, "eot_draws": a.eot_draws,
            "plateau": dict(PLATEAU)}


def main(argv=None) -> dict:
    """The victim, the val pool, then the epoch soak or the frontier;
    returns the record."""
    a = parse_args(argv)
    device = resolve_device(a.device)
    cfg = make_config()
    rng = np.random.default_rng(a.seed)
    os.makedirs(a.save_dir, exist_ok=True)
    print("[soak] building train scene pool...", flush=True)
    pool = ScenePool(rng, n_batches=12, batch=a.batch, hw=640, device=device)
    print(f"[soak] train pool ready: {pool.n} scenes", flush=True)
    net = victim(cfg, pool, rng, a.save_dir, det_steps=a.det_steps,
                 batch=a.batch, seed=a.seed, victim_ckpt=a.victim_ckpt,
                 device=device)
    # after the victim stage: the trainer is the memory peak
    val_imgs = val_pool(a.seed, a.val_batches, a.batch, device)
    print(f"[soak] fixed val pool ready: {a.val_batches * a.batch} scenes",
          flush=True)
    record = {"config": config_record(cfg, a)}
    out_json = os.path.join(
        a.save_dir, "frontier.json" if a.frontier else "northstar.json")
    if a.frontier:
        scales = [float(s) for s in a.frontier.split(",") if s.strip()]
        return frontier(cfg, net, pool, rng, val_imgs, scales,
                        steps=a.frontier_steps, batch=a.batch, seed=a.seed,
                        record=record, out_json=out_json, device=device)
    epoch_soak(cfg, net, pool, rng, val_imgs, a.save_dir, epochs=a.epochs,
               steps_per_epoch=a.steps_per_epoch, batch=a.batch, seed=a.seed,
               window=a.window, eot_draws=a.eot_draws, max_hours=a.max_hours,
               initial_patch=a.initial_patch, initial_lr=a.initial_lr,
               record=record, out_json=out_json, device=device)
    return record


if __name__ == "__main__":
    main()
