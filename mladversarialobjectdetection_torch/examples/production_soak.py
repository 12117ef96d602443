"""Production-geometry soak: a lite4@640 victim, attacked and defended.

Port of `examples/production_soak.py:121-316`, the reference workflow at its
own operating point (efficientdet-lite4 at 640), on synthetic labelled
scenes (`data/pipeline.ScenePool`, 12 batches rendered once and kept on the
device):

1. `victim`: train the detector (`train/victim.build_victim`, bf16, SGD .08,
   no EMA) and save it as `<save-dir>/victim_ckpt.pkl`, or load
   `--victim-ckpt`;
2. `gate`: one batch through `PatchAttacker.first_pass`; fewer detections
   than images writes `"gate": "FAILED"` and stops;
3. `attack`: the attack driver's operating point (batch 24, bf16, 256 NMS
   candidates, window 320, score / iou .5), the ASR pass on logged steps
   only; the patch saved as `patch_{attack_steps}_{asr:.3f}`;
4. `defend`: the defender (bf16 U-Net, lr 1e-2) against the learned patch
   at the learned scale, evaluated on 2 pool batches every `log_every`
   steps; the best validation loss saves the U-Net's Flax variables as
   `patch_{step}_{val_loss:.4f}/antipatch.pkl` (`ckpt/io.save_pytree`,
   which the JAX package's `load_pytree` reads).

`soak.json` in the save directory holds the JAX script's keys (`config`,
`victim`, `attack_trajectory`, `attack_artifact`, `defense_trajectory`,
`defense_best`, `defense_artifact`), and `victim_training` when the victim
was trained here. The scenes and their order equal the JAX script's for a
seed (the same numpy generator); the victim, the patch and the U-Net are
drawn by the port's `init_state(seed)` from `seed`, `seed + 1` and
`seed + 2` where JAX draws from `PRNGKey` of the same numbers, so they are
not JAX's.

Usage:
    python -m mladversarialobjectdetection_torch.examples.production_soak \\
        --save-dir /tmp/soak
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import warnings

import numpy as np
import torch

from ..attack import artifacts
from ..attack.attacker import PatchAttacker
from ..attack.train import get_victim, get_victim_variables
from ..ckpt import bridge
from ..ckpt import io as ckpt_io
from ..data.pipeline import ScenePool
from ..defense.defender import PatchAttackDefender
from ..train.victim import build_victim, make_config
from ..utils.device import resolve_device

WINDOW = 320


def _nanmean(xs) -> float:
    """np.nanmean, NaN without a warning when every value is NaN."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(xs))


def write_json(path: str, record: dict) -> str:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def victim(cfg, pool, rng, save_dir: str, *, det_steps: int, batch: int,
           seed: int, victim_ckpt=None, device=None, record=None):
    """The frozen victim: `victim_ckpt` loaded, or `det_steps` trainer steps
    on the pool saved as `<save_dir>/victim_ckpt.pkl`. The trainer and its
    optimizer are freed before this returns."""
    device = resolve_device(device)
    if victim_ckpt:
        print(f"[victim] loading {victim_ckpt}", flush=True)
        return get_victim(cfg, variables=get_victim_variables(cfg, victim_ckpt),
                          device=device)
    path = os.path.join(save_dir, "victim_ckpt")
    net, log = build_victim(cfg, pool, rng, det_steps, path, batch=batch,
                            seed=seed, device=device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[victim] saved {path}", flush=True)
    if record is not None:
        record["victim_training"] = log
    return net


def gate(attacker: PatchAttacker, pool, rng, batch: int, record: dict) -> bool:
    """The detection gate: at least one detection an image on a pool batch.
    Writes the record's `victim` keys; returns whether the gate passed."""
    imgs, _, _, gt_valid = pool.sample(rng, batch)
    _, scores, valid = attacker.first_pass(imgs)
    valid = valid.cpu().numpy()
    scores = scores.float().cpu().numpy()
    n_det = int(valid.sum())
    mean_score = float((scores * valid).sum() / max(1, n_det))
    live_per_img = valid[:, :attacker.max_boxes].sum(1)
    print(f"[victim] gate: {n_det} detections on {batch} scenes "
          f"({int(gt_valid.sum())} ground-truth persons), mean score "
          f"{mean_score:.3f}, live slots/img mean {live_per_img.mean():.1f} "
          f"max {live_per_img.max()}", flush=True)
    record["victim"] = {"detections": n_det,
                        "gt_persons": int(gt_valid.sum()),
                        "mean_score": mean_score,
                        "live_slots_mean": float(live_per_img.mean()),
                        "live_slots_max": int(live_per_img.max())}
    if n_det < batch:  # fewer than one an image: the attack would be vacuous
        print("[victim] GATE FAILED: detector too weak, aborting soak",
              flush=True)
        record["gate"] = "FAILED"
        return False
    return True


def attack(attacker: PatchAttacker, pool, rng, save_dir: str, *,
           attack_steps: int, batch: int, seed: int, log_every: int,
           record: dict):
    """`attack_steps` attack steps on pool batches from `init_state(seed +
    1)`; logged steps (the first and every `log_every`-th) run the ASR pass.
    Saves `patch_{attack_steps}_{asr:.3f}`; returns the attack state."""
    astate = attacker.init_state(seed + 1)
    traj = []
    t0 = time.time()
    for i in range(attack_steps):
        imgs, _, _, _ = pool.sample(rng, batch)
        logged = (i + 1) % log_every == 0 or i == 0
        astate, m = attacker.train_step(astate, imgs, with_asr=logged)
        if logged:
            row = {"step": i + 1,
                   "mean_max_score": float(m.mean_max_score),
                   "asr": float(m.asr), "scale": float(m.scale),
                   "loss": float(m.loss),
                   "img_per_sec": (i + 1) * batch / (time.time() - t0)}
            traj.append(row)
            print(f"[attack] step {row['step']}: "
                  f"mean_max_score={row['mean_max_score']:.3f} "
                  f"asr={row['asr']:.3f} scale={row['scale']:.3f} "
                  f"({row['img_per_sec']:.1f} img/s)", flush=True)
    record["attack_trajectory"] = traj
    patch_dir = os.path.join(
        save_dir, f"patch_{attack_steps}_{traj[-1]['asr']:.3f}")
    artifacts.save_patch_dir(patch_dir, astate.patch.detach().cpu().numpy(),
                             float(astate.scale.detach()))
    record["attack_artifact"] = patch_dir
    print(f"[attack] artifact: {patch_dir}", flush=True)
    return astate


def defend(cfg, victim_net, patch: np.ndarray, scale: float, pool, rng,
           save_dir: str, *, defend_steps: int, batch: int, seed: int,
           log_every: int, record: dict, device=None):
    """The defender against (patch, scale): `defend_steps` train steps from
    `init_state(seed + 2)`, every `log_every` steps an eval on 2 pool
    batches (batch_idx 0, 1); the best val_loss saves
    `patch_{step}_{val_loss:.4f}/antipatch.pkl`. Returns the defender state."""
    defender = PatchAttackDefender(cfg, victim_net, eval_patch=patch,
                                   eval_scale=scale, learning_rate=1e-2,
                                   device=device)
    dstate = defender.init_state(seed + 2)
    dtraj = []
    best = None  # the reference's ModelCheckpoint monitors val_loss
    t0 = time.time()
    for i in range(defend_steps):
        imgs, _, _, _ = pool.sample(rng, batch)
        dstate, dm = defender.train_step(dstate, imgs)
        if (i + 1) % log_every == 0:
            evs = [defender.eval_step(dstate, pool.sample(rng, batch)[0], vi)
                   for vi in range(2)]
            row = {"step": i + 1,
                   "train_loss": float(dm.loss),
                   "val_loss": float(np.mean([float(e.loss) for e in evs])),
                   "recovery_psnr": _nanmean(
                       [float(e.recovery_psnr) for e in evs]),
                   "adr": _nanmean([float(e.adr) for e in evs]),
                   "mean_adv_score": float(np.mean(
                       [float(e.mean_adv_score) for e in evs])),
                   "img_per_sec": (i + 1) * batch / (time.time() - t0)}
            dtraj.append(row)
            print(f"[defense] step {row['step']}: "
                  f"val_loss={row['val_loss']:.4f} "
                  f"psnr={row['recovery_psnr']:.1f}dB adr={row['adr']:.2f} "
                  f"({row['img_per_sec']:.1f} img/s)", flush=True)
            if best is None or row["val_loss"] < best["val_loss"]:
                best = dict(row)
                dd = os.path.join(
                    save_dir, f"patch_{row['step']}_{row['val_loss']:.4f}",
                    "antipatch")
                ckpt_io.save_pytree(dd, bridge.torch_to_flax(dstate.unet))
                best["artifact"] = dd
                print(f"[defense] new best val_loss -> {dd}", flush=True)
    record["defense_trajectory"] = dtraj
    record["defense_best"] = best
    record["defense_artifact"] = best["artifact"]
    print(f"[defense] best: step {best['step']} val_loss "
          f"{best['val_loss']:.4f} psnr {best['recovery_psnr']:.1f}dB "
          f"adr {best['adr']:.2f} -> {best['artifact']}", flush=True)
    return dstate


def soak(cfg, pool, rng, save_dir: str, *, det_steps=800, attack_steps=1000,
         defend_steps=400, batch=24, seed=0, log_every=50, victim_ckpt=None,
         device=None) -> dict:
    """The four stages in order on `pool`; returns the record written to
    `<save_dir>/soak.json`."""
    if attack_steps < 1 or defend_steps < 1:
        raise ValueError("attack_steps and defend_steps must be >= 1")
    # the record indexes the last logged rows: log at least once
    log_every = max(1, min(log_every, attack_steps, defend_steps))
    device = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    record = {"config": {"model": cfg.name, "image_size": cfg.image_size,
                         "batch": batch, "window": WINDOW,
                         "bf16": bool(cfg.mixed_precision),
                         "pre_nms_topk": cfg.nms_configs.pre_nms_topk,
                         "det_steps": det_steps, "attack_steps": attack_steps,
                         "defend_steps": defend_steps}}
    net = victim(cfg, pool, rng, save_dir, det_steps=det_steps, batch=batch,
                 seed=seed, victim_ckpt=victim_ckpt, device=device,
                 record=record)
    attacker = PatchAttacker(cfg, net, window=WINDOW, device=device)
    path = os.path.join(save_dir, "soak.json")
    if not gate(attacker, pool, rng, batch, record):
        write_json(path, record)
        return record
    astate = attack(attacker, pool, rng, save_dir, attack_steps=attack_steps,
                    batch=batch, seed=seed, log_every=log_every, record=record)
    patch = astate.patch.detach().cpu().numpy()
    scale = float(astate.scale.detach())
    del astate, attacker
    defend(cfg, net, patch, scale, pool, rng, save_dir,
           defend_steps=defend_steps, batch=batch, seed=seed,
           log_every=log_every, record=record, device=device)
    write_json(path, record)
    print(f"[soak] record: {path}", flush=True)
    return record


def main(save_dir: str, det_steps=800, attack_steps=1000, defend_steps=400,
         batch=24, seed=0, log_every=50, victim_ckpt=None, device=None) -> dict:
    """The JAX script's `main`: lite4@640 (`train/victim.make_config`) on a
    pool of 12 batches of 640 px scenes."""
    device = resolve_device(device)
    cfg = make_config()
    rng = np.random.default_rng(seed)
    print("[soak] building scene pool...", flush=True)
    pool = ScenePool(rng, n_batches=12, batch=batch, hw=640, device=device)
    print(f"[soak] pool ready: {pool.n} scenes", flush=True)
    return soak(cfg, pool, rng, save_dir, det_steps=det_steps,
                attack_steps=attack_steps, defend_steps=defend_steps,
                batch=batch, seed=seed, log_every=log_every,
                victim_ckpt=victim_ckpt, device=device)


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description="production-geometry soak: "
                                "victim, gate, attack, defender")
    p.add_argument("--save-dir", default="/tmp/soak")
    p.add_argument("--det-steps", type=int, default=800)
    p.add_argument("--attack-steps", type=int, default=1000)
    p.add_argument("--defend-steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--victim-ckpt", default=None,
                   help="reuse a saved victim instead of retraining")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    return main(a.save_dir, a.det_steps, a.attack_steps, a.defend_steps,
                a.batch, victim_ckpt=a.victim_ckpt, device=a.device)


if __name__ == "__main__":
    cli()
