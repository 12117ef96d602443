"""The frontier at one pinned scale in float32 and in bf16, on one victim.

Trains the north-star victim (`production_soak.victim`: 800 steps on the
scene pool, saved as `<save-dir>/victim_ckpt.pkl`), reports its held-out
confidence under the keys of the JAX package's `tools/victim_confidence.py`
record (the bf16 attacker's first pass over the soak's fixed val stream),
then runs `northstar_soak.frontier` at one scale twice, from the same patch
and the same pool draws: once with `mixed_precision` on (the default of
`attack.train.train`) and once off. Both arms load the victim from the same
file. For each arm it also counts, on the val scenes at the initial patch,
the anchors that tie at each image's masked max score (the score the loss
takes the max of): a count above 1 splits the max's gradient among them.

Usage:
    python -m mladversarialobjectdetection_torch.examples.precision_frontier \\
        --save-dir /tmp/prec --scale 0.6 --steps 400

The record goes to `<save-dir>/precision_frontier.json` and, as one JSON
object, to the last line of standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

from ..attack.attacker import PatchAttacker
from ..attack.train import get_victim, get_victim_variables
from ..data.pipeline import ScenePool
from ..train.victim import make_config
from ..utils.device import resolve_device
from .northstar_soak import FRONTIER_WINDOW, frontier, parse_args, val_pool
from .production_soak import victim, write_json


def _quantiles(x: np.ndarray) -> dict:
    return {"mean": float(x.mean()), "p10": float(np.percentile(x, 10)),
            "p50": float(np.percentile(x, 50)),
            "p90": float(np.percentile(x, 90))}


def victim_confidence(attacker: PatchAttacker, val_imgs) -> dict:
    """The clean detections' scores on the val scenes, as
    `tools/victim_confidence.py` reports them."""
    per_img_max, all_scores = [], []
    for imgs in val_imgs:
        _, scores, valid = attacker.first_pass(imgs)
        s, v = scores.float().cpu().numpy(), valid.cpu().numpy()
        for i in range(s.shape[0]):
            si = s[i][v[i]]
            all_scores.extend(si.tolist())
            per_img_max.append(float(si.max()) if si.size else 0.0)
    pm, al = np.asarray(per_img_max), np.asarray(all_scores)
    return {"n_images": int(pm.size), "n_detections": int(al.size),
            "per_image_max": _quantiles(pm),
            "all_detections": _quantiles(al) if al.size else None}


@torch.no_grad()
def max_ties(attacker: PatchAttacker, state, val_imgs) -> dict:
    """Per val image, the anchors whose masked score equals the image's
    max in the patched pass at `state` (eval draws of batch i)."""
    counts = []
    for i, imgs in enumerate(val_imgs):
        boxes, _, clean_valid = attacker.first_pass(imgs)
        boxes, valid = attacker._boxes(boxes, clean_valid, None)
        _, aux = attacker._loss_from_images(
            state.patch, state.scale, imgs, boxes, valid,
            attacker._eval_generator(state, i * 7))
        m = aux["adv_masked"]
        counts.append((m == m.amax(dim=1, keepdim=True)).sum(1).cpu().numpy())
    c = np.concatenate(counts)
    return {"images": int(c.size), "mean": float(c.mean()),
            "max": int(c.max()), "share_tied": float((c > 1).mean())}


def run(cfg, pool, val_imgs, victim_variables, *, scale: float, steps: int,
        batch: int, seed: int, save_dir: str, device=None) -> dict:
    """The two arms on `victim_variables`; returns {"bf16": ..., "fp32": ...},
    each with its frontier row, seconds and tie counts."""
    out = {}
    for name, mp in (("bf16", True), ("fp32", False)):
        arm_cfg = type(cfg)(cfg.as_dict())
        arm_cfg.mixed_precision = mp
        net = get_victim(arm_cfg, variables=victim_variables, device=device)
        probe = PatchAttacker(arm_cfg, net, window=FRONTIER_WINDOW,
                              freeze_scale=True, device=device)
        ties = max_ties(probe, probe.init_state(seed + 11, initial_scale=scale),
                        val_imgs)
        del probe
        record = {"config": {"mixed_precision": mp, "scale": scale,
                             "steps": steps, "batch": batch,
                             "window": FRONTIER_WINDOW}}
        t0 = time.perf_counter()
        frontier(arm_cfg, net, pool, np.random.default_rng(seed + 1000),
                 val_imgs, [scale], steps=steps, batch=batch, seed=seed,
                 record=record, out_json=os.path.join(save_dir, f"frontier_{name}.json"),
                 device=device)
        row = record["frontier"][0]
        row.update(seconds=time.perf_counter() - t0, max_ties=ties)
        out[name] = row
        del net
        gc.collect()
        if resolve_device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    """The north-star soak's victim (800 steps, batch 24, seed 0, 4 val
    batches: its defaults), then both arms; returns the record."""
    p = argparse.ArgumentParser(description="the frontier at one scale in "
                                "float32 and bf16 on one victim")
    p.add_argument("--save-dir", default="/tmp/precision_frontier")
    p.add_argument("--victim-ckpt", default=None,
                   help="a saved victim instead of training one")
    p.add_argument("--scale", type=float, default=0.6)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    ns = parse_args([])
    device = resolve_device(a.device)
    os.makedirs(a.save_dir, exist_ok=True)
    cfg = make_config()
    rng = np.random.default_rng(ns.seed)
    pool = ScenePool(rng, n_batches=12, batch=ns.batch, hw=640, device=device)
    record = {}
    t0 = time.perf_counter()
    net = victim(cfg, pool, rng, a.save_dir, det_steps=ns.det_steps,
                 batch=ns.batch, seed=ns.seed, victim_ckpt=a.victim_ckpt,
                 device=device, record=record)
    record["victim_s"] = time.perf_counter() - t0
    val_imgs = val_pool(ns.seed, ns.val_batches, ns.batch, device)
    record["victim_confidence"] = victim_confidence(
        PatchAttacker(cfg, net, window=320, device=device), val_imgs)
    del net
    gc.collect()
    ckpt = a.victim_ckpt or os.path.join(a.save_dir, "victim_ckpt")
    record["arms"] = run(cfg, pool, val_imgs, get_victim_variables(cfg, ckpt),
                         scale=a.scale, steps=a.steps, batch=ns.batch,
                         seed=ns.seed, save_dir=a.save_dir, device=device)
    write_json(os.path.join(a.save_dir, "precision_frontier.json"), record)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
