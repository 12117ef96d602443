"""Synthetic moving-person clip: demo input from no assets.

Copy of `mladversarialobjectdetection_tpu/demo/synthetic_clip.py`. The
reference demos read real mp4 footage (demo.py:276-378,
demo_v2.py:192-247); the repo ships none, so this renders a deterministic
clip of person-shaped sprites (head, torso, split legs) walking over a
gradient background (`render_frames`, numpy), and `write_clip` writes it as
an mp4 through cv2.

CLI:  python -m mladversarialobjectdetection_torch.demo.synthetic_clip \
          out.mp4 --frames 72 --height 360 --width 640
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np


def _person_sprite(h: int, w: int, color: np.ndarray) -> np.ndarray:
    """uint8 RGBA-ish sprite: head + torso + legs on a transparent field."""
    spr = np.zeros((h, w, 4), np.float32)
    head_h = h // 5
    head_w = max(2, w // 2)
    x0 = (w - head_w) // 2
    spr[:head_h, x0:x0 + head_w, :3] = color * 0.7
    spr[:head_h, x0:x0 + head_w, 3] = 1.0
    torso_h = (h * 3) // 5
    spr[head_h:head_h + torso_h, :, :3] = color
    spr[head_h:head_h + torso_h, :, 3] = 1.0
    leg_w = max(1, w // 3)
    spr[head_h + torso_h:, :leg_w, :3] = color * 0.8
    spr[head_h + torso_h:, :leg_w, 3] = 1.0
    spr[head_h + torso_h:, w - leg_w:, :3] = color * 0.8
    spr[head_h + torso_h:, w - leg_w:, 3] = 1.0
    return spr


def render_frames(n_frames: int = 72, height: int = 360, width: int = 640,
                  n_persons: int = 2, seed: int = 0
                  ) -> Tuple[List[np.ndarray], List[List[tuple]]]:
    """Render RGB uint8 frames + per-frame ground-truth person boxes
    (ymin, xmin, ymax, xmax)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.25, 0.65, height, dtype=np.float32)[:, None, None]
    base = np.stack([np.full((height, width), 0.55, np.float32),
                     np.full((height, width), 0.62, np.float32),
                     np.full((height, width), 0.70, np.float32)], axis=-1)
    base = np.clip(base * (0.6 + yy), 0, 1)

    sprites = []
    for _ in range(n_persons):
        ph = int(rng.integers(height // 3, int(height * 0.6)))
        pw = int(ph * rng.uniform(0.3, 0.45))
        color = rng.uniform(0.05, 0.85, 3).astype(np.float32)
        x = rng.uniform(0, width - pw)
        y = rng.uniform(height * 0.25, height - ph)
        vx = rng.uniform(1.5, 4.0) * rng.choice([-1, 1])
        sprites.append(dict(h=ph, w=pw, color=color, x=x, y=y, vx=vx,
                            phase=rng.uniform(0, 2 * np.pi)))

    frames, gts = [], []
    for t in range(n_frames):
        img = base.copy()
        img += rng.normal(0, 0.015, img.shape).astype(np.float32)
        boxes = []
        for s in sprites:
            s["x"] += s["vx"]
            if s["x"] < 0 or s["x"] + s["w"] > width:
                s["vx"] = -s["vx"]
                s["x"] = float(np.clip(s["x"], 0, width - s["w"]))
            bob = 2.0 * np.sin(0.4 * t + s["phase"])  # walking bounce
            y0 = int(np.clip(s["y"] + bob, 0, height - s["h"]))
            x0 = int(s["x"])
            spr = _person_sprite(s["h"], s["w"], s["color"])
            a = spr[..., 3:4]
            img[y0:y0 + s["h"], x0:x0 + s["w"], :] = (
                (1 - a) * img[y0:y0 + s["h"], x0:x0 + s["w"], :]
                + a * spr[..., :3])
            boxes.append((y0, x0, y0 + s["h"], x0 + s["w"]))
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
        gts.append(boxes)
    return frames, gts


def write_clip(out_path: str, n_frames: int = 72, height: int = 360,
               width: int = 640, n_persons: int = 2, seed: int = 0,
               fps: int = 24) -> List[List[tuple]]:
    """Render + write an mp4; returns the ground-truth boxes per frame."""
    import cv2

    frames, gts = render_frames(n_frames, height, width, n_persons, seed)
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {out_path}")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return gts


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out")
    p.add_argument("--frames", type=int, default=72)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--persons", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    write_clip(args.out, args.frames, args.height, args.width, args.persons,
               args.seed)
    print(f"wrote {args.frames}-frame clip to {args.out}")


if __name__ == "__main__":
    main()
