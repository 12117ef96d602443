"""Attack checkpoint artifacts: patch + scale save/load.

A copy of `mladversarialobjectdetection_tpu/attack/artifacts.py` (format
parity with reference attacker.py:328-341 `save_weights`): a directory per
epoch named `patch_{epoch}_{val_asr_to_scale:.4f}` containing
  - scale.txt   : python literal of the scale scalar
  - patch.png   : denormalized uint8 preview
  - patch.npy   : raw float32 patch in [-1, 1] (a reference patch.tiff is
                  also read, where tifffile or PIL can)
"""
from __future__ import annotations

import ast
import os

import numpy as np


def save_patch_dir(dirpath: str, patch: np.ndarray, scale: float,
                   mean_rgb=127.0, stddev_rgb=128.0) -> None:
    os.makedirs(dirpath, exist_ok=True)
    patch = np.asarray(patch, np.float32)
    with open(os.path.join(dirpath, "scale.txt"), "w") as f:
        f.write(str(float(scale)))
    np.save(os.path.join(dirpath, "patch.npy"), patch)
    preview = np.clip(patch * np.asarray(stddev_rgb) + np.asarray(mean_rgb),
                      0.0, 255.0).astype(np.uint8)
    try:
        from PIL import Image
        Image.fromarray(preview).save(os.path.join(dirpath, "patch.png"))
    except ImportError:
        pass


def load_patch_dir(dirpath: str, mean_rgb=127.0, stddev_rgb=128.0):
    """Load (patch float32 normalized, scale float) from an artifact dir.

    mean_rgb/stddev_rgb are only used by the lossy patch.png fallback and
    must match the values the artifact was saved with."""
    with open(os.path.join(dirpath, "scale.txt")) as f:
        scale = float(ast.literal_eval(f.read()))
    npy = os.path.join(dirpath, "patch.npy")
    if os.path.exists(npy):
        return np.load(npy).astype(np.float32), scale
    tiff = os.path.join(dirpath, "patch.tiff")
    if os.path.exists(tiff):
        try:
            import tifffile
            return tifffile.imread(tiff).astype(np.float32), scale
        except ImportError:
            from PIL import Image
            return np.asarray(Image.open(tiff), np.float32), scale
    png = os.path.join(dirpath, "patch.png")
    if os.path.exists(png):
        from PIL import Image
        arr = np.asarray(Image.open(png).convert("RGB"), np.float32)
        return ((arr - np.asarray(mean_rgb, np.float32))
                / np.asarray(stddev_rgb, np.float32)), scale
    raise FileNotFoundError(f"no patch artifact in {dirpath}")
