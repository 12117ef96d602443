"""Streaming attack and defence demo writing three videos.

Port of `mladversarialobjectdetection_tpu/demo/demo_v2.py` (reference
demo_v2.py:31-257). Per frame:
  1. the clean pass through the detector (mean person score overlay);
  2. the adversarial pass: `AdversarialPatch` plants the patch on the
     detected persons on the host, and the detector runs again;
  3. the recovery pass: the U-Net defender neutralizes the patch and the
     detector runs again; a red "ATTACK DETECTED" appears when the score
     recovers by more than 10 points (demo_v2.py:116-148).

The detector and the U-Net run on `device` (the card by default; NMS and
the U-Net's small convs are the port's CUDA kernels): `RecoveryDemo.recover`
is the U-Net's device part on normalized frames. Reading, drawing and
writing frames (cv2) stay on the host. Outputs clean.mp4 / adv.mp4 /
det.mp4 in save_dir.

Usage:
    python -m mladversarialobjectdetection_torch.demo.demo_v2 \\
        --save-dir /tmp/demo --input clip.mp4 [--defender-weights <dir>/antipatch]
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..attack import artifacts
from ..inference.adv_patch import AdversarialPatch
from ..inference.detector import Detector
from ..inference.streaming import Stream
from ..utils.log import get_logger
from . import draw

logger = get_logger(__name__)

SCORE_THRESH = 0.55
RECOVERY_FLASH_PTS = 10.0  # score points of recovery that flag an attack


class Demo:
    """Clean detection view (demo_v2.py:31-70)."""

    def __init__(self, detector: Detector):
        self.detector = detector

    def run(self, frame: np.ndarray):
        bb, sc = self.detector.infer(frame)
        bb, sc = draw.filter_by_thresh(bb, sc, SCORE_THRESH)
        mean_score = float(np.mean(sc)) if sc else 0.0
        out = draw.draw_boxes(frame.copy(), bb, sc)
        out = draw.put_text(out, f"mean score: {mean_score * 100:.1f}",
                            (10, 30))
        return out, bb, sc, mean_score


class AttackDemo(Demo):
    """Adversarial patch view (demo_v2.py:73-96)."""

    def __init__(self, patch: AdversarialPatch, detector: Detector):
        super().__init__(detector)
        self.patch = patch

    def run(self, frame: np.ndarray, bboxes):
        attacked = self.patch.add_adv_to_img(frame, bboxes)
        out, bb, sc, mean_score = super().run(attacked)
        out = draw.put_text(out, "adversarial", (10, 60), color=(255, 80, 80))
        return out, attacked, mean_score


class RecoveryDemo(Demo):
    """Defender recovery view (demo_v2.py:99-169): the U-Net on the
    detector's device."""

    def __init__(self, weights_path: str, detector: Detector,
                 model_name: str = "efficientdet-lite4"):
        super().__init__(detector)
        from ..ckpt import bridge
        from ..ckpt.convert_defense import load_antipatch
        from ..models.unet import PatchNeutralizer

        # a pytree file of either package's defender (`antipatch.pkl`) or a
        # reference antipatch.h5 (attack_detection.py:311-318, demo_v2.py:226)
        self.unet = PatchNeutralizer().eval()
        bridge.load_flax_variables(self.unet, load_antipatch(
            weights_path, bridge.torch_to_flax(self.unet)))
        for p in self.unet.parameters():
            p.requires_grad_(False)
        self.unet.to(detector.device)
        self.device = detector.device
        self.config = detector.config

    @torch.no_grad()
    def recover(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] normalized frames on the device ->
        clip(x + 2 * unet(x), -1, 1), the device part of `serve`."""
        return torch.clamp(x + 2.0 * self.unet(x, training=False), -1.0, 1.0)

    def serve(self, frame: np.ndarray) -> np.ndarray:
        """U-Net recovery in normalized space, de-preprocessed back to the
        raw frame (demo_v2.py:151-169)."""
        from ..ops.preprocess import preprocess_host
        h, w = frame.shape[:2]
        x, scale_back = preprocess_host(frame, self.config.image_size,
                                        self.config.mean_rgb,
                                        self.config.stddev_rgb)
        rec = self.recover(torch.from_numpy(x)[None].to(self.device))
        rec = rec[0].cpu().numpy()
        rec = rec * np.asarray(self.config.stddev_rgb) + np.asarray(
            self.config.mean_rgb)
        rec = np.clip(rec, 0, 255).astype(np.uint8)
        # crop the grey pad band and resize back to the raw frame size
        import cv2
        sh = int(round(h / scale_back))
        sw = int(round(w / scale_back))
        rec = rec[:sh, :sw]
        return cv2.resize(rec, (w, h))

    def run(self, frame: np.ndarray, adv_mean_score: float):
        recovered = self.serve(frame)
        out, bb, sc, mean_score = super().run(recovered)
        recovery = (mean_score - adv_mean_score) * 100.0
        if recovery > RECOVERY_FLASH_PTS:
            out = draw.put_text(out, "ATTACK DETECTED", (10, 90),
                                color=(0, 0, 255), scale=1.0)
        out = draw.put_text(out, f"recovery: {recovery:.1f} pts", (10, 60))
        return out, mean_score


def main(save_dir: str, input_file: Optional[str] = None, *,
         patch_dir: Optional[str] = None,
         defender_weights: Optional[str] = None,
         model_name: str = "efficientdet-lite4",
         detector_ckpt: Optional[str] = None,
         detector_params: Optional[dict] = None,
         set_width: int = 1280, max_frames: Optional[int] = None,
         device=None):
    """Write clean/adv/det videos for a stream (demo_v2.py:192-257); the
    detector and the U-Net on `device` (the card unless "cpu")."""
    import cv2

    os.makedirs(save_dir, exist_ok=True)
    stream = Stream(input_file, set_width=set_width)
    from . import make_demo_detector
    detector = make_demo_detector(model_name, detector_ckpt, detector_params,
                                  device)

    if patch_dir:
        patch_np, scale = artifacts.load_patch_dir(
            patch_dir, detector.config.mean_rgb,
            detector.config.stddev_rgb)
        adv = AdversarialPatch(scale=scale, patch_array=patch_np)
    else:
        adv = AdversarialPatch(scale=0.4)

    clean_demo = Demo(detector)
    attack_demo = AttackDemo(adv, detector)
    recovery_demo = (RecoveryDemo(defender_weights, detector, model_name)
                     if defender_weights else None)

    writers = {}

    def write(name: str, frame: np.ndarray):
        if name not in writers:
            h, w = frame.shape[:2]
            writers[name] = cv2.VideoWriter(
                os.path.join(save_dir, f"{name}.mp4"),
                cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
        writers[name].write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    for i, frame in enumerate(stream.play()):
        if max_frames is not None and i >= max_frames:
            break
        clean_out, bb, sc, _ = clean_demo.run(frame)
        write("clean", clean_out)
        adv_out, attacked, adv_score = attack_demo.run(frame, bb)
        write("adv", adv_out)
        if recovery_demo is not None:
            det_out, _ = recovery_demo.run(attacked, adv_score)
            write("det", det_out)
    for w in writers.values():
        w.release()
    logger.info(f"wrote {list(writers)} to {save_dir}")


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--save-dir", required=True)
    p.add_argument("--input", default=None)
    p.add_argument("--patch-dir", default=None)
    p.add_argument("--defender-weights", default=None)
    p.add_argument("--detector-ckpt", default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args()
    main(a.save_dir, a.input, patch_dir=a.patch_dir,
         defender_weights=a.defender_weights, detector_ckpt=a.detector_ckpt,
         max_frames=a.max_frames, device=a.device)
