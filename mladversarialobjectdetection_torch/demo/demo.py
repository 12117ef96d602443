"""Four-quadrant composite video demo: clean / adversarial patch /
random-patch baseline / defender recovery, with a rolling score graph.

Port of `mladversarialobjectdetection_tpu/demo/demo.py` (reference
demo.py:29-385): each output frame is a 2x2 mosaic [clean | adv;
random-patch | recovery], a matplotlib line graph of the rolling mean
person score (last 30 frames) per view, and ASR / attack-detection-rate
overlays. The detector and the U-Net run on `device` (the card by
default); cv2 and matplotlib on the host.

Usage:
    python -m mladversarialobjectdetection_torch.demo.demo \\
        --save-dir /tmp/demo4 --input clip.mp4
"""
from __future__ import annotations

import collections
import os
from typing import Optional

import numpy as np

from ..attack import artifacts
from ..inference.adv_patch import AdversarialPatch
from ..inference.streaming import Stream
from ..utils.log import get_logger
from . import draw
from .demo_v2 import RecoveryDemo, SCORE_THRESH

logger = get_logger(__name__)

GRAPH_FRAMES = 30


class ScoreGraph:
    """Rolling mean-score graph rendered to a small RGB image
    (demo.py:222-273)."""

    def __init__(self, labels, colors, width=320, height=200):
        self.series = {lb: collections.deque(maxlen=GRAPH_FRAMES)
                       for lb in labels}
        self.colors = colors
        self.wh = (width, height)

    def add(self, label: str, value: float):
        self.series[label].append(value)

    def render(self) -> np.ndarray:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        fig, ax = plt.subplots(figsize=(self.wh[0] / 100, self.wh[1] / 100),
                               dpi=100)
        for (lb, vals), color in zip(self.series.items(), self.colors):
            ax.plot(list(vals), label=lb, color=color, linewidth=1)
        ax.set_ylim(0.0, 1.0)
        ax.set_xlim(0, GRAPH_FRAMES)
        ax.legend(loc="upper right", fontsize=6)
        ax.tick_params(labelsize=6)
        fig.tight_layout(pad=0.3)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        return buf


def _mean_score(scores) -> float:
    return float(np.mean(scores)) if len(scores) else 0.0


def main(save_dir: str, input_file: Optional[str] = None, *,
         patch_dir: Optional[str] = None,
         defender_weights: Optional[str] = None,
         model_name: str = "efficientdet-lite4",
         detector_ckpt: Optional[str] = None,
         detector_params: Optional[dict] = None,
         set_width: int = 640, max_frames: Optional[int] = None,
         device=None):
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
    rnd = AdversarialPatch(scale=adv.scale)  # random-patch baseline
    recovery = (RecoveryDemo(defender_weights, detector, model_name)
                if defender_weights else None)

    graph = ScoreGraph(["clean", "adv", "random", "recovered"],
                       ["green", "red", "orange", "blue"])
    writer = None
    n_frames = n_attacked_detected = 0
    asr_hits = asr_total = 0

    for i, frame in enumerate(stream.play()):
        if max_frames is not None and i >= max_frames:
            break
        views = {}
        bb, sc = detector.infer(frame)
        bb, sc = draw.filter_by_thresh(bb, sc, SCORE_THRESH)
        clean_score = _mean_score(sc)
        views["clean"] = draw.draw_boxes(frame.copy(), bb, sc)

        attacked = adv.add_adv_to_img(frame, bb)
        abb, asc = detector.infer(attacked)
        abb, asc = draw.filter_by_thresh(abb, asc, SCORE_THRESH)
        adv_score = _mean_score(asc)
        views["adv"] = draw.draw_boxes(attacked.copy(), abb, asc)
        asr_total += len(bb)
        asr_hits += max(0, len(bb) - len(abb))

        randomly = rnd.add_adv_to_img(frame, bb)
        rbb, rsc = detector.infer(randomly)
        rbb, rsc = draw.filter_by_thresh(rbb, rsc, SCORE_THRESH)
        views["random"] = draw.draw_boxes(randomly.copy(), rbb, rsc)

        if recovery is not None:
            recovered = recovery.serve(attacked)
            dbb, dsc = detector.infer(recovered)
            dbb, dsc = draw.filter_by_thresh(dbb, dsc, SCORE_THRESH)
            rec_score = _mean_score(dsc)
            views["recovered"] = draw.draw_boxes(recovered.copy(), dbb, dsc)
            if (rec_score - adv_score) * 100 > 10:
                n_attacked_detected += 1
        else:
            rec_score = 0.0
            views["recovered"] = np.zeros_like(frame)
        n_frames += 1

        graph.add("clean", clean_score)
        graph.add("adv", adv_score)
        graph.add("random", _mean_score(rsc))
        graph.add("recovered", rec_score)

        top = np.concatenate([views["clean"], views["adv"]], axis=1)
        bottom = np.concatenate([views["random"], views["recovered"]], axis=1)
        mosaic = np.concatenate([top, bottom], axis=0)

        g = graph.render()
        mosaic[-g.shape[0]:, :g.shape[1]] = g
        asr = asr_hits / max(asr_total, 1)
        det_rate = n_attacked_detected / max(n_frames, 1)
        mosaic = draw.put_text(mosaic, f"ASR: {asr:.2f}", (10, 30))
        mosaic = draw.put_text(mosaic,
                               f"attack detection rate: {det_rate:.2f}",
                               (10, 60))

        if writer is None:
            h, w = mosaic.shape[:2]
            writer = cv2.VideoWriter(os.path.join(save_dir, "demo.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 24,
                                     (w, h))
        writer.write(cv2.cvtColor(mosaic, cv2.COLOR_RGB2BGR))
    if writer is not None:
        writer.release()
    logger.info(f"wrote demo.mp4 ({n_frames} frames) to {save_dir}")


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
         defender_weights=a.defender_weights,
         detector_ckpt=a.detector_ckpt, max_frames=a.max_frames,
         device=a.device)
