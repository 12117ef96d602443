"""Host-side plots and images of the attack and defense training (copies of
the JAX package's `utils/visualize.plot_asr_curve`, `plot_score_violin` and
`draw_detections_grid`). Need matplotlib or cv2, imported at call time."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _fig_to_array(fig) -> np.ndarray:
    import matplotlib.pyplot as plt
    fig.canvas.draw()
    arr = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return arr


def plot_asr_curve(thresholds: Sequence[float], asr: Sequence[float]
                   ) -> np.ndarray:
    """ASR-vs-score-threshold curve (reference attacker.py:221-236) as an
    RGB image array."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(np.asarray(thresholds), np.asarray(asr), color="blue")
    ax.set_ylim(0.0, 1.0)
    ax.set_xlabel("score_thresh")
    ax.set_ylabel("attack_success_rate")
    fig.tight_layout()
    return _fig_to_array(fig)


def plot_score_violin(original: Sequence[float], recovered: Sequence[float]
                      ) -> np.ndarray:
    """Violins of detection-score distributions before and after defense
    (reference attack_detection.py:210-237) as an RGB image array."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(4, 4))
    data = [np.asarray(original, np.float64).reshape(-1),
            np.asarray(recovered, np.float64).reshape(-1)]
    data = [d if d.size else np.zeros(1) for d in data]
    ax.violinplot(data, showmeans=True)
    ax.set_xticks([1, 2], ["original", "recovered"])
    ax.set_ylabel("scores")
    fig.tight_layout()
    return _fig_to_array(fig)


def draw_detections_grid(images: np.ndarray, clean_boxes, clean_valid,
                         adv_boxes, adv_valid, mean_rgb=127.0,
                         stddev_rgb=128.0) -> np.ndarray:
    """A batch of normalized images with the clean (green) and patched
    (red) detections drawn: the attack's sample images
    (reference attacker.py:285-305). Returns uint8 [B, H, W, 3]."""
    from ..demo import draw as drawmod

    out = []
    for i in range(images.shape[0]):
        img = np.clip(images[i] * stddev_rgb + mean_rgb, 0, 255).astype(
            np.uint8)
        cb = [b for b, v in zip(np.asarray(clean_boxes[i]),
                                np.asarray(clean_valid[i])) if v]
        ab = [b for b, v in zip(np.asarray(adv_boxes[i]),
                                np.asarray(adv_valid[i])) if v]
        img = drawmod.draw_boxes(img, cb, [1.0] * len(cb))
        img = drawmod.draw_boxes(img, ab, [0.0] * len(ab))
        out.append(img)
    return np.stack(out) if out else np.zeros((0, 1, 1, 3), np.uint8)
