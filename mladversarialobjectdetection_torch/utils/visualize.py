"""Host-side plots of the attack and defense drivers (copies of the JAX
package's `utils/visualize.plot_asr_curve` and `plot_score_violin`). Need
matplotlib, imported at call time."""
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
