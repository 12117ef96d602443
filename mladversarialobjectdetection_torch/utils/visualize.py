"""Host-side plot of the attack driver (copy of the JAX package's
`utils/visualize.plot_asr_curve`). Needs matplotlib, imported at call time."""
from __future__ import annotations

from typing import Sequence

import numpy as np


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
    fig.canvas.draw()
    arr = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return arr
