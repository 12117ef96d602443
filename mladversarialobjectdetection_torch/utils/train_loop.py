"""Training-loop utilities: plateau LR control, metric logging, throughput.

Port of `mladversarialobjectdetection_tpu/utils/train_loop.py`: the
reference's ReduceLROnPlateau(.5, patience 50, min 1e-4)
(attacker_train.py:70-72), a JSONL metric log and an images/s counter.
The plateau controller mutates a `torch.optim` optimizer's learning rate
where the JAX one rewrites an optax `inject_hyperparams` state.
`save_loop_state`/`load_loop_state` (full-state resume) are not ported yet.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict


class ReduceLROnPlateau:
    """Halve (by `factor`) the learning rate after `patience` epochs without
    improvement of the monitored metric, down to `min_lr`."""

    def __init__(self, factor: float = 0.5, patience: int = 50,
                 min_lr: float = 1e-4, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.best = float("inf") if mode == "min" else -float("inf")
        self.wait = 0

    def update(self, metric: float, optimizer):
        """Record one value of the metric; returns `optimizer` (lr mutated)."""
        improved = (metric < self.best) if self.mode == "min" else (
            metric > self.best)
        if improved:
            self.best = metric
            self.wait = 0
            return optimizer
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            for group in optimizer.param_groups:
                group["lr"] = max(float(group["lr"]) * self.factor, self.min_lr)
        return optimizer


class MetricLogger:
    """JSONL metric log, `<log_dir>/metrics.jsonl`, one record per call.

    Non-finite values (asr on steps that skip the ASR pass) are written as
    JSON null, so each line stays strict JSON."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            v = float(v)
            rec[prefix + k] = v if math.isfinite(v) else None
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class Throughput:
    """Images/s over a window started by `start`."""

    def __init__(self):
        self.t0 = None
        self.images = 0

    def start(self):
        self.t0 = time.time()
        self.images = 0

    def count(self, n: int):
        self.images += n

    def rate(self) -> float:
        dt = time.time() - self.t0
        return self.images / dt if dt > 0 else 0.0
