"""Training-loop utilities: plateau LR control, metric logging, throughput.

Port of `mladversarialobjectdetection_tpu/utils/train_loop.py`: the
reference's ReduceLROnPlateau(.5, patience 50, min 1e-4)
(attacker_train.py:70-72), a JSONL metric log and an images/s counter.
The plateau controller mutates a `torch.optim` optimizer's learning rate
where the JAX one rewrites an optax `inject_hyperparams` state.
`save_loop_state` / `load_loop_state` write and read the full-state resume
file (`state-latest.msgpack`, flax msgpack bytes with the JAX payload's
keys); `adam_state` / `load_adam_state` and `generator_state` /
`load_generator_state` turn the torch objects of a driver's state into the
arrays it holds and back.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from ..parallel import process_index


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


def adam_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The moments, step count and learning rate of a one-group Adam as
    arrays: `{"<i>": {"exp_avg", "exp_avg_sq", "step"}, "lr"}`, parameter i
    in the group's order. Before the first step the moments are zeros and
    the step 0 (optax's initial state)."""
    (group,) = optimizer.param_groups
    out: Dict[str, Any] = {"lr": np.asarray(group["lr"], np.float64)}
    for i, p in enumerate(group["params"]):
        st = optimizer.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        out[str(i)] = {
            "exp_avg": (st["exp_avg"].detach().cpu().numpy() if st else zeros),
            "exp_avg_sq": (st["exp_avg_sq"].detach().cpu().numpy() if st
                           else zeros),
            "step": np.asarray(float(st["step"]) if st else 0.0, np.float32)}
    return out


def load_adam_state(optimizer: torch.optim.Optimizer, arrays) -> None:
    """Restore what `adam_state` returned into `optimizer` (in place)."""
    (group,) = optimizer.param_groups
    group["lr"] = float(arrays["lr"])
    for i, p in enumerate(group["params"]):
        a = arrays[str(i)]
        step = float(a["step"])
        if step == 0:
            optimizer.state.pop(p, None)
            continue
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.tensor(np.array(a["exp_avg"]), device=p.device),
            "exp_avg_sq": torch.tensor(np.array(a["exp_avg_sq"]),
                                       device=p.device)}


def generator_state(gen: torch.Generator) -> np.ndarray:
    """A `torch.Generator`'s state as a uint8 array."""
    return gen.get_state().numpy().copy()


def load_generator_state(gen: torch.Generator, arr) -> None:
    gen.set_state(torch.from_numpy(np.array(arr, np.uint8)))


def save_loop_state(path: str, state: Dict[str, Any], *, epoch: int,
                    step: int, best: float, plateau: ReduceLROnPlateau,
                    aug_gen: torch.Generator) -> None:
    """Full-state training checkpoint for kill-and-resume (JAX
    train_loop.py:51-72): a training driver's state as nested dicts of arrays
    (its trainables, optimizer moments, step and generator), the loop
    counters, the best-metric gate, the plateau controller's best / wait
    (its LR lives in the optimizer state) and the augmentation generator,
    under the JAX payload's keys (`aug_key` holds the generator's state)."""
    from ..ckpt import io as ckpt_io
    payload = {"state": state, "aug_key": generator_state(aug_gen),
               "loop": np.asarray([epoch, step], np.int64),
               "best": np.asarray(best, np.float64),
               "plateau": np.asarray([plateau.best, plateau.wait], np.float64)}
    ckpt_io.save_state_bytes(path, payload)


def load_loop_state(path: str, state_template: Dict[str, Any],
                    aug_gen: torch.Generator, plateau: ReduceLROnPlateau):
    """Restore a `save_loop_state` file. Sets `aug_gen` and `plateau` in
    place; returns (state arrays, start_epoch, step, best)."""
    from ..ckpt import io as ckpt_io
    template = {"state": state_template, "aug_key": 0, "loop": 0, "best": 0,
                "plateau": 0}
    p = ckpt_io.load_state_bytes(path, template)
    plateau.best = float(p["plateau"][0])
    plateau.wait = int(p["plateau"][1])
    load_generator_state(aug_gen, p["aug_key"])
    return (p["state"], int(p["loop"][0]), int(p["loop"][1]),
            float(p["best"]))


class MetricLogger:
    """JSONL metric log, `<log_dir>/metrics.jsonl`, one record per call.

    Across processes each writes its own file (JAX train_loop.py:101-107):
    rank 0 `metrics.jsonl`, rank i `metrics.p{i}.jsonl`, so ranks sharing a
    log directory never interleave lines. Non-finite values (asr on steps
    that skip the ASR pass) are written as JSON null, so each line stays
    strict JSON."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        rank = process_index()
        self.path = os.path.join(
            log_dir, "metrics.jsonl" if rank == 0 else f"metrics.p{rank}.jsonl")
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
