"""Learning-rate schedules and the optimizer of supervised detector training.

Port of `mladversarialobjectdetection_tpu/train/schedules.py` (reference
tf2/train_lib.py:51-199): stepwise, cosine and polynomial decay, each with
a linear warmup from `lr_warmup_init` over `lr_warmup_epoch` epochs, and
the optimizer stack clip-by-global-norm + SGD with momentum (or Adam).

A schedule maps the update count to a learning rate in float32, with the
JAX function's operations in its order (jnp with float32 weak types), so
the LR a step uses equals optax's. `make_optimizer` returns an `Optimizer`:
a torch `SGD` (optax `sgd(momentum)`: the trace g + momentum * trace, then
-lr * trace) or `Adam` whose LR is set from the schedule before each update,
at the count before it (optax's `scale_by_schedule` reads `schedule(count)`
and then increments), and a hand-written `clip_by_global_norm`: optax
scales only when the norm is at least `max_norm`, by exactly
`max_norm / norm` (torch's `clip_grad_norm_` divides by `norm + 1e-6`).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List

import numpy as np
import torch

f32 = np.float32


def _with_warmup(base_fn, warmup_init: float, peak_lr: float,
                 warmup_steps: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = f32(step) / f32(max(warmup_steps, 1))
            return float(f32(warmup_init) + f32(peak_lr - warmup_init) * frac)
        return float(base_fn(step))
    return schedule


def cosine_lr(peak_lr: float, warmup_init: float, warmup_steps: int,
              total_steps: int):
    def base(step):
        decay_steps = max(total_steps - warmup_steps, 1)
        # the reference's quirk, kept: the cosine phase uses the raw step
        # over (total - warmup) (train_lib.py:110-117)
        frac = np.clip(f32(step) / f32(decay_steps), f32(0.0), f32(1.0))
        # the cosine of the float32 angle, rounded once (as XLA's is; numpy's
        # float32 cos is an ulp off at some angles)
        cos = f32(np.cos(np.float64(f32(math.pi) * frac)))
        return f32(0.5 * peak_lr) * (f32(1) + cos)
    return _with_warmup(base, warmup_init, peak_lr, warmup_steps)


def stepwise_lr(peak_lr: float, warmup_init: float, warmup_steps: int,
                first_drop_step: int, second_drop_step: int):
    def base(step):
        lr = f32(peak_lr) if step < first_drop_step else f32(peak_lr * 0.1)
        return lr if step < second_drop_step else f32(peak_lr * 0.01)
    return _with_warmup(base, warmup_init, peak_lr, warmup_steps)


def polynomial_lr(peak_lr: float, warmup_init: float, warmup_steps: int,
                  total_steps: int, power: float = 0.9):
    def base(step):
        frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
        return f32(peak_lr) * (f32(1) - frac) ** f32(power)
    return _with_warmup(base, warmup_init, peak_lr, warmup_steps)


def from_config(config, steps_per_epoch: int):
    """The schedule named by config.lr_decay_method (default cosine)."""
    method = config.get("lr_decay_method", "cosine") or "cosine"
    peak = config.learning_rate
    warm_init = config.lr_warmup_init
    warm_steps = int(config.lr_warmup_epoch * steps_per_epoch)
    total = int(config.num_epochs * steps_per_epoch)
    if method == "cosine":
        return cosine_lr(peak, warm_init, warm_steps, total)
    if method == "stepwise":
        return stepwise_lr(
            peak, warm_init, warm_steps,
            int(config.get("first_lr_drop_epoch", 200.0) * steps_per_epoch),
            int(config.get("second_lr_drop_epoch", 250.0) * steps_per_epoch))
    if method == "polynomial":
        return polynomial_lr(peak, warm_init, warm_steps, total,
                             config.get("poly_lr_power", 0.9))
    raise ValueError(f"unknown lr_decay_method {method}")


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm on gradients, in place: when the global
    norm is at least `max_norm`, each gradient becomes (g / norm) * max_norm;
    below it they are left as they are. The decision is taken on the
    device (no host synchronisation)."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


class Optimizer:
    """optax's `make_optimizer` stack over `params`: clip, then SGD with
    momentum (or Adam) at the scheduled LR. `count` is optax's update
    count, the step whose LR the next update uses."""

    def __init__(self, params: List[torch.Tensor], schedule, *, name: str,
                 momentum: float, clip: float):
        self.params = list(params)
        self.name = name
        self.schedule = schedule
        self.clip = float(clip or 0.0)
        self.count = 0
        if name == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=schedule(0),
                                       momentum=momentum)
        elif name == "adam":
            # optax.adam's defaults: b1 .9, b2 .999, eps 1e-8, bias-corrected
            self.opt = torch.optim.Adam(self.params, lr=schedule(0),
                                        betas=(0.9, 0.999), eps=1e-8)
        else:
            raise ValueError(f"optimizer {name}")

    def step(self) -> None:
        """Clip the parameters' gradients and apply one update at the LR of
        the update count."""
        if self.clip > 0:
            clip_by_global_norm([p.grad for p in self.params], self.clip)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)


def make_optimizer(config, steps_per_epoch: int, params) -> Optimizer:
    """The optimizer of `config` (train_lib.py:176-199) over `params`."""
    return Optimizer(params, from_config(config, steps_per_epoch),
                     name=config.get("optimizer", "sgd") or "sgd",
                     momentum=config.momentum,
                     clip=config.get("clip_gradients_norm", 0.0) or 0.0)
