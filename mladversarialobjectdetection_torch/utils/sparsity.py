"""Model optimization: magnitude pruning (the reference's tf2/tfmot.py analog).

Port of `mladversarialobjectdetection_tpu/utils/sparsity.py:31-195`. The
reference exposes tensorflow_model_optimization wrappers through a method
registry {'prune': prune_low_magnitude, 'quantize': ...} (tf2/tfmot.py:31-49).
Here they work on a torch module in place:

- `prune_low_magnitude(module, sparsity)`: one-shot magnitude pruning of
  the conv kernels (the smallest |w| of each layer zeroed);
- `MagnitudePruner` + `PolynomialDecaySchedule`: prune during training
  with tfmot's PolynomialDecay sparsity ramp;
- `mask_like`: the parameter EMA follows the mask;
- `sparsity_report`: the zero share per kernel and overall;
- `get_method(name)` / `set_config`: the tfmot.py registry; 'quantize' is
  the port's `inference/quantize` module, and `set_config` binds kwargs
  onto its `quantize_conv_params`, as JAX's (sparsity.py:161-195).

As tfmot, only the weight kernels are pruned: the parameters whose Flax
name is `kernel` (`ckpt/bridge.named_kernel_parameters`), every conv
kernel, depthwise and transposed ones included; biases and BatchNorm stay
dense. Reports and `scope` see each kernel's Flax path ('a/b/kernel'), so
a report compares to the JAX package's key for key. A layer's mask ranks
all of its weights at once, so Flax's HWIO and torch's OIHW layouts give
the same mask.

The pruned count follows JAX to the rounding: k = round(sparsity * n) in
float32 (half to even), with a schedule's float32 value multiplied in
float32 and a Python sparsity multiplied in float64 and then cast, as JAX's
weak types do; every weight tied at the threshold is kept (`>=`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..ckpt import bridge

Sparsity = Union[float, torch.Tensor]


def _pruned_count(sparsity: Sparsity, n: int) -> int:
    """k = round(sparsity * n) in float32, clipped to [0, n - 1] (JAX
    sparsity.py:50-53)."""
    if isinstance(sparsity, torch.Tensor):
        prod = sparsity.to(torch.float32) * torch.tensor(float(n),
                                                         dtype=torch.float32,
                                                         device=sparsity.device)
    else:
        prod = torch.tensor(float(sparsity) * n, dtype=torch.float32)
    return int(torch.clamp(torch.round(prod), 0, n - 1))


def _layer_mask(w: torch.Tensor, sparsity: Sparsity) -> torch.Tensor:
    """Keep-mask zeroing the `sparsity` fraction of smallest |w|: with
    k = round(sparsity * n) weights pruned, the keep threshold is the
    (k+1)-th smallest magnitude (exactly k pruned when the magnitudes are
    distinct; ties at the threshold are all kept)."""
    mag = w.detach().abs()
    k = _pruned_count(sparsity, mag.numel())
    threshold = torch.sort(mag.reshape(-1)).values[k]
    return mag >= threshold


def _kernels(module: nn.Module, scope: Optional[Callable[[str], bool]]):
    return [(path, p) for path, p in bridge.named_kernel_parameters(module)
            if p.dim() >= 2 and (scope is None or scope(path))]


@torch.no_grad()
def prune_low_magnitude(module: nn.Module, sparsity: float, *,
                        scope: Optional[Callable[[str], bool]] = None):
    """One-shot magnitude pruning of `module`'s kernels, in place. Returns
    (module, report): the zero share each kernel's mask makes, by Flax path.

    scope: optional predicate over the 'a/b/kernel' path; layers where it
    returns False are left dense."""
    report: Dict[str, float] = {}
    for path, p in _kernels(module, scope):
        mask = _layer_mask(p, sparsity)
        p.mul_(mask.to(p.dtype))
        report[path] = 1.0 - float(mask.to(torch.float64).mean())
    return module, report


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n by repeated squaring, in JAX's `lax.integer_pow` order."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


@dataclass(frozen=True)
class PolynomialDecaySchedule:
    """tfmot PolynomialDecay: ramp the sparsity from initial to final.

    s(t) = final + (initial - final) * (1 - clip((t-begin)/(end-begin)))^power
    Before begin_step the schedule reports sparsity 0 (no pruning yet).
    Returns a float32 scalar tensor, computed as JAX's float32 schedule."""
    initial_sparsity: float = 0.0
    final_sparsity: float = 0.5
    begin_step: int = 0
    end_step: int = 100
    power: int = 3

    def __call__(self, step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        span = max(self.end_step - self.begin_step, 1)
        frac = torch.clamp((step - self.begin_step) / span, 0.0, 1.0)
        s = (self.final_sparsity
             + (self.initial_sparsity - self.final_sparsity)
             * _integer_pow(1.0 - frac, self.power))
        return torch.where(step >= self.begin_step, s, torch.zeros_like(s))


class MagnitudePruner:
    """Prune during training: re-mask the kernels by their current
    magnitude rank. Call `prune(module, step)` after each optimizer update
    (the tfmot UpdatePruningStep callback role)."""

    def __init__(self, schedule: PolynomialDecaySchedule, *,
                 scope: Optional[Callable[[str], bool]] = None):
        self.schedule = schedule
        self.scope = scope

    @torch.no_grad()
    def prune(self, module: nn.Module, step) -> nn.Module:
        sparsity = self.schedule(step)
        for _, p in _kernels(module, self.scope):
            p.mul_(_layer_mask(p, sparsity).to(p.dtype))
        return module


@torch.no_grad()
def mask_like(reference: nn.Module, tree: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Zero `tree`'s kernel entries (tensors keyed by `reference`'s
    parameter names, as the trainer's EMA) wherever `reference`'s kernels
    are zero, in place; returns the tree.

    Keeps the shadow copies consistent with the pruned weights: a dense
    EMA would silently undo the pruning at eval time (`eval_variables`
    defaults to the EMA)."""
    kernels = {id(p) for p in bridge.kernel_parameters(reference)}
    for name, p in reference.named_parameters():
        if id(p) in kernels and p.dim() >= 2 and name in tree:
            tree[name].mul_((p != 0).to(tree[name].dtype))
    return tree


@torch.no_grad()
def sparsity_report(module: nn.Module) -> Dict[str, Any]:
    """Zero share per kernel (by Flax path) and overall."""
    per_layer: Dict[str, float] = {}
    zeros = total = 0
    for path, p in _kernels(module, None):
        z = int((p == 0).sum())
        per_layer[path] = z / p.numel()
        zeros += z
        total += p.numel()
    return {"per_layer": per_layer,
            "overall": (zeros / total) if total else 0.0}


def _quantize_method():
    from ..inference import quantize
    return quantize

_optimization_methods: Dict[str, Any] = {}


def set_config(configs: Dict[str, Dict[str, Any]]) -> None:
    """tfmot.py:37-43: pre-bind kwargs onto a registry method, e.g.
    ``set_config({'prune': {'sparsity': 0.8}})`` makes
    ``get_method('prune')(module)`` prune at 0.8."""
    for key, kwargs in configs.items():
        if key == "prune":
            _optimization_methods[key] = functools.partial(
                prune_low_magnitude, **kwargs)
        elif key == "quantize":
            _optimization_methods[key] = functools.partial(
                _quantize_method().quantize_conv_params, **kwargs)
        else:
            raise KeyError(f"only support ['prune', 'quantize'], got {key!r}")


def get_method(method: str):
    """tfmot.py:46-49 registry: the supported optimization methods."""
    if method in _optimization_methods:
        return _optimization_methods[method]
    if method == "prune":
        return prune_low_magnitude
    if method == "quantize":
        return _quantize_method()
    raise KeyError(f"only support ['prune', 'quantize'], got {method!r}")
