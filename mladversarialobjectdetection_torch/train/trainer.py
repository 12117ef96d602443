"""Supervised EfficientDet trainer (PyTorch).

Port of `mladversarialobjectdetection_tpu/train/trainer.py`
(`DetectorTrainer`: `init_state`, `train_step`, `eval_variables`; reference
tf2/train_lib.py:467-729, `EfficientDetNetTrain`): focal + huber losses over
anchor labels, l2 weight decay on conv kernels, clip-by-global-norm, SGD
with momentum (or Adam) at the configured schedule, a parameter EMA at
`moving_average_decay` (0: the EMA is the parameters themselves), and
train-mode BatchNorm statistics. `grad_accum` > 1 splits each batch into
that many sequential microbatches with one update on the mean gradient;
BatchNorm uses each microbatch's statistics (ghost batch norm), and the
running statistics move once per microbatch (trainer.py:103-143).

The net runs with Flax's explicit `training=True`: train-mode BatchNorm and
every backbone block through `_forward_unfused` (the fused MBConv op
computes frozen BatchNorm and has no weight gradient), so the convs are
cuDNN's (or ATen's on the CPU), as the JAX trainer's are XLA's: no Pallas
kernel lies on this path. `config.mixed_precision` trains with bf16
activations and float32 parameters, statistics and loss, by Flax's `dtype=`
rules. Entry points run on the card unless `device="cpu"` is asked for.

Data parallelism (`parallel.use_mesh`, JAX's step on a batch-sharded
array): each rank steps on its rows of the global batch with the same
state. Train-mode BatchNorm normalises by the global batch's statistics
(over `bn_axis_name`, or every data axis), drop-connect draws at the global
batch's shape, the losses divide by the global batch's positives, and the
L2 term of the replicated parameters enters on the first rank only, so the
ranks' losses sum to the global one; the gradients are summed over the
ranks before the clip, and the update and the EMA stay replicated.

Spatial partitioning (a ('data', 'spatial') mesh, `parallel/spatial.py`):
the images are this rank's rows of its data shard's images, the net runs
row-sharded and gathers its outputs, so the labels, the losses and the
metrics are the data shard's, alike on each rank of a spatial group. The
loss enters the backward once in the group (`spatial.count_once`), the
gradients are summed over data x spatial, and the statistics of row-sharded
levels over data x spatial too (`efficientnet.batch_stats`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import parallel
from ..ckpt import bridge
from ..parallel import spatial
from ..models.efficientdet import EfficientDetNet, spec_from_config
from ..models.init import init_weights
from ..ops.anchors import Anchors
from ..utils.device import resolve_device
from . import labeler as labeler_lib
from . import losses as losses_lib
from . import schedules


@dataclasses.dataclass
class TrainState:
    """The detector being trained; `train_step` updates it in place."""
    net: EfficientDetNet                  # parameters and BatchNorm statistics
    ema: Optional[Dict[str, torch.Tensor]]  # EMA of the parameters; None: decay 0
    optimizer: schedules.Optimizer
    step: int


class DetectorTrainer:
    """The supervised train step of an EfficientDet config."""

    def __init__(self, config, *, steps_per_epoch: int = 1000,
                 bn_axis_name: str | None = None, grad_accum: int = 1,
                 device=None):
        self.bn_axis_name = bn_axis_name
        self.device = resolve_device(device)
        self.config = config
        self.spec = spec_from_config(config)
        self.steps_per_epoch = steps_per_epoch
        self.anchor_boxes = torch.from_numpy(
            Anchors.from_config(config).boxes).to(self.device)
        self.ema_decay = float(config.get("moving_average_decay", 0.9998) or 0)
        self.num_classes = config.num_classes
        self.num_anchors = self.spec.num_anchors
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def init_state(self, seed: int = 0, variables=None) -> TrainState:
        """A detector drawn from `seed` (Flax's initializer families, not its
        draws) or loaded from Flax `variables`, its optimizer and EMA."""
        net = EfficientDetNet(self.spec, bn_axis_name=self.bn_axis_name)
        if variables is not None:
            bridge.load_flax_variables(net, variables)
        else:
            init_weights(net, torch.Generator().manual_seed(seed))
        net.to(self.device)
        ema = ({k: p.detach().clone() for k, p in net.named_parameters()}
               if self.ema_decay else None)
        opt = schedules.make_optimizer(self.config, self.steps_per_epoch,
                                       list(net.parameters()))
        return TrainState(net, ema, opt, 0)

    def labels(self, gt_boxes, gt_classes, gt_valid) -> labeler_lib.AnchorLabels:
        dev = self.device
        return labeler_lib.label_anchors(
            self.anchor_boxes,
            torch.as_tensor(np.asarray(gt_boxes, np.float32)).to(dev),
            torch.as_tensor(np.asarray(gt_classes)).to(dev),
            torch.as_tensor(np.asarray(gt_valid, bool)).to(dev))

    def _loss(self, net: EfficientDetNet, images: torch.Tensor,
              labels: labeler_lib.AnchorLabels):
        cls_out, box_out = net(images, training=True)
        cfg = self.config
        det_loss, parts = losses_lib.detection_loss(
            cls_out, box_out, labels, num_classes=self.num_classes,
            num_anchors=self.num_anchors, alpha=cfg.alpha, gamma=cfg.gamma,
            delta=cfg.delta, box_loss_weight=cfg.box_loss_weight,
            label_smoothing=cfg.label_smoothing,
            anchor_boxes=self.anchor_boxes,
            iou_loss_type=cfg.get("iou_loss_type"),
            iou_loss_weight=float(cfg.get("iou_loss_weight") or 1.0))
        reg = losses_lib.l2_regularization(net, cfg.weight_decay)
        # the replicated parameters' L2 term counts once in the ranks' sum
        return (det_loss + reg if parallel.is_first_rank() else det_loss,
                parts, reg)

    def train_step(self, state: TrainState, images, gt_boxes, gt_classes,
                   gt_valid) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One supervised step; updates `state` in place and returns it.

        images [B, H, W, 3] (under a spatial mesh, this rank's rows);
        gt_boxes [B, G, 4]; gt_classes [B, G] (0-based model classes);
        gt_valid [B, G] bool. Metrics: loss, det_loss,
        reg_loss, cls_loss, box_loss (and box_iou_loss), device tensors."""
        images = torch.as_tensor(images).to(self.device)  # the net casts it
        labels = self.labels(gt_boxes, gt_classes, gt_valid)
        net = state.net
        state.optimizer.zero_grad()
        k = self.grad_accum
        b = images.shape[0]
        if b % k != 0:
            raise ValueError(f"batch {b} not divisible by grad_accum={k}")
        mb = b // k
        loss_sum = reg_sum = None
        parts_sum: Dict[str, torch.Tensor] = {}
        for i in range(k):
            rows = slice(i * mb, (i + 1) * mb)
            micro = labeler_lib.AnchorLabels(*(f[rows] for f in labels))
            loss, parts, reg = self._loss(net, images[rows], micro)
            spatial.count_once(loss).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            reg_sum = reg.detach() if reg_sum is None else reg_sum + reg.detach()
            for name, v in parts.items():
                parts_sum[name] = (v.detach() if name not in parts_sum
                                   else parts_sum[name] + v.detach())
        # the global batch's loss and parts (the L2 term is replicated)
        loss_sum, *sums = parallel.reduce_sum(
            torch.stack([loss_sum, *parts_sum.values()])).unbind()
        parts_sum = dict(zip(parts_sum, sums))
        parallel.all_reduce_grads(net.parameters())
        if k > 1:  # the mean of the microbatch gradients (JAX: g * (1 / k))
            inv = 1.0 / k
            with torch.no_grad():
                for p in net.parameters():
                    if p.grad is not None:
                        p.grad.mul_(inv)
            loss_sum, reg_sum = loss_sum * inv, reg_sum * inv
            parts_sum = {n: v * inv for n, v in parts_sum.items()}
        for p in net.parameters():  # optax sees a zero gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        if state.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in net.named_parameters():
                    e = state.ema[name]
                    e.copy_(d * e + (1 - d) * p)
        state.step += 1
        metrics = {"loss": loss_sum, "det_loss": loss_sum - reg_sum,
                   "reg_loss": reg_sum, **parts_sum}
        return state, metrics

    def state_dict(self, state: TrainState) -> Dict:
        """`state` as the JAX `TrainState`'s flax state dict (nested dicts of
        numpy arrays, Flax names and layouts): params, batch_stats,
        ema_params (the parameters themselves at decay 0, as JAX's), the
        optax chain's opt_state and step (int32). `ckpt/io.save_state_bytes`
        of it is the file both packages' drivers resume from."""
        net = state.net
        named = dict(net.named_parameters())
        variables = bridge.torch_to_flax(net)
        tree = lambda tensors: bridge.to_flax_tree(net, tensors)
        opt = state.optimizer
        count = np.asarray(opt.count, np.int32)
        slots = {n: opt.opt.state.get(p, {}) for n, p in named.items()}
        moment = lambda key: tree({n: s[key] if key in s else torch.zeros_like(named[n])
                                   for n, s in slots.items()})
        if opt.name == "sgd":  # optax.sgd: chain(trace, scale_by_schedule)
            tx = {"0": {"trace": moment("momentum_buffer")}, "1": {"count": count}}
        else:  # optax.adam: chain(scale_by_adam, scale_by_schedule)
            tx = {"0": {"count": count, "mu": moment("exp_avg"),
                        "nu": moment("exp_avg_sq")}, "1": {"count": count}}
        return {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "ema_params": tree(state.ema if state.ema is not None else named),
                "opt_state": {"0": {}, "1": tx} if opt.clip > 0 else tx,
                "step": np.asarray(state.step, np.int32)}

    @torch.no_grad()
    def load_state_dict(self, state: TrainState, arrays) -> TrainState:
        """Restore what `state_dict` gives (or JAX's `TrainState` read through
        `ckpt/io.load_state_bytes` with `state_dict(state)` as the template)
        into `state`, in place; returns it."""
        net = state.net
        bridge.load_flax_variables(net, {"params": arrays["params"],
                                         "batch_stats": arrays["batch_stats"]})
        if state.ema is not None:
            for name, value in bridge.from_flax_tree(
                    net, arrays["ema_params"]).items():
                state.ema[name].copy_(value)
        opt = state.optimizer
        tx = arrays["opt_state"]["1"] if opt.clip > 0 else arrays["opt_state"]
        opt.count = int(tx["1"]["count"])
        inner = opt.opt
        inner.state.clear()
        named = dict(net.named_parameters())
        if opt.name == "sgd":
            for name, value in bridge.from_flax_tree(net, tx["0"]["trace"]).items():
                p = named[name]
                inner.state[p] = {"momentum_buffer": value.to(p.device, p.dtype)}
        elif opt.count > 0:
            mu = bridge.from_flax_tree(net, tx["0"]["mu"])
            nu = bridge.from_flax_tree(net, tx["0"]["nu"])
            for name, p in named.items():
                inner.state[p] = {
                    "step": torch.tensor(float(tx["0"]["count"]), dtype=torch.float32),
                    "exp_avg": mu[name].to(p.device, p.dtype),
                    "exp_avg_sq": nu[name].to(p.device, p.dtype)}
        state.step = int(arrays["step"])
        return state

    def eval_variables(self, state: TrainState, use_ema: bool = True
                       ) -> EfficientDetNet:
        """The inference detector: a frozen copy of the net with the EMA
        parameters (by default, as restore_ckpt with moving_average_decay)
        or the parameters, and the BatchNorm statistics. Its Flax variables
        are `ckpt/bridge.torch_to_flax` of it."""
        net = copy.deepcopy(state.net).eval()
        if use_ema and state.ema is not None:
            with torch.no_grad():
                for name, p in net.named_parameters():
                    p.copy_(state.ema[name])
        for p in net.parameters():
            p.requires_grad_(False)
        return net
