"""EfficientNet / EfficientNet-lite backbone in PyTorch.

Port of `mladversarialobjectdetection_tpu/models/efficientnet.py`. The
block-string decoding, width/depth rounding and lite rules are copies of
the JAX module's; the layers are `nn.Module`s whose names mirror the Flax
module names (`stem_conv`, `blocks_3.depthwise_conv`, `blocks_3.bn1`, ...),
so `ckpt/bridge.py` maps a Flax variable tree onto them by a rename.

Tensors are NCHW inside this module; a fused block (`MBConvBlock`) hands
its kernel the NHWC view of the same memory, which the activations already
have, since the detector enters the backbone as a permute of NHWC images.
Two behaviours of the Flax layers are reproduced explicitly, because
PyTorch's defaults differ:

- Flax `"SAME"` padding is asymmetric for stride 2: `same_pads`.
- Flax `BatchNorm` in eval mode computes
  `(x - mean) * (rsqrt(var + eps) * scale) + bias` with eps 1e-3, and in
  train mode (an explicit `training` argument, as Flax's) normalises by the
  batch statistics with the variance E[x^2] - E[x]^2 clipped at 0, in
  float32, and moves the running statistics by that biased variance at
  momentum .99: `batch_norm`, `BatchNorm` (the U-Net's too).

Mixed precision follows Flax's explicit `dtype=` (the JAX package's
`EfficientNet(..., dtype=bf16)`), not `torch.autocast`, whose op lists
round at other points: a module built with a compute dtype
(`set_compute_dtype`) keeps float32 parameters, and each `Conv2d` casts its
input, kernel and bias to that dtype and adds the bias after the conv, as
`nn.Conv(dtype=...)` does; each `BatchNorm` normalises in float32 (bf16 x
minus the float32 mean promotes, flax.linen.normalization._normalize) and
rounds once; a fused block runs the kernels' bf16 instance.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import mbconv as mbconv_ops


class BlockArgs(NamedTuple):
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    id_skip: bool
    se_ratio: Optional[float]
    strides: Tuple[int, int]


class BackboneSpec(NamedTuple):
    """Fully-resolved static backbone description (hashable)."""
    blocks: Tuple[BlockArgs, ...]  # repeats already expanded
    stem_filters: int
    act_type: str
    use_se: bool
    bn_momentum: float
    bn_epsilon: float
    survival_prob: Optional[float]


# (width_coefficient, depth_coefficient, resolution, dropout_rate) — parity
# with the reference's backbone tables (backbone/efficientnet_*.py).
PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-lite0": (1.0, 1.0, 224, 0.2),
    "efficientnet-lite1": (1.0, 1.1, 240, 0.2),
    "efficientnet-lite2": (1.1, 1.2, 260, 0.3),
    "efficientnet-lite3": (1.2, 1.4, 280, 0.3),
    "efficientnet-lite4": (1.4, 1.8, 300, 0.3),
}

# the reference's default block strings (backbone/efficientnet_*.py)
DEFAULT_BLOCK_STRINGS = (
    "r1_k3_s11_e1_i32_o16_se0.25",
    "r2_k3_s22_e6_i16_o24_se0.25",
    "r2_k5_s22_e6_i24_o40_se0.25",
    "r3_k3_s22_e6_i40_o80_se0.25",
    "r3_k5_s11_e6_i80_o112_se0.25",
    "r4_k5_s22_e6_i112_o192_se0.25",
    "r1_k3_s11_e6_i192_o320_se0.25",
)

BN_EPSILON = 1e-3  # efficientnet.py:164 and the BatchNorm defaults at 180-181
BN_MOMENTUM = 0.99


def decode_block_string(s: str) -> BlockArgs:
    """Decode a block string such as 'r1_k3_s11_e1_i32_o16_se0.25'."""
    options = {}
    for op in s.split("_"):
        splits = re.split(r"(\d.*)", op)
        if len(splits) >= 2:
            options[splits[0]] = splits[1]
    return BlockArgs(
        kernel_size=int(options["k"]),
        num_repeat=int(options["r"]),
        input_filters=int(options["i"]),
        output_filters=int(options["o"]),
        expand_ratio=int(options["e"]),
        id_skip="noskip" not in s,
        se_ratio=float(options["se"]) if "se" in options else None,
        strides=(int(options["s"][0]), int(options["s"][1])),
    )


def round_filters(filters: int, width_coefficient: float,
                  divisor: int = 8, skip: bool = False) -> int:
    """Parity with efficientnet_model.py:129-143."""
    if skip or not width_coefficient:
        return int(filters)
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


def activation(x: torch.Tensor, act_type: str) -> torch.Tensor:
    """Parity with automl utils.py:36-53 activation_fn."""
    if act_type in ("swish", "silu"):
        return F.silu(x)
    if act_type == "swish_native":
        return x * torch.sigmoid(x)
    if act_type == "relu":
        return F.relu(x)
    if act_type == "relu6":
        return F.relu6(x)
    if act_type == "hswish":
        return x * F.relu6(x + 3) / 6
    if act_type == "mish":
        return x * torch.tanh(F.softplus(x))
    raise ValueError(f"Unsupported act_type {act_type}")


def get_backbone_spec(backbone_name: str, survival_prob: Optional[float] = None
                      ) -> BackboneSpec:
    """Resolve a backbone name into a static spec (reference parity)."""
    if backbone_name not in PARAMS:
        raise ValueError(f"Unknown backbone {backbone_name}")
    width, depth, _, _ = PARAMS[backbone_name]
    is_lite = "lite" in backbone_name
    fix_head_stem = is_lite  # lite: don't scale stem/head
    use_se = not is_lite
    act_type = "relu6" if is_lite else "swish"

    raw_blocks = [decode_block_string(s) for s in DEFAULT_BLOCK_STRINGS]
    expanded: list[BlockArgs] = []
    n = len(raw_blocks)
    for i, ba in enumerate(raw_blocks):
        in_f = round_filters(ba.input_filters, width)
        out_f = round_filters(ba.output_filters, width)
        if fix_head_stem and (i == 0 or i == n - 1):
            repeats = ba.num_repeat
        else:
            repeats = round_repeats(ba.num_repeat, depth)
        first = ba._replace(input_filters=in_f, output_filters=out_f,
                            num_repeat=1)
        expanded.append(first)
        for _ in range(repeats - 1):
            expanded.append(first._replace(input_filters=out_f,
                                           strides=(1, 1)))
    stem_filters = round_filters(raw_blocks[0].input_filters, width,
                                 skip=fix_head_stem)
    return BackboneSpec(tuple(expanded), stem_filters, act_type, use_se,
                        bn_momentum=0.99, bn_epsilon=BN_EPSILON,
                        survival_prob=survival_prob)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial dim under Flax/XLA `"SAME"`.

    Hazard: XLA pads `total = max((ceil(size/stride) - 1) * stride + kernel
    - size, 0)` with `total // 2` before and the rest after. For stride 2 at
    an even size that is (0, 1) for k3 and (1, 2) for k5, so PyTorch's
    symmetric `padding=k//2` shifts the sampling grid by one pixel.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor as Flax `"SAME"` would, before a `padding=0` op."""
    top, bottom = same_pads(x.shape[2], kernel[0], stride[0])
    left, right = same_pads(x.shape[3], kernel[1], stride[1])
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv2d(nn.Conv2d):
    """`nn.Conv` with Flax `"SAME"` padding (explicit `F.pad` + `padding=0`).

    `init` names the Flax initializer family of the matching Flax conv,
    which `models/init.py` applies; `bias_value` is its constant bias.
    `compute_dtype` (None: float32) as Flax's `dtype`: see the module notes.
    The kernel and bias in the compute dtype are cached and recast when a
    parameter changes (its storage or version); where gradients are on and
    a parameter requires one, they are cast with autograd on every call, and
    under `torch.export` (whose parameters have no storage) the cast is
    traced as ops.
    """
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True, *,
                 init: str, bias_value: float = 0.0):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=0, groups=groups, bias=bias)
        self.init = init
        self.bias_value = bias_value
        self._cast = None  # (key of the parameters and dtype, weight, bias)

    def _in_dtype(self, cd: torch.dtype):
        """(weight, bias) in the compute dtype cd (see the class docstring)."""
        params = [p for p in (self.weight, self.bias) if p is not None]
        cast = lambda: (self.weight.to(cd),
                        None if self.bias is None else self.bias.to(cd))
        if torch.compiler.is_exporting() or (
                torch.is_grad_enabled() and any(p.requires_grad for p in params)):
            return cast()
        key = (cd,) + tuple((p.data_ptr(), p._version, p.device) for p in params)
        if self._cast is None or self._cast[0] != key:
            with torch.no_grad():
                self._cast = (key, *cast())
        return self._cast[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(pad_same(x, self.kernel_size, self.stride))
        weight, bias = self._in_dtype(cd)
        y = F.conv2d(pad_same(x.to(cd), self.kernel_size, self.stride),
                     weight, None, self.stride, 0, self.dilation, self.groups)
        return y if bias is None else y + bias.view(1, -1, 1, 1)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, *, training: bool,
               momentum: float = BN_MOMENTUM, eps: float = BN_EPSILON):
    """Flax `nn.BatchNorm` over NCHW x; returns (y, new mean, new var).

    Train mode normalizes by the batch statistics and returns the running
    statistics moved toward them (Flax's `mutable=["batch_stats"]`); eval
    mode normalizes by `mean` / `var` and returns them unchanged."""
    if training:
        mu = x.mean(dim=(0, 2, 3))
        batch_var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mu * mu, 0.0)
        new_mean = momentum * mean + (1.0 - momentum) * mu.detach()
        new_var = momentum * var + (1.0 - momentum) * batch_var.detach()
    else:
        mu, batch_var, new_mean, new_var = mean, var, mean, var
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(batch_var + eps) * weight
    y = (x - mu.view(shape)) * mul.view(shape) + bias.view(shape)
    return y, new_mean, new_var


_RECOMPUTE = threading.local()  # .active: a remat recompute is running
_UNFUSED = threading.local()    # .active: every MBConvBlock runs unfused


@contextlib.contextmanager
def unfused_blocks():
    """Every `MBConvBlock` in this thread runs `_forward_unfused` inside:
    the int8 serve (`inference/quantize.py`) calibrates and quantises the
    block's own convs, which the fused op never calls."""
    before = getattr(_UNFUSED, "active", False)
    _UNFUSED.active = True
    try:
        yield
    finally:
        _UNFUSED.active = before


def recomputing() -> bool:
    """Whether a remat recompute is running in this thread."""
    return getattr(_RECOMPUTE, "active", False)


@contextlib.contextmanager
def _recompute():
    """The block pass inside runs again for remat: its BatchNorms leave their
    running statistics as they are."""
    before = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = before


def checkpointed(fn, *tensors):
    """`fn(*tensors)` with its activations recomputed in the backward pass
    (`torch.utils.checkpoint`, non-reentrant; Flax's `nn.remat`): the
    recompute runs under `_recompute`, so its BatchNorms do not move their
    running statistics a second time. `fn` must compute the same function
    again: the detector's FPN cells and head convs draw nothing at random;
    `unet.remat_call` hands the U-Net's blocks, which draw dropout, a
    generator restored to the first pass's state."""
    from torch.utils.checkpoint import checkpoint
    first = [True]

    def run(*args):
        if first[0]:
            first[0] = False
            return fn(*args)
        with _recompute():
            return fn(*args)

    return checkpoint(run, *tensors, use_reentrant=False)


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm` (the JAX wrapper `BatchNorm`, efficientnet.py:174-193),
    eps 1e-3 and momentum .99, with an explicit `training` argument as Flax
    has: a module's own `nn.Module.training` is not read, so a victim that
    was never `.eval()`'d still normalises by its running statistics.

    Eval mode computes `(x - mean) * (rsqrt(var + eps) * scale) + bias`
    (flax.linen.normalization._normalize). Hazard: `F.batch_norm` divides by
    `sqrt(var + eps)` and multiplies after, which differs by rounding. Train
    mode normalises by the batch statistics (`batch_norm`) and moves the
    running statistics in place, not in a remat recompute. The detector's
    Flax wrapper nests `nn.BatchNorm` as `bn`; this module holds the
    parameters directly (the bridge drops that segment). With a
    `compute_dtype` it normalises in float32 and returns that dtype.
    """
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, num_features: int, eps: float = BN_EPSILON,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is not None:
            x = x.to(torch.float32)
        y, new_mean, new_var = batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            training=training, momentum=self.momentum, eps=self.eps)
        if training and not recomputing():
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return y if cd is None else y.to(cd)


def drop_connect(x: torch.Tensor, generator: torch.Generator,
                 survival_prob: float) -> torch.Tensor:
    """Stochastic depth (efficientnet.py:196-200, automl utils.py:329-341):
    keep each example's residual branch with probability `survival_prob`
    (a uniform draw from `generator` below it) and scale it by its inverse."""
    keep = torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                      device=x.device) < survival_prob
    return x / survival_prob * keep.to(x.dtype)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Give every `Conv2d` and `BatchNorm` in `module` the compute dtype
    (None or torch.float32: float32; torch.bfloat16: mixed precision)."""
    dtype = None if dtype == torch.float32 else dtype
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute dtype float32 or bfloat16, got {dtype}")
    for m in module.modules():
        if isinstance(m, (Conv2d, BatchNorm)):
            m.compute_dtype = dtype


class SqueezeExcite(nn.Module):
    """efficientnet.py:203-217; only the non-lite backbones use it."""

    def __init__(self, channels: int, se_filters: int, act_type: str):
        super().__init__()
        self.act_type = act_type
        self.reduce = Conv2d(channels, se_filters, 1, init="fan_out_normal")
        self.expand = Conv2d(se_filters, channels, 1, init="fan_out_normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.mean(x, dim=(2, 3), keepdim=True)
        s = activation(self.reduce(pooled), self.act_type)
        return torch.sigmoid(self.expand(s)) * x


class MBConvBlock(nn.Module):
    """Mobile inverted residual bottleneck (efficientnet.py:220-267).

    `in_channels` is the actual input width: the lite stem is unscaled while
    the block args are width-rounded, so block 0 of a lite backbone sees
    fewer channels than `args.input_filters`.

    A block that `ops/mbconv.fuseable` accepts (expansion, stride 1, no
    squeeze-excite; 25 of lite4's 30 blocks) runs as the fused frozen MBConv
    (`ops/mbconv.mbconv`): the CUDA kernels for CUDA tensors, the plain
    version on the CPU, its BatchNorms folded into its convs. The folded
    weights are cached and refolded when a parameter or statistic changes
    (its storage or version). Where gradients are on and a weight requires
    one, the fold is recomputed with autograd so that a backward that needs
    the weights' gradient reaches the op's refusal instead of a silent zero;
    under `torch.export` the fold is traced as ops. The other blocks, the
    tests' reference and the int8 serve (`unfused_blocks`, whose calibration
    and int8 convs need the block's own convs) run `_forward_unfused`.
    A bf16 input runs the op's bf16 instance on the fold in bf16
    (`folded(torch.bfloat16)`: We and Wp in bf16), cached per dtype.

    In training (`training=True`) every block runs `_forward_unfused`: the
    fused op computes frozen BatchNorm and has no weight gradient.
    """

    def __init__(self, args: BlockArgs, spec: BackboneSpec, in_channels: int):
        super().__init__()
        self.args = args
        self.act_type = spec.act_type
        eps = spec.bn_epsilon
        if args.expand_ratio != 1:
            filters = args.input_filters * args.expand_ratio
            self.expand_conv = Conv2d(in_channels, filters, 1, bias=False,
                                      init="fan_out_normal")
            self.bn0 = BatchNorm(filters, eps)
        else:
            filters = in_channels
        self.depthwise_conv = Conv2d(filters, filters, args.kernel_size,
                                     args.strides[0], groups=filters,
                                     bias=False, init="fan_out_normal")
        self.bn1 = BatchNorm(filters, eps)
        self.se = None
        if spec.use_se and args.se_ratio:
            se_filters = max(1, int(args.input_filters * args.se_ratio))
            self.se = SqueezeExcite(filters, se_filters, spec.act_type)
        self.project_conv = Conv2d(filters, args.output_filters, 1, bias=False,
                                   init="fan_out_normal")
        self.bn2 = BatchNorm(args.output_filters, eps)
        self.residual = (args.id_skip and args.strides == (1, 1)
                         and args.input_filters == args.output_filters)
        self.fuseable = mbconv_ops.fuseable(args, spec.use_se, spec.act_type)
        self._folded = {}  # dtype: (key of the source tensors, FoldedBlock)

    def _fold_sources(self) -> Tuple[torch.Tensor, ...]:
        bns = (self.bn0, self.bn1, self.bn2)
        return ((self.expand_conv.weight, self.depthwise_conv.weight,
                 self.project_conv.weight)
                + tuple(t for bn in bns for t in (bn.weight, bn.bias,
                                                  bn.running_mean, bn.running_var)))

    def folded(self, dtype: torch.dtype = torch.float32) -> mbconv_ops.FoldedBlock:
        """The block's BN-folded weights, We and Wp in `dtype` (cached per
        dtype; see the class docstring)."""
        sources = self._fold_sources()
        if torch.compiler.is_exporting() or (
                torch.is_grad_enabled() and any(t.requires_grad for t in sources)):
            return mbconv_ops.fold_block(self).in_dtype(dtype)
        key = tuple((t.data_ptr(), t._version, t.device) for t in sources)
        hit = self._folded.get(dtype)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = self._folded[dtype] = (key, mbconv_ops.fold_block(self).in_dtype(dtype))
        return hit[1]

    def forward(self, x: torch.Tensor, training: bool = False,
                survival_prob: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if training:
            return self._forward_unfused(x, training, survival_prob, generator)
        if not self.fuseable or getattr(_UNFUSED, "active", False):
            return self._forward_unfused(x)
        y = mbconv_ops.mbconv(mbconv_ops.nhwc(x.permute(0, 2, 3, 1)),
                              self.folded(x.dtype), act_type=self.act_type,
                              residual=self.residual)
        return y.permute(0, 3, 1, 2)

    def _forward_unfused(self, x: torch.Tensor, training: bool = False,
                         survival_prob: Optional[float] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        inputs = x
        if self.args.expand_ratio != 1:
            x = activation(self.bn0(self.expand_conv(x), training),
                           self.act_type)
        x = activation(self.bn1(self.depthwise_conv(x), training),
                       self.act_type)
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.project_conv(x), training)
        if self.residual:
            if training and survival_prob:
                if generator is None:  # Flax: no "dropout" rng
                    raise ValueError("drop-connect in training needs a "
                                     "generator")
                x = drop_connect(x, generator, survival_prob)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Backbone returning the reduction_1..5 endpoints (efficientnet.py:270-301).

    `dtype`: the compute dtype (None: float32; torch.bfloat16 as the JAX
    `EfficientNet(..., dtype)`); the endpoints come in it. `training` as
    Flax's argument: train-mode BatchNorm, every block unfused, and
    drop-connect from `generator` where `spec.survival_prob` is set."""

    def __init__(self, spec: BackboneSpec, in_channels: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.spec = spec
        self.stem_conv = Conv2d(in_channels, spec.stem_filters, 3, 2,
                                bias=False, init="fan_out_normal")
        self.stem_bn = BatchNorm(spec.stem_filters, spec.bn_epsilon)
        channels = spec.stem_filters
        for idx, ba in enumerate(spec.blocks):
            self.add_module(f"blocks_{idx}", MBConvBlock(ba, spec, channels))
            channels = ba.output_filters
        n_blocks = len(spec.blocks)
        self._reductions = tuple(
            idx for idx in range(n_blocks)
            if idx == n_blocks - 1 or spec.blocks[idx + 1].strides[0] > 1)
        self.endpoint_channels: List[int] = [
            spec.blocks[idx].output_filters for idx in self._reductions]
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        spec = self.spec
        x = activation(self.stem_bn(self.stem_conv(x), training), spec.act_type)
        endpoints = []
        n_blocks = len(spec.blocks)
        for idx in range(n_blocks):
            survival_prob = None
            if spec.survival_prob:  # efficientnet.py:289-292
                survival_prob = 1.0 - (1.0 - spec.survival_prob) * float(idx) / n_blocks
            x = getattr(self, f"blocks_{idx}")(x, training, survival_prob,
                                               generator)
            if idx in self._reductions:
                endpoints.append(x)
        return endpoints  # [reduction_1 .. reduction_5]
