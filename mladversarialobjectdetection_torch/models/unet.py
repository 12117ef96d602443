"""Attention U-Net defender (patch detection and background recovery) in PyTorch.

Port of `mladversarialobjectdetection_tpu/models/unet.py` (reference
generator.py:17-261): four encoder ConvBlocks of n_filters * 2^i filters, a
bottleneck block, four decoder blocks (transposed conv, attention-gated skip,
ConvBlock), leaky ReLU, BatchNorm, dropout, and a 1x1 tanh head giving a
3-channel "update". The module names are Flax's, so `ckpt/bridge.py` maps a
Flax variable tree onto them by a rename.

Tensors are NCHW inside; `PatchNeutralizer` takes and returns NHWC images,
the JAX layout. Where Flax and PyTorch differ, the port follows Flax:

- BatchNorm (`batch_norm`): eps 1e-3 and momentum 0.99 (Keras'); in train
  mode it normalizes by the batch statistics, with the variance as
  E[x^2] - E[x]^2 clipped at 0 (Flax's `use_fast_variance`), and the running
  variance moves by that biased variance (torch's `BatchNorm2d` moves by the
  unbiased one, and its momentum 0.1 is Flax's 0.9);
- leaky ReLU slope 0.2 (torch's default is 0.01);
- `ConvTranspose` is Flax's `nn.ConvTranspose(3, strides=2, padding="SAME")`
  with `transpose_kernel=False`: the input zero-dilated, padded (2, 1) and
  cross-correlated with the unflipped kernel. `F.conv_transpose2d` pads
  (2, 2) and flips, so the port hands it the flipped kernel and drops the
  last row and column;
- dropout (`dropout`) draws its keep mask from an explicit generator.

The ConvBlocks of at most `CMCONV_MAX_FILTERS` filters (the 640x640 and
320x320 stages at n_filters 8) run their 3x3 convs through `ops/cmconv.py`:
on the card the hand-written CUDA kernel `csrc/cmconv.cu` (bf16:
`csrc/cmconv_bf16.cu`), forward and input gradient. The choice is static,
by channel count, made when the block is built.

`dtype` (None: float32; torch.bfloat16 under mixed precision) is Flax's
`dtype=`, module by module, with explicit casts (never autocast): the images
are cast to it at entry; every conv casts its input, kernel and bias to it,
convolves in it and adds the bias in it (`efficientnet.Conv2d`; `CMConv2d`
hands the kernel the bf16 input and the kernel rounded to bf16, held in
float32); BatchNorm computes its statistics and its normalisation in
float32 and rounds once to the dtype, its running statistics float32; leaky
ReLU, sigmoid, the gate product, the concat, max-pool and dropout stay in
the dtype, their constants (0.2, the keep rate) rounded to it as JAX's weak
types are; the head's tanh is taken in it and then cast to float32. The
cached casts of the convs' weights keep their autograd edge: they are
recast on every call while gradients are on and the weights require one.

Spatial partitioning (`parallel/spatial.py`, JAX's GSPMD row sharding of
the U-Net's convs): under a mesh whose 'spatial' axis is larger than 1, the
modules take `height`, their input's global height, and hold the rows the
layout rule gives each level. The 3x3 convs read one row from each
neighbour: `CMConv2d` runs its kernel on its shard extended by one row at
each side (zeros at the image's edges) and crops one output row at each
side (`spatial.halo_rows`), `Conv2d` through `spatial.same_window`; the
transposed conv reads one input row above its shard (`ConvTranspose`); the
max pool is local, gathered where the pooled level is replicated; the 1x1
convs are local; the BatchNorms of a row-sharded level take their
statistics over data x spatial; the dropout masks are drawn at the global
shape (`spatial.draw_rows`).

`remat` (JAX unet.py:126-139, `nn.remat` of every ConvBlock and
DeconvBlock) recomputes each block in the backward pass instead of storing
its activations (`torch.utils.checkpoint`, non-reentrant). The recompute
must be the same function: it draws its dropout masks from a generator
restored to the state the block's first pass started from (checkpoint's
`preserve_rng_state` restores only the global generators, not the explicit
one the masks come from), and its BatchNorms do not move their running
statistics a second time (Flax is functional and moves them once). Under
a spatial mesh the recompute runs the same halo exchanges and statistics'
all-reduces on every rank, in the same order.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cmconv import cmconv
from ..parallel import spatial
from .efficientnet import (BN_MOMENTUM, Conv2d, checkpointed, out_height,
                           set_compute_dtype)
from .efficientnet import BatchNorm as _BatchNorm
from .efficientnet import _recompute, batch_norm, recomputing  # noqa: F401

LEAKY_SLOPE = 0.2
BN_EPS = 1e-3
CMCONV_MAX_FILTERS = 16
HE_INIT = "he_truncated"       # variance_scaling(2.0, fan_in, truncated_normal)
LECUN_INIT = "fan_in_truncated"  # Flax's default lecun_normal


class BatchNorm(_BatchNorm):
    """Flax BatchNorm (`efficientnet.BatchNorm`, shared with the detector);
    Flax names the U-Net's `bn1`..`bn3` directly, with no inner `bn`
    wrapper."""

    FLAX_INNER_BN = False


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            height: Optional[int] = None) -> torch.Tensor:
    """Flax `nn.Dropout` in train mode: keep each unit with probability
    1 - rate and scale it by 1 / (1 - rate). Under an active mesh the mask
    is this rank's rows of the global batch's draw at x's global `height`
    (`spatial.draw_rows`)."""
    keep = 1.0 - rate
    c, w = x.shape[1], x.shape[3]
    mask = spatial.draw_rows(
        lambda n, h: torch.rand((n, c, h, w), generator=generator,
                                device=x.device),
        x.shape[0], x.shape[2] if height is None else height) < keep
    return torch.where(mask, x / _weak(keep, x), torch.zeros_like(x))


def _weak(value: float, x: torch.Tensor):
    """A Python constant as JAX's weak type meets x: rounded to x's dtype
    where that is bf16 (torch would keep it float32 inside the op)."""
    if x.dtype == torch.bfloat16:
        return torch.tensor(value, dtype=x.dtype, device=x.device)
    return value


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:  # jnp.where(x >= 0, x, bf16(0.2) * x)
        return torch.where(x >= 0, x, x * _weak(LEAKY_SLOPE, x))
    return F.leaky_relu(x, LEAKY_SLOPE)


class CMConv2d(Conv2d):
    """A 3x3 stride-1 SAME conv run by `ops/cmconv.cmconv` (the CUDA kernel
    on the card); the weight stays OIHW like every other conv of the port.
    At bf16 the op takes the bf16 input, the kernel rounded to bf16 and held
    in float32 (the TPU kernel's float32 w), and the bias in bf16. Under a
    spatial mesh (`height`: x's global height) the kernel runs on x's shard
    and a halo row at each side (`spatial.halo_rows`)."""

    def forward(self, x: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
        return spatial.halo_rows(x, height, 1, self._conv)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return cmconv(x.contiguous(), self.weight.permute(2, 3, 1, 0),
                          self.bias)
        weight, bias = self._in_dtype(cd)
        return cmconv(x.to(cd).contiguous(),
                      weight.to(torch.float32).permute(2, 3, 1, 0), bias)


class ConvTranspose(Conv2d):
    """Flax `nn.ConvTranspose(out, (3, 3), strides=(2, 2))`, padding SAME.

    `weight` is [out, in, 3, 3], the Flax kernel [3, 3, in, out] in OIHW like
    every conv of the port; forward flips it in both spatial axes and swaps
    its channel axes into the [in, out, 3, 3] form `F.conv_transpose2d`
    takes."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 bias: bool = True, init: str = HE_INIT):
        super().__init__(in_channels, out_channels, 3, bias=bias, init=init)

    def forward(self, x: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
        """x [B, Ci, h, w] -> [B, Co, 2h, 2w]. Under a spatial mesh
        (`height`: x's global height) output rows [o_lo, o_hi) read input
        rows [(o_lo - 1) // 2, (o_hi + 1) // 2): for a sharded x's rows
        [2lo, 2hi), its own and one row above; a replicated x's output may
        split at an odd row (`spatial.window`)."""
        if height is None or spatial.active() is None:
            return self._rows(x, 0, 2 * x.shape[2], 0)
        return spatial.window(x, height, 2 * height,
                              lambda o_lo, o_hi: ((o_lo - 1) // 2, (o_hi + 1) // 2),
                              self._rows)

    def _rows(self, xe: torch.Tensor, o_lo: int, o_hi: int, lo: int) -> torch.Tensor:
        """Output rows [o_lo, o_hi) from xe, the input's rows from `lo` on."""
        crop = (slice(None), slice(None), slice(o_lo - 2 * lo, o_hi - 2 * lo),
                slice(0, 2 * xe.shape[3]))
        cd = self.compute_dtype
        if cd is None:
            weight = self.weight.flip(2, 3).transpose(0, 1)
            return F.conv_transpose2d(xe, weight, self.bias, stride=2)[crop]
        weight, bias = self._in_dtype(cd)
        y = F.conv_transpose2d(xe.to(cd), weight.flip(2, 3).transpose(0, 1),
                               None, stride=2)[crop]
        return y if bias is None else y + bias.view(1, -1, 1, 1)


class ConvBlock(nn.Module):
    """Two 3x3 conv + BN + leaky ReLU (generator.py:153-214)."""

    def __init__(self, in_channels: int, n_filters: int, *,
                 batchnorm: bool = True, dropout: Optional[float] = None,
                 maxpool: bool = True):
        super().__init__()
        conv = CMConv2d if n_filters <= CMCONV_MAX_FILTERS else Conv2d
        self.cnv1 = conv(in_channels, n_filters, 3, init=HE_INIT)
        self.cnv2 = conv(n_filters, n_filters, 3, init=HE_INIT)
        if batchnorm:
            self.bn1 = BatchNorm(n_filters, eps=BN_EPS)
            self.bn2 = BatchNorm(n_filters, eps=BN_EPS)
        self.batchnorm = batchnorm
        self.dropout = dropout
        self.maxpool = maxpool

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None,
                height: Optional[int] = None):
        for j in (1, 2):
            x = getattr(self, f"cnv{j}")(x, height)
            if self.batchnorm:
                x = getattr(self, f"bn{j}")(x, training, height)
            x = leaky_relu(x)
        drop = self.dropout and training
        if self.maxpool:
            f = max_pool(x, height)
            if drop:
                f = dropout(f, self.dropout, generator, out_height(height, 2))
            return x, f  # (skip, downsampled)
        return dropout(x, self.dropout, generator, height) if drop else x


def max_pool(x: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
    """2x2/2 max pool; under a spatial mesh (`height`: x's global height)
    local to each shard, gathered where the pooled level is replicated."""
    pool = lambda xe: F.max_pool2d(xe, 2, 2)
    if height is None or spatial.active() is None:
        return pool(x)
    return spatial.same_window(x, height, 2, 2, 0, pool)


class AttentionBlock(nn.Module):
    """Convolutional attention gating (generator.py:99-150)."""

    def __init__(self, n_filters: int):
        super().__init__()
        self.cnv1 = Conv2d(n_filters, n_filters, 1, init=LECUN_INIT)
        self.bn1 = BatchNorm(n_filters, eps=BN_EPS)
        self.cnv2 = Conv2d(n_filters, n_filters, 1, init=LECUN_INIT)
        self.bn2 = BatchNorm(n_filters, eps=BN_EPS)
        self.conv3 = Conv2d(n_filters, 1, 1, init=LECUN_INIT)
        self.bn3 = BatchNorm(1, eps=BN_EPS)

    def forward(self, up_in: torch.Tensor, skip_in: torch.Tensor,
                training: bool = False, height: Optional[int] = None) -> torch.Tensor:
        g = self.bn1(self.cnv1(up_in), training, height)
        x = self.bn2(self.cnv2(skip_in), training, height)
        x = leaky_relu(g + x)
        x = torch.sigmoid(self.bn3(self.conv3(x), training, height))
        return skip_in * x


class DeconvBlock(nn.Module):
    """Transposed-conv upsample, attention-gated skip concat, ConvBlock
    (generator.py:217-261)."""

    def __init__(self, in_channels: int, n_filters: int, *,
                 dropout: Optional[float] = None, batchnorm: bool = True,
                 attention: bool = True):
        super().__init__()
        self.cnv = ConvTranspose(in_channels, n_filters)
        if attention:
            self.attention = AttentionBlock(n_filters)
        self.use_attention = attention
        self.dropout = dropout
        self.convblock = ConvBlock(2 * n_filters, n_filters, maxpool=False,
                                   batchnorm=batchnorm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                training: bool = False,
                generator: torch.Generator | None = None,
                height: Optional[int] = None) -> torch.Tensor:
        """`height`: x's global height (the skip's is twice it)."""
        up = None if height is None else 2 * height
        x = self.cnv(x, height)
        if self.use_attention:
            skip = self.attention(x, skip, training, up)
        x = torch.cat([x, skip], dim=1)
        if self.dropout and training:
            x = dropout(x, self.dropout, generator, up)
        return self.convblock(x, training, height=up)


def remat_call(block: nn.Module, tensors, training: bool,
               generator: torch.Generator | None):
    """`block(*tensors, training, generator)` with its activations
    recomputed in the backward pass: the recompute replays the first pass's
    dropout masks from a generator restored to the state that pass started
    from, and moves no BatchNorm statistics."""
    snapshot = None if generator is None else generator.get_state()
    first = [True]

    def run(*args):
        gen = generator
        if not first[0] and generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(snapshot)
        first[0] = False
        return block(*args, training, gen)

    return checkpointed(run, *tensors)


def global_height(images: torch.Tensor, height: Optional[int]) -> Optional[int]:
    """The global height of NHWC `images` under the active spatial mesh
    (`height`, or their rows times the spatial group's size), checked
    against the rows they hold; None without a spatial mesh."""
    sp = spatial.active()
    if sp is None:
        return None
    height = images.shape[1] * sp.size if height is None else int(height)
    spatial.check_rows(images, height, dim=1)
    return height


class PatchNeutralizer(nn.Module):
    """Attention U-Net + 1x1 tanh head (generator.py:17-96).

    The output is the defender's "update": 2 * output added to the input
    image neutralizes the patches it finds (attack_detection.py:190).
    `dtype` and `remat`: see the module notes; the output is float32
    (float64 where the U-Net computes in float64)."""

    def __init__(self, n_filters: int = 8, dropout: float = 0.2,
                 batchnorm: bool = True, remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat = remat
        nf = n_filters
        chans = 3
        for i in range(4):
            self.add_module(f"conv{i}", ConvBlock(
                chans, nf * 2 ** i, batchnorm=batchnorm, dropout=dropout))
            chans = nf * 2 ** i
        self.conv4 = ConvBlock(chans, nf * 16, batchnorm=batchnorm,
                               maxpool=False)
        chans = nf * 16
        for i, m in enumerate((8, 4, 2, 1)):
            self.add_module(f"deconv{i}", DeconvBlock(
                chans, nf * m, dropout=dropout, batchnorm=batchnorm))
            chans = nf * m
        self.output = Conv2d(chans, 3, 1, init=HE_INIT)
        self.dtype = None if dtype == torch.float32 else dtype
        set_compute_dtype(self, self.dtype)

    def _block(self, name: str, tensors, training, generator, height):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return remat_call(functools.partial(block, height=height), tensors,
                              training, generator)
        return block(*tensors, training, generator, height)

    def forward(self, images: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None,
                height: Optional[int] = None) -> torch.Tensor:
        """[B, H, W, 3] -> update [B, H, W, 3] in (-1, 1); H, W divisible
        by 16.

        `generator` draws the dropout masks in train mode. Under a spatial
        mesh, images are this rank's rows of images `height` rows high
        (default: its rows times the spatial group's size), and so is the
        update."""
        height = global_height(images, height)
        x = images.permute(0, 3, 1, 2).contiguous()
        if self.dtype is not None:
            x = x.to(self.dtype)
        skips = []
        for i in range(4):
            skip, x = self._block(f"conv{i}", (x,), training, generator, height)
            skips.append(skip)
            height = out_height(height, 2)
        x = self._block("conv4", (x,), training, generator, height)
        for i, skip in enumerate(reversed(skips)):
            x = self._block(f"deconv{i}", (x, skip), training, generator, height)
            height = None if height is None else 2 * height
        y = torch.tanh(self.output(x))
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        return y.permute(0, 2, 3, 1)
