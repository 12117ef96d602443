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

`remat` (JAX unet.py:126-139, `nn.remat` of every ConvBlock and
DeconvBlock) recomputes each block in the backward pass instead of storing
its activations (`torch.utils.checkpoint`, non-reentrant). The recompute
must be the same function: it draws its dropout masks from a generator
restored to the state the block's first pass started from (checkpoint's
`preserve_rng_state` restores only the global generators, not the explicit
one the masks come from), and its BatchNorms do not move their running
statistics a second time (Flax is functional and moves them once).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ops.cmconv import cmconv
from ..parallel import spatial
from .efficientnet import BN_MOMENTUM, Conv2d, checkpointed, set_compute_dtype
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


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax `nn.Dropout` in train mode: keep each unit with probability
    1 - rate and scale it by 1 / (1 - rate). Under an active mesh the mask
    is this rank's rows of the global batch's draw (`parallel.draw_rows`)."""
    keep = 1.0 - rate
    mask = parallel.draw_rows(
        lambda n: torch.rand((n, *x.shape[1:]), generator=generator,
                             device=x.device), x.shape[0]) < keep
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
    in float32 (the TPU kernel's float32 w), and the bias in bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        cd = self.compute_dtype
        if cd is None:
            weight = self.weight.flip(2, 3).transpose(0, 1)
            y = F.conv_transpose2d(x, weight, self.bias, stride=2)
            return y[..., :2 * h, :2 * w]
        weight, bias = self._in_dtype(cd)
        y = F.conv_transpose2d(x.to(cd), weight.flip(2, 3).transpose(0, 1),
                               None, stride=2)[..., :2 * h, :2 * w]
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
                generator: torch.Generator | None = None):
        for j in (1, 2):
            x = getattr(self, f"cnv{j}")(x)
            if self.batchnorm:
                x = getattr(self, f"bn{j}")(x, training)
            x = leaky_relu(x)
        drop = self.dropout and training
        if self.maxpool:
            f = F.max_pool2d(x, 2, 2)
            if drop:
                f = dropout(f, self.dropout, generator)
            return x, f  # (skip, downsampled)
        return dropout(x, self.dropout, generator) if drop else x


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
                training: bool = False) -> torch.Tensor:
        g = self.bn1(self.cnv1(up_in), training)
        x = self.bn2(self.cnv2(skip_in), training)
        x = leaky_relu(g + x)
        x = torch.sigmoid(self.bn3(self.conv3(x), training))
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
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.cnv(x)
        if self.use_attention:
            skip = self.attention(x, skip, training)
        x = torch.cat([x, skip], dim=1)
        if self.dropout and training:
            x = dropout(x, self.dropout, generator)
        return self.convblock(x, training)


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


class PatchNeutralizer(nn.Module):
    """Attention U-Net + 1x1 tanh head (generator.py:17-96).

    The output is the defender's "update": 2 * output added to the input
    image neutralizes the patches it finds (attack_detection.py:190).
    `dtype` and `remat`: see the module notes; the output is float32."""

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

    def _block(self, name: str, tensors, training, generator):
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return remat_call(block, tensors, training, generator)
        return block(*tensors, training, generator)

    def forward(self, images: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """[B, H, W, 3] -> update [B, H, W, 3] in (-1, 1), float32; H, W
        divisible by 16.

        `generator` draws the dropout masks in train mode. Under a spatial
        mesh it raises (ROADMAP Queue 1 item 10)."""
        if spatial.active() is not None:
            raise NotImplementedError(parallel.SPATIAL_NOT_PORTED)
        x = images.permute(0, 3, 1, 2).contiguous()
        if self.dtype is not None:
            x = x.to(self.dtype)
        skips = []
        for i in range(4):
            skip, x = self._block(f"conv{i}", (x,), training, generator)
            skips.append(skip)
        x = self._block("conv4", (x,), training, generator)
        for i, skip in enumerate(reversed(skips)):
            x = self._block(f"deconv{i}", (x, skip), training, generator)
        y = torch.tanh(self.output(x)).to(torch.float32)
        return y.permute(0, 2, 3, 1)
