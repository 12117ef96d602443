"""Space-to-depth packed attention U-Net defender in PyTorch.

Port of `mladversarialobjectdetection_tpu/models/unet_packed.py`: the same
function as `models/unet.PatchNeutralizer` on the same parameters (the
module and parameter names are the unpacked module's, so `ckpt/bridge.py`
loads the same Flax variables into either and `antipatch.pkl` is the same
file), with the high-resolution stages computed in a space-to-depth packed
layout: a [B, 8, 640, 640] activation becomes [B, 32, 320, 320].

The JAX package packs to cut the TPU's lane padding of 8-channel tensors.
On a card the packed 3x3 conv is a dense conv over a block kernel of which
36 of every 144 entries are non-zero (`pack_conv3_kernel`), 4x the
multiply-adds of the unpacked conv, and the sub-pixel transposed conv's
kernel has 9 of 16 non-zero. The port carries the layout for parity with
the JAX package, not for speed: on an H100 it is slower than the unpacked
module at every packed depth (PERF.md), where the TPU gained.

- 3x3 SAME conv -> a 3x3 SAME conv on the packed grid with the block kernel
  [3, 3, 4Ci, 4Co] built from the original [3, 3, Ci, Co] (`packed_conv3`).
  Where both packed channel counts are at most `ops/cmconv_cuda.MAX_CHANNELS`
  (level 1's 12 -> 32 and 32 -> 32) it runs `ops/cmconv.cmconv`, on the card
  the hand-written kernel (float32 or bf16 instance); otherwise `F.conv2d`
  (the JAX package computes all of these with XLA, outside any Pallas
  kernel).
- ConvTranspose stride 2 -> a 2x2 conv from the unpacked input to the packed
  output, padded ((1, 0), (1, 0)) (`packed_convT`).
- 2x2/2 max-pool -> max over the 4 phases (`phase_max`).
- BatchNorm -> phase-grouped statistics over (B, phase, h, w) (`PackedBN`),
  float32, with [C] parameters and running statistics as before.
- 1x1 convs -> per phase (`packed_1x1`, a grouped conv of 4 groups).

Spatial partitioning (`parallel/spatial.py`; `models/unet.py` says how the
unpacked stages run): `height` is each tensor's own global height (a packed
level's is half its image's). `space_to_depth` / `depth_to_space` are local
on even shard heights (gathered or sliced where the packed level is
replicated and the image level is not), the packed 3x3 conv runs on its
shard and one packed row from each neighbour (`spatial.halo_rows`; cmconv or
`F.conv2d`, as above), the sub-pixel transposed conv reads one input row
above its shard, `phase_max` and the 1x1 convs are local, `PackedBN` takes
its statistics over data x spatial for a row-sharded level, and the dropout
masks are drawn over the global packed shape.

Dropout in the packed deconv blocks draws its masks over the packed shape,
so its masks differ from the unpacked module's by design (the same iid
Bernoulli distribution; JAX unet_packed.py:30-33). `dtype` follows
`models/unet.py`'s rules.

Layout: NCHW inside, NHWC at the module's edges. A packed tensor is [B, 4C,
H/2, W/2] with channel index (p*2 + q)*C + c, where (p, q) is the pixel's
offset inside its 2x2 block (JAX unet_packed.py:41-42).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cmconv import cmconv
from ..ops.cmconv_cuda import MAX_CHANNELS as CMCONV_MAX_CHANNELS
from ..parallel import spatial
from .efficientnet import Conv2d, batch_stats, set_compute_dtype
from .unet import (BN_MOMENTUM, HE_INIT, LECUN_INIT, BatchNorm, ConvBlock,
                   ConvTranspose, DeconvBlock, dropout, global_height,
                   leaky_relu, recomputing)


# -- packed layout helpers ---------------------------------------------------

def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2] (phase-major channel packing)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """[B, 4C, H/2, W/2] -> [B, C, H, W] (inverse of space_to_depth)."""
    b, c4, h, w = y.shape
    c = c4 // 4
    y = y.reshape(b, 2, 2, c, h, w)
    return y.permute(0, 3, 4, 1, 5, 2).reshape(b, c, 2 * h, 2 * w)


def packed_rows(x: torch.Tensor, height: Optional[int]) -> torch.Tensor:
    """`space_to_depth` of x (global height `height`) under the active
    spatial mesh: local where the packed level is row-sharded too, of the
    gathered image where only the image level is."""
    if spatial.sharded(height) and not spatial.sharded(height // 2):
        x = spatial.gather_rows(x)
    return space_to_depth(x)


def unpacked_rows(y: torch.Tensor, height: Optional[int]) -> torch.Tensor:
    """`depth_to_space` of y to an image of global height `height` under the
    active spatial mesh: local where the packed level is row-sharded too,
    this rank's rows of the whole image where only the image level is."""
    x = depth_to_space(y)
    if spatial.sharded(height) and not spatial.sharded(height // 2):
        x = spatial.local_rows(x)
    return x


def _phase_tap_table() -> np.ndarray:
    """T[k, p, P, d] = 1 iff original tap d (of a 3x3 SAME conv) maps to
    packed-grid tap k when the input phase is p and the output phase is P:
    d = 2k + p - P - 1."""
    t = np.zeros((3, 2, 2, 3), np.float32)
    for k in range(3):
        for p in range(2):
            for pp in range(2):
                d = 2 * k + p - pp - 1
                if 0 <= d < 3:
                    t[k, p, pp, d] = 1.0
    return t


def _convT_tap_table() -> np.ndarray:
    """T[kt, P, d] = 1 iff transposed-conv tap d reaches output phase P
    from packed-grid tap kt: d = 2 kt - P."""
    t = np.zeros((2, 2, 3), np.float32)
    for kt in range(2):
        for pp in range(2):
            d = 2 * kt - pp
            if 0 <= d < 3:
                t[kt, pp, d] = 1.0
    return t


_T3 = _phase_tap_table()
_TT = _convT_tap_table()


def pack_conv3_kernel(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, Ci, Co] (HWIO) -> [3, 3, 4Ci, 4Co] packed block kernel (HWIO):
    each (input phase, output phase, tap) routes the original weight, every
    other entry is 0."""
    t = torch.as_tensor(_T3, dtype=w.dtype, device=w.device)
    kh, kw, ci, co = w.shape
    wp = torch.einsum("apPd,bqQe,decf->abpqcPQf", t, t, w)
    return wp.reshape(kh, kw, 4 * ci, 4 * co)


def pack_convT_kernel(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, Ci, Co] ConvTranspose(stride 2, SAME) kernel (Flax's HWIO) ->
    [2, 2, Ci, 4Co] conv kernel (HWIO) from the unpacked input to the packed
    output (JAX unet_packed.py:102-120)."""
    t = torch.as_tensor(_TT, dtype=w.dtype, device=w.device)
    ci, co = w.shape[2], w.shape[3]
    wp = torch.einsum("aPd,bQe,decf->abcPQf", t, t, w)
    return wp.reshape(2, 2, ci, 4 * co)


def _cast(dtype, *tensors):
    return tensors if dtype is None else tuple(t.to(dtype) for t in tensors)


def packed_conv3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 dtype: Optional[torch.dtype],
                 height: Optional[int] = None) -> torch.Tensor:
    """3x3 SAME conv in the packed domain: x [B, 4Ci, h, w], `kernel` the
    original [3, 3, Ci, Co] (HWIO), `bias` [Co] -> [B, 4Co, h, w]. The block
    kernel and the tiled bias are cast to `dtype` (None: as they are), the
    conv computed in it and the bias added in it. Under a spatial mesh
    (`height`: x's global height) it runs on x's shard and a halo row at
    each side (`spatial.halo_rows`)."""
    wp = pack_conv3_kernel(kernel)
    x, wp, bp = _cast(dtype, x, wp, bias.repeat(4))
    if max(wp.shape[2], wp.shape[3]) <= CMCONV_MAX_CHANNELS:
        # cmconv takes w in float32: bf16 values held in float32 at bf16
        wf = wp.to(torch.float32)
        return spatial.halo_rows(x, height, 1,
                                 lambda xe: cmconv(xe.contiguous(), wf, bp))
    conv = lambda xe: F.conv2d(xe, wp.permute(3, 2, 0, 1), None, padding=1)
    return spatial.halo_rows(x, height, 1, conv) + bp.view(1, -1, 1, 1)


def packed_convT(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 dtype: Optional[torch.dtype],
                 height: Optional[int] = None) -> torch.Tensor:
    """ConvTranspose(stride 2, k3, SAME) from unpacked x [B, Ci, h, w] to the
    packed output [B, 4Co, h, w]; `kernel` the Flax [3, 3, Ci, Co]. Output
    row r reads input rows r - 1 and r: under a spatial mesh (`height`: x's
    global height) this rank's and one row above (`spatial.window`)."""
    wp = pack_convT_kernel(kernel)
    x, wp, bp = _cast(dtype, x, wp, bias.repeat(4))
    conv = lambda xe, *_: F.conv2d(F.pad(xe, (1, 0, 0, 0)), wp.permute(3, 2, 0, 1),
                                   None)
    if height is None or spatial.active() is None:
        y = conv(F.pad(x, (0, 0, 1, 0)))
    else:
        y = spatial.window(x, height, height, lambda lo, hi: (lo - 1, hi), conv)
    return y + bp.view(1, -1, 1, 1)


def packed_1x1(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    """1x1 conv applied per phase: x [B, 4Ci, h, w], `kernel` [1, 1, Ci, Co]
    (HWIO), `bias` [Co] -> [B, 4Co, h, w]."""
    w = kernel.reshape(kernel.shape[-2], kernel.shape[-1]).t()  # [Co, Ci]
    x, w, bias = _cast(dtype, x, w, bias)
    co, ci = w.shape
    y = F.conv2d(x, w.reshape(co, ci, 1, 1).repeat(4, 1, 1, 1), None, groups=4)
    return y + bias.repeat(4).view(1, -1, 1, 1)


def phase_max(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool of the underlying image = max over the 4 phases."""
    b, c4, h, w = x.shape
    return x.reshape(b, 4, c4 // 4, h, w).amax(dim=1)


def phase_concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel concat of the underlying images, in the packed layout."""
    n, ca, h, w = a.shape
    cb = b.shape[1]
    y = torch.cat([a.reshape(n, 4, ca // 4, h, w),
                   b.reshape(n, 4, cb // 4, h, w)], dim=2)
    return y.reshape(n, ca + cb, h, w)


def _hwio(conv: Conv2d) -> torch.Tensor:
    """The Flax-layout kernel of a port conv (OIHW weight)."""
    return conv.weight.permute(2, 3, 1, 0)


# -- packed blocks (the unpacked blocks' parameter names and shapes) ----------

class PackedBN(BatchNorm):
    """BatchNorm over packed tensors with phase-grouped statistics
    (JAX unet_packed.py:190-233): [C] parameters and running statistics as
    the unpacked BatchNorm; batch statistics over (B, phase, h, w), the same
    value set the unpacked module reduces over, in float32 (float64 inputs
    keep float64), with Flax's fast variance, momentum .99 and eps 1e-3; the
    output in the compute dtype (None: x's)."""

    def forward(self, x: torch.Tensor, training: bool = False,
                height: Optional[int] = None) -> torch.Tensor:
        out_dtype = x.dtype if self.compute_dtype is None else self.compute_dtype
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if training:
            b, c4, h, w = xf.shape
            xr = xf.reshape(b, 4, c4 // 4, h, w)
            mu, var = batch_stats(xr, (0, 1, 3, 4), self.axis_name, height)
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                            + 0.01 * mu)
                    self.running_var.copy_(BN_MOMENTUM * self.running_var
                                           + 0.01 * var)
        else:
            mu, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, -1, 1, 1)
        y = ((xf - mu.repeat(4).view(shape)) * mul.repeat(4).view(shape)
             + self.bias.repeat(4).view(shape))
        return y.to(out_dtype)


class PackedConvBlock(nn.Module):
    """ConvBlock (two 3x3 conv + BN + leaky ReLU) in the packed domain; with
    maxpool it returns (packed skip, unpacked half-resolution output)."""

    def __init__(self, in_channels: int, n_filters: int, *,
                 batchnorm: bool = True, dropout: Optional[float] = None,
                 maxpool: bool = True):
        super().__init__()
        self.cnv1 = Conv2d(in_channels, n_filters, 3, init=HE_INIT)
        self.cnv2 = Conv2d(n_filters, n_filters, 3, init=HE_INIT)
        if batchnorm:
            self.bn1 = PackedBN(n_filters)
            self.bn2 = PackedBN(n_filters)
        self.batchnorm = batchnorm
        self.dropout = dropout
        self.maxpool = maxpool

    def forward(self, xp: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None,
                height: Optional[int] = None):
        """`height`: xp's global (packed) height, the pooled output's too."""
        for j in (1, 2):
            conv = getattr(self, f"cnv{j}")
            xp = packed_conv3(xp, _hwio(conv), conv.bias, conv.compute_dtype,
                              height)
            if self.batchnorm:
                xp = getattr(self, f"bn{j}")(xp, training, height)
            xp = leaky_relu(xp)
        drop = self.dropout and training
        if self.maxpool:
            f = phase_max(xp)
            if drop:
                f = dropout(f, self.dropout, generator, height)
            return xp, f
        return dropout(xp, self.dropout, generator, height) if drop else xp


class PackedAttention(nn.Module):
    """AttentionBlock in the packed domain: the 1x1 convs per phase, BN3
    normalising the one gate channel over the phases too."""

    def __init__(self, n_filters: int):
        super().__init__()
        self.cnv1 = Conv2d(n_filters, n_filters, 1, init=LECUN_INIT)
        self.bn1 = PackedBN(n_filters)
        self.cnv2 = Conv2d(n_filters, n_filters, 1, init=LECUN_INIT)
        self.bn2 = PackedBN(n_filters)
        self.conv3 = Conv2d(n_filters, 1, 1, init=LECUN_INIT)
        self.bn3 = PackedBN(1)

    def forward(self, up_p: torch.Tensor, skip_p: torch.Tensor,
                training: bool = False, height: Optional[int] = None) -> torch.Tensor:
        conv1x1 = lambda conv, x: packed_1x1(x, _hwio(conv), conv.bias,
                                             conv.compute_dtype)
        g = self.bn1(conv1x1(self.cnv1, up_p), training, height)
        x = self.bn2(conv1x1(self.cnv2, skip_p), training, height)
        x = leaky_relu(g + x)
        x = torch.sigmoid(self.bn3(conv1x1(self.conv3, x), training, height))  # [B, 4, h, w]
        b, c4, h, w = skip_p.shape
        gated = skip_p.reshape(b, 4, c4 // 4, h, w) * x[:, :, None]
        return gated.reshape(b, c4, h, w)


class PackedDeconvBlock(nn.Module):
    """DeconvBlock in the packed domain: the sub-pixel transposed conv from
    the unpacked input straight into the packed layout, packed attention
    gating, the phase-aware concat, a packed ConvBlock."""

    def __init__(self, in_channels: int, n_filters: int, *,
                 dropout: Optional[float] = None, batchnorm: bool = True):
        super().__init__()
        self.cnv = ConvTranspose(in_channels, n_filters)
        self.attention = PackedAttention(n_filters)
        self.dropout = dropout
        self.convblock = PackedConvBlock(2 * n_filters, n_filters,
                                         maxpool=False, batchnorm=batchnorm)

    def forward(self, x: torch.Tensor, skip_p: torch.Tensor,
                training: bool = False,
                generator: torch.Generator | None = None,
                height: Optional[int] = None) -> torch.Tensor:
        """`height`: x's global height, the packed output's too."""
        up_p = packed_convT(x, _hwio(self.cnv), self.cnv.bias,
                            self.cnv.compute_dtype, height)
        skip_p = self.attention(up_p, skip_p, training, height)
        xp = phase_concat(up_p, skip_p)
        if self.dropout and training:
            # the unpacked module's mask distribution, drawn over the packed
            # shape (arrangement differs)
            xp = dropout(xp, self.dropout, generator, height)
        return self.convblock(xp, training, height=height)


class PackedPatchNeutralizer(nn.Module):
    """`PatchNeutralizer` with the high-resolution stages packed
    (JAX unet_packed.py:328-397); the same parameters and output.

    `packed_levels` is how deep the packing reaches (level i runs at H/2^i
    with n_filters * 2^i channels): 1 packs conv0, deconv3 and the head (the
    640x640 stages at 640), 2 also conv1 and deconv2, 3 also conv2 and
    deconv1. A packed decoder stage above level 0 ends with a depth_to_space,
    so that the next stage's sub-pixel transposed conv reads the plain
    layout it expects."""

    def __init__(self, n_filters: int = 8, dropout: float = 0.2,
                 batchnorm: bool = True, packed_levels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if not 1 <= packed_levels <= 3:
            raise ValueError(f"packed_levels must be in 1..3, got {packed_levels}")
        self.packed_levels = packed_levels
        nf = n_filters
        chans = 3
        for i in range(4):
            block = PackedConvBlock if i < packed_levels else ConvBlock
            self.add_module(f"conv{i}", block(
                chans, nf * 2 ** i, batchnorm=batchnorm, dropout=dropout))
            chans = nf * 2 ** i
        self.conv4 = ConvBlock(chans, nf * 16, batchnorm=batchnorm,
                               maxpool=False)
        chans = nf * 16
        for i, m in enumerate((8, 4, 2, 1)):
            block = PackedDeconvBlock if 3 - i < packed_levels else DeconvBlock
            self.add_module(f"deconv{i}", block(
                chans, nf * m, dropout=dropout, batchnorm=batchnorm))
            chans = nf * m
        self.output = Conv2d(chans, 3, 1, init=HE_INIT)
        self.dtype = None if dtype == torch.float32 else dtype
        set_compute_dtype(self, self.dtype)

    def forward(self, images: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None,
                height: Optional[int] = None) -> torch.Tensor:
        """[B, H, W, 3] -> update [B, H, W, 3] in (-1, 1), float32 (float64
        where the U-Net computes in float64); H, W divisible by 16.
        `generator` draws the dropout masks in train mode. Under a spatial
        mesh, images are this rank's rows of images `height` rows high
        (default: its rows times the spatial group's size), and so is the
        update."""
        pl = self.packed_levels
        top = global_height(images, height)
        f = images.permute(0, 3, 1, 2).contiguous()
        if self.dtype is not None:
            f = f.to(self.dtype)
        h = lambda level: None if top is None else top >> level  # level's height
        skips = []
        for i in range(4):
            block = getattr(self, f"conv{i}")
            if i < pl:  # the packed level's height is the pooled one's
                skip, f = block(packed_rows(f, h(i)), training, generator, h(i + 1))
            else:
                skip, f = block(f, training, generator, h(i))
            skips.append(skip)
        f = self.conv4(f, training, generator, h(4))
        for i, skip in enumerate(reversed(skips)):
            level = 3 - i
            f = getattr(self, f"deconv{i}")(f, skip, training, generator,
                                            h(level + 1))
            if level < pl and level > 0:
                f = unpacked_rows(f, h(level))
        yp = packed_1x1(f, _hwio(self.output), self.output.bias, self.dtype)
        y = unpacked_rows(torch.tanh(yp), top)
        return y.to(torch.promote_types(y.dtype, torch.float32)).permute(0, 2, 3, 1)

