"""Space-to-depth packed EfficientNet entry blocks in PyTorch.

Port of `mladversarialobjectdetection_tpu/models/efficientnet_packed.py`:
the same network as `models/efficientnet.EfficientNet` on the same
parameters, with the stem and the first `packed_blocks` blocks computed in
a 2x2 space-to-depth layout, [B, C, H, W] -> [B, 4C, H/2, W/2]. The JAX
package packs to cut the TPU's lane padding of the C < 128 entry stages; a
card pads no lane, so the port carries the layout for parity with the JAX
package and measures it (PERF.md), as it does the packed U-Net.

`PackedEntryEfficientNet` is an `EfficientNet`: it owns the same
`stem_conv`, `stem_bn` and `blocks_{i}` submodules, so its `state_dict`
keys and shapes are `EfficientNet`'s and `ckpt/bridge.py`, every
checkpoint file and the converters serve both. The packed forward is
computed from those modules' parameters; blocks at or past `packed_blocks`
call `MBConvBlock.forward` unchanged (the fused kernels in eval).

Layout (JAX efficientnet_packed.py:16-41): NCHW, a packed tensor is
[B, 4C, h, w] with channel (p*2 + q)*C + c (phase-major, as
`models/unet_packed.py`), which is memory-identical to [4B, C, h, w].
So:

- the stem's stride-2 conv is a stride-4 conv writing the packed layout
  directly ([4S, 3, 5, 5] kernel holding the [S, 3, 3, 3] weights at the four
  phase offsets, padded (0, 1): `pack_stem_kernel`);
- 1x1 expand / project convs run per phase as one conv over the [4B, C, h, w]
  view (`packed_1x1`);
- BatchNorm takes phase-grouped statistics over (B, phase, h, w), the set
  the unpacked BatchNorm reduces over: the block's own `BatchNorm` applied
  to the [4B, C, h, w] view (`packed_bn`; Flax's E[x^2] - E[x]^2 clipped at 0,
  momentum .99, in float32, its output in the compute dtype);
- a stride-1 depthwise conv is a grouped conv (groups C, 4 in and 4 out
  channels per group) on the channel-major view (channel c*4 + phase,
  `pm_to_cm`) with the [4C, 4, pk, pk] kernel of `pack_dw_kernel_s1`;
- a stride-2 depthwise conv leaves the packed layout: a stride-1 grouped
  conv from the channel-major packed grid straight to the unpacked
  half-resolution output (`pack_dw_kernel_s2`), after which the block and
  the next ones run unpacked until a later block in the range packs again
  (`space_to_depth`);
- squeeze-excite pools over the phases too (`packed_se`).

Spatial partitioning (`parallel/spatial.py`): under a mesh whose 'spatial'
axis is larger than 1, `forward` takes `height`, the images' global height,
and every packed tensor is laid out by the layout rule on its global
*packed* height (one packed row is two rows of its unpacked level), every
unpacked one on its image height. The stem and the packed depthwise convs
read rows across the shard edge and take them from their neighbours
(`spatial.same_window` in packed rows: the stem's stride-4 5x5 conv padded
(0, 1), the stride-1 and stride-2 grouped convs); the 1x1 convs, BatchNorm,
`space_to_depth` and `depth_to_space` stay local, since a level's shard
packs into its packed shard; `packed_se` pools over the spatial group; the
blocks past the packed range take their global heights, so the fused ones
run on halo-extended shards. A level whose shard does not pack into a
packed shard (odd rows a rank, or packed shards under `spatial.MAX_HALO`
rows) raises `ValueError`.

Mixed precision follows the JAX module (:368-371, :169-172, :236-245): the
input is cast once to the compute dtype (`stem_conv.compute_dtype`), each
conv runs in x's dtype with its kernel cast to it, each BatchNorm computes in
float32 and returns the compute dtype, and the squeeze-excite gate is cast
to x's dtype.

The packed kernels are built from the weights and cached per block and
dtype, rebuilt when a weight changes (its storage or version); where
gradients are on and a weight requires one they are built with autograd on
every call, and under `torch.export` traced as ops (the rules of
`MBConvBlock.folded`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..parallel import spatial
from .efficientnet import (BackboneSpec, BatchNorm, EfficientNet, MBConvBlock,
                           SqueezeExcite, activation, drop_connect, out_height)
from .unet_packed import depth_to_space, space_to_depth


# -- layout helpers ------------------------------------------------------------

def pm_to_cm(xp: torch.Tensor) -> torch.Tensor:
    """Phase-major [B, 4C, h, w] (channel ph*C + c) -> channel-major (c*4 + ph)."""
    b, c4, h, w = xp.shape
    return xp.reshape(b, 4, c4 // 4, h, w).transpose(1, 2).reshape(b, c4, h, w)


def cm_to_pm(xc: torch.Tensor) -> torch.Tensor:
    """Channel-major [B, 4C, h, w] (c*4 + ph) -> phase-major (ph*C + c)."""
    b, c4, h, w = xc.shape
    return xc.reshape(b, c4 // 4, 4, h, w).transpose(1, 2).reshape(b, c4, h, w)


# -- packed kernels (einsums against constant 0/1 maps: exact copies) ---------

def _dw_map_s1(k: int) -> np.ndarray:
    """[pk, pk, 4 (input phase), 4 (output phase), k, k] 0/1 map of the s1
    packed depthwise (JAX :95-110)."""
    r = k // 2
    lo = (0 - r) // 2
    hi = (1 + r) // 2
    pk = hi - lo + 1
    ctr = -lo
    m = np.zeros((pk, pk, 4, 4, k, k), np.float32)
    for p in range(2):
        for q in range(2):
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    ip, iq = (p + dy) % 2, (q + dx) % 2
                    ty, tx = (p + dy) // 2 + ctr, (q + dx) // 2 + ctr
                    m[ty, tx, ip * 2 + iq, p * 2 + q, dy + r, dx + r] = 1.0
    return m


def _dw_map_s2(k: int) -> Tuple[np.ndarray, int, int]:
    """[pk, pk, 4 (input phase), k, k] map of the s2 packed -> unpacked
    depthwise and the (low, high) padding of its stride-1 conv (JAX
    :113-131): Flax "SAME" s2 on an even size pads (k - 2) // 2 low, so
    output o reads unpacked row 2o + t - pad_lo, packed row o + (t -
    pad_lo) // 2 at phase (t - pad_lo) % 2."""
    pad_lo = (k - 2) // 2
    offs = [(t - pad_lo) // 2 for t in range(k)]
    lo, hi = min(offs), max(offs)
    pk = hi - lo + 1
    m = np.zeros((pk, pk, 4, k, k), np.float32)
    for dy in range(k):
        for dx in range(k):
            ip = (dy - pad_lo) % 2
            iq = (dx - pad_lo) % 2
            m[offs[dy] - lo, offs[dx] - lo, ip * 2 + iq, dy, dx] = 1.0
    return m, -lo, hi


def pack_dw_kernel_s1(w: torch.Tensor) -> torch.Tensor:
    """Depthwise weight [C, 1, k, k] -> the channel-major grouped kernel
    [4C, 4, pk, pk] (groups C: output c*4 + out phase, input in phase)."""
    c, _, k, _ = w.shape
    m = torch.as_tensor(_dw_map_s1(k), dtype=w.dtype, device=w.device)
    kp = torch.einsum("tuioyx,cyx->coitu", m, w[:, 0])
    return kp.reshape(4 * c, 4, m.shape[0], m.shape[1])


def pack_dw_kernel_s2(w: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Stride-2 depthwise weight [C, 1, k, k] -> (the grouped kernel [C, 4,
    pk, pk] of the stride-1 packed -> unpacked conv, pad_lo, pad_hi)."""
    m, pad_lo, pad_hi = _dw_map_s2(w.shape[-1])
    m = torch.as_tensor(m, dtype=w.dtype, device=w.device)
    return torch.einsum("tuiyx,cyx->citu", m, w[:, 0]), pad_lo, pad_hi


def pack_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """Stride-2 stem [S, Ci, 3, 3] -> the stride-4 packed-output kernel
    [4S, Ci, 5, 5]: output phase (p, q) is the s2 conv at input offset (2p,
    2q) (JAX :154-166)."""
    return torch.cat([F.pad(w, (2 * q, 2 - 2 * q, 2 * p, 2 - 2 * p))
                      for p in range(2) for q in range(2)], dim=0)


# -- packed ops ---------------------------------------------------------------

def _phases(xp: torch.Tensor) -> torch.Tensor:
    """The [4B, C, h, w] view of a packed [B, 4C, h, w] tensor."""
    b, c4, h, w = xp.shape
    return xp.reshape(4 * b, c4 // 4, h, w)


def _unphases(x: torch.Tensor, b: int) -> torch.Tensor:
    _, c, h, w = x.shape
    return x.reshape(b, 4 * c, h, w)


def packed_1x1(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free 1x1 conv [Co, Ci, 1, 1] per phase of a packed tensor, in
    x's dtype (JAX :175-181)."""
    return _unphases(F.conv2d(_phases(xp), w.to(xp.dtype)), xp.shape[0])


def packed_bn(bn: BatchNorm, xp: torch.Tensor, training: bool,
              height: Optional[int] = None) -> torch.Tensor:
    """The unpacked `BatchNorm` on a packed tensor: statistics over (B,
    phase, h, w), [C] parameters and running statistics (JAX :195-245);
    `height`: xp's global packed height under a spatial mesh."""
    return _unphases(bn(_phases(xp), training, height), xp.shape[0])


def _on_rows(height: Optional[int]) -> bool:
    """Whether a conv of an input of global `height` runs on rows under an
    active spatial group."""
    return height is not None and spatial.active() is not None


def packed_dw_s1(xp: torch.Tensor, kp: torch.Tensor,
                 height: Optional[int] = None) -> torch.Tensor:
    """Stride-1 depthwise conv of a packed tensor, `kp` from
    `pack_dw_kernel_s1`; stays packed. `height`: xp's global packed height
    under a spatial mesh (its rows and a packed halo row a side)."""
    pk = kp.shape[-1]
    pad, groups, kp = (pk - 1) // 2, xp.shape[1] // 4, kp.to(xp.dtype)
    if not _on_rows(height):
        return cm_to_pm(F.conv2d(pm_to_cm(xp), kp, padding=pad, groups=groups))
    conv = lambda xe: F.conv2d(F.pad(xe, (pad, pad, 0, 0)), kp, groups=groups)
    return cm_to_pm(spatial.same_window(pm_to_cm(xp), height, pk, 1, pad, conv))


def packed_dw_s2(xp: torch.Tensor, kp: torch.Tensor, pad_lo: int,
                 pad_hi: int, height: Optional[int] = None) -> torch.Tensor:
    """Stride-2 depthwise conv of a packed tensor, `kp` from
    `pack_dw_kernel_s2`: the unpacked half-resolution output, as many rows
    as xp has packed rows. `height`: xp's global packed height under a
    spatial mesh."""
    groups, kp = xp.shape[1] // 4, kp.to(xp.dtype)
    if not _on_rows(height):
        pads = (pad_lo, pad_hi, pad_lo, pad_hi)
        return F.conv2d(F.pad(pm_to_cm(xp), pads), kp, groups=groups)
    conv = lambda xe: F.conv2d(F.pad(xe, (pad_lo, pad_hi, 0, 0)), kp, groups=groups)
    return spatial.same_window(pm_to_cm(xp), height, kp.shape[-1], 1, pad_lo, conv)


def packed_stem(x: torch.Tensor, kp: torch.Tensor,
                height: Optional[int] = None) -> torch.Tensor:
    """The stride-2 stem on unpacked images, written packed. `height`: the
    images' global height under a spatial mesh (packed output row o reads
    image rows [4o, 4o + 5), the row past the last one a zero)."""
    kp = kp.to(x.dtype)
    if not _on_rows(height):
        return F.conv2d(F.pad(x, (0, 1, 0, 1)), kp, stride=4)
    conv = lambda xe: F.conv2d(F.pad(xe, (0, 1, 0, 0)), kp, stride=4)
    return spatial.same_window(x, height, kp.shape[-1], 4, 0, conv)


def packed_se(se: SqueezeExcite, xp: torch.Tensor,
              height: Optional[int] = None) -> torch.Tensor:
    """Squeeze-excite of a packed tensor: the mean over the phases and the
    map, the module's own convs, the gate on every phase (JAX :263-283).
    `height`: xp's global packed height; where the layout shards it, the
    mean sums over the spatial group's rows."""
    b, c4, h, w = xp.shape
    x5 = xp.reshape(b, 4, c4 // 4, h, w)
    if spatial.sharded(height):
        pooled = parallel.all_reduce_sum(
            x5.sum(dim=(1, 3, 4)), parallel.SPATIAL_AXIS) / (4 * height * w)
    else:
        pooled = x5.mean(dim=(1, 3, 4))
    s = activation(se.reduce(pooled[:, :, None, None]), se.act_type)
    gate = torch.sigmoid(se.expand(s)).to(xp.dtype)
    return (x5 * gate[:, None]).reshape(b, c4, h, w)


def check_packable(height: Optional[int]) -> None:
    """Raise unless a level of global `height` rows packs shard by shard
    under the active spatial group: where the layout shards the level, its
    packed rows must shard too (each rank's rows even, the packed shards
    at least `spatial.MAX_HALO` rows)."""
    sp = spatial.active()
    if (height is not None and sp is not None and spatial.is_sharded(height, sp.size)
            and not spatial.is_sharded(height // 2, sp.size)):
        raise ValueError(
            f"packed_entry under --spatial {sp.size}: a level of {height} rows "
            f"({height // sp.size} a rank) cannot be packed; its {height // 2} "
            f"packed rows do not split into {sp.size} shards of at least "
            f"{spatial.MAX_HALO} rows")


class PackedEntryEfficientNet(EfficientNet):
    """`EfficientNet` with the stem and the first `packed_blocks` blocks
    computed packed (JAX :358-414); its `state_dict` is `EfficientNet`'s.
    `packed_blocks` 0 is the unpacked forward. Needs H and W divisible by 4
    when packing."""

    def __init__(self, spec: BackboneSpec, packed_blocks: int = 0,
                 in_channels: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__(spec, in_channels, dtype)
        self.packed_blocks = int(packed_blocks)
        self._kernels: Dict = {}

    @classmethod
    def sharing(cls, backbone: EfficientNet, packed_blocks: int
                ) -> "PackedEntryEfficientNet":
        """A packed view of `backbone`: the same submodules (parameters,
        buffers and fold caches), its own packed-kernel cache."""
        view = cls.__new__(cls)
        view.__dict__.update(backbone.__dict__)
        view.packed_blocks = int(packed_blocks)
        view._kernels = {}
        return view

    # -- packed kernels, cached --------------------------------------------
    def _kernel(self, name: str, sources: Sequence[torch.Tensor],
                build: Callable):
        if torch.compiler.is_exporting() or (
                torch.is_grad_enabled() and any(t.requires_grad for t in sources)):
            return build()
        key = tuple((t.data_ptr(), t._version, t.device) for t in sources)
        hit = self._kernels.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = self._kernels[name] = (key, build())
        return hit[1]

    def packed_kernels(self, dtype: torch.dtype) -> List:
        """Every packed kernel of the forward in `dtype` (built or cached):
        what a call with the cache empty builds first."""
        out = [self._stem_kernel(dtype)]
        for idx in range(min(self.packed_blocks, len(self.spec.blocks))):
            out.append(self._dw_kernel(idx, dtype))
        return out

    def _stem_kernel(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.stem_conv.weight
        return self._kernel(f"stem {dtype}", (w,),
                            lambda: pack_stem_kernel(w).to(dtype))

    def _dw_kernel(self, idx: int, dtype: torch.dtype):
        w = getattr(self, f"blocks_{idx}").depthwise_conv.weight
        if self.spec.blocks[idx].strides[0] > 1:
            build = lambda: (lambda kp, lo, hi: (kp.to(dtype), lo, hi))(
                *pack_dw_kernel_s2(w))
        else:
            build = lambda: pack_dw_kernel_s1(w).to(dtype)
        return self._kernel(f"blocks_{idx} {dtype}", (w,), build)

    # -- forward -------------------------------------------------------------
    def _packed_block(self, idx: int, xp: torch.Tensor, training: bool,
                      survival_prob: Optional[float],
                      generator: Optional[torch.Generator],
                      height: Optional[int] = None
                      ) -> Tuple[torch.Tensor, bool]:
        """Block `idx` on a packed input (JAX :286-355): (output, whether it
        is still packed: a stride-2 block leaves the layout). `height`: the
        global height of the block's unpacked input under a spatial mesh."""
        block: MBConvBlock = getattr(self, f"blocks_{idx}")
        act = block.act_type
        hp = None if height is None else height // 2  # packed rows; the s2 output's
        inputs = xp
        if block.args.expand_ratio != 1:
            xp = packed_1x1(xp, block.expand_conv.weight)
            xp = activation(packed_bn(block.bn0, xp, training, hp), act)
        stays_packed = block.args.strides[0] == 1
        if stays_packed:
            x = packed_dw_s1(xp, self._dw_kernel(idx, xp.dtype), hp)
            x = activation(packed_bn(block.bn1, x, training, hp), act)
            if block.se is not None:
                x = packed_se(block.se, x, hp)
            x = packed_bn(block.bn2, packed_1x1(x, block.project_conv.weight),
                          training, hp)
        else:
            x = packed_dw_s2(xp, *self._dw_kernel(idx, xp.dtype), hp)
            x = activation(block.bn1(x, training, hp), act)
            if block.se is not None:
                x = block.se(x, hp)
            # the project conv as a plain conv (JAX's lax conv, not its module)
            x = block.bn2(F.conv2d(x, block.project_conv.weight.to(x.dtype)),
                          training, hp)
            # the unpacked blocks after it take channels-last activations
            x = x.contiguous(memory_format=torch.channels_last)
        if block.residual:
            if training and survival_prob:
                if generator is None:  # Flax: no "dropout" rng
                    raise ValueError("drop-connect in training needs a generator")
                x = drop_connect(x, generator, survival_prob)
            x = x + inputs
        return x, stays_packed

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                height: Optional[int] = None) -> List[torch.Tensor]:
        if self.packed_blocks <= 0:
            return super().forward(x, training, generator, height)
        image_h = x.shape[2] if height is None else height
        if image_h % 4 or x.shape[3] % 4:
            raise ValueError(f"the packed entry needs image H and W divisible "
                             f"by 4, got {(image_h, x.shape[3])}")
        spec = self.spec
        cd = self.stem_conv.compute_dtype
        if cd is not None:  # cast once at the entry (JAX :368-371)
            x = x.to(cd)
        x = packed_stem(x, self._stem_kernel(x.dtype), height).contiguous()
        height = out_height(height, 2)  # the stem's unpacked rows
        check_packable(height)
        x = activation(packed_bn(self.stem_bn, x, training,
                                 None if height is None else height // 2),
                       spec.act_type)
        packed = True
        endpoints = []
        n_blocks = len(spec.blocks)
        for idx in range(n_blocks):
            survival_prob = None
            if spec.survival_prob:  # efficientnet.py:289-292
                survival_prob = 1.0 - (1.0 - spec.survival_prob) * float(idx) / n_blocks
            if idx < self.packed_blocks:
                if not packed:  # pack a later segment again
                    check_packable(height)
                    x = space_to_depth(x).contiguous()
                x, packed = self._packed_block(idx, x, training, survival_prob,
                                               generator, height)
            else:
                if packed:
                    x = depth_to_space(x).contiguous(memory_format=torch.channels_last)
                    packed = False
                x = getattr(self, f"blocks_{idx}")(x, training, survival_prob,
                                                   generator, height)
            height = out_height(height, spec.blocks[idx].strides[0])
            if idx in self._reductions:
                endpoints.append(depth_to_space(x) if packed else x)
        return endpoints

