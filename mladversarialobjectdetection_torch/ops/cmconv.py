"""Channel-major 3x3 SAME convolution: the plain version, its autograd and dispatch.

Port of `tools/proto_cmconv.py` (`cmconv` and its Pallas `_kernel`, written
for the defender U-Net's small-channel 3x3 convs). x is [B, C, H, W]
(NCHW: the channel-major layout of the TPU kernel is the port's own), w is
[3, 3, C, Co] (HWIO, as `proto_cmconv.py:57`); the optional bias [Co] is
what Flax's `nn.Conv` adds (the TPU kernel has none).

Two dtypes. float32: x, w, bias and the output float32. bf16, the TPU
kernel's own signature (proto_cmconv.py:57): x bf16, w float32 (the U-Net
hands it bf16 values held in float32, as Flax's bf16 conv rounds its
kernel), each product `x.float() * w` summed in float32 and the sum rounded
once to bf16 (:36-38); a bias, bf16, is then added in bf16, rounded again,
as Flax's bf16 `nn.Conv` adds it after the conv's bf16 output.

- `cmconv_plain`: the Co * C * 9 shifted multiply-adds of the TPU kernel, in
  its order (c, then dy, then dx; `proto_cmconv.py:30-37`), in float32 for
  a bf16 x (never in bf16), then the rounding and the bias.
  It runs on any device; the CUDA kernels are held against it within 1e-5
  of the output's scale in float32, and within one bf16 ulp of it in bf16
  (`BF16_TOL`): they are not bit-equal to it, since the SIMT
  instances sum with FMAs (in the same c, dy, dx order) and the
  tensor-core instance with 3xTF32 products.
- `cmconv_rounding_bound`: the bf16 function's allowed distance from the
  float64 sum (`cmconv_sum64`), element by element, for a kernel whose
  float32 sums run in another order than the plain version's: the bf16
  main-path instance (`csrc/cmconv_bf16_sm90.cu`) sums each weight's bf16
  hi and lo terms' products on the tensor cores, chunk by chunk, so it is
  not bit-equal to the plain version even where w holds bf16 values.
- `CMConv3x3` / `cmconv`: the differentiable op. Forward: the CUDA kernel
  (`ops/cmconv_cuda.py`; float32 `csrc/cmconv.cu` / `cmconv_tc.cu`, bf16
  `csrc/cmconv_bf16_sm90.cu` / `cmconv_bf16.cu`, the instance
  `cmconv_cuda.plan` picks) for CUDA tensors, which launches
  or raises, the plain version for CPU tensors. Input gradient: the same
  kernel (or plain version) on the output gradient with the weights flipped
  in both spatial axes and C / Co swapped, which is exact for a stride-1 3x3
  SAME conv. Weight gradient: `torch.nn.grad.conv2d_weight` (the JAX package
  has no kernel for it: JAX cannot differentiate `cmconv`), in the operands'
  dtype: at bf16 a bf16 gradient, cast to w's float32 (Flax's bf16 conv
  gives a bf16 kernel gradient that reaches the float32 parameter through
  the cast). Bias gradient: the sum of the output gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# bf16 kernels against the bf16 plain version: float32 sums in another order
# can round to the neighbouring bf16 value, one ulp of the output: at most
# 2^-7 of its scale max(1, max|plain|); with a bias the sum and the bias
# add each round, two ulps
BF16_TOL = 2.0 ** -6
# one float32 add of a tensor core: at most this unit of its larger operand
# (2^-23, so that an adder that truncates passes, not only one that rounds)
TC_ADD_UNIT = 2.0 ** -23


def cmconv_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, C, H, W], w [3, 3, C, Co], bias [Co] -> [B, Co, H, W] in x's
    dtype; a bf16 x sums in float32 and rounds once, then adds the bias."""
    b, c, h, wd = x.shape
    co = w.shape[3]
    sum_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    xp = F.pad(x, (1, 1, 1, 1)).to(sum_dtype)
    w = w.to(sum_dtype)
    acc = torch.zeros((b, co, h, wd), dtype=sum_dtype, device=x.device)
    for ci in range(c):
        for dy in range(3):
            for dx in range(3):
                acc = acc + (xp[:, ci:ci + 1, dy:dy + h, dx:dx + wd]
                             * w[dy, dx, ci].view(1, co, 1, 1))
    acc = acc.to(x.dtype)
    if bias is not None:
        acc = acc + bias.view(1, co, 1, 1)
    return acc


def cmconv_sum64(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """The float64 sum of the conv (x [B, C, H, W], w [3, 3, C, Co]) plus the
    bias, [B, Co, H, W] float64: the reference `cmconv_rounding_bound` is a
    distance from."""
    out = F.conv2d(x.double(), w.double().permute(3, 2, 0, 1), padding=1)
    if bias is not None:
        out = out + bias.double().view(1, -1, 1, 1)
    return out


def _round_bf16(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 (nearest) -> bf16 (nearest): one rounding to bf16
    where v is a float32 value."""
    return v.float().bfloat16()


def cmconv_rounding_bound(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """Each output element's allowed distance (float64, [B, Co, H, W]) from
    `cmconv_sum64(x, w, bias)` for the bf16 function (bf16 x, float32 w) of a
    kernel that splits each weight into bf16 terms hi = bf16(w) and lo =
    bf16(w - hi), sums the 2 * 9 * C exact products x * hi, x * lo in float32
    in one fixed order, rounds the sum once to bf16 and adds the bf16 bias in
    bf16 (rounded again).

    The float32 sum s' lies within E of the exact s: each tensor-core add
    loses at most TC_ADD_UNIT of its larger operand, and an add that
    aligns a block of products to its largest and then normalises loses at
    most that for each term and once more for the block, so at most
    2 * n * TC_ADD_UNIT * S with n = 18 C and S the sum of |x| (|hi| + |lo|);
    plus the split's residual, the sum of |x| |w - hi - lo| (at most 2^-16 of
    the sum of |x w|), computed exactly. Rounding to bf16 is monotone, so the
    output lies between bf16(s - E) and bf16(s + E), each then plus the bias
    in bf16; the distance is that interval's farther end from s + bias. A
    float32 slack of 2^-22 |s| (and 2^-126 n for flushed subnormals) covers
    the rounding of s - E and s + E to float32 on the way to bf16."""
    c = x.shape[1]
    xa = x.double().abs()
    hi = w.bfloat16()
    lo = (w - hi.float()).bfloat16()
    resid = (w.double() - hi.double() - lo.double()).abs()
    s = cmconv_sum64(x, w)
    terms = cmconv_sum64(xa, hi.double().abs() + lo.double().abs())
    n = 2 * 9 * c
    err = (2 * n * TC_ADD_UNIT * terms + cmconv_sum64(xa, resid)
           + 2.0 ** -22 * s.abs() + n * 2.0 ** -126)
    low, high = _round_bf16(s - err), _round_bf16(s + err)
    ref = s
    if bias is not None:
        low, high = low + bias.view(1, -1, 1, 1), high + bias.view(1, -1, 1, 1)
        ref = s + bias.double().view(1, -1, 1, 1)
    return torch.maximum(ref - low.double(), high.double() - ref)


def _conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        from . import cmconv_cuda
        return cmconv_cuda.cmconv3x3_cuda(x, w, bias)
    if x.device.type == "cpu":
        return cmconv_plain(x, w, bias)
    raise ValueError(f"no cmconv for device {x.device}")


class CMConv3x3(torch.autograd.Function):
    """3x3 SAME conv whose forward and input gradient run `_conv`."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return _conv(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _conv(g, w.flip(0, 1).transpose(2, 3).contiguous(), None)
        if ctx.needs_input_grad[1]:
            c, co = w.shape[2], w.shape[3]
            dw = torch.nn.grad.conv2d_weight(x, (co, c, 3, 3), g, padding=1
                                             ).permute(2, 3, 1, 0).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3))
        return dx, dw, db


def cmconv(x: torch.Tensor, w: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable `cmconv_plain`: x [B, C, H, W] contiguous, w [3, 3, C, Co];
    bias in x's dtype."""
    return CMConv3x3.apply(x, w.contiguous(), bias)
