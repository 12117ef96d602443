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
- `CMConv3x3` / `cmconv`: the differentiable op. Forward: the CUDA kernel
  (`ops/cmconv_cuda.py`, `csrc/cmconv.cu` / `cmconv_tc.cu`, the instance
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
