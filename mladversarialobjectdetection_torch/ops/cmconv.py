"""Channel-major 3x3 SAME convolution: the plain version, its autograd and dispatch.

Port of `tools/proto_cmconv.py` (`cmconv` and its Pallas `_kernel`, written
for the defender U-Net's small-channel 3x3 convs). x is [B, C, H, W]
(NCHW: the channel-major layout of the TPU kernel is the port's own), w is
[3, 3, C, Co] (HWIO, as `proto_cmconv.py:57`); the optional bias [Co] is
what Flax's `nn.Conv` adds (the TPU kernel has none).

- `cmconv_plain`: the Co * C * 9 shifted multiply-adds of the TPU kernel, in
  its order (c, then dy, then dx; `proto_cmconv.py:30-37`), then the bias.
  It runs on any device; the CUDA kernels are held against it within 1e-5
  of the output's scale: they are not bit-equal to it, since the SIMT
  instance sums with FMAs (in the same c, dy, dx order) and the
  tensor-core instance with 3xTF32 products.
- `CMConv3x3` / `cmconv`: the differentiable op. Forward: the CUDA kernel
  (`ops/cmconv_cuda.py`, `csrc/cmconv.cu` / `cmconv_tc.cu`, the instance
  `cmconv_cuda.plan` picks) for CUDA tensors, which launches
  or raises, the plain version for CPU tensors. Input gradient: the same
  kernel (or plain version) on the output gradient with the weights flipped
  in both spatial axes and C / Co swapped, which is exact for a stride-1 3x3
  SAME conv. Weight gradient: `torch.nn.grad.conv2d_weight` (the JAX package
  has no kernel for it: JAX cannot differentiate `cmconv`). Bias gradient:
  the sum of the output gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cmconv_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, C, H, W], w [3, 3, C, Co], bias [Co] -> [B, Co, H, W]."""
    b, c, h, wd = x.shape
    co = w.shape[3]
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros((b, co, h, wd), dtype=x.dtype, device=x.device)
    for ci in range(c):
        for dy in range(3):
            for dx in range(3):
                acc = acc + (xp[:, ci:ci + 1, dy:dy + h, dx:dx + wd]
                             * w[dy, dx, ci].view(1, co, 1, 1))
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
                                             ).permute(2, 3, 1, 0)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3))
        return dx, dw, db


def cmconv(x: torch.Tensor, w: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable `cmconv_plain`: x [B, C, H, W] contiguous, w [3, 3, C, Co]."""
    return CMConv3x3.apply(x, w.contiguous(), bias)
