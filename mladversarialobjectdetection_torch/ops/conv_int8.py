"""The int8 convolution of the W8A8 serve (`csrc/conv_int8.cu`), its plain
version and its wrapper.

One conv of JAX's int8 interceptor (`mladversarialobjectdetection_tpu/
inference/quantize.py:160-178`), in NCHW:

    xq  = clip(round(x.float() / a_s), -127, 127)      int8, half to even
    acc = conv(xq, wq)                                  int8 x int8 -> int32
    out = (acc.float() * scale + bias).to(out_dtype)    scale = a_s * w_scale

with wq [Co, C/groups, kh, kw] int8 (OIHW), `scale` and `bias` [Co] float32,
stride 1 or 2 (or a pair), Flax `"SAME"` (`models/efficientnet.same_pads`) or
`"VALID"` padding, and groups 1 or C = Co (depthwise). `activation_scale`
computes a_s as JAX does and `dequant_scale` the product a_s * w_scale in
float32, once, on the host.

- `conv_int8_plain`: the plain version, on any device. The sums are exact:
  a float64 `F.conv2d` on the int8 values (127^2 times the taps stays far
  below 2^53), rounded and cast to int32. Never `F.conv2d` on int8 tensors:
  it sums in int8 and wraps. The quantisation divides by a tensor on x's
  device, never by a Python scalar: PyTorch's CUDA division by a host scalar
  multiplies by its reciprocal, which rounds otherwise.
- `conv_int8_cuda`: the kernel (two launches: the quantisation, then the
  conv), bit-equal to the plain version (integer sums are exact in any order;
  the kernel's epilogue keeps the multiply and the add apart). It takes
  CUDA tensors only and launches or raises; it never falls back.
- `conv_int8`: the CUDA route for CUDA tensors, the plain version for CPU
  tensors.

`LAUNCHES` counts the kernel launches of `conv_int8_cuda` (two a call) and
`CALLS` its calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..models.efficientnet import same_pads

LAUNCHES = 0  # kernel launches of conv_int8_cuda in this process (2 a call)
CALLS = 0     # calls of conv_int8_cuda in this process
PADDINGS = ("SAME", "VALID")
OUT_DTYPES = (torch.float32, torch.bfloat16)
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int

Stride = Union[int, Sequence[int]]


def reset_counts() -> None:
    global LAUNCHES, CALLS
    LAUNCHES = CALLS = 0


def activation_scale(amax: float) -> float:
    """a_s = float32(max(amax, 1e-8) / 127.0), the division in Python's
    double (quantize.py:167)."""
    return float(np.float32(max(float(amax), 1e-8) / 127.0))


def dequant_scale(a_s: float, w_scale) -> np.ndarray:
    """a_s * w_scale in float32 (quantize.py:174)."""
    return np.float32(a_s) * np.asarray(w_scale, np.float32)


def _pair(v: Stride) -> Tuple[int, int]:
    if isinstance(v, int):
        return v, v
    t = tuple(int(e) for e in v)
    return t if len(t) == 2 else (t[0], t[0])


def geometry(h: int, w: int, kh: int, kw: int, stride: Stride, padding: str):
    """(pads (top, bottom, left, right), (OH, OW)) of one conv."""
    if padding not in PADDINGS:
        raise ValueError(f"padding {padding!r}: want one of {PADDINGS}")
    sh, sw = _pair(stride)
    if padding == "SAME":
        top, bottom = same_pads(h, kh, sh)
        left, right = same_pads(w, kw, sw)
    else:
        top = bottom = left = right = 0
    oh = (h + top + bottom - kh) // sh + 1
    ow = (w + left + right - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"{h}x{w} input gives no output for a {kh}x{kw} {padding} conv")
    return (top, bottom, left, right), (oh, ow)


def _check_groups(c: int, wq: torch.Tensor, groups: int) -> None:
    co, ci = wq.shape[:2]
    if groups == 1:
        if ci != c:
            raise ValueError(f"weights take {ci} channels, x has {c}")
    elif not (groups == c == co and ci == 1):
        raise ValueError(f"groups {groups}: want 1, or C = Co (depthwise); "
                         f"x has {c} channels, weights {tuple(wq.shape)}")


def quantize_plain(x: torch.Tensor, a_s: float) -> torch.Tensor:
    """clip(round(x.float() / a_s), -127, 127) as int8 (a true division)."""
    div = torch.full((1,), a_s, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / div), -127, 127).to(torch.int8)


def sums_plain(xq: torch.Tensor, wq: torch.Tensor, *, stride: Stride = 1,
               padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """The exact int32 sums of the int8 conv of xq [B, C, H, W] with wq."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 operands, got {xq.dtype} and {wq.dtype}")
    _check_groups(xq.shape[1], wq, groups)
    (top, bottom, left, right), _ = geometry(xq.shape[2], xq.shape[3], wq.shape[2],
                                             wq.shape[3], stride, padding)
    xp = F.pad(xq.to(torch.float64), (left, right, top, bottom))
    y = F.conv2d(xp, wq.to(torch.float64), None, _pair(stride), 0, 1, groups)
    return torch.round(y).to(torch.int32)


def dequantize_plain(acc: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """(acc.float() * scale + bias) in out_dtype, the multiply and the add
    apart (quantize.py:174-178)."""
    y = acc.to(torch.float32) * scale.view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y.to(out_dtype)


def _check(x, a_s, wq, scale, bias, padding, groups, out_dtype):
    if x.dim() != 4:
        raise ValueError(f"x [B, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in OUT_DTYPES:
        raise TypeError(f"x float32 or bfloat16, got {x.dtype}")
    if wq.dtype != torch.int8 or wq.dim() != 4:
        raise TypeError(f"wq [Co, C/g, kh, kw] int8, got {wq.dtype} {tuple(wq.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (wq.shape[0],):
        raise ValueError(f"scale [Co] float32, got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (wq.shape[0],)):
        raise ValueError(f"bias [Co] float32, got {bias.dtype} {tuple(bias.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype float32 or bfloat16, got {out_dtype}")
    if not a_s > 0.0:
        raise ValueError(f"activation scale {a_s} must be positive")
    _check_groups(x.shape[1], wq, groups)
    if padding not in PADDINGS:
        raise ValueError(f"padding {padding!r}: want one of {PADDINGS}")


def conv_int8_plain(x: torch.Tensor, a_s: float, wq: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, stride: Stride = 1,
                    padding: str = "SAME", groups: int = 1,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 conv in plain PyTorch (see the module notes)."""
    out_dtype = out_dtype or x.dtype
    _check(x, a_s, wq, scale, bias, padding, groups, out_dtype)
    acc = sums_plain(quantize_plain(x, a_s), wq, stride=stride, padding=padding,
                     groups=groups)
    return dequantize_plain(acc, scale, bias, out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of `csrc/conv_int8.cu`, built on first use."""
    fn = _build.load("conv_int8").mlad_conv_int8
    fn.argtypes = [_P, _I, ctypes.c_float, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _I, _I, _P, _P, _I, _P]
    fn.restype = _I
    return fn


def _launch(x, a_s, wq, scale, bias, stride, padding, groups, out_dtype) -> torch.Tensor:
    """Both kernels on PyTorch's current stream; `out_dtype` int32 writes
    the raw sums."""
    global LAUNCHES, CALLS
    tensors = [x, wq, scale] + ([] if bias is None else [bias])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("conv_int8_cuda takes CUDA tensors; use conv_int8_plain on the CPU")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on {sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv_int8_cuda takes contiguous tensors (x NCHW, wq OIHW)")
    b, c, h, w = x.shape
    co, _, kh, kw = wq.shape
    (top, _, left, _), (oh, ow) = geometry(h, w, kh, kw, stride, padding)
    sh, sw = _pair(stride)
    depthwise = groups != 1
    dev = x.device
    nbytes = b * c * h * w if depthwise else b * h * w * 4 * (-(-c // 4))
    scratch = torch.empty((nbytes,), dtype=torch.int8, device=dev)
    out = torch.empty((b, co, oh, ow), device=dev, dtype=out_dtype)
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), a_s, wq.data_ptr(),
                 scale.data_ptr(), None if bias is None else bias.data_ptr(), b, c, h, w, co,
                 kh, kw, sh, sw, top, left, oh, ow, int(depthwise), scratch.data_ptr(),
                 out.data_ptr(), _KIND[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_int8 kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, wq {tuple(wq.shape)}, stride {stride}, "
                           f"{padding}, groups {groups})")
    LAUNCHES += 2
    CALLS += 1
    return out


def conv_int8_cuda(x: torch.Tensor, a_s: float, wq: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, stride: Stride = 1,
                   padding: str = "SAME", groups: int = 1,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`conv_int8_plain` as the kernel: two launches on PyTorch's stream."""
    out_dtype = out_dtype or x.dtype
    _check(x, a_s, wq, scale, bias, padding, groups, out_dtype)
    return _launch(x, a_s, wq, scale, bias, stride, padding, groups, out_dtype)


def sums_cuda(x: torch.Tensor, a_s: float, wq: torch.Tensor, *, stride: Stride = 1,
              padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """The kernel's int32 sums of the quantised x with wq (no dequantisation),
    for holding them to `sums_plain(quantize_plain(x, a_s), wq)`."""
    scale = torch.ones((wq.shape[0],), dtype=torch.float32, device=x.device)
    _check(x, a_s, wq, scale, None, padding, groups, torch.float32)
    return _launch(x, a_s, wq, scale, None, stride, padding, groups, torch.int32)


def conv_int8(x: torch.Tensor, a_s: float, wq: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, stride: Stride = 1,
              padding: str = "SAME", groups: int = 1,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 conv: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.is_cuda:
        return conv_int8_cuda(x, a_s, wq, scale, bias, stride=stride, padding=padding,
                              groups=groups, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return conv_int8_plain(x, a_s, wq, scale, bias, stride=stride, padding=padding,
                               groups=groups, out_dtype=out_dtype)
    raise ValueError(f"no int8 conv for device {x.device}")
