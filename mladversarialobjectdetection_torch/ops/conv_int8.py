"""The int8 convolution of the W8A8 serve (`csrc/conv_int8_sm90.cu`, its
ablation `csrc/conv_int8.cu`), its plain version and its wrapper.

One conv of JAX's int8 interceptor (`mladversarialobjectdetection_tpu/
inference/quantize.py:160-178`), in NCHW:

    xq  = clip(round(x.float() / a_s), -127, 127)      int8, half to even
    acc = conv(xq, wq)                                  int8 x int8 -> int32
    out = (acc.float() * scale + bias).to(out_dtype)    scale = a_s * w_scale

with wq [Co, C/groups, kh, kw] int8 (OIHW), `scale` and `bias` [Co] float32,
stride 1 or 2 (or a pair), Flax `"SAME"` (`models/efficientnet.same_pads`) or
`"VALID"` padding or explicit zero pads `((top, bottom), (left, right))`
(a row shard's halo-extended rows take none, its columns SAME's), and
groups 1 or C = Co (depthwise). `activation_scale`
computes a_s as JAX does and `dequant_scale` the product a_s * w_scale in
float32, once, on the host.

- `conv_int8_plain`: the plain version, on any device. The sums are exact:
  a float64 `F.conv2d` on the int8 values (127^2 times the taps stays far
  below 2^53), rounded and cast to int32. Never `F.conv2d` on int8 tensors:
  it sums in int8 and wraps. The quantisation divides by a tensor on x's
  device, never by a Python scalar: PyTorch's CUDA division by a host scalar
  multiplies by its reciprocal, which rounds otherwise.
- `conv_int8_cuda`: the kernel, bit-equal to the plain version (integer
  sums are exact in any order; the kernel's epilogue keeps the multiply and
  the add apart). Instance `"sm90"` (the default, every path's) is one
  launch a call with the quantisation fused in: s8 tensor-core products for
  groups 1, a shared-memory halo tile for depthwise convs. Its dense convs
  read the weights packed once by `pack_int8_weights` (`packed=`; packed on
  the fly where none is given). Instance `"simt"` is the first design, two
  launches a call (the quantisation, then `__dp4a` or int32 sums), kept as
  the ablation. It takes CUDA tensors only and launches or raises; it never
  falls back.
- `conv_int8`: the CUDA route for CUDA tensors, the plain version for CPU
  tensors.
- `pack_int8_weights` and `sums_packed_plain`: the dense kernel's weight
  layout and its implicit GEMM in its own K order, in plain PyTorch.

`LAUNCHES` counts the kernel launches of `conv_int8_cuda`, `CALLS` its
calls and `INSTANCE_LAUNCHES` the launches again by instance.
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

LAUNCHES = 0  # kernel launches of conv_int8_cuda in this process
CALLS = 0     # calls of conv_int8_cuda in this process
# instance -> (library, C entry, launches a call)
INSTANCES = {"sm90": ("conv_int8_sm90", "mlad_conv_int8_sm90", 1),
             "simt": ("conv_int8", "mlad_conv_int8", 2)}
INSTANCE_LAUNCHES = dict.fromkeys(INSTANCES, 0)  # launches by instance
C_STEP = 4    # the dense kernel's channels a word: C is padded to it in each tap
K_STEP = 64   # K of one step of the dense kernel: a packed row is padded to it
CO_STEP = 32  # the packed weights' rows are padded to it
PADDINGS = ("SAME", "VALID")
OUT_DTYPES = (torch.float32, torch.bfloat16)
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int

Stride = Union[int, Sequence[int]]
Padding = Union[str, Sequence[Sequence[int]]]  # a mode or ((top, bottom), (left, right))


def reset_counts() -> None:
    global LAUNCHES, CALLS
    LAUNCHES = CALLS = 0
    for k in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[k] = 0


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


def explicit_pads(padding: Padding) -> Optional[Tuple[int, int, int, int]]:
    """(top, bottom, left, right) of explicit pads; None for a mode. Raises
    on anything else."""
    if isinstance(padding, str):
        if padding not in PADDINGS:
            raise ValueError(f"padding {padding!r}: want one of {PADDINGS}")
        return None
    try:
        (top, bottom), (left, right) = padding
        pads = tuple(int(p) for p in (top, bottom, left, right))
    except (TypeError, ValueError):
        pads = None
    if pads is None or min(pads) < 0:
        raise ValueError(f"padding {padding!r}: want one of {PADDINGS} or "
                         f"((top, bottom), (left, right)) of non-negative ints")
    return pads


def geometry(h: int, w: int, kh: int, kw: int, stride: Stride, padding: Padding):
    """(pads (top, bottom, left, right), (OH, OW)) of one conv."""
    pads = explicit_pads(padding)
    sh, sw = _pair(stride)
    if pads is not None:
        top, bottom, left, right = pads
    elif padding == "SAME":
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
               padding: Padding = "SAME", groups: int = 1) -> torch.Tensor:
    """The exact int32 sums of the int8 conv of xq [B, C, H, W] with wq."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 operands, got {xq.dtype} and {wq.dtype}")
    _check_groups(xq.shape[1], wq, groups)
    (top, bottom, left, right), _ = geometry(xq.shape[2], xq.shape[3], wq.shape[2],
                                             wq.shape[3], stride, padding)
    xp = F.pad(xq.to(torch.float64), (left, right, top, bottom))
    y = F.conv2d(xp, wq.to(torch.float64), None, _pair(stride), 0, 1, groups)
    return torch.round(y).to(torch.int32)


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def packed_shape(shape: Sequence[int]) -> Tuple[int, int]:
    """The packed weights' shape for weights of `shape` [Co, C, kh, kw]."""
    co, c, kh, kw = (int(v) for v in shape)
    return _round_up(co, CO_STEP), _round_up(kh * kw * _round_up(c, C_STEP), K_STEP)


def pack_int8_weights(wq: torch.Tensor) -> torch.Tensor:
    """The dense kernel's weights: wq [Co, C, kh, kw] int8 (groups 1) as
    [Co padded to CO_STEP, Kp] int8, Kp = kh*kw*Cp padded to K_STEP and
    Cp = C padded to C_STEP. Row co holds tap t = i*kw + j's channels at
    columns t*Cp .. t*Cp + C - 1, zeros elsewhere: K-major in the kernel's K
    order (tap, then channel)."""
    if wq.dtype != torch.int8 or wq.dim() != 4:
        raise TypeError(f"wq [Co, C, kh, kw] int8, got {wq.dtype} {tuple(wq.shape)}")
    co, c, kh, kw = wq.shape
    cp = _round_up(c, C_STEP)
    packed = torch.zeros(packed_shape(wq.shape), dtype=torch.int8, device=wq.device)
    packed[:co, :kh * kw * cp].view(co, kh * kw, cp)[:, :, :c] = (
        wq.permute(0, 2, 3, 1).reshape(co, kh * kw, c))
    return packed


def sums_packed_plain(xq: torch.Tensor, packed: torch.Tensor, shape: Sequence[int], *,
                      stride: Stride = 1, padding: Padding = "SAME") -> torch.Tensor:
    """The dense kernel's implicit GEMM in its own K order: the packed
    weights (`pack_int8_weights` of weights of `shape` [Co, C, kh, kw]) times
    the unfolded, channel-padded xq [B, C, H, W] with K padded as the
    weights are, a float64 product (exact: 127^2 times K stays far below
    2^53) rounded to int32 [B, Co, OH, OW]."""
    co, c, kh, kw = (int(v) for v in shape)
    b, cx, h, w = xq.shape
    if xq.dtype != torch.int8 or cx != c:
        raise TypeError(f"xq [B, {c}, H, W] int8, got {xq.dtype} {tuple(xq.shape)}")
    if tuple(packed.shape) != packed_shape(shape):
        raise ValueError(f"packed weights {tuple(packed.shape)} are not those of {tuple(shape)}")
    cp = _round_up(c, C_STEP)
    (top, bottom, left, right), (oh, ow) = geometry(h, w, kh, kw, stride, padding)
    xp = F.pad(xq.to(torch.float64), (left, right, top, bottom, 0, cp - c))
    cols = F.unfold(xp, (kh, kw), stride=_pair(stride))  # [B, Cp*kh*kw, L], (c, tap) order
    cols = cols.view(b, cp, kh * kw, oh * ow).transpose(1, 2).reshape(b, kh * kw * cp, oh * ow)
    cols = F.pad(cols, (0, 0, 0, packed.shape[1] - kh * kw * cp))  # K's padding, zeros
    y = packed[:co].to(torch.float64) @ cols
    return torch.round(y).to(torch.int32).view(b, co, oh, ow)


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
    explicit_pads(padding)


def conv_int8_plain(x: torch.Tensor, a_s: float, wq: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, stride: Stride = 1,
                    padding: Padding = "SAME", groups: int = 1,
                    out_dtype: Optional[torch.dtype] = None,
                    packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv in plain PyTorch (see the module notes). It reads wq;
    `packed`, the kernel's copy of it, is taken so that a kernel call runs
    here as it stands, and is not read."""
    out_dtype = out_dtype or x.dtype
    _check(x, a_s, wq, scale, bias, padding, groups, out_dtype)
    acc = sums_plain(quantize_plain(x, a_s), wq, stride=stride, padding=padding,
                     groups=groups)
    return dequantize_plain(acc, scale, bias, out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel(instance: str):
    """The C entry of an instance, built on first use."""
    lib, name, _ = INSTANCES[instance]
    fn = getattr(_build.load(lib), name)
    ints = [_I] * 14  # B, C, H, W, Co, kh, kw, sh, sw, pt, pl, OH, OW, depthwise
    if instance == "sm90":  # x, x_bf16, a_s, w, w_rows, scale, bias, ..., out, kind, stream
        fn.argtypes = [_P, _I, ctypes.c_float, _P, _I, _P, _P, *ints, _P, _I, _P]
    else:  # x, x_bf16, a_s, w, scale, bias, ..., scratch, out, kind, stream
        fn.argtypes = [_P, _I, ctypes.c_float, _P, _P, _P, *ints, _P, _P, _I, _P]
    fn.restype = _I
    return fn


def _launch(x, a_s, wq, scale, bias, stride, padding, groups, out_dtype, instance,
            packed) -> torch.Tensor:
    """One call of `instance` on PyTorch's current stream; `out_dtype`
    int32 writes the raw sums."""
    global LAUNCHES, CALLS
    if instance not in INSTANCES:
        raise ValueError(f"no conv_int8 instance {instance!r}; have {sorted(INSTANCES)}")
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
    out = torch.empty((b, co, oh, ow), device=dev, dtype=out_dtype)
    geo = (b, c, h, w, co, kh, kw, sh, sw, top, left, oh, ow, int(depthwise))
    bias_ptr = None if bias is None else bias.data_ptr()
    fn = _kernel(instance)
    if instance == "sm90":
        wk = wq
        if not depthwise:
            wk = pack_int8_weights(wq) if packed is None else packed
            want = packed_shape(wq.shape)
            if (wk.dtype != torch.int8 or tuple(wk.shape) != want or wk.device != dev
                    or not wk.is_contiguous()):
                raise ValueError(f"packed weights {wk.dtype} {tuple(wk.shape)} on {wk.device}: "
                                 f"want pack_int8_weights(wq), int8 {want} on {dev}")
        args = (wk.data_ptr(), wk.shape[0], scale.data_ptr(), bias_ptr, *geo)
    else:
        nbytes = b * c * h * w if depthwise else b * h * w * 4 * (-(-c // 4))
        scratch = torch.empty((nbytes,), dtype=torch.int8, device=dev)
        args = (wq.data_ptr(), scale.data_ptr(), bias_ptr, *geo, scratch.data_ptr())
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), a_s, *args, out.data_ptr(),
                 _KIND[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_int8 {instance} kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, wq {tuple(wq.shape)}, stride {stride}, "
                           f"{padding}, groups {groups})")
    n = INSTANCES[instance][2]
    LAUNCHES += n
    INSTANCE_LAUNCHES[instance] += n
    CALLS += 1
    return out


def conv_int8_cuda(x: torch.Tensor, a_s: float, wq: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, stride: Stride = 1,
                   padding: Padding = "SAME", groups: int = 1,
                   out_dtype: Optional[torch.dtype] = None, instance: str = "sm90",
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`conv_int8_plain` as the kernel of `instance` on PyTorch's stream."""
    out_dtype = out_dtype or x.dtype
    _check(x, a_s, wq, scale, bias, padding, groups, out_dtype)
    return _launch(x, a_s, wq, scale, bias, stride, padding, groups, out_dtype, instance,
                   packed)


def sums_cuda(x: torch.Tensor, a_s: float, wq: torch.Tensor, *, stride: Stride = 1,
              padding: Padding = "SAME", groups: int = 1,
              instance: str = "sm90") -> torch.Tensor:
    """The kernel's int32 sums of the quantised x with wq (no dequantisation),
    for holding them to `sums_plain(quantize_plain(x, a_s), wq)`."""
    scale = torch.ones((wq.shape[0],), dtype=torch.float32, device=x.device)
    _check(x, a_s, wq, scale, None, padding, groups, torch.float32)
    return _launch(x, a_s, wq, scale, None, stride, padding, groups, torch.int32, instance,
                   None)


def conv_int8(x: torch.Tensor, a_s: float, wq: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, stride: Stride = 1,
              padding: Padding = "SAME", groups: int = 1,
              out_dtype: Optional[torch.dtype] = None,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv: the kernel for CUDA tensors, the plain version for CPU
    tensors. `packed`: `pack_int8_weights(wq)`, made once by the caller."""
    if x.is_cuda:
        return conv_int8_cuda(x, a_s, wq, scale, bias, stride=stride, padding=padding,
                              groups=groups, out_dtype=out_dtype, packed=packed)
    if x.device.type == "cpu":
        return conv_int8_plain(x, a_s, wq, scale, bias, stride=stride, padding=padding,
                               groups=groups, out_dtype=out_dtype)
    raise ValueError(f"no int8 conv for device {x.device}")
