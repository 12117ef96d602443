"""The CUDA channel-major 3x3 convolution kernel (`csrc/cmconv.cu`) and its wrapper.

Replaces the Pallas TPU kernel `_kernel` of `tools/proto_cmconv.py` (launched
by `cmconv`). `cmconv3x3_cuda` has the signature of `ops/cmconv.cmconv_plain`:
x [B, C, H, W] and w [3, 3, C, Co] (HWIO), an optional bias [Co], 1 <= C, Co
<= 32. It takes only contiguous float32 CUDA tensors on one device (a tensor
in the channels-last memory format is not contiguous: make it so at the
call site), launches on PyTorch's current stream, allocates its output and
nothing else, and raises on any refusal; it never falls back to the plain
version. `LAUNCHES` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

LAUNCHES = 0  # kernel launches made by cmconv3x3_cuda in this process
MAX_CHANNELS = 32  # input and output channels the kernel takes

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of `csrc/cmconv.cu`, built on first use."""
    fn = _build.load("cmconv").mlad_cmconv3x3
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def cmconv3x3_cuda(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """`ops/cmconv.cmconv_plain` as one kernel launch."""
    global LAUNCHES
    tensors = (x, w) if bias is None else (x, w, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"float32 only, got {[t.dtype for t in tensors]}")
    if not all(t.is_cuda for t in tensors):
        raise ValueError("cmconv3x3_cuda takes CUDA tensors; use "
                         "ops/cmconv.cmconv_plain on the CPU")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or \
            w.shape[2] != x.shape[1]:
        raise ValueError(f"want x [B, C, H, W] and w [3, 3, C, Co], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, c, h, wd = x.shape
    co = w.shape[3]
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias {tuple(bias.shape)}, want ({co},)")
    if not (1 <= c <= MAX_CHANNELS and 1 <= co <= MAX_CHANNELS):
        raise ValueError(f"channels {c} -> {co} outside 1..{MAX_CHANNELS}")
    if min(b, h, wd) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, w and bias must be contiguous (x in NCHW)")
    out = torch.empty((b, co, h, wd), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), b, c, co, h, wd,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cmconv kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, Co {co})")
    LAUNCHES += 1
    return out
