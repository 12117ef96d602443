"""The CUDA fused frozen-MBConv kernels (`csrc/mbconv.cu`) and their wrappers.

Replace the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
`tools/experiments/fused_mbconv.py` (launched by `_mbconv_fwd_pallas` and
`_mbconv_bwd_pallas`). `mbconv_fwd_cuda` and `mbconv_dx_cuda` have the
signatures of `ops/mbconv.mbconv_plain` and `mbconv_dx_plain`: x [B, H, W, C]
and g [B, H, W, Co] NHWC, the folded weights of `ops/mbconv.FoldedBlock`, a
k of 3 or 5, an act of `ops/mbconv.SUPPORTED_ACTS`. They take only
contiguous float32 CUDA tensors on one device, launch on PyTorch's current
stream, allocate their output and nothing else, and raise on any refusal
(the C entry refuses a width whose shared-memory sum passes 227 KB: Co in
the forward, C in dx, about 700 channels); neither falls back to the plain
version. `LAUNCHES` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .mbconv import SUPPORTED_ACTS, FoldedBlock

LAUNCHES = {"mbconv_fwd": 0, "mbconv_dx": 0}  # kernel launches in this process
ACT_CODES = {"relu6": 0, "relu": 1, "swish": 2, "silu": 2, "swish_native": 2}
assert set(ACT_CODES) == set(SUPPORTED_ACTS)

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_counts() -> None:
    """Set both launch counts to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _kernels():
    """The two C entries of `csrc/mbconv.cu`, built on first use."""
    lib = _build.load("mbconv")
    fns = {}
    for name, n_ptr in (("fwd", 7), ("dx", 7)):
        fn = getattr(lib, f"mlad_mbconv_{name}")
        fn.argtypes = [_P] * n_ptr + [_I] * 9 + [_P, _P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _check(tensors, fb: FoldedBlock, c: int, act_type: str, residual: bool):
    """Raise unless the tensors are contiguous float32 CUDA tensors on one
    device and the folded weights fit x's C. Returns (E, Co, k)."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"float32 only, got {[t.dtype for t in tensors]}")
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the fused MBConv kernels take CUDA tensors; use "
                         "ops/mbconv.mbconv_plain on the CPU")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, g and the folded weights must be contiguous (x "
                         "and g in NHWC)")
    if act_type not in ACT_CODES:
        raise ValueError(f"unsupported act {act_type}")
    e, co = fb.wp.shape
    k = fb.wd.shape[0]
    want = {"we": (c, e), "be": (e,), "wd": (k, k, e), "bd": (e,),
            "wp": (e, co), "bp": (co,)}
    got = {name: tuple(getattr(fb, name).shape) for name in want}
    if got != want or k not in (3, 5):
        raise ValueError(f"folded weights {got} for C={c}: want {want} with "
                         f"k 3 or 5")
    if residual and c != co:
        raise ValueError(f"a residual block needs C == Co, got {c} and {co}")
    return e, co, k


def _launch(name, ptrs, shape, e, co, k, act_type, residual, out, device):
    b, h, w, c = shape
    if min(b, h, w, c) < 1:
        raise ValueError(f"empty input {tuple(shape)}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernels()[name](*ptrs, b, h, w, c, e, co, k, ACT_CODES[act_type],
                               int(residual), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mbconv {name} kernel launch failed: cudaError_t "
                           f"{err} (x {tuple(shape)}, E {e}, Co {co}, k {k})")
    LAUNCHES[f"mbconv_{name}"] += 1
    return out


def mbconv_fwd_cuda(x: torch.Tensor, fb: FoldedBlock, *, act_type: str,
                    residual: bool) -> torch.Tensor:
    """`ops/mbconv.mbconv_plain` as one kernel launch: y [B, H, W, Co]."""
    tensors = (x, *fb)
    if x.dim() != 4:
        raise ValueError(f"want x [B, H, W, C], got {tuple(x.shape)}")
    e, co, k = _check(tensors, fb, x.shape[3], act_type, residual)
    out = torch.empty((*x.shape[:3], co), dtype=torch.float32, device=x.device)
    return _launch("fwd", [t.data_ptr() for t in tensors], x.shape, e, co, k,
                   act_type, residual, out, x.device)


def mbconv_dx_cuda(x: torch.Tensor, g: torch.Tensor, fb: FoldedBlock, *,
                   act_type: str, residual: bool) -> torch.Tensor:
    """`ops/mbconv.mbconv_dx_plain` as one kernel launch: dx [B, H, W, C]."""
    tensors = (x, g, *fb[:5])  # bp has no part in dx
    if x.dim() != 4 or g.dim() != 4 or g.shape[:3] != x.shape[:3]:
        raise ValueError(f"want x [B, H, W, C] and g [B, H, W, Co], got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    e, co, k = _check(tensors + (fb.bp,), fb, x.shape[3], act_type, residual)
    if g.shape[3] != co:
        raise ValueError(f"g has {g.shape[3]} channels, the block {co}")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return _launch("dx", [t.data_ptr() for t in tensors], x.shape, e, co, k,
                   act_type, residual, out, x.device)
