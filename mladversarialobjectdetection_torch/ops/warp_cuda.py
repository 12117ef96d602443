"""The CUDA kernels of the EOT two-pass warp (`csrc/warp.cu`) and their wrappers.

Replace the Pallas TPU kernels of `tools/experiments/pallas_warp.py`
(`_pass1_fwd_kernel`, `_pass1_bwd_kernel`, `_pass2_fwd_kernel`,
`_pass2_bwd_kernel`) and `tools/experiments/pallas_warp2.py` (the same four
functions, channel-major). Each wrapper has the signature of the plain
version of the same name in `ops/eot.py`: a whole step's live windows in one
launch, described by a window table `[N, 8]` of (g_i, g_x, g_c, a, b, cu,
radius, image) rows (`eot.window_table`).

The table lives on the host: each wrapper checks it there (shape, finite
values, radius > 0, integral image indices in range), so that a kernel never
reads out of bounds, and copies it to the card without waiting. The wrappers
take only contiguous float32 CUDA tensors (the kernels read single floats,
so no alignment beyond a float's is needed), launch on PyTorch's current
stream, allocate their outputs and nothing else, and raise on any refusal;
none falls back to the plain version. `LAUNCHES` counts the launches of each
kernel and `WINDOWS` the windows the pass-1 forward kernel has warped.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build

# kernel launches made by the wrappers in this process, per kernel
LAUNCHES = {"pass1_fwd": 0, "pass2_fwd": 0, "pass2_bwd": 0, "pass1_bwd": 0}
WINDOWS = 0  # windows warped by pass1_fwd launches in this process

TABLE_COLS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_counts() -> None:
    """Set every launch count and the window count to 0."""
    global WINDOWS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    WINDOWS = 0


@functools.lru_cache(maxsize=None)
def _kernels():
    """The four C entries of `csrc/warp.cu`, built on first use."""
    lib = _build.load("warp")
    sigs = {"pass1_fwd": [_P, _P, _I, _I, _I, _I, _P, _P],
            "pass2_fwd": [_P, _P, _I, _I, _I, _P, _P],
            "pass2_bwd": [_P, _P, _I, _I, _I, _P, _P],
            "pass1_bwd": [_P, _P, _I, _I, _I, _I, _P, _P]}
    fns = {}
    for name, argtypes in sigs.items():
        fn = getattr(lib, f"mlad_warp_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def check_table(table: torch.Tensor, n_images: int | None = None) -> None:
    """Raise unless `table` is a host float32 [N, 8] window table whose image
    indices (when n_images is given) lie in [0, n_images)."""
    if table.device.type != "cpu":
        raise ValueError(f"the window table lives on the host, got {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or \
            table.shape[1] != TABLE_COLS or table.shape[0] < 1:
        raise ValueError(f"want a float32 [N >= 1, {TABLE_COLS}] window table, "
                         f"got {table.dtype} {tuple(table.shape)}")
    q = table.numpy()  # numpy: a few microseconds on a table of N <= 384 rows
    if not np.isfinite(q).all():
        raise ValueError("window table holds non-finite values")
    if not (q[:, 6] > 0).all():
        raise ValueError("window radius must be > 0")
    img = q[:, 7]
    if n_images is not None and not (
            (img == np.floor(img)) & (img >= 0) & (img < n_images)).all():
        raise ValueError(f"window image index out of [0, {n_images})")


def _check_data(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"{name}: takes CUDA tensors; use the plain version "
                         f"in ops/eot.py on the CPU")
    if x.dim() != ndim or x.shape[-1] != 3:
        raise ValueError(f"{name}: want [..., 3] of rank {ndim}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, x: torch.Tensor, table: torch.Tensor, out_shape,
            *sizes) -> torch.Tensor:
    """Copy the checked table to x's card, launch kernel `name`, count it."""
    dev = x.device
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    fn = _kernels()[name]
    with torch.cuda.device(dev):
        table_d = table.pin_memory().to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), table_d.data_ptr(), *sizes, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"warp {name} kernel launch failed: cudaError_t "
                           f"{err} (sizes {sizes})")
    LAUNCHES[name] += 1
    return out


def pass1_fwd(canvases: torch.Tensor, table: torch.Tensor, w: int) -> torch.Tensor:
    """canvases [B, p0, p0, 3] -> t [N, p0, w, 3] (`eot.pass1_fwd`)."""
    global WINDOWS
    _check_data("canvases", canvases, 4)
    b, p0, p0b, _ = canvases.shape
    if p0 != p0b:
        raise ValueError(f"canvases must be square, got {tuple(canvases.shape)}")
    check_table(table, b)
    n = table.shape[0]
    out = _launch("pass1_fwd", canvases, table, (n, p0, w, 3), n, b, p0, int(w))
    WINDOWS += n
    return out


def pass2_fwd(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """t [N, p0, w, 3] -> out [N, w, w, 3] (`eot.pass2_fwd`)."""
    _check_data("t", t, 4)
    n, p0, w, _ = t.shape
    check_table(table)
    if table.shape[0] != n:
        raise ValueError(f"t has {n} windows, the table {table.shape[0]}")
    return _launch("pass2_fwd", t, table, (n, w, w, 3), n, p0, w)


def pass2_bwd(g: torch.Tensor, table: torch.Tensor, p0: int) -> torch.Tensor:
    """g [N, w, w, 3] -> dt [N, p0, w, 3], the transpose of pass2_fwd."""
    _check_data("g", g, 4)
    n, w, wb, _ = g.shape
    if w != wb:
        raise ValueError(f"g must be [N, w, w, 3], got {tuple(g.shape)}")
    check_table(table)
    if table.shape[0] != n:
        raise ValueError(f"g has {n} windows, the table {table.shape[0]}")
    return _launch("pass2_bwd", g, table, (n, p0, w, 3), n, int(p0), w)


def pass1_bwd(dt: torch.Tensor, table: torch.Tensor, n_images: int
              ) -> torch.Tensor:
    """dt [N, p0, w, 3] -> dcanvases [n_images, p0, p0, 3], the transpose of
    pass1_fwd, summed over the windows of each image."""
    _check_data("dt", dt, 4)
    n, p0, w, _ = dt.shape
    check_table(table, n_images)
    if table.shape[0] != n:
        raise ValueError(f"dt has {n} windows, the table {table.shape[0]}")
    return _launch("pass1_bwd", dt, table, (n_images, p0, p0, 3), n,
                   int(n_images), p0, w)
