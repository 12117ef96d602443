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
reads out of bounds, and copies it to the card without waiting. The two
transposes also take small host tables, appended to the window table and
copied with it in the same transfer: the live rows of each strip of
`STRIP` columns (`pass2_bwd_ranges`), and the windows of each image in
table order with the live columns of each window's rows
(`pass1_bwd_ranges`). A live range covers every position that a non-zero
hat reads, widened by one on each side; the kernels still evaluate every
hat and skip the zeros, so a wide range costs time, never a tap.
`taps_near`, `taps_along` and `pass2_fwd_taps` are float32 twins of the
kernels' own intervals, and `hat` of their hat, for the tests.
The wrappers
take only contiguous float32 CUDA tensors (the kernels read single floats;
pass 2's forward takes 16-byte loads and stores where w % 4 == 0 and its
pointers allow, single floats elsewhere), launch on PyTorch's current
stream, allocate their outputs and nothing else, and raise on any refusal;
none falls back to the plain version. `LAUNCHES` counts the launches of each
kernel and `WINDOWS` the windows the pass-1 forward kernel has warped.
`pass2_fwd_ablation` launches pass 2's first kernel (a thread per output
pixel), bit-equal to `pass2_fwd`: no path calls it, and it counts in
`ABLATION_LAUNCHES` alone.
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
ABLATION_LAUNCHES = {"pass2_fwd_ablation": 0}  # launches of the ablation

TABLE_COLS = 8
STRIP = 32  # output columns of a pass2_bwd CTA (csrc/warp.cu kStrip)
QUAD = 4    # adjacent output pixels of a pass2_fwd thread (csrc/warp.cu kQuad)

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_counts() -> None:
    """Set every launch count and the window count to 0."""
    global WINDOWS
    for counts in (LAUNCHES, ABLATION_LAUNCHES):
        for name in counts:
            counts[name] = 0
    WINDOWS = 0


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entries of `csrc/warp.cu`, built on first use."""
    lib = _build.load("warp")
    sigs = {"pass1_fwd": [_P, _P, _I, _I, _I, _I, _P, _P],
            "pass2_fwd": [_P, _P, _I, _I, _I, _P, _P],
            "pass2_fwd_ablation": [_P, _P, _I, _I, _I, _P, _P],
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


def taps_near(c, r, n: int):
    """(lo, hi): the float32 twin of csrc/warp.cu `taps_near`, elementwise:
    the k in [0, n) with |c - k| < r, from floor(c - r) to ceil(c + r)."""
    c, r = np.asarray(c, np.float32), np.asarray(r, np.float32)
    return (np.clip(np.floor(c - r), 0, n).astype(np.int64),
            np.clip(np.ceil(c + r), -1, n - 1).astype(np.int64))


def pass2_fwd_taps(table_row, p0: int, w: int):
    """(lo, hi) [w, ceil(w / QUAD)]: the float32 twin of the interval that
    csrc/warp.cu `pass2_fwd_kernel` walks for the QUAD pixels (y, x0 ..
    x0 + QUAD - 1) of a thread, window `table_row` (8 floats): the union of
    their non-empty `taps_near` intervals around u = (a*y + b*x) + cu, the
    pixels past w left out; empty (lo > hi) where every one is."""
    f32 = np.float32
    a, b, cu, r = (f32(table_row[c]) for c in (3, 4, 5, 6))
    y = np.arange(w, dtype=f32)[:, None]
    x = np.arange(-(-w // QUAD) * QUAD, dtype=f32)[None, :]
    lo, hi = taps_near((a * y + b * x) + cu, r, p0)
    live = (lo <= hi) & (x < w)
    lo = np.where(live, lo, p0).reshape(w, -1, QUAD).min(-1)
    hi = np.where(live, hi, -1).reshape(w, -1, QUAD).max(-1)
    return lo, hi


def hat(c, k, r, unit: bool = False):
    """The float32 twin of csrc/warp.cu `hat<unit>`: max(0, 1 - |c - k| / r),
    with |c - k| in place of the quotient where `unit` (the kernels' r = 1
    instance)."""
    f32 = np.float32
    d = np.abs(np.asarray(c, f32) - np.asarray(k, f32))
    q = d if unit else d / np.asarray(r, f32)
    return np.maximum(f32(0), f32(1) - q)


def taps_along(slope, base, target, r, n: int):
    """(lo, hi): the float32 twin of csrc/warp.cu `taps_along`, elementwise.

    The k in [0, n) with |slope * k + base - target| < r ((0, n - 1) where
    slope is 0); empty when lo > hi. As in the kernel, the quotient by the
    slope is a product with its float32 reciprocal."""
    f32 = np.float32
    slope, base, target, r = (np.asarray(v, f32) for v in (slope, base, target, r))
    flat = slope == 0
    inv = f32(1) / np.where(flat, f32(1), slope)
    q0 = ((target - r) - base) * inv
    q1 = ((target + r) - base) * inv
    lo = np.clip(np.floor(np.minimum(q0, q1)), 0, n)
    hi = np.clip(np.ceil(np.maximum(q0, q1)), -1, n - 1)
    return (np.where(flat, 0, lo).astype(np.int64),
            np.where(flat, n - 1, hi).astype(np.int64))


def _live_range(slope, lo_t, hi_t, n: int) -> np.ndarray:
    """[..., 2] int32 inclusive ranges within [0, n) of the k with
    lo_t < slope * k < hi_t (float64), widened by one on each side; where
    slope is 0, every k or none."""
    out = np.empty(np.broadcast(slope, lo_t).shape + (2,), np.int32)
    flat = slope == 0
    if flat.any():  # never at |angle| <= 20 degrees
        slope = np.where(flat, 1.0, slope)
    q0, q1 = lo_t / slope, hi_t / slope
    np.clip(np.floor(np.minimum(q0, q1)) - 1, 0, n, out=out[..., 0],
            casting="unsafe")
    np.clip(np.ceil(np.maximum(q0, q1)) + 1, -1, n - 1, out=out[..., 1],
            casting="unsafe")
    if flat.any():
        every = np.broadcast_to(flat & (lo_t < 0) & (hi_t > 0), out.shape[:-1])
        none = np.broadcast_to(flat, out.shape[:-1]) & ~every
        out[every] = (0, n - 1)
        out[none] = (n, -1)
    return out


def pass2_bwd_ranges(table, p0: int, w: int) -> np.ndarray:
    """[N, ceil(w / STRIP), 2] int32: for each window and strip of STRIP
    output columns x, the rows y at which u(y, x) = a*y + b*x + cu lies in
    (-r, p0 - 1 + r) for some x of the strip: every row where pass 2 has a
    non-zero tap there."""
    q = np.asarray(table, np.float64)
    a, b, cu, r = (q[:, c, None] for c in (3, 4, 5, 6))
    x0 = np.arange(0, w, STRIP, dtype=np.float64)
    x1 = np.minimum(x0 + STRIP - 1, w - 1)
    bmin, bmax = np.minimum(b * x0, b * x1), np.maximum(b * x0, b * x1)
    return _live_range(a, -r - cu - bmax, (p0 - 1) + r - cu - bmin, w)


def pass1_bwd_ranges(table, n_images: int, p0: int, w: int):
    """(order [N], offsets [n_images + 1], cols [N, p0, 2]), int32: the
    windows sorted by image, stably, so each image's keep their table order;
    where each image's run starts; and for each window and canvas row i the
    columns x at which g(i, x) = g_i*i + g_x*x + g_c lies in
    (-r, p0 - 1 + r): every column where pass 1 has a non-zero tap."""
    q = np.asarray(table, np.float64)
    image = q[:, 7].astype(np.int64)
    order = np.argsort(image, kind="stable").astype(np.int32)
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(image, minlength=n_images))]).astype(np.int32)
    g_i, g_x, g_c, r = (q[:, c, None] for c in (0, 1, 2, 6))
    base = g_i * np.arange(p0, dtype=np.float64) + g_c          # [N, p0]
    cols = _live_range(g_x, -r - base, (p0 - 1) + r - base, w)
    return order, offsets, cols


def _launch(name: str, x: torch.Tensor, table: torch.Tensor, out_shape,
            *sizes, appendix=(), counts=LAUNCHES) -> torch.Tensor:
    """Copy the checked table, with its int32 appendix, to x's card in one
    transfer, launch kernel `name`, count it in `counts`."""
    dev = x.device
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    fn = _kernels()[name]
    host = table
    if len(appendix):
        host = torch.from_numpy(np.concatenate(
            [table.numpy().view(np.int32).ravel()]
            + [np.asarray(a, np.int32).ravel() for a in appendix]))
    with torch.cuda.device(dev):
        table_d = host.pin_memory().to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), table_d.data_ptr(), *sizes, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"warp {name} kernel launch failed: cudaError_t "
                           f"{err} (sizes {sizes})")
    counts[name] += 1
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


def _pass2_fwd(entry: str, counts, t: torch.Tensor, table: torch.Tensor
               ) -> torch.Tensor:
    _check_data("t", t, 4)
    n, p0, w, _ = t.shape
    check_table(table)
    if table.shape[0] != n:
        raise ValueError(f"t has {n} windows, the table {table.shape[0]}")
    return _launch(entry, t, table, (n, w, w, 3), n, p0, w, counts=counts)


def pass2_fwd(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """t [N, p0, w, 3] -> out [N, w, w, 3] (`eot.pass2_fwd`)."""
    return _pass2_fwd("pass2_fwd", LAUNCHES, t, table)


def pass2_fwd_ablation(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """`pass2_fwd` by its first kernel, a thread per output pixel: bit-equal,
    timed beside it; no path calls it."""
    return _pass2_fwd("pass2_fwd_ablation", ABLATION_LAUNCHES, t, table)


def pass2_bwd(g: torch.Tensor, table: torch.Tensor, p0: int) -> torch.Tensor:
    """g [N, w, w, 3] -> dt [N, p0, w, 3], the transpose of pass2_fwd."""
    _check_data("g", g, 4)
    n, w, wb, _ = g.shape
    if w != wb:
        raise ValueError(f"g must be [N, w, w, 3], got {tuple(g.shape)}")
    check_table(table)
    if table.shape[0] != n:
        raise ValueError(f"g has {n} windows, the table {table.shape[0]}")
    return _launch("pass2_bwd", g, table, (n, p0, w, 3), n, int(p0), w,
                   appendix=[pass2_bwd_ranges(table.numpy(), int(p0), w)])


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
                   int(n_images), p0, w,
                   appendix=pass1_bwd_ranges(table.numpy(), int(n_images), p0, w))
