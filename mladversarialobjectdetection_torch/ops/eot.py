"""Expectation-over-Transformation patch compositing (PyTorch).

Port of `mladversarialobjectdetection_tpu/ops/eot.py`: the adversarial patch
is colour-jittered, matched to the scene's brightness, pre-downsampled to a
small canvas, then scaled, rotated and placed on every live person box of a
batch, later slots over earlier ones.

Two backends share the geometry (`make_patch_geometry`):

* `matmul`, the training path: each live (image, slot) window of side `w`
  is resampled from its image's canvas by the two-pass separable hat-filter
  warp (pass 1 along the canvas minor axis, pass 2 along its major axis;
  the filter radius max(1, rho) antialiases downscaling). The JAX package
  runs it as bf16 einsums; here it is float32, and on the card the four
  passes are hand-written CUDA kernels (`ops/warp_cuda.py`, `csrc/warp.cu`,
  replacing `tools/experiments/pallas_warp{,2}.py`). `warp_windows` sends
  CUDA tensors to the kernels and CPU tensors to the plain versions
  (`pass1_fwd`, `pass2_fwd`, `pass2_bwd`, `pass1_bwd` below) and raises on
  anything else. All live windows of a step go through one launch per pass;
  only the composite is ordered.
* `gather`: the per-pixel bilinear gather, the reference geometry of the
  tests.

Randomness comes from an explicit `torch.Generator`, or is passed in as
`EOTDraws`: torch cannot reproduce JAX's threefry draws, so the parity tests
feed the JAX package's draws in. Which slots are live is read to the host
once per call (`_live_windows`); slots dead in the whole batch cost nothing.

Under a spatial mesh (`apply_patches(height=)`, `parallel/spatial.py`) the
images are this rank's rows: the geometry, the draws and the warp of every
window are the data shard's, alike on each rank of a spatial group; each
rank composites into its own rows (a window's rows offset by the shard's
first row, the rows outside it dropped), and the brightness and histogram
matches read the whole image's Y channel through sums over the group. The
gather backend, which draws per pixel of an image, gathers the rows, runs
on the data shard's whole images and returns this rank's rows of both
outputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..parallel import spatial
from ..utils.device import resolve_device
from . import color
from .preprocess import linear_resize_matrix

DEG20 = 20.0 * float(np.pi) / 180.0
SQRT2 = float(np.sqrt(np.float32(2.0)))  # jnp.sqrt(2.0): float32
_NORM_FLOOR = 1e-8


class PatchGeometry(NamedTuple):
    """Per-slot placement ([..., K] each)."""
    ymin: torch.Tensor   # region top (float)
    xmin: torch.Tensor   # region left (float)
    size: torch.Tensor   # patch square side s (float, floored)
    diag: torch.Tensor   # region side (float)
    angle: torch.Tensor  # rotation angle (radians)
    valid: torch.Tensor  # bool


class EOTDraws(NamedTuple):
    """Random draws of `apply_patches`, fed in instead of drawn.

    u_y, u_x [B, K]: centre jitter in [-1, 1), in units of tolerance * box/2;
    angle [B, K]: rotation (radians); random_scale [B, K]: per-slot scale
    (only with random_scale_range); print_gain, print_bias [B, 3]: the print
    transform of `color.random_print_adjust` (gain includes its .5 mean).
    """
    u_y: torch.Tensor
    u_x: torch.Tensor
    angle: torch.Tensor
    random_scale: Optional[torch.Tensor] = None
    print_gain: Optional[torch.Tensor] = None
    print_bias: Optional[torch.Tensor] = None


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def _uniform_rows(shape, lo: float, hi: float, generator, device
                  ) -> torch.Tensor:
    """`_uniform` of a batched shape (dim 0 the batch): under an active
    mesh, this rank's rows of the draw at the global batch's shape."""
    return parallel.draw_rows(
        lambda n: _uniform((n, *shape[1:]), lo, hi, generator, device),
        shape[0])


def make_patch_geometry(boxes: torch.Tensor, boxes_valid: torch.Tensor, scale,
                        img_hw: Tuple[int, int], *, tolerance: float = 0.2,
                        min_patch_area: float = 4.0,
                        random_scale_range: Tuple[float, float] | None = None,
                        max_region: Optional[float] = None,
                        rotation_mag: float = DEG20,
                        u_y: torch.Tensor | None = None,
                        u_x: torch.Tensor | None = None,
                        angle: torch.Tensor | None = None,
                        random_scale: torch.Tensor | None = None,
                        generator: torch.Generator | None = None
                        ) -> PatchGeometry:
    """Per-slot patch placement (eot.py:76-142) for boxes [..., K, 4].

    Draws not given (u_y, u_x, angle; random_scale with random_scale_range)
    come from `generator` (dim 0 of boxes is the batch: under an active mesh
    they are this rank's rows of the global batch's draws). The geometry
    does not depend on `scale`'s gradient, as in the reference (its floor
    and int cast cut the path).
    """
    h_img, w_img = float(img_hw[0]), float(img_hw[1])
    region_cap = w_img if max_region is None else min(w_img, float(max_region))
    dev = boxes.device
    shape = boxes.shape[:-1]
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    h = ymax - ymin
    w = xmax - xmin
    longer = torch.maximum(h, w)

    if random_scale_range is not None:
        lo, hi = random_scale_range
        scale_k = (_uniform_rows(shape, lo, hi, generator, dev)
                   if random_scale is None else random_scale.to(dev))
    else:
        scale_k = torch.as_tensor(scale, dtype=torch.float32,
                                  device=dev).expand(shape)
    scale_k = scale_k.detach()

    size = torch.floor(longer * scale_k)
    size = torch.clamp_max(size, region_cap)
    diag = torch.clamp_max(SQRT2 * size, region_cap)

    if u_y is None:
        u_y = _uniform_rows(shape, -1.0, 1.0, generator, dev)
    if u_x is None:
        u_x = _uniform_rows(shape, -1.0, 1.0, generator, dev)
    jy = u_y.to(dev) * (tolerance * h / 2.0)
    jx = u_x.to(dev) * (tolerance * w / 2.0)
    cy = ymin + h / 2.0 + jy
    cx = xmin + w / 2.0 + jx

    ymin_p = torch.clamp_min(cy - diag / 2.0, 0.0)
    xmin_p = torch.clamp_min(cx - diag / 2.0, 0.0)
    ymin_p = torch.where(ymin_p + diag > h_img, h_img - diag, ymin_p)
    xmin_p = torch.where(xmin_p + diag > w_img, w_img - diag, xmin_p)

    if angle is None:
        angle = _uniform_rows(shape, -rotation_mag, rotation_mag, generator, dev)
    valid = boxes_valid.to(dev) & (size * size > min_patch_area)
    return PatchGeometry(ymin_p, xmin_p, size, diag, angle.to(dev), valid)


def downsample_canvas(patch: torch.Tensor, p0: int) -> torch.Tensor:
    """[..., P, P, 3] -> [..., p0, p0, 3] separable antialiased resize."""
    p = patch.shape[-3]
    if p == p0:
        return patch
    r = torch.from_numpy(linear_resize_matrix(p0, p)).to(patch)
    out = torch.einsum("oi,...ijc->...ojc", r, patch)
    return torch.einsum("oj,...ijc->...ioc", r, out)


# ---------------------------------------------------------------------------
# the two-pass warp: window table, plain passes, dispatch
# ---------------------------------------------------------------------------

def _warp_scalars(canvas_p0: int, oy, ox, ymin, xmin, size, diag, angle):
    """Affine scalars of the two-pass warp (eot.py:172-194), elementwise.

    Returns ((g_i, g_x, g_c), (a, b, cu), radius): pass 1 resamples along
    the canvas minor axis j at g(i, x) = g_i*i + g_x*x + g_c, pass 2 along i
    at u(y, x) = a*y + b*x + cu."""
    cyx = (diag - 1.0) / 2.0
    off = (diag - size) / 2.0
    rho = canvas_p0 / torch.clamp_min(size, 1.0)
    cos_a = torch.cos(angle)
    sin_a = torch.sin(angle)
    a = cos_a * rho
    b = sin_a * rho
    d = -sin_a * rho
    e = cos_a * rho
    base_y = oy - ymin - cyx
    base_x = ox - xmin - cyx
    cu = (cos_a * base_y + sin_a * base_x + cyx - off + 0.5) * rho - 0.5
    cv = (-sin_a * base_y + cos_a * base_x + cyx - off + 0.5) * rho - 0.5
    g_i = d / a
    g_x = e - d * b / a
    g_c = cv - d * cu / a
    radius = torch.clamp_min(rho, 1.0)
    return (g_i, g_x, g_c), (a, b, cu), radius


def window_table(canvas_p0: int, oy, ox, ymin, xmin, size, diag, angle,
                 image) -> torch.Tensor:
    """The [N, 8] window table of the warp passes: per window (g_i, g_x, g_c,
    a, b, cu, radius, image index), float32, from [N] geometry."""
    (g_i, g_x, g_c), (a, b, cu), radius = _warp_scalars(
        canvas_p0, oy, ox, ymin, xmin, size, diag, angle)
    return torch.stack([g_i, g_x, g_c, a, b, cu, radius,
                        image.to(torch.float32)], dim=-1).to(torch.float32)


def _hat(dist: torch.Tensor, radius) -> torch.Tensor:
    return torch.clamp_min(1.0 - torch.abs(dist) / radius, 0.0)


def _cols(table: torch.Tensor, cols: Sequence[int], ndim: int):
    return [table[:, c].reshape((-1,) + (1,) * (ndim - 1)) for c in cols]


def _pass1_weights(table: torch.Tensor, p0: int, w: int) -> torch.Tensor:
    """hat(g(i, x) - j) for every window: [N, p0(i), w(x), p0(j)]."""
    g_i, g_x, g_c, r = _cols(table, (0, 1, 2, 6), 3)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=table.device)
    g = (g_i * ar(p0)[:, None] + g_x * ar(w)[None, :]) + g_c   # [N, i, x]
    return _hat(g[..., None] - ar(p0), r[..., None])


def _pass2_weights(table: torch.Tensor, p0: int, w: int) -> torch.Tensor:
    """hat(u(y, x) - i) for every window: [N, w(y), w(x), p0(i)]."""
    a, b, cu, r = _cols(table, (3, 4, 5, 6), 3)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=table.device)
    u = (a * ar(w)[:, None] + b * ar(w)[None, :]) + cu        # [N, y, x]
    return _hat(u[..., None] - ar(p0), r[..., None])


def _inv_norm(hat: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp_min(hat.sum(-1, keepdim=True), _NORM_FLOOR)


def pass1_fwd(canvases: torch.Tensor, table: torch.Tensor, w: int) -> torch.Tensor:
    """Plain pass 1: canvases [B, p0, p0, 3] -> t [N, p0, w, 3].

    t[n,i,x,c] = sum_j hat(g(i,x) - j) canvas[img(n),i,j,c] / max(sum_j hat,
    1e-8), dense over j (pallas_warp2.py:77-106)."""
    table = table.to(canvases.device)
    hat = _pass1_weights(table, canvases.shape[1], int(w))
    src = canvases[table[:, 7].long()]                          # [N, i, j, c]
    return torch.einsum("nixj,nijc->nixc", hat, src) * _inv_norm(hat)


def pass2_fwd(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain pass 2: t [N, p0, w, 3] -> out [N, w, w, 3].

    out[n,y,x,c] = sum_i hat(u(y,x) - i) t[n,i,x,c] / max(sum_i hat, 1e-8)
    (pallas_warp2.py:133-163)."""
    table = table.to(t.device)
    hat = _pass2_weights(table, t.shape[1], t.shape[2])
    return torch.einsum("nyxi,nixc->nyxc", hat, t) * _inv_norm(hat)


def pass2_bwd(g: torch.Tensor, table: torch.Tensor, p0: int) -> torch.Tensor:
    """Plain transpose of pass 2: g [N, w, w, 3] -> dt [N, p0, w, 3].

    dt[n,i,x,c] = sum_y hat(u(y,x) - i) (g[n,y,x,c] / max(sum_i' hat, 1e-8))
    (pallas_warp2.py:190-221)."""
    table = table.to(g.device)
    hat = _pass2_weights(table, int(p0), g.shape[1])
    gn = g / torch.clamp_min(hat.sum(-1, keepdim=True), _NORM_FLOOR)
    return torch.einsum("nyxi,nyxc->nixc", hat, gn)


def pass1_bwd(dt: torch.Tensor, table: torch.Tensor, n_images: int
              ) -> torch.Tensor:
    """Plain transpose of pass 1: dt [N, p0, w, 3] -> dcanvases
    [n_images, p0, p0, 3], summed over the windows of each image.

    dcanvas[b,i,j,c] = sum_{n: img(n)=b} sum_x hat(g(i,x) - j) (dt[n,i,x,c] /
    max(sum_j' hat, 1e-8)) (pallas_warp2.py:246-276)."""
    table = table.to(dt.device)
    n, p0, w, _ = dt.shape
    hat = _pass1_weights(table, p0, w)
    dn = dt / torch.clamp_min(hat.sum(-1, keepdim=True), _NORM_FLOOR)
    per_window = torch.einsum("nixj,nixc->nijc", hat, dn)
    out = torch.zeros((int(n_images), p0, p0, 3), dtype=dt.dtype,
                      device=dt.device)
    return out.index_add_(0, table[:, 7].long(), per_window)


class _TwoPassWarp(torch.autograd.Function):
    """canvases -> samples through pass 1 and pass 2; the backward runs the
    two transposes. The geometry gets no cotangent (eot.py:120-123), and the
    backward needs only the window table, so nothing per window is saved."""

    @staticmethod
    def forward(ctx, canvases, table, w, passes):
        p1, p2, _, _ = passes
        ctx.passes = passes
        ctx.n_images, ctx.p0 = canvases.shape[0], canvases.shape[1]
        ctx.save_for_backward(table)
        return p2(p1(canvases, table, w), table)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (table,) = ctx.saved_tensors
        _, _, p2_t, p1_t = ctx.passes
        dt = p2_t(g.contiguous(), table, ctx.p0)
        return p1_t(dt, table, ctx.n_images), None, None, None


def warp_windows(canvases: torch.Tensor, table: torch.Tensor, w: int
                 ) -> torch.Tensor:
    """Warp every window of `table` (host [N, 8]) from its image's canvas.

    canvases [B, p0, p0, 3] float32 -> samples [N, w, w, 3], differentiable
    in the canvases. CUDA tensors go through the four CUDA kernels, which
    launch or raise; CPU tensors through the plain passes."""
    if canvases.is_cuda:
        from . import warp_cuda
        passes = (warp_cuda.pass1_fwd, warp_cuda.pass2_fwd,
                  warp_cuda.pass2_bwd, warp_cuda.pass1_bwd)
    elif canvases.device.type == "cpu":
        passes = (pass1_fwd, pass2_fwd, pass2_bwd, pass1_bwd)
    else:
        raise ValueError(f"no warp for device {canvases.device}")
    return _TwoPassWarp.apply(canvases.contiguous(), table, int(w), passes)


# ---------------------------------------------------------------------------
# matmul backend: windowed composite of every live slot
# ---------------------------------------------------------------------------

def _inside_region_masks(oy, ox, ymin, xmin, size, diag, angle, w: int):
    """Analytic inside-the-patch and region masks [N, w, w] (eot.py:197-217)."""
    cyx = (diag - 1.0) / 2.0
    off = (diag - size) / 2.0
    cos_a = torch.cos(angle)[:, None, None]
    sin_a = torch.sin(angle)[:, None, None]
    ar = torch.arange(w, dtype=torch.float32, device=oy.device)
    col = lambda v: v[:, None, None]
    yy = col(oy) + ar[None, :, None]
    xx = col(ox) + ar[None, None, :]
    ly = yy - col(ymin) - col(cyx)
    lx = xx - col(xmin) - col(cyx)
    sy = cos_a * ly + sin_a * lx + col(cyx)
    sx = -sin_a * ly + cos_a * lx + col(cyx)
    py = sy - col(off)
    px = sx - col(off)
    s = col(size)
    inside = (py > -0.5) & (py < s - 0.5) & (px > -0.5) & (px < s - 0.5)
    region = ((yy >= col(ymin)) & (yy < col(ymin) + col(diag))
              & (xx >= col(xmin)) & (xx < col(xmin) + col(diag)))
    return inside, region


class LiveWindows(NamedTuple):
    """The live (image, slot) windows of a step, slot-major, on the host."""
    image: torch.Tensor  # [N] int64
    slot: torch.Tensor   # [N] int64
    geom: torch.Tensor   # [N, 7] float32: oy, ox, ymin, xmin, size, diag, angle
    mask: torch.Tensor   # [B, K] bool: which slots are live


def _live_windows(geom: PatchGeometry, h_img: int, w_img: int, window: int
                  ) -> LiveWindows:
    """One host read of the geometry: the live windows and their origins.

    The window origin is clip(floor(ymin), 0, H - w) (eot.py:357-359)."""
    host = torch.stack([geom.ymin, geom.xmin, geom.size, geom.diag,
                        geom.angle, geom.valid.to(torch.float32)],
                       dim=-1).detach().cpu()                  # [B, K, 6]
    mask = host[..., 5] > 0
    slot, image = mask.t().nonzero(as_tuple=True)
    ymin, xmin, size, diag, angle, _ = host[image, slot].unbind(-1)
    oy = torch.clamp(torch.floor(ymin), 0.0, float(h_img - window))
    ox = torch.clamp(torch.floor(xmin), 0.0, float(w_img - window))
    return LiveWindows(image, slot, torch.stack(
        [oy, ox, ymin, xmin, size, diag, angle], dim=-1), mask)


def _window_noise(live: LiveWindows, window: int, noise_mag: float,
                  generator, dev) -> torch.Tensor:
    """Sensor noise [N, w, w, 3] of the live windows. Under an active mesh
    it is drawn for the global batch's live windows, slot-major as one
    process orders them (the live masks gathered), and this rank keeps its
    own; every rank draws, so the replicated generator stays replicated.
    Nothing is drawn where no window is live."""
    shape = (window, window, 3)
    group = parallel.data_group()
    if group is None:
        n = live.image.numel()
        return (_uniform((n, *shape), -noise_mag, noise_mag, generator, dev)
                if n else torch.zeros((0, *shape), device=dev))
    b, k = live.mask.shape
    mask = parallel.all_gather_rows(live.mask.to(dev, torch.uint8)).cpu() > 0
    n_all = int(mask.sum())
    if n_all == 0:
        return torch.zeros((0, *shape), device=dev)
    order = (mask.t().reshape(-1).cumsum(0) - 1).view(k, -1)
    _, start = parallel.global_rows(b)
    full = _uniform((n_all, *shape), -noise_mag, noise_mag, generator, dev)
    return full[order[live.slot, live.image + start].to(dev)]


def _composite_matmul_batch(images: torch.Tensor, canvases: torch.Tensor,
                            geom: PatchGeometry, *, noise_mag: float,
                            brightness_mag: float, window: int,
                            generator: torch.Generator | None = None,
                            rows_of: Tuple[int, int] | None = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed composite of every live slot over a batch (eot.py:298-387).

    images [B, H, W, 3]; canvases [B, p0, p0, 3]; geom fields [B, K]. All
    live windows are warped at once; then slot by slot, each window is
    pasted where the patch covers it (slot k + 1 over slot k), with fresh
    sensor noise per window and a brightness shift per (image, slot).
    `rows_of` (first row, global height): images are those rows of taller
    images, and each window writes only its rows among them. Returns
    (patched images, region masks [B, H, W] bool)."""
    b, h_img, w_img, _ = images.shape
    k = geom.ymin.shape[1]
    dev = images.device
    bright = _uniform_rows((b, k), -brightness_mag, brightness_mag, generator,
                           dev)
    region_any = torch.zeros((b, h_img, w_img), dtype=torch.bool, device=dev)
    live = _live_windows(geom, h_img if rows_of is None else rows_of[1], w_img,
                         window)
    noise = _window_noise(live, window, noise_mag, generator, dev)
    n = live.image.numel()
    if n == 0:
        return images, region_any
    oy, ox, ymin, xmin, size, diag, angle = live.geom.unbind(-1)
    table = window_table(canvases.shape[1], oy, ox, ymin, xmin, size, diag,
                         angle, live.image)
    samples = warp_windows(canvases, table, window)            # [N, w, w, 3]
    win_geom = live.geom.to(dev)
    inside, region = _inside_region_masks(*win_geom.unbind(-1), window)
    img = live.image.to(dev)
    val = torch.clamp(samples + noise
                      + bright[img, live.slot.to(dev)][:, None, None, None],
                      -1.0, 1.0)
    ar = torch.arange(window, device=dev)
    rows = win_geom[:, 0].long()[:, None] + ar                   # [N, w]
    cols = win_geom[:, 1].long()[:, None] + ar
    out = images
    if rows_of is not None:
        # a row outside this shard goes to one of two scratch rows around
        # it (written in any order, then dropped)
        rows = torch.clamp(rows - rows_of[0], -1, h_img) + 1
        out = F.pad(images, (0, 0, 0, 0, 1, 1))
        region_any = F.pad(region_any, (0, 0, 1, 1))
    bounds = torch.searchsorted(live.slot, torch.unique(live.slot),
                                right=True).tolist()
    start = 0
    for end in bounds:
        at = (img[start:end, None, None], rows[start:end, :, None],
              cols[start:end, None, :])
        new = torch.where(inside[start:end, ..., None], val[start:end], out[at])
        out = out.index_put(at, new)
        region_any = region_any.index_put(at, region_any[at] | region[start:end])
        start = end
    if rows_of is not None:
        out, region_any = out[:, 1:-1], region_any[:, 1:-1]
    return out, region_any


# ---------------------------------------------------------------------------
# gather backend (reference implementation for tests)
# ---------------------------------------------------------------------------

def _composite_gather(image: torch.Tensor, patch_canvas: torch.Tensor,
                      geom: PatchGeometry, *, noise_mag: float,
                      brightness_mag: float,
                      generator: torch.Generator | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel bilinear-gather composite of one image (eot.py:394-455)."""
    h_img, w_img, _ = image.shape
    p = patch_canvas.shape[0]
    k = geom.ymin.shape[0]
    dev = image.device
    yy = torch.arange(h_img, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w_img, dtype=torch.float32, device=dev)[None, :]
    bright = _uniform((k,), -brightness_mag, brightness_mag, generator, dev)
    out = image
    region_any = torch.zeros((h_img, w_img), dtype=torch.bool, device=dev)
    for i in range(k):
        noise = _uniform(image.shape, -noise_mag, noise_mag, generator, dev)
        ymin, xmin = geom.ymin[i], geom.xmin[i]
        size, diag, angle = geom.size[i], geom.diag[i], geom.angle[i]
        ok = geom.valid[i]
        cyx = (diag - 1.0) / 2.0
        ly = yy - ymin - cyx
        lx = xx - xmin - cyx
        cos_a, sin_a = torch.cos(angle), torch.sin(angle)
        sy = cos_a * ly + sin_a * lx + cyx
        sx = -sin_a * ly + cos_a * lx + cyx
        off = (diag - size) / 2.0
        py = sy - off
        px = sx - off
        inside = ((py > -0.5) & (py < size - 0.5)
                  & (px > -0.5) & (px < size - 0.5))
        region = ((yy >= ymin) & (yy < ymin + diag)
                  & (xx >= xmin) & (xx < xmin + diag))
        rho = p / torch.clamp_min(size, 1.0)
        u = torch.clamp((py + 0.5) * rho - 0.5, 0.0, p - 1.0)
        v = torch.clamp((px + 0.5) * rho - 0.5, 0.0, p - 1.0)
        u0, v0 = torch.floor(u), torch.floor(v)
        fu, fv = (u - u0)[..., None], (v - v0)[..., None]
        u0i, v0i = u0.long(), v0.long()
        u1i = torch.clamp_max(u0i + 1, p - 1)
        v1i = torch.clamp_max(v0i + 1, p - 1)
        val = ((1 - fu) * (1 - fv) * patch_canvas[u0i, v0i]
               + (1 - fu) * fv * patch_canvas[u0i, v1i]
               + fu * (1 - fv) * patch_canvas[u1i, v0i]
               + fu * fv * patch_canvas[u1i, v1i])
        val = torch.clamp(val + noise + bright[i], -1.0, 1.0)
        out = torch.where((inside & ok)[..., None], val, out)
        region_any = region_any | (region & ok)
    return out, region_any


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def default_window(img_hw: Tuple[int, int]) -> int:
    """Slot-window side (eot.py:462-468): min(image, 384)."""
    return min(img_hw[0], img_hw[1], 384)


def apply_patches(images, boxes, boxes_valid, patch, scale, *,
                  generator: torch.Generator | None = None,
                  draws: EOTDraws | None = None, device=None,
                  tolerance: float = 0.2, min_patch_area: float = 4.0,
                  noise_mag: float = 0.01, brightness_mag: float = 0.3,
                  random_scale_range: Tuple[float, float] | None = None,
                  per_image_patches=None,
                  use_histogram_match: bool = False,
                  backend: str = "matmul", window: Optional[int] = None,
                  canvas_res: int = 96, rotation_mag: float = DEG20,
                  print_jitter: bool = True, height: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the adversarial patch to every valid person box of a batch.

    Port of `eot.apply_patches` (eot.py:471-570), with the same options.

    Args:
      images: [B, H, W, 3] in [-1, 1].
      boxes: [B, K, 4] person boxes in pixels; boxes_valid: [B, K] bool.
      patch: [P, P, 3] patch in [-1, 1] (the trainable patch), ignored if
        per_image_patches ([B, P', P', 3]) is given.
      scale: scalar patch scale in [0, 1].
      generator: source of the random draws not given in `draws`. Under an
        active mesh (`parallel.use_mesh`) images is this rank's rows of the
        global batch, and every draw of the matmul backend is made at the
        global batch's shape from the replicated generator, this rank
        keeping its rows: the ranks draw what one process draws for the
        global batch. The gather backend draws per image, for this rank's
        images alone.
      draws: fed-in draws (`EOTDraws`, this rank's rows), for parity with
        the JAX package.
      device: "cuda" (the default) or "cpu"; inputs are moved there.
      backend: 'matmul' (the two-pass warp) or 'gather'.
      window, canvas_res, rotation_mag, print_jitter: as in the JAX package.
      height: the images' global height. Under a spatial mesh that
        row-shards it, images holds this rank's rows and the results too.

    Returns:
      (patched images [B, H, W, 3], region masks [B, H, W] bool).
    """
    if backend not in ("matmul", "gather"):
        raise ValueError(f"unknown EOT backend {backend!r}")
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev)
    images, boxes, patch = f32(images), f32(boxes), f32(patch)
    boxes_valid = torch.as_tensor(boxes_valid, dtype=torch.bool).to(dev)
    b = images.shape[0]
    img_hw = (images.shape[1], images.shape[2])
    rows_of, group_sum = None, None
    if spatial.sharded(height) and backend == "gather":
        # per-image draws at the whole image's shape: run whole, keep my rows
        out, region = apply_patches(
            spatial.gather_rows(images, dim=1), boxes, boxes_valid, patch, scale,
            generator=generator, draws=draws, device=device, tolerance=tolerance,
            min_patch_area=min_patch_area, noise_mag=noise_mag,
            brightness_mag=brightness_mag, random_scale_range=random_scale_range,
            per_image_patches=per_image_patches,
            use_histogram_match=use_histogram_match, backend=backend, window=window,
            canvas_res=canvas_res, rotation_mag=rotation_mag, print_jitter=print_jitter)
        return spatial.local_rows(out, dim=1), spatial.local_rows(region, dim=1)
    if spatial.sharded(height):
        sp = spatial.active()
        img_hw = (height, images.shape[2])
        rows_of = (sp.index * images.shape[1], height)
        group_sum = lambda t: parallel.reduce_sum(t, parallel.SPATIAL_AXIS)
    window = min(window or default_window(img_hw), img_hw[0], img_hw[1])
    max_region = None if backend == "gather" else float(window)

    src = (f32(per_image_patches) if per_image_patches is not None
           else patch.expand(b, *patch.shape))
    if print_jitter:
        # gain ~ N(.5, .1), then bias ~ N(0, .01), [B, 3] rows of the global
        # batch's draws (`color.random_print_adjust`'s draws)
        randn = lambda n: torch.randn((n, 3), generator=generator, device=dev,
                                      dtype=src.dtype)
        gain = draws.print_gain if draws else None
        if gain is None:
            gain = 0.5 + 0.1 * parallel.draw_rows(randn, b)
        bias = draws.print_bias if draws else None
        if bias is None:
            bias = 0.01 * parallel.draw_rows(randn, b)
        printed = color.random_print_adjust(src, generator, gain=gain, bias=bias)
    else:
        printed = torch.clamp(0.5 * src, -1.0, 1.0)
    match = color.histogram_match if use_histogram_match else color.brightness_match
    canvases = match(printed, images, group_sum)
    geom = make_patch_geometry(
        boxes, boxes_valid, scale, img_hw, tolerance=tolerance,
        min_patch_area=min_patch_area, random_scale_range=random_scale_range,
        max_region=max_region, rotation_mag=rotation_mag,
        u_y=draws.u_y if draws else None, u_x=draws.u_x if draws else None,
        angle=draws.angle if draws else None,
        random_scale=draws.random_scale if draws else None,
        generator=generator)

    if backend == "matmul":
        p0 = min(canvas_res, canvases.shape[1])
        return _composite_matmul_batch(
            images, downsample_canvas(canvases, p0), geom,
            noise_mag=noise_mag, brightness_mag=brightness_mag,
            window=window, generator=generator, rows_of=rows_of)
    outs = [_composite_gather(images[i], canvases[i],
                              PatchGeometry(*(f[i] for f in geom)),
                              noise_mag=noise_mag,
                              brightness_mag=brightness_mag,
                              generator=generator) for i in range(b)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([r for _, r in outs]))


def total_variation(img: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation of an [H, W, C] image (eot.py:573-578)."""
    dh = torch.abs(img[1:, :, :] - img[:-1, :, :])
    dw = torch.abs(img[:, 1:, :] - img[:, :-1, :])
    return torch.sum(dh) + torch.sum(dw)
