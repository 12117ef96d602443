"""The port's EOT compositor against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages. Random
draws cannot be shared between JAX's threefry and torch, so the JAX draws are
replayed from the same key splits as `eot.apply_patches` (eot.py:527-534,
:108, color.py:124-126) and fed into the port; sensor noise and brightness
are pinned to 0 where outputs are compared, and the port's own draws are
checked by their distributions. Tolerances:

- `linear_resize_matrix`: bit-equal (the same numpy arithmetic);
- colour ops: 1e-6 (float32 elementwise); the scene matchers 2e-6 (their
  means sum in another order, and the [0, 1] result is scaled by 255/127);
- geometry: 1e-5 px;
- each plain warp pass against the Pallas TPU kernels (`pallas_warp2`, and
  `pallas_warp` v1) in interpret mode: 1e-5 of the output's scale (float32
  on both sides; the sums run in another order);
- `apply_patches` against the JAX matmul backend: the same regions, samples
  within 0.02, the bf16 bound of `tools/experiments/test_pallas_warp.py:91`
  (that backend rounds the canvas and the hat weights to bf16,
  eot.py:265-278); against the fp32 gather backend: 1e-4.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.ops import color as jcolor
from mladversarialobjectdetection_tpu.ops import eot as jeot
from mladversarialobjectdetection_tpu.ops import preprocess as jpre
from mladversarialobjectdetection_torch.ops import color as pcolor
from mladversarialobjectdetection_torch.ops import eot as peot
from mladversarialobjectdetection_torch.ops import preprocess as ppre
from mladversarialobjectdetection_torch.ops import warp_cuda

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools" / "experiments"))
import pallas_warp  # noqa: E402  the archived TPU kernels, v1
import pallas_warp2  # noqa: E402  v2, channel-major

PASS_TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    """Run the Pallas TPU kernels in interpret mode, as their own tests do."""
    old = pallas_warp._INTERPRET, pallas_warp2._INTERPRET
    pallas_warp._INTERPRET = pallas_warp2._INTERPRET = True
    yield
    pallas_warp._INTERPRET, pallas_warp2._INTERPRET = old


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def assert_close(port, ref, tol, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def jax_draws(key, b, k, *, rotation_mag=jeot.DEG20, random_scale_range=None):
    """The draws `jeot.apply_patches(key, ...)` makes, as `peot.EOTDraws`."""
    cols = {f: [] for f in peot.EOTDraws._fields}
    for kk in jax.random.split(key, b):
        k_print, k_geom, _ = jax.random.split(kk, 3)
        k_scale, k_y, k_x, k_a = jax.random.split(k_geom, 4)
        cols["u_y"].append(jax.random.uniform(k_y, (k,), minval=-1.0, maxval=1.0))
        cols["u_x"].append(jax.random.uniform(k_x, (k,), minval=-1.0, maxval=1.0))
        cols["angle"].append(jax.random.uniform(
            k_a, (k,), minval=-rotation_mag, maxval=rotation_mag))
        if random_scale_range is not None:
            lo, hi = random_scale_range
            cols["random_scale"].append(jax.random.uniform(
                k_scale, (k,), minval=lo, maxval=hi))
        kw, kb = jax.random.split(k_print)
        cols["print_gain"].append(
            0.5 + 0.1 * jax.random.normal(kw, (1, 1, 3)).reshape(3))
        cols["print_bias"].append(0.01 * jax.random.normal(kb, (1, 1, 3)).reshape(3))
    return peot.EOTDraws(**{f: (t(np.stack(v)) if v else None)
                            for f, v in cols.items()})


# ---------------------------------------------------------------------------
# resize matrix, colour, geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_out,n_in", [(96, 640), (32, 32), (17, 50), (50, 17)])
def test_linear_resize_matrix_bit_equal(n_out, n_in):
    ref = jpre.linear_resize_matrix(n_out, n_in)
    out = ppre.linear_resize_matrix(n_out, n_in)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


@pytest.fixture(scope="module")
def rgb_pair():
    rng = np.random.default_rng(0)
    src = rng.uniform(-1, 1, (2, 24, 24, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, 40, 36, 3)).astype(np.float32)
    tgt[1] = tgt[1] * 0.3 + 0.5  # a bright, low-contrast scene
    return src, tgt


def test_color_space_matches_jax(rgb_pair):
    src, _ = rgb_pair
    assert_close(pcolor.rgb_to_yuv(t(src)), jcolor.rgb_to_yuv(jnp.asarray(src)), 1e-6)
    assert_close(pcolor.yuv_to_rgb(t(src)), jcolor.yuv_to_rgb(jnp.asarray(src)), 1e-6)


@pytest.mark.parametrize("fn", ["brightness_match", "histogram_match"])
def test_scene_matching_matches_jax(rgb_pair, fn):
    src, tgt = rgb_pair
    out = getattr(pcolor, fn)(t(src), t(tgt))
    for i in range(src.shape[0]):
        ref = getattr(jcolor, fn)(jnp.asarray(src[i]), jnp.asarray(tgt[i]))
        assert_close(out[i], ref, 2e-6, fn)


def test_random_print_adjust_with_fed_draws(rgb_pair):
    src, _ = rgb_pair
    key = jax.random.PRNGKey(3)
    ref = jcolor.random_print_adjust(key, jnp.asarray(src[0]))
    kw, kb = jax.random.split(key)
    gain = 0.5 + 0.1 * np.asarray(jax.random.normal(kw, (1, 1, 3))).reshape(3)
    bias = 0.01 * np.asarray(jax.random.normal(kb, (1, 1, 3))).reshape(3)
    out = pcolor.random_print_adjust(t(src[0]), gain=t(gain), bias=t(bias))
    assert_close(out, ref, 1e-6)


@pytest.mark.parametrize("mode", ["scale", "random_scale", "max_region"])
def test_make_patch_geometry_matches_jax(mode):
    rng = np.random.default_rng(1)
    k = 6
    y0 = rng.uniform(0, 400, k)
    x0 = rng.uniform(0, 500, k)
    boxes = np.stack([y0, x0, y0 + rng.uniform(5, 240, k),
                      x0 + rng.uniform(5, 140, k)], -1).astype(np.float32)
    valid = np.array([True, True, False, True, True, True])
    kw = dict(tolerance=0.2, min_patch_area=4.0)
    if mode == "random_scale":
        kw["random_scale_range"] = (0.2, 0.5)
    if mode == "max_region":
        kw["max_region"] = 96.0
    key = jax.random.PRNGKey(5)
    ref = jeot.make_patch_geometry(key, jnp.asarray(boxes), jnp.asarray(valid),
                                   0.37, (640, 640), **kw)
    k_scale, k_y, k_x, k_a = jax.random.split(key, 4)
    u = lambda kk, lo, hi: t(jax.random.uniform(kk, (k,), minval=lo, maxval=hi))
    draws = dict(u_y=u(k_y, -1.0, 1.0), u_x=u(k_x, -1.0, 1.0),
                 angle=u(k_a, -jeot.DEG20, jeot.DEG20))
    if mode == "random_scale":
        draws["random_scale"] = u(k_scale, 0.2, 0.5)
    out = peot.make_patch_geometry(t(boxes), torch.from_numpy(valid),
                                   torch.tensor(0.37), (640, 640), **kw, **draws)
    for f in ("ymin", "xmin", "size", "diag", "angle"):
        assert_close(getattr(out, f), getattr(ref, f), 1e-5 / 640, f)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))


def test_geometry_detaches_scale():
    scale = torch.tensor(0.4, requires_grad=True)
    g = peot.make_patch_geometry(torch.tensor([[10.0, 10.0, 200.0, 90.0]]),
                                 torch.tensor([True]), scale, (640, 640))
    assert not g.size.requires_grad and not g.ymin.requires_grad


def test_downsample_canvas_matches_jax():
    patch = np.random.default_rng(2).uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    assert_close(peot.downsample_canvas(t(patch)[None], 24)[0],
                 jeot.downsample_canvas(jnp.asarray(patch), 24), 1e-6)


def test_total_variation_matches_jax():
    img = np.random.default_rng(3).uniform(-1, 1, (20, 17, 3)).astype(np.float32)
    assert_close(peot.total_variation(t(img)), jeot.total_variation(jnp.asarray(img)),
                 1e-6)


def test_default_window():
    assert peot.default_window((640, 640)) == jeot.default_window((640, 640)) == 384
    assert peot.default_window((64, 80)) == jeot.default_window((64, 80)) == 64


# ---------------------------------------------------------------------------
# the four warp passes against the Pallas TPU kernels (interpret mode)
# ---------------------------------------------------------------------------

# (p0, w, (ymin, xmin, size, diag, angle), (oy, ox)): rotation both ways,
# upscaling (rho < 1, radius 1) and downscaling (rho > 1, radius rho), a
# window not a power of two, a region partly outside the window
GEOMS = [
    (16, 32, (3.0, 5.0, 20.0, 28.0, 0.3), (2.0, 1.0)),
    (16, 40, (1.0, 0.0, 9.0, 12.7, -0.34), (0.0, 0.0)),
    (12, 24, (4.0, 2.0, 30.0, 24.0, 0.0), (0.0, 0.0)),
    (16, 32, (20.0, -6.0, 22.0, 31.1, 0.2), (0.0, 0.0)),
]


def _jax_window(p0, geom, origin):
    scal = tuple(np.float32(v) for v in geom)
    oy, ox = (np.float32(v) for v in origin)
    p1s, p2s, radius = jeot._warp_scalars(p0, oy, ox, scal)
    table = t([[*(float(v) for v in p1s), *(float(v) for v in p2s),
                float(radius), 0.0]])
    return p1s, p2s, radius, oy, ox, table


@pytest.mark.parametrize("p0,w,geom,origin", GEOMS)
def test_window_table_matches_jax_scalars(p0, w, geom, origin):
    *_, table = _jax_window(p0, geom, origin)
    out = peot.window_table(p0, *(t([v]) for v in origin + geom),
                            torch.tensor([0]))
    assert_close(out, table, 1e-6)


@pytest.mark.parametrize("p0,w,geom,origin", GEOMS)
def test_plain_passes_match_pallas_kernels(p0, w, geom, origin):
    rng = np.random.default_rng(p0 + w)
    canvas = rng.uniform(-1, 1, (p0, p0, 3)).astype(np.float32)
    g = rng.normal(size=(w, w, 3)).astype(np.float32)
    p1s, p2s, radius, oy, ox, table = _jax_window(p0, geom, origin)
    # v2 layouts: canvas [3, j, i], t [3, x, i] / [3, i, x], out [3, y, x]
    t_ref = pallas_warp2.pass1_fwd(jnp.asarray(canvas.transpose(2, 1, 0)),
                                   *p1s, radius, w)
    tt = peot.pass1_fwd(t(canvas)[None], table, w)
    assert_close(tt[0], np.asarray(t_ref).transpose(2, 1, 0), PASS_TOL, "pass1")
    out_ref = pallas_warp2.pass2_fwd(jnp.asarray(tt[0].numpy().transpose(2, 0, 1)),
                                     *p2s, radius, w)
    out = peot.pass2_fwd(tt, table)
    assert_close(out[0], np.asarray(out_ref).transpose(1, 2, 0), PASS_TOL, "pass2")
    dt_ref = pallas_warp2.pass2_bwd(jnp.asarray(g.transpose(2, 0, 1)), *p2s,
                                    radius, p0)
    dt = peot.pass2_bwd(t(g)[None], table, p0)
    assert_close(dt[0], np.asarray(dt_ref).transpose(1, 2, 0), PASS_TOL, "pass2_bwd")
    dc_ref = pallas_warp2.pass1_bwd(jnp.asarray(dt[0].numpy().transpose(2, 1, 0)),
                                    *p1s, radius, p0)
    dc = peot.pass1_bwd(dt, table, 1)
    assert_close(dc[0], np.asarray(dc_ref).transpose(2, 1, 0), PASS_TOL, "pass1_bwd")
    # v1 (layout [i, x, c] like the port's; its grids need w % 32 == 0)
    if w % 32 == 0:
        assert_close(tt[0], pallas_warp.pass1_fwd(jnp.asarray(canvas), *p1s,
                                                  radius, w), PASS_TOL, "v1 pass1")
        assert_close(out[0], pallas_warp.pass2_fwd(jnp.asarray(tt[0].numpy()),
                                                   *p2s, radius, w),
                     PASS_TOL, "v1 pass2")
        assert_close(dt[0], pallas_warp.pass2_bwd(jnp.asarray(g), *p2s, radius, p0),
                     PASS_TOL, "v1 pass2_bwd")
        assert_close(dc[0], pallas_warp.pass1_bwd(jnp.asarray(dt[0].numpy()),
                                                  *p1s, radius, p0),
                     PASS_TOL, "v1 pass1_bwd")


def test_plain_transposes_are_the_forward_vjps():
    """pass2_bwd / pass1_bwd are the exact linear transposes of the forwards,
    summed over the windows of each image."""
    rng = np.random.default_rng(4)
    geoms = [(3.0, 5.0, 20.0, 28.0, 0.3), (0.0, 2.0, 12.0, 17.0, -0.2),
             (4.0, 1.0, 14.0, 19.8, 0.1)]
    cols = [t([g[i] for g in geoms]) for i in range(5)]
    table = peot.window_table(16, t([0.0] * 3), t([0.0] * 3), *cols,
                              torch.tensor([1, 0, 1]))
    canvases = t(rng.uniform(-1, 1, (2, 16, 16, 3)))
    tt = peot.pass1_fwd(canvases, table, 32)
    g = t(rng.normal(size=(3, 32, 32, 3)))
    _, vjp2 = torch.autograd.functional.vjp(lambda x: peot.pass2_fwd(x, table), tt, g)
    dt = peot.pass2_bwd(g, table, 16)
    assert_close(dt, vjp2, PASS_TOL)
    _, vjp1 = torch.autograd.functional.vjp(
        lambda c: peot.pass1_fwd(c, table, 32), canvases, dt)
    assert_close(peot.pass1_bwd(dt, table, 2), vjp1, PASS_TOL)


def test_warp_gradient_matches_jax_grad_of_pallas_warp():
    """The autograd Function (plain passes on the CPU) against jax.grad of
    `pallas_warp2.warp_window`, whose VJP runs the Pallas transposes."""
    p0, w, geom, origin = GEOMS[0]
    rng = np.random.default_rng(5)
    canvas = rng.uniform(-1, 1, (p0, p0, 3)).astype(np.float32)
    g = rng.normal(size=(w, w, 3)).astype(np.float32)
    p1s, p2s, radius, oy, ox, table = _jax_window(p0, geom, origin)
    ref = jax.grad(lambda c: jnp.sum(pallas_warp2.warp_window(
        c, p1s, p2s, radius, oy, ox, w) * g))(jnp.asarray(canvas))
    c = t(canvas)[None].requires_grad_(True)
    before = dict(warp_cuda.LAUNCHES)
    (peot.warp_windows(c, table, w)[0] * t(g)).sum().backward()
    assert warp_cuda.LAUNCHES == before  # the CPU path never reaches a kernel
    assert_close(c.grad[0], ref, PASS_TOL)


def test_warp_refuses_other_devices():
    with pytest.raises(ValueError, match="no warp"):
        peot.warp_windows(torch.zeros((1, 4, 4, 3), device="meta"),
                          t([[0, 1, 0, 1, 0, 0, 1, 0]]), 8)


# ---------------------------------------------------------------------------
# apply_patches against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(6)
    imgs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    boxes = np.array([[[8, 8, 40, 40], [0, 0, 0, 0], [20, 16, 58, 44]],
                      [[10, 20, 50, 60], [5, 5, 20, 20], [0, 0, 0, 0]]],
                     np.float32)
    valid = np.array([[True, False, True], [True, True, False]])
    patch = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    per_image = rng.uniform(-1, 1, (2, 24, 24, 3)).astype(np.float32)
    return imgs, boxes, valid, patch, per_image


PINNED = dict(noise_mag=0.0, brightness_mag=0.0)
APPLY_CASES = {
    "pinned_print": dict(print_jitter=False),
    "fed_print": dict(),
    "no_rotation": dict(print_jitter=False, rotation_mag=0.0),
    "histogram_match": dict(print_jitter=False, use_histogram_match=True),
    "random_scale": dict(print_jitter=False, random_scale_range=(0.3, 0.6)),
    "per_image_patches": dict(print_jitter=False, per_image=True),
    "window_48_canvas_16": dict(print_jitter=False, window=48, canvas_res=16),
}


def _apply_both(scene, backend, opts):
    imgs, boxes, valid, patch, per_image = scene
    opts = dict(opts)
    pip = per_image if opts.pop("per_image", False) else None
    key = jax.random.PRNGKey(11)
    ref_out, ref_reg = jeot.apply_patches(
        key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(patch), 0.5, backend=backend, per_image_patches=(
            None if pip is None else jnp.asarray(pip)), **PINNED, **opts)
    draws = jax_draws(key, 2, 3, rotation_mag=opts.get("rotation_mag", jeot.DEG20),
                      random_scale_range=opts.get("random_scale_range"))
    out, reg = peot.apply_patches(
        t(imgs), t(boxes), torch.from_numpy(valid), t(patch), 0.5,
        draws=draws, device="cpu", backend=backend,
        per_image_patches=None if pip is None else t(pip), **PINNED, **opts)
    return (out, reg), (ref_out, ref_reg)


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_patches_matches_jax_matmul_backend(scene, case):
    (out, reg), (ref_out, ref_reg) = _apply_both(scene, "matmul", APPLY_CASES[case])
    np.testing.assert_array_equal(reg.numpy(), np.asarray(ref_reg))
    assert np.asarray(ref_reg).any()
    assert_close(out, ref_out, 0.02)
    assert not np.allclose(out.numpy(), scene[0])  # patches were placed


def test_apply_patches_gather_backend_matches_jax():
    imgs = np.random.default_rng(7).uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    boxes = np.array([[[6, 6, 40, 30], [10, 12, 44, 46]]], np.float32)
    valid = np.array([[True, True]])
    patch = np.random.default_rng(8).uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    opts = dict(backend="gather", print_jitter=False, **PINNED)
    ref_out, ref_reg = jeot.apply_patches(key, jnp.asarray(imgs), jnp.asarray(boxes),
                                          jnp.asarray(valid), jnp.asarray(patch),
                                          0.6, **opts)
    out, reg = peot.apply_patches(t(imgs), t(boxes), torch.from_numpy(valid),
                                  t(patch), 0.6, draws=jax_draws(key, 1, 2),
                                  device="cpu", **opts)
    np.testing.assert_array_equal(reg.numpy(), np.asarray(ref_reg))
    assert_close(out, ref_out, 1e-4)


def test_apply_patches_gradient_matches_jax(scene):
    """d sum(out^2) / d patch through the warp's transposes, against jax.grad
    of the JAX matmul backend (bf16 warp): cosine >= 0.9999."""
    imgs, boxes, valid, patch, _ = scene
    key = jax.random.PRNGKey(11)
    opts = dict(print_jitter=False, **PINNED)
    ref = jax.grad(lambda p: jnp.sum(jeot.apply_patches(
        key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(valid), p, 0.5,
        **opts)[0] ** 2))(jnp.asarray(patch))
    p = t(patch).requires_grad_(True)
    out, _ = peot.apply_patches(t(imgs), t(boxes), torch.from_numpy(valid), p, 0.5,
                                draws=jax_draws(key, 2, 3), device="cpu", **opts)
    (out ** 2).sum().backward()
    a, b = p.grad.numpy().ravel(), np.asarray(ref).ravel()
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) >= 0.9999


def test_apply_patches_refuses_unknown_backend(scene):
    """The JAX entry runs the gather backend for any name but "matmul"
    (eot.py:560-570); the port refuses what it does not have."""
    imgs, boxes, valid, patch, _ = scene
    with pytest.raises(ValueError, match="unknown EOT backend"):
        peot.apply_patches(t(imgs), t(boxes), torch.from_numpy(valid), t(patch),
                           0.5, device="cpu", backend="pallas2")


def test_dead_slots_cost_nothing(scene):
    imgs, boxes, _, patch, _ = scene
    before = dict(warp_cuda.LAUNCHES)
    out, reg = peot.apply_patches(t(imgs), t(boxes), torch.zeros((2, 3), dtype=torch.bool),
                                  t(patch), 0.5, device="cpu")
    assert torch.equal(out, t(imgs)) and not reg.any()
    assert warp_cuda.LAUNCHES == before


def test_later_slot_overwrites_earlier():
    """Two identical boxes: slot 1's sample, not slot 0's, stays on top."""
    imgs = torch.zeros((1, 64, 64, 3))
    boxes = torch.tensor([[[8.0, 8.0, 56.0, 56.0]] * 2])
    valid = torch.ones((1, 2), dtype=torch.bool)
    draws = peot.EOTDraws(torch.zeros((1, 2)), torch.zeros((1, 2)),
                          torch.zeros((1, 2)))
    common = dict(device="cpu", draws=draws, print_jitter=False, noise_mag=0.0)
    gen = torch.Generator().manual_seed(0)
    out, _ = peot.apply_patches(imgs, boxes, valid, torch.zeros((16, 16, 3)), 0.5,
                                generator=gen, brightness_mag=0.3, **common)
    bright = peot._uniform((1, 2), -0.3, 0.3, torch.Generator().manual_seed(0), "cpu")
    centre = out[0, 32, 32]
    # the canvas of a zero patch on a zero image is 0, so the centre pixel
    # holds the brightness shift of the slot on top
    assert torch.allclose(centre, bright[0, 1].expand(3), atol=1e-6)
    assert not torch.allclose(centre, bright[0, 0].expand(3), atol=1e-6)


def test_own_draws_have_the_reference_distributions():
    """Noise in +-noise_mag, fresh per slot; brightness in +-0.3; print gain
    N(.5, .1) and bias N(0, .01) per image and channel."""
    gen = torch.Generator().manual_seed(1)
    printed = pcolor.random_print_adjust(torch.ones((4000, 1, 1, 3)) * 0.5, gen)
    gain = printed.reshape(-1) / 0.5  # bias is ~1% of the gain's spread
    assert abs(float(gain.mean()) - 0.5) < 0.01
    assert abs(float(gain.std()) - 0.1) < 0.01
    imgs = torch.zeros((1, 96, 96, 3))
    boxes = torch.tensor([[[0.0, 0.0, 96.0, 96.0]] * 2])
    valid = torch.ones((1, 2), dtype=torch.bool)
    draws = peot.EOTDraws(torch.zeros((1, 2)), torch.zeros((1, 2)), torch.zeros((1, 2)))
    geom = peot.make_patch_geometry(boxes, valid, 1.0, (96, 96), u_y=draws.u_y,
                                    u_x=draws.u_x, angle=draws.angle,
                                    max_region=96.0)
    canvases = torch.zeros((1, 8, 8, 3))
    samples = []
    for slot_valid in ([True, False], [True, True]):
        g = geom._replace(valid=torch.tensor([slot_valid]))
        out, _ = peot._composite_matmul_batch(
            imgs, canvases, g, noise_mag=0.01, brightness_mag=0.0, window=96,
            generator=torch.Generator().manual_seed(2))
        samples.append(out)
    noise0 = samples[0][0, 20:76, 20:76]
    assert float(noise0.abs().max()) <= 0.01 and float(noise0.std()) > 0.004
    # with both slots live the visible noise is slot 1's, drawn afresh
    assert not torch.allclose(samples[1][0, 20:76, 20:76], noise0)
    bright = peot._uniform((5000,), -0.3, 0.3, torch.Generator().manual_seed(3), "cpu")
    assert float(bright.min()) >= -0.3 and float(bright.max()) <= 0.3
    assert abs(float(bright.mean())) < 0.02
