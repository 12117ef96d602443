"""The host side of the warp kernels, on the CPU.

`csrc/warp.cu`'s `pass1_fwd_kernel` sums each output over the taps of its
`taps_near` interval alone, and `pass2_fwd_kernel` each of a thread's 4
pixels over the union of their intervals (`pass2_fwd_taps`); both drop the
hat's division where r = 1 (`hat(unit=True)`). Its `pass2_bwd_kernel` and
`pass1_bwd_kernel` visit only the
rows and columns that `ops/warp_cuda.py` marks live, and within them only the
taps of their `taps_along` and `taps_near` intervals, so a range that misses a
non-zero tap would lose it without a trace. These tests hold the host ranges
(`pass2_bwd_ranges`, `pass1_bwd_ranges`) and the float32 twins of the
kernels' intervals to every non-zero weight of the plain passes
(`eot._pass2_weights`, `eot._pass1_weights`), and check the per-image window
order that `pass1_bwd` walks. Exact: these are index sets, not sums.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mladversarialobjectdetection_torch.ops import eot
from mladversarialobjectdetection_torch.ops import warp_cuda

# rows (or columns) a live range may reach past the last live position on
# either side: the kernels' own widening by one, plus the ceil / floor of a
# real bound
SLACK = 2


def random_table(seed, n_images, n, p0, w, *, angle_deg=None, size=None,
                 shift=0.0, images=None):
    """A host window table [n, 8] of random windows (origin 0, 0), each region
    inside the window unless `shift` moves it."""
    rng = np.random.default_rng(seed)
    size = np.full(n, size) if size is not None else rng.uniform(40, 200, n)
    diag = np.minimum(np.sqrt(2.0) * size, w)
    ymin = rng.uniform(0, np.maximum(w - diag, 1e-3)) + shift
    xmin = rng.uniform(0, np.maximum(w - diag, 1e-3)) + shift
    angle = (np.full(n, angle_deg) if angle_deg is not None
             else rng.uniform(-20, 20, n)) * np.pi / 180
    image = rng.integers(0, n_images, n) if images is None else np.asarray(images)
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    zero = f(np.zeros(n))
    return eot.window_table(p0, zero, zero, f(ymin), f(xmin), f(size),
                            f(diag), f(angle), torch.from_numpy(image))


# (id, table, p0, w): seeded random tables and the edge cases
RANGE_CASES = [
    ("random_p96_w320", random_table(0, 2, 4, 96, 320), 96, 320),
    ("random_p96_w160", random_table(1, 3, 5, 96, 160), 96, 160),
    ("angle_-20", random_table(2, 2, 3, 96, 320, angle_deg=-20), 96, 320),
    ("angle_+20", random_table(3, 2, 3, 96, 320, angle_deg=20), 96, 320),
    ("rho_below_1", random_table(4, 2, 3, 96, 320, size=150.0), 96, 320),
    ("rho_96_size_1", random_table(5, 1, 3, 96, 160, size=1.0), 96, 160),
    ("partly_outside", random_table(6, 2, 3, 96, 320, shift=150.0), 96, 320),
    ("wholly_outside", random_table(7, 2, 2, 96, 160, shift=5000.0), 96, 160),
    ("w200", random_table(8, 2, 4, 96, 200), 96, 200),
    ("w384", random_table(9, 2, 2, 96, 384), 96, 384),
    ("p32_w200", random_table(10, 3, 5, 32, 200), 32, 200),
    ("live_regime_b24", chip_smoke.live_regime_table()[:12], 96, 320),
]
# pass 2's forward also at the frontier's window, every window at r = 1, and
# at a w whose last quad is ragged
PASS2_FWD_CASES = RANGE_CASES + [
    ("w448_r1", random_table(12, 2, 3, 96, 448, size=300.0), 96, 448),
    ("p32_w150", random_table(13, 2, 3, 32, 150), 32, 150)]


def _within(k, lo, hi):
    return (k >= lo) & (k <= hi)


@pytest.mark.parametrize("name,table,p0,w", RANGE_CASES,
                         ids=[c[0] for c in RANGE_CASES])
def test_pass2_bwd_ranges_cover_every_nonzero_tap(name, table, p0, w):
    rows = warp_cuda.pass2_bwd_ranges(table.numpy(), p0, w)
    assert rows.dtype == np.int32 and rows.shape == (
        table.shape[0], -(-w // warp_cuda.STRIP), 2)
    assert (rows[..., 0] >= 0).all() and (rows[..., 1] <= w - 1).all()
    q = table.numpy()
    x = np.arange(w)
    strip = x // warp_cuda.STRIP
    for k in range(table.shape[0]):
        hat = eot._pass2_weights(table[k:k + 1], p0, w)[0].numpy()  # [y, x, i]
        ys, xs, is_ = np.nonzero(hat > 0)
        lo, hi = rows[k, strip[xs], 0], rows[k, strip[xs], 1]
        assert _within(ys, lo, hi).all(), f"window {k}: a live row outside its strip's range"
        # the range reaches no further than SLACK rows past the strip's live rows
        for s in np.unique(strip[xs]):
            live_y = ys[strip[xs] == s]
            assert rows[k, s, 0] >= live_y.min() - SLACK
            assert rows[k, s, 1] <= live_y.max() + SLACK
        # the kernel's intervals: of y for output (i, x), of i around u(y, x)
        a, b, cu, r = (np.float32(q[k, c]) for c in (3, 4, 5, 6))
        xf, yf = xs.astype(np.float32), ys.astype(np.float32)
        base = b * xf + cu
        tlo, thi = warp_cuda.taps_along(a, base, is_.astype(np.float32), r, w)
        assert _within(ys, tlo, thi).all(), f"window {k}: a tap outside taps_along"
        nlo, nhi = warp_cuda.taps_near((a * yf + b * xf) + cu, r, p0)
        assert _within(is_, nlo, nhi).all(), f"window {k}: a tap outside taps_near"
    if name == "wholly_outside":
        assert (rows[..., 0] > rows[..., 1]).all()


@pytest.mark.parametrize("name,table,p0,w", RANGE_CASES,
                         ids=[c[0] for c in RANGE_CASES])
def test_pass1_bwd_ranges_cover_every_nonzero_tap(name, table, p0, w):
    n_images = int(table[:, 7].max()) + 1
    _, _, cols = warp_cuda.pass1_bwd_ranges(table.numpy(), n_images, p0, w)
    assert cols.dtype == np.int32 and cols.shape == (table.shape[0], p0, 2)
    assert (cols[..., 0] >= 0).all() and (cols[..., 1] <= w - 1).all()
    q = table.numpy()
    for k in range(table.shape[0]):
        hat = eot._pass1_weights(table[k:k + 1], p0, w)[0].numpy()  # [i, x, j]
        is_, xs, js = np.nonzero(hat > 0)
        assert _within(xs, cols[k, is_, 0], cols[k, is_, 1]).all(), (
            f"window {k}: a live column outside its row's range")
        for i in np.unique(is_):
            live_x = xs[is_ == i]
            assert cols[k, i, 0] >= live_x.min() - SLACK
            assert cols[k, i, 1] <= live_x.max() + SLACK
        g_i, g_x, g_c, r = (np.float32(q[k, c]) for c in (0, 1, 2, 6))
        xf, if_ = xs.astype(np.float32), is_.astype(np.float32)
        base = g_i * if_ + g_c
        tlo, thi = warp_cuda.taps_along(g_x, base, js.astype(np.float32), r, w)
        assert _within(xs, tlo, thi).all(), f"window {k}: a tap outside taps_along"
        nlo, nhi = warp_cuda.taps_near((g_i * if_ + g_x * xf) + g_c, r, p0)
        assert _within(js, nlo, nhi).all(), f"window {k}: a tap outside taps_near"
    if name == "wholly_outside":
        assert (cols[..., 0] > cols[..., 1]).all()


@pytest.mark.parametrize("name,table,p0,w", RANGE_CASES,
                         ids=[c[0] for c in RANGE_CASES])
def test_pass1_fwd_taps_near_covers_every_nonzero_tap(name, table, p0, w):
    """`pass1_fwd_kernel` sums output (i, x) over taps_near(g(i, x)) and
    nothing else: every non-zero weight of the plain pass 1 lies inside, and
    the interval holds no margin, at most one zero tap past each end."""
    q = table.numpy()
    i, x = np.meshgrid(np.arange(p0, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    for k in range(table.shape[0]):
        hat = eot._pass1_weights(table[k:k + 1], p0, w)[0].numpy()  # [i, x, j]
        g_i, g_x, g_c, r = (np.float32(q[k, c]) for c in (0, 1, 2, 6))
        lo, hi = warp_cuda.taps_near((g_i * i + g_x * x) + g_c, r, p0)  # [i, x]
        is_, xs, js = np.nonzero(hat > 0)
        assert _within(js, lo[is_, xs], hi[is_, xs]).all(), (
            f"window {k}: a non-zero tap outside taps_near")
        width = np.maximum(hi - lo + 1, 0)
        assert (width <= (hat > 0).sum(-1) + 2).all(), (
            f"window {k}: taps_near wider than the non-zero taps and one on each side")


@pytest.mark.parametrize("name,table,p0,w", PASS2_FWD_CASES,
                         ids=[c[0] for c in PASS2_FWD_CASES])
def test_pass2_fwd_taps_cover_every_nonzero_tap(name, table, p0, w):
    """`pass2_fwd_kernel` sums the QUAD pixels of a thread over the union of
    their taps_near intervals and nothing else: every non-zero weight of the
    plain pass 2 lies inside its quad's interval, and the interval holds no
    margin, at most one zero tap past each end of the quad's non-zero taps."""
    if name == "w448_r1":
        assert (table[:, 6] == 1).all()
    quads = -(-w // warp_cuda.QUAD)
    pad = quads * warp_cuda.QUAD - w
    for k in range(table.shape[0]):
        nz = eot._pass2_weights(table[k:k + 1], p0, w)[0] > 0             # [y, x, i]
        nz = torch.nn.functional.pad(nz, (0, 0, 0, pad)).view(
            w, quads, warp_cuda.QUAD, p0).any(2).numpy()                 # [y, quad, i]
        lo, hi = warp_cuda.pass2_fwd_taps(table[k].numpy(), p0, w)      # [y, quad]
        has = nz.any(-1)
        first = np.argmax(nz, -1)
        last = p0 - 1 - np.argmax(nz[..., ::-1], -1)
        assert ((first >= lo) & (last <= hi))[has].all(), (
            f"window {k}: a non-zero tap outside its quad's interval")
        extent = np.where(has, last - first + 1, 0)
        assert (np.maximum(hi - lo + 1, 0) <= extent + 2).all(), (
            f"window {k}: an interval wider than its quad's non-zero taps and one on each side")
    if name == "wholly_outside":
        lo, hi = warp_cuda.pass2_fwd_taps(table[0].numpy(), p0, w)
        assert (lo > hi).all()


@pytest.mark.parametrize("name,table,p0,w", PASS2_FWD_CASES,
                         ids=[c[0] for c in PASS2_FWD_CASES])
def test_unit_hat_equals_divided_hat(name, table, p0, w):
    """At r = 1 the kernels' hat without its division (`hat<true>`) is the
    divided hat and the plain version's `_hat`, bit for bit: on the d = u - i
    of the case's windows (every pixel, the taps around u) and on a grid of d
    through [-3, 3] with the float32 neighbours of 0, +-1 and +-2."""
    q = table.numpy()
    y, x = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(w, dtype=np.float32),
                       indexing="ij")
    u = np.concatenate([((q[k, 3] * y + q[k, 4] * x) + q[k, 5]).ravel()
                        for k in range(q.shape[0])])
    c = np.concatenate([u] * 5)
    i = np.concatenate([np.floor(u) + off for off in (-2, -1, 0, 1, 2)]).astype(np.float32)
    edges = np.float32([0, 1, -1, 2, -2])
    grid = np.concatenate([np.linspace(-3, 3, 60001, dtype=np.float32),
                           np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf)), edges])
    c, i = np.concatenate([c, grid]), np.concatenate([i, np.zeros_like(grid)])
    unit = warp_cuda.hat(c, i, 1.0, unit=True)
    divided = warp_cuda.hat(c, i, 1.0)
    plain = eot._hat(torch.from_numpy(c - i), 1.0).numpy()
    assert unit.dtype == divided.dtype == plain.dtype == np.float32
    assert np.array_equal(unit.view(np.int32), divided.view(np.int32))
    assert np.array_equal(unit.view(np.int32), plain.view(np.int32))
    assert (unit > 0).any() and (unit == 0).any()


def test_taps_along_full_range_at_slope_zero():
    lo, hi = warp_cuda.taps_along(np.float32([0.0, 0.0]), np.float32([3.0, -7.0]),
                                  np.float32([1.0, 5.0]), np.float32(1.5), 40)
    assert lo.tolist() == [0, 0] and hi.tolist() == [39, 39]


# (id, image index per window, n_images)
ORDER_CASES = [
    ("16_windows_one_image_beside_empty", [2] * 16, 4),
    ("interleaved", [1, 0, 1, 2, 0, 1, 2, 2, 0], 3),
    ("empty_first_and_last", [1, 2, 1, 2], 4),
    ("one_window", [0], 1),
    ("live_regime_b24", chip_smoke.live_regime_table()[:, 7].long().tolist(), 24),
]


@pytest.mark.parametrize("name,images,n_images", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_pass1_bwd_window_order(name, images, n_images):
    images = np.asarray(images)
    table = random_table(11, n_images, len(images), 32, 64, images=images)
    order, offsets, _ = warp_cuda.pass1_bwd_ranges(table.numpy(), n_images, 32, 64)
    assert order.dtype == offsets.dtype == np.int32
    assert offsets.shape == (n_images + 1,)
    assert offsets[0] == 0 and offsets[-1] == len(images)
    assert sorted(order.tolist()) == list(range(len(images)))
    for b in range(n_images):
        # image b's windows, in table order (a stable sort)
        assert order[offsets[b]:offsets[b + 1]].tolist() == \
            np.flatnonzero(images == b).tolist()


def test_live_ranges_at_slope_zero():
    """A zero slope (a = 0 in pass 2, g_x = 0 in pass 1; |angle| <= 20
    degrees never gives one) makes every row or column live, or none."""
    table = torch.zeros((2, 8))
    table[:, 6] = 1.5                       # r
    table[0, 5] = 40.0                      # cu: u = 40 for every (y, x)
    table[1, 5] = 200.0                     # beyond p0 - 1 + r
    table[0, 2], table[1, 2] = 10.0, -9.0   # g_c: g = 10, then -9
    rows = warp_cuda.pass2_bwd_ranges(table.numpy(), 96, 70)
    assert (rows[0] == (0, 69)).all() and (rows[1, :, 0] > rows[1, :, 1]).all()
    _, _, cols = warp_cuda.pass1_bwd_ranges(table.numpy(), 1, 96, 70)
    assert (cols[0] == (0, 69)).all() and (cols[1, :, 0] > cols[1, :, 1]).all()
