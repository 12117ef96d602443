"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card: it carries the `cuda` marker and
skips, with a reason, where `torch.cuda.is_available()` is false (decided
inside the `cuda` fixture, never at import). The module imports neither JAX
nor the JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: `tests/conftest.py` sets up JAX). The NMS input sets of
`CASES` are also the ones `test_torch_nms.py` holds the plain version to
JAX with. NMS kernel vs plain: indices, valid, valid_len and boxes exactly
equal, scores within 1e-6. Warp kernels vs plain: within WARP_TOL of the
output's scale, since the weights are the same float32 values and only the
order of the sums differs; two launches bit-equal (no atomics); pass 2's
forward also bit-equal to its ablation, the thread-per-output kernel, which
sums the same taps in the same order plus taps that are zero. cmconv
kernels (both instances, `simt` and `tc`, and the plan's pick) vs plain:
within CMCONV_TOL of the output's scale (the SIMT instance sums with FMAs,
the tensor-core one with 3xTF32 products, each in one fixed order, where
the plain version multiplies and adds apart); two launches bit-equal. Fused MBConv kernels vs plain: forward
within MBCONV_FWD_TOL of max(1, max|plain|) (3xTF32 products summed in
another order), dx within MBCONV_DX_TOL of max|plain| of the plain dx fed
the kernel's own relu masks, every mask that differs from the plain
version's within MBCONV_KINK_TOL of its kink; two launches bit-equal; the
kernels' SIMT ablation against them; their bf16 instances against the bf16
plain versions within chip_smoke.py's MBCONV_BF16_* tolerances (the reasons
there), with only bf16 launches counted; and the backbone's dispatch counts
on the card. The bf16 cmconv instances: the plan's pick, the Hopper
instance (`csrc/cmconv_bf16_sm90.cu`), every element within
`ops/cmconv.cmconv_rounding_bound` of the float64 sum and within
`ops/cmconv.BF16_TOL` of the plain version's scale, two launches bit-equal;
the SIMT instance bit-equal to the bf16 plain version where the kernel holds
bf16 values (the U-Net's), within BF16_TOL otherwise; the bf16, packed and
remat defenders' launches on the card; the packed backbone entry's lite4@640 serve against
the unpacked one (19 fused forward launches a serve).
"""
import copy

import numpy as np
import pytest
import torch

from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
from mladversarialobjectdetection_torch.attack.train import get_victim
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.ops import eot as peot
from mladversarialobjectdetection_torch.ops import nms as pnms
from mladversarialobjectdetection_torch.ops import nms_cuda, postprocess
from mladversarialobjectdetection_torch.ops import cmconv as pcmconv
from mladversarialobjectdetection_torch.ops import cmconv_cuda, warp_cuda

pytestmark = pytest.mark.cuda

SCORE_TOL = 1e-6
WARP_TOL = 1e-5
CMCONV_TOL = 1e-5
HARD = dict(method="hard", iou_thresh=0.5, score_thresh=0.3, max_output_size=24)
GAUSS = dict(method="gaussian", sigma=0.5, score_thresh=0.001, max_output_size=24)


def random_boxes(rng, b, n, lo=30.0, hi=300.0, size=(10.0, 80.0)):
    centers = rng.uniform(lo, hi, (b, n, 2))
    sizes = rng.uniform(size[0], size[1], (b, n, 2))
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          -1).astype(np.float32)


def _cases():
    """(id, boxes, scores, kwargs): random inputs and the edge cases."""
    rng = np.random.RandomState(0)
    boxes = random_boxes(rng, 3, 100)  # N not a multiple of 32
    scores = rng.uniform(0.0, 1.0, (3, 100)).astype(np.float32)
    tied = (rng.randint(0, 3, (3, 100)) / 3.0 + 0.2).astype(np.float32)
    masked = scores.copy()
    masked[rng.uniform(size=masked.shape) < 0.5] = pnms.NEG_INF
    same = np.broadcast_to(boxes[:, :1], boxes.shape).copy()
    flat = boxes.copy()
    flat[:, ::3, 2] = flat[:, ::3, 0]           # zero height
    flat[:, 1::3, 3] = flat[:, 1::3, 1] - 5.0   # negative width
    nan = scores.copy()
    nan[rng.uniform(size=nan.shape) < 0.05] = np.nan  # NaN wins, is never valid
    few = scores * 0.6  # about 1 in 6 over .5: a few valid winners, then none
    return [
        ("hard", boxes, scores, HARD),
        ("gaussian", boxes, scores, GAUSS),
        ("gaussian_sigma0.3", boxes, scores, dict(GAUSS, sigma=0.3)),
        ("tied_hard", boxes, tied, HARD),
        ("tied_gaussian", boxes, tied, GAUSS),
        ("masked_hard_no_thresh", boxes, masked, dict(HARD, score_thresh=None)),
        ("masked_gaussian", boxes, masked, GAUSS),
        ("identical_boxes_hard", same, scores, HARD),
        ("identical_boxes_gaussian", same, scores, dict(GAUSS, sigma=0.1)),
        ("zero_area_hard", flat, scores, HARD),
        ("zero_area_gaussian", flat, scores, GAUSS),
        ("exhausted_pool", boxes[:, :10].copy(), scores[:, :10].copy(),
         dict(HARD, score_thresh=None)),
        ("score_thresh_0_gaussian", boxes, scores, dict(GAUSS, score_thresh=0.0)),
        ("score_thresh_0_iou_0_hard", boxes, scores,
         dict(HARD, score_thresh=0.0, iou_thresh=0.0)),
        ("defaults_gaussian", boxes, scores, dict(max_output_size=24)),
        ("nan_scores_hard", boxes, nan, HARD),
        ("nan_scores_gaussian", boxes, nan, GAUSS),
        ("early_exit_hard", boxes, few, dict(HARD, score_thresh=0.5)),
        ("early_exit_gaussian", boxes, few, dict(GAUSS, score_thresh=0.5)),
        # hard, nothing suppressed, no threshold: all M steps valid
        ("all_valid_chain", boxes, scores, dict(HARD, score_thresh=None, iou_thresh=1.0)),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]


def _serve_shape_cases():
    """lite4@640 serve shapes: [8, 1024] candidates -> 100 outputs."""
    rng = np.random.RandomState(1)
    boxes = random_boxes(rng, 8, 1024, hi=600.0, size=(10.0, 160.0))
    scores = rng.uniform(0.0, 1.0, (8, 1024)).astype(np.float32)
    return [("serve_hard", boxes, scores, dict(HARD, max_output_size=100)),
            ("serve_gaussian", boxes, scores, dict(GAUSS, max_output_size=100))]


def _large_cases():
    """Near 48 KB of shared memory (N = 3000 with the static slots and row
    ring), past the kernel's 4096-candidate instance, up to kMaxCandidates."""
    rng = np.random.RandomState(3)
    out = []
    for n in (3000, 4097, 8192):
        boxes = random_boxes(rng, 2, n, hi=600.0, size=(10.0, 160.0))
        scores = rng.uniform(0.0, 1.0, (2, n)).astype(np.float32)
        nan = scores.copy()
        nan[rng.uniform(size=nan.shape) < 0.01] = np.nan
        out += [(f"n{n}_gaussian", boxes, scores, dict(GAUSS, max_output_size=100)),
                (f"n{n}_nan_hard", boxes, nan, dict(HARD, max_output_size=100))]
    return out


LARGE_CASES = _large_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def assert_kernel_equals_plain(boxes, scores, kw):
    """One kernel launch against the plain version on the same CUDA tensors."""
    before = nms_cuda.LAUNCHES
    kern = nms_cuda.batched_nms_cuda(boxes, scores, **kw)
    assert nms_cuda.LAUNCHES == before + 1
    plain = pnms.batched_nms(boxes, scores, **kw)
    torch.cuda.synchronize()
    for field in ("indices", "valid", "valid_len", "boxes"):
        assert torch.equal(getattr(kern, field), getattr(plain, field)), field
    assert float((kern.scores - plain.scores).abs().max()) <= SCORE_TOL
    return kern


@pytest.mark.parametrize("name,boxes,scores,kw", CASES + _serve_shape_cases(),
                         ids=IDS + ["serve_hard", "serve_gaussian"])
def test_cuda_kernel_matches_plain(cuda, name, boxes, scores, kw):
    assert_kernel_equals_plain(torch.from_numpy(boxes).to(cuda),
                               torch.from_numpy(scores).to(cuda), kw)


@pytest.mark.parametrize("name,boxes,scores,kw", LARGE_CASES, ids=[c[0] for c in LARGE_CASES])
def test_cuda_kernel_matches_plain_large(cuda, name, boxes, scores, kw):
    assert_kernel_equals_plain(torch.from_numpy(boxes).to(cuda),
                               torch.from_numpy(scores).to(cuda), kw)


def test_cuda_kernel_early_exit_rows(cuda):
    """A pool where every score is under the threshold: the kernel stops at
    step 0 and writes all M pad rows (boxes[0] * 0), as the plain version."""
    _, boxes, scores, kw = CASES[0]
    kern = assert_kernel_equals_plain(torch.from_numpy(boxes).to(cuda),
                                      torch.from_numpy(scores * 0.1).to(cuda),
                                      dict(kw, score_thresh=0.5))
    assert not kern.valid.any() and not kern.indices.any()


@pytest.mark.parametrize("pair_range", [0, 1])
def test_nms_fast_division_is_div_rn(cuda, pair_range):
    """The kernel's branch-free division equals div.rn over its range."""
    assert nms_cuda.division_mismatches(1 << 30, pair_range, cuda) == 0


def test_auto_dispatches_cuda_tensors_to_kernel(cuda):
    _, boxes, scores, kw = CASES[1]
    before = nms_cuda.LAUNCHES
    pnms.batched_nms_auto(torch.from_numpy(boxes).to(cuda),
                          torch.from_numpy(scores).to(cuda), **kw)
    assert nms_cuda.LAUNCHES == before + 1


def test_cuda_wrapper_rejects_bad_inputs(cuda):
    boxes = torch.zeros((2, 64, 4), device=cuda)
    scores = torch.zeros((2, 64), device=cuda)
    assert boxes.data_ptr() % 16 == 0
    before = nms_cuda.LAUNCHES
    with pytest.raises(TypeError):
        nms_cuda.batched_nms_cuda(boxes.double(), scores.double())
    with pytest.raises(ValueError, match="contiguous"):
        nms_cuda.batched_nms_cuda(boxes.transpose(0, 1).contiguous().transpose(0, 1),
                                  scores)
    with pytest.raises(ValueError, match="want boxes"):
        nms_cuda.batched_nms_cuda(boxes, scores[:, :32])
    # contiguous, but one float past a 16-byte boundary: the kernel's float4
    # read would fault the CUDA context
    shifted = torch.zeros(2 * 64 * 4 + 1, device=cuda)[1:].view(2, 64, 4)
    with pytest.raises(ValueError, match="16-byte"):
        nms_cuda.batched_nms_cuda(shifted, scores)
    # past kMaxCandidates of csrc/nms.cu (8192): the C entry refuses to launch
    big = 8193
    with pytest.raises(RuntimeError, match="cudaError_t 1 "):
        nms_cuda.batched_nms_cuda(torch.zeros((1, big, 4), device=cuda),
                                  torch.zeros((1, big), device=cuda))
    with pytest.raises(RuntimeError, match="cudaError_t 1 "):
        nms_cuda.batched_nms_cuda(boxes, scores, max_output_size=0)
    assert nms_cuda.LAUNCHES == before
    # the context is still usable after the refusals
    assert_kernel_equals_plain(boxes, scores, GAUSS)


def test_serve_on_card_goes_through_kernel(cuda):
    """A tiny lite0 served on the card: one kernel launch per serve."""
    params = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
              "box_class_repeats": 1,
              "nms_configs": {"method": "gaussian", "score_thresh": 0.0099,
                              "pre_nms_topk": 64, "max_output_size": 16}}
    det = Detector("efficientdet-lite0", params=params, seed=0, device=cuda)
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 256, (48, 80, 3)).astype(np.uint8)
              for _ in range(2)]
    before = nms_cuda.LAUNCHES
    out = det.serve(frames)
    assert nms_cuda.LAUNCHES == before + 1
    assert out.boxes.shape == (2, 16, 4) and out.valid_len.shape == (2,)
    assert np.all(np.isfinite(out.boxes)) and np.all(np.isfinite(out.scores))
    np.testing.assert_array_equal(out.valid.sum(1), out.valid_len)

    images, scales = det.preprocess(frames)
    with torch.no_grad():
        cls_out, box_out = det.net(torch.from_numpy(images).to(cuda))
        boxes, scores, _ = postprocess._pre_nms_select(
            det._params_dict, cls_out, box_out)
    assert_kernel_equals_plain(
        boxes.contiguous(), scores.contiguous(),
        postprocess.nms_kwargs_from_config(det.config.nms_configs))


def test_packed_serve_on_card_matches_unpacked(cuda):
    """`Detector(packed_entry=10)` at lite4@640 b1 on the card (JAX's lite4
    operating point): head outputs within 2e-4 of the unpacked serve's
    scale on the same seeded weights, the same detections' top entry, and
    19 fused MBConv forward launches (25 less the fuseable blocks 2-4 and
    6-8 in the packed range) and one NMS a serve."""
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    det = Detector("efficientdet-lite4", seed=0, device=cuda, packed_entry=10)
    frames = [np.random.default_rng(3).integers(0, 256, (720, 1280, 3), dtype=np.uint8)]
    det.serve(frames)  # warm-up
    nms0, mb0 = nms_cuda.LAUNCHES, dict(mbconv_cuda.LAUNCHES)
    out = det.serve(frames)
    torch.cuda.synchronize()
    assert nms_cuda.LAUNCHES - nms0 == 1
    assert {k: v - mb0[k] for k, v in mbconv_cuda.LAUNCHES.items()} == {
        "mbconv_fwd": 19, "mbconv_dx": 0}
    plain = copy.copy(det)
    plain.net = det.net.with_packed_entry(0)
    ref = plain.serve(frames)
    assert out.valid[0, 0] and ref.valid[0, 0]
    assert out.classes[0, 0] == ref.classes[0, 0]
    np.testing.assert_allclose(out.boxes[0, 0], ref.boxes[0, 0], rtol=0, atol=1e-2)
    images, _ = det.preprocess(frames)
    x = torch.from_numpy(images).to(cuda)
    with torch.no_grad():
        got = [o for group in det.net(x) for o in group]
        want = [o for group in plain.net(x) for o in group]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-4 * max(1.0, float(b.abs().max()))


def warp_windows_case(rng, n_images, n, p0, w, *, angle_deg=None, size=None,
                      shift=0.0, images=None):
    """(canvases [B, p0, p0, 3], host window table [n, 8]) of random windows
    of `images` (else random images).

    Each region lies in the window (origin 0, 0) unless `shift` moves it."""
    size = np.full(n, size) if size is not None else rng.uniform(40, 200, n)
    diag = np.minimum(np.sqrt(2.0) * size, w)
    ymin = rng.uniform(0, np.maximum(w - diag, 1e-3)) + shift
    xmin = rng.uniform(0, np.maximum(w - diag, 1e-3)) + shift
    angle = (np.full(n, angle_deg) if angle_deg is not None
             else rng.uniform(-20, 20, n)) * np.pi / 180
    zero = np.zeros(n)
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    table = peot.window_table(p0, f(zero), f(zero), f(ymin), f(xmin), f(size),
                              f(diag), f(angle),
                              torch.from_numpy(rng.integers(0, n_images, n)
                                               if images is None else np.asarray(images)))
    canvases = rng.uniform(-1, 1, (n_images, p0, p0, 3)).astype(np.float32)
    return torch.from_numpy(canvases), table


def live_regime_case(rng, window=320, scale=0.4):
    """(canvases [24, 96, 96, 3], host window table) of the attack step's
    windows: `chip_smoke.make_live_slot_boxes`' b24 live regime at 640, at
    the attacker's window 320 and initial scale .4 (or the frontier's window
    448 at a pinned scale)."""
    import chip_smoke

    canvases = rng.uniform(-1, 1, (24, 96, 96, 3)).astype(np.float32)
    return torch.from_numpy(canvases), chip_smoke.live_regime_table(
        window=window, scale=scale)


def _warp_cases():
    """(id, w, (canvases, table)): the lite4 window and the edge cases."""
    r = np.random.default_rng(3)
    return [
        ("p96_w320_rot-20", 320, warp_windows_case(r, 2, 3, 96, 320, angle_deg=-20)),
        ("p96_w320_rot0_upscale", 320, warp_windows_case(
            r, 2, 3, 96, 320, angle_deg=0, size=150.0)),
        ("p96_w320_rot20_downscale", 320, warp_windows_case(
            r, 2, 3, 96, 320, angle_deg=20, size=60.0)),
        ("partly_outside", 160, warp_windows_case(r, 1, 2, 96, 160, shift=100.0)),
        ("wholly_outside", 160, warp_windows_case(r, 1, 2, 96, 160, shift=5000.0)),
        ("size_1", 160, warp_windows_case(r, 1, 2, 96, 160, size=1.0)),
        ("w200_p32", 200, warp_windows_case(r, 3, 5, 32, 200)),
        ("w384", 384, warp_windows_case(r, 2, 2, 96, 384)),
        ("b24_70_windows", 320, warp_windows_case(r, 24, 70, 96, 320)),
        ("16_windows_of_one_image_beside_none", 320, warp_windows_case(
            r, 4, 16, 96, 320, images=np.full(16, 2))),
        ("b24_live_regime", 320, live_regime_case(r)),
        # the frontier's window (examples/northstar_soak.py --frontier)
        ("w448_16_windows_of_one_image_beside_none", 448, warp_windows_case(
            r, 4, 16, 96, 448, images=np.full(16, 2))),
        ("w448_size_300", 448, warp_windows_case(r, 3, 6, 96, 448, size=300.0)),
        ("b24_live_regime_w448_scale_.6", 448, live_regime_case(r, 448, 0.6)),
        # w past the last 32-column tile and past a multiple of 4 (pass 2's
        # forward by single floats); every window at r = 1, rotated
        ("w203_ragged_tiles", 203, warp_windows_case(r, 2, 4, 96, 203)),
        ("w384_all_r1", 384, warp_windows_case(r, 3, 6, 96, 384, size=220.0)),
    ]


WARP_CASES = _warp_cases()


def _close(kern, plain, what, tol=WARP_TOL):
    scale = max(1.0, float(plain.abs().max()))
    err = float((kern - plain).abs().max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("name,w,case", WARP_CASES, ids=[c[0] for c in WARP_CASES])
def test_warp_kernels_match_plain(cuda, name, w, case):
    canvases, table = case
    canvases = canvases.to(cuda)
    n_img, p0 = canvases.shape[0], canvases.shape[1]
    n = table.shape[0]
    before = dict(warp_cuda.LAUNCHES)
    t = warp_cuda.pass1_fwd(canvases, table, w)
    _close(t, peot.pass1_fwd(canvases, table, w), "pass1_fwd")
    out = warp_cuda.pass2_fwd(t, table)
    _close(out, peot.pass2_fwd(t, table), "pass2_fwd")
    ablation = dict(warp_cuda.ABLATION_LAUNCHES)
    assert torch.equal(warp_cuda.pass2_fwd_ablation(t, table), out)
    assert warp_cuda.ABLATION_LAUNCHES["pass2_fwd_ablation"] == \
        ablation["pass2_fwd_ablation"] + 1
    if name == "w384_all_r1":
        assert (table[:, 6] == 1).all()
    g = torch.randn((n, w, w, 3), generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda)
    dt = warp_cuda.pass2_bwd(g, table, p0)
    _close(dt, peot.pass2_bwd(g, table, p0), "pass2_bwd")
    dc = warp_cuda.pass1_bwd(dt, table, n_img)
    _close(dc, peot.pass1_bwd(dt, table, n_img), "pass1_bwd")
    torch.cuda.synchronize()
    assert all(warp_cuda.LAUNCHES[k] == before[k] + 1 for k in before)
    if name == "wholly_outside":
        assert float(out.abs().max()) == 0.0
    # an image with no window gets an exactly zero gradient
    empty = sorted(set(range(n_img)) - set(table[:, 7].long().tolist()))
    assert not bool(dc[empty].any())
    # gathers in a fixed order: a second launch repeats bit for bit
    assert torch.equal(warp_cuda.pass1_fwd(canvases, table, w), t)
    assert torch.equal(warp_cuda.pass2_fwd(t, table), out)
    assert torch.equal(warp_cuda.pass2_bwd(g, table, p0), dt)
    assert torch.equal(warp_cuda.pass1_bwd(dt, table, n_img), dc)


def test_pass2_fwd_unaligned_t(cuda):
    """t 4 bytes past a 16-byte boundary at w % 4 == 0: the kernel takes
    single floats there, bit-equal to the 16-byte path and the ablation."""
    canvases, table = warp_windows_case(np.random.default_rng(7), 2, 3, 96, 320)
    t = warp_cuda.pass1_fwd(canvases.to(cuda), table, 320)
    shifted = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    out = warp_cuda.pass2_fwd(t, table)
    assert torch.equal(warp_cuda.pass2_fwd(shifted, table), out)
    assert torch.equal(warp_cuda.pass2_fwd_ablation(shifted, table), out)
    _close(out, peot.pass2_fwd(t, table), "pass2_fwd")


def test_warp_autograd_on_card_matches_plain(cuda):
    canvases, table = warp_windows_case(np.random.default_rng(5), 3, 6, 32, 96)
    g = torch.randn((6, 96, 96, 3), generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in (torch.device("cpu"), cuda):
        c = canvases.to(dev).clone().requires_grad_(True)
        (peot.warp_windows(c, table, 96) * g.to(dev)).sum().backward()
        grads.append(c.grad.cpu())
    _close(grads[1], grads[0], "dcanvas")


def test_warp_wrapper_rejects_bad_inputs(cuda):
    canvases, table = warp_windows_case(np.random.default_rng(6), 2, 3, 32, 64)
    canvases = canvases.to(cuda)
    before = dict(warp_cuda.LAUNCHES)
    with pytest.raises(TypeError):
        warp_cuda.pass1_fwd(canvases.double(), table, 64)
    with pytest.raises(ValueError, match="contiguous"):
        warp_cuda.pass1_fwd(canvases.transpose(1, 2), table, 64)
    with pytest.raises(ValueError, match="host"):
        warp_cuda.pass1_fwd(canvases, table.to(cuda), 64)
    bad = table.clone()
    bad[0, 7] = 2.0  # image index past B = 2
    with pytest.raises(ValueError, match="image index"):
        warp_cuda.pass1_fwd(canvases, bad, 64)
    bad = table.clone()
    bad[1, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        warp_cuda.pass1_fwd(canvases, bad, 64)
    with pytest.raises(ValueError, match="windows"):
        warp_cuda.pass2_fwd(torch.zeros((2, 32, 64, 3), device=cuda), table)
    with pytest.raises(RuntimeError, match="cudaError_t 1 "):
        warp_cuda.pass1_fwd(canvases, table, 0)
    assert warp_cuda.LAUNCHES == before
    t = warp_cuda.pass1_fwd(canvases, table, 64)  # the context still works
    _close(t, peot.pass1_fwd(canvases, table, 64), "pass1_fwd")


def test_attack_step_on_card_goes_through_kernels(cuda):
    """A tiny lite0 attack step on the card: 4 warp launches, 1 NMS launch."""
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.override({"image_size": 64, "fpn_num_filters": 16,
                  "fpn_cell_repeats": 1, "box_class_repeats": 1,
                  "nms_configs": {"iou_thresh": 0.5, "score_thresh": 0.5,
                                  "pre_nms_topk": 64, "max_output_size": 16},
                  "max_boxes_per_image": 4})
    victim = get_victim(cfg, seed=0, device=cuda)
    atk = PatchAttacker(cfg, victim, patch_size=32, device=cuda)
    state = atk.init_state(seed=0)
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2)
                        ).to(cuda) * 2 - 1
    boxes = torch.zeros((2, 4, 4))
    boxes[:, 0] = torch.tensor([4.0, 4.0, 60.0, 60.0])
    boxes[1, 1] = torch.tensor([10.0, 20.0, 50.0, 44.0])
    valid = torch.zeros((2, 4), dtype=torch.bool)
    valid[:, 0] = True
    valid[1, 1] = True
    patch0 = state.patch.detach().clone()
    warp_cuda.reset_counts()
    nms_before = nms_cuda.LAUNCHES
    state, m = atk.train_step(state, images, with_asr=False,
                              boxes_override=(boxes.to(cuda), valid.to(cuda)))
    torch.cuda.synchronize()
    assert warp_cuda.LAUNCHES == {k: 1 for k in warp_cuda.LAUNCHES}
    assert warp_cuda.ABLATION_LAUNCHES == {"pass2_fwd_ablation": 0}
    assert warp_cuda.WINDOWS == 3
    assert nms_cuda.LAUNCHES == nms_before + 1
    assert np.isfinite(float(m.loss))
    assert not torch.equal(state.patch.detach(), patch0)


# ---------------------------------------------------------------------------
# cmconv
# ---------------------------------------------------------------------------

# (C, Co) of the defender's small-channel 3x3 convs: forward 3->8, 8->8,
# 8->16, 16->16, 32->16, 16->16, 16->8, 8->8; input gradients the same
# convs with C and Co swapped (16->32 and 16->8 are new); the packed U-Net's
# level-1 convs on the packed grid: forward 12->32 and 32->32, input
# gradients 32->32 and 32->12
CMCONV_PATH = [(3, 8), (8, 8), (8, 16), (16, 16), (32, 16), (16, 8), (16, 32),
               (12, 32), (32, 32), (32, 12)]
# (id, B, C, Co, H, W): sizes off the instances' 64-wide tiles, 1x1 images, one image, one
# channel, the 32-channel limit, output widths off the compiled ones
CMCONV_EDGES = [("ragged_13x37", 2, 8, 8, 13, 37), ("1x1", 3, 8, 16, 1, 1),
                ("b1", 1, 16, 16, 24, 40), ("c1", 2, 1, 8, 20, 20),
                ("c32_co32", 1, 32, 32, 17, 33), ("co1", 2, 8, 1, 9, 9),
                ("co3", 2, 5, 3, 10, 11), ("co20", 1, 12, 20, 8, 70)]


def _cmconv_case(cuda, b, c, co, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g).to(cuda)
    wt = (torch.randn((3, 3, c, co), generator=g) * 0.3).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    return x, wt, bias


def _assert_cmconv(cuda, x, wt, bias, instance=None):
    """The plan's pick (instance None) or a named instance against plain."""
    if instance is None:
        before, count = cmconv_cuda.LAUNCHES, lambda: cmconv_cuda.LAUNCHES
        run = lambda: cmconv_cuda.cmconv3x3_cuda(x, wt, bias)
    else:
        before = cmconv_cuda.INSTANCE_LAUNCHES[instance]
        count = lambda: cmconv_cuda.INSTANCE_LAUNCHES[instance]
        run = lambda: cmconv_cuda.cmconv3x3_instance(x, wt, bias, instance)
    out = run()
    plain = pcmconv.cmconv_plain(x, wt, bias)
    torch.cuda.synchronize()
    assert count() == before + 1
    _close(out, plain, f"cmconv {instance or 'plan'}", CMCONV_TOL)
    assert torch.equal(run(), out)


@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_cmconv_kernel_matches_plain_at_path_shapes(cuda, c, co, with_bias):
    x, wt, bias = _cmconv_case(cuda, 4, c, co, 48, 64, seed=c * 100 + co)
    _assert_cmconv(cuda, x, wt, bias if with_bias else None)


@pytest.mark.parametrize("name,b,c,co,h,w", CMCONV_EDGES, ids=[e[0] for e in CMCONV_EDGES])
def test_cmconv_kernel_edge_cases(cuda, name, b, c, co, h, w):
    _assert_cmconv(cuda, *_cmconv_case(cuda, b, c, co, h, w, seed=7))


@pytest.mark.parametrize("instance", sorted(cmconv_cuda.ENTRIES))
@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
def test_cmconv_instances_match_plain_at_path_shapes(cuda, c, co, instance):
    x, wt, bias = _cmconv_case(cuda, 4, c, co, 48, 64, seed=c * 100 + co)
    _assert_cmconv(cuda, x, wt, bias, instance)


@pytest.mark.parametrize("instance", sorted(cmconv_cuda.ENTRIES))
@pytest.mark.parametrize("name,b,c,co,h,w", CMCONV_EDGES, ids=[e[0] for e in CMCONV_EDGES])
def test_cmconv_instances_edge_cases(cuda, name, b, c, co, h, w, instance):
    _assert_cmconv(cuda, *_cmconv_case(cuda, b, c, co, h, w, seed=7), instance)


@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
def test_cmconv_launches_the_plans_instance(cuda, c, co):
    """cmconv3x3_cuda is bit-equal to the instance its plan names."""
    x, wt, bias = _cmconv_case(cuda, 2, c, co, 24, 72, seed=c + co)
    inst = cmconv_cuda.plan(c, co, 24, 72).instance
    assert torch.equal(cmconv_cuda.cmconv3x3_cuda(x, wt, bias),
                       cmconv_cuda.cmconv3x3_instance(x, wt, bias, inst))


def test_cmconv_autograd_on_card_matches_cpu(cuda):
    """Forward and input gradient through the kernel, weight gradient by
    conv2d_weight: the same as the plain version on the CPU."""
    x, wt, bias = _cmconv_case(torch.device("cpu"), 2, 16, 8, 20, 36, seed=3)
    g = torch.randn((2, 8, 20, 36), generator=torch.Generator().manual_seed(4))
    grads = []
    for dev in (torch.device("cpu"), cuda):
        args = [a.to(dev).clone().requires_grad_(True) for a in (x, wt, bias)]
        before = cmconv_cuda.LAUNCHES
        (pcmconv.cmconv(*args) * g.to(dev)).sum().backward()
        assert cmconv_cuda.LAUNCHES == before + (2 if dev.type == "cuda" else 0)
        grads.append([a.grad.cpu() for a in args])
    for name, a, b in zip(("dx", "dw", "db"), grads[1], grads[0]):
        _close(a, b, name, 1e-5)


def test_cmconv_wrapper_rejects_bad_inputs(cuda):
    x, wt, bias = _cmconv_case(cuda, 1, 8, 8, 16, 16)
    before = cmconv_cuda.LAUNCHES
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        cmconv_cuda.cmconv3x3_cuda(x.double(), wt.double())
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        cmconv_cuda.cmconv3x3_cuda(x, wt, bias.half())
    with pytest.raises(ValueError, match="contiguous"):
        cmconv_cuda.cmconv3x3_cuda(x.to(memory_format=torch.channels_last), wt)
    with pytest.raises(ValueError, match="contiguous"):
        cmconv_cuda.cmconv3x3_cuda(x, wt.transpose(2, 3))
    big, wbig, _ = _cmconv_case(cuda, 1, 33, 8, 8, 8)
    with pytest.raises(ValueError, match="outside 1..32"):
        cmconv_cuda.cmconv3x3_cuda(big, wbig)
    with pytest.raises(ValueError, match="outside 1..32"):
        cmconv_cuda.cmconv3x3_cuda(x, torch.zeros((3, 3, 8, 33), device=cuda))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cmconv_cuda.cmconv3x3_cuda(x.cpu(), wt.cpu())
    with pytest.raises(ValueError, match="CUDA tensors"):
        cmconv_cuda.cmconv3x3_cuda(x, wt.cpu())
    with pytest.raises(ValueError, match="want x"):
        cmconv_cuda.cmconv3x3_cuda(x, torch.zeros((5, 5, 8, 8), device=cuda))
    with pytest.raises(ValueError, match="empty"):
        cmconv_cuda.cmconv3x3_cuda(x[:0], wt)
    with pytest.raises(RuntimeError, match="cudaError_t 1 "):
        cmconv_cuda.cmconv3x3_cuda(torch.zeros((70000, 1, 1, 1), device=cuda),
                                   torch.zeros((3, 3, 1, 1), device=cuda))
    assert cmconv_cuda.LAUNCHES == before
    _assert_cmconv(cuda, x, wt, bias)  # the context still works


# the bf16 instances against the bf16 function. The plan's pick, the Hopper
# instance (csrc/cmconv_bf16_sm90.cu), sums each weight's bf16 hi and lo
# terms' exact products on the tensor cores in its own K order: every
# element within `cmconv.cmconv_rounding_bound` of the float64 sum, for
# kernels of bf16 values (the U-Net's) and general float32 ones, and within
# one rounding of the plain version (`cmconv.BF16_TOL`, two bf16 ulps of
# scale with the bias's second rounding). The SIMT instance `simt`
# (csrc/cmconv_bf16.cu): with a kernel of bf16 values each product is exact
# in float32 and the sums run in the plain version's order, so its output is
# bit-equal; with any float32 kernel within BF16_TOL
CMCONV_BF16_EXTRA = [("w_even_not_8", 2, 8, 8, 12, 36), ("misaligned_x", 2, 8, 16, 9, 24)]
# heights off the Hopper instance's 8-, 6-, 4- and 2-row tiles (a spatial
# shard's halo-extended rows), at each tile height
CMCONV_ODD_HEIGHTS = (1, 13, 162, 322)


def _cmconv_bf16_case(cuda, b, c, co, h, w, seed=0, offset=0):
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn((b * c * h * w + offset,), generator=g).bfloat16().to(cuda)
    x = flat[offset:].view(b, c, h, w)  # offset 1: x not 4-byte aligned
    wt = (torch.randn((3, 3, c, co), generator=g) * 0.3).to(cuda)
    bias = torch.randn((co,), generator=g).bfloat16().to(cuda)
    return x, wt, bias


def _assert_within_rounding_bound(name, out, x, wt, bias):
    err = (out.double() - pcmconv.cmconv_sum64(x, wt, bias)).abs()
    bound = pcmconv.cmconv_rounding_bound(x, wt, bias)
    outside = int((err > bound).sum())
    assert outside == 0, f"{name}: {outside} elements outside cmconv_rounding_bound"


def _assert_cmconv_bf16(cuda, x, wt, bias):
    f32_before = cmconv_cuda.DTYPE_LAUNCHES["float32"]
    before = cmconv_cuda.DTYPE_LAUNCHES["bfloat16"]
    plan_before = dict(cmconv_cuda.PLAN_LAUNCHES)
    for w_ in (wt.bfloat16().float(), wt):
        for b_ in (bias, None):
            out = cmconv_cuda.cmconv3x3_cuda(x, w_, b_)
            plain = pcmconv.cmconv_plain(x, w_, b_)
            assert out.dtype == torch.bfloat16 and out.shape == plain.shape
            _close(out.float(), plain.float(), "cmconv bf16", pcmconv.BF16_TOL)
            _assert_within_rounding_bound("cmconv bf16 sm90", out, x, w_, b_)
            assert torch.equal(cmconv_cuda.cmconv3x3_cuda(x, w_, b_), out)
            simt = cmconv_cuda.cmconv3x3_instance(x, w_, b_, "simt")
            _close(simt.float(), plain.float(), "cmconv bf16 simt", pcmconv.BF16_TOL)
            if w_ is not wt:
                assert torch.equal(simt, plain)
    torch.cuda.synchronize()
    assert cmconv_cuda.DTYPE_LAUNCHES["bfloat16"] == before + 8
    assert cmconv_cuda.DTYPE_LAUNCHES["float32"] == f32_before
    assert cmconv_cuda.PLAN_LAUNCHES == dict(plan_before,
                                             sm90_bf16=plan_before["sm90_bf16"] + 8)
    inst = cmconv_cuda.INSTANCE_LAUNCHES["sm90_bf16"]
    assert torch.equal(cmconv_cuda.cmconv3x3_instance(x, wt, bias, "sm90"),
                       cmconv_cuda.cmconv3x3_cuda(x, wt, bias))
    assert cmconv_cuda.INSTANCE_LAUNCHES["sm90_bf16"] == inst + 1


@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
def test_cmconv_bf16_matches_plain_at_path_shapes(cuda, c, co):
    _assert_cmconv_bf16(cuda, *_cmconv_bf16_case(cuda, 4, c, co, 48, 64, seed=c * 100 + co))


@pytest.mark.parametrize("name,b,c,co,h,w", CMCONV_EDGES + CMCONV_BF16_EXTRA,
                         ids=[e[0] for e in CMCONV_EDGES + CMCONV_BF16_EXTRA])
def test_cmconv_bf16_edge_cases(cuda, name, b, c, co, h, w):
    offset = 1 if name == "misaligned_x" else 0
    _assert_cmconv_bf16(cuda, *_cmconv_bf16_case(cuda, b, c, co, h, w, 7, offset))


@pytest.mark.parametrize("h", CMCONV_ODD_HEIGHTS)
@pytest.mark.parametrize("c,co", [(8, 8), (16, 16), (32, 16), (16, 32), (32, 32)],
                         ids=["8to8", "16to16", "32to16", "16to32", "32to32"])
def test_cmconv_bf16_odd_heights(cuda, c, co, h):
    _assert_cmconv_bf16(cuda, *_cmconv_bf16_case(cuda, 2, c, co, h, 64, seed=h + c + co))


def test_cmconv_bf16_wrapper_refuses_float16_and_mixed_dtypes(cuda):
    x, wt, bias = _cmconv_bf16_case(cuda, 1, 8, 8, 16, 16)
    before = cmconv_cuda.LAUNCHES
    for args in ((x.half(), wt), (x, wt.bfloat16()), (x, wt, bias.float()),
                 (x.float(), wt, bias), (x, wt.half())):
        with pytest.raises(TypeError, match="float32 or bfloat16 x"):
            cmconv_cuda.cmconv3x3_cuda(*args)
    with pytest.raises(ValueError, match="no bfloat16 cmconv instance 'tc'"):
        cmconv_cuda.cmconv3x3_instance(x, wt, bias, "tc")
    assert cmconv_cuda.LAUNCHES == before


def test_cmconv_bf16_autograd_on_card_matches_cpu(cuda):
    """The bf16 op on the card (forward and input gradient through the
    Hopper instance, weight gradient by cuDNN in bf16) against the same op on
    the CPU (the plain version): forward and dx each within
    `cmconv_rounding_bound` of its float64 sum (dx: the conv of g with w
    flipped and C / Co swapped) and within one bf16 rounding of scale of the
    CPU's; dw and db within two bf16 ulps of scale."""
    x, wt, bias = _cmconv_bf16_case(torch.device("cpu"), 2, 16, 8, 20, 36, seed=3)
    wt = wt.bfloat16().float()
    g = torch.randn((2, 8, 20, 36), generator=torch.Generator().manual_seed(4)).bfloat16()
    res = []
    for dev in (torch.device("cpu"), cuda):
        args = [a.to(dev).clone().requires_grad_(True) for a in (x, wt, bias)]
        before = cmconv_cuda.DTYPE_LAUNCHES["bfloat16"]
        out = pcmconv.cmconv(*args)
        out.backward(g.to(dev))
        n = cmconv_cuda.DTYPE_LAUNCHES["bfloat16"] - before
        assert n == (2 if dev.type == "cuda" else 0)
        res.append([out.detach().cpu()] + [a.grad.cpu() for a in args])
    _assert_within_rounding_bound("forward", res[1][0], x, wt, bias)
    _assert_within_rounding_bound("dx", res[1][1], g, wt.flip(0, 1).transpose(2, 3), None)
    for name, a, b in zip(("out", "dx", "dw", "db"), res[1], res[0]):
        _close(a.float(), b.float(), name, pcmconv.BF16_TOL)


def test_defender_step_on_card_goes_through_kernels(cuda):
    """A tiny lite0 defender step on the card (n_filters 8, score threshold
    .0099 so the random victim's detections get patches): 15 cmconv
    launches (8 forward, 7 input gradients), the two forward warp passes
    once each and no transpose (the images need no gradient), NMS once; then
    eval_step (8 cmconv, 3 NMS) and recover (8 cmconv)."""
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.override({"image_size": 64, "fpn_num_filters": 16,
                  "fpn_cell_repeats": 1, "box_class_repeats": 1,
                  "nms_configs": {"iou_thresh": 0.5, "score_thresh": 0.0099,
                                  "pre_nms_topk": 64, "max_output_size": 16},
                  "max_boxes_per_image": 4})
    patch = torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    d = PatchAttackDefender(cfg, get_victim(cfg, seed=0, device=cuda),
                            eval_patch=patch.numpy(), device=cuda)
    state = d.init_state(0)
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2)
                        ).to(cuda) * 2 - 1
    params0 = [p.detach().clone() for p in state.unet.parameters()]
    warp_cuda.reset_counts()
    cm0, nms0 = cmconv_cuda.LAUNCHES, nms_cuda.LAUNCHES
    state, m = d.train_step(state, images)
    torch.cuda.synchronize()
    assert cmconv_cuda.LAUNCHES - cm0 == 15
    assert warp_cuda.LAUNCHES == {"pass1_fwd": 1, "pass2_fwd": 1,
                                  "pass2_bwd": 0, "pass1_bwd": 0}
    assert warp_cuda.WINDOWS > 0
    assert nms_cuda.LAUNCHES - nms0 == 1
    assert np.isfinite(float(m.loss)) and float(m.mean_clean_score) > 0
    assert any(not torch.equal(p, q) for p, q in zip(state.unet.parameters(), params0))
    cm0, nms0 = cmconv_cuda.LAUNCHES, nms_cuda.LAUNCHES
    em = d.eval_step(state, images)
    torch.cuda.synchronize()
    assert (cmconv_cuda.LAUNCHES - cm0, nms_cuda.LAUNCHES - nms0) == (8, 3)
    assert np.isfinite(float(em.loss)) and np.isfinite(float(em.recovery_psnr))
    cm0 = cmconv_cuda.LAUNCHES
    rec = d.recover(state, images)
    torch.cuda.synchronize()
    assert cmconv_cuda.LAUNCHES - cm0 == 8
    assert rec.shape == images.shape and float(rec.abs().max()) <= 1.0


@pytest.mark.parametrize("variant", ["bf16", "packed1", "packed3_bf16", "remat"])
def test_defender_variants_on_card(cuda, variant):
    """The bf16, packed and remat defenders on the card: a train step, an
    eval_step and recover. bf16: every cmconv launch in its bf16 instance
    (15 a step, 8 an eval_step or recover), none in the float32 one.
    Packed: a packed 3x3 conv goes to cmconv where both packed channel
    counts are at most 32 (conv0's two and deconv3's second: 3 forward, 2
    input gradients a step); at level 1 the unpacked conv1 and deconv2
    blocks add their 4 convs (13 launches a step, 7 an eval pass). remat:
    the same 15 launches a step, plus the 8 forwards of the recompute."""
    from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.override({"image_size": 64, "fpn_num_filters": 16,
                  "fpn_cell_repeats": 1, "box_class_repeats": 1,
                  "nms_configs": {"iou_thresh": 0.5, "score_thresh": 0.0099,
                                  "pre_nms_topk": 64, "max_output_size": 16},
                  "max_boxes_per_image": 4})
    bf16 = variant.endswith("bf16")
    cfg.mixed_precision = bf16
    packed = {"packed1": 1, "packed3_bf16": 3}.get(variant, 0)
    patch = torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    d = PatchAttackDefender(cfg, get_victim(cfg, seed=0, device=cuda),
                            eval_patch=patch.numpy(), packed=packed, device=cuda)
    state = d.init_state(0)
    if variant == "remat":
        remat = PatchNeutralizer(8, remat=True).to(cuda)
        remat.load_state_dict(state.unet.state_dict())
        state.unet = remat
        state.optimizer = torch.optim.Adam(remat.parameters(), lr=1e-2)
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2)
                        ).to(cuda) * 2 - 1
    want = {"bf16": (15, 8), "packed1": (13, 7), "packed3_bf16": (5, 3),
            "remat": (15 + 8, 8)}[variant]
    dtype = "bfloat16" if bf16 else "float32"
    cmconv_cuda.reset_counts()
    state, m = d.train_step(state, images)
    em = d.eval_step(state, images)
    rec = d.recover(state, images)
    torch.cuda.synchronize()
    assert cmconv_cuda.DTYPE_LAUNCHES[dtype] == want[0] + 2 * want[1]
    assert cmconv_cuda.LAUNCHES == want[0] + 2 * want[1]
    key = "sm90_bf16" if bf16 else "simt"  # every bf16 launch on the Hopper instance
    assert cmconv_cuda.PLAN_LAUNCHES == dict(dict.fromkeys(cmconv_cuda.PLAN_LAUNCHES, 0),
                                             **{key: want[0] + 2 * want[1]})
    assert np.isfinite(float(m.loss)) and np.isfinite(float(em.loss))
    assert rec.dtype == torch.float32 and rec.shape == images.shape
    assert float(rec.abs().max()) <= 1.0


# ---------------------------------------------------------------------------
# fused frozen MBConv
# ---------------------------------------------------------------------------

MBCONV_FWD_TOL = 1e-5  # of max(1, max|plain|): 3xTF32 products, summed in another order
MBCONV_DX_TOL = 1e-4   # of max|plain| of the plain dx fed the kernel's own relu masks
MBCONV_KINK_TOL = 1e-5  # of max(1, max|z|): a mask that differs lies this near its kink
# (id, B, H, W, C, E, Co, k, residual, act); the last four reach the tile
# plan's regimes: a split of E at 20x20, the 16x16 tile, C and Co not
# multiples of 8
MBCONV_CASES = [
    ("k3_res_relu6", 2, 16, 16, 24, 144, 24, 3, True, "relu6"),
    ("k5_res_relu6", 2, 20, 20, 40, 240, 40, 5, True, "relu6"),
    ("k3_c13_co20_relu", 3, 12, 10, 13, 78, 20, 3, False, "relu"),
    ("k5_swish", 1, 18, 22, 16, 96, 24, 5, False, "swish"),
    ("k3_res_swish", 2, 9, 9, 32, 192, 32, 3, True, "swish"),
    ("co_gt_c_272to448", 1, 20, 20, 272, 1632, 448, 3, False, "relu6"),
    ("1x1_b3_k5", 3, 1, 1, 8, 48, 8, 5, True, "relu6"),
    ("ragged_13x37", 1, 13, 37, 16, 96, 24, 3, False, "relu6"),
    ("b1_k5_relu", 1, 10, 12, 24, 144, 24, 5, True, "relu"),
    ("split_e_20x20_k5", 1, 20, 20, 272, 1632, 272, 5, True, "relu6"),
    ("tile16x16_96x96", 2, 96, 96, 32, 192, 32, 3, True, "relu6"),
    ("c12_co20_k5", 2, 14, 11, 12, 72, 20, 5, False, "relu6"),
    ("c20_co12_swish", 1, 9, 17, 20, 120, 12, 3, False, "swish"),
]


def _mbconv_case(cuda, b, h, w, c, e, co, k, seed=0):
    """x [B, H, W, C] and a FoldedBlock with fan-in scaled random weights."""
    from mladversarialobjectdetection_torch.ops.mbconv import FoldedBlock
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape, s=1.0: (torch.randn(shape, generator=g) * s).to(cuda)
    fb = FoldedBlock(we=r(c, e, s=2 / c ** 0.5), be=r(e, s=0.5), wd=r(k, k, e, s=2 / k),
                     bd=r(e, s=0.5), wp=r(e, co, s=2 / e ** 0.5), bp=r(co, s=0.5))
    return r(b, h, w, c), fb


def _plain_dx_with_kernel_masks(x, gy, fb, act, residual):
    """(plain dx, (z0 flips, z1 flips, worst distance)): for relu6 / relu the
    plain dx fed the masks the kernel's masks instance writes, and every
    mask that differs from the plain version's checked against its kink."""
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    kw = dict(act_type=act, residual=residual)
    if act not in ("relu6", "relu"):
        return pmb.mbconv_dx_plain(x, gy, fb, **kw), (0, 0, 0.0)
    b, h, w, _ = x.shape
    masks = torch.full((2, b, h, w, fb.we.shape[1]), 7, dtype=torch.uint8, device=x.device)
    mbconv_cuda.mbconv_dx_cuda(x, gy, fb, masks_out=masks, **kw)
    assert int(masks.max()) <= 1  # every mask written
    plain_masks, z0, z1 = pmb.dx_masks(x, fb, act_type=act)
    flips = pmb.kink_flips(masks, plain_masks, z0, z1, act)
    assert flips[2] <= MBCONV_KINK_TOL, flips
    return pmb.mbconv_dx_plain(x, gy, fb, masks=masks, **kw), flips


@pytest.mark.parametrize("name,b,h,w,c,e,co,k,residual,act", MBCONV_CASES,
                         ids=[m[0] for m in MBCONV_CASES])
def test_mbconv_kernels_match_plain(cuda, name, b, h, w, c, e, co, k, residual, act):
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    x, fb = _mbconv_case(cuda, b, h, w, c, e, co, k, seed=b * 1000 + c)
    gy = torch.randn((b, h, w, co), generator=torch.Generator().manual_seed(1)).to(cuda)
    before = dict(mbconv_cuda.LAUNCHES)
    kw = dict(act_type=act, residual=residual)
    y = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    dx = mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw)
    torch.cuda.synchronize()
    assert mbconv_cuda.LAUNCHES == {k_: v + 1 for k_, v in before.items()}
    y_plain = pmb.mbconv_plain(x, fb, **kw)
    dx_plain, _ = _plain_dx_with_kernel_masks(x, gy, fb, act, residual)
    _close(y, y_plain, "mbconv fwd", MBCONV_FWD_TOL)
    err = float((dx - dx_plain).abs().max())
    assert err <= MBCONV_DX_TOL * float(dx_plain.abs().max()), err
    # no atomics, the split's partials added in a fixed order: a second
    # launch repeats bit for bit
    assert torch.equal(mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw), y)
    assert torch.equal(mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw), dx)


@pytest.mark.parametrize("name,b,h,w,c,e,co,k,residual,act", MBCONV_CASES,
                         ids=[m[0] for m in MBCONV_CASES])
def test_mbconv_ablation_matches_kernel(cuda, name, b, h, w, c, e, co, k, residual, act):
    """The SIMT ablation (csrc/mbconv.cu, TC = false) on the main kernel's
    plan: the forward within MBCONV_FWD_TOL of the kernel's, dx within
    MBCONV_DX_TOL with swish (the two sum z0 in different orders, so a relu
    mask may flip between them)."""
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    if c % 4 or e % 4 or co % 4:
        pytest.skip("the ablation is built for 16-byte shapes only")
    x, fb = _mbconv_case(cuda, b, h, w, c, e, co, k, seed=b * 1000 + c)
    gy = torch.randn((b, h, w, co), generator=torch.Generator().manual_seed(1)).to(cuda)
    kw = dict(act_type=act, residual=residual)
    before = dict(mbconv_cuda.LAUNCHES)
    _close(mbconv_cuda.mbconv_fwd_simt(x, fb, **kw), mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw),
           "mbconv fwd ablation", MBCONV_FWD_TOL)
    kw["act_type"] = "swish"
    ref = mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw)
    err = float((mbconv_cuda.mbconv_dx_simt(x, gy, fb, **kw) - ref).abs().max())
    assert err <= MBCONV_DX_TOL * float(ref.abs().max()), err
    assert mbconv_cuda.LAUNCHES == {k_: v + 1 for k_, v in before.items()}


@pytest.mark.parametrize("name,b,h,w,c,e,co,k,residual,act", MBCONV_CASES,
                         ids=[m[0] for m in MBCONV_CASES])
def test_mbconv_bf16_kernels_match_plain(cuda, name, b, h, w, c, e, co, k, residual, act):
    """The bf16 main path (the Hopper kernels where their rules take the
    shape, the bf16 instances elsewhere) against the bf16 plain versions
    (chip_smoke.py's tolerances), only bf16 launches counted, two launches
    bit-equal."""
    import chip_smoke
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    x, fb = _mbconv_case(cuda, b, h, w, c, e, co, k, seed=b * 1000 + c)
    x, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    gy = torch.randn((b, h, w, co), generator=torch.Generator().manual_seed(1)).to(
        cuda, torch.bfloat16)
    kw = dict(act_type=act, residual=residual)
    mbconv_cuda.reset_counts()
    y = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    dx = mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == torch.bfloat16
    assert mbconv_cuda.DTYPE_LAUNCHES["bfloat16"] == {"mbconv_fwd": 1, "mbconv_dx": 1}
    assert sum(mbconv_cuda.DTYPE_LAUNCHES["float32"].values()) == 0
    y_plain = pmb.mbconv_plain(x, fb, **kw)
    _close(y.float(), y_plain.float(), "mbconv bf16 fwd", chip_smoke.MBCONV_BF16_FWD_TOL)
    bound = pmb.rounding_bound(y, x, fb, **kw)
    assert bound.outside == 0, bound
    if act in ("relu6", "relu"):
        masks = torch.full((2, b, h, w, e), 7, dtype=torch.uint8, device=cuda)
        mbconv_cuda.mbconv_dx_cuda(x, gy, fb, masks_out=masks, **kw)
        assert int(masks.max()) <= 1
        plain_masks, z0, z1 = pmb.dx_masks(x, fb, act_type=act)
        flips = pmb.kink_flips(masks, plain_masks, z0, z1, act)
        assert flips[2] <= chip_smoke.MBCONV_BF16_KINK_TOL, flips
        dx_plain = pmb.mbconv_dx_plain(x, gy, fb, masks=masks, **kw)
    else:
        dx_plain = pmb.mbconv_dx_plain(x, gy, fb, **kw)
    err = float((dx.float() - dx_plain.float()).abs().max())
    assert err <= chip_smoke.MBCONV_BF16_DX_TOL * float(dx_plain.float().abs().max()), err
    assert torch.equal(mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw), y)
    assert torch.equal(mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw), dx)


def test_mbconv_bf16_wrapper_rejects_other_dtypes(cuda):
    """No float16 instance, no mixed x / g dtypes, no bf16 x with a float32
    fold (nor the reverse), no bf16 ablation."""
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    x, fb = _mbconv_case(cuda, 1, 8, 8, 8, 48, 8, 3)
    fb16 = fb.in_dtype(torch.bfloat16)
    kw = dict(act_type="relu6", residual=True)
    mbconv_cuda.reset_counts()
    with pytest.raises(TypeError, match="float32 only"):
        mbconv_cuda.mbconv_fwd_cuda(x.half(), fb, **kw)
    with pytest.raises(TypeError, match="float32 only"):
        mbconv_cuda.mbconv_dx_cuda(x.bfloat16(), x, fb16, **kw)
    with pytest.raises(TypeError, match="float32 only"):
        mbconv_cuda.mbconv_fwd_cuda(x.bfloat16(), fb, **kw)
    with pytest.raises(TypeError, match="float32 only"):
        mbconv_cuda.mbconv_fwd_cuda(x, fb16, **kw)
    with pytest.raises(TypeError, match="SIMT"):
        mbconv_cuda.mbconv_fwd_simt(x.bfloat16(), fb16, **kw)
    assert sum(mbconv_cuda.LAUNCHES.values()) == 0


def _sm90_cases():
    """(id, B, H, W, C, E, Co, k, residual, act): the MBCONV_CASES the Hopper
    bf16 forward's rule takes, and lite4@640's 7 fused shapes at b2."""
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    from mladversarialobjectdetection_torch.ops.mbconv_sweep import LITE4_FUSED
    cases = [m for m in MBCONV_CASES if mbconv_cuda.sm90_supported(*m[2:8], m[1])]
    cases += [(f"lite4_{s[0]}x{s[1]}_c{s[2]}_co{s[4]}_k{s[5]}", 2, *s, "relu6")
              for s in LITE4_FUSED]
    return cases


SM90_CASES = _sm90_cases()


@pytest.mark.parametrize("name,b,h,w,c,e,co,k,residual,act", SM90_CASES,
                         ids=[m[0] for m in SM90_CASES])
def test_mbconv_sm90_matches_plain(cuda, name, b, h, w, c, e, co, k, residual, act):
    """The Hopper bf16 forward (csrc/mbconv_fwd_sm90.cu) against the bf16
    plain version: within chip_smoke.py's MBCONV_BF16_FWD_TOL of max(1,
    max|plain|), every output within `rounding_bound`, two launches
    bit-equal, both counted on it and none on the bf16 instance."""
    import chip_smoke
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    x, fb = _mbconv_case(cuda, b, h, w, c, e, co, k, seed=b * 1000 + c)
    x, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    kw = dict(act_type=act, residual=residual)
    mbconv_cuda.reset_counts()
    y = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    again = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    torch.cuda.synchronize()
    assert mbconv_cuda.BF16_FWD_LAUNCHES == {"sm90": 2, "instance": 0}
    assert mbconv_cuda.DTYPE_LAUNCHES["bfloat16"] == {"mbconv_fwd": 2, "mbconv_dx": 0}
    assert y.dtype == torch.bfloat16 and torch.equal(y, again)
    y_plain = pmb.mbconv_plain(x, fb, **kw)
    _close(y.float(), y_plain.float(), "mbconv sm90 fwd", chip_smoke.MBCONV_BF16_FWD_TOL)
    bound = pmb.rounding_bound(y, x, fb, **kw)
    assert bound.outside == 0, bound


def test_mbconv_sm90_rule_sends_other_shapes_to_the_instance(cuda):
    """C, E or Co off a multiple of 8 runs the template's bf16 instance,
    counted apart; `mbconv_fwd_bf16_instance` runs the instance on a shape
    the Hopper kernel takes, and the two agree within the bf16 tolerance."""
    import chip_smoke
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    kw = dict(act_type="relu", residual=False)
    x, fb = _mbconv_case(cuda, 3, 12, 10, 13, 78, 20, 3)
    x, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    assert not mbconv_cuda.sm90_supported(12, 10, 13, 78, 20, 3, 3)
    mbconv_cuda.reset_counts()
    y = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    torch.cuda.synchronize()
    assert mbconv_cuda.BF16_FWD_LAUNCHES == {"sm90": 0, "instance": 1}
    _close(y.float(), pmb.mbconv_plain(x, fb, **kw).float(), "mbconv bf16 instance",
           chip_smoke.MBCONV_BF16_FWD_TOL)
    x, fb = _mbconv_case(cuda, 2, 16, 16, 24, 144, 24, 3)
    x, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    mbconv_cuda.reset_counts()
    inst = mbconv_cuda.mbconv_fwd_bf16_instance(x, fb, **kw)
    new = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    torch.cuda.synchronize()
    assert mbconv_cuda.BF16_FWD_LAUNCHES == {"sm90": 1, "instance": 1}
    _close(new.float(), inst.float(), "mbconv sm90 vs instance", 2 * chip_smoke.MBCONV_BF16_FWD_TOL)


def _sm90_dx_cases():
    """(id, B, H, W, C, E, Co, k, residual, act): the MBCONV_CASES the Hopper
    bf16 dx's rule takes, and lite4@640's 7 fused shapes at b2."""
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    from mladversarialobjectdetection_torch.ops.mbconv_sweep import LITE4_FUSED
    cases = [m for m in MBCONV_CASES if mbconv_cuda.sm90_dx_supported(*m[2:8], m[1])]
    cases += [(f"lite4_{s[0]}x{s[1]}_c{s[2]}_co{s[4]}_k{s[5]}", 2, *s, "relu6")
              for s in LITE4_FUSED]
    return cases


SM90_DX_CASES = _sm90_dx_cases()


@pytest.mark.parametrize("name,b,h,w,c,e,co,k,residual,act", SM90_DX_CASES,
                         ids=[m[0] for m in SM90_DX_CASES])
def test_mbconv_dx_sm90_matches_plain(cuda, name, b, h, w, c, e, co, k, residual, act):
    """The Hopper bf16 dx (csrc/mbconv_dx_sm90.cu) against the bf16 plain dx
    fed its own masks (relu6 / relu): within chip_smoke.py's
    MBCONV_BF16_DX_TOL of max|plain|, every element and mask within
    `dx_rounding_bound`, two launches bit-equal, both counted on it and none
    on the bf16 instance."""
    import chip_smoke
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    x, fb = _mbconv_case(cuda, b, h, w, c, e, co, k, seed=b * 1000 + c)
    x, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    gy = (torch.randn((b, h, w, co), generator=torch.Generator().manual_seed(3)) * 0.1).to(
        cuda, torch.bfloat16)
    kw = dict(act_type=act, residual=residual)
    relu = act in ("relu6", "relu")
    masks = torch.full((2, b, h, w, e), 7, dtype=torch.uint8, device=cuda) if relu else None
    mbconv_cuda.reset_counts()
    dx = mbconv_cuda.mbconv_dx_cuda(x, gy, fb, masks_out=masks, **kw)
    again = mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw)
    torch.cuda.synchronize()
    assert mbconv_cuda.BF16_DX_LAUNCHES == {"sm90": 2, "instance": 0}
    assert mbconv_cuda.DTYPE_LAUNCHES["bfloat16"] == {"mbconv_fwd": 0, "mbconv_dx": 2}
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, again)
    if relu:
        assert int(masks.max()) <= 1
    dx_plain = pmb.mbconv_dx_plain(x, gy, fb, masks=masks, **kw)
    err = float((dx.float() - dx_plain.float()).abs().max())
    assert err <= chip_smoke.MBCONV_BF16_DX_TOL * float(dx_plain.float().abs().max()), err
    bound = pmb.dx_rounding_bound(dx, x, gy, fb, masks=masks, **kw)
    assert bound.outside == 0 and bound.mask_faults == 0, bound


def test_mbconv_dx_sm90_rule_sends_other_shapes_to_the_instance(cuda):
    """C, E or Co off a multiple of 8 runs the template's bf16 dx instance,
    counted apart; `mbconv_dx_bf16_instance` runs the instance on a shape
    the Hopper dx takes, and the two agree within the bf16 tolerance."""
    import chip_smoke
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    kw = dict(act_type="relu", residual=False)
    x, fb = _mbconv_case(cuda, 3, 12, 10, 13, 78, 20, 3)
    x, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    gy = torch.randn((3, 12, 10, 20), generator=torch.Generator().manual_seed(4)).to(
        cuda, torch.bfloat16)
    assert not mbconv_cuda.sm90_dx_supported(12, 10, 13, 78, 20, 3, 3)
    mbconv_cuda.reset_counts()
    dx = mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw)
    torch.cuda.synchronize()
    assert mbconv_cuda.BF16_DX_LAUNCHES == {"sm90": 0, "instance": 1}
    plain = pmb.mbconv_dx_plain(x, gy, fb, **kw).float()
    assert float((dx.float() - plain).abs().max()) <= (
        chip_smoke.MBCONV_BF16_DX_TOL * float(plain.abs().max()))
    x, fb = _mbconv_case(cuda, 2, 16, 16, 24, 144, 24, 3)
    x, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    gy = torch.randn((2, 16, 16, 24), generator=torch.Generator().manual_seed(5)).to(
        cuda, torch.bfloat16)
    mbconv_cuda.reset_counts()
    inst = mbconv_cuda.mbconv_dx_bf16_instance(x, gy, fb, **kw)
    new = mbconv_cuda.mbconv_dx_cuda(x, gy, fb, **kw)
    torch.cuda.synchronize()
    assert mbconv_cuda.BF16_DX_LAUNCHES == {"sm90": 1, "instance": 1}
    err = float((new.float() - inst.float()).abs().max())
    assert err <= 2 * chip_smoke.MBCONV_BF16_DX_TOL * float(inst.float().abs().max()), err


def test_bf16_attack_patch_gradient_sm90_dx_matches_instance(cuda):
    """A tiny bf16 lite0 attack loss: its patch gradient with every fused dx
    on the Hopper kernel against the same with every dx on the bf16
    instance (chip_smoke.InstanceRoute("dx")), at cosine >= 0.9999 and with
    norms within 1e-3: the two differ by bf16 roundings of gd, ge and dx."""
    import chip_smoke
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.override({"image_size": 64, "fpn_num_filters": 16,
                  "fpn_cell_repeats": 1, "box_class_repeats": 1,
                  "nms_configs": {"iou_thresh": 0.5, "score_thresh": 0.5,
                                  "pre_nms_topk": 64, "max_output_size": 16},
                  "max_boxes_per_image": 4})
    cfg.mixed_precision = True
    atk = PatchAttacker(cfg, get_victim(cfg, seed=0, device=cuda), patch_size=32, device=cuda)
    state = atk.init_state(seed=0)
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2)
                        ).to(cuda) * 2 - 1
    boxes = torch.zeros((2, 4, 4))
    boxes[:, 0] = torch.tensor([4.0, 4.0, 60.0, 60.0])
    valid = torch.zeros((2, 4), dtype=torch.bool)
    valid[:, 0] = True
    override = (boxes.to(cuda), valid.to(cuda))

    def patch_grad():
        patch = state.patch.detach().clone().requires_grad_(True)
        scale = state.scale.detach().clone().requires_grad_(True)
        loss, _ = atk._loss_from_images(patch, scale, images, *override,
                                        torch.Generator(cuda).manual_seed(7))
        loss.backward()
        return patch.grad.double().flatten()

    mbconv_cuda.reset_counts()
    new = patch_grad()
    assert mbconv_cuda.BF16_DX_LAUNCHES["sm90"] > 0
    assert mbconv_cuda.BF16_DX_LAUNCHES["instance"] == 0
    mbconv_cuda.reset_counts()
    with chip_smoke.InstanceRoute("dx"):
        old = patch_grad()
    assert mbconv_cuda.BF16_DX_LAUNCHES["sm90"] == 0
    assert mbconv_cuda.BF16_DX_LAUNCHES["instance"] > 0
    cos = float(new @ old / (new.norm() * old.norm()))
    assert cos >= 0.9999, cos
    assert abs(float(new.norm() / old.norm()) - 1.0) <= 1e-3


def test_warp_pass1_fwd_at_unit_and_wider_radius(cuda):
    """pass1_fwd runs its r = 1 instance (no division) and the divided one
    within one launch: both against the plain pass within WARP_TOL, and a
    second launch bit-equal."""
    canvases, table = warp_windows_case(np.random.default_rng(11), 3, 12, 96, 320)
    r = table[:, 6]
    assert bool((r == 1.0).any()) and bool((r > 1.0).any())
    canvases = canvases.to(cuda)
    t = warp_cuda.pass1_fwd(canvases, table, 320)
    _close(t, peot.pass1_fwd(canvases, table, 320), "pass1_fwd")
    assert torch.equal(warp_cuda.pass1_fwd(canvases, table, 320), t)


def test_mbconv_autograd_on_card_matches_cpu(cuda):
    """The op's card backward against the CPU's plain dx, fed the card
    kernel's relu masks (a mask can flip where z0 lies within rounding of a
    kink)."""
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    x, fb = _mbconv_case(torch.device("cpu"), 2, 12, 14, 16, 96, 16, 5, seed=3)
    gy = torch.randn((2, 12, 14, 16), generator=torch.Generator().manual_seed(4))
    xx = x.to(cuda).clone().requires_grad_(True)
    fbd = pmb.FoldedBlock(*(t.to(cuda) for t in fb))
    (pmb.mbconv(xx, fbd, act_type="relu6", residual=True) * gy.to(cuda)).sum().backward()
    masks = torch.empty((2, 2, 12, 14, 96), dtype=torch.uint8, device=cuda)
    mbconv_cuda.mbconv_dx_cuda(x.to(cuda), gy.to(cuda), fbd, act_type="relu6",
                               residual=True, masks_out=masks)
    cpu = pmb.mbconv_dx_plain(x, gy, fb, act_type="relu6", residual=True,
                              masks=masks.cpu())
    scale = float(cpu.abs().max())
    assert float((xx.grad.cpu() - cpu).abs().max()) <= MBCONV_DX_TOL * scale


def test_mbconv_wrapper_rejects_bad_inputs(cuda):
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    x, fb = _mbconv_case(cuda, 1, 8, 8, 8, 48, 8, 3)
    kw = dict(act_type="relu6", residual=True)
    before = dict(mbconv_cuda.LAUNCHES)
    with pytest.raises(TypeError, match="float32 only"):
        mbconv_cuda.mbconv_fwd_cuda(x.double(), fb, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mbconv_cuda.mbconv_fwd_cuda(x.cpu(), fb, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mbconv_cuda.mbconv_dx_cuda(x, x.cpu(), fb, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mbconv_cuda.mbconv_fwd_cuda(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                                    fb, **kw)
    with pytest.raises(ValueError, match="k 3 or 5"):
        x7, fb7 = _mbconv_case(cuda, 1, 8, 8, 8, 48, 8, 7)
        mbconv_cuda.mbconv_fwd_cuda(x7, fb7, **kw)
    with pytest.raises(ValueError, match="C == Co"):
        x2, fb2 = _mbconv_case(cuda, 1, 8, 8, 8, 48, 12, 3)
        mbconv_cuda.mbconv_fwd_cuda(x2, fb2, **kw)
    with pytest.raises(ValueError, match="unsupported act"):
        mbconv_cuda.mbconv_fwd_cuda(x, fb, act_type="hswish", residual=True)
    with pytest.raises(ValueError, match="16-byte"):
        xo = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
        mbconv_cuda.mbconv_fwd_cuda(xo, fb, **kw)
    with pytest.raises(ValueError, match="masks_out"):
        mbconv_cuda.mbconv_dx_cuda(x, x, fb, masks_out=torch.empty(3, device=cuda), **kw)
    # a plan the kernels have no instance for, or one whose slice passes its
    # accumulators: the C entry refuses
    xw, fbw = _mbconv_case(cuda, 1, 8, 8, 8, 48, 1024, 3)
    good = mbconv_cuda.plan_fwd(8, 8, 8, 48, 1024, 3)
    for bad in (good._replace(npw=5), good._replace(split=9),
                good._replace(n_per_slice=1024)):
        with pytest.raises(RuntimeError, match="cudaError_t 1 "):
            mbconv_cuda._fwd(xw, fbw, "relu6", False, bad, False)
    assert mbconv_cuda.LAUNCHES == before
    # any output width: 1024 channels run in slices of the accumulator
    from mladversarialobjectdetection_torch.ops import mbconv as pmb
    _close(mbconv_cuda.mbconv_fwd_cuda(xw, fbw, act_type="relu6", residual=False),
           pmb.mbconv_plain(xw, fbw, act_type="relu6", residual=False), "Co 1024",
           MBCONV_FWD_TOL)
    y = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)  # the context still works
    assert torch.isfinite(y).all()


def _lite0_cfg():
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.override({"image_size": 64, "fpn_num_filters": 16,
                  "fpn_cell_repeats": 1, "box_class_repeats": 1,
                  "nms_configs": {"iou_thresh": 0.5, "score_thresh": 0.0099,
                                  "pre_nms_topk": 64, "max_output_size": 16},
                  "max_boxes_per_image": 4})
    return cfg


def test_backbone_dispatches_fuseable_blocks_to_kernels(cuda):
    """lite0 has 11 fuseable blocks of 16: a serve launches the forward
    kernel 11 times, an attack step 22 forward and 11 dx, a defender step 11
    forward, eval_step 33; no fuseable block runs unfused on the card."""
    from mladversarialobjectdetection_torch.models.efficientnet import MBConvBlock
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    cfg = _lite0_cfg()
    unfused = []
    orig = MBConvBlock._forward_unfused

    def spy(self, x, *args, **kwargs):
        unfused.append(self.fuseable)
        return orig(self, x, *args, **kwargs)

    MBConvBlock._forward_unfused = spy
    try:
        victim = get_victim(cfg, seed=0, device=cuda)
        det = Detector("efficientdet-lite0", params={
            "image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
            "box_class_repeats": 1}, device=cuda)
        mbconv_cuda.reset_counts()
        det.serve([np.zeros((48, 80, 3), np.uint8)])
        assert mbconv_cuda.LAUNCHES == {"mbconv_fwd": 11, "mbconv_dx": 0}
        atk = PatchAttacker(cfg, victim, patch_size=32, device=cuda)
        state = atk.init_state(seed=0)
        images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2)
                            ).to(cuda) * 2 - 1
        boxes = torch.zeros((2, 4, 4))
        boxes[:, 0] = torch.tensor([4.0, 4.0, 60.0, 60.0])
        valid = torch.zeros((2, 4), dtype=torch.bool)
        valid[:, 0] = True
        mbconv_cuda.reset_counts()
        atk.train_step(state, images, with_asr=False,
                       boxes_override=(boxes.to(cuda), valid.to(cuda)))
        torch.cuda.synchronize()
        assert mbconv_cuda.LAUNCHES == {"mbconv_fwd": 22, "mbconv_dx": 11}
        patch = torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
        d = PatchAttackDefender(cfg, victim, eval_patch=patch.numpy(), device=cuda)
        dstate = d.init_state(0)
        mbconv_cuda.reset_counts()
        d.train_step(dstate, images)
        assert mbconv_cuda.LAUNCHES == {"mbconv_fwd": 11, "mbconv_dx": 0}
        mbconv_cuda.reset_counts()
        d.eval_step(dstate, images)
        assert mbconv_cuda.LAUNCHES == {"mbconv_fwd": 33, "mbconv_dx": 0}
    finally:
        MBConvBlock._forward_unfused = orig
    assert unfused and not any(unfused)  # only e1 and strided blocks ran unfused


# ---------------------------------------------------------------------------
# the supervised trainer and checkpoint files on the card
# ---------------------------------------------------------------------------

TRAIN_F64_TOL = 1e-6   # chip_smoke.py's: float64 card against CPU
TRAIN_F32_TOL = 2e-2   # float32: train-mode BatchNorm over 2 images magnifies


def _train_batch(rng, size):
    images = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    boxes = np.zeros((2, 3, 4), np.float32)
    boxes[0, 0] = (4, 6, size * 0.7, size * 0.5)
    boxes[1, 0] = (size * 0.2, size * 0.3, size * 0.9, size * 0.8)
    boxes[1, 1] = (2, 2, size * 0.4, size * 0.3)
    valid = np.zeros((2, 3), bool)
    valid[0, 0] = valid[1, :2] = True
    return images, (boxes, np.zeros((2, 3), np.int32), valid)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_train_step_on_the_card_matches_the_cpu(cuda, dtype):
    """One trainer step at lite0@128 b2 on the card and on the CPU from the
    same weights and scenes: parameters and statistics per leaf within the
    limit of scale, the loss within it relative."""
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.image_size = 128
    images, gt = _train_batch(np.random.default_rng(0), 128)
    tol = TRAIN_F64_TOL if dtype == "float64" else TRAIN_F32_TOL
    out = {}
    for where in ("cpu", cuda):
        tr = DetectorTrainer(cfg, steps_per_epoch=10, device=where)
        st = tr.init_state(seed=0)
        if dtype == "float64":
            st.net.double()
            st.net.compute_dtype = torch.float64
        st, m = tr.train_step(st, images.astype(dtype), *gt)
        out[str(where)] = (st.net.state_dict(), float(m["loss"]))
    ref, ref_loss = out["cpu"]
    got, loss = out[str(cuda)]
    assert abs(loss - ref_loss) <= tol * abs(ref_loss)
    for k, v in ref.items():
        v = v.double()
        err = float((got[k].cpu().double() - v).abs().max())
        assert err <= tol * max(1.0, float(v.abs().max())), k


def test_training_launches_no_fused_kernel(cuda):
    """A train step on the card takes every block unfused: no fused MBConv
    launch; an eval serve of the trained net launches them again."""
    from mladversarialobjectdetection_torch.models.efficientnet import MBConvBlock
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    cfg = _lite0_cfg()
    tr = DetectorTrainer(cfg, device=cuda)
    st = tr.init_state(seed=1)
    images, gt = _train_batch(np.random.default_rng(1), 64)
    mbconv_cuda.reset_counts()
    calls = []
    orig = MBConvBlock._forward_unfused

    def spy(self, x, *args):
        calls.append(1)
        return orig(self, x, *args)

    MBConvBlock._forward_unfused = spy
    try:
        st, m = tr.train_step(st, images, *gt)
        torch.cuda.synchronize()
    finally:
        MBConvBlock._forward_unfused = orig
    assert sum(mbconv_cuda.LAUNCHES.values()) == 0 and np.isfinite(float(m["loss"]))
    assert len(calls) == len(st.net.spec.backbone.blocks)
    with torch.no_grad():
        tr.eval_variables(st)(torch.as_tensor(images, device=cuda))
    assert mbconv_cuda.LAUNCHES["mbconv_fwd"] == 11


def test_saved_victim_serves_what_the_victim_in_memory_serves(cuda, tmp_path):
    """eval_variables -> torch_to_flax -> save_pytree -> Detector(ckpt_path)
    gives the in-memory victim's detections exactly."""
    from mladversarialobjectdetection_torch.ckpt import bridge
    from mladversarialobjectdetection_torch.ckpt.io import save_pytree
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    cfg = _lite0_cfg()
    tr = DetectorTrainer(cfg, device=cuda)
    st = tr.init_state(seed=2)
    images, gt = _train_batch(np.random.default_rng(2), 64)
    st, _ = tr.train_step(st, images, *gt)
    victim = tr.eval_variables(st)
    path = str(tmp_path / "victim")
    save_pytree(path, bridge.torch_to_flax(victim))
    params = {k: cfg.as_dict()[k] for k in ("image_size", "fpn_num_filters",
                                            "fpn_cell_repeats", "box_class_repeats",
                                            "nms_configs")}
    det_file = Detector("efficientdet-lite0", params=params, device=cuda,
                        ckpt_path=path)
    det_mem = Detector("efficientdet-lite0", params=params, device=cuda)
    det_mem.net = victim
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (48, 80, 3), dtype=np.uint8) for _ in range(3)]
    a, b = det_file.serve(frames), det_mem.serve(frames)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_northstar_epoch_on_card_goes_through_kernels(cuda, tmp_path):
    """One epoch of one step of the north-star loop (examples/northstar_soak.py)
    at lite0@64 on the card, with 1 val batch x 1 draw: the train step (the
    epoch's last, so with the ASR pass) launches each warp kernel once, NMS
    twice, 22 fused forward and 11 dx; the eval the two forward warp
    kernels, NMS twice (detections and ASR) and 22 fused forward."""
    from mladversarialobjectdetection_torch.examples import end_to_end_attack as e2e
    from mladversarialobjectdetection_torch.examples import northstar_soak as ns
    from mladversarialobjectdetection_torch.ops import mbconv_cuda

    class Pool:
        def sample(self, rng, batch):
            imgs, boxes, valid = e2e.synthetic_scene_batch(rng, batch, 64)
            return (torch.from_numpy(imgs).to(cuda), boxes,
                    np.zeros(valid.shape, np.int32), valid)

    cfg = _lite0_cfg()
    victim = get_victim(cfg, seed=0, device=cuda)
    val = [torch.from_numpy(e2e.synthetic_scene_batch(
        np.random.default_rng(777), 2, 64)[0]).to(cuda)]
    warp_cuda.reset_counts()
    mbconv_cuda.reset_counts()
    nms_before = nms_cuda.LAUNCHES
    record = {"config": {}}
    state = ns.epoch_soak(cfg, victim, Pool(), np.random.default_rng(0), val,
                          str(tmp_path), epochs=1, steps_per_epoch=1, batch=2, seed=0,
                          window=320, eot_draws=1, max_hours=10.0, record=record,
                          out_json=str(tmp_path / "northstar.json"), device=cuda)
    torch.cuda.synchronize()
    assert warp_cuda.LAUNCHES == {"pass1_fwd": 2, "pass2_fwd": 2, "pass2_bwd": 1,
                                  "pass1_bwd": 1}
    assert nms_cuda.LAUNCHES - nms_before == 4
    assert mbconv_cuda.LAUNCHES == {"mbconv_fwd": 44, "mbconv_dx": 11}
    (row,) = record["attack_trajectory"]
    assert row["lr"] == state.optimizer.param_groups[0]["lr"] == 1e-2
    assert np.isfinite(row["val_loss"]) and np.isfinite(row["train_asr"])


DEMO_PARAMS = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
               "box_class_repeats": 1,
               "nms_configs": {"pre_nms_topk": 64, "max_output_size": 16}}


def test_demo_detector_nms_at_score_0_on_card(cuda):
    """The demos' detector (gaussian, iou .5, score 0): every candidate
    stays valid and the chain runs all M steps. One kernel launch per
    `infer`, and the kernel equals the plain version on the serve's own
    candidates."""
    from mladversarialobjectdetection_torch.demo import make_demo_detector
    det = make_demo_detector("efficientdet-lite0", detector_params=DEMO_PARAMS,
                             device=cuda)
    frame = np.random.RandomState(5).randint(0, 256, (48, 80, 3)).astype(np.uint8)
    before = nms_cuda.LAUNCHES
    boxes, scores = det.infer(frame)
    assert nms_cuda.LAUNCHES == before + 1 and len(boxes) == len(scores)
    images, _ = det.preprocess([frame])
    with torch.no_grad():
        cls_out, box_out = det.net(torch.from_numpy(images).to(cuda))
        cand_boxes, cand_scores, _ = postprocess._pre_nms_select(
            det._params_dict, cls_out, box_out)
    kw = postprocess.nms_kwargs_from_config(det.config.nms_configs)
    assert kw["score_thresh"] == 0.0 and kw["method"] == "gaussian"
    kern = assert_kernel_equals_plain(cand_boxes.contiguous(),
                                      cand_scores.contiguous(), kw)
    assert bool(kern.valid.all())


def test_recovery_unet_at_b1_on_card_matches_cpu(cuda, tmp_path):
    """`RecoveryDemo.recover` on one 640 px frame: 8 cmconv launches on the
    card (the ConvBlocks of at most 16 filters), and the recovery within
    1e-4 of its scale of the same U-Net on the CPU (plain cmconv; cuDNN's
    convs in float32, TF32 off)."""
    from mladversarialobjectdetection_torch.ckpt import bridge
    from mladversarialobjectdetection_torch.ckpt.io import save_pytree
    from mladversarialobjectdetection_torch.demo import demo_v2, make_demo_detector
    from mladversarialobjectdetection_torch.models.init import init_weights
    from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer
    unet = PatchNeutralizer()
    init_weights(unet, torch.Generator().manual_seed(0))
    path = str(tmp_path / "antipatch")
    save_pytree(path, bridge.torch_to_flax(unet))
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (1, 640, 640, 3)).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = []
        for dev in (torch.device("cpu"), cuda):
            det = make_demo_detector("efficientdet-lite0",
                                     detector_params=DEMO_PARAMS, device=dev)
            rd = demo_v2.RecoveryDemo(path, det, "efficientdet-lite0")
            before = cmconv_cuda.LAUNCHES
            outs.append(rd.recover(x.to(dev)).cpu())
            assert cmconv_cuda.LAUNCHES - before == (8 if dev.type == "cuda" else 0)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert outs[1].shape == (1, 640, 640, 3)
    _close(outs[1], outs[0], "recover", 1e-4)


def test_evaluate_map_on_card_launches_kernels_and_matches_cpu(cuda):
    """`train.evaluate_map` on the card: 11 fused forward and 1 NMS launches
    a batch (lite0), and the COCO metrics of the CPU's evaluation of the
    same net and scenes (NMS at .0099, so the random net detects) within
    1e-3."""
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    from mladversarialobjectdetection_torch.train import train as sup
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    rng = np.random.default_rng(2)
    batches = [_train_batch(rng, 64) for _ in range(2)]
    res = {}
    for where in ("cpu", cuda):
        tr = DetectorTrainer(_lite0_cfg(), device=where)
        st = tr.init_state(seed=3)
        nms_cuda.LAUNCHES = 0
        mbconv_cuda.reset_counts()
        res[str(where)] = sup.evaluate_map(
            tr, st, iter({"images": im, "boxes": b, "classes": c, "valid": v}
                         for im, (b, c, v) in batches), 2, score_thresh=0.0099)
    assert nms_cuda.LAUNCHES == 2 and mbconv_cuda.LAUNCHES["mbconv_fwd"] == 22
    for k, v in res["cpu"].items():
        assert abs(res[str(cuda)][k] - v) <= 1e-3, k


def test_grad_checkpoint_on_card_matches_no_checkpointing(cuda):
    """One lite0 train step with `grad_checkpoint` and without, cuDNN
    deterministic: the parameters and statistics after it bit-equal."""
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    images, gt = _train_batch(np.random.default_rng(4), 64)
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for gc in (False, True):
            cfg = _lite0_cfg()
            cfg.grad_checkpoint = gc
            tr = DetectorTrainer(cfg, device=cuda)
            st, m = tr.train_step(tr.init_state(seed=5), images, *gt)
            out[gc] = (st.net.state_dict(), float(m["loss"]))
    finally:
        torch.backends.cudnn.deterministic = det
    assert out[True][1] == out[False][1]
    for k, v in out[False][0].items():
        assert torch.equal(out[True][0][k], v), k


# (B, C, H, W, Co, k, stride, padding, depthwise): dense 1x1 and 3x3, the
# stem's stride 2, depthwise k3 / k5 at odd sizes, VALID, C not a multiple of
# 4, the pooled [B, C, 1, 1] case; then explicit pads at lite4@640's int8
# convs on a rank's rows under a two-way spatial split, the halo rows in
# place (no row padding) and SAME's columns: the stem, a k3 stride-2 and a
# k5 depthwise; then the tails of the Hopper kernel's tiles: K (C 40 in one
# 64-wide step, 24 channels of it zeros) and M (169 and 432 pixels, off 64)
# tails, Co 700 over many 32-channel tiles and Co 300 over two 160-channel
# tiles, and lite4's b1 level-7 5x5 map (1x1 and depthwise)
CONV_INT8_CASES = [(2, 13, 9, 11, 20, 1, 1, "SAME", False),
                   (1, 3, 64, 64, 32, 3, 2, "SAME", False),
                   (2, 48, 13, 37, 48, 3, 2, "SAME", True),
                   (2, 40, 15, 15, 40, 5, 1, "SAME", True),
                   (2, 16, 9, 9, 24, 3, 1, "VALID", False),
                   (3, 7, 1, 1, 9, 1, 1, "SAME", False),
                   (1, 3, 321, 640, 32, 3, 2, ((0, 0), (0, 1)), False),
                   (2, 144, 81, 160, 144, 3, 2, ((0, 0), (0, 1)), True),
                   (2, 192, 44, 80, 192, 5, 1, ((0, 0), (2, 2)), True),
                   (1, 40, 13, 13, 56, 1, 1, "SAME", False),
                   (3, 40, 12, 12, 24, 1, 1, "SAME", False),
                   (2, 64, 8, 8, 700, 1, 1, "SAME", False),
                   (1, 32, 130, 130, 300, 1, 1, "SAME", False),
                   (1, 224, 5, 5, 224, 1, 1, "SAME", False),
                   (1, 224, 5, 5, 224, 3, 1, "SAME", True)]


@pytest.mark.parametrize("instance", ["sm90", "simt"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_INT8_CASES)
def test_conv_int8_kernel_bit_equal_to_plain(cuda, case, out_dtype, instance):
    """Each int8 conv instance against `conv_int8_plain` on the card: the
    int32 sums and the dequantised output bit-equal (integer sums are exact;
    the epilogue keeps the multiply and the add apart), two launches
    bit-equal; the Hopper instance one launch a call (the SIMT one two), on
    weights packed by the caller or by the wrapper."""
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    b, c, h, w, co, k, s, pad, dw = case
    g = torch.Generator().manual_seed(sum(case[:6]))
    x = (torch.randn((b, c, h, w), generator=g) * 3).to(cuda)
    if out_dtype == "bfloat16":
        x = x.bfloat16()
    wq = torch.randint(-127, 128, (co, 1 if dw else c, k, k), generator=g,
                       dtype=torch.int8).to(cuda)
    a_s = ci.activation_scale(float(x.float().abs().max()))
    scale = torch.from_numpy(ci.dequant_scale(
        a_s, (torch.rand(co, generator=g) * 0.01 + 1e-3).numpy())).to(cuda)
    bias = torch.randn(co, generator=g).to(cuda)
    groups = c if dw else 1
    packed = ci.pack_int8_weights(wq) if instance == "sm90" and not dw else None
    kw = dict(stride=s, padding=pad, groups=groups, out_dtype=getattr(torch, out_dtype))
    ci.reset_counts()
    sums = ci.sums_cuda(x, a_s, wq, stride=s, padding=pad, groups=groups, instance=instance)
    assert torch.equal(sums, ci.sums_plain(ci.quantize_plain(x, a_s), wq, stride=s,
                                           padding=pad, groups=groups))
    y = ci.conv_int8_cuda(x, a_s, wq, scale, bias, instance=instance, packed=packed, **kw)
    per_call = 1 if instance == "sm90" else 2
    assert ci.CALLS == 2 and ci.LAUNCHES == 2 * per_call
    assert ci.INSTANCE_LAUNCHES[instance] == ci.LAUNCHES
    assert torch.equal(y, ci.conv_int8_plain(x, a_s, wq, scale, bias, **kw))
    assert torch.equal(y, ci.conv_int8_cuda(x, a_s, wq, scale, bias, instance=instance,
                                            packed=packed, **kw))
    torch.cuda.synchronize()


def test_int8_serve_on_card_equals_the_plain_route(cuda, monkeypatch):
    """`Detector.quantize_int8` at lite0@64 on the card: NMS once a serve,
    no fused MBConv launch, one int8 launch per quantised conv call, all of
    the Hopper instance, and detections equal to the same detector's on
    `conv_int8_plain`."""
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    det = Detector("efficientdet-lite0", params=DEMO_PARAMS, device=cuda)
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 256, (48, 80, 3)).astype(np.uint8) for _ in range(8)]
    det.quantize_int8(frames)
    n_convs = len(det._int8.qkernels)
    ci.reset_counts()
    mbconv_cuda.reset_counts()
    before = nms_cuda.LAUNCHES
    got = det.serve(frames[:2])
    torch.cuda.synchronize()
    assert nms_cuda.LAUNCHES == before + 1
    assert mbconv_cuda.LAUNCHES["mbconv_fwd"] == 0
    assert ci.CALLS >= n_convs and ci.LAUNCHES == ci.CALLS
    assert ci.INSTANCE_LAUNCHES == {"sm90": ci.CALLS, "simt": 0}
    monkeypatch.setattr(ci, "conv_int8", ci.conv_int8_plain)
    ci.reset_counts()
    want = det.serve(frames[:2])
    assert ci.LAUNCHES == 0
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_export_on_card_runs_the_kernels(cuda, tmp_path):
    """`Detector.export` on the card: the program holds the NMS op once and
    the fused MBConv op once per fuseable block, runs the kernels when it
    runs, and re-serves `Detector.serve` exactly."""
    from mladversarialobjectdetection_torch.inference import drivers
    from mladversarialobjectdetection_torch.inference import export as pexport
    from mladversarialobjectdetection_torch.ops import library, mbconv_cuda
    det = Detector("efficientdet-lite0", params=DEMO_PARAMS, device=cuda)
    frames = np.random.RandomState(4).randint(0, 256, (2, 48, 80, 3)).astype(np.uint8)
    ref = det.serve(frames)
    path = str(tmp_path / "det.pt2")
    det.export(path, batch_size=2)
    counts = library.op_counts(pexport.load_program(path).graph)
    fused = sum(b.fuseable for b in det.net.backbone.children()
                if hasattr(b, "fuseable"))
    assert counts == {"batched_nms": 1, "mbconv_fwd": fused}
    driver = drivers.ExportedProgramDriver(path, "efficientdet-lite0", DEMO_PARAMS)
    mbconv_cuda.reset_counts()
    before = nms_cuda.LAUNCHES
    out = driver.serve(frames)
    assert nms_cuda.LAUNCHES == before + 1
    assert mbconv_cuda.LAUNCHES["mbconv_fwd"] == fused
    for f in out._fields:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f))


# ---------------------------------------------------------------------------
# spatial partitioning over NCCL (two cards)
# ---------------------------------------------------------------------------

SPATIAL_TINY = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
                "box_class_repeats": 1}


def _spatial_nccl_rank(rank, tmp):
    """One of two NCCL ranks, each on its own card, at mesh ('data',
    'spatial') = (1, 2): the halo exchange and the gather with their
    gradients, and the lite0@64 victim's forward and input gradient on this
    rank's 32 rows against the whole image on this card."""
    import os
    from mladversarialobjectdetection_torch import parallel
    from mladversarialobjectdetection_torch.models.efficientdet import (
        EfficientDetNet, spec_from_config)
    from mladversarialobjectdetection_torch.models.init import init_weights
    from mladversarialobjectdetection_torch.parallel import spatial

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 5))).to(dev)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)).to(dev)
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.update(SPATIAL_TINY)
    net = EfficientDetNet(spec_from_config(cfg)).eval()
    init_weights(net, torch.Generator().manual_seed(0))
    net.to(dev)
    for p in net.parameters():
        p.requires_grad_(False)

    def victim(imgs):
        imgs = imgs.clone().requires_grad_(True)
        cls, box = net(imgs)
        spatial.count_once(sum((o * o).sum() for o in cls + box)).backward()
        return [o.detach().cpu() for o in cls + box], imgs.grad.cpu()

    out = {"ref": victim(images)}  # no mesh: the whole image on this card
    mesh = parallel.make_serve_mesh(1, 2, device=dev)
    with parallel.use_mesh(mesh):
        shard = x[:, :, 4 * rank:4 * rank + 4].clone().requires_grad_(True)
        halo = spatial.rows(shard, 4 * rank - 2, 4 * rank + 6, fill=-3.0)
        halo.sum().backward()
        out["halo"] = (halo.detach().cpu(), shard.grad.cpu())
        out["gather"] = spatial.gather_rows(x[:, :, 4 * rank:4 * rank + 4]).cpu()
        out["victim"] = victim(images[:, 32 * rank:32 * rank + 32])
    out["backend"] = torch.distributed.get_backend()
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))


def test_spatial_partitioning_over_nccl(cuda, tmp_path):
    """Two NCCL ranks on two cards (skips with fewer): the halo rows (with
    the fill beyond the image's edges) and their gradients sent back to
    their owners, the gather, and the lite0@64 victim at mesh (1, 2) against
    the whole image on one card (fused MBConv kernels on halo-extended
    shards): head outputs and the input gradient within 2e-4 of scale."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from mladversarialobjectdetection_torch.parallel import launch
    launch.spawn(_spatial_nccl_rank, 2, (str(tmp_path),), backend="nccl",
                 init_method=f"file://{tmp_path}/store", timeout_s=300.0)
    r0, r1 = (torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(2))
    assert r0["backend"] == "nccl"
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 8, 5)))
    pad = torch.full((2, 3, 2, 5), -3.0, dtype=x.dtype)
    assert torch.equal(r0["halo"][0], torch.cat([pad, x[:, :, :6]], 2))
    assert torch.equal(r1["halo"][0], torch.cat([x[:, :, 2:], pad], 2))
    # each row's gradient: 1 from its owner, 1 more where the other rank read it
    reads = torch.ones(8, dtype=x.dtype)
    reads[2:6] += 1
    grad = torch.cat([r0["halo"][1], r1["halo"][1]], 2)
    assert torch.equal(grad, reads.view(1, 1, 8, 1).expand_as(grad))
    assert torch.equal(r0["gather"], x) and torch.equal(r1["gather"], x)
    for rank, r in enumerate((r0, r1)):
        (outs, g), (ref_outs, ref_g) = r["victim"], r["ref"]
        for o, ref in zip(outs, ref_outs):
            scale = max(1.0, float(ref.abs().max()))
            assert float((o - ref).abs().max()) <= 2e-4 * scale
        ref_rows = ref_g[:, 32 * rank:32 * rank + 32]
        assert float((g - ref_rows).abs().max()) <= 2e-4 * max(1.0, float(ref_g.abs().max()))
