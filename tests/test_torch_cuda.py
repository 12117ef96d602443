"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card: it carries the `cuda` marker and
skips, with a reason, where `torch.cuda.is_available()` is false (decided
inside the `cuda` fixture, never at import). The module imports neither JAX
nor the JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: `tests/conftest.py` sets up JAX). The NMS input sets of
`CASES` are also the ones `test_torch_nms.py` holds the plain version to
JAX with. Kernel vs plain: indices, valid, valid_len and boxes exactly
equal, scores within 1e-6.
"""
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.ops import nms as pnms
from mladversarialobjectdetection_torch.ops import nms_cuda, postprocess

pytestmark = pytest.mark.cuda

SCORE_TOL = 1e-6
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
