"""The port's NMS (ops/nms.py, ops/nms_cuda.py) against the JAX package's.

The plain torch version is held against `ops/nms.batched_nms` and against
the Pallas kernel `pallas_nms.batched_nms_pallas` in interpret mode, on the
same numpy inputs: indices, valid and valid_len exact, scores within 1e-6,
boxes within 1e-6. The input sets are `test_torch_cuda.CASES` (NaN scores,
an early exit and an all-valid chain among them), with which the CUDA
kernel is held against the plain version where a card is present. The
invariant that the kernel's early exit rests on is checked on the plain
version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.ops import nms as jnms
from mladversarialobjectdetection_tpu.ops import pallas_nms
from mladversarialobjectdetection_torch.ops import nms as pnms
from mladversarialobjectdetection_torch.ops import nms_cuda
from test_torch_cuda import CASES, GAUSS, HARD, IDS, SCORE_TOL
from test_torch_cuda import random_boxes as _boxes


def _assert_same(ref, out):
    np.testing.assert_array_equal(np.asarray(ref.indices), np.asarray(out.indices))
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(out.valid))
    np.testing.assert_array_equal(np.asarray(ref.valid_len),
                                  np.asarray(out.valid_len))
    np.testing.assert_allclose(np.asarray(out.scores), np.asarray(ref.scores),
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(np.asarray(out.boxes), np.asarray(ref.boxes),
                               rtol=0, atol=1e-6)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name,boxes,scores,kw", CASES, ids=IDS)
def test_plain_matches_jax(name, boxes, scores, kw):
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    out = pnms.batched_nms(*_torch(boxes, scores), **kw)
    _assert_same(ref, out)
    assert out.indices.dtype == torch.int32 and out.valid.dtype == torch.bool
    assert out.valid_len.dtype == torch.int32


@pytest.mark.parametrize("kw", [HARD, GAUSS], ids=["hard", "gaussian"])
def test_plain_matches_pallas_interpret(kw):
    rng = np.random.RandomState(1)
    boxes, scores = _boxes(rng, 2, 128), rng.uniform(0.05, 1, (2, 128)).astype(np.float32)
    old = pallas_nms._INTERPRET
    pallas_nms._INTERPRET = True
    try:
        ref = pallas_nms.batched_nms_pallas(jnp.asarray(boxes),
                                            jnp.asarray(scores), **kw)
    finally:
        pallas_nms._INTERPRET = old
    _assert_same(ref, pnms.batched_nms(*_torch(boxes, scores), **kw))


@pytest.mark.parametrize("name,boxes,scores,kw", CASES, ids=IDS)
def test_plain_early_exit_invariant(monkeypatch, name, boxes, scores, kw):
    """What csrc/nms.cu's early exit rests on: after the first step whose
    winner is invalid and not NaN, every later winner is invalid and every
    later row is the pad row (index 0, score 0, not valid, boxes[0] * 0)."""
    winners = []
    argmax = torch.argmax

    def spy(live, dim):
        best = argmax(live, dim=dim)
        winners.append(live.gather(1, best[:, None])[:, 0].clone())
        return best

    monkeypatch.setattr(torch, "argmax", spy)
    out = pnms.batched_nms(*_torch(boxes, scores), **kw)
    monkeypatch.undo()
    method = kw.get("method", "gaussian")
    _, _, score_t = pnms.nms_thresholds(method, kw.get("iou_thresh"),
                                        kw.get("score_thresh"), kw.get("sigma"))
    win = torch.stack(winners, 1)  # [B, M] the live score of each winner
    ok = (win >= score_t) & (win > 0.5 * pnms.NEG_INF)
    assert torch.equal(ok, out.valid)
    m = win.shape[1]
    exits = 0
    for b in range(win.shape[0]):
        stops = [i for i in range(m) if not ok[b, i] and not torch.isnan(win[b, i])]
        if not stops:
            continue
        s, exits = stops[0], exits + 1
        assert not ok[b, s:].any()
        assert not out.indices[b, s:].any() and not out.scores[b, s:].any()
        pad = torch.from_numpy(boxes[b, 0]) * 0.0
        assert torch.equal(out.boxes[b, s:], pad.expand(m - s, 4))
    if name.startswith(("early_exit", "exhausted", "identical")):
        assert exits == win.shape[0], f"{name}: no early exit in some image"


def test_iou_matches_jax():
    rng = np.random.RandomState(2)
    a, b = _boxes(rng, 1, 7)[0], _boxes(rng, 1, 9)[0]
    a[0, 2] = a[0, 0]  # a zero-area box
    np.testing.assert_allclose(pnms.iou(*_torch(a, b)).numpy(),
                               np.asarray(jnms.iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-7)


def test_nms_padded_matches_jax():
    boxes, scores = CASES[1][1][0], CASES[1][2][0]
    ref = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), **GAUSS)
    _assert_same(ref, pnms.nms_padded(*_torch(boxes, scores), **GAUSS))


def test_thresholds_defaulting():
    neg = float(np.float32(pnms.NEG_INF))
    assert pnms.nms_thresholds("hard", None, None, None) == (0.0, 0.5, neg)
    assert pnms.nms_thresholds("hard", 0.0, 0.0, None) == (0.0, 0.5, neg)
    assert pnms.nms_thresholds("gaussian", 0.3, 0.0, None) == (
        0.5, 1.0, float(np.float32(0.001)))
    with pytest.raises(ValueError):
        pnms.nms_thresholds("linear", None, None, None)


def test_auto_runs_plain_on_cpu():
    _, boxes, scores, kw = CASES[1]
    before = nms_cuda.LAUNCHES
    auto = pnms.batched_nms_auto(*_torch(boxes, scores), **kw)
    _assert_same(pnms.batched_nms(*_torch(boxes, scores), **kw), auto)
    assert nms_cuda.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    _, boxes, scores, kw = CASES[0]
    before = nms_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        nms_cuda.batched_nms_cuda(*_torch(boxes, scores), **kw)
    assert nms_cuda.LAUNCHES == before
