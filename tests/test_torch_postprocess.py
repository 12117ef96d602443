"""The port's anchors and global postprocess against the JAX package's.

Same numpy head outputs go through `ops/postprocess` of both packages:
anchors bit-equal, box decode within 1e-5, the top-k candidate order exact
(also under deliberately tied scores, where `jax.lax.top_k` puts the lower
index first), and `postprocess_global` with valid, valid_len and classes
exact, boxes within 1e-3 px and scores within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from mladversarialobjectdetection_tpu import config as jconfig
from mladversarialobjectdetection_tpu.ops import anchors as janchors
from mladversarialobjectdetection_tpu.ops import postprocess as jpost
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.ops import anchors as panchors
from mladversarialobjectdetection_torch.ops import postprocess as ppost


def _params(**nms):
    cfg = tiny_config()
    cfg.nms_configs.update(nms)
    return cfg.as_dict()


def _head_outputs(params, rng, batch=2, values=None):
    """Per-level NHWC (class, box) outputs as numpy, in the JAX layout."""
    sizes = [params["image_size"] // 2 ** lv
             for lv in range(params["min_level"], params["max_level"] + 1)]
    a = params["num_scales"] * len(params["aspect_ratios"])
    c = params["num_classes"]
    cls, box = [], []
    for s in sizes:
        s = max(s, 1)
        if values is None:
            cls.append(rng.normal(-3, 1, (batch, s, s, a * c)).astype(np.float32))
        else:
            cls.append(rng.choice(values, (batch, s, s, a * c)).astype(np.float32))
        box.append(rng.normal(0, 0.3, (batch, s, s, a * 4)).astype(np.float32))
    return cls, box


@pytest.mark.parametrize("model,image_size", [
    ("efficientdet-lite4", 640), ("efficientdet-lite0", 64),
    ("efficientdet-lite0", 96), ("efficientdet-d0", 512)])
def test_anchors_bit_equal(model, image_size):
    jcfg = jconfig.get_efficientdet_config(model)
    jcfg.image_size = image_size
    pcfg = pconfig.get_efficientdet_config(model)
    pcfg.image_size = image_size
    ref = janchors.Anchors.from_config(jcfg).boxes
    out = panchors.Anchors.from_config(pcfg).boxes
    assert out.dtype == ref.dtype and np.array_equal(out, ref)
    if (model, image_size) == ("efficientdet-lite4", 640):
        assert out.shape == (76725, 4)


def test_decode_box_outputs():
    rng = np.random.RandomState(0)
    pred = rng.normal(0, 0.5, (2, 50, 4)).astype(np.float32)
    anchors = np.sort(rng.uniform(0, 640, (50, 4)).astype(np.float32), axis=-1)
    ref = np.asarray(janchors.decode_box_outputs(jnp.asarray(pred),
                                                 jnp.asarray(anchors)[None]))
    out = panchors.decode_box_outputs(torch.from_numpy(pred),
                                      torch.from_numpy(anchors)[None]).numpy()
    # 1e-5 of the box scale: exp differs by an ulp between XLA and ATen,
    # which is 3e-5 on a 640 px box
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_pre_nms_matches_jax():
    params = _params()
    cls, box = _head_outputs(params, np.random.RandomState(1))
    ref = jpost.pre_nms(params, [jnp.asarray(c) for c in cls],
                        [jnp.asarray(b) for b in box])
    out = ppost.pre_nms(params, [torch.from_numpy(c) for c in cls],
                        [torch.from_numpy(b) for b in box])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


def test_top_k_stable_tie_order():
    scores = np.asarray([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.9]], np.float32)
    vals, idx = ppost.top_k_stable(torch.from_numpy(scores), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(scores), 5)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 3, 6, 0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_pre_nms_select_candidate_order(tied):
    params = _params(pre_nms_topk=64)
    rng = np.random.RandomState(2)
    values = np.asarray([-4.0, -1.5, 0.25, 1.0], np.float32) if tied else None
    cls, box = _head_outputs(params, rng, values=values)
    ref = jpost._pre_nms_select(params, [jnp.asarray(c) for c in cls],
                                [jnp.asarray(b) for b in box])
    out = ppost._pre_nms_select(params, [torch.from_numpy(c) for c in cls],
                                [torch.from_numpy(b) for b in box])
    if tied:  # the top 64 must hold equal scores for the order to matter
        assert len(np.unique(np.asarray(ref[1]))) < np.asarray(ref[1]).size // 2
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-3)


@pytest.mark.parametrize("approx", [True, 0.9], ids=["recall_default", "recall_0.9"])
def test_pre_nms_approx_topk_raises(approx):
    """`pre_nms_approx_topk` no longer raises: the port's exact top-k picks
    the candidates that JAX's `lax.approx_max_k` picks off the TPU, in the
    same order, ties included."""
    params = _params(pre_nms_approx_topk=approx, pre_nms_topk=64)
    values = np.asarray([-4.0, -1.5, 0.25, 1.0], np.float32)
    cls, box = _head_outputs(params, np.random.RandomState(3), values=values)
    ref = jpost._pre_nms_select(params, [jnp.asarray(c) for c in cls],
                                [jnp.asarray(b) for b in box])
    out = ppost._pre_nms_select(params, [torch.from_numpy(c) for c in cls],
                                [torch.from_numpy(b) for b in box])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-3)


@pytest.mark.parametrize("nms", [
    dict(method="gaussian", score_thresh=0.5),
    dict(method="hard", iou_thresh=0.5, score_thresh=0.65)],
    ids=["gaussian", "hard"])
def test_postprocess_global_matches_jax(nms):
    params = _params(**nms)
    cls, box = _head_outputs(params, np.random.RandomState(4))
    scales = np.asarray([1.5, 0.75], np.float32)
    ref = jpost.postprocess_global(params, [jnp.asarray(c) for c in cls],
                                   [jnp.asarray(b) for b in box],
                                   image_scales=jnp.asarray(scales))
    out = ppost.postprocess_global(params, [torch.from_numpy(c) for c in cls],
                                   [torch.from_numpy(b) for b in box],
                                   image_scales=torch.from_numpy(scales))
    valid = np.asarray(ref.valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    np.testing.assert_array_equal(out.valid_len.numpy(), np.asarray(ref.valid_len))
    np.testing.assert_array_equal(out.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               rtol=0, atol=1e-6)


def test_clip_boxes_and_nms_kwargs():
    boxes = np.asarray([[[-5, 10, 70, 30], [1, -2, 3, 99]]], np.float32)
    np.testing.assert_array_equal(
        ppost.clip_boxes(torch.from_numpy(boxes), 64).numpy(),
        np.asarray(jpost.clip_boxes(jnp.asarray(boxes), 64)))
    cfg = tiny_config().nms_configs
    assert ppost.nms_kwargs_from_config(cfg) == jpost.nms_kwargs_from_config(cfg)
