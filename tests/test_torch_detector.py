"""The port's `Detector.serve` against the JAX package's, end to end on the CPU.

A tiny JAX lite0 detector's variables go through the bridge into the port's
`Detector(..., device="cpu")`, and both serve the same three raw uint8
frames of different sizes. The score threshold leaves some output slots
valid and some not (random init puts every score near 0.01, by the class
head bias). Host preprocessing must be exactly equal; Detections: valid and
classes exact, boxes within 1e-3 px, scores within 1e-5.
"""
import os

import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
from mladversarialobjectdetection_tpu.ops import preprocess as jpre
from mladversarialobjectdetection_torch import parallel
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.ops import nms_cuda
from mladversarialobjectdetection_torch.ops import preprocess as ppre

PARAMS = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
          "box_class_repeats": 1,
          "nms_configs": {"method": "gaussian", "score_thresh": 0.0099,
                          "pre_nms_topk": 64, "max_output_size": 16}}


@pytest.fixture(scope="module")
def detectors():
    jdet = JDetector(model_name="efficientdet-lite0", params=PARAMS, seed=0)
    pdet = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    pdet.load_flax_variables(jdet.variables)
    return jdet, pdet


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
            for hw in [(48, 80), (64, 64), (100, 30)]]


def test_preprocess_host_exact(frames):
    for frame in frames:
        ref_img, ref_scale = jpre.preprocess_host(frame, 64, 127.0, 128.0)
        img, scale = ppre.preprocess_host(frame, 64, 127.0, 128.0)
        assert img.dtype == ref_img.dtype and np.array_equal(img, ref_img)
        assert scale == ref_scale


def test_serve_matches_jax(detectors, frames):
    jdet, pdet = detectors
    before = nms_cuda.LAUNCHES
    ref, out = jdet.serve(frames), pdet.serve(frames)
    assert nms_cuda.LAUNCHES == before  # the CPU path never reaches the kernel
    valid = np.asarray(ref.valid)
    assert valid.any() and not valid.all()
    for field in ("boxes", "scores", "classes", "valid", "valid_len"):
        assert getattr(out, field).shape == np.asarray(getattr(ref, field)).shape
    np.testing.assert_array_equal(out.valid, valid)
    np.testing.assert_array_equal(out.valid_len, np.asarray(ref.valid_len))
    np.testing.assert_array_equal(out.classes, np.asarray(ref.classes))
    np.testing.assert_allclose(out.boxes, np.asarray(ref.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(out.scores, np.asarray(ref.scores), rtol=0, atol=1e-5)


def test_infer_matches_jax(detectors, frames):
    jdet, pdet = detectors
    ref_boxes, ref_scores = jdet.infer(frames[0])
    boxes, scores = pdet.infer(frames[0])
    assert len(boxes) == len(ref_boxes)
    np.testing.assert_allclose(np.asarray(boxes).reshape(-1, 4),
                               np.asarray(ref_boxes).reshape(-1, 4), atol=1e-3)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-5)


def test_weights_loaded_through_bridge(detectors):
    jdet, pdet = detectors
    kernel = np.asarray(jdet.variables["params"]["backbone"]["stem_conv"]["kernel"])
    weight = pdet.net.backbone.stem_conv.weight.detach().numpy()
    assert np.array_equal(weight, kernel.transpose(3, 2, 0, 1))


def test_unported_post_modes_raise():
    """Every post mode of the JAX package is ported; an unknown one raises,
    and so do the serving options not ported yet."""
    with pytest.raises(ValueError, match="post_mode"):
        Detector("efficientdet-lite0", params=PARAMS, device="cpu",
                 post_mode="per_anchor")
    # a mesh is ported (tests/test_torch_parallel.py), a spatial axis too
    # (tests/test_torch_spatial.py), and under one the packed entry and the
    # int8 serve (across ranks: tests/test_torch_spatial_rest.py); without a
    # process group the mesh's collectives are the identity, so each serves
    # as the detector without a mesh
    spatial = parallel.Mesh(np.arange(2).reshape(1, 2), ("data", "spatial"),
                            device="cpu")
    frame = [np.random.default_rng(1).integers(0, 256, (48, 80, 3), dtype=np.uint8)]
    got = Detector("efficientdet-lite0", params=PARAMS, device="cpu", mesh=spatial,
                   packed_entry=2).serve(frame)
    want = Detector("efficientdet-lite0", params=PARAMS, device="cpu",
                    packed_entry=2).serve(frame)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    meshed = Detector("efficientdet-lite0", params=PARAMS, device="cpu", mesh=spatial)
    plain = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    for det in (meshed, plain):
        det.quantize_int8(frame * 2)
    assert meshed._int8.act_scales == plain._int8.act_scales
    for a, b in zip(meshed.serve(frame), plain.serve(frame)):
        assert np.array_equal(a, b)
    # a directory is read as an orbax checkpoint (ported), and refused without
    # orbax's metadata; packed_entry is ported (tests/test_torch_efficientnet_packed.py)
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        Detector("efficientdet-lite0", params=PARAMS, device="cpu",
                 ckpt_path=os.path.dirname(__file__))
    packed = Detector("efficientdet-lite0", params=PARAMS, device="cpu", packed_entry=2)
    assert packed.net.backbone.packed_blocks == 2
    # export and quantize are ported; writing a TF file is what stays behind
    det = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    for fmt in ("saved_model", "tflite"):
        with pytest.raises(NotImplementedError, match="jax2tf"):
            det.export(os.path.join(os.path.dirname(__file__), "unwritten"), fmt=fmt)


def test_seeded_detectors_repeat():
    a = Detector("efficientdet-lite0", params=PARAMS, seed=3, device="cpu")
    b = Detector("efficientdet-lite0", params=PARAMS, seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.net.state_dict().items(),
                                  b.net.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
