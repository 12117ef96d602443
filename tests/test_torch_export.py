"""The port's export and artifact drivers (`inference/{export,drivers}.py`,
`Detector.export`, `train/eval.py`'s `artifact=`) against the JAX
package's, on the CPU.

- `export_program` / `load_program` round-trip a function (JAX's
  test_stablehlo_roundtrip: within 1e-6).
- `Detector.export` -> `ExportedProgramDriver.serve` equals `Detector.serve`
  on a tiny lite0 (boxes within 1e-4, scores within 1e-5, the rest exact, as
  JAX's test_stablehlo_detector; on the CPU it is bit-equal), with the NMS
  op once and the fused MBConv op once per fuseable block in the graph.
- The port's driver against JAX's `StableHloDriver` serving JAX's export of
  the same weights: valid, valid_len and classes exact, boxes within 1e-3
  px, scores within 1e-5 (tests/test_torch_serving.py's tolerances).
- `saved_model`, `tflite` and `stablehlo` raise as specified.
- `eval.evaluate(artifact=...)` equals the live model's metrics within 1e-6
  over TFRecords the test writes (`create_coco_tfrecord.write_records`).
- The port's `SavedModelDriver` and `TfliteDriver` against JAX's on a
  SavedModel and a TFLite file JAX wrote (jax2tf): equal outputs, the
  TFLite int8 3-output layout finished by the port's plain NMS within 1e-5.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.inference import drivers as jdrivers
from mladversarialobjectdetection_tpu.inference import export as jexport
from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
from mladversarialobjectdetection_torch.data import create_coco_tfrecord as pcoco
from mladversarialobjectdetection_torch.inference import drivers as pdrivers
from mladversarialobjectdetection_torch.inference import export as pexport
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.ops import library
from mladversarialobjectdetection_torch.train import eval as peval

TINY = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
        "box_class_repeats": 1,
        "nms_configs": {"score_thresh": 0.0099, "pre_nms_topk": 64,
                        "max_output_size": 8}}
LITE0_FUSED = 11  # lite0's fuseable blocks: all but 0 (e1), 1, 3, 5, 11 (s2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(seed=5, n=2):
    return np.random.RandomState(seed).uniform(0, 255, (n, 80, 100, 3)).astype(np.uint8)


def _assert_same(out, ref, box_atol, score_atol):
    for f in ("valid", "valid_len", "classes"):
        np.testing.assert_array_equal(np.asarray(getattr(out, f)), np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(np.asarray(out.boxes), np.asarray(ref.boxes), rtol=0,
                               atol=box_atol)
    np.testing.assert_allclose(np.asarray(out.scores), np.asarray(ref.scores), rtol=0,
                               atol=score_atol)


@pytest.fixture(scope="module")
def detectors():
    """A JAX detector and the port's with its weights."""
    jdet = JDetector(model_name="efficientdet-lite0", params=TINY, seed=0)
    pdet = Detector("efficientdet-lite0", params=TINY, device="cpu")
    pdet.load_flax_variables(jdet.variables)
    return jdet, pdet


def test_export_program_roundtrip(tmp_path):
    class Fn(torch.nn.Module):
        def forward(self, x):
            return torch.tanh(x) * 2.0

    x = torch.ones((2, 4))
    path = str(tmp_path / "fn.pt2")
    pexport.export_program(Fn(), (x,), path)
    out = pexport.load_program(path).module()(x)
    np.testing.assert_allclose(out.numpy(), np.tanh(x.numpy()) * 2.0, atol=1e-6)


def test_detector_export_reserves_serve(detectors, tmp_path):
    _, pdet = detectors
    raw = _raw()
    ref = pdet.serve(raw)
    path = str(tmp_path / "det.pt2")
    pdet.export(path, batch_size=2)
    program = pexport.load_program(path)
    assert library.op_counts(program.graph) == {"batched_nms": 1,
                                                "mbconv_fwd": LITE0_FUSED}
    driver = pdrivers.ExportedProgramDriver(path, "efficientdet-lite0", TINY,
                                            device="cpu")
    out = driver.serve(raw)
    assert out.valid.any()
    _assert_same(out, ref, box_atol=1e-4, score_atol=1e-5)
    for f in out._fields:  # one route on one device: bit-equal
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f))


def test_driver_matches_jax_stablehlo_driver(detectors, tmp_path):
    jdet, pdet = detectors
    raw = _raw(7)
    jpath, ppath = str(tmp_path / "det.stablehlo"), str(tmp_path / "det.pt2")
    jdet.export(jpath, fmt="stablehlo", batch_size=2)
    pdet.export(ppath, batch_size=2)
    want = jdrivers.StableHloDriver(jpath, "efficientdet-lite0", TINY).serve(raw)
    got = pdrivers.ExportedProgramDriver(ppath, "efficientdet-lite0", TINY,
                                         device="cpu").serve(raw)
    assert np.asarray(want.valid).any()
    _assert_same(got, want, box_atol=1e-3, score_atol=1e-5)


def test_export_formats_that_raise(detectors, tmp_path):
    _, pdet = detectors
    with pytest.raises(ValueError, match="exported_program"):
        pdet.export(str(tmp_path / "x"), fmt="stablehlo")
    for fmt in ("saved_model", "tflite"):
        with pytest.raises(NotImplementedError, match="jax2tf"):
            pdet.export(str(tmp_path / "x"), fmt=fmt)
    with pytest.raises(ValueError, match="unknown"):
        pdet.export(str(tmp_path / "x"), fmt="onnx")
    with pytest.raises(NotImplementedError, match="jax2tf"):
        pexport.export_saved_model(None, (), str(tmp_path / "sm"))
    with pytest.raises(NotImplementedError, match="jax2tf"):
        pexport.export_tflite(str(tmp_path / "sm"), str(tmp_path / "x.tflite"))


def _records(det, path, n=4):
    """Records whose ground truth is `det`'s top box, with its class, and a
    corner box."""
    from PIL import Image

    rng = np.random.default_rng(0)
    scenes = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]
    top = det.serve(scenes)
    recs = []
    for i, img in enumerate(scenes):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        boxes = np.concatenate([top.boxes[i][:1] / 64.0, [[0.0, 0.0, 0.3, 0.3]]])
        cls = int(top.classes[i][0])
        recs.append(pcoco.make_example(buf.getvalue(), 64, 64, boxes, [cls, cls], [0, 0],
                                       str(i)))
    pcoco.write_records(recs, path)


def test_eval_artifact_matches_live_model(tmp_path):
    hparams = ("fpn_num_filters=16,fpn_cell_repeats=1,box_class_repeats=1,"
               "nms_configs.score_thresh=0.0099,nms_configs.max_output_size=8,"
               "nms_configs.pre_nms_topk=64")
    kw = dict(batch_size=2, hparams=hparams, image_size=64, device="cpu")
    live_det = Detector("efficientdet-lite0", params=dict(TINY), device="cpu",
                        post_mode="per_class")
    val = str(tmp_path / "val.tfrecord")
    _records(live_det, val)
    live = peval.evaluate("efficientdet-lite0", val, **kw)
    artifact = str(tmp_path / "model.pt2")
    live_det.export(artifact, batch_size=2)
    arte = peval.evaluate("efficientdet-lite0", val, artifact=artifact, **kw)
    assert live["AP"] > 0
    assert set(arte) == set(live)
    for k in live:
        assert arte[k] == pytest.approx(live[k], abs=1e-6), k


@pytest.fixture(scope="module")
def tf_artifacts(detectors, tmp_path_factory):
    """A SavedModel and an fp32 and an int8 TFLite file of the JAX detector,
    written by JAX (jax2tf)."""
    pytest.importorskip("tensorflow")
    jdet, _ = detectors
    root = tmp_path_factory.mktemp("tf")
    sm = str(root / "saved_model")
    fn = lambda images, scales: tuple(jdet._serve_float_impl(images, scales))  # noqa: E731
    example = (np.zeros((2, 64, 64, 3), np.float32), np.ones((2,), np.float32))
    jexport.export_saved_model(fn, example, sm)
    fp32 = str(root / "det.tflite")
    jexport.export_tflite(sm, fp32)
    return sm, fp32


def test_saved_model_driver_matches_jax(tf_artifacts):
    sm, _ = tf_artifacts
    raw = _raw(9)
    want = jdrivers.SavedModelDriver(sm, "efficientdet-lite0", TINY).serve(raw)
    got = pdrivers.SavedModelDriver(sm, "efficientdet-lite0", TINY).serve(raw)
    assert np.asarray(want.valid).any()
    for f in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def test_tflite_driver_matches_jax(tf_artifacts):
    _, fp32 = tf_artifacts
    raw = _raw(9)
    want = jdrivers.TfliteDriver(fp32, "efficientdet-lite0", TINY).serve(raw)
    got = pdrivers.TfliteDriver(fp32, "efficientdet-lite0", TINY).serve(raw)
    for f in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def test_tflite_int8_layout_matches_jax(detectors, tmp_path):
    """The int8 3-output layout (box encodings, scores, anchors) finished by
    the port's NMS against JAX's (the same pre-NMS numbers fed to both)."""
    from mladversarialobjectdetection_tpu.ops import postprocess as jpost
    from mladversarialobjectdetection_torch.ops import postprocess as ppost

    _, pdet = detectors
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        cls_out, box_out = pdet.net(torch.from_numpy(x))
    pre = [np.array(t) for t in jpost.tflite_pre_nms(
        pdet._params_dict, [jnp.asarray(c.numpy()) for c in cls_out],
        [jnp.asarray(b.numpy()) for b in box_out])]
    want = jpost.tflite_detections_from_pre(pdet._params_dict, *map(jnp.asarray, pre))
    got = ppost.tflite_detections_from_pre(pdet._params_dict, *map(torch.from_numpy, pre))
    _assert_same(got, want, box_atol=1e-5, score_atol=1e-5)
