"""The rest of the port's serving against the JAX package's, on the CPU.

- The post modes `per_class`, `combined` and `tflite` on the same numpy head
  outputs, with exact and "approximate" pre-NMS top-k: valid, valid_len and
  classes exact, boxes within 1e-5 of their scale, scores within 1e-6.
- `preprocess_device` against `preprocess_jax` (vmapped), downscaling and
  upscaling: within 1e-5 (the resize weights are computed in float64 and
  rounded in the port, in float32 by `jax.image.resize`).
- A tiny lite0 `Detector` of each package (the JAX variables through the
  bridge): `serve` in each post mode and with `device_preprocess`,
  `serve_streams` over three in-memory sources of unequal length, and
  `serve_pipelined` with a partial last batch, host and device preprocess:
  valid, valid_len and classes exact, boxes within 1e-3 px, scores within
  1e-5 (the tolerances of tests/test_torch_detector.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
from mladversarialobjectdetection_tpu.ops import postprocess as jpost
from mladversarialobjectdetection_tpu.ops import preprocess as jpre
from mladversarialobjectdetection_torch.inference import streaming as pstreaming
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.ops import postprocess as ppost
from mladversarialobjectdetection_torch.ops import preprocess as ppre

PARAMS = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
          "box_class_repeats": 1,
          "nms_configs": {"method": "gaussian", "score_thresh": 0.0099,
                          "pre_nms_topk": 64, "max_output_size": 16}}
MODES = ("per_class", "combined", "tflite")
# score thresholds that leave some of the 16 output slots of each mode empty
MODE_THRESH = {"per_class": 0.8, "combined": 0.75, "tflite": 0.3}


def _head_outputs(params, rng, batch=2):
    """Per-level NHWC (class, box) outputs as numpy, in the JAX layout."""
    a = params["num_scales"] * len(params["aspect_ratios"])
    cls, box = [], []
    for lv in range(params["min_level"], params["max_level"] + 1):
        s = max(params["image_size"] // 2 ** lv, 1)
        cls.append(rng.normal(-3, 1, (batch, s, s, a * params["num_classes"])
                              ).astype(np.float32))
        box.append(rng.normal(0, 0.3, (batch, s, s, a * 4)).astype(np.float32))
    return cls, box


def _post(module, mode):
    return {"per_class": module.postprocess_per_class,
            "combined": module.postprocess_combined,
            "tflite": module.postprocess_tflite}[mode]


def _assert_detections(out, ref, box_atol, score_atol=1e-6):
    valid = np.asarray(ref.valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(np.asarray(out.valid), valid)
    np.testing.assert_array_equal(np.asarray(out.valid_len), np.asarray(ref.valid_len))
    np.testing.assert_array_equal(np.asarray(out.classes), np.asarray(ref.classes))
    np.testing.assert_allclose(np.asarray(out.boxes), np.asarray(ref.boxes),
                               rtol=0, atol=box_atol)
    np.testing.assert_allclose(np.asarray(out.scores), np.asarray(ref.scores),
                               rtol=0, atol=score_atol)


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("mode", MODES)
def test_post_mode_matches_jax(mode, approx):
    cfg = tiny_config()
    cfg.nms_configs.update({"method": "hard", "iou_thresh": 0.5,
                            "score_thresh": MODE_THRESH[mode],
                            "pre_nms_approx_topk": approx})
    params = cfg.as_dict()
    cls, box = _head_outputs(params, np.random.RandomState(11))
    jargs = ([jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box])
    pargs = ([torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box])
    if mode == "tflite":
        ref, out = _post(jpost, mode)(params, *jargs), _post(ppost, mode)(params, *pargs)
    else:
        scales = np.asarray([1.5, 0.75], np.float32)
        ref = _post(jpost, mode)(params, *jargs, image_scales=jnp.asarray(scales))
        out = _post(ppost, mode)(params, *pargs, image_scales=torch.from_numpy(scales))
    _assert_detections(out, ref, 1e-5 * max(1.0, float(np.abs(ref.boxes).max())))


def test_tflite_pre_nms_matches_jax():
    params = tiny_config().as_dict()
    cls, box = _head_outputs(params, np.random.RandomState(12))
    ref = jpost.tflite_pre_nms(params, [jnp.asarray(c) for c in cls],
                               [jnp.asarray(b) for b in box])
    out = ppost.tflite_pre_nms(params, [torch.from_numpy(c) for c in cls],
                               [torch.from_numpy(b) for b in box])
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    boxes, scores = ppost.pre_nms_multiclass(
        params, [torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box])
    jboxes, jscores = jpost.pre_nms_multiclass(
        params, [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box])
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(48, 80), (100, 30), (30, 40)],
                         ids=["48x80", "100x30", "upscale_30x40"])
def test_preprocess_device_matches_jax(hw):
    frames = np.random.RandomState(13).randint(0, 256, (3, *hw, 3)).astype(np.uint8)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    ref_img, ref_scale = jax.vmap(
        lambda im: jpre.preprocess_jax(im, 64, mean, std))(jnp.asarray(frames))
    img, scale = ppre.preprocess_device(torch.from_numpy(frames), 64, mean, std)
    assert img.shape == ref_img.shape and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))


@pytest.fixture(scope="module")
def pair():
    """(JAX Detector, port Detector with the same weights), global mode."""
    jdet = JDetector(model_name="efficientdet-lite0", params=PARAMS, seed=0)
    pdet = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    pdet.load_flax_variables(jdet.variables)
    return jdet, pdet


def _frames(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in shapes]


def _close(out, ref):
    """Detections of one frame or a batch, within test_torch_detector's bounds."""
    for field in ("valid", "valid_len", "classes"):
        np.testing.assert_array_equal(np.asarray(getattr(out, field)),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    np.testing.assert_allclose(np.asarray(out.boxes), np.asarray(ref.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.scores), np.asarray(ref.scores),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_serve_post_modes_match_jax(pair, mode):
    jdet, _ = pair
    jmode = JDetector(model_name="efficientdet-lite0", params=PARAMS, seed=0,
                      post_mode=mode)
    pdet = Detector("efficientdet-lite0", params=PARAMS, device="cpu",
                    post_mode=mode)
    pdet.load_flax_variables(jdet.variables)
    frames = _frames(14, [(48, 80), (64, 64), (100, 30)])
    ref, out = jmode.serve(frames), pdet.serve(frames)
    assert np.asarray(ref.valid).any()
    _close(out, ref)


def test_serve_device_preprocess_matches_jax(pair):
    jdet, pdet = pair
    frames = _frames(15, [(48, 80)] * 3)
    ref = jdet.serve(frames, device_preprocess=True)
    out = pdet.serve(frames, device_preprocess=True)
    assert np.asarray(ref.valid).any()
    _close(out, ref)
    with pytest.raises(ValueError, match="uint8"):
        pdet.serve([f.astype(np.float32) for f in frames], device_preprocess=True)


class _Source:
    """An in-memory frame source: what `MultiStream` asks of a `Stream`."""

    def __init__(self, frames):
        self.frames = frames

    def play(self):
        yield from self.frames


def test_serve_streams_matches_jax(pair):
    jdet, pdet = pair
    sources = [_frames(16, [(48, 80), (48, 80)]), _frames(17, [(64, 64)] * 3),
               _frames(18, [(100, 30)])]
    ref = list(jdet.serve_streams([_Source(s) for s in sources]))
    out = list(pdet.serve_streams([_Source(s) for s in sources]))
    assert len(out) == len(ref) == 3
    for tick_out, tick_ref in zip(out, ref):
        assert [o is None for o in tick_out] == [r is None for r in tick_ref]
        for o, r in zip(tick_out, tick_ref):
            if r is not None:
                _close(o, r)
    assert [o is None for o in out[2]] == [True, False, True]


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["host", "device"])
def test_serve_pipelined_matches_jax(pair, device_preprocess):
    jdet, pdet = pair
    frames = _frames(19, [(48, 80)] * 5)  # batches of 2: the last is partial
    ref = list(jdet.serve_pipelined(iter(frames), batch_size=2,
                                    device_preprocess=device_preprocess))
    out = list(pdet.serve_pipelined(iter(frames), batch_size=2,
                                    device_preprocess=device_preprocess))
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        _close(o, r)
    with pytest.raises(ValueError, match="None"):
        list(pdet.serve_pipelined(iter([frames[0], None]), batch_size=2))


def test_multistream_zips_sources_until_all_end():
    ticks = list(pstreaming.MultiStream(
        [_Source([1, 2]), _Source([3]), _Source([4, 5, 6])]).play())
    assert ticks == [([0, 1, 2], [1, 3, 4]), ([0, 2], [2, 5]), ([2], [6])]
