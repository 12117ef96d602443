"""The port's int8 serve (`inference/quantize.py`, `ops/conv_int8.py`) against
the JAX package's `inference/quantize.py`, on the CPU.

- `conv_int8.sums_plain` equals `lax.conv_general_dilated` on int8 operands
  with `preferred_element_type=int32` exactly (1x1, 3x3, 5x5; stride 1 and
  2; SAME and VALID; groups 1 and C; odd sizes); the quantisation equals
  `clip(round(x / a_s))` exactly; the dequantised output equals JAX's
  epilogue (quantize.py:174-178) within 1 ulp of its dtype.
- On a tiny lite0 detector of each package with the same weights (the JAX
  variables through the bridge): `quantize_conv_params` bit-equal to JAX's
  (from the port's net and from the Flax variables), within half an LSB of
  the float kernel; `act_scales` with JAX's keys (the `class_net/` shared
  convs in, no `predict`) and values within ACT_RTOL (the float activations
  differ by float32 rounding); the int8 forward held to JAX's `Int8Serve`:
  at most INT8_FRACTION of the outputs off by more than INT8_TOL. Skipping
  quantisation fails that limit (the float forward lies off JAX's int8
  forward at 66% of the outputs by 1e-4, checked in a mutated copy whose
  quantised convs run the float conv); the port's int8 forward lies within
  5e-7 everywhere.
- The drop-in contract of JAX's tests/test_quantize.py:42-112: scores
  within 5e-3 of the float serve, ValueError on no frames, `export` and
  `_serve_float_impl` stay float after `quantize_int8`, and
  `load_flax_variables` returns the serve to float.
- `utils/sparsity`'s 'quantize' registry entry against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mladversarialobjectdetection_tpu.inference import quantize as jquant
from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
from mladversarialobjectdetection_tpu.utils import sparsity as jsp
from mladversarialobjectdetection_torch.inference import quantize as pquant
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.ops import conv_int8
from mladversarialobjectdetection_torch.utils import sparsity as psp

PARAMS = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
          "box_class_repeats": 1,
          "nms_configs": {"score_thresh": 0.0, "pre_nms_topk": 64,
                          "max_output_size": 16}}
ACT_RTOL = 1e-4
INT8_TOL = 1e-4
INT8_FRACTION = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(rng, n, hw=(80, 60)):
    return [rng.integers(0, 255, (*hw, 3), dtype=np.uint8) for _ in range(n)]


# (name, B, C, H, W, Co, k, stride, padding, depthwise)
CONV_CASES = [
    ("1x1", 2, 13, 9, 7, 20, 1, 1, "SAME", False),
    ("3x3 s2 odd", 2, 8, 13, 37, 16, 3, 2, "SAME", False),
    ("5x5 valid", 1, 5, 11, 10, 6, 5, 1, "VALID", False),
    ("3x3 s2 valid", 1, 6, 12, 9, 4, 3, 2, "VALID", False),
    ("dw 3x3", 2, 12, 9, 11, 12, 3, 1, "SAME", True),
    ("dw 5x5 s2 odd", 1, 10, 15, 13, 10, 5, 2, "SAME", True),
    ("dw 3x3 valid", 1, 7, 8, 8, 7, 3, 1, "VALID", True),
    ("1x1 pooled", 3, 9, 1, 1, 5, 1, 1, "SAME", False),
]


def _conv_case(case, seed):
    _, b, c, h, w, co, k, s, pad, dw = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, h, w)) * 3).astype(np.float32)
    wq = rng.integers(-127, 128, (co, 1 if dw else c, k, k)).astype(np.int8)
    return x, wq, s, pad, (c if dw else 1)


def _lax_sums(xq, wq, stride, padding, groups):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq.transpose(0, 2, 3, 1)), jnp.asarray(wq.transpose(2, 3, 1, 0)),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_plain_sums_equal_lax_int8_conv(case):
    x, wq, s, pad, groups = _conv_case(case, 3)
    xq = np.clip(np.round(x / 0.05), -127, 127).astype(np.int8)
    got = conv_int8.sums_plain(torch.from_numpy(xq), torch.from_numpy(wq), stride=s,
                               padding=pad, groups=groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _lax_sums(xq, wq, s, pad, groups))


def _jax_conv(x, a_s, wq, w_scale, bias, stride, padding, groups, out_dtype):
    """JAX's interceptor body (quantize.py:160-178) on NCHW numpy inputs."""
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    a = jnp.float32(a_s)
    xq = jnp.clip(jnp.round(xj.astype(jnp.float32) / a), -127, 127).astype(jnp.int8)
    y = lax.conv_general_dilated(
        xq, jnp.asarray(wq.transpose(2, 3, 1, 0)), window_strides=(stride, stride),
        padding=padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    y = y.astype(jnp.float32) * (a * jnp.asarray(w_scale))
    if bias is not None:
        y = y + jnp.asarray(bias)
    return (np.asarray(xq).transpose(0, 3, 1, 2),
            np.asarray(y.astype(out_dtype).astype(jnp.float32)).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_int8_plain_matches_jax_epilogue(case, out_dtype):
    x, wq, s, pad, groups = _conv_case(case, 5)
    rng = np.random.default_rng(9)
    co = wq.shape[0]
    w_scale = (rng.random(co) * 0.01 + 1e-3).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    a_s = conv_int8.activation_scale(float(np.abs(x).max()))
    jdtype = jnp.float32 if out_dtype == "float32" else jnp.bfloat16
    tdtype = getattr(torch, out_dtype)
    jxq, jy = _jax_conv(x, a_s, wq, w_scale, bias, s, pad, groups, jdtype)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(conv_int8.quantize_plain(xt, a_s).numpy(), jxq)
    scale = torch.from_numpy(conv_int8.dequant_scale(a_s, w_scale))
    y = conv_int8.conv_int8(xt, a_s, torch.from_numpy(wq), scale, torch.from_numpy(bias),
                            stride=s, padding=pad, groups=groups, out_dtype=tdtype)
    assert y.dtype == tdtype
    y = y.to(torch.float32).numpy()
    # one ulp of the output dtype (XLA may contract the epilogue's multiply
    # and add into an FMA; the port keeps them apart)
    ulp = np.spacing(np.abs(jy).astype(np.float32))
    if out_dtype == "bfloat16":
        ulp = ulp * 2.0 ** 16
    assert np.all(np.abs(y - jy) <= ulp)


def test_conv_int8_rejects_what_it_does_not_compute():
    x = torch.zeros((1, 4, 5, 5))
    w = torch.zeros((4, 2, 3, 3), dtype=torch.int8)
    one = torch.ones(4)
    with pytest.raises(ValueError, match="groups"):
        conv_int8.conv_int8(x, 0.1, w, one, groups=2)
    with pytest.raises(ValueError, match="padding"):
        conv_int8.conv_int8(x, 0.1, w[:, :1], one, groups=4, padding="CIRCULAR")
    with pytest.raises(TypeError):
        conv_int8.conv_int8(x, 0.1, w.float(), one)
    with pytest.raises(ValueError, match="CUDA"):
        conv_int8.conv_int8_cuda(x, 0.1, torch.zeros((4, 4, 3, 3), dtype=torch.int8), one)


def test_activation_scale_is_jaxs():
    for amax in (0.0, 1e-9, 0.731, 3.3, 17.0):
        assert conv_int8.activation_scale(amax) == float(
            np.float32(max(amax, 1e-8) / 127.0))


@pytest.fixture(scope="module")
def detectors():
    """(JAX detector, port detector with its variables, JAX Int8Serve and the
    port's on the same 16 calibration frames, the float forward's state)."""
    jdet = JDetector(model_name="efficientdet-lite0", params=PARAMS, seed=0)
    pdet = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    pdet.load_flax_variables(jdet.variables)
    frames = _frames(np.random.default_rng(7), 16)
    batches = [pdet.preprocess(frames[i:i + 8])[0] for i in range(0, 16, 8)]
    jint8 = jquant.Int8Serve(jdet.net, jdet.variables, batches)
    pdet.quantize_int8(frames)
    return jdet, pdet, jint8


def test_quantize_conv_params_bit_equal_to_jax(detectors):
    jdet, pdet, jint8 = detectors
    paths = sorted(jint8.act_scales)
    want = jquant.quantize_conv_params(jdet.variables, paths)
    for source in (pdet.net, jdet.variables):
        got = pquant.quantize_conv_params(source, paths)
        assert list(got) == paths
        for p in paths:
            k_q, w_scale = got[p]
            assert k_q.dtype == torch.int8
            np.testing.assert_array_equal(k_q.numpy().transpose(2, 3, 1, 0),
                                          np.asarray(want[p][0]))
            np.testing.assert_array_equal(w_scale.numpy(), np.asarray(want[p][1]))
    jb = jquant.extract_biases(jdet.variables, paths)
    for source in (pdet.net, jdet.variables):
        pb = pquant.extract_biases(source, paths)
        for p in paths:
            assert (pb[p] is None) == (jb[p] is None)
            if pb[p] is not None:
                np.testing.assert_array_equal(pb[p].numpy(), np.asarray(jb[p]))


def test_per_channel_roundtrip():
    """quantize_conv_params inverts to the float kernel within half an LSB
    (JAX's test_per_channel_roundtrip), from Flax variables."""
    k = np.random.default_rng(7).standard_normal((3, 3, 8, 16)).astype(np.float32)
    (k_q, s), = pquant.quantize_conv_params({"params": {"m": {"kernel": k}}},
                                            ["m"]).values()
    recon = k_q.numpy().astype(np.float32) * s.numpy()[:, None, None, None]
    assert np.abs(recon - k.transpose(3, 2, 0, 1)).max() <= s.numpy().max() * 0.5 + 1e-7


def test_act_scales_match_jax(detectors):
    _, pdet, jint8 = detectors
    got, want = pdet._int8.act_scales, jint8.act_scales
    assert set(got) == set(want)
    assert any(p.startswith("class_net/conv_0/") for p in got)
    assert not any("predict" in p for p in got)
    for p in want:
        assert abs(got[p] - want[p]) <= ACT_RTOL * want[p], p


def test_quantized_conv_count_and_skip(detectors):
    _, pdet, jint8 = detectors
    qk = pdet._int8.qkernels
    assert set(qk) == set(jint8.state["qkernels"]) and len(qk) > 50
    assert all("predict" not in p for p in qk)
    assert any(p.startswith("class_net/") for p in qk)
    for k, s in qk.values():
        assert k.dtype == torch.int8 and tuple(s.shape) == (k.shape[0],)
        assert int(k.abs().max()) <= 127


def test_int8_forward_matches_jax(detectors):
    _, pdet, jint8 = detectors
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jc, jb = jax.jit(jint8)(jint8.state, jnp.asarray(x))
    with torch.no_grad():
        pc, pb = pdet._int8(torch.from_numpy(x))
    off = total = 0
    for j, p in zip(list(jc) + list(jb), list(pc) + list(pb)):
        d = np.abs(np.asarray(j, np.float32) - p.numpy())
        off += int((d > INT8_TOL).sum())
        total += d.size
    assert off <= INT8_FRACTION * total, f"{off} of {total} outputs off by > {INT8_TOL}"


def test_serve_scores_track_float(detectors):
    jdet, pdet, _ = detectors
    frames = _frames(np.random.default_rng(11), 2)
    qd = pdet.serve(frames)
    fdet = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    fdet.load_flax_variables(jdet.variables)
    fd = fdet.serve(frames)
    assert qd.boxes.shape == fd.boxes.shape == (2, 16, 4)
    assert float(np.abs(fd.scores - qd.scores).max()) < 5e-3


def test_requires_frames(detectors):
    with pytest.raises(ValueError):
        detectors[1].quantize_int8([])


def test_export_and_float_serve_stay_float_after_quantize(detectors, tmp_path):
    from mladversarialobjectdetection_torch.inference import export as pexport
    jdet, pdet, _ = detectors
    fdet = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    fdet.load_flax_variables(jdet.variables)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 64, 64, 3)).astype(np.float32))
    scales = torch.ones((1,))
    ref = fdet.serve_tensors(x, scales)
    with torch.no_grad():
        float_serve = pdet._serve_float_impl(x, scales)
    for a, b in zip(float_serve, ref):
        assert torch.equal(a, b)
    path = str(tmp_path / "det.pt2")
    pdet.export(path)
    with torch.no_grad():
        out = pexport.load_program(path).module()(x, scales)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert pdet._int8 is not None


def test_load_flax_variables_resets_to_float(detectors):
    jdet, _, _ = detectors
    det = Detector("efficientdet-lite0", params=PARAMS, device="cpu")
    det.load_flax_variables(jdet.variables)
    frames = _frames(np.random.default_rng(13), 2)
    fd = det.serve(frames)
    det.quantize_int8(_frames(np.random.default_rng(14), 8))
    assert det._int8 is not None
    det.load_flax_variables(jdet.variables)
    assert det._int8 is None
    back = det.serve(frames)
    for f in fd._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(fd, f))


def test_sparsity_quantize_matches_jax(detectors):
    jdet, pdet, jint8 = detectors
    assert psp.get_method("quantize") is pquant
    assert jsp.get_method("quantize") is jquant
    paths = sorted(jint8.act_scales)[:5]
    psp.set_config({"quantize": {"paths": paths}})
    jsp.set_config({"quantize": {"paths": paths}})
    try:
        got = psp.get_method("quantize")(jdet.variables)
        want = jsp.get_method("quantize")(jdet.variables)
    finally:
        psp._optimization_methods.clear()
        jsp._optimization_methods.clear()
    assert list(got) == list(want) == paths
    for p in paths:
        np.testing.assert_array_equal(got[p][0].numpy().transpose(2, 3, 1, 0),
                                      np.asarray(want[p][0]))
        np.testing.assert_array_equal(got[p][1].numpy(), np.asarray(want[p][1]))
