"""The port's inspector CLI (`inference/inspector.py`) and debug harness
(`utils/debug.py`) against the JAX package's, on the CPU.

- `run_infer` writes `0.jpg`, and its annotated image equals JAX's
  `run_infer` on the same weights and input: the drawings' pixels equal
  (the two detections' boxes lie within 1e-3 px, the scores within 1e-5,
  tests/test_torch_serving.py's tolerances; the drawing rounds them to whole
  pixels and two decimals), the JPEG files decoded within INFER_LSB.
- `run_dry`'s checkpoint (Flax names, `ckpt/io.save_pytree`) restores to
  an identical serve in the port and to JAX's variables in the JAX package.
- `run_benchmark` returns `ms`, `fps` and `compile_s`, serve and bare net.
- `run_video` annotates a synthetic clip through `serve_pipelined`.
- `main` runs the benchmark mode on the CPU; the export mode writes a
  program, and `saved_model` raises.
- `utils.debug`: `benchmark` returns a positive time (JAX test_aux.py:80),
  `set_deterministic` a seeded generator, `trace` a Chrome trace.
"""
import os

import jax
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.inference import inspector as jinspector
from mladversarialobjectdetection_torch.inference import inspector as pinspector
from mladversarialobjectdetection_torch.utils import debug as pdebug

TINY = ("image_size=64,fpn_num_filters=16,fpn_cell_repeats=1,"
        "box_class_repeats=1,nms_configs.score_thresh=0.0,"
        "nms_configs.pre_nms_topk=64,nms_configs.max_output_size=16")
INFER_LSB = 8  # JPEG's lossy decode of images drawn alike


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def detectors():
    """JAX's inspector detector and the port's with its weights."""
    jdet = jinspector.build_detector("efficientdet-lite0", hparams=TINY)
    pdet = pinspector.build_detector("efficientdet-lite0", hparams=TINY, device="cpu")
    pdet.load_flax_variables(jdet.variables)
    return jdet, pdet


def test_infer_writes_the_image_jax_writes(tmp_path, detectors):
    from PIL import Image

    jdet, pdet = detectors
    src = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (80, 96, 3),
                                                      dtype=np.uint8)).save(src)
    got = pinspector.run_infer(pdet, str(src), str(tmp_path / "p"), min_score=0.0,
                               max_boxes=5)
    want = jinspector.run_infer(jdet, str(src), str(tmp_path / "j"), min_score=0.0,
                                max_boxes=5)
    assert os.path.basename(got) == "0.jpg"
    frame = np.asarray(Image.open(src).convert("RGB"))
    pd, jd = pdet.serve(frame[None]), jdet.serve(frame[None])
    np.testing.assert_array_equal(
        pinspector._annotate(pdet, frame, pd, 0, 0.0, 5),
        jinspector._annotate(jdet, frame, jd, 0, 0.0, 5))
    a = np.asarray(Image.open(got)).astype(int)
    b = np.asarray(Image.open(want)).astype(int)
    assert a.shape == b.shape == (80, 96, 3)
    assert np.abs(a - b).max() <= INFER_LSB


def test_dry_checkpoint_restores_identical_serve(tmp_path, detectors):
    from mladversarialobjectdetection_tpu.ckpt import io as jio

    jdet, pdet = detectors
    ckpt = str(tmp_path / "native_ckpt")
    pinspector.run_dry(pdet, export_ckpt=ckpt)
    det2 = pinspector.build_detector("efficientdet-lite0", hparams=TINY, ckpt=ckpt,
                                     device="cpu")
    raw = np.random.default_rng(2).integers(0, 255, (2, 70, 90, 3), dtype=np.uint8)
    a, b = pdet.serve(raw), det2.serve(raw)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    restored = jio.load_pytree(ckpt)
    want = jax.tree_util.tree_flatten_with_path(jdet.variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(restored)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


def test_benchmark_reports_throughput(detectors):
    _, pdet = detectors
    res = pinspector.run_benchmark(pdet, batch_size=2, bm_runs=2)
    assert set(res) == {"ms", "fps", "compile_s"}
    assert res["ms"] > 0 and res["fps"] > 0 and res["compile_s"] > 0
    assert pinspector.run_benchmark(pdet, batch_size=2, bm_runs=2,
                                    only_network=True)["ms"] > 0


def test_video_annotates_clip(tmp_path, detectors):
    import cv2

    from mladversarialobjectdetection_torch.demo import synthetic_clip

    _, pdet = detectors
    clip = str(tmp_path / "clip.mp4")
    synthetic_clip.write_clip(clip, n_frames=5, height=120, width=160, seed=0)
    out = str(tmp_path / "annotated.mp4")
    assert pinspector.run_video(pdet, clip, out, min_score=0.0, batch_size=2,
                                max_frames=5) == 5
    cap = cv2.VideoCapture(out)
    assert cap.isOpened()
    got = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        got += 1
        assert frame.shape[2] == 3
    cap.release()
    assert got == 5
    with pytest.raises(ValueError):
        pinspector.run_video(pdet, clip, "", max_frames=1)


def test_main_benchmark_and_export(tmp_path, capsys):
    pinspector.main(["--mode", "benchmark", "--model", "efficientdet-lite0",
                     "--hparams", TINY, "--batch-size", "2", "--bm-runs", "2",
                     "--device", "cpu"])
    assert "'ms'" in capsys.readouterr().out
    path = str(tmp_path / "det.pt2")
    pinspector.main(["--mode", "export", "--model", "efficientdet-lite0", "--hparams",
                     TINY, "--saved-model-dir", path, "--device", "cpu"])
    assert os.path.getsize(path) > 0
    with pytest.raises(NotImplementedError):
        pinspector.main(["--mode", "export", "--model", "efficientdet-lite0",
                         "--hparams", TINY, "--saved-model-dir", str(tmp_path / "sm"),
                         "--export-format", "saved_model", "--device", "cpu"])


def test_debug_harness(tmp_path):
    dt = pdebug.benchmark(lambda x: x * 2, torch.ones((4, 4)), iters=3, warmup=1)
    assert dt > 0
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        g = pdebug.set_deterministic(3)
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert torch.equal(torch.rand(4, generator=g),
                           torch.rand(4, generator=torch.Generator().manual_seed(3)))
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[1:]
    with pdebug.trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    pdebug.enable_debug(nans=True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    finally:
        pdebug.enable_debug(nans=False)
    assert not torch.is_anomaly_enabled()
