"""The rest of the port's serving surface against the JAX package's, on the
CPU: host NMS and WBF, label maps, drawing, `Detector.__call__`,
`AdversarialPatch`, the synthetic clip, the video helpers and both demos.

Tolerances:

- `nms_np`, `per_class_nms`, `weighted_boxes_fusion`, `get_label_map`,
  `render_frames` and the video helpers' files: exact (the same numpy code).
- `draw_*`, `draw_detections_grid` and `AdversarialPatch.add_adv_to_img`:
  byte-equal, `np.random` seeded alike.
- `Detector.__call__` on a tiny lite0 victim read by both packages from one
  pytree file: byte-equal. The victim's class head is biased toward persons
  and its person columns scaled, so that the detections clear the demos'
  score threshold and their scores do not tie (equal-score candidates could
  leave the two packages' NMS in another order).
- `RecoveryDemo`: the float recovery within 2e-4 * max(1, max|ref|), the
  uint8 frame within 1 LSB.
- `demo_v2.main` and `demo.main` on a 4-frame synthetic clip: every frame
  handed to a video writer, per video, within 1 LSB of JAX's (the recovered
  view carries the U-Net's rounding; the others are byte-equal).
"""
import os

import jax
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.demo import demo as jdemo
from mladversarialobjectdetection_tpu.demo import demo_v2 as jdemo_v2
from mladversarialobjectdetection_tpu.demo import draw as jdraw
from mladversarialobjectdetection_tpu.demo import make_demo_detector as jmake
from mladversarialobjectdetection_tpu.demo import synthetic_clip as jclip
from mladversarialobjectdetection_tpu.demo import video as jvideo
from mladversarialobjectdetection_tpu.inference.adv_patch import AdversarialPatch as JPatch
from mladversarialobjectdetection_tpu.models import unet as junet
from mladversarialobjectdetection_tpu.ops import nms_np as jnms_np
from mladversarialobjectdetection_tpu.ops import wbf as jwbf
from mladversarialobjectdetection_tpu.utils import label_util as jlabel
from mladversarialobjectdetection_tpu.utils import visualize as jvis
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack.train import get_victim
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.ckpt import io as pio
from mladversarialobjectdetection_torch.demo import demo as pdemo
from mladversarialobjectdetection_torch.demo import demo_v2 as pdemo_v2
from mladversarialobjectdetection_torch.demo import draw as pdraw
from mladversarialobjectdetection_torch.demo import make_demo_detector as pmake
from mladversarialobjectdetection_torch.demo import synthetic_clip as pclip
from mladversarialobjectdetection_torch.demo import video as pvideo
from mladversarialobjectdetection_torch.inference import AdversarialPatch as PPatch
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer
from mladversarialobjectdetection_torch.ops import nms_np as pnms_np
from mladversarialobjectdetection_torch.ops import wbf as pwbf
from mladversarialobjectdetection_torch.utils import label_util as plabel
from mladversarialobjectdetection_torch.utils import visualize as pvis

cv2 = pytest.importorskip("cv2")

TINY = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
        "box_class_repeats": 1,
        "nms_configs": {"pre_nms_topk": 64, "max_output_size": 8}}
PERSON_GAIN = 3000.0  # spreads the person logits (tests/test_torch_attack.py)
REC_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the tier-1 run shares the CPU among six
    workers, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, n, lo=20, hi=100):
    centers = rng.uniform(lo, hi, (n, 2))
    sizes = rng.uniform(5, 30, (n, 2))
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          axis=1).astype(np.float32)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# host NMS, WBF, label maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["hard", "gaussian", "linear", "diou"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_nms_np_matches_jax(method, plus_one):
    rng = np.random.default_rng(0)
    boxes, scores = _boxes(rng, 40), rng.uniform(0.1, 1.0, 40).astype(np.float32)
    for kw in ({}, {"score_thresh": 0.2, "iou_thresh": 0.4, "max_output_size": 10}):
        ref = jnms_np.nms_np(boxes, scores, method=method, plus_one=plus_one, **kw)
        _equal(pnms_np.nms_np(boxes, scores, method=method, plus_one=plus_one,
                              **kw), ref)
    _equal([pnms_np.iou_np(boxes[0], boxes, plus_one)],
           [jnms_np.iou_np(boxes[0], boxes, plus_one)])
    _equal([pnms_np.diou_np(boxes[0], boxes, plus_one)],
           [jnms_np.diou_np(boxes[0], boxes, plus_one)])


def test_nms_np_rejects_an_unknown_method():
    for mod in (jnms_np, pnms_np):
        with pytest.raises(ValueError):
            mod.nms_np(np.zeros((1, 4)), np.ones(1), method="box")


def test_per_class_nms_matches_jax():
    rng = np.random.default_rng(1)
    boxes, scores = _boxes(rng, 60), rng.uniform(0.05, 1.0, 60).astype(np.float32)
    classes = rng.integers(0, 4, 60)
    for kw in ({"method": "hard", "iou_thresh": 0.5, "score_thresh": 0.1},
               {"method": "gaussian", "max_output_size": 12}):
        _equal(pnms_np.per_class_nms(boxes, scores, classes, **kw),
               jnms_np.per_class_nms(boxes, scores, classes, **kw))
    empty = (np.zeros((0, 4)), np.zeros(0), np.zeros(0, int))
    _equal(pnms_np.per_class_nms(*empty), jnms_np.per_class_nms(*empty))


def test_wbf_matches_jax():
    rng = np.random.default_rng(2)
    base = _boxes(rng, 12)
    models = [base + rng.normal(0, 2, base.shape) for _ in range(3)]
    scores = [rng.uniform(0.05, 1.0, 12) for _ in range(3)]
    classes = [rng.integers(0, 3, 12) for _ in range(3)]
    for kw in ({}, {"iou_thresh": 0.3, "score_thresh": 0.2, "max_output_size": 5},
               {"score_thresh": 2.0}):
        _equal(pwbf.weighted_boxes_fusion(models, scores, classes, **kw),
               jwbf.weighted_boxes_fusion(models, scores, classes, **kw))


def test_label_maps_match_jax():
    for mapping in (None, "coco", "voc", {1: "x", 2: "y"}):
        assert plabel.get_label_map(mapping) == jlabel.get_label_map(mapping)
    for mod in (jlabel, plabel):
        with pytest.raises(ValueError):
            mod.get_label_map("kitti")


# ---------------------------------------------------------------------------
# drawing, the attack's sample grid, the patch compositor
# ---------------------------------------------------------------------------

def test_draw_matches_jax():
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    boxes = [tuple(b) for b in _boxes(rng, 5, 20, 100).tolist()]
    scores = rng.uniform(0, 1, 5).tolist()
    assert pdraw.filter_by_thresh(boxes, scores, 0.4) == \
        jdraw.filter_by_thresh(boxes, scores, 0.4)
    for labels in (None, ["a", "b", "c", "d", "e"]):
        _equal([pdraw.draw_boxes(frame.copy(), boxes, scores, labels=labels)],
               [jdraw.draw_boxes(frame.copy(), boxes, scores, labels=labels)])
    ro = frame.copy()
    ro.flags.writeable = False
    _equal([pdraw.draw_boxes(ro, boxes, scores, thickness=1)],
           [jdraw.draw_boxes(ro, boxes, scores, thickness=1)])
    _equal([pdraw.put_text(ro, "mean score: 51.2", (10, 30), color=(255, 0, 0),
                           scale=1.0)],
           [jdraw.put_text(ro, "mean score: 51.2", (10, 30), color=(255, 0, 0),
                           scale=1.0)])


def test_draw_detections_grid_matches_jax():
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    boxes = rng.uniform(0, 60, (2, 3, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + 4
    valid = np.array([[True, False, True], [False, False, False]])
    args = (images, boxes, valid, boxes[:, ::-1], valid[:, ::-1])
    _equal([pvis.draw_detections_grid(*args)], [jvis.draw_detections_grid(*args)])
    _equal([pvis.draw_detections_grid(images[:0], *args[1:])],
           [jvis.draw_detections_grid(images[:0], *args[1:])])


def _patch_kwargs(kind, tmp_path):
    if kind == "random":
        return {"h": 96, "w": 128}
    rng = np.random.default_rng(5)
    if kind == "array":
        return {"patch_array": rng.uniform(-1, 1, (40, 40, 3)).astype(np.float32)}
    from PIL import Image
    path = str(tmp_path / "patch.png")
    Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)).save(path)
    return {"patch_file": path}


@pytest.mark.parametrize("kind", ["random", "array", "file"])
def test_adversarial_patch_matches_jax(kind, tmp_path):
    """Both packages' `add_adv_to_img` byte-equal with `np.random` seeded
    alike: the print transform, placement (edge clamps, a box too small to
    patch), brightness match, both resizes and the noise."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    bboxes = [(10, 12, 80, 60), (50, 100, 96, 128), (0, 0, 1, 1),
              (30.5, 40.2, 90.7, 70.1)]
    outs = []
    for cls in (JPatch, PPatch):
        np.random.seed(7)
        ap = cls(scale=0.6, **_patch_kwargs(kind, tmp_path))
        outs.append([ap.add_adv_to_img(img, bboxes), ap._patch_img,
                     ap.brightness_match(img)])
    _equal(outs[0], outs[1])
    assert (outs[1][0] != img).any()


# ---------------------------------------------------------------------------
# a tiny victim both packages read from one file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def victim_file(tmp_path_factory):
    """A lite0@64 detector's variables (a pytree file, `<path>.pkl`, which
    both packages read), drawn by the port from a seed, with a class head
    that calls every anchor a person, scores spread by PERSON_GAIN."""
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.override(TINY, allow_new_keys=False)
    variables = bridge.torch_to_flax(get_victim(cfg, seed=0, device="cpu"))
    pw = variables["params"]["class_net"]["predict"]["pw"]
    n = cfg.num_classes
    pw["bias"][:] = -10.0
    pw["bias"][0::n] = 0.0
    pw["kernel"][..., 0::n] *= PERSON_GAIN
    path = str(tmp_path_factory.mktemp("victim") / "victim")
    pio.save_pytree(path, variables)
    return path


@pytest.fixture(scope="module")
def detectors(victim_file):
    return (jmake("efficientdet-lite0", victim_file, TINY),
            pmake("efficientdet-lite0", victim_file, TINY, device="cpu"))


@pytest.fixture(scope="module")
def clip_frames():
    return pclip.render_frames(4, 120, 160, n_persons=2, seed=3)[0]


def test_synthetic_clip_matches_jax(tmp_path):
    for args in ((4, 120, 160, 2, 3), (3, 64, 96, 1, 0)):
        _equal(*[sum(mod.render_frames(*args)[:1], []) for mod in (pclip, jclip)])
        assert pclip.render_frames(*args)[1] == jclip.render_frames(*args)[1]
    paths = [str(tmp_path / f"{n}.mp4") for n in ("p", "j")]
    gts = [mod.write_clip(p, n_frames=3, height=64, width=96, seed=1)
           for mod, p in zip((pclip, jclip), paths)]
    assert gts[0] == gts[1]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_video_helpers_match_jax(tmp_path):
    clip = str(tmp_path / "clip.mp4")
    pclip.write_clip(clip, n_frames=3, height=64, width=96, seed=2)
    dirs = []
    for name, mod in (("p", pvideo), ("j", jvideo)):
        d = str(tmp_path / name)
        assert mod.extract_video_frames(clip, d, set_width=48) == 3
        out = str(tmp_path / f"{name}.mp4")
        assert mod.frames_to_video(d, out, fps=12) == 3
        dirs.append((d, out))
    (pd, pout), (jd, jout) = dirs
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for f in os.listdir(pd):
        assert open(os.path.join(pd, f), "rb").read() == \
            open(os.path.join(jd, f), "rb").read()
    assert open(pout, "rb").read() == open(jout, "rb").read()


def test_detector_call_matches_jax(detectors, clip_frames):
    """`Detector.__call__` byte-equal; the demo detector is the demos'
    (iou .5, score 0), so every candidate of the 8 slots is drawn."""
    jdet, pdet = detectors
    assert pdet.config.nms_configs.score_thresh == 0.0
    assert pdet.config.nms_configs.iou_thresh == 0.5
    for frame in clip_frames[:2]:
        ref = jdet(frame.copy())  # draws on the frame it is given
        _equal([pdet(frame.copy())], [ref])
        assert (ref != frame).any()
        jb, js = jdet.infer(frame)
        pb, ps = pdet.infer(frame)
        assert len(pb) == len(jb) == 8
        assert sum(s >= jdemo_v2.SCORE_THRESH for s in js) >= 1
        np.testing.assert_allclose(pb, jb, atol=1e-3)
        np.testing.assert_allclose(ps, js, atol=1e-5)


# ---------------------------------------------------------------------------
# the recovery demo and both demos end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_file(tmp_path_factory):
    """A U-Net's variables for `RecoveryDemo`, drawn by the port from a seed."""
    unet = PatchNeutralizer()
    init_weights(unet, torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("unet") / "antipatch")
    pio.save_pytree(path, bridge.torch_to_flax(unet))
    return path


class _ShapeInitUnet(junet.PatchNeutralizer):
    """JAX's U-Net whose `init` gives shapes only. JAX's `RecoveryDemo`
    builds an init template that a pytree file never reads
    (`convert_defense.load_antipatch` reads it for .h5 files alone), and
    built op by op on a cold compilation cache it costs about 28 s of CPU."""

    def init(self, rngs, x, *args):
        return jax.eval_shape(lambda r, y: super(_ShapeInitUnet, self).init(
            r, y, *args), rngs, x)


@pytest.fixture()
def jax_unet_template_by_shape(monkeypatch):
    monkeypatch.setattr(junet, "PatchNeutralizer", _ShapeInitUnet)


@pytest.mark.usefixtures("jax_unet_template_by_shape")
def test_recovery_demo_matches_jax(detectors, unet_file, clip_frames):
    jdet, pdet = detectors
    jrd = jdemo_v2.RecoveryDemo(unet_file, jdet, "efficientdet-lite0")
    prd = pdemo_v2.RecoveryDemo(unet_file, pdet, "efficientdet-lite0")
    x = np.random.default_rng(8).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jrd._apply(jrd._variables, x))
    got = prd.recover(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= REC_TOL * max(1.0, np.abs(ref).max())
    for frame in clip_frames[:2]:
        ref, got = jrd.serve(frame), prd.serve(frame)
        assert got.shape == ref.shape == frame.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


class _Writers:
    """Stands in for `cv2.VideoWriter`: keeps every frame written, per file."""

    def __init__(self):
        self.frames = {}

    def __call__(self, path, fourcc, fps, size):
        frames = self.frames.setdefault(os.path.basename(path), [])

        class Writer:
            def write(self, frame):
                assert frame.shape[1::-1] == tuple(size)
                frames.append(frame.copy())

            def release(self):
                pass
        return Writer()


@pytest.mark.usefixtures("jax_unet_template_by_shape")
@pytest.mark.parametrize("which", ["demo_v2", "demo"])
def test_demo_main_matches_jax(which, tmp_path, victim_file, unet_file,
                               monkeypatch):
    """`main` of each demo on a 4-frame synthetic clip with a defender: the
    frames handed to each writer within 1 LSB of JAX's."""
    clip = str(tmp_path / "walk.mp4")
    pclip.write_clip(clip, n_frames=4, height=120, width=160, n_persons=2,
                     seed=3)
    runs = []
    for mod, kw in (((jdemo_v2, jdemo)[which == "demo"], {}),
                    ((pdemo_v2, pdemo)[which == "demo"], {"device": "cpu"})):
        writers = _Writers()
        monkeypatch.setattr(cv2, "VideoWriter", writers)
        np.random.seed(9)
        mod.main(str(tmp_path / "out"), clip, defender_weights=unet_file,
                 model_name="efficientdet-lite0", detector_ckpt=victim_file,
                 detector_params=TINY, set_width=160, **kw)
        runs.append(writers.frames)
    ref, got = runs
    names = {"demo_v2": {"clean.mp4", "adv.mp4", "det.mp4"},
             "demo": {"demo.mp4"}}[which]
    assert set(got) == set(ref) == names
    for name in names:
        assert len(got[name]) == len(ref[name]) == 4, name
        for g, r in zip(got[name], ref[name]):
            assert g.shape == r.shape and g.dtype == r.dtype == np.uint8
            assert np.abs(g.astype(int) - r.astype(int)).max() <= 1, name
    if which == "demo_v2":  # the patch was planted: adv differs from clean
        assert any((a != c).any() for a, c in zip(got["adv.mp4"], got["clean.mp4"]))
        for name in ("clean.mp4", "adv.mp4"):
            _equal(got[name], ref[name])
