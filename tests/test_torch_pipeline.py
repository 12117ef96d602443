"""The port's image-folder input against the JAX package's, on the CPU.

`data/pipeline.py`'s `ImageFolderSource`, `partition`, `filter_by_dims`,
`_parse_label_line` and `repeat_batches(skip_batches=)` are held to JAX's
`data/pipeline.py` on seeded PNG folders written here: every batch, split
and keep bit-equal or equal. A skip reads no skipped image (`_read_image`
calls counted). Both drivers at lite0@64 on a folder consume the JAX
stream's batches, and a run killed after one epoch and resumed is
bit-equal to an uninterrupted one.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import mladversarialobjectdetection_tpu as mad
from mladversarialobjectdetection_tpu.data import pipeline as jpipeline
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack import train as atrain
from mladversarialobjectdetection_torch.data import pipeline as ppipeline
from mladversarialobjectdetection_torch.defense import train as dtrain
from mladversarialobjectdetection_torch.utils import train_loop

TINY = {"fpn_num_filters": 16, "fpn_cell_repeats": 1, "box_class_repeats": 1,
        "max_boxes_per_image": 4,
        "nms_configs": {"score_thresh": 0.0099, "pre_nms_topk": 64,
                        "max_output_size": 16}}
N_IMAGES = 9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this file's tests: the tier-1 run
    shares the CPU among six workers, where torch's default of a thread per
    core oversubscribes it and the driver steps slow down many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """N_IMAGES PNGs of unequal shapes with labels: img0-5 keep every box
    inside the 20 px margin and under a tenth of the area, img6 crosses the
    margin, img7 is too large a box, img8 has a blank and a malformed line
    around a good one."""
    from PIL import Image
    root = tmp_path_factory.mktemp("folder")
    img_dir, label_dir = root / "imgs", root / "labels"
    img_dir.mkdir()
    label_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        h, w = (100, 80) if i % 2 else (90, 120)
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"img{i}.png")
        lines = {6: "0 5 30 60 50\n", 7: "0 22 22 78 70\n",
                 8: "\n0 30 30 50 45\nbad line here\n"}.get(i, "0 30 30 50 45\n")
        (label_dir / f"img{i}.txt").write_text(lines)
    # a grey image: the source converts it to RGB
    Image.fromarray(rng.integers(0, 256, (70, 70), dtype=np.uint8)).save(
        img_dir / "img9_grey.png")
    (label_dir / "img9_grey.txt").write_text("0 25 25 40 40\n")
    return str(img_dir), str(label_dir)


def _sources(folder, **kw):
    img_dir, _ = folder
    return (ppipeline.ImageFolderSource(img_dir, 64, 127.0, 128.0, **kw),
            jpipeline.ImageFolderSource(img_dir, 64, 127.0, 128.0, **kw))


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("shuffle", [False, True])
def test_folder_batches_are_jax_bit_for_bit(folder, shuffle):
    """Two epochs of 3-image batches of 10 files (the last wrap-padded)."""
    p, j = _sources(folder, shuffle=shuffle, seed=3)
    assert len(p) == len(j) == N_IMAGES + 1
    got = _take(p.repeat_batches(3), 8)
    want = _take(j.repeat_batches(3), 8)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (3, 64, 64, 3)
        assert np.array_equal(a, b)
    one = list(ppipeline.ImageFolderSource(folder[0], 64, 127.0, 128.0,
                                           shuffle=False).batches(4))
    assert len(one) == 3 and np.array_equal(one[2][2:], one[0][:2])
    drop = list(ppipeline.ImageFolderSource(folder[0], 64, 127.0, 128.0,
                                            shuffle=False).batches(
        4, drop_remainder=True))
    assert len(drop) == 2


def test_shard_is_jax_shard(folder):
    p, j = _sources(folder, shuffle=False)
    assert p.shard(1, 3).files == j.shard(1, 3).files
    with pytest.raises(ValueError, match="bad shard"):
        p.shard(3, 3)


def test_filter_by_dims_and_label_lines_are_jax(folder):
    img_dir, label_dir = folder
    files = sorted(os.listdir(img_dir))
    kept = [f for f in files if ppipeline.filter_by_dims(img_dir, label_dir, 0.1, f)]
    assert kept == [f for f in files
                    if jpipeline.filter_by_dims(img_dir, label_dir, 0.1, f)]
    assert "img6.png" not in kept and "img7.png" not in kept
    assert "img8.png" in kept and "img9_grey.png" in kept
    for line in ("0 1 2 3 4", "", "\n", "0 1 2 3", "a b c d e", "1 2.5 3 4 5\n"):
        assert ppipeline._parse_label_line(line) == jpipeline._parse_label_line(line)


@pytest.mark.parametrize("filter_data", [False, True])
def test_partition_is_jax(folder, filter_data):
    img_dir, label_dir = folder
    pcfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    jcfg = mad.get_efficientdet_config("efficientdet-lite0")
    pcfg.image_size = jcfg.image_size = 64
    kw = dict(batch_size=2, filter_data=filter_data, seed=5)
    pp = ppipeline.partition(pcfg, img_dir, label_dir, **kw)
    jp = jpipeline.partition(jcfg, img_dir, label_dir, **kw)
    for split in ("train", "val"):
        assert pp[split]["length"] == jp[split]["length"]
        ps, js = pp[split]["source"], jp[split]["source"]
        assert ps.files == js.files and ps.shuffle == js.shuffle
        for a, b in zip(_take(ps.repeat_batches(2), 3), _take(js.repeat_batches(2), 3)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("skip", [2, 4, 9])
def test_skip_batches_reads_nothing_it_skips(folder, monkeypatch, skip):
    """4 batches an epoch: a skip inside the first epoch, one of exactly one
    epoch and one across two epochs, each equal to consuming the batches
    (and to JAX's skip); only the batch taken is read."""
    reads = []
    real = ppipeline._read_image
    monkeypatch.setattr(ppipeline, "_read_image",
                        lambda d, f: reads.append(f) or real(d, f))
    p, j = _sources(folder, shuffle=True, seed=7)
    consumed = _take(p.repeat_batches(3), skip + 1)[-1]
    reads.clear()
    p2, _ = _sources(folder, shuffle=True, seed=7)
    skipped = next(p2.repeat_batches(3, skip_batches=skip))
    assert len(reads) == 3
    assert np.array_equal(skipped, consumed)
    assert np.array_equal(skipped, next(j.repeat_batches(3, skip_batches=skip)))


def test_empty_source_and_missing_pil_raise(folder, tmp_path, monkeypatch):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no images"):
        next(ppipeline.ImageFolderSource(str(empty), 64, 127.0, 128.0)
             .repeat_batches(2))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        ppipeline._read_image(folder[0], "img0.png")


def _recording_prefetch(monkeypatch):
    """Record, per `prefetch` call of a driver (train, then val), the batches
    its consumer took."""
    seen = []
    real = ppipeline.prefetch

    def prefetch(iterator, **kw):
        got = []
        seen.append(got)
        for x in real(iterator, **kw):
            got.append(x.numpy().copy())
            yield x

    monkeypatch.setattr(ppipeline, "prefetch", prefetch)
    return seen


def _jax_streams(folder, batch, filter_data, seed, n_train, n_val):
    img_dir, label_dir = folder
    cfg = mad.get_efficientdet_config("efficientdet-lite0")
    cfg.image_size = 64
    parts = jpipeline.partition(cfg, img_dir, label_dir, batch_size=batch,
                                filter_data=filter_data, seed=seed)
    return (_take(parts["train"]["source"].repeat_batches(batch), n_train),
            _take(parts["val"]["source"].repeat_batches(batch), n_val))


def _assert_streams(seen, want_train, want_val):
    train, val = seen
    assert len(train) == len(want_train) and len(val) == len(want_val)
    for a, b in zip(train + val, want_train + want_val):
        assert np.array_equal(a, b)


def _assert_adam_equal(a, b):
    flat = jax.tree_util.tree_leaves
    assert all(np.array_equal(x, y) for x, y in zip(
        flat(train_loop.adam_state(a)), flat(train_loop.adam_state(b))))


def test_attack_driver_on_a_folder(folder, tmp_path, monkeypatch):
    """The unfiltered split of 10 files at batch 2: 9 train images (5
    batches an epoch, the last wrap-padded) and 1 val image (1 batch). Two
    epochs of 2 steps, each with one val batch and (visualize_freq 2) one
    more for the ASR curve; then killed after one epoch and resumed, which
    fast-forwards both folder streams."""
    img_dir, label_dir = folder
    kw = dict(img_dir=img_dir, label_dir=label_dir, image_size=64,
              batch_size=2, steps_per_epoch=2, patch_size=32, visualize_freq=2,
              mixed_precision=False, config_override=TINY, seed=11,
              device="cpu")
    seen = _recording_prefetch(monkeypatch)
    ref = atrain.train("efficientdet-lite0", epochs=2,
                       save_dir=str(tmp_path / "ref"), **kw)
    _assert_streams(seen, *_jax_streams(folder, 2, False, 11, 4, 4))
    rdir = str(tmp_path / "resumed")
    atrain.train("efficientdet-lite0", epochs=1, save_dir=rdir, **kw)
    seen.clear()
    res = atrain.train("efficientdet-lite0", epochs=2, save_dir=rdir,
                       resume=True, **kw)
    train, val = _jax_streams(folder, 2, False, 11, 4, 4)
    _assert_streams(seen, train[2:], val[2:])
    assert torch.equal(ref.patch, res.patch) and torch.equal(ref.scale, res.scale)
    assert ref.step == res.step == 4
    assert torch.equal(ref.generator.get_state(), res.generator.get_state())
    _assert_adam_equal(ref.optimizer, res.optimizer)


def test_defense_driver_on_a_folder(folder, tmp_path, monkeypatch):
    """The split filtered by the labels (8 of 10 kept: 7 train images in 4
    batches, 1 val image), its length the epoch: 4 steps an epoch; killed
    after one epoch and resumed."""
    img_dir, label_dir = folder
    kw = dict(img_dir=img_dir, label_dir=label_dir, image_size=64,
              batch_size=2, config_override=TINY, seed=13, device="cpu")
    seen = _recording_prefetch(monkeypatch)
    ref = dtrain.train("efficientdet-lite0", epochs=2,
                       save_dir=str(tmp_path / "ref"), **kw)
    _assert_streams(seen, *_jax_streams(folder, 2, True, 13, 8, 2))
    rdir = str(tmp_path / "resumed")
    dtrain.train("efficientdet-lite0", epochs=1, save_dir=rdir, **kw)
    seen.clear()
    res = dtrain.train("efficientdet-lite0", epochs=2, save_dir=rdir,
                       resume=True, **kw)
    train, val = _jax_streams(folder, 2, True, 13, 8, 2)
    _assert_streams(seen, train[4:], val[1:])
    assert ref.step == res.step == 8
    for (ka, va), (kb, vb) in zip(ref.unet.state_dict().items(),
                                  res.unet.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert torch.equal(ref.generator.get_state(), res.generator.get_state())
    _assert_adam_equal(ref.optimizer, res.optimizer)
