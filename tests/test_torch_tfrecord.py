"""The port's TFRecord input and dataset tooling against the JAX package's, on the CPU.

`data/{tfrecord,create_coco_tfrecord,create_pascal_tfrecord,
inspect_tfrecords,autoaugment,augment}.py` and the native reader
(`csrc/tfrecord_native.c`, built by `_build.build_tfrecord_native`). All
exact: record bytes, parsed examples, reader batches (the same seed, shard,
`skip_crowd` and autoaugment policy), the COCO and Pascal conversions,
every autoaugment op and policy and RandAugment under the same numpy
generator, `mosaic`, and `gridmask` given JAX's draws. The native reader's
payloads equal the pure-python framing's, and a flipped CRC raises.
"""
import io
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mladversarialobjectdetection_tpu.data import augment as jaug
from mladversarialobjectdetection_tpu.data import autoaugment as jaa
from mladversarialobjectdetection_tpu.data import create_coco_tfrecord as jcoco
from mladversarialobjectdetection_tpu.data import create_pascal_tfrecord as jvoc
from mladversarialobjectdetection_tpu.data import inspect_tfrecords as jinspect
from mladversarialobjectdetection_tpu.data import tfrecord as jtf
from mladversarialobjectdetection_torch import _build
from mladversarialobjectdetection_torch.data import augment as paug
from mladversarialobjectdetection_torch.data import autoaugment as paa
from mladversarialobjectdetection_torch.data import create_coco_tfrecord as pcoco
from mladversarialobjectdetection_torch.data import create_pascal_tfrecord as pvoc
from mladversarialobjectdetection_torch.data import inspect_tfrecords as pinspect
from mladversarialobjectdetection_torch.data import tfrecord as ptf

MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def _png(rng, h, w) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _examples(n, seed=0):
    """n detection examples of 48x64 PNGs with 1-4 boxes, crowds among them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = int(rng.integers(1, 5))
        y0, x0 = rng.uniform(0, 0.5, (2, g))
        boxes = np.stack([y0, x0, y0 + rng.uniform(0.2, 0.5, g),
                          x0 + rng.uniform(0.2, 0.5, g)], -1)
        classes = rng.integers(1, 91, g).tolist()
        crowd = (rng.random(g) < 0.3).astype(int).tolist()
        out.append(pcoco.make_example(_png(rng, 48, 64), 48, 64, boxes,
                                      classes, crowd, str(i)))
    return out


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three shards of detection records, written by the port."""
    root = tmp_path_factory.mktemp("shards")
    recs = _examples(9)
    for i in range(3):
        pcoco.write_records(recs[i::3], str(root / f"d-{i:05d}.tfrecord"))
    return str(root / "d-*.tfrecord"), recs


def test_records_and_examples_are_jax_bytes(shards, tmp_path):
    pattern, recs = shards
    for rec in recs:
        assert ptf.frame_record(rec) == jtf.frame_record(rec)
        assert ptf.parse_example(rec) == jtf.parse_example(rec)
        ours = ptf.decode_detection_example(ptf.parse_example(rec))
        ref = jtf.decode_detection_example(jtf.parse_example(rec))
        for k in ref:
            assert np.array_equal(ours[k], ref[k]), k
    rng = np.random.default_rng(3)
    args = (_png(rng, 32, 40), 32, 40, np.asarray([[0.1, 0.2, 0.5, 0.6]]),
            [1], [0], "7")
    assert pcoco.make_example(*args) == jcoco.make_example(*args)
    ptf.write_fake_tfrecord(str(tmp_path / "p.tfrecord"), n=3)
    jtf.write_fake_tfrecord(str(tmp_path / "j.tfrecord"), n=3)
    assert (tmp_path / "p.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()


def test_native_reader_matches_python_framing_and_checks_crcs(shards, tmp_path,
                                                              monkeypatch):
    pattern, recs = shards
    path = pattern.replace("*", "00000")
    with monkeypatch.context() as m:
        m.setattr(ptf, "_native", lambda: None)
        py = list(ptf.read_tfrecord_file(path))
        crc_py = ptf.masked_crc32c(b"123456789")
    _build.build_tfrecord_native()
    native = ptf._native()
    assert native is not None and native.crc32c(b"123456789") == 0xE3069283
    assert ptf.masked_crc32c(b"123456789") == crc_py
    assert list(ptf.read_tfrecord_file(path)) == py == recs[0::3]
    data = bytearray(open(path, "rb").read())
    (length,) = struct.unpack("<Q", bytes(data[:8]))
    data[12 + length] ^= 0x01  # the first payload CRC
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        list(ptf.read_tfrecord_file(str(bad)))


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=1, skip_crowd=False, shuffle=False),
    dict(seed=2, shard=(1, 2)),
    dict(seed=3, shard=(2, 4)),
    dict(seed=4, autoaugment_policy="v1"),
    dict(seed=5, autoaugment_policy="randaug", skip_crowd=False),
])
def test_reader_batches_are_jax_batches(shards, kw):
    pattern, _ = shards
    common = dict(image_size=64, mean_rgb=MEAN, stddev_rgb=STD, max_instances=6)
    ours = ptf.DetectionTFRecordReader(pattern, **common, **kw).batches(2)
    ref = jtf.DetectionTFRecordReader(pattern, **common, **kw).batches(2)
    for _ in range(5):  # more than one pass over the (sharded) records
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _coco_dir(root, rng):
    images, anns = [], []
    for i in range(5):
        h, w = int(rng.integers(20, 40)), int(rng.integers(20, 40))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / f"{i}.jpg")
        images.append({"id": i, "file_name": f"{i}.jpg", "height": h, "width": w})
        for k in range(int(rng.integers(0, 3))):
            anns.append({"image_id": i, "bbox": rng.uniform(0, 15, 4).tolist(),
                         "category_id": int(rng.integers(1, 91)),
                         "iscrowd": int(rng.random() < 0.3)})
    images.append({"id": 9, "file_name": "missing.jpg", "height": 5, "width": 5})
    with open(root / "ann.json", "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def _voc_dir(root, rng):
    year = root / "VOC2007"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (year / sub).mkdir(parents=True)
    names = list(pvoc.PASCAL_LABEL_MAP)[1:]
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)).save(
            year / "JPEGImages" / f"{i:06d}.jpg")
        objs = "".join(
            f"<object><name>{names[int(rng.integers(0, 20))] if k else 'unicorn'}"
            f"</name><difficult>{int(rng.random() < 0.5)}</difficult>"
            f"<truncated>0</truncated><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
            f"<xmax>{x0 + 9}</xmax><ymax>{y0 + 7}</ymax></bndbox></object>"
            for k, (x0, y0) in enumerate(rng.integers(0, 20, (3, 2))))
        (year / "Annotations" / f"{i:06d}.xml").write_text(
            f"<annotation><filename>{i:06d}.jpg</filename><size><width>40"
            f"</width><height>30</height></size>{objs}</annotation>")
    (year / "ImageSets/Main/train.txt").write_text("000000\n000002\n000003\n")


def test_coco_and_pascal_conversion_are_jax_bytes(tmp_path):
    rng = np.random.default_rng(11)
    _coco_dir(tmp_path, rng)
    for mod, out in ((pcoco, "p"), (jcoco, "j")):
        n = mod.convert(str(tmp_path / "ann.json"), str(tmp_path),
                        str(tmp_path / out), num_shards=2, limit=5)
        assert n == 5
    _voc_dir(tmp_path / "voc", rng)
    for split, skip in (("train", False), ("val", True)):
        for mod, out in ((pvoc, f"pv{split}"), (jvoc, f"jv{split}")):
            mod.convert(str(tmp_path / "voc"), str(tmp_path / out), split=split,
                        num_shards=2, ignore_difficult_instances=skip)
    for p in sorted(tmp_path.glob("p*.tfrecord")):
        j = tmp_path / ("j" + p.name[1:])
        assert p.read_bytes() == j.read_bytes(), p.name
    assert len(list(tmp_path.glob("p*.tfrecord"))) == 6
    ann = str(tmp_path / "voc/VOC2007/Annotations/000001.xml")
    assert pvoc.parse_annotation(ann) == jvoc.parse_annotation(ann)


def test_inspect_tfrecords_matches_jax(shards, tmp_path):
    pattern, _ = shards
    assert pinspect.summarize(pattern) == jinspect.summarize(pattern)
    assert pinspect.summarize(pattern, 4) == jinspect.summarize(pattern, 4)
    n = pinspect.save_samples(pattern, str(tmp_path / "p"), samples=3, seed=1)
    assert n == jinspect.save_samples(pattern, str(tmp_path / "j"), samples=3,
                                      seed=1) == 3
    for name in sorted(os.listdir(tmp_path / "j")):
        assert np.array_equal(np.asarray(Image.open(tmp_path / "p" / name)),
                              np.asarray(Image.open(tmp_path / "j" / name)))


def _image_and_boxes(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (56, 72, 3), dtype=np.uint8)
    boxes = np.asarray([[5, 6, 30, 40], [20, 30, 50, 70], [0, 0, 10, 12]],
                       np.float32)
    return img, boxes


ALL_OPS = sorted({n for p in jaa.POLICIES.values() for sp in p for n, _, _ in sp}
                 | set(jaa.RANDAUG_OPS) | {"AutoContrast", "Posterize",
                                           "Solarize", "Rotate_Only_BBoxes",
                                           "ShearX_Only_BBoxes"})


def test_every_autoaugment_op_is_jax_bytes():
    assert set(paa.POLICIES) == set(jaa.POLICIES)
    for i, name in enumerate(ALL_OPS):
        for level in (2.0, 7.0, 10.0):
            img, boxes = _image_and_boxes(i)
            ours = paa._apply_op(np.random.default_rng(i), img, boxes, name,
                                 level, 0.9)
            ref = jaa._apply_op(np.random.default_rng(i), img, boxes, name,
                                level, 0.9)
            for a, b in zip(ours, ref):
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, level)


@pytest.mark.parametrize("policy", ["v0", "v1", "v2", "v3", "test", "randaug"])
def test_policies_and_randaugment_are_jax_bytes(policy):
    for seed in range(12):
        img, boxes = _image_and_boxes(100 + seed)
        if policy == "randaug":
            ours = paa.distort_image_with_randaugment(
                np.random.default_rng(seed), img, boxes, num_layers=2, magnitude=15)
            ref = jaa.distort_image_with_randaugment(
                np.random.default_rng(seed), img, boxes, num_layers=2, magnitude=15)
        else:
            ours = paa.distort_image_with_autoaugment(
                np.random.default_rng(seed), img, boxes, policy)
            ref = jaa.distort_image_with_autoaugment(
                np.random.default_rng(seed), img, boxes, policy)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b), (policy, seed)


def test_mosaic_and_gridmask_match_jax():
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (int(h), int(w), 3), dtype=np.uint8)
            for h, w in rng.integers(20, 60, (4, 2))]
    boxes = [rng.uniform(0, 20, (int(n), 4)) + [0, 0, 10, 10]
             for n in rng.integers(0, 4, 4)]
    classes = [rng.integers(1, 9, len(b)) for b in boxes]
    for seed in range(4):
        ours = paug.mosaic(np.random.default_rng(seed), imgs, boxes, classes, 80)
        ref = jaug.mosaic(np.random.default_rng(seed), imgs, boxes, classes, 80)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    images = rng.uniform(-1, 1, (3, 40, 50, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jaug.gridmask(key, jnp.asarray(images), ratio=0.55,
                                   fill_value=-1.0, d_range=(8, 24)))
    # JAX's own draws (gridmask.py: split into d, off_y, off_x)
    k_d, k_oy, k_ox = jax.random.split(key, 3)
    d = jax.random.randint(k_d, (3, 1, 1), 8, 24)
    oy = jax.random.randint(k_oy, (3, 1, 1), 0, 24)
    ox = jax.random.randint(k_ox, (3, 1, 1), 0, 24)
    got = paug.gridmask_from_draws(torch.from_numpy(images),
                                   *(torch.from_numpy(np.array(v))
                                     for v in (d, oy, ox)),
                                   ratio=0.55, fill_value=-1.0)
    assert np.array_equal(got.numpy(), ref)
    out = paug.gridmask(torch.Generator().manual_seed(0), torch.from_numpy(images),
                        d_range=(8, 24))
    assert out.shape == images.shape and (out == 0).any() and (out != 0).any()
