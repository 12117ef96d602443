"""Pure-python TFRecord + tf.Example reading for supervised training data.

Port of `mladversarialobjectdetection_tpu/data/tfrecord.py` (reference
dataloader.py:236-459 `InputReader` and object_detection/
tf_example_decoder.py): iterate TFRecord shards, decode tf.Example
detection records (image/encoded, image/object/bbox/*,
image/object/class/label, image/object/is_crowd), and yield fixed-shape
padded training batches as numpy arrays, byte-equal to the JAX package's
for the same files, seed, shard and policy.

No TensorFlow dependency: the TFRecord framing and the protobuf wire
format of tf.Example are decoded directly. Record framing rides the port's
native C reader (`csrc/tfrecord_native.c`, masked-CRC32C validation; the
analog of tf.data's C++ TFRecordDataset) once `_build.build_tfrecord_native`
has built it; nothing builds it at import, and without it a pure-python
reader (CRCs unverified on read) keeps the package dependency-free.
Writers always emit valid CRCs, so the output is readable by TF itself.

The image decode (`decode_detection_example`, PIL) and the autoaugment
warps (cv2) import their libraries inside the functions that need them:
TFRecord images are decoded on the host CPU only.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .. import _build


def _native():
    """The native reader module if it has been built, else None."""
    return _build.load_tfrecord_native()


def _crc32c_py(data: bytes) -> int:
    """Table-driven CRC32C (Castagnoli); used only when the native
    extension is absent (writing is offline tooling, speed is fine)."""
    table = _crc32c_py.table
    if table is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            table.append(c)
        _crc32c_py.table = table
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


_crc32c_py.table = None


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC (tensorflow/core/lib/hash/crc32c.h)."""
    native = _native()
    c = native.crc32c(data) if native is not None else _crc32c_py(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(payload: bytes) -> bytes:
    """One TFRecord frame with valid CRCs (readable by TF itself)."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


# -- TFRecord framing -------------------------------------------------------

def read_tfrecord_file(path: str) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file.

    Uses the native CRC-validating reader when built; pure-python
    (CRCs skipped) otherwise."""
    native = _native()
    if native is not None:
        yield from native.read_records(path)
        return
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc (unverified in the python fallback)
            payload = f.read(length)
            if len(payload) < length:
                return
            f.read(4)  # payload crc (unverified in the python fallback)
            yield payload


# -- protobuf wire format (just enough for tf.Example) ----------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    """Feature { bytes_list=1 | float_list=2 | int64_list=3 }."""
    for field, _, val in _iter_fields(buf):
        if field == 1:  # BytesList { repeated bytes value = 1 }
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList { repeated float value = 1 [packed] }
            out: List[float] = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    out.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:  # Int64List { repeated int64 value = 1 [packed] }
            out = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out.append(x)
                else:
                    out.append(v)
            return out
    return []


def parse_example(payload: bytes) -> Dict[str, list]:
    """tf.Example bytes -> {feature_name: list of values}."""
    features: Dict[str, list] = {}
    for field, _, val in _iter_fields(payload):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            feat = None
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    feat = _parse_feature(v3)
            if key is not None:
                features[key] = feat if feat is not None else []
    return features


# -- detection example decoding --------------------------------------------

def decode_detection_example(example: Dict[str, list]) -> dict:
    """tf.Example features -> {image (decoded RGB), boxes [G,4] normalized,
    classes [G]} (tf_example_decoder parity)."""
    import io

    from PIL import Image

    encoded = example["image/encoded"][0]
    img = Image.open(io.BytesIO(encoded))
    if img.mode != "RGB":
        img = img.convert("RGB")
    image = np.asarray(img)

    ymin = np.asarray(example.get("image/object/bbox/ymin", []), np.float32)
    xmin = np.asarray(example.get("image/object/bbox/xmin", []), np.float32)
    ymax = np.asarray(example.get("image/object/bbox/ymax", []), np.float32)
    xmax = np.asarray(example.get("image/object/bbox/xmax", []), np.float32)
    boxes = np.stack([ymin, xmin, ymax, xmax], axis=-1) if len(ymin) else (
        np.zeros((0, 4), np.float32))
    classes = np.asarray(example.get("image/object/class/label", []),
                         np.int64)
    is_crowd = np.asarray(example.get("image/object/is_crowd", []), np.int64)
    return {"image": image, "boxes": boxes, "classes": classes,
            "is_crowd": is_crowd}


class DetectionTFRecordReader:
    """Padded supervised training batches from TFRecord shards
    (InputReader parity, dataloader.py:404-459)."""

    def __init__(self, file_pattern: str, *, image_size, mean_rgb, stddev_rgb,
                 max_instances: int = 100, skip_crowd: bool = True,
                 shuffle: bool = True, seed: int = 0,
                 autoaugment_policy: str | None = None,
                 shard: tuple[int, int] | None = None):
        import glob

        from ..utils.image import parse_image_size
        self.files = sorted(glob.glob(file_pattern))
        if not self.files:
            raise FileNotFoundError(file_pattern)
        # (index, count): multi-host input sharding — this reader yields
        # only its 1/count disjoint slice of the dataset (whole files when
        # there are >= count of them, else every count-th example). Train
        # drivers pass (process index, process count).
        self.shard = shard
        if shard is not None:
            idx, cnt = shard
            if not (0 <= idx < cnt):
                raise ValueError(f"bad shard {shard}")
        self.image_size = parse_image_size(image_size)
        self.mean_rgb = mean_rgb
        self.stddev_rgb = stddev_rgb
        self.max_instances = max_instances
        self.skip_crowd = skip_crowd
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        # 'v0'..'v3'/'test' policy or 'randaug' (dataloader.py:312-319)
        self.autoaugment_policy = autoaugment_policy

    def _examples(self) -> Iterator[dict]:
        files = list(self.files)
        ex_idx, ex_cnt = 0, 1
        if self.shard is not None:
            idx, cnt = self.shard
            if len(files) >= cnt:
                files = files[idx::cnt]
            else:
                ex_idx, ex_cnt = idx, cnt  # fall back to example striding
        if self.shuffle:
            self.rng.shuffle(files)
        n = 0
        for path in files:
            for payload in read_tfrecord_file(path):
                if n % ex_cnt == ex_idx:
                    yield decode_detection_example(parse_example(payload))
                n += 1

    def batches(self, batch_size: int) -> Iterator[dict]:
        """Yield {'images' [B,H,W,3], 'boxes' [B,G,4] px, 'classes' [B,G]
        (0-based model ids), 'valid' [B,G], 'is_crowd' [B,G]} forever.
        With skip_crowd=False, crowd annotations stay in the batch and are
        flagged in 'is_crowd' so COCO eval can treat them as ignore
        regions (COCOEvaluator.add_image gt_is_crowd)."""
        from ..ops.preprocess import preprocess_host

        g = self.max_instances
        while True:
            batch_imgs, batch_boxes, batch_cls = [], [], []
            batch_valid, batch_crowd = [], []
            for ex in self._examples():
                boxes, classes = ex["boxes"], ex["classes"]
                crowd = (np.asarray(ex["is_crowd"], np.int64)
                         if len(ex["is_crowd"])
                         else np.zeros(len(boxes), np.int64))
                if self.skip_crowd and len(ex["is_crowd"]):
                    keep = ex["is_crowd"] == 0
                    boxes, classes = boxes[keep], classes[keep]
                    crowd = crowd[keep]
                h, w = ex["image"].shape[:2]
                raw = ex["image"]
                raw_px_boxes = boxes * np.asarray([h, w, h, w], np.float32)
                if self.autoaugment_policy:
                    from . import autoaugment as aa
                    if self.autoaugment_policy == "randaug":
                        raw, raw_px_boxes = aa.distort_image_with_randaugment(
                            self.rng, raw, raw_px_boxes,
                            num_layers=1, magnitude=15)
                    else:
                        raw, raw_px_boxes = aa.distort_image_with_autoaugment(
                            self.rng, raw, raw_px_boxes,
                            self.autoaugment_policy)
                img, _ = preprocess_host(raw, self.image_size,
                                         self.mean_rgb, self.stddev_rgb)
                scale = min(self.image_size[0] / h, self.image_size[1] / w)
                px_boxes = raw_px_boxes * scale

                n = min(len(px_boxes), g)
                pb = np.zeros((g, 4), np.float32)
                pc = np.zeros((g,), np.int32)
                pv = np.zeros((g,), bool)
                pw = np.zeros((g,), bool)
                pb[:n] = px_boxes[:n]
                pc[:n] = classes[:n] - 1  # 1-based labels -> 0-based model ids
                pv[:n] = True
                pw[:n] = crowd[:n] != 0
                batch_imgs.append(img)
                batch_boxes.append(pb)
                batch_cls.append(pc)
                batch_valid.append(pv)
                batch_crowd.append(pw)
                if len(batch_imgs) == batch_size:
                    yield {"images": np.stack(batch_imgs),
                           "boxes": np.stack(batch_boxes),
                           "classes": np.stack(batch_cls),
                           "valid": np.stack(batch_valid),
                           "is_crowd": np.stack(batch_crowd)}
                    batch_imgs, batch_boxes, batch_cls = [], [], []
                    batch_valid, batch_crowd = [], []


def write_fake_tfrecord(path: str, n: int = 1, image_hw=(64, 64)) -> None:
    """Write a tiny synthetic detection TFRecord (test fixture; the analog
    of the reference's test_util.make_fake_tfrecord, test_util.py:22-65)."""
    import io

    from PIL import Image

    def varint(x: int) -> bytes:
        out = b""
        while True:
            b7 = x & 0x7F
            x >>= 7
            if x:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def field(num: int, payload: bytes) -> bytes:
        return varint((num << 3) | 2) + varint(len(payload)) + payload

    def feature_bytes(vals: List[bytes]) -> bytes:
        inner = b"".join(field(1, v) for v in vals)
        return field(1, inner)

    def feature_floats(vals: List[float]) -> bytes:
        packed = struct.pack(f"<{len(vals)}f", *vals)
        float_list = varint((1 << 3) | 2) + varint(len(packed)) + packed
        return field(2, float_list)

    def feature_ints(vals: List[int]) -> bytes:
        packed = b"".join(varint(v) for v in vals)
        return field(3, varint((1 << 3) | 2) + varint(len(packed)) + packed)

    def entry(key: str, feat: bytes) -> bytes:
        return field(1, field(1, key.encode()) + field(2, feat))

    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        for _ in range(n):
            img = Image.fromarray(
                rng.integers(0, 255, (*image_hw, 3), dtype=np.uint8))
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            feats = (
                entry("image/encoded", feature_bytes([buf.getvalue()]))
                + entry("image/object/bbox/ymin", feature_floats([0.1]))
                + entry("image/object/bbox/xmin", feature_floats([0.1]))
                + entry("image/object/bbox/ymax", feature_floats([0.6]))
                + entry("image/object/bbox/xmax", feature_floats([0.5]))
                + entry("image/object/class/label", feature_ints([1]))
                + entry("image/object/is_crowd", feature_ints([0]))
            )
            example = field(1, feats)
            f.write(frame_record(example))
