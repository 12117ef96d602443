"""COCO annotations -> detection TFRecords (offline dataset tooling).

Port of `mladversarialobjectdetection_tpu/data/create_coco_tfrecord.py`
(the reference's automl dataset/create_coco_tfrecord.py role): read a COCO
instances json and an image directory, emit TFRecord shards of tf.Example
records that `data/tfrecord.DetectionTFRecordReader` (and the reference's
own reader) read. Pure Python: the records are assembled directly in
protobuf wire format, byte-equal to the JAX package's.
"""
from __future__ import annotations

import json
import os
import struct
from typing import List

import numpy as np

from ..utils.log import get_logger

logger = get_logger(__name__)


def _varint(x: int) -> bytes:
    out = b""
    while True:
        b7 = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _feature_bytes(vals: List[bytes]) -> bytes:
    return _field(1, b"".join(_field(1, v) for v in vals))


def _feature_floats(vals: List[float]) -> bytes:
    packed = struct.pack(f"<{len(vals)}f", *vals)
    return _field(2, _varint((1 << 3) | 2) + _varint(len(packed)) + packed)


def _feature_ints(vals: List[int]) -> bytes:
    packed = b"".join(_varint(int(v)) for v in vals)
    return _field(3, _varint((1 << 3) | 2) + _varint(len(packed)) + packed)


def _entry(key: str, feat: bytes) -> bytes:
    return _field(1, _field(1, key.encode()) + _field(2, feat))


def make_example(encoded_image: bytes, height: int, width: int,
                 boxes_norm: np.ndarray, classes: List[int],
                 is_crowd: List[int], source_id: str = "0") -> bytes:
    """Serialize one detection tf.Example (normalized [ymin,xmin,ymax,xmax])."""
    boxes_norm = np.asarray(boxes_norm, np.float32).reshape(-1, 4)
    feats = (
        _entry("image/encoded", _feature_bytes([encoded_image]))
        + _entry("image/source_id", _feature_bytes([source_id.encode()]))
        + _entry("image/height", _feature_ints([height]))
        + _entry("image/width", _feature_ints([width]))
        + _entry("image/object/bbox/ymin", _feature_floats(boxes_norm[:, 0].tolist()))
        + _entry("image/object/bbox/xmin", _feature_floats(boxes_norm[:, 1].tolist()))
        + _entry("image/object/bbox/ymax", _feature_floats(boxes_norm[:, 2].tolist()))
        + _entry("image/object/bbox/xmax", _feature_floats(boxes_norm[:, 3].tolist()))
        + _entry("image/object/class/label", _feature_ints(list(classes)))
        + _entry("image/object/is_crowd", _feature_ints(list(is_crowd)))
    )
    return _field(1, feats)


def write_records(records: List[bytes], path: str) -> None:
    """Write framed records with valid masked CRC32Cs — the output must be
    readable by TF's own (CRC-verifying) TFRecordDataset."""
    from .tfrecord import frame_record
    with open(path, "wb") as f:
        for rec in records:
            f.write(frame_record(rec))


def convert(annotation_file: str, image_dir: str, output_prefix: str, *,
            num_shards: int = 8, limit: int | None = None) -> int:
    """COCO instances json + images -> TFRecord shards. Returns #examples."""
    with open(annotation_file) as f:
        coco = json.load(f)
    anns_by_img: dict = {}
    for ann in coco["annotations"]:
        anns_by_img.setdefault(ann["image_id"], []).append(ann)

    shards: List[List[bytes]] = [[] for _ in range(num_shards)]
    n = 0
    for img_info in coco["images"][:limit]:
        path = os.path.join(image_dir, img_info["file_name"])
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            encoded = f.read()
        h, w = img_info["height"], img_info["width"]
        boxes, classes, crowd = [], [], []
        for ann in anns_by_img.get(img_info["id"], []):
            x, y, bw, bh = ann["bbox"]
            boxes.append([y / h, x / w, (y + bh) / h, (x + bw) / w])
            classes.append(ann["category_id"])
            crowd.append(int(ann.get("iscrowd", 0)))
        rec = make_example(encoded, h, w,
                           np.asarray(boxes or np.zeros((0, 4))),
                           classes, crowd, str(img_info["id"]))
        shards[n % num_shards].append(rec)
        n += 1
    for i, shard in enumerate(shards):
        write_records(shard,
                      f"{output_prefix}-{i:05d}-of-{num_shards:05d}.tfrecord")
    logger.info(f"wrote {n} examples into {num_shards} shards")
    return n


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="COCO -> TFRecord converter")
    p.add_argument("--annotations", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--output-prefix", required=True)
    p.add_argument("--num-shards", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    a = p.parse_args()
    convert(a.annotations, a.image_dir, a.output_prefix,
            num_shards=a.num_shards, limit=a.limit)
