"""PASCAL VOC annotations -> detection TFRecords (offline dataset tooling).

Port of `mladversarialobjectdetection_tpu/data/create_pascal_tfrecord.py`
(reference dataset/create_pascal_tfrecord.py): walk a VOCdevkit year/set
split, parse each Annotations/*.xml (size, object/name/bndbox/difficult/
truncated), normalize the boxes, and emit sharded tf.Example records in
the COCO converter's layout. Difficult objects can be skipped
(`ignore_difficult_instances`); kept ones are marked in the is_crowd slot,
so readers that skip crowds skip them too.

Pure Python (xml.etree and the wire-format encoder of
`create_coco_tfrecord`): no TF dependency.
"""
from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from ..utils.log import get_logger
from .create_coco_tfrecord import make_example, write_records

logger = get_logger(__name__)

SETS = ("train", "val", "trainval", "test")
YEARS = ("VOC2007", "VOC2012", "merged")

# reference create_pascal_tfrecord.py:41-63
PASCAL_LABEL_MAP: Dict[str, int] = {
    "background": 0, "aeroplane": 1, "bicycle": 2, "bird": 3, "boat": 4,
    "bottle": 5, "bus": 6, "car": 7, "cat": 8, "chair": 9, "cow": 10,
    "diningtable": 11, "dog": 12, "horse": 13, "motorbike": 14,
    "person": 15, "pottedplant": 16, "sheep": 17, "sofa": 18, "train": 19,
    "tvmonitor": 20,
}


def parse_annotation(xml_path: str) -> dict:
    """One VOC Annotations/*.xml -> dict (filename, size, objects)."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    objects = []
    for obj in root.findall("object"):
        bnd = obj.find("bndbox")
        objects.append(dict(
            name=obj.findtext("name", "").strip(),
            difficult=int(obj.findtext("difficult", "0") or 0),
            truncated=int(obj.findtext("truncated", "0") or 0),
            xmin=float(bnd.findtext("xmin")),
            ymin=float(bnd.findtext("ymin")),
            xmax=float(bnd.findtext("xmax")),
            ymax=float(bnd.findtext("ymax")),
        ))
    return dict(
        filename=root.findtext("filename", "").strip(),
        height=int(size.findtext("height")),
        width=int(size.findtext("width")),
        objects=objects)


def example_from_annotation(ann: dict, images_dir: str,
                            label_map: Dict[str, int], source_id: int, *,
                            ignore_difficult_instances: bool = False
                            ) -> Optional[bytes]:
    """VOC annotation dict -> serialized tf.Example (normalized boxes)."""
    img_path = os.path.join(images_dir, ann["filename"])
    if not os.path.exists(img_path):
        logger.warning(f"missing image {img_path}; skipped")
        return None
    with open(img_path, "rb") as f:
        encoded = f.read()
    h, w = ann["height"], ann["width"]
    boxes, classes, crowd = [], [], []
    for obj in ann["objects"]:
        if ignore_difficult_instances and obj["difficult"]:
            continue
        if obj["name"] not in label_map:
            logger.warning(f"unknown label {obj['name']!r}; skipped")
            continue
        boxes.append([obj["ymin"] / h, obj["xmin"] / w,
                      obj["ymax"] / h, obj["xmax"] / w])
        classes.append(label_map[obj["name"]])
        crowd.append(obj["difficult"])
    return make_example(encoded, h, w,
                        np.asarray(boxes, np.float32).reshape(-1, 4),
                        classes, crowd, source_id=str(source_id))


def convert(data_dir: str, output_prefix: str, *, split: str = "train",
            year: str = "VOC2007", annotations_dir: str = "Annotations",
            label_map: Optional[Dict[str, int]] = None,
            ignore_difficult_instances: bool = False,
            num_shards: int = 10, num_images: Optional[int] = None) -> int:
    """Convert a VOCdevkit split to TFRecord shards; returns example count.

    data_dir layout: <data_dir>/<year>/{Annotations,JPEGImages,ImageSets}
    (reference create_pascal_tfrecord.py main flow)."""
    if split not in SETS:
        raise ValueError(f"split must be one of {SETS}")
    years = ["VOC2007", "VOC2012"] if year == "merged" else [year]
    label_map = label_map or PASCAL_LABEL_MAP

    records: List[bytes] = []
    source_id = 0
    for yr in years:
        list_file = os.path.join(data_dir, yr, "ImageSets", "Main",
                                 f"{split}.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                names = [line.split()[0] for line in f if line.strip()]
            xmls = [os.path.join(data_dir, yr, annotations_dir, f"{n}.xml")
                    for n in names]
        else:  # no split list: take every annotation
            xmls = sorted(glob.glob(
                os.path.join(data_dir, yr, annotations_dir, "*.xml")))
        for xml_path in xmls:
            if num_images is not None and source_id >= num_images:
                break
            ann = parse_annotation(xml_path)
            ex = example_from_annotation(
                ann, os.path.join(data_dir, yr, "JPEGImages"), label_map,
                source_id,
                ignore_difficult_instances=ignore_difficult_instances)
            if ex is not None:
                records.append(ex)
                source_id += 1

    num_shards = max(1, min(num_shards, len(records) or 1))
    for shard in range(num_shards):
        path = f"{output_prefix}-{shard:05d}-of-{num_shards:05d}.tfrecord"
        write_records(records[shard::num_shards], path)
    logger.info(f"wrote {len(records)} examples to "
                f"{output_prefix}-*-of-{num_shards:05d}.tfrecord")
    return len(records)


def main():
    import argparse
    p = argparse.ArgumentParser(description="PASCAL VOC -> TFRecord")
    p.add_argument("--data-dir", required=True,
                   help="VOCdevkit root (contains VOC2007/VOC2012)")
    p.add_argument("--set", default="train", choices=SETS)
    p.add_argument("--year", default="VOC2007", choices=YEARS)
    p.add_argument("--annotations-dir", default="Annotations")
    p.add_argument("--output-path", required=True,
                   help="output prefix for shards")
    p.add_argument("--ignore-difficult-instances", action="store_true")
    p.add_argument("--num-shards", type=int, default=10)
    p.add_argument("--num-images", type=int, default=None)
    a = p.parse_args()
    convert(a.data_dir, a.output_path, split=a.set, year=a.year,
            annotations_dir=a.annotations_dir,
            ignore_difficult_instances=a.ignore_difficult_instances,
            num_shards=a.num_shards, num_images=a.num_images)


if __name__ == "__main__":
    main()
