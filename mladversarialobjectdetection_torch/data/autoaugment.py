"""AutoAugment + RandAugment for detection, host-side numpy.

Port of `mladversarialobjectdetection_tpu/data/autoaugment.py:47-470` (the
same code; the reference's aug/autoaugment.py as wired at
dataloader.py:311-319): policies v0/v1/v2/v3/test select one random
sub-policy of (op, probability, magnitude) triples per image; `randaug`
applies `num_layers` uniformly drawn ops at a fixed magnitude. Geometric
ops move the bounding boxes with the pixels; `*_Only_BBoxes` ops transform
only the pixel content INSIDE each box (per box with probability prob/3,
aug/autoaugment.py:486-501), leaving the boxes unchanged. Every random
choice is a call on the caller's `np.random.Generator`, in the JAX
package's order, so a seeded generator gives byte-equal output.

The ops are plain numpy transforms in the host input pipeline, before
batching; the affine, shear and rotate ops warp with cv2, imported inside
them (host CPU only).

Boxes are [N, 4] = (ymin, xmin, ymax, xmax) in PIXELS of the given image.
Magnitudes follow the reference's 0..10 scale; the magnitude->argument
decoding and the op constants (translate_const 250, cutout_const 100,
cutout_bbox_const 50, translate_bbox_const 120, cutout_max_pad_fraction
.75) match aug/autoaugment.py:1431-1477 and 1619-1630. Fill value for
vacated pixels is 128 (replace_value, autoaugment.py:1588).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_MAX_LEVEL = 10.0
_REPLACE = 128

# augmentation_hparams (reference autoaugment.py:1619-1630 / 1637-1644)
CUTOUT_MAX_PAD_FRACTION = 0.75
CUTOUT_BBOX_REPLACE_WITH_MEAN = False
CUTOUT_CONST = 100
TRANSLATE_CONST = 250
CUTOUT_BBOX_CONST = 50
TRANSLATE_BBOX_CONST = 120

# luma weights of tf.image.rgb_to_grayscale (used by Color/Contrast)
_LUMA = np.asarray([0.2989, 0.587, 0.114], np.float32)


# -- pixel-only ops (reference autoaugment.py:170-330, 1063-1180) -----------

def _blend(image1: np.ndarray, image2: np.ndarray, factor: float
           ) -> np.ndarray:
    """blend() parity: image1 + factor * (image2 - image1), clipped."""
    out = image1.astype(np.float32) + factor * (
        image2.astype(np.float32) - image1.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def _grayscale_rgb(img: np.ndarray) -> np.ndarray:
    g = (img.astype(np.float32) @ _LUMA)
    return np.repeat(np.rint(g)[..., None], 3, axis=-1).astype(np.uint8)


def autocontrast(img: np.ndarray) -> np.ndarray:
    """Per-channel min/max rescale (autoaugment.py:1063-1100)."""
    out = img.copy()
    for c in range(3):
        ch = img[..., c]
        lo, hi = float(ch.min()), float(ch.max())
        if hi > lo:
            scale = 255.0 / (hi - lo)
            out[..., c] = np.clip(ch * scale - lo * scale, 0, 255
                                  ).astype(np.uint8)
    return out


def equalize(img: np.ndarray) -> np.ndarray:
    """PIL-style histogram equalize (autoaugment.py:1132-1168): step-based
    LUT, NOT cv2.equalizeHist (which normalizes differently)."""
    out = img.copy()
    for c in range(3):
        ch = img[..., c]
        histo = np.bincount(ch.ravel(), minlength=256).astype(np.int64)
        nonzero = histo[histo != 0]
        step = (int(nonzero.sum()) - int(nonzero[-1])) // 255
        if step == 0:
            continue
        lut = (np.cumsum(histo) + step // 2) // step
        lut = np.concatenate([[0], lut[:-1]])
        out[..., c] = np.clip(lut, 0, 255).astype(np.uint8)[ch]
    return out


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """Keep `bits` high bits (autoaugment.py:1103-1106: right+left shift
    by 8-bits)."""
    shift = 8 - int(bits)
    return ((img >> shift) << shift).astype(np.uint8)


def solarize(img: np.ndarray, threshold: int) -> np.ndarray:
    return np.where(img < threshold, img, 255 - img).astype(np.uint8)


def solarize_add(img: np.ndarray, addition: int,
                 threshold: int = 128) -> np.ndarray:
    added = np.clip(img.astype(np.int64) + addition, 0, 255).astype(np.uint8)
    return np.where(img < threshold, added, img)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(_grayscale_rgb(img), img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img.astype(np.float32) @ _LUMA).astype(np.uint8)
    mean = float(np.mean(gray.astype(np.float32)))
    degenerate = np.full_like(img, int(np.clip(mean, 0, 255)))
    return _blend(degenerate, img, factor)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(np.zeros_like(img), img, factor)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL smoothing kernel [[1,1,1],[1,5,1],[1,1,1]]/13, borders kept
    original (autoaugment.py:1109-1129's VALID conv + pad-with-original)."""
    f = img.astype(np.float32)
    k = np.asarray([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    smooth = np.zeros_like(f)
    for dy in range(3):
        for dx in range(3):
            smooth[1:-1, 1:-1] += k[dy, dx] * f[dy:f.shape[0] - 2 + dy,
                                                dx:f.shape[1] - 2 + dx]
    degenerate = np.clip(smooth, 0, 255).astype(np.uint8)
    degenerate[0, :] = img[0, :]
    degenerate[-1, :] = img[-1, :]
    degenerate[:, 0] = img[:, 0]
    degenerate[:, -1] = img[:, -1]
    return _blend(degenerate, img, factor)


def cutout(rng, img: np.ndarray, pad_size: int,
           replace: int = _REPLACE) -> np.ndarray:
    """(2*pad x 2*pad) mask at a uniform center (autoaugment.py:193-241)."""
    h, w = img.shape[:2]
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    y0, y1 = max(0, cy - pad_size), min(h, cy + pad_size)
    x0, x1 = max(0, cx - pad_size), min(w, cx + pad_size)
    out = img.copy()
    out[y0:y1, x0:x1] = replace
    return out


# -- geometric ops (move boxes with pixels) ---------------------------------

def _affine(img: np.ndarray, boxes: np.ndarray, m: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply a 2x3 affine (x, y convention) to image + boxes; vacated
    pixels filled with the reference replace value 128."""
    import cv2
    h, w = img.shape[:2]
    out = cv2.warpAffine(img, m, (w, h),
                         borderValue=(_REPLACE, _REPLACE, _REPLACE))
    if len(boxes):
        ys = boxes[:, [0, 0, 2, 2]]
        xs = boxes[:, [1, 3, 1, 3]]
        pts = np.stack([xs, ys], axis=-1).reshape(-1, 2)  # [4N, (x,y)]
        ones = np.ones((pts.shape[0], 1))
        new = (np.concatenate([pts, ones], axis=1) @ m.T).reshape(-1, 4, 2)
        new_x, new_y = new[..., 0], new[..., 1]
        boxes = np.stack([new_y.min(1), new_x.min(1),
                          new_y.max(1), new_x.max(1)], axis=1)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, h)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, w)
    return out, boxes.astype(np.float32)


def _translate(img, boxes, dx: float, dy: float):
    m = np.array([[1, 0, dx], [0, 1, dy]], np.float64)
    return _affine(img, boxes, m)


def _shear(img, boxes, sx: float, sy: float):
    m = np.array([[1, sx, 0], [sy, 1, 0]], np.float64)
    return _affine(img, boxes, m)


def _rotate(img, boxes, degrees: float):
    import cv2
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), degrees, 1.0)
    return _affine(img, boxes, m)


# -- bbox-only ops (reference autoaugment.py:486-1060) -----------------------

def _apply_only_bboxes(rng, img: np.ndarray, boxes: np.ndarray, prob: float,
                       region_fn) -> np.ndarray:
    """Apply region_fn to each box's pixel content independently with
    probability `prob` (already scaled by 1/3, autoaugment.py:486-501);
    boxes themselves never change."""
    out = img
    for b in np.asarray(boxes, np.float32).reshape(-1, 4):
        if rng.random() >= prob:
            continue
        h, w = out.shape[:2]
        y0, x0 = int(b[0]), int(b[1])
        y1, x1 = min(int(b[2]), h - 1), min(int(b[3]), w - 1)
        if y1 < y0 or x1 < x0:
            continue
        region = out[y0:y1 + 1, x0:x1 + 1]
        out = out.copy()
        out[y0:y1 + 1, x0:x1 + 1] = region_fn(region)
    return out


def _region_affine(region: np.ndarray, m: np.ndarray) -> np.ndarray:
    import cv2
    h, w = region.shape[:2]
    return cv2.warpAffine(region, m, (w, h),
                          borderValue=(_REPLACE, _REPLACE, _REPLACE))


def bbox_cutout(rng, img: np.ndarray, boxes: np.ndarray,
                pad_fraction: float, replace_with_mean: bool) -> np.ndarray:
    """Cutout sized by one randomly-chosen bbox, centered uniformly inside
    that bbox (autoaugment.py:1218-1347)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    if len(boxes) == 0:
        return img
    h, w = img.shape[:2]
    b = boxes[int(rng.integers(0, len(boxes)))]
    y0, x0 = int(b[0]), int(b[1])
    y1, x1 = min(int(b[2]), h - 1), min(int(b[3]), w - 1)
    if y1 < y0 or x1 < x0:
        return img
    mean = img[y0:y1 + 1, x0:x1 + 1].reshape(-1, 3).mean(0)
    replace = mean.astype(np.uint8) if replace_with_mean else _REPLACE
    pad_h = int(pad_fraction * ((y1 - y0 + 1) / 2))
    pad_w = int(pad_fraction * ((x1 - x0 + 1) / 2))
    cy = int(rng.integers(y0, y1 + 1))
    cx = int(rng.integers(x0, x1 + 1))
    out = img.copy()
    out[max(0, cy - pad_h):min(h, cy + pad_h),
        max(0, cx - pad_w):min(w, cx + pad_w)] = replace
    return out


# -- magnitude decoding (reference level_to_arg, autoaugment.py:1431-1477) ---

def _enhance_factor(level: float) -> float:
    return level / _MAX_LEVEL * 1.8 + 0.1


def _maybe_negate(rng, v: float) -> float:
    return -v if rng.random() < 0.5 else v


def _apply_op(rng, img, boxes, name: str, level: float, prob: float):
    """Dispatch one (op, prob, level). For whole-image ops the caller has
    already rolled `prob`; *_Only_BBoxes ops consume prob/3 per box."""
    del_prob = prob / 3.0  # bbox-only probability scaling
    if name == "AutoContrast":
        return autocontrast(img), boxes
    if name == "Equalize":
        return equalize(img), boxes
    if name == "Posterize":
        return posterize(img, int(level / _MAX_LEVEL * 4)), boxes
    if name == "Solarize":
        return solarize(img, int(level / _MAX_LEVEL * 256)), boxes
    if name == "SolarizeAdd":
        return solarize_add(img, int(level / _MAX_LEVEL * 110)), boxes
    if name == "Color":
        return color(img, _enhance_factor(level)), boxes
    if name == "Contrast":
        return contrast(img, _enhance_factor(level)), boxes
    if name == "Brightness":
        return brightness(img, _enhance_factor(level)), boxes
    if name == "Sharpness":
        return sharpness(img, _enhance_factor(level)), boxes
    if name == "Cutout":
        return cutout(rng, img, int(level / _MAX_LEVEL * CUTOUT_CONST)), boxes
    if name == "BBox_Cutout":
        pad_fraction = level / _MAX_LEVEL * CUTOUT_MAX_PAD_FRACTION
        return bbox_cutout(rng, img, boxes, pad_fraction,
                           CUTOUT_BBOX_REPLACE_WITH_MEAN), boxes

    if name == "TranslateX_BBox":
        px = _maybe_negate(rng, level / _MAX_LEVEL * TRANSLATE_CONST)
        return _translate(img, boxes, px, 0)
    if name == "TranslateY_BBox":
        px = _maybe_negate(rng, level / _MAX_LEVEL * TRANSLATE_CONST)
        return _translate(img, boxes, 0, px)
    if name == "ShearX_BBox":
        return _shear(img, boxes,
                      _maybe_negate(rng, level / _MAX_LEVEL * 0.3), 0)
    if name == "ShearY_BBox":
        return _shear(img, boxes, 0,
                      _maybe_negate(rng, level / _MAX_LEVEL * 0.3))
    if name == "Rotate_BBox":
        return _rotate(img, boxes,
                       _maybe_negate(rng, level / _MAX_LEVEL * 30.0))

    # bbox-only content ops (boxes unchanged, prob/3 per box)
    if name == "Flip_Only_BBoxes":
        return _apply_only_bboxes(rng, img, boxes, del_prob,
                                  lambda r: r[:, ::-1]), boxes
    if name == "Equalize_Only_BBoxes":
        return _apply_only_bboxes(rng, img, boxes, del_prob, equalize), boxes
    if name == "Solarize_Only_BBoxes":
        thr = int(level / _MAX_LEVEL * 256)
        return _apply_only_bboxes(rng, img, boxes, del_prob,
                                  lambda r: solarize(r, thr)), boxes
    if name == "Cutout_Only_BBoxes":
        pad = int(level / _MAX_LEVEL * CUTOUT_BBOX_CONST)
        return _apply_only_bboxes(rng, img, boxes, del_prob,
                                  lambda r: cutout(rng, r, pad)), boxes
    if name == "Rotate_Only_BBoxes":
        deg = _maybe_negate(rng, level / _MAX_LEVEL * 30.0)

        def rot(r):
            import cv2
            h, w = r.shape[:2]
            m = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
            return _region_affine(r, m)
        return _apply_only_bboxes(rng, img, boxes, del_prob, rot), boxes
    if name in ("ShearX_Only_BBoxes", "ShearY_Only_BBoxes"):
        s = _maybe_negate(rng, level / _MAX_LEVEL * 0.3)
        horiz = name.startswith("ShearX")
        m = (np.array([[1, s, 0], [0, 1, 0]], np.float64) if horiz
             else np.array([[1, 0, 0], [s, 1, 0]], np.float64))
        return _apply_only_bboxes(rng, img, boxes, del_prob,
                                  lambda r: _region_affine(r, m)), boxes
    if name in ("TranslateX_Only_BBoxes", "TranslateY_Only_BBoxes"):
        px = _maybe_negate(rng, level / _MAX_LEVEL * TRANSLATE_BBOX_CONST)
        horiz = name.startswith("TranslateX")
        m = (np.array([[1, 0, px], [0, 1, 0]], np.float64) if horiz
             else np.array([[1, 0, 0], [0, 1, px]], np.float64))
        return _apply_only_bboxes(rng, img, boxes, del_prob,
                                  lambda r: _region_affine(r, m)), boxes
    raise ValueError(f"unknown op {name}")


# -- policy tables (reference autoaugment.py:37-150, verbatim triples) -------

POLICY_V0: List[List[Tuple[str, float, float]]] = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
]

POLICY_V1: List[List[Tuple[str, float, float]]] = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
    [("Color", 0.0, 0), ("ShearX_Only_BBoxes", 0.8, 4)],
    [("ShearY_Only_BBoxes", 0.8, 2), ("Flip_Only_BBoxes", 0.0, 10)],
    [("Equalize", 0.6, 10), ("TranslateX_BBox", 0.2, 2)],
    [("Color", 1.0, 10), ("TranslateY_Only_BBoxes", 0.4, 6)],
    [("Rotate_BBox", 0.8, 10), ("Contrast", 0.0, 10)],
    [("Cutout", 0.2, 2), ("Brightness", 0.8, 10)],
    [("Color", 1.0, 6), ("Equalize", 1.0, 2)],
    [("Cutout_Only_BBoxes", 0.4, 6), ("TranslateY_Only_BBoxes", 0.8, 2)],
    [("Color", 0.2, 8), ("Rotate_BBox", 0.8, 10)],
    [("Sharpness", 0.4, 4), ("TranslateY_Only_BBoxes", 0.0, 4)],
    [("Sharpness", 1.0, 4), ("SolarizeAdd", 0.4, 4)],
    [("Rotate_BBox", 1.0, 8), ("Sharpness", 0.2, 8)],
    [("ShearY_BBox", 0.6, 10), ("Equalize_Only_BBoxes", 0.6, 8)],
    [("ShearX_BBox", 0.2, 6), ("TranslateY_Only_BBoxes", 0.2, 10)],
    [("SolarizeAdd", 0.6, 8), ("Brightness", 0.8, 10)],
]

POLICY_V2: List[List[Tuple[str, float, float]]] = [
    [("Color", 0.0, 6), ("Cutout", 0.6, 8), ("Sharpness", 0.4, 8)],
    [("Rotate_BBox", 0.4, 8), ("Sharpness", 0.4, 2),
     ("Rotate_BBox", 0.8, 10)],
    [("TranslateY_BBox", 1.0, 8), ("AutoContrast", 0.8, 2)],
    [("AutoContrast", 0.4, 6), ("ShearX_BBox", 0.8, 8),
     ("Brightness", 0.0, 10)],
    [("SolarizeAdd", 0.2, 6), ("Contrast", 0.0, 10),
     ("AutoContrast", 0.6, 0)],
    [("Cutout", 0.2, 0), ("Solarize", 0.8, 8), ("Color", 1.0, 4)],
    [("TranslateY_BBox", 0.0, 4), ("Equalize", 0.6, 8),
     ("Solarize", 0.0, 10)],
    [("TranslateY_BBox", 0.2, 2), ("ShearY_BBox", 0.8, 8),
     ("Rotate_BBox", 0.8, 8)],
    [("Cutout", 0.8, 8), ("Brightness", 0.8, 8), ("Cutout", 0.2, 2)],
    [("Color", 0.8, 4), ("TranslateY_BBox", 1.0, 6), ("Rotate_BBox", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("BBox_Cutout", 1.0, 4), ("Cutout", 0.2, 8)],
    [("Rotate_BBox", 0.0, 0), ("Equalize", 0.6, 6), ("ShearY_BBox", 0.6, 8)],
    [("Brightness", 0.8, 8), ("AutoContrast", 0.4, 2),
     ("Brightness", 0.2, 2)],
    [("TranslateY_BBox", 0.4, 8), ("Solarize", 0.4, 6),
     ("SolarizeAdd", 0.2, 10)],
    [("Contrast", 1.0, 10), ("SolarizeAdd", 0.2, 8), ("Equalize", 0.2, 4)],
]

POLICY_V3: List[List[Tuple[str, float, float]]] = [
    [("Posterize", 0.8, 2), ("TranslateX_BBox", 1.0, 8)],
    [("BBox_Cutout", 0.2, 10), ("Sharpness", 1.0, 8)],
    [("Rotate_BBox", 0.6, 8), ("Rotate_BBox", 0.8, 10)],
    [("Equalize", 0.8, 10), ("AutoContrast", 0.2, 10)],
    [("SolarizeAdd", 0.2, 2), ("TranslateY_BBox", 0.2, 8)],
    [("Sharpness", 0.0, 2), ("Color", 0.4, 8)],
    [("Equalize", 1.0, 8), ("TranslateY_BBox", 1.0, 8)],
    [("Posterize", 0.6, 2), ("Rotate_BBox", 0.0, 10)],
    [("AutoContrast", 0.6, 0), ("Rotate_BBox", 1.0, 6)],
    [("Equalize", 0.0, 4), ("Cutout", 0.8, 10)],
    [("Brightness", 1.0, 2), ("TranslateY_BBox", 1.0, 6)],
    [("Contrast", 0.0, 2), ("ShearY_BBox", 0.8, 0)],
    [("AutoContrast", 0.8, 10), ("Contrast", 0.2, 10)],
    [("Rotate_BBox", 1.0, 10), ("Cutout", 1.0, 10)],
    [("SolarizeAdd", 0.8, 6), ("Equalize", 0.8, 8)],
]

POLICY_VTEST: List[List[Tuple[str, float, float]]] = [
    [("TranslateX_BBox", 1.0, 4), ("Equalize", 1.0, 10)],
]

POLICIES: Dict[str, list] = {"v0": POLICY_V0, "v1": POLICY_V1,
                             "v2": POLICY_V2, "v3": POLICY_V3,
                             "test": POLICY_VTEST}

_BBOX_ONLY = frozenset(n for p in POLICIES.values() for sp in p
                       for n, _, _ in sp if "Only_BBoxes" in n)

# RandAugment op pool (autoaugment.py:1646-1649)
RANDAUG_OPS = ["Equalize", "Solarize", "Color", "Cutout", "SolarizeAdd",
               "TranslateX_BBox", "TranslateY_BBox", "ShearX_BBox",
               "ShearY_BBox", "Rotate_BBox"]


def distort_image_with_autoaugment(
        rng: np.random.Generator, image: np.ndarray, boxes: np.ndarray,
        policy_name: str = "v0") -> Tuple[np.ndarray, np.ndarray]:
    """Apply one randomly-chosen sub-policy (reference
    distort_image_with_autoaugment, autoaugment.py:1592-1630). Image uint8
    RGB; boxes [N, 4] in pixels."""
    policy = POLICIES[policy_name]
    sub = policy[rng.integers(0, len(policy))]
    img = image
    bxs = np.asarray(boxes, np.float32).reshape(-1, 4)
    for name, prob, level in sub:
        if "Only_BBoxes" in name:
            # per-box probability (prob/3) is rolled inside the op
            img, bxs = _apply_op(rng, img, bxs, name, float(level), prob)
        elif rng.random() < prob:
            img, bxs = _apply_op(rng, img, bxs, name, float(level), prob)
    return img, bxs


def distort_image_with_randaugment(
        rng: np.random.Generator, image: np.ndarray, boxes: np.ndarray,
        num_layers: int = 1, magnitude: float = 15.0
        ) -> Tuple[np.ndarray, np.ndarray]:
    """RandAugment for detection (autoaugment.py:1632-1667): `num_layers`
    uniformly-chosen ops at fixed magnitude; the dataloader wires
    num_layers=1, magnitude=15 for policy 'randaug' (dataloader.py:314-316).
    The reference rolls a per-op prob U(.2,.8) but applies the selected op
    unconditionally (the prob only feeds bbox-only scaling, and no bbox-only
    op is in the RandAugment pool) — reproduced here by applying directly."""
    img = image
    bxs = np.asarray(boxes, np.float32).reshape(-1, 4)
    for _ in range(num_layers):
        name = RANDAUG_OPS[rng.integers(0, len(RANDAUG_OPS))]
        prob = float(rng.uniform(0.2, 0.8))
        img, bxs = _apply_op(rng, img, bxs, name, float(magnitude), prob)
    return img, bxs
