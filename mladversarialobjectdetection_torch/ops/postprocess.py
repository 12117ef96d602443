"""Anchor decode + global NMS postprocessing, fixed shapes.

Port of `mladversarialobjectdetection_tpu/ops/postprocess.py`:
`merge_class_box_level_outputs`, `pre_nms`, `clip_boxes`, `_pre_nms_select`
(whose exact `top_k_stable` also serves `pre_nms_approx_topk`),
`nms_kwargs_from_config`, and the four post modes
`postprocess_global`, `postprocess_per_class`, `postprocess_combined` and
`postprocess_tflite` (with `pre_nms_multiclass`,
`decode_anchors_to_centersize`, `tflite_pre_nms` and
`tflite_detections_from_pre`). Every mode's NMS goes through
`nms.batched_nms_auto`, so through the CUDA kernel on the card.

Head outputs come in the JAX layout, per level [B, h, w, A * C], so the
merged anchor order is the JAX package's.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from . import nms as nms_ops
from .anchors import Anchors, decode_box_outputs
from ..utils.image import parse_image_size

CLASS_OFFSET = 1


class Detections(NamedTuple):
    """Padded per-image detections (all [B, M, ...] / [B, M] / [B])."""
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    valid_len: torch.Tensor


@functools.lru_cache(maxsize=16)
def _anchor_tensor(min_level, max_level, num_scales, aspect_ratios,
                   anchor_scale, image_size, device: str) -> torch.Tensor:
    return torch.from_numpy(Anchors(min_level, max_level, num_scales,
                                    aspect_ratios, anchor_scale,
                                    image_size).boxes).to(device)


def anchor_boxes(params, device) -> torch.Tensor:
    """The config's anchors [A, 4] on `device`, uploaded once per config."""
    scale = params["anchor_scale"]
    scale = tuple(scale) if isinstance(scale, (list, tuple)) else float(scale)
    return _anchor_tensor(params["min_level"], params["max_level"],
                          params["num_scales"], tuple(params["aspect_ratios"]),
                          scale, parse_image_size(params["image_size"]),
                          str(device))


def _get(cfg, key):
    return cfg.get(key) if hasattr(cfg, "get") else cfg[key]


def merge_class_box_level_outputs(
        params, cls_outputs: Sequence[torch.Tensor],
        box_outputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concat all levels into [B, A, num_classes] and [B, A, 4]."""
    num_classes = params["num_classes"]
    cls_all: List[torch.Tensor] = []
    box_all: List[torch.Tensor] = []
    batch = cls_outputs[0].shape[0]
    for level in range(0, params["max_level"] - params["min_level"] + 1):
        cls_all.append(cls_outputs[level].reshape(batch, -1, num_classes))
        box_all.append(box_outputs[level].reshape(batch, -1, 4))
    return torch.cat(cls_all, dim=1), torch.cat(box_all, dim=1)


def pre_nms(params, cls_outputs: Sequence[torch.Tensor],
            box_outputs: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode all anchors; per-anchor max class (max_reduce mode).

    Returns (boxes [B,A,4], scores [B,A] sigmoid, classes [B,A] int32) with
    classes NOT yet offset (person == 0).
    """
    cls_merged, box_merged = merge_class_box_level_outputs(
        params, cls_outputs, box_outputs)
    classes = torch.argmax(cls_merged, dim=-1).to(torch.int32)
    logits = torch.amax(cls_merged, dim=-1)
    boxes = decode_box_outputs(box_merged,
                               anchor_boxes(params, box_merged.device)[None])
    return boxes, torch.sigmoid(logits), classes


def clip_boxes(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip boxes into the image (reference postprocess.py:61-64)."""
    h, w = parse_image_size(image_size)
    hi = torch.tensor([h, w, h, w], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(torch.clamp_min(boxes, 0.0), hi)


def top_k_stable(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores per row, the lower index first among equal scores.

    Hazard: `jax.lax.top_k` breaks ties by index; `torch.topk` promises no
    tie order on either device. The fp32 sigmoid scores of 76,725 anchors
    tie often near 0.01, so a stable descending sort is used instead.

    It is also the port's answer to `nms_configs.pre_nms_approx_topk`
    (`_select_topk`, postprocess.py:84-106): the JAX package then calls
    `lax.approx_max_k`, which maps onto the TPU's partial-reduce unit and
    lowers to an exact top-k everywhere else. The port has no approximate
    top-k; both settings select these candidates, which JAX's approximate
    selection on the CPU agrees with, ties included
    (tests/test_torch_postprocess.py).
    """
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _pre_nms_select(params, cls_outputs: Sequence[torch.Tensor],
                    box_outputs: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k candidate selection BEFORE box decode (postprocess.py:109-144).

    Box decode is per-anchor elementwise, so selecting first and decoding
    only the K winners equals decoding everything and then selecting.
    Returns (top_boxes [B,K,4] decoded, top_scores [B,K] sigmoid,
    top_classes [B,K] int32, NOT class-offset).
    """
    nms_cfg = params["nms_configs"]
    cls_merged, box_merged = merge_class_box_level_outputs(
        params, cls_outputs, box_outputs)
    classes = torch.argmax(cls_merged, dim=-1).to(torch.int32)   # [B, A]
    scores = torch.sigmoid(torch.amax(cls_merged, dim=-1))       # [B, A]
    topk = min(int(_get(nms_cfg, "pre_nms_topk") or 1024), scores.shape[1])

    top_scores, top_idx = top_k_stable(scores, topk)              # [B, K]
    top_enc = torch.gather(box_merged, 1, top_idx[..., None].expand(-1, -1, 4))
    top_boxes = decode_box_outputs(
        top_enc, anchor_boxes(params, box_merged.device)[top_idx])
    top_classes = torch.gather(classes, 1, top_idx)
    return top_boxes, top_scores, top_classes


def nms_kwargs_from_config(nms_configs) -> dict:
    """Translate a config nms_configs block into batched_nms kwargs."""
    return dict(
        method=_get(nms_configs, "method") or "hard",
        iou_thresh=_get(nms_configs, "iou_thresh"),
        score_thresh=_get(nms_configs, "score_thresh"),
        sigma=_get(nms_configs, "sigma"),
        max_output_size=int(_get(nms_configs, "max_output_size") or 100),
    )


def postprocess_global(params, cls_outputs, box_outputs,
                       image_scales=None) -> Detections:
    """Global (class-agnostic) NMS postprocessing (postprocess.py:159-178).

    NMS goes through `batched_nms_auto`: the CUDA kernel on the card, the
    plain version on the CPU.
    """
    top_boxes, top_scores, top_classes = _pre_nms_select(
        params, list(cls_outputs), list(box_outputs))
    kw = nms_kwargs_from_config(params["nms_configs"])
    res = nms_ops.batched_nms_auto(top_boxes.contiguous(),
                                   top_scores.contiguous(), **kw)
    out_boxes = clip_boxes(res.boxes, params["image_size"])
    out_classes = ((torch.gather(top_classes, 1, res.indices.long())
                    + CLASS_OFFSET) * res.valid)
    if image_scales is not None:
        scales = torch.as_tensor(image_scales, device=out_boxes.device)
        out_boxes = out_boxes * scales.reshape(-1, 1, 1).to(out_boxes.dtype)
    return Detections(out_boxes, res.scores, out_classes.to(torch.float32),
                      res.valid, res.valid_len)


def _unshift(res, top_classes, offset):
    """(classes [B, M] of the winners, their boxes moved back out of their
    class band and zeroed where invalid)."""
    sel_classes = torch.gather(top_classes, 1, res.indices.long())
    valid = res.valid[..., None].to(res.boxes.dtype)
    boxes = res.boxes - (sel_classes[..., None].to(res.boxes.dtype) * offset) * valid
    return sel_classes, boxes * valid


def _class_shift(top_boxes, top_classes):
    """(shifted boxes, offset): each class's boxes moved into a band of its
    own, so that boxes of different classes never overlap in one NMS pass."""
    offset = (torch.amax(top_boxes) - torch.amin(top_boxes) + 1.0).to(top_boxes.dtype)
    return top_boxes + top_classes[..., None].to(top_boxes.dtype) * offset, offset


def _scale(boxes, image_scales):
    if image_scales is None:
        return boxes
    scales = torch.as_tensor(image_scales, device=boxes.device)
    return boxes * scales.reshape(-1, 1, 1).to(boxes.dtype)


def postprocess_per_class(params, cls_outputs, box_outputs,
                          image_scales=None) -> Detections:
    """Per-class NMS (postprocess.py:181-219): suppression only between boxes
    of one class, by shifting each class into its own band before one NMS
    pass. NMS sees unclipped boxes and the result is not clipped, as in the
    reference's per-class path."""
    top_boxes, top_scores, top_classes = _pre_nms_select(
        params, list(cls_outputs), list(box_outputs))
    shifted, offset = _class_shift(top_boxes, top_classes)
    kw = nms_kwargs_from_config(params["nms_configs"])
    res = nms_ops.batched_nms_auto(shifted.contiguous(), top_scores.contiguous(),
                                   **kw)
    sel_classes, out_boxes = _unshift(res, top_classes, offset)
    out_classes = (sel_classes + CLASS_OFFSET) * res.valid
    return Detections(_scale(out_boxes, image_scales), res.scores,
                      out_classes.to(torch.float32), res.valid, res.valid_len)


def pre_nms_multiclass(params, cls_outputs, box_outputs
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All anchors decoded with the full per-class sigmoid score matrix:
    (boxes [B, A, 4], scores [B, A, C]) (postprocess.py:222-237)."""
    cls_merged, box_merged = merge_class_box_level_outputs(
        params, cls_outputs, box_outputs)
    boxes = decode_box_outputs(box_merged,
                               anchor_boxes(params, box_merged.device)[None])
    return boxes, torch.sigmoid(cls_merged)


def postprocess_combined(params, cls_outputs, box_outputs,
                         image_scales=None) -> Detections:
    """Combined NMS (postprocess.py:240-295): top-k over the flattened
    (anchor, class) scores, then one class-shifted hard NMS at iou .5; the
    config's method, sigma and iou are ignored, as by the reference."""
    cls_merged, box_merged = merge_class_box_level_outputs(
        params, list(cls_outputs), list(box_outputs))
    b, a, c = cls_merged.shape
    nms_cfg = params["nms_configs"]
    topk = min(int(_get(nms_cfg, "pre_nms_topk") or 1024), a * c)
    max_out = int(_get(nms_cfg, "max_output_size") or 100)
    score_thresh = _get(nms_cfg, "score_thresh") or None

    flat = torch.sigmoid(cls_merged).reshape(b, a * c)
    top_scores, top_flat_idx = top_k_stable(flat, topk)  # [B, K]
    top_anchor = torch.div(top_flat_idx, c, rounding_mode="floor")
    top_classes = (top_flat_idx % c).to(torch.int32)
    top_enc = torch.gather(box_merged, 1, top_anchor[..., None].expand(-1, -1, 4))
    top_boxes = decode_box_outputs(
        top_enc, anchor_boxes(params, box_merged.device)[top_anchor])
    shifted, offset = _class_shift(top_boxes, top_classes)
    res = nms_ops.batched_nms_auto(shifted.contiguous(), top_scores.contiguous(),
                                   method="hard", iou_thresh=0.5,
                                   score_thresh=score_thresh,
                                   max_output_size=max_out)
    sel_classes, out_boxes = _unshift(res, top_classes, offset)
    out_boxes = clip_boxes(out_boxes, params["image_size"])
    out_classes = (sel_classes + CLASS_OFFSET) * res.valid
    return Detections(_scale(out_boxes, image_scales), res.scores,
                      out_classes.to(torch.float32), res.valid, res.valid_len)


def decode_anchors_to_centersize(anchors: torch.Tensor) -> torch.Tensor:
    """Corner anchors -> (y_center, x_center, h, w) (postprocess.py:302-309)."""
    ycenter = (anchors[..., 0] + anchors[..., 2]) / 2
    xcenter = (anchors[..., 1] + anchors[..., 3]) / 2
    h = anchors[..., 2] - anchors[..., 0]
    w = anchors[..., 3] - anchors[..., 1]
    return torch.stack([ycenter, xcenter, h, w], dim=-1)


def tflite_pre_nms(params, cls_outputs, box_outputs):
    """The TFLite custom-NMS op's inputs (postprocess.py:312-328): (raw box
    encodings [B, A, 4], sigmoid scores [B, A, C], normalized center-size
    anchors [A, 4])."""
    cls_merged, box_merged = merge_class_box_level_outputs(
        params, cls_outputs, box_outputs)
    h, w = parse_image_size(params["image_size"])
    norm = torch.tensor([h, w, h, w], dtype=torch.float32, device=box_merged.device)
    anchors = decode_anchors_to_centersize(
        anchor_boxes(params, box_merged.device) / norm)
    return box_merged, torch.sigmoid(cls_merged), anchors


def postprocess_tflite(params, cls_outputs, box_outputs) -> Detections:
    """TFLite's detection-postprocess op (postprocess.py:331-351): boxes in
    normalized [0, 1] corner coordinates, 0-based classes, no scale-back,
    `tflite_max_detections` outputs."""
    box_enc, scores, anchors = tflite_pre_nms(params, list(cls_outputs),
                                              list(box_outputs))
    return tflite_detections_from_pre(params, box_enc, scores, anchors)


def tflite_detections_from_pre(params, box_enc, scores,
                               decoded_anchors) -> Detections:
    """The op's fast path on the pre-NMS triple (postprocess.py:354-401):
    per-anchor max class, top-k, decode against the center-size anchors with
    unit scale factors, hard NMS at the config's iou and score thresholds."""
    nms_cfg = params["nms_configs"]
    iou_thresh = _get(nms_cfg, "iou_thresh") or 0.5
    score_thresh = _get(nms_cfg, "score_thresh") or None
    max_det = int(params.get("tflite_max_detections") or 100)

    cls_ids = torch.argmax(scores, dim=-1).to(torch.int32)   # [B, A]
    max_scores = torch.amax(scores, dim=-1)                  # [B, A]
    topk = min(int(_get(nms_cfg, "pre_nms_topk") or 1024), max_scores.shape[1])
    top_scores, top_idx = top_k_stable(max_scores, topk)
    top_enc = torch.gather(box_enc, 1, top_idx[..., None].expand(-1, -1, 4))
    top_anc = torch.as_tensor(decoded_anchors, device=box_enc.device)[top_idx]
    ya, xa, ha, wa = top_anc.unbind(-1)
    ty, tx, th, tw = top_enc.unbind(-1)
    ycenter = ty * ha + ya
    xcenter = tx * wa + xa
    hh = torch.exp(th) * ha
    ww = torch.exp(tw) * wa
    top_boxes = torch.stack([ycenter - hh / 2, xcenter - ww / 2,
                             ycenter + hh / 2, xcenter + ww / 2], dim=-1)
    top_classes = torch.gather(cls_ids, 1, top_idx)
    res = nms_ops.batched_nms_auto(top_boxes.contiguous(), top_scores.contiguous(),
                                   method="hard", iou_thresh=iou_thresh,
                                   score_thresh=score_thresh,
                                   max_output_size=max_det)
    out_classes = torch.gather(top_classes, 1, res.indices.long()) * res.valid
    return Detections(res.boxes, res.scores, out_classes.to(torch.float32),
                      res.valid, res.valid_len)
