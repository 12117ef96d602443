"""Anchor decode + global NMS postprocessing, fixed shapes.

Port of `mladversarialobjectdetection_tpu/ops/postprocess.py:31-178`:
`merge_class_box_level_outputs`, `pre_nms`, `clip_boxes`, `_pre_nms_select`,
`nms_kwargs_from_config` and `postprocess_global`. The `per_class`,
`combined` and `tflite` modes and `pre_nms_approx_topk` are not ported yet;
asking for them raises.

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
    if _get(nms_cfg, "pre_nms_approx_topk"):
        raise NotImplementedError("pre_nms_approx_topk is not ported yet")
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
