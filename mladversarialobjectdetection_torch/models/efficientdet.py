"""EfficientDet detector assembly in PyTorch.

Port of `mladversarialobjectdetection_tpu/models/efficientdet.py`: backbone
-> extra `ResampleFeatureMap` for levels 6..max_level -> FPN cells ->
ClassNet / BoxNet. A static `DetSpec` resolves every architectural decision
before the modules are built.

The public forward keeps the JAX layouts: NHWC images in, per-level NHWC
head outputs out (fp32). NCHW is used only inside. With `mixed_precision`
the net follows the JAX policy (efficientdet.py:107-109, :154-155): float32
parameters, the images cast to bf16 at the entry, bf16 activations through
the backbone (the fused blocks on the kernels' bf16 instance), the BiFPN and
the heads, and the predictions cast back to float32.

Under a mesh whose 'spatial' axis is larger than 1 (`parallel/spatial.py`),
the images are this rank's rows, every module runs on the rows the layout
rule gives its level (the global heights from `DetSpec.level_hw`), and each
level's class and box outputs are gathered (`spatial.whole`): from there on
anchors, postprocessing, NMS and the losses see every anchor. The packed
entry runs on packed row shards (`models/efficientnet_packed.py`), and the
segmentation head on the row-sharded levels, its logits gathered alike.
"""
from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..parallel import spatial
from ..utils.image import get_feat_sizes, parse_image_size
from . import bifpn, heads
from .efficientnet import (BackboneSpec, EfficientNet, get_backbone_spec,
                           set_bn_axis_name)
from .efficientnet_packed import PackedEntryEfficientNet


class DetSpec(NamedTuple):
    """Static, hashable description of one EfficientDet variant."""
    backbone: BackboneSpec
    min_level: int
    max_level: int
    num_classes: int
    num_anchors: int
    fpn_num_filters: int
    fpn_cell_repeats: int
    box_class_repeats: int
    fpn_nodes: Tuple[bifpn.FpnNode, ...]
    fpn_weight_method: str
    act_type: str
    separable_conv: bool
    apply_bn_for_resampling: bool
    conv_after_downsample: bool
    conv_bn_act_pattern: bool
    level_hw: Tuple[Tuple[int, int], ...]  # (h, w) per absolute level 0..max
    image_size: Tuple[int, int]
    survival_prob: Optional[float]
    grad_checkpoint: bool
    mixed_precision: bool
    heads: Tuple[str, ...] = ("object_detection",)
    seg_num_classes: int = 3


def spec_from_config(config) -> DetSpec:
    """Resolve a Config (config.py) into a static DetSpec."""
    image_size = parse_image_size(config.image_size)
    feat_sizes = get_feat_sizes(image_size, config.max_level)
    level_hw = tuple((f["height"], f["width"]) for f in feat_sizes)
    weight_method = config.fpn_weight_method or "fastattn"
    nodes = bifpn.get_topology(config.fpn_name, config.min_level,
                               config.max_level)
    backbone = get_backbone_spec(config.backbone_name,
                                 survival_prob=config.survival_prob)
    # the detector's act_type overrides the backbone default
    # (efficientdet_keras.py:884-906 passes utils.activation_fn w/ config act)
    backbone = backbone._replace(act_type=config.act_type)
    return DetSpec(
        backbone=backbone,
        min_level=config.min_level,
        max_level=config.max_level,
        num_classes=config.num_classes,
        num_anchors=config.num_scales * len(config.aspect_ratios),
        fpn_num_filters=config.fpn_num_filters,
        fpn_cell_repeats=config.fpn_cell_repeats,
        box_class_repeats=config.box_class_repeats,
        fpn_nodes=nodes,
        fpn_weight_method=weight_method,
        act_type=config.act_type,
        separable_conv=config.separable_conv,
        apply_bn_for_resampling=config.apply_bn_for_resampling,
        conv_after_downsample=config.conv_after_downsample,
        conv_bn_act_pattern=config.conv_bn_act_pattern,
        level_hw=level_hw,
        image_size=image_size,
        survival_prob=config.survival_prob,
        grad_checkpoint=bool(config.grad_checkpoint),
        mixed_precision=bool(config.mixed_precision),
        heads=tuple(config.get("heads", ["object_detection"])),
        seg_num_classes=int(config.get("seg_num_classes", 3) or 3),
    )


HEADS = ("object_detection", "segmentation")


class EfficientDetNet(nn.Module):
    """Backbone -> resample 6..max -> BiFPN -> heads (no pre/post).

    `spec.heads` names the heads, as JAX's (efficientdet.py:143-160):
    `object_detection` (ClassNet and BoxNet) and / or `segmentation`
    (`heads.SegmentationHead`, module `seg_head`). `grad_checkpoint`
    recomputes the FPN cells and the heads' shared convs in the backward
    pass. `packed_entry` > 0 computes the backbone's stem and first
    `packed_entry` blocks in the space-to-depth layout
    (`models/efficientnet_packed.py`, JAX efficientdet.py:111-117) on the same
    parameters: the `state_dict` is the unpacked net's. `bn_axis_name` is
    the mesh axis its train-mode BatchNorms reduce over
    (`efficientnet.set_bn_axis_name`); packed entry blocks do not take it,
    as in JAX.
    """

    def __init__(self, spec: DetSpec, packed_entry: int = 0,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        if packed_entry > 0 and bn_axis_name is not None:
            raise ValueError("packed_entry does not support cross-replica BN")
        unknown = set(spec.heads) - set(HEADS)
        if unknown or not spec.heads:
            raise ValueError(f"heads {spec.heads}: want some of {HEADS}")
        self.spec = spec
        cdtype = torch.bfloat16 if spec.mixed_precision else None
        self.compute_dtype = cdtype or torch.float32
        self.packed_entry = int(packed_entry)
        if self.packed_entry > 0:
            self.backbone = PackedEntryEfficientNet(spec.backbone, self.packed_entry,
                                                    dtype=cdtype)
        else:
            self.backbone = EfficientNet(spec.backbone, dtype=cdtype)
        # endpoints[i] == reduction_{i+1}; levels min..5 come from the backbone
        self._backbone_levels = range(spec.min_level, min(spec.max_level, 5) + 1)
        channels = [self.backbone.endpoint_channels[level - 1]
                    for level in self._backbone_levels]
        # extra downsample levels 6..max_level (efficientdet_keras.py:814-828)
        for level in range(6, spec.max_level + 1):
            self.add_module(f"resample_p{level}", bifpn.ResampleFeatureMap(
                channels[-1], spec.level_hw[level - 1], spec.fpn_num_filters,
                spec.level_hw[level], apply_bn=spec.apply_bn_for_resampling,
                conv_after_downsample=spec.conv_after_downsample, dtype=cdtype))
            channels.append(spec.fpn_num_filters)
        self.fpn_cells = bifpn.FPNCells(
            spec.fpn_nodes, spec.min_level, spec.max_level,
            spec.fpn_cell_repeats, spec.fpn_num_filters, spec.level_hw,
            channels, spec.fpn_weight_method, spec.act_type,
            spec.separable_conv, spec.apply_bn_for_resampling,
            spec.conv_after_downsample, spec.conv_bn_act_pattern, dtype=cdtype,
            grad_checkpoint=spec.grad_checkpoint)
        num_levels = spec.max_level - spec.min_level + 1
        if "object_detection" in spec.heads:
            self.class_net = heads.class_net(
                spec.num_classes, spec.num_anchors, spec.fpn_num_filters,
                num_levels, spec.box_class_repeats, spec.act_type,
                spec.separable_conv, spec.survival_prob,
                spec.grad_checkpoint, dtype=cdtype)
            self.box_net = heads.box_net(
                spec.num_anchors, spec.fpn_num_filters, num_levels,
                spec.box_class_repeats, spec.act_type, spec.separable_conv,
                spec.survival_prob, spec.grad_checkpoint, dtype=cdtype)
        if "segmentation" in spec.heads:
            self.seg_head = heads.SegmentationHead(
                spec.seg_num_classes, spec.fpn_num_filters,
                [spec.fpn_num_filters] * num_levels, spec.act_type)
        self.bn_axis_name = bn_axis_name
        set_bn_axis_name(self, bn_axis_name)

    def with_packed_entry(self, packed_entry: int) -> "EfficientDetNet":
        """This net with its backbone's first `packed_entry` blocks packed
        (0: unpacked), sharing every parameter, buffer and submodule but the
        backbone's packed view; `self` is left as it is."""
        if packed_entry > 0 and self.bn_axis_name is not None:
            raise ValueError("packed_entry does not support cross-replica BN")
        view = copy.copy(self)
        view._modules = dict(self._modules)
        view._modules["backbone"] = PackedEntryEfficientNet.sharing(
            self.backbone, packed_entry)
        view.packed_entry = int(packed_entry)
        return view

    def pyramid(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                height: Optional[int] = None) -> List[torch.Tensor]:
        """NCHW images -> NCHW features of levels min..max, before the BiFPN
        (`height`: the images' global height under a spatial mesh)."""
        endpoints = self.backbone(x, training, generator, height)
        feats = [endpoints[level - 1] for level in self._backbone_levels]
        for level in range(6, self.spec.max_level + 1):
            feats.append(getattr(self, f"resample_p{level}")(feats[-1], training))
        return feats

    def forward(self, images: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> tuple:
        """[B, H, W, 3] images -> (class, box) outputs, per level [B, h, w, C],
        float32 (the images cast to the compute dtype first); with a
        segmentation head its logits [B, h, w, seg_num_classes] float32
        follow, or stand alone: `(seg,)` (JAX's output tuple).

        `training` is Flax's argument (efficientdet.py:104), never the
        module's own `training` flag: train-mode BatchNorm (batch
        statistics, running statistics moved in place), every backbone
        block unfused, and drop-connect drawn from `generator` where
        `survival_prob` is set. Under a spatial mesh, `images` are this
        rank's rows and the outputs every row's (see the module notes)."""
        spec = self.spec
        heights = levels = None
        if spatial.active() is not None:
            spatial.check_rows(images, spec.image_size[0], dim=1)
            heights = [h for h, _ in spec.level_hw]
            levels = heights[spec.min_level:spec.max_level + 1]
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        fpn_feats = self.fpn_cells(
            self.pyramid(x, training, generator, heights and heights[0]), training)
        # float32 outputs, as Flax's (float64 nets keep float64)
        out_dtype = torch.promote_types(self.compute_dtype, torch.float32)
        nhwc = lambda o: o.permute(0, 2, 3, 1).to(out_dtype).contiguous()
        whole = (lambda outs: [nhwc(o) for o in outs]) if levels is None else (
            lambda outs: [nhwc(spatial.whole(o, h)) for o, h in zip(outs, levels)])
        outputs = []
        if "object_detection" in spec.heads:
            outputs.append(whole(self.class_net(fpn_feats, training, levels)))
            outputs.append(whole(self.box_net(fpn_feats, training, levels)))
        if "segmentation" in spec.heads:
            seg = self.seg_head(fpn_feats, training, levels)
            outputs.append(nhwc(seg if levels is None else spatial.whole(seg, 2 * levels[0])))
        return tuple(outputs)
