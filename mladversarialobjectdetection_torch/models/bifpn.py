"""BiFPN feature network in PyTorch (NCHW inside; `training` as Flax's).

Port of `mladversarialobjectdetection_tpu/models/bifpn.py`: the same DAG
topologies (copied), the same resampling and the same weighted fusion. Every
feature size is static, so each `ResampleFeatureMap` decides at construction
whether it pools, upsamples or only projects. Module names mirror Flax's
(`cell_0.fnode2.resample_0_1.conv2d`, `cell_0.fnode2.conv_pw`, ...).

Hazards reproduced explicitly:

- The SAME max-pool (bifpn.py:89-94) pads with -inf, with Flax's asymmetric
  split and a window of `stride + 1`: `_max_pool_to`.
- A non-integer nearest upsample (bifpn.py:105) follows
  `jax.image.resize(method="nearest")`, whose source index differs from
  both PyTorch `nearest` modes: `nearest_source_index`.
- `fastattn` fusion divides by `sum(relu(w)) + 1e-4` (bifpn.py:182-184).

Under a spatial mesh (`parallel/spatial.py`) every module passes the global
heights it knows statically: the pool takes its stride from the global
height and fetches its halo (-inf beyond the image's edges), the upsample
fetches the source rows of its output rows (none for an integer factor on
aligned shards), and each level's tensors are in the layout its height
gives, so a node sums inputs of one layout.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from .efficientnet import (BatchNorm, Conv2d, activation, checkpointed,
                           pad_same, same_pads, set_compute_dtype)


class FpnNode(NamedTuple):
    feat_level: int
    inputs_offsets: Tuple[int, ...]


def bifpn_topology(min_level: int, max_level: int) -> Tuple[FpnNode, ...]:
    """BiFPN node list (parity with fpn_configs.bifpn_config, 24-72)."""
    num_levels = max_level - min_level + 1
    node_ids = {min_level + i: [i] for i in range(num_levels)}
    next_id = num_levels
    nodes = []
    for i in range(max_level - 1, min_level - 1, -1):  # top-down
        nodes.append(FpnNode(i, (node_ids[i][-1], node_ids[i + 1][-1])))
        node_ids[i].append(next_id)
        next_id += 1
    for i in range(min_level + 1, max_level + 1):  # bottom-up
        nodes.append(FpnNode(i, tuple(node_ids[i]) + (node_ids[i - 1][-1],)))
        node_ids[i].append(next_id)
        next_id += 1
    return tuple(nodes)


def qufpn_topology(min_level: int, max_level: int) -> Tuple[FpnNode, ...]:
    """Quad-FPN node list (parity with fpn_configs.qufpn_config, 75-163)."""
    num_levels = max_level - min_level + 1
    node_ids = {min_level + i: [i] for i in range(num_levels)}
    next_id = num_levels
    nodes = []

    def add(level, offsets):
        nonlocal next_id
        nodes.append(FpnNode(level, tuple(offsets)))
        node_ids[level].append(next_id)
        next_id += 1

    for i in range(max_level - 1, min_level - 1, -1):  # top-down 1
        add(i, [node_ids[i][-1], node_ids[i + 1][-1]])
    node_ids[max_level].append(node_ids[max_level][-1])
    for i in range(min_level + 1, max_level):  # bottom-up 2
        add(i, list(node_ids[i]) + [node_ids[i - 1][-1]])
    add(max_level, [node_ids[max_level][0], node_ids[max_level - 1][-1]])
    node_ids[min_level].append(node_ids[min_level][-1])
    for i in range(min_level + 1, max_level + 1):  # bottom-up 3
        add(i, [node_ids[i][0],
                node_ids[i - 1][-1] if i != min_level + 1 else node_ids[i - 1][0]])
    node_ids[min_level].append(node_ids[min_level][-1])
    for i in range(max_level - 1, min_level, -1):  # top-down 4
        add(i, [node_ids[i][0], node_ids[i][-1], node_ids[i + 1][-1]])
    add(min_level, [node_ids[min_level][0], node_ids[min_level + 1][-1]])
    node_ids[max_level].append(node_ids[max_level][-1])
    for i in range(max_level, min_level - 1, -1):  # quad-add
        add(i, [node_ids[i][2], node_ids[i][4]])
    return tuple(nodes)


def get_topology(fpn_name: Optional[str], min_level: int, max_level: int
                 ) -> Tuple[FpnNode, ...]:
    if not fpn_name or fpn_name in ("bifpn", "bifpn_dyn"):
        return bifpn_topology(min_level, max_level)
    if fpn_name == "qufpn":
        return qufpn_topology(min_level, max_level)
    raise ValueError(f"unknown fpn name {fpn_name}")


def _max_pool_to(x: torch.Tensor, th: int, tw: int,
                 height: Optional[int] = None) -> torch.Tensor:
    """SAME max-pool of an NCHW map down to (th, tw) (bifpn.py:89-94);
    `height`: x's global height under a spatial mesh.

    Hazard: `nn.max_pool(padding="SAME")` pads with -inf and splits the
    padding as `same_pads` does; `max_pool2d(padding=...)` is symmetric.
    """
    h, w = x.shape[2], x.shape[3]
    if height is not None and spatial.active() is not None:
        sh, sw = (height - 1) // th + 1, (w - 1) // tw + 1
        window = (sh + 1, sw + 1)
        left, right = same_pads(w, window[1], sw)
        pool = lambda xe: F.max_pool2d(
            F.pad(xe, (left, right, 0, 0), value=float("-inf")), window,
            stride=(sh, sw), padding=0)
        return spatial.same_window(x, height, window[0], sh,
                                   same_pads(height, window[0], sh)[0], pool,
                                   fill=float("-inf"))
    sh = (h - 1) // th + 1
    sw = (w - 1) // tw + 1
    window = (sh + 1, sw + 1)
    x = pad_same(x, window, (sh, sw), value=float("-inf"))
    return F.max_pool2d(x, window, stride=(sh, sw), padding=0)


@functools.lru_cache(maxsize=64)
def nearest_source_index(n_in: int, n_out: int) -> np.ndarray:
    """Source row of each output row under `jax.image.resize("nearest")`.

    Hazard: jax/_src/image/scale.py `_resize_nearest` computes
    `floor((arange(n_out) + 0.5) * n_in / n_out)` in float32, and XLA
    rewrites the division by the constant `n_out` into a multiply by its
    float32 reciprocal and folds the two constants, so the table is
    `floor((i + 0.5) * (n_in * (1 / n_out)))` in float32. Neither torch
    `nearest` nor `nearest-exact` gives the same table for every size pair.
    """
    f32 = np.float32
    step = f32(n_in) * (f32(1) / f32(n_out))
    return np.floor((np.arange(n_out, dtype=f32) + f32(0.5)) * step).astype(
        np.int64)


def _nearest_upsample_to(x: torch.Tensor, th: int, tw: int,
                         height: Optional[int] = None) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW map up to (th, tw) (bifpn.py:97-105);
    `height`: x's global height under a spatial mesh, where each rank makes
    its output rows from the source rows they read."""
    if (height is not None and spatial.active() is not None
            and (spatial.sharded(height) or spatial.sharded(th))):
        src = (np.arange(th) // (th // height) if th % height == 0
               else nearest_source_index(height, th))
        need = lambda o_lo, o_hi: (int(src[o_lo]), int(src[o_hi - 1]) + 1)
        x = spatial.window(x, height, th, need, lambda xe, o_lo, o_hi, lo: xe.index_select(
            2, torch.from_numpy(src[o_lo:o_hi] - lo).to(x.device)))
        w = x.shape[3]
        if tw % w == 0:
            return x.repeat_interleave(tw // w, dim=3)
        return x.index_select(3, torch.from_numpy(
            nearest_source_index(w, tw)).to(x.device))
    h, w = x.shape[2], x.shape[3]
    if th % h == 0 and tw % w == 0:
        return x.repeat_interleave(th // h, dim=2).repeat_interleave(
            tw // w, dim=3)
    if th != h:
        x = x.index_select(2, torch.from_numpy(
            nearest_source_index(h, th)).to(x.device))
    if tw != w:
        x = x.index_select(3, torch.from_numpy(
            nearest_source_index(w, tw)).to(x.device))
    return x


class ResampleFeatureMap(nn.Module):
    """Match a feature map to a target (h, w, c) (bifpn.py:108-146).

    `in_channels` and `in_hw` are the static shape of the input map; `dtype`
    the compute dtype (`efficientnet.set_compute_dtype`).
    """

    def __init__(self, in_channels: int, in_hw: Tuple[int, int],
                 target_num_channels: int, target_hw: Tuple[int, int],
                 apply_bn: bool = True, conv_after_downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        (h, w), (th, tw) = in_hw, target_hw
        self.in_hw, self.target_hw = in_hw, target_hw
        if h > th and w > tw:
            self.mode = "pool"
        elif h <= th and w <= tw:
            self.mode = "upsample" if (h < th or w < tw) else "identity"
        else:
            raise ValueError(f"Incompatible resample {h}x{w} -> {th}x{tw}")
        self.conv_after_downsample = conv_after_downsample and self.mode == "pool"
        self.conv2d = self.bn = None
        if in_channels != target_num_channels:
            self.conv2d = Conv2d(in_channels, target_num_channels, 1,
                                 init="fan_in_truncated")
            if apply_bn:
                self.bn = BatchNorm(target_num_channels)
        set_compute_dtype(self, dtype)

    def _maybe_1x1(self, x: torch.Tensor, training: bool,
                   height: int) -> torch.Tensor:
        if self.conv2d is not None:
            x = self.conv2d(x)
            if self.bn is not None:
                x = self.bn(x, training, height)
        return x

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        h, (th, tw) = self.in_hw[0], self.target_hw
        if self.mode == "pool":
            if not self.conv_after_downsample:
                x = self._maybe_1x1(x, training, h)
            x = _max_pool_to(x, th, tw, h)
            if self.conv_after_downsample:
                x = self._maybe_1x1(x, training, th)
            return x
        x = self._maybe_1x1(x, training, h)
        if self.mode == "upsample":
            x = _nearest_upsample_to(x, th, tw, h)
        return x


class FNode(nn.Module):
    """One BiFPN fusion node (bifpn.py:149-223).

    `in_shapes[i]` is (channels, (h, w)) of `feats[i]`. The fusion weights
    are cast to the nodes' dtype before the softmax or relu, as the JAX
    node does (bifpn.py:175-191): at bf16 the fusion runs in bf16.
    """

    def __init__(self, inputs_offsets: Tuple[int, ...],
                 in_shapes: Sequence[Tuple[int, Tuple[int, int]]],
                 fpn_num_filters: int, feat_hw: Tuple[int, int],
                 weight_method: str = "fastattn", act_type: str = "swish",
                 separable_conv: bool = True,
                 apply_bn_for_resampling: bool = True,
                 conv_after_downsample: bool = False,
                 conv_bn_act_pattern: bool = False):
        super().__init__()
        self.inputs_offsets = tuple(inputs_offsets)
        self.height = feat_hw[0]
        self.weight_method = weight_method
        self.act_type = act_type
        self.separable_conv = separable_conv
        self.conv_bn_act_pattern = conv_bn_act_pattern
        for i, offset in enumerate(self.inputs_offsets):
            channels, hw = in_shapes[offset]
            self.add_module(f"resample_{i}_{offset}", ResampleFeatureMap(
                channels, hw, fpn_num_filters, feat_hw,
                apply_bn=apply_bn_for_resampling,
                conv_after_downsample=conv_after_downsample))
        n = len(self.inputs_offsets)
        if weight_method in ("attn", "fastattn"):
            self.WSM = nn.Parameter(torch.ones(n))
        elif weight_method in ("channel_attn", "channel_fastattn"):
            self.WSM = nn.Parameter(torch.ones(n, fpn_num_filters))
        elif weight_method != "sum":
            raise ValueError(f"unknown weight_method {weight_method}")
        c = fpn_num_filters
        use_bias = not conv_bn_act_pattern
        if separable_conv:
            self.conv_dw = Conv2d(c, c, 3, groups=c, bias=False,
                                  init="fan_in_truncated")
            self.conv_pw = Conv2d(c, c, 1, bias=use_bias,
                                  init="fan_in_truncated")
        else:
            self.conv = Conv2d(c, c, 3, bias=use_bias, init="fan_in_truncated")
        self.bn = BatchNorm(c)

    def forward(self, feats: Sequence[torch.Tensor],
                training: bool = False) -> torch.Tensor:
        nodes = [getattr(self, f"resample_{i}_{offset}")(feats[offset], training)
                 for i, offset in enumerate(self.inputs_offsets)]
        wm = self.weight_method
        n = len(nodes)
        dtype = nodes[0].dtype
        if wm == "attn":
            norm = torch.softmax(self.WSM.to(dtype), dim=0)
            new_node = sum(nodes[i] * norm[i] for i in range(n))
        elif wm == "fastattn":  # divides by sum(relu(w)) + 1e-4 (bifpn.py:182-184)
            w = F.relu(self.WSM.to(dtype))
            new_node = sum(nodes[i] * w[i] for i in range(n)) / (
                torch.sum(w) + 1e-4)
        elif wm == "channel_attn":
            norm = torch.softmax(self.WSM.to(dtype), dim=0).view(n, 1, -1, 1, 1)
            new_node = sum(nodes[i] * norm[i] for i in range(n))
        elif wm == "channel_fastattn":
            w = F.relu(self.WSM.to(dtype))
            new_node = sum(nodes[i] * w[i].view(1, -1, 1, 1)
                           for i in range(n)) / (
                torch.sum(w, dim=0) + 1e-4).view(1, -1, 1, 1)
        else:  # "sum"
            new_node = sum(nodes)

        # op_after_combine (efficientdet_keras.py:175-221)
        if not self.conv_bn_act_pattern:
            new_node = activation(new_node, self.act_type)
        if self.separable_conv:
            new_node = self.conv_pw(self.conv_dw(new_node, self.height))
        else:
            new_node = self.conv(new_node, self.height)
        new_node = self.bn(new_node, training, self.height)
        if self.conv_bn_act_pattern:
            new_node = activation(new_node, self.act_type)
        return new_node


class FPNCell(nn.Module):
    """One repeat of the BiFPN DAG (bifpn.py:226-256).

    `in_shapes` are (channels, (h, w)) of the cell's input features, one
    per level; `level_hw` is (h, w) per absolute level 0..max.
    """

    def __init__(self, nodes: Tuple[FpnNode, ...], fpn_num_filters: int,
                 level_hw, in_shapes, **node_kw):
        super().__init__()
        self.num_nodes = len(nodes)
        shapes = list(in_shapes)
        for i, node in enumerate(nodes):
            hw = level_hw[node.feat_level]
            self.add_module(f"fnode{i}", FNode(
                node.inputs_offsets, shapes, fpn_num_filters, hw, **node_kw))
            shapes.append((fpn_num_filters, hw))

    def forward(self, feats: Sequence[torch.Tensor],
                training: bool = False) -> List[torch.Tensor]:
        feats = list(feats)
        for i in range(self.num_nodes):
            feats.append(getattr(self, f"fnode{i}")(feats, training))
        return feats


class FPNCells(nn.Module):
    """Stack of FPN cells with output re-selection (bifpn.py:259-298), in
    the compute dtype `dtype` (`efficientnet.set_compute_dtype`).

    `grad_checkpoint` recomputes each cell in the backward pass (JAX
    bifpn.py:276-281, `nn.remat(FPNCell)`): only the cell's selected
    outputs are kept, and the recompute leaves the BatchNorms' running
    statistics where the first pass moved them (`efficientnet.checkpointed`;
    a cell draws nothing at random)."""

    def __init__(self, nodes: Tuple[FpnNode, ...], min_level: int,
                 max_level: int, fpn_cell_repeats: int, fpn_num_filters: int,
                 level_hw, in_channels: Sequence[int], weight_method: str,
                 act_type: str, separable_conv: bool = True,
                 apply_bn_for_resampling: bool = True,
                 conv_after_downsample: bool = False,
                 conv_bn_act_pattern: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 grad_checkpoint: bool = False):
        super().__init__()
        self.fpn_cell_repeats = fpn_cell_repeats
        self.grad_checkpoint = grad_checkpoint
        node_kw = dict(weight_method=weight_method, act_type=act_type,
                       separable_conv=separable_conv,
                       apply_bn_for_resampling=apply_bn_for_resampling,
                       conv_after_downsample=conv_after_downsample,
                       conv_bn_act_pattern=conv_bn_act_pattern)
        levels = range(min_level, max_level + 1)
        shapes = [(c, level_hw[lv]) for c, lv in zip(in_channels, levels)]
        for rep in range(fpn_cell_repeats):
            self.add_module(f"cell_{rep}", FPNCell(
                nodes, fpn_num_filters, level_hw, shapes, **node_kw))
            shapes = [(fpn_num_filters, level_hw[lv]) for lv in levels]
        # re-select one output per level: the last node at that level
        n_in = max_level - min_level + 1
        self._select = [n_in + max(i for i, fnode in enumerate(nodes)
                                   if fnode.feat_level == level)
                        for level in levels]
        set_compute_dtype(self, dtype)

    def _cell_outputs(self, cell: FPNCell, training: bool, *feats):
        cell_feats = cell(feats, training)
        return tuple(cell_feats[i] for i in self._select)

    def forward(self, feats: Sequence[torch.Tensor],
                training: bool = False) -> List[torch.Tensor]:
        for rep in range(self.fpn_cell_repeats):
            # bound now: a checkpoint calls it again in the backward pass
            run = functools.partial(self._cell_outputs,
                                    getattr(self, f"cell_{rep}"), training)
            if self.grad_checkpoint and torch.is_grad_enabled():
                feats = list(checkpointed(run, *feats))
            else:
                feats = list(run(*feats))
        return feats
