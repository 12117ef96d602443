"""The kernels of the float serve program as `torch.library` custom ops.

No JAX counterpart: the port's plumbing for `torch.export`, which cannot
trace a `ctypes` call (`_build.load`, `ops/nms_cuda.py`). Each op has a CUDA
implementation (the kernel's wrapper, which launches or raises and counts
its launches), a CPU implementation (the plain version) and a fake one
(shapes and dtypes only), so that `torch.export` traces through it on
either device and an exported program calls the kernel when it runs:

- `mlad::batched_nms`: `ops/nms_cuda.batched_nms_cuda` / `ops/nms.batched_nms`
  (boxes [B, N, 4], scores [B, N] -> the five fields of `NMSResult`);
- `mlad::mbconv_fwd`: the fused frozen MBConv forward, float32 or bf16,
  `ops/mbconv_cuda.mbconv_fwd_cuda` / `ops/mbconv.mbconv_plain`.

The live serve calls the same ops (`nms.batched_nms_auto`,
`mbconv._forward`), so there is one route, not two. Import this module
before `torch.export.load` of a program that holds them
(`inference/drivers.ExportedProgramDriver` does).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from . import mbconv as mbconv_ops
from . import nms as nms_ops

NAMESPACE = "mlad"


def _nms_cuda(boxes: Tensor, scores: Tensor, method: str, iou_thresh: Optional[float],
              score_thresh: Optional[float], sigma: Optional[float],
              max_output_size: int) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    from . import nms_cuda
    return tuple(nms_cuda.batched_nms_cuda(
        boxes, scores, method=method, iou_thresh=iou_thresh, score_thresh=score_thresh,
        sigma=sigma, max_output_size=max_output_size))


batched_nms = torch.library.custom_op(f"{NAMESPACE}::batched_nms", _nms_cuda,
                                      mutates_args=(), device_types="cuda")


@batched_nms.register_kernel("cpu")
def _nms_cpu(boxes, scores, method, iou_thresh, score_thresh, sigma, max_output_size):
    return tuple(nms_ops.batched_nms(
        boxes, scores, method=method, iou_thresh=iou_thresh, score_thresh=score_thresh,
        sigma=sigma, max_output_size=max_output_size))


@batched_nms.register_fake
def _nms_fake(boxes, scores, method, iou_thresh, score_thresh, sigma, max_output_size):
    b, m = boxes.shape[0], max_output_size
    return (boxes.new_empty((b, m, 4), dtype=torch.float32),
            scores.new_empty((b, m), dtype=torch.float32),
            boxes.new_empty((b, m), dtype=torch.int32),
            boxes.new_empty((b, m), dtype=torch.bool),
            boxes.new_empty((b,), dtype=torch.int32))


def _mbconv_cuda(x: Tensor, we: Tensor, be: Tensor, wd: Tensor, bd: Tensor, wp: Tensor,
                 bp: Tensor, act_type: str, residual: bool) -> Tensor:
    from . import mbconv_cuda
    return mbconv_cuda.mbconv_fwd_cuda(x, mbconv_ops.FoldedBlock(we, be, wd, bd, wp, bp),
                                       act_type=act_type, residual=residual)


mbconv_fwd = torch.library.custom_op(f"{NAMESPACE}::mbconv_fwd", _mbconv_cuda,
                                     mutates_args=(), device_types="cuda")


@mbconv_fwd.register_kernel("cpu")
def _mbconv_cpu(x, we, be, wd, bd, wp, bp, act_type, residual):
    return mbconv_ops.mbconv_plain(x, mbconv_ops.FoldedBlock(we, be, wd, bd, wp, bp),
                                   act_type=act_type, residual=residual)


@mbconv_fwd.register_fake
def _mbconv_fake(x, we, be, wd, bd, wp, bp, act_type, residual):
    return x.new_empty((*x.shape[:-1], wp.shape[1]))


def op_counts(graph) -> dict:
    """{op name: calls} of this module's ops in an FX graph (an exported
    program's `graph`)."""
    names = {getattr(torch.ops, NAMESPACE).batched_nms.default: "batched_nms",
             getattr(torch.ops, NAMESPACE).mbconv_fwd.default: "mbconv_fwd"}
    counts = dict.fromkeys(names.values(), 0)
    for node in graph.nodes:
        if node.op == "call_function" and node.target in names:
            counts[names[node.target]] += 1
    return counts
