"""The CUDA NMS kernel (`csrc/nms.cu`) and its wrapper.

Replaces the Pallas TPU kernel `_nms_kernel` of
`mladversarialobjectdetection_tpu/ops/pallas_nms.py` (launched by
`batched_nms_pallas`). The kernel runs the whole greedy loop for one image
in one CTA and recomputes the winner's IoU row each step instead of forming
the Pallas kernel's [N, N] matrix, which does not fit a block's shared
memory on Hopper. Its launch configuration, chosen by the C entry from N:
ceil(N / 4) threads rounded up to a warp (at most 1024, N <= 4096), else
ceil(N / 16) (at most 512, N <= 8192); each thread holds its candidates'
live scores in registers; 16 bytes of dynamic shared memory per candidate
(the boxes, read-only after the load), two 32-entry slots and one barrier
per step. It stops at the first invalid step whose winner is not NaN and
writes the remaining rows as pad rows, which the plain version would
produce too. Its bound on an H100 (bytes, operations and the serial chain
of M block-wide argmax steps) is worked out in `csrc/nms.cu` and PERF.md.

`batched_nms_cuda` takes only CUDA float32 tensors and launches the kernel
or raises; it never falls back to the plain version (`ops/nms.batched_nms`).
`LAUNCHES` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .nms import NMSResult, inverse_sigma, nms_thresholds

LAUNCHES = 0  # kernel launches made by batched_nms_cuda in this process

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of `csrc/nms.cu`, built on first use."""
    lib = _build.load("nms")
    fn = lib.mlad_nms
    fn.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _div_check():
    """The division check's C entry in `csrc/nms.cu`, built on first use."""
    fn = _build.load("nms").mlad_nms_div_check
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_int, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def division_mismatches(pairs: int, pair_range: int,
                        device: torch.device | str = "cuda") -> int:
    """Pairs of `pair_range` (0: both operands in [2^-40, 2^41); 1: the
    iou's, a <= d in [1e-3, 1e6]) on which the kernel's fast division
    differs from div.rn; `csrc/nms.cu`'s exactness rests on it being 0."""
    if pair_range not in (0, 1):
        raise ValueError(f"pair_range {pair_range}: want 0 or 1")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(bad.device):
        err = _div_check()(int(pairs), pair_range, bad.data_ptr(),
                           torch.cuda.current_stream(bad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"division check launch failed: cudaError_t {err}")
    return int(bad.item())


def batched_nms_cuda(boxes: torch.Tensor, scores: torch.Tensor, *,
                     method: str = "gaussian", iou_thresh: float | None = None,
                     score_thresh: float | None = None,
                     sigma: float | None = None,
                     max_output_size: int = 100) -> NMSResult:
    """`ops/nms.batched_nms` as one kernel launch: boxes [B, N, 4], scores [B, N]."""
    global LAUNCHES
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"float32 only, got {boxes.dtype} / {scores.dtype}")
    if not (boxes.is_cuda and scores.is_cuda):
        raise ValueError("batched_nms_cuda takes CUDA tensors; "
                         "use ops/nms.batched_nms on the CPU")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or tuple(scores.shape) != tuple(
            boxes.shape[:2]):
        raise ValueError(f"want boxes [B, N, 4] and scores [B, N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        # the kernel reads each box as one float4; a misaligned read would
        # fault the whole CUDA context instead of raising here
        raise ValueError("boxes must start on a 16-byte boundary")
    b, n, _ = boxes.shape
    m = int(max_output_size)
    sigma_v, iou_t, score_t = nms_thresholds(method, iou_thresh,
                                             score_thresh, sigma)
    gaussian = sigma_v > 0.0
    dev = boxes.device
    out_boxes = torch.empty((b, m, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty((b, m), dtype=torch.float32, device=dev)
    out_idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    out_valid = torch.empty((b, m), dtype=torch.bool, device=dev)
    out_len = torch.empty((b,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), b, n, m, int(gaussian),
                 -inverse_sigma(sigma_v) if gaussian else 0.0, iou_t, score_t,
                 out_boxes.data_ptr(), out_scores.data_ptr(),
                 out_idx.data_ptr(), out_valid.data_ptr(), out_len.data_ptr(),
                 stream)
    if err != 0:
        # 1 (cudaErrorInvalidValue): B, N or M out of the C entry's range
        # (N <= kMaxCandidates of csrc/nms.cu, the shared memory of one block)
        raise RuntimeError(f"NMS kernel launch failed: cudaError_t {err} "
                           f"(B={b}, N={n}, M={m})")
    LAUNCHES += 1
    return NMSResult(out_boxes, out_scores, out_idx, out_valid, out_len)
