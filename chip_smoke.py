#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a) and the
CUDA toolkit; imports nothing of JAX. Phases, each of which fails the run:

1. build: compile every kernel of `mladversarialobjectdetection_torch/csrc`
   with nvcc (`_build.build_all`);
2. kernel vs plain: the NMS kernel against its plain PyTorch version on the
   card, at B=8, N=1024, M=100 (hard and gaussian) and on edge cases:
   indices, valid, valid_len and boxes exactly equal, scores within 1e-6;
3. serve: `Detector("efficientdet-lite4")` at full width with seeded random
   weights serves synthetic 720x1280 frames at batch 1 and 8; the outputs are
   checked, the NMS kernel must have launched once per `serve`, the kernel is
   held against the plain version on the served candidates, and `serve`, the
   device part of it and the kernel alone are timed;
4. card: the `nvidia-smi` name and power limit, and one JSON line with each
   kernel's launches, error, times and bound.

The last line is `{"ok": true, "device": {...}}`. Without a card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

NEG_INF = -1.0e9
SCORE_TOL = 1e-6
# H100 SXM published peaks (NVIDIA data sheet): HBM rate and fp32 outside
# the tensor cores, the unit the NMS kernel's arithmetic runs on
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations the NMS function needs (csrc/nms.cu): each candidate's
# area once per image (2 sub, 2 max0, 1 mul); per (step, candidate) the
# argmax scan (2 compares) on every step; on a step with a valid winner also
# the IoU with the winner (2 min + 2 max + 2 sub + 2 max0 for the
# intersection, 1 mul, 1 add + 1 sub for the union, 1 compare, 1 div,
# 1 select) and the suppression: gaussian 1 mul (iou^2), 1 mul by -1/sigma,
# 1 exp, 1 mul; hard 1 compare, 1 select
NMS_AREA_OPS = 5
NMS_SCAN_OPS = 2
NMS_SUPPRESS_OPS = {"gaussian": 14 + 4, "hard": 14 + 2}

def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def random_boxes(rng, b, n, lo=30.0, hi=600.0, size=(10.0, 160.0)):
    centers = rng.uniform(lo, hi, (b, n, 2))
    sizes = rng.uniform(size[0], size[1], (b, n, 2))
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          -1).astype(np.float32)


def nms_cases(rng):
    """(name, boxes [B,N,4], scores [B,N], kwargs): main shapes and edge cases."""
    hard = dict(method="hard", iou_thresh=0.5, score_thresh=0.3,
                max_output_size=100)
    gauss = dict(method="gaussian", sigma=0.5, score_thresh=0.001,
                 max_output_size=100)
    boxes = random_boxes(rng, 8, 1024)
    scores = rng.uniform(0.0, 1.0, (8, 1024)).astype(np.float32)
    tied = (rng.integers(0, 4, (8, 1024)) / 4.0 + 0.2).astype(np.float32)
    masked = scores.copy()
    masked[rng.uniform(size=masked.shape) < 0.5] = NEG_INF
    same = np.broadcast_to(boxes[:, :1], boxes.shape).copy()
    flat = boxes.copy()
    flat[:, ::3, 2] = flat[:, ::3, 0]  # zero-height boxes
    flat[:, 1::3, 3] = flat[:, 1::3, 1] - 5.0  # negative width
    yield "hard b8 n1024", boxes, scores, hard
    yield "gaussian b8 n1024", boxes, scores, gauss
    yield "tied scores hard", boxes, tied, hard
    yield "tied scores gaussian", boxes, tied, gauss
    yield "NEG_INF masked hard", boxes, masked, dict(hard, score_thresh=None)
    yield "NEG_INF masked gaussian", boxes, masked, gauss
    yield "identical boxes hard", same, scores, hard
    yield "identical boxes gaussian", same, scores, dict(gauss, sigma=0.1)
    yield "zero-area boxes gaussian", flat, scores, gauss
    yield "zero-area boxes hard", flat, scores, hard
    yield "n100 gaussian", boxes[:, :100].copy(), scores[:, :100].copy(), gauss
    yield "exhausted pool n40 m100", boxes[:3, :40].copy(), scores[:3, :40].copy(), \
        dict(hard, score_thresh=None)
    yield "score_thresh 0.0 gaussian", boxes, scores, dict(gauss, score_thresh=0.0)
    yield "score_thresh 0.0 iou 0.0 hard", boxes, scores, \
        dict(hard, score_thresh=0.0, iou_thresh=0.0)
    yield "n3000 m50 sigma 0.3", random_boxes(rng, 2, 3000), \
        rng.uniform(0.0, 1.0, (2, 3000)).astype(np.float32), \
        dict(gauss, sigma=0.3, max_output_size=50)


def compare_nms(name, kern, plain) -> float:
    """Exact indices / valid / valid_len / boxes, scores within SCORE_TOL."""
    import torch

    for field in ("indices", "valid", "valid_len", "boxes"):
        a, b = getattr(kern, field), getattr(plain, field)
        if a.shape != b.shape or not torch.equal(a, b.to(a.dtype)):
            fail(f"{name}: kernel and plain version differ in {field}")
    err = float((kern.scores - plain.scores).abs().max())
    if not err <= SCORE_TOL:
        fail(f"{name}: scores differ by {err} > {SCORE_TOL}")
    return err


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call of fn, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_p50_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median host milliseconds of fn() followed by a device synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_device(fn, label: str) -> None:
    """One traced call of fn: device busy share of the wall time, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%), {launches} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from mladversarialobjectdetection_torch import _build
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.ops import nms, nms_cuda, postprocess

    # fp32 everywhere: the port is held to the fp32 JAX reference, and cuDNN
    # runs fp32 convs in TF32 unless told not to
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 1: build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s, "
          f"{sorted(p.name for p in libs.values())}")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # phase 2: kernel vs plain on the card
    rng = np.random.default_rng(0)
    max_err = 0.0
    n_cases = 0
    for name, boxes, scores, kw in nms_cases(rng):
        tb = torch.from_numpy(boxes).to(dev)
        ts = torch.from_numpy(scores).to(dev)
        kern = nms_cuda.batched_nms_cuda(tb, ts, **kw)
        plain = nms.batched_nms(tb, ts, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_nms(name, kern, plain))
        n_cases += 1
        print(f"  nms {name}: ok, valid_len {kern.valid_len.tolist()}")
    print(f"phase 2 kernel vs plain: {n_cases} cases exact, "
          f"max score error {max_err}")

    # phase 3: serve lite4@640 at full width
    t0 = time.perf_counter()
    det = Detector("efficientdet-lite4", seed=0, device="cuda")
    n_params = sum(p.numel() for p in det.net.parameters())
    print(f"  detector efficientdet-lite4 {det.spec.image_size}, "
          f"{n_params} parameters, built in {time.perf_counter() - t0:.2f} s")
    frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
              for _ in range(8)]
    batches = {1: frames[:1], 8: frames}
    det.serve(frames[:1])  # warm-up outside the counted run
    torch.cuda.synchronize()

    nms_cuda.LAUNCHES = 0
    results = {b: det.serve(batch) for b, batch in batches.items()}
    launches = nms_cuda.LAUNCHES
    if launches != len(batches):
        fail(f"NMS kernel launched {launches} times in {len(batches)} serve calls")
    m = det.config.nms_configs.max_output_size
    for b, res in results.items():
        shapes = {f: getattr(res, f).shape for f in res._fields}
        want = {"boxes": (b, m, 4), "scores": (b, m), "classes": (b, m),
                "valid": (b, m), "valid_len": (b,)}
        if shapes != want:
            fail(f"b{b}: Detections shapes {shapes}, want {want}")
        for f in res._fields:
            if not np.all(np.isfinite(getattr(res, f))):
                fail(f"b{b}: non-finite {f}")
        if not np.all(res.valid_len > 0):
            fail(f"b{b}: valid_len {res.valid_len}")
        if not np.array_equal(res.valid.sum(1), res.valid_len):
            fail(f"b{b}: valid_len disagrees with valid")
    print(f"phase 3 serve: NMS kernel launches {launches} in {len(batches)} "
          f"serve calls; valid_len b1 {results[1].valid_len.tolist()} "
          f"b8 {results[8].valid_len.tolist()}")

    images, scales = det.preprocess(frames)
    images_d = torch.from_numpy(images).to(dev)
    scales_d = torch.from_numpy(scales).to(dev)
    with torch.no_grad():
        cls_out, box_out = det.net(images_d)
        cand_boxes, cand_scores, _ = postprocess._pre_nms_select(
            det._params_dict, cls_out, box_out)
    cand_boxes, cand_scores = cand_boxes.contiguous(), cand_scores.contiguous()
    kw = postprocess.nms_kwargs_from_config(det.config.nms_configs)
    kern = nms_cuda.batched_nms_cuda(cand_boxes, cand_scores, **kw)
    plain = nms.batched_nms(cand_boxes, cand_scores, **kw)
    max_err = max(max_err, compare_nms("served candidates", kern, plain))
    print(f"  served candidates {tuple(cand_boxes.shape)} {kw}: kernel == plain")

    timings = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for b, batch in batches.items():
            serve_ms = host_p50_ms(lambda: det.serve(batch), iters=10)
            dev_ms = host_p50_ms(lambda: det.serve_tensors(
                images_d[:b], scales_d[:b]), iters=10)
            timings[(tf32, b)] = (serve_ms, dev_ms)
            print(f"  serve b{b} cudnn.allow_tf32={tf32} "
                  f"matmul.allow_tf32={tf32}: p50 {serve_ms:.3f} ms/batch "
                  f"({b * 1e3 / serve_ms:.2f} images/s); device part "
                  f"(forward + postprocess) p50 {dev_ms:.3f} ms/batch")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for b, batch in batches.items():
        pre_ms = host_p50_ms(lambda: det.preprocess(batch), iters=5)
        print(f"  host preprocess b{b} (720x1280 -> 640): p50 {pre_ms:.3f} ms")
        profile_device(lambda: det.serve_tensors(images_d[:b], scales_d[:b]),
                       f"device part b{b}")

    kern_ms = cuda_ms(lambda: nms_cuda.batched_nms_cuda(
        cand_boxes, cand_scores, **kw), iters=50)
    plain_ms = cuda_ms(lambda: nms.batched_nms(
        cand_boxes, cand_scores, **kw), iters=5)
    # the serial chain alone: the same launch with every candidate masked
    # runs the M dependent block-wide argmax steps and skips every IoU row
    masked = torch.full_like(cand_scores, NEG_INF)
    chain_ms = cuda_ms(lambda: nms_cuda.batched_nms_cuda(
        cand_boxes, masked, **kw), iters=50)
    b, n = cand_scores.shape
    m = kw["max_output_size"]
    nbytes = b * n * 20 + b * m * (16 + 4 + 4 + 1) + b * 4
    # the kernel skips the IoU row on steps without a valid winner, so the
    # work is counted from this run's valid steps
    ops = n * (b * NMS_AREA_OPS + b * m * NMS_SCAN_OPS
               + int(kern.valid_len.sum()) * NMS_SUPPRESS_OPS[kw["method"]])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  nms [{b},{n}] -> {m}: kernel {kern_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
          f"{nbytes} B, {ops} fp32 ops); serial chain of {m} argmax steps "
          f"(all candidates masked) {chain_ms:.4f} ms, "
          f"{chain_ms * 1e3 / m:.3f} us per step, "
          f"{100 * chain_ms / kern_ms:.1f}% of the kernel")

    # phase 4: card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi.splitlines()[0]}")
    print(json.dumps({"kernels": [{
        "name": "nms", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/nms.cu",
        "replaces": "mladversarialobjectdetection_tpu/ops/pallas_nms.py:34",
        "launches": launches, "max_abs_err": max_err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
