#!/usr/bin/env python3
"""Drive the PyTorch port's serving, attack and defense paths and its
supervised trainer on one CUDA card, and check its kernels.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a) and the
CUDA toolkit; imports nothing of JAX. Phases, each of which fails the run:

1. build: compile every kernel of `mladversarialobjectdetection_torch/csrc`
   with nvcc, one process per source, all at once (`_build.build_all`), and
   print each kernel's ptxas line (each template instance of the fused
   MBConv kernels: registers, shared memory, spills); a spill in a
   main-path kernel fails;
1a. fused MBConv kernels vs plain on odd shapes and on one shape per regime
   of the tile plan: 1x1 and 13x37 maps, C not a multiple of 4, Co > C,
   relu / relu6 / swish, k3 / k5, a split of E at 20x20 with B = 1, the
   16x16 tile, W under the tile, Co and C of 700; forward within
   MBCONV_FWD_TOL of max(1, max|plain|), dx within MBCONV_DX_TOL of
   max|plain| of the plain dx fed the kernel's own relu masks, each mask
   that differs from the plain version's within MBCONV_KINK_TOL of its kink;
   two launches bit-equal; then their bf16 instances on the same shapes
   against the bf16 plain versions, within the MBCONV_BF16_* tolerances,
   and every bf16 forward output within the roundings the bf16 function
   allows (`ops/mbconv.rounding_bound`: an e, d or output rounded the other
   way only where its float32 value lies within the sums' float32 error of a
   bf16 boundary);
2. NMS kernel vs plain: the NMS kernel against its plain PyTorch version on
   the card, at B=8, N=1024, M=100 (hard and gaussian) and on edge cases
   (NaN scores, an early exit after a few valid winners, the all-valid
   chain, N=8192): indices, valid, valid_len and boxes exactly equal, scores
   within 1e-6; the kernel's fast division equal to div.rn on 2^36 pairs of
   each of its two ranges. Wherever NMS is timed (phases 3, 6, 11), the
   kernel's device time is printed beside the chain's time per step on the
   same boxes with seeded uniform scores and all M steps valid (hard, iou
   1.0, no threshold), and beside the same launch with every candidate
   masked, which stops after one step;
3. serve: `Detector("efficientdet-lite4")` at full width with seeded random
   weights serves synthetic 720x1280 frames at batch 1 and 8; the outputs are
   checked, the NMS kernel must have launched once per `serve` and the fused
   MBConv forward kernel 25 times (once per fuseable block; only the 5 other
   blocks run unfused), the NMS kernel is held against the plain version on
   the served candidates, and `serve`, the device part of it and the kernel
   alone are timed;
3a. the rest of serving at batch 8: the post modes per_class, combined and
   tflite, and `pre_nms_approx_topk`, each against the same network outputs
   with the plain NMS; `serve(device_preprocess=True)` against the host
   path; `serve_streams` over three in-memory sources of unequal length and
   `serve_pipelined` with a partial last batch (host and device
   preprocessing), each against `serve` of the same batches;
3b. bf16 serve: `Detector(params={"mixed_precision": True})` at b1 / b8:
   25 launches of the bf16 forward instance per serve and none of the
   float32 one, NMS once per serve, the outputs checked and timed;
4. warp kernels vs plain: the four EOT warp kernels (two forward passes and
   both transposes) against their plain versions on the card, on the
   lite4 window, on edge cases, on an image with 16 windows beside images
   with none, and on the b24 live regime's windows, within WARP_TOL of the
   output's scale, and at the frontier's window 448 (16 windows of one
   image, regions of 300 px, the b24 live regime at scale .6); two
   launches of each kernel must be bit-equal, and an image with no window
   must get an exactly zero canvas gradient;
5. attack step: `PatchAttacker.train_step` on efficientdet-lite4 at 640,
   full width and depth, seeded weights, fp32 (TF32 off), batch 24, window
   320, 256 NMS candidates, in the benchmark's "live" regime (1-5 person
   boxes per image through `boxes_override`, 70 windows per step). The
   counts are set to 0 before the counted steps and read after: the NMS
   kernel must launch once per step (twice with the ASR pass), each warp
   kernel once per step over 70 windows, the fused MBConv forward 50 times
   and its dx 25 times per step; loss, patch and scale are checked; the
   step is timed, profiled and its peak memory read;
5a. the fused victim against the unfused one (every block through
   `_forward_unfused`, cuDNN, TF32 off): logits within VICTIM_TOL of
   max(1, max|ref|), the input gradient of a seeded cotangent on every
   class and box output at cosine >= VICTIM_GRAD_COS, and on one attack
   loss with fixed draws the patch gradient at cosine >= VICTIM_COS;
6. warp kernels in the step: each kernel on the inputs a step gave it,
   against its plain version, timed beside its bound (the input positions
   that a non-zero tap reads, each read once, and the output written once)
   and the plain time, with the windows at r = 1 counted;
6a. fused MBConv kernels in the step: the forward of the 25 blocks of the
   gradient-carrying pass and their 25 dx launches, on the inputs the step
   gave them, against the plain versions (as in 1a, the mask flips counted),
   timed beside the fp32 and 3xTF32 bounds, the plain time, the unfused
   block (cuDNN, TF32 off) and the kernels' SIMT ablation on the same plan;
7. driver: `attack.train.train` for 3 steps at batch 12 (`mixed_precision=
   False`) with a score threshold the random victim passes, so the warp
   runs on its detections; its metrics log and patch artifacts must be
   written;
5b. bf16 attack step: phase 5's step with `config.mixed_precision` (the JAX
   driver's default and bench.py's attack workload: bf16 victim, float32
   patch, EOT composite, warp and loss): each warp kernel and NMS once a
   step, 50 bf16 forward and 25 bf16 dx launches a step and no float32
   MBConv launch; loss and patch checked; timed, profiled, peak memory;
   then phase 5a's check on it (the fused bf16 victim against the unfused
   bf16 one, BF16_VICTIM_TOL, BF16_VICTIM_GRAD_COS and BF16_VICTIM_COS) and
   phase 6a's on the bf16 instances at the bf16 step's own inputs (with
   1a's rounding bound; bounds with the products at the bf16 rate; beside
   cuDNN's unfused bf16 block);
7b. driver with its defaults (bf16): `attack.train.train` for 3 steps at
   batch 12; only bf16 MBConv launches;
8. cmconv kernels vs plain: both instances of the channel-major 3x3 conv
   (`simt` and the 3xTF32 `tc`) against the plain version at every shape of
   the defender's path at full size (batch 24 at 640x640 and 320x320,
   forward with bias and input gradient), within WARP_TOL of the output's
   scale; two launches bit-equal; the wrapper runs the plan's instance; then
   the bf16 instance (`csrc/cmconv_bf16.cu`) at the same shapes against the
   bf16 plain version, with the U-Net's kernels (bf16 values in float32):
   bit-equal, within BF16_CMCONV_TOL of scale, and no float32 launch;
9. defender step: `PatchAttackDefender.train_step` against efficientdet-lite4
   at 640 (full width and depth, seeded weights, fp32, TF32 off), U-Net
   n_filters 8, batch 24, score threshold .0099 so that the random victim's
   detections get patches. The counts are set to 0 before the counted steps
   and read after: 15 cmconv launches per step (8 forward, 7 input
   gradients), the two forward warp passes once per step and no transpose,
   NMS once per step, the fused MBConv forward 25 times and no dx; loss and
   metrics are checked; the step is timed, profiled and its peak memory
   read;
10. `eval_step` (8 cmconv, 3 NMS and 75 fused MBConv forward launches) and
   `recover` (8 cmconv, no MBConv), checked and timed;
11. kernels in the defender step: cmconv on the 15 inputs a step gave it,
   both instances against the plain version, each instance timed beside the
   bound at the fp32 rate and with the products at the 3xTF32 rate, the
   plain time and `F.conv2d` (cuDNN) on the same tensors, summed per step
   and over the 8 forward launches (`recover`'s and `eval_step`'s); the
   cuDNN weight gradient of the same convs; the two forward warp kernels
   (the masker's windows) and NMS (the victim pass) on the inputs the same
   step gave them, against their plain versions;
9b. bf16 defender step: phase 9's step with `config.mixed_precision`
   (bf16 victim and U-Net): 15 bf16 cmconv launches a step and no float32
   one, 25 bf16 fused MBConv forward and no dx, NMS and the two forward
   warp passes once; loss and metrics checked; timed, profiled, peak memory
   beside the fp32 step's; its `eval_step` and `recover` checked and timed;
11, bf16: the bf16 instance on the 15 inputs the bf16 step gave it,
   against the bf16 plain version (bit-equal), each launch timed beside its
   bound with 2-byte x, bias and output and the products at the bf16
   tensor-core rate (the kernels hold bf16 values: checked), beside the
   bound at fp32 FMAs, the plain time and `F.conv2d` in bf16 (cuDNN) on the
   same tensors;
9c. packed defender (`packed=1, 2, 3`, fp32, phase 9's victim, weights and
   images): its `recover` against the unpacked `recover` within
   RECOVER_TOL of the pre-tanh logits' scale; one train-mode pass's
   parameter gradients at dropout 0 against the unpacked U-Net's on the
   same masked images: in float64 each leaf within PACKED_GRAD_F64_TOL of
   its scale, the float32 gradient as a whole within PACKED_GRAD_TOL
   (relative L2) of the float64 one; every
   cmconv call of its train step (the packed 12 -> 32, 32 -> 32 forwards
   and 32 -> 32, 32 -> 12 input gradients at 320x320 among them) against
   the plain version within WARP_TOL of scale, two launches bit-equal, the
   packed ones timed beside `F.conv2d`; its train step's cmconv and NMS
   launches checked, timed, with its peak memory;
9d. remat: one fp32 train step's parameter gradients and BatchNorm
   statistics with every U-Net block recomputed against remat=False's, on
   the same masks (cuDNN deterministic: bit-equal, else within REMAT_TOL);
   the defender step with the remat U-Net (15 + 8 cmconv launches) timed,
   its peak memory beside the step's without;
12. driver: `defense.train.train` for 3 steps at batch 12 with score
   threshold .0099; its metrics log and `antipatch.pkl` must be written;
   then with `bf16=True` (only bf16 cmconv and MBConv launches) and with
   `packed=3`, 3 steps each;
14. trainer, card against CPU: one `DetectorTrainer.train_step` at
   lite0@128 b2 from the same seeded weights and scenes on the card and on
   the CPU, in float64 (within TRAIN_F64_TOL of each leaf's scale) and
   float32 (TRAIN_F32_TOL), parameters and BatchNorm statistics and loss;
15. trainer at lite4@640 b24 (examples/northstar_soak.py's operating
   point: SGD .08 from a warmup of .004, no EMA; `train/victim.make_config`)
   in fp32 and bf16 on the port's scene pool (`data/pipeline.ScenePool`),
   2 + TRAIN_STEPS steps each: p50, images/s, peak memory, det_loss at each
   step (finite), 0 fused MBConv launches and 30 `_forward_unfused` calls
   a step, busy share and top kernels of one profiled step;
16. save and serve: the bf16 victim's `eval_variables` through
   `torch_to_flax` into `ckpt.io.save_pytree`, served back at b8 by
   `Detector(ckpt_path=)` (25 fused forward and 1 NMS launches) with the
   detections of the victim in memory, exactly;
17. attack driver from that file (`victim_ckpt`), batch 12, two epochs of
   2 steps, uninterrupted and killed after one epoch and resumed, cuDNN
   deterministic: patch, scale, Adam moments and LR, step and generator
   bit-equal (else within RESUME_TOL);
18. the same for the defense driver, its `initial_weights` the
   `antipatch.pkl` of a first run;
19. the example workflows' stages (`mladversarialobjectdetection_torch/
   examples/`) on that victim file at lite4@640 b24 bf16, score threshold
   .0099 (the 12-step victim would fail the production soak's detection
   gate at .5, so the stages are called directly). Each train step's
   launches are counted: every warp kernel once, NMS once (twice with the
   ASR pass), 50 bf16 MBConv forward and 25 dx, no float32 MBConv; and
   every kernel of the path must have launched in each phase.
   19a: the north-star epoch loop, 2 epochs of 3 steps, 1 val batch x 2
   draws: `northstar.json` rows with val_asr_to_scale = val_asr / (scale +
   1e-7) and the TPU record's keys, the best artifact equal to its epoch's
   state, a restart from it (`initial_patch`, `initial_lr`) starting from
   that patch, scale and lr exactly;
   19b: the frontier at window 448, one scale for 3 steps and 4 val
   batches x 4 draws, the scale bit-equal to its pin in every evaluation,
   `frontier.json`'s keys; then the warp kernels at window 448 on a
   frontier step's inputs (the b24 live regime) against the plain passes,
   timed beside their bounds;
   19c: the production soak's attack stage (3 steps) and defender stage (2
   steps of 15 bf16 cmconv launches, 1 NMS and 25 bf16 MBConv forward, one
   eval of 2 batches): recovery PSNR and ADR finite, or NaN only where the
   defender defines NaN (the case printed), `soak.json`'s keys, the
   antipatch file read back equal;
20. the video demos' device path (`demo/`) at lite4@640, seeded weights,
   on 8 synthetic 720x1280 frames (`demo/synthetic_clip.render_frames`):
   `make_demo_detector`'s `infer` (gaussian NMS at score 0, where every
   candidate stays valid and the chain runs to the end: 1 NMS and 25 fused
   MBConv forward launches a frame) and `RecoveryDemo.recover`, the U-Net on
   one normalized 640 px frame (8 cmconv launches a frame), its seeded
   weights written with `ckpt/io` and read back through `load_antipatch`;
   the NMS kernel against the plain version on the phase's own score-0
   candidates and cmconv against `cmconv_plain` on the U-Net's b1 inputs,
   each timed beside its bound; p50 ms per frame of detection and of
   recovery. The demos' cv2 parts (reading, drawing, writing, the recovered
   frame's resize) are held to JAX on the CPU (tests/test_torch_demo.py);
   none is imported here;
21. the rest of the supervised trainer (lite4@640, 90 classes, 76,725
   anchors), with phase 16's victim file:
   21a: the supervised driver `train.train` (synthetic input, fp32, batch
   8, 2 epochs of 3 steps): `ckpt-0`, `ckpt-1` and `state-latest.msgpack`
   written, 0 fused MBConv launches while training; `resume=True` to 3
   epochs starts at epoch 2 and ends at step 9, and `ckpt-1` reads back
   equal to the state it was saved from; with `prune_sparsity=0.5,
   prune_end=6` every kernel at .5 within one weight and the EMA zero
   wherever the parameters are; p50 step ms, images/s and peak memory;
   21b: `train.evaluate_map` on the victim over 4 batches of 24 held-out
   `ScenePool` scenes (their own seed), NMS and the evaluation at score
   .0099 (the 12-step victim scores about .01): per batch 25 bf16 fused MBConv
   forward and 1 NMS launches; AP, AP50, AP75 and the other 9 metrics within
   EVAL_AP_TOL of the same evaluation with the plain versions of both ops
   on the card; AP and
   ms a batch; the NMS kernel and the 25 bf16 forward launches timed at an
   eval batch's inputs beside their bounds and plain versions;
   21c: `segmentation.train` (heads ("segmentation",), batch 8, 3 steps):
   a finite loss and logits [8, 160, 160, 3]; p50 step ms, peak memory;
   21d: `grad_checkpoint` at the trainer's operating point
   (`train/victim.make_config`, b24, fp32): one step with it on and off
   from the same state, loss, gradients and BatchNorm statistics within
   TRAIN_F32_TOL (cuDNN deterministic: bit-equal expected), each one's
   peak memory and step time;
   21e: the native TFRecord reader (`csrc/tfrecord_native.c`) built with
   the host C compiler, reading records written by `make_example` and
   `write_records` (raw image bytes: no PIL here): payloads equal to the
   pure-python framing's, and a flipped CRC raises;
22. export and quantize (lite4@640, seeded weights), with phase 16's victim:
   22a: the int8 conv kernel (`csrc/conv_int8.cu`) against `conv_int8_plain`
   on odd shapes (a 1x1 map, 13x37, C not a multiple of 4, stride 2 at odd
   sizes, k5 depthwise, the pooled [B, C, 1, 1] case, a bias, bf16 x and
   output, VALID, Co over many tiles) and then at every conv call of a b8
   int8 serve, fp32 and bf16: the int32 sums and the outputs bit-equal, two
   launches bit-equal; each serve call timed beside its bound (int8 products
   at 1,979 TOPS, bytes at 3.35 TB/s), the plain version, `torch._int_mm` on
   the 1x1 convs and cuDNN's bf16 conv of the same shape; what `F.conv2d`
   does with int8 CUDA tensors, as a record;
   22b: `Detector.quantize_int8` on 16 seeded 720x1280 frames, fp32 and
   bf16: every eligible conv quantised (no `predict`), a b1 and a b8 serve
   with conv_int8 at two launches a conv call (the heads' shared convs at
   each level), NMS once a serve, no fused MBConv launch; b8 detections
   equal to those of the same detector on `conv_int8_plain`; against the
   float serve the largest score difference and the top detection's
   agreement; p50 at b1 and b8 of the float and int8 serves in both
   dtypes, peak memory and the device's busy share;
   22c: `Detector.export` (the float program after `quantize_int8`) fp32
   and bf16 at b1: the graph holds the NMS op once and the fused MBConv op
   25 times; `ExportedProgramDriver.serve` launches them and equals
   `Detector.serve`; export, load and both p50s;
   22d: `python -m ...inference.inspector --mode benchmark --batch-size 8`
   and `--mode dry` (whose checkpoint serves as the seeded detector); the
   victim exported per_class at b8 and `train.eval.evaluate(artifact=)`
   over TFRecords of zlib PNGs (no PIL on the card's machine) equal to the
   live victim's metrics within 1e-6;
13. card: the `nvidia-smi` name and power limit, and one JSON line with each
   kernel's launches, error, times and bound (cmconv's also with its
   ablation, the instance the plan did not pick, and its bound at 3xTF32;
   cmconv's bf16 instance, and the fused MBConv's float32 and bf16
   instances, each a row; NMS, cmconv and the fused forward also with phase
   20's launches per frame, and NMS and cmconv with their times there; NMS
   and the bf16 fused forward also with phase 21b's launches per
   `evaluate_map` batch and their times at its inputs; `conv_int8` with
   phase 22b's launches in a b1 and a b8 fp32 int8 serve and phase 22a's
   times summed over a b8 serve's calls, `torch._int_mm` as its library
   time on the 1x1 convs, cuDNN's bf16 convs beside it).

The last line is `{"ok": true, "device": {...}}`. Without a card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import copy
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
# argmax scan (2 compares) on every step it runs; on a step with a valid winner also
# the IoU with the winner (2 min + 2 max + 2 sub + 2 max0 for the
# intersection, 1 mul, 1 add + 1 sub for the union, 1 compare, 1 div,
# 1 select) and the suppression: gaussian 1 mul (iou^2), 1 mul by -1/sigma,
# 1 exp, 1 mul; hard 1 compare, 1 select
NMS_AREA_OPS = 5
NMS_SCAN_OPS = 2
NMS_SUPPRESS_OPS = {"gaussian": 14 + 4, "hard": 14 + 2}
# hard NMS that suppresses nothing and has no threshold: every one of the M
# steps is valid while candidates remain, so the whole chain runs
ALL_VALID = dict(method="hard", iou_thresh=1.0, score_thresh=None,
                 max_output_size=100)
# warp and cmconv kernels vs plain: float32 sums in another order (cmconv's
# as FMAs, or as 3xTF32 tensor-core products in its `tc` instance)
WARP_TOL = 1e-5
# fp32 operations of the warp functions (csrc/warp.cu): per non-zero tap the
# hat (sub, abs, div, sub, max), three FMAs and the normaliser's add; per
# output of a forward pass the affine index (2 mul, 2 add) and the
# normalisation (max, div, 3 mul); per element a transpose divides (the
# affine index, max, 3 div)
WARP_TAP_OPS = 5 + 6 + 1
WARP_FWD_OUT_OPS = 4 + 5
WARP_BWD_OUT_OPS = 4 + 1 + 3
WARP_KERNELS = ("pass1_fwd", "pass2_fwd", "pass2_bwd", "pass1_bwd")
WARP_REPLACES = {  # the Pallas kernels of v1; v2's are listed in PERF.md
    "pass1_fwd": "tools/experiments/pallas_warp.py:73",
    "pass2_fwd": "tools/experiments/pallas_warp.py:120",
    "pass2_bwd": "tools/experiments/pallas_warp.py:139",
    "pass1_bwd": "tools/experiments/pallas_warp.py:89",
}
# fused MBConv kernels vs plain: the kernels' 1x1 products are 3xTF32 on the
# tensor cores, summed in another order (forward within MBCONV_FWD_TOL of
# max(1, max|plain|)); dx within MBCONV_DX_TOL of max|plain| of the plain dx
# fed the kernel's own relu masks, and every element whose mask differs from
# the plain version's within MBCONV_KINK_TOL * max(1, max|z|) of its kink
MBCONV_FWD_TOL = 1e-5
MBCONV_DX_TOL = 1e-4
MBCONV_KINK_TOL = 1e-5
# the bf16 instances vs their bf16 plain versions: the same rounding points
# (e, d, gd, ge and the output), float32 sums in another order, so an
# intermediate within float32 rounding of a bf16 rounding boundary can round
# the other way (one bf16 ulp, 2^-8 relative, moved downstream): forward
# within MBCONV_BF16_FWD_TOL of max(1, max|plain|), dx within
# MBCONV_BF16_DX_TOL of max|plain| of the plain dx fed the kernel's own
# masks, four bf16 ulps of scale; a flipped mask within MBCONV_BF16_KINK_TOL
# of its kink over max(1, max|z|) (z1 sums bf16 e, one of which may have
# rounded the other way)
MBCONV_BF16_FWD_TOL = 2.0 ** -6
MBCONV_BF16_DX_TOL = 2.0 ** -6
MBCONV_BF16_KINK_TOL = 2.0 ** -8
# the fused victim against the unfused one (phase 5a): logits within
# VICTIM_TOL of max(1, max|ref|), the attack's patch gradient at cosine >=
# VICTIM_COS, and the input gradient of a seeded cotangent on every output
# at cosine >= VICTIM_GRAD_COS (float32: sums in another order only)
VICTIM_TOL = 2e-4
VICTIM_COS = 0.9999
VICTIM_GRAD_COS = 0.9999
# bf16: the two round at other points (the fused block rounds e once, the
# unfused one after each conv, BN and activation), as the port's bf16 net
# and JAX's do. Readings of this script on an H100 80GB HBM3 at 700 W, the
# same in every run: logits 4.58e-05 of scale, patch gradient cosine
# 1.00000000 (mostly its TV term), the input gradient of the seeded
# cotangent 0.80113035. That gradient is bf16's own at lite4's depth: the
# fused one lies at cosine 0.80517509 of the float32 victim's, cuDNN's
# unfused one at 0.80404789. The limits: about four times the
# logits' reading, 0.05 under the input gradient's, and the fused gradient
# no further from the float32 one than the unfused, less
# BF16_VS_FP32_MARGIN. A zero or sign-flipped gradient reads 0 or below.
BF16_VICTIM_TOL = 2e-4
BF16_VICTIM_COS = 0.9999
BF16_VICTIM_GRAD_COS = 0.75
BF16_VS_FP32_MARGIN = 0.02
# the bf16 cmconv instance vs the bf16 plain version: one bf16 ulp of the
# sum's rounding and one of the bias add's, at most 2^-6 of the output's
# scale (ops/cmconv.BF16_TOL); at the U-Net's kernels it is bit-equal
BF16_CMCONV_TOL = 2.0 ** -6
# the 1x1 products at the 3xTF32 rate: three TF32 tensor-core products each
TC3_FLOP_PER_S = 495e12 / 3
# the bf16 instance's products: dense bf16 on the tensor cores
BF16_FLOP_PER_S = 989e12
MBCONV_PER_PASS = 25   # lite4's fuseable blocks: all but 0 (e1), 1, 5, 9, 21
UNFUSED_PER_PASS = 5
MBCONV_REPLACES = {"fwd": "tools/experiments/fused_mbconv.py:212",
                   "dx": "tools/experiments/fused_mbconv.py:282"}
# (name, B, H, W, C, E, Co, k, residual, act): shapes off the path's
# and one per regime of the tile plan (ops/mbconv_cuda.plan_fwd / plan_dx)
MBCONV_ODD = [("1x1 b3 k5", 3, 1, 1, 8, 48, 8, 5, True, "relu6"),
              ("13x37 k3", 1, 13, 37, 16, 96, 24, 3, False, "relu6"),
              ("C13 -> 20 relu", 3, 12, 10, 13, 78, 20, 3, False, "relu"),
              ("k5 swish", 2, 18, 22, 16, 96, 24, 5, False, "swish"),
              ("272 -> 448 at 20x20", 8, 20, 20, 272, 1632, 448, 3, False, "relu6"),
              ("split E at 20x20 b1 k5", 1, 20, 20, 272, 1632, 272, 5, True, "relu6"),
              ("16x16 tile at 96x96", 2, 96, 96, 32, 192, 32, 3, True, "relu6"),
              ("W < tile 24x5 k5", 2, 24, 5, 56, 336, 56, 5, True, "relu"),
              ("Co 700 > C, C 30", 1, 12, 12, 30, 180, 700, 3, False, "relu6"),
              ("C 700 in dx", 1, 10, 10, 700, 1400, 700, 3, True, "relu6")]
ATTACK_BATCH = 24
ATTACK_WINDOW = 320
ATTACK_STEPS = 3
FRONTIER_WINDOW = 448   # examples/northstar_soak.py --frontier
DEFEND_BATCH = 24
DEFEND_STEPS = 2
DEFEND_THRESH = 0.0099  # under the random victim's scores (about 0.01)
CMCONV_PER_STEP = 15    # 8 forward + 7 input gradients
# the packed U-Net's cmconv launches per train step: a packed 3x3 conv goes
# to cmconv where both packed channel counts are at most 32 (conv0's two
# and deconv3's second: 3 forward, 2 input gradients); at level 1 the
# unpacked conv1 and deconv2 blocks add 4 convs (4 forward, 4 gradients)
PACKED_LEVELS = (1, 2, 3)
PACKED_CMCONV_PER_STEP = {1: 13, 2: 5, 3: 5}
# the packed recover against the unpacked one on the same weights: float32
# sums in another order, within 2e-4 of max(1, max|pre-tanh logits|) (tanh
# is 1-Lipschitz; the ROADMAP rule on the head's output)
RECOVER_TOL = 2e-4
# the packed U-Net's parameter gradients (one train-mode pass, dropout 0)
# against the unpacked one's on the same weights and inputs. The function is
# held in float64 (both U-Nets' 3x3 convs as float64 `F.conv2d`s), each leaf
# within PACKED_GRAD_F64_TOL of its largest entry: what is left is level 1's
# packed kernel passed to cmconv in float32 and its gradient rounded there.
# In float32 a leaf is no stable measure: the gate BatchNorm's one-channel
# scale and bias are each one sum over B*H*W terms that may cancel (one run
# on an H100 80GB HBM3 at 700 W read 0.022 of its value between packed and
# unpacked on deconv1.attention.bn3.bias; the unpacked float32 gradient's
# own worst leaf against float64 is printed). So the float32 route, kernels
# included, is held as a whole: the relative L2 distance of the packed
# float32 gradient from the float64 one within PACKED_GRAD_TOL, the
# unpacked one's printed beside it
PACKED_GRAD_F64_TOL = 1e-6
PACKED_GRAD_TOL = 1e-3
# remat against no remat, one train step's parameter gradients with cuDNN
# deterministic: bit-equal expected (the recompute replays the same masks
# on the same inputs); else within REMAT_TOL of each gradient's scale
REMAT_TOL = 1e-5

# the supervised trainer (phases 14-18). Card against CPU at lite0@128 b2:
# float64 (cuDNN and ATen at 64 bits compute the same function; sums in
# another order) within TRAIN_F64_TOL of max(1, max|cpu|) per leaf; float32
# within TRAIN_F32_TOL: train-mode BatchNorm over 2 images of 4x4 maps
# magnifies float32 sum-order differences (JAX's own float32 step lies up to
# 6.5e-3 of scale off its float64 one at this size, tests/test_torch_train.py)
TRAIN_F64_TOL = 1e-6
TRAIN_F32_TOL = 2e-2
TRAIN_BATCH = 24
TRAIN_STEPS = 10
TRAIN_POOL_BATCHES = 2  # northstar renders 12; 48 scenes keep the host part short
DRIVER_BATCH = 12
# phase 21: the rest of the supervised trainer
SUP_BATCH = 8           # the driver's and the segmentation trainer's batch
SUP_STEPS = 3           # steps per epoch of the driver
EVAL_BATCHES = 4        # evaluate_map: 4 batches of 24 held-out scenes
EVAL_AP_TOL = 1e-3      # each COCO metric with the kernels vs the plain versions
# kill and resume on the card: bit-equal expected (cuDNN deterministic, the
# same kernels on the same inputs); where ATen's CUDA backward of a gather
# or index op adds with atomics, float32 sums may reorder between runs, so a
# difference is printed and held within RESUME_TOL of max(1, max|ref|)
RESUME_TOL = 1e-5
# phase 22: the int8 serve, export and the inspector. The int8 conv kernel
# is held bit-equal to its plain version (integer sums are exact; the
# epilogue keeps the multiply and the add apart); its bound counts the int8
# products at the dense int8 tensor-core rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
INT8_CALIB_FRAMES = 16
EVAL_ARTIFACT_BATCHES = 2   # eval --artifact: 2 batches of 8 scenes
CONV_INT8_REPLACES = ("no Pallas counterpart: XLA's int8 lax.conv_general_dilated with "
                      "preferred_element_type=int32, "
                      "mladversarialobjectdetection_tpu/inference/quantize.py:168-173")
# (name, B, C, H, W, Co, k, stride, padding, depthwise, bias, dtype of x and out)
CONV_INT8_ODD = [
    ("1x1 map", 3, 24, 1, 1, 40, 1, 1, "SAME", False, True, "float32"),
    ("13x37 k3", 2, 16, 13, 37, 24, 3, 1, "SAME", False, False, "float32"),
    ("C 13 not a multiple of 4", 2, 13, 12, 10, 20, 3, 1, "SAME", False, True, "bfloat16"),
    ("stride 2 at odd 15x17", 2, 12, 15, 17, 16, 3, 2, "SAME", False, False, "float32"),
    ("k5 depthwise stride 2 at odd 15x13", 2, 40, 15, 13, 40, 5, 2, "SAME", True, False,
     "bfloat16"),
    ("k5 depthwise with bias", 1, 96, 20, 20, 96, 5, 1, "SAME", True, True, "float32"),
    ("pooled [B, C, 1, 1]", 4, 64, 1, 1, 16, 1, 1, "SAME", False, True, "bfloat16"),
    ("VALID 3x3", 2, 16, 9, 9, 24, 3, 1, "VALID", False, False, "float32"),
    ("Co 700 over 11 tiles, K 612", 1, 272, 10, 10, 700, 3, 1, "SAME", False, True,
     "float32"),
]
# the cmconv instances (ops/cmconv_cuda.ENTRIES) and their kernels' names
CMCONV_INSTANCES = ("simt", "tc")
CMCONV_KERNEL = {"simt": "cmconv3x3_kernel", "tc": "cmconv3x3_tc_kernel"}
# (role, C, Co, side) of every cmconv launch of a defender step at 640x640,
# n_filters 8: the forward convs of conv0, conv1, deconv2.convblock and
# deconv3.convblock, then their input gradients (C and Co swapped), all but
# that of conv0.cnv1, whose input is the image
CMCONV_SHAPES = (
    [("fwd", 3, 8, 640), ("fwd", 8, 8, 640), ("fwd", 8, 16, 320),
     ("fwd", 16, 16, 320), ("fwd", 32, 16, 320), ("fwd", 16, 16, 320),
     ("fwd", 16, 8, 640), ("fwd", 8, 8, 640)]
    + [("dx", 8, 8, 640), ("dx", 8, 16, 640), ("dx", 16, 16, 320),
       ("dx", 16, 32, 320), ("dx", 16, 16, 320), ("dx", 16, 8, 320),
       ("dx", 8, 8, 640)])


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
    nan = scores.copy()
    nan[rng.uniform(size=nan.shape) < 0.02] = np.nan  # NaN wins, never valid
    yield "NaN scores hard", boxes, nan, hard
    yield "NaN scores gaussian", boxes, nan, gauss
    # about 1 in 20 over .5: a few valid winners, then the early exit
    yield "early exit hard", boxes, scores * 0.525, dict(hard, score_thresh=0.5)
    yield "early exit gaussian", boxes, scores * 0.525, dict(gauss, score_thresh=0.5)
    yield "all-valid chain", boxes, scores, ALL_VALID
    big = random_boxes(rng, 2, 8192)
    big_scores = rng.uniform(0.0, 1.0, (2, 8192)).astype(np.float32)
    yield "n8192 gaussian", big, big_scores, gauss
    big_scores[:, rng.uniform(size=8192) < 0.01] = np.nan
    yield "n8192 NaN hard", big, big_scores, hard


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


def profile_device(fn, label: str, top: int = 6, sessions: int = 3) -> None:
    """One traced call of fn: device busy share of the wall time, top kernels.
    A session that records no device activity is tried again, up to
    `sessions` times, and then reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        if busy_us > 0:
            break
    else:
        print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy not "
              f"measured (the profiler saw no device activity in {sessions} "
              f"sessions)")
        return
    launches = sum(e.count for e in kernels)
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%), {launches} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")


def kernel_device_ms(fn, kernel: str, iters: int = 10, sessions: int = 3) -> float:
    """Mean device ms per launch of the CUDA kernel whose name contains
    `kernel`, from torch.profiler over `iters` calls of fn (the host work
    around each launch is left out).

    A profiler session now and then records no device activity at all. Such a
    session is tried again; after `sessions` empty ones the time is taken by
    CUDA events instead, which include the host work between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        total_us = sum(e.self_device_time_total for e in hits)
        count = sum(e.count for e in hits)
        if count and total_us > 0:
            return total_us / 1e3 / count
        print(f"  profiler session {attempt} of {sessions} saw no device time "
              f"of kernel {kernel}")
    ms = cuda_ms(fn, iters=max(iters, 10))
    print(f"  {kernel}: timed by CUDA events instead, {ms:.4f} ms per call "
          f"(host work between launches included)")
    return ms


def kernel_name(mangled: str) -> str:
    """The `*_kernel` component of an Itanium-mangled entry name, with its
    integer and bool template arguments: `mbconv_fwd_kernel<3,8,8,8,1,1>`."""
    import re

    names, i = [], 0
    while i < len(mangled):
        digits = len(mangled[i:]) - len(mangled[i:].lstrip("0123456789"))
        if digits:
            n = int(mangled[i:i + digits])
            names.append((mangled[i + digits:i + digits + n], i + digits + n))
            i += digits + n
        else:
            i += 1
    hits = [(x, end) for x, end in names if x.endswith("_kernel")]
    if not hits:
        return mangled
    name, end = hits[-1]
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
    if args:
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
    return name


# libraries on the main path: a spill in their kernels fails phase 1
MAIN_PATH_LIBS = ("nms", "warp", "cmconv", "cmconv_bf16", "cmconv_tc", "mbconv",
                  "mbconv_dx", "mbconv_bf16", "mbconv_bf16_dx")


def print_ptxas(libs) -> None:
    """Each kernel's registers, shared memory and spills from nvcc's log;
    fail on a spill in a main-path library."""
    import re

    spills = []
    for lib, path in libs.items():
        kernel = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {lib}/{kernel}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if m and int(m.group(1)) and lib in MAIN_PATH_LIBS:
                    spills.append(f"{lib}/{kernel}")
    if spills:
        fail(f"register spills in main-path kernels: {spills}")


def nms_numbers(boxes, scores, kw, label: str):
    """(kernel ms, plain ms, bound ms, bound_by, max error) of the NMS kernel
    on these candidates, which must match the plain version; beside it the
    chain's time per step on the same boxes with every step valid."""
    import torch
    from mladversarialobjectdetection_torch.ops import nms, nms_cuda

    kern = nms_cuda.batched_nms_cuda(boxes, scores, **kw)
    plain = nms.batched_nms(boxes, scores, **kw)
    err = compare_nms(label, kern, plain)
    m = kw["max_output_size"]
    # the chain: the same boxes with seeded uniform scores (the path's own may
    # be masked), hard, nothing suppressed, no threshold: every step valid
    chain_kw = dict(ALL_VALID, max_output_size=m)
    chain_scores = torch.rand(scores.shape, device=scores.device,
                              generator=torch.Generator(scores.device).manual_seed(0))
    chain = nms_cuda.batched_nms_cuda(boxes, chain_scores, **chain_kw)
    compare_nms(f"{label}, all-valid chain", chain,
                nms.batched_nms(boxes, chain_scores, **chain_kw))
    # steps the chain runs: all M where every image has M candidates
    chain_steps = int(torch.clamp(chain.valid_len + 1, max=m).max())
    kern_ms, chain_ms, masked_ms = (
        kernel_device_ms(lambda: nms_cuda.batched_nms_cuda(boxes, sc, **k),
                         "nms_kernel", iters=20)
        for sc, k in ((scores, kw), (chain_scores, chain_kw),
                      (torch.full_like(scores, NEG_INF), kw)))
    plain_ms = cuda_ms(lambda: nms.batched_nms(boxes, scores, **kw), iters=5)
    b, n = scores.shape
    nbytes = b * n * 20 + b * m * (16 + 4 + 4 + 1) + b * 4
    # the work is counted from this run's data: an IoU row on each valid
    # step, and an argmax scan on each step up to the first invalid one, where
    # the kernel stops (NaN winners aside, which these inputs do not have)
    n_valid = int(kern.valid_len.sum())
    steps = int(torch.clamp(kern.valid_len + 1, max=m).sum())
    ops = n * (b * NMS_AREA_OPS + steps * NMS_SCAN_OPS
               + n_valid * NMS_SUPPRESS_OPS[kw["method"]])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  nms {label} [{b},{n}] -> {m}: kernel {kern_ms:.4f} ms ({n_valid} "
          f"valid rows of {b * m}), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} fp32 ops); chain "
          f"with {chain_steps} of {m} steps valid (hard, iou 1.0, no threshold) "
          f"{chain_ms:.4f} ms, {chain_ms * 1e3 / chain_steps:.3f} us per step; every "
          f"candidate masked (exits after one step) {masked_ms:.4f} ms; max "
          f"error {err}")
    return kern_ms, plain_ms, bound_ms, bound_by, err


def make_live_slot_boxes(batch: int, image_hw, max_boxes: int = 16,
                         lives=(1, 2, 3, 4, 5), seed: int = 0):
    """Pinned person boxes: image i gets lives[i % len] valid slots.

    A copy of bench.py:48-70 (its "live" regime): heights 150-400 px, aspect
    0.3-0.5, placed in bounds, from a seeded numpy generator; at batch 24,
    70 live slots and a batch maximum of 5."""
    h, w = image_hw
    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    valid = np.zeros((batch, max_boxes), bool)
    for i in range(batch):
        for j in range(lives[i % len(lives)]):
            bh = rng.uniform(150.0, 400.0)
            bw = bh * rng.uniform(0.3, 0.5)
            y0 = rng.uniform(0.0, h - bh)
            x0 = rng.uniform(0.0, w - bw)
            boxes[i, j] = (y0, x0, y0 + bh, x0 + bw)
            valid[i, j] = True
    return boxes, valid


def warp_case(rng, n_images, n, p0, w, *, angle_deg=None, size=None,
              shift=0.0, images=None):
    """(canvases [B, p0, p0, 3] on the card, host window table [n, 8]) of
    random windows of `images` (else random images); each region lies in its
    window unless `shift` moves it."""
    import torch
    from mladversarialobjectdetection_torch.ops import eot

    size = np.full(n, size) if size is not None else rng.uniform(40, 200, n)
    diag = np.minimum(np.sqrt(2.0) * size, w)
    ymin = rng.uniform(0, np.maximum(w - diag, 1e-3)) + shift
    xmin = rng.uniform(0, np.maximum(w - diag, 1e-3)) + shift
    angle = (np.full(n, angle_deg) if angle_deg is not None
             else rng.uniform(-20, 20, n)) * np.pi / 180
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    zero = f(np.zeros(n))
    table = eot.window_table(p0, zero, zero, f(ymin), f(xmin), f(size),
                             f(diag), f(angle),
                             torch.from_numpy(rng.integers(0, n_images, n)
                                              if images is None else np.asarray(images)))
    canvases = torch.from_numpy(rng.uniform(
        -1, 1, (n_images, p0, p0, 3)).astype(np.float32)).cuda()
    return canvases, table


def warp_cases(rng):
    """(name, w, canvases, table): the lite4 window and the edge cases."""
    import torch

    yield ("p96 w320 rot -20", 320, *warp_case(rng, 2, 3, 96, 320, angle_deg=-20))
    yield ("p96 w320 rot 0 rho<1", 320, *warp_case(rng, 2, 3, 96, 320,
                                                   angle_deg=0, size=150.0))
    yield ("p96 w320 rot +20 rho 1.6", 320, *warp_case(rng, 2, 3, 96, 320,
                                                       angle_deg=20, size=60.0))
    yield ("partly outside", 320, *warp_case(rng, 2, 3, 96, 320, shift=150.0))
    yield ("wholly outside", 320, *warp_case(rng, 2, 3, 96, 320, shift=5000.0))
    yield ("size 1", 160, *warp_case(rng, 1, 2, 96, 160, size=1.0))
    yield ("w160", 160, *warp_case(rng, 2, 4, 96, 160))
    yield ("w200", 200, *warp_case(rng, 2, 4, 96, 200))
    yield ("w384", 384, *warp_case(rng, 2, 4, 96, 384))
    yield ("p32 w200", 200, *warp_case(rng, 3, 5, 32, 200))
    yield ("b24 70 windows", 320, *warp_case(rng, 24, 70, 96, 320))
    yield ("16 windows of one image beside images with none", 320,
           *warp_case(rng, 4, 16, 96, 320, images=np.full(16, 2)))
    table = live_regime_table()
    yield ("b24 live regime", ATTACK_WINDOW, torch.from_numpy(rng.uniform(
        -1, 1, (ATTACK_BATCH, 96, 96, 3)).astype(np.float32)).cuda(), table)
    # the frontier's window (examples/northstar_soak.py --frontier): regions
    # up to 448 / sqrt(2) px, so sizes up to 316
    yield ("w448 16 windows of one image beside images with none", FRONTIER_WINDOW,
           *warp_case(rng, 4, 16, 96, FRONTIER_WINDOW, images=np.full(16, 2)))
    yield ("w448 size 300", FRONTIER_WINDOW,
           *warp_case(rng, 3, 6, 96, FRONTIER_WINDOW, size=300.0))
    yield ("b24 live regime at w448, scale .6", FRONTIER_WINDOW, torch.from_numpy(
        rng.uniform(-1, 1, (ATTACK_BATCH, 96, 96, 3)).astype(np.float32)).cuda(),
        live_regime_table(window=FRONTIER_WINDOW, scale=0.6))


def live_regime_table(seed: int = 0, window: int = ATTACK_WINDOW,
                      scale: float = 0.4):
    """The host window table of `make_live_slot_boxes`' b24 regime at 640,
    canvas 96, at the attacker's initial scale .4 and window 320 (or the
    frontier's window 448 at a pinned scale): the attack step's windows
    before its draws move them."""
    import torch
    from mladversarialobjectdetection_torch.ops import eot

    boxes, valid = make_live_slot_boxes(ATTACK_BATCH, (640, 640), 16)
    geom = eot.make_patch_geometry(
        torch.from_numpy(boxes), torch.from_numpy(valid), scale, (640, 640),
        max_region=float(window),
        generator=torch.Generator().manual_seed(seed))
    live = eot._live_windows(geom, 640, 640, window)
    return eot.window_table(96, *live.geom.unbind(-1), live.image)


def kernel_err(name, kern, plain) -> float:
    """Max abs error of a warp or cmconv kernel, within WARP_TOL of the
    output's scale."""
    err = float((kern - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    if not err <= WARP_TOL * scale:
        fail(f"{name}: kernel and plain differ by {err} > {WARP_TOL} * {scale}")
    return err


def check_warp(name, canvases, table, w, g=None):
    """The four warp kernels against the plain passes on the same CUDA
    tensors, and each kernel launched twice bit-equal. Returns the max error
    per kernel and whether the forward output was all zero."""
    import torch
    from mladversarialobjectdetection_torch.ops import eot, warp_cuda

    n_img, p0 = canvases.shape[0], canvases.shape[1]
    t = warp_cuda.pass1_fwd(canvases, table, w)
    out = warp_cuda.pass2_fwd(t, table)
    if g is None:
        g = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    dt = warp_cuda.pass2_bwd(g, table, p0)
    dc = warp_cuda.pass1_bwd(dt, table, n_img)
    errs = {"pass1_fwd": kernel_err(f"warp {name} pass1_fwd", t,
                                    eot.pass1_fwd(canvases, table, w)),
            "pass2_fwd": kernel_err(f"warp {name} pass2_fwd", out,
                                    eot.pass2_fwd(t, table)),
            "pass2_bwd": kernel_err(f"warp {name} pass2_bwd", dt,
                                    eot.pass2_bwd(g, table, p0)),
            "pass1_bwd": kernel_err(f"warp {name} pass1_bwd", dc,
                                    eot.pass1_bwd(dt, table, n_img))}
    again = (warp_cuda.pass1_fwd(canvases, table, w), warp_cuda.pass2_fwd(t, table),
             warp_cuda.pass2_bwd(g, table, p0), warp_cuda.pass1_bwd(dt, table, n_img))
    torch.cuda.synchronize()
    for k, a, b in zip(WARP_KERNELS, again, (t, out, dt, dc)):
        if not torch.equal(a, b):
            fail(f"warp {name} {k}: two launches differ")
    empty = sorted(set(range(n_img)) - set(table[:, 7].long().tolist()))
    if empty and bool(dc[empty].any()):
        fail(f"warp {name} pass1_bwd: an image with no window got a gradient")
    return errs, float(out.abs().max()) == 0.0


def check_warp_fwd(name, canvases, table, w, t_in, chunk: int = 16):
    """The two forward warp kernels against the plain passes on the same
    CUDA tensors, the plain version `chunk` windows at a time (its hat
    weights are [N, p0, w, p0] and [N, w, w, p0]); each kernel launched twice
    bit-equal. Returns the max error per kernel."""
    import torch
    from mladversarialobjectdetection_torch.ops import eot, warp_cuda

    t = warp_cuda.pass1_fwd(canvases, table, w)
    out = warp_cuda.pass2_fwd(t_in, table)
    parts = [(table[s:s + chunk], t_in[s:s + chunk])
             for s in range(0, table.shape[0], chunk)]
    errs = {"pass1_fwd": kernel_err(f"warp {name} pass1_fwd", t, torch.cat(
                [eot.pass1_fwd(canvases, tab, w) for tab, _ in parts])),
            "pass2_fwd": kernel_err(f"warp {name} pass2_fwd", out, torch.cat(
                [eot.pass2_fwd(ti, tab) for tab, ti in parts]))}
    if not (torch.equal(warp_cuda.pass1_fwd(canvases, table, w), t)
            and torch.equal(warp_cuda.pass2_fwd(t_in, table), out)):
        fail(f"warp {name}: two launches of a forward kernel differ")
    return errs


def warp_taps(table, n_img: int, p0: int, w: int):
    """(T1, T2, live): the (window, i, x, j) and (window, y, x, i) taps whose
    hat weight is non-zero for these windows, counted with the plain
    version's weights (`eot._pass1_weights`, `eot._pass2_weights`), and per
    kernel the input positions that a non-zero tap reads: canvas (b, i, j)
    for pass1_fwd, t (n, i, x) for pass2_fwd, g (n, y, x) for pass2_bwd, dt
    (n, i, x) for pass1_bwd."""
    import torch
    from mladversarialobjectdetection_torch.ops import eot

    t1 = t2 = 0
    live = dict.fromkeys(WARP_KERNELS, 0)
    canvas = torch.zeros((n_img, p0, p0), dtype=torch.bool, device="cuda")
    for start in range(0, table.shape[0], 8):
        part = table[start:start + 8].cuda()
        h1 = eot._pass1_weights(part, p0, w) > 0   # [n, i, x, j]
        h2 = eot._pass2_weights(part, p0, w) > 0   # [n, y, x, i]
        t1 += int(h1.sum())
        t2 += int(h2.sum())
        for img, read in zip(part[:, 7].long().tolist(), h1.any(2)):
            canvas[img] |= read                    # (i, j) of image img
        live["pass2_fwd"] += int(h2.any(1).sum())  # (n, x, i)
        live["pass2_bwd"] += int(h2.any(3).sum())  # (n, y, x)
        live["pass1_bwd"] += int(h1.any(3).sum())  # (n, i, x)
    live["pass1_fwd"] = int(canvas.sum())
    return t1, t2, live


def warp_bounds(n_img: int, n_win: int, p0: int, w: int, taps):
    """{kernel: (bound ms, bound_by, bytes, ops)}: the input positions that a
    non-zero tap reads, each read once, and each output written once, over
    the HBM rate; the operations of the non-zero taps and of each output,
    over the fp32 rate."""
    t1, t2, live = taps
    f = 4  # bytes per float32
    canvas, table = n_img * p0 * p0 * 3 * f, n_win * 8 * f
    t_sz, out_sz = n_win * p0 * w * 3 * f, n_win * w * w * 3 * f
    work = {  # (live input bytes, output bytes, ops)
        "pass1_fwd": (live["pass1_fwd"] * 3 * f, t_sz,
                      t1 * WARP_TAP_OPS + n_win * p0 * w * WARP_FWD_OUT_OPS),
        "pass2_fwd": (live["pass2_fwd"] * 3 * f, out_sz,
                      t2 * WARP_TAP_OPS + n_win * w * w * WARP_FWD_OUT_OPS),
        "pass2_bwd": (live["pass2_bwd"] * 3 * f, t_sz,
                      t2 * WARP_TAP_OPS + n_win * w * w * WARP_BWD_OUT_OPS),
        "pass1_bwd": (live["pass1_bwd"] * 3 * f, canvas,
                      t1 * WARP_TAP_OPS + n_win * p0 * w * WARP_BWD_OUT_OPS),
    }
    out = {}
    for k, (read, written, ops) in work.items():
        nbytes = read + table + written
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOP_PER_S * 1e3
        out[k] = (max(bytes_ms, ops_ms),
                  "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)
    return out


class Capture:
    """Records the arguments of every call of the named wrappers in its block
    (the dispatching code looks each wrapper up at call time): `args[name]`
    is the list of (positional, keyword) arguments, in call order."""

    def __init__(self, targets):
        self.targets = targets  # [(module, wrapper name)]
        self.args = {name: [] for _, name in targets}

    def __enter__(self):
        self.originals = [getattr(m, k) for m, k in self.targets]
        for (mod, name), orig in zip(self.targets, self.originals):
            def rec(*a, _name=name, _orig=orig, **kw):
                self.args[_name].append((a, kw))
                return _orig(*a, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in zip(self.targets, self.originals):
            setattr(mod, name, orig)


def cmconv_bound(x, co: int, has_bias: bool, flop_per_s: float = FP32_FLOP_PER_S):
    """(bound ms, bound_by, bytes, ops) of one cmconv call on x [B, C, H, W]:
    x, the weights (float32) and the bias read once and the output written
    once, over the HBM rate (x, bias and output in x's element size: 2 bytes
    at bf16); 2 * 9 * C * Co operations per output pixel over `flop_per_s`
    (the fp32 rate by default; the bf16 tensor-core rate for bf16 x and a
    kernel holding bf16 values, where one bf16 product is exact)."""
    b, c, h, w = x.shape
    item = x.element_size()
    nbytes = item * (b * c * h * w + co * has_bias + b * co * h * w) + 4 * 9 * c * co
    ops = 2 * 9 * c * co * b * h * w
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / flop_per_s * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            nbytes, ops)


def check_cmconv_bf16(name, kern, plain) -> float:
    """The bf16 instance against the bf16 plain version: within
    BF16_CMCONV_TOL of the output's scale, and bit-equal (the kernels the
    U-Net hands it hold bf16 values: each product is exact in float32 and
    the sums run in the plain version's order)."""
    import torch

    if kern.dtype != plain.dtype or kern.shape != plain.shape:
        fail(f"{name}: kernel {kern.dtype} {tuple(kern.shape)}, plain "
             f"{plain.dtype} {tuple(plain.shape)}")
    err = float((kern.float() - plain.float()).abs().max())
    scale = max(1.0, float(plain.float().abs().max()))
    if not err <= BF16_CMCONV_TOL * scale:
        fail(f"{name}: kernel and plain differ by {err} > {BF16_CMCONV_TOL} * {scale}")
    if not torch.equal(kern, plain):
        fail(f"{name}: not bit-equal to the plain version (max error {err})")
    return err


def calibrate_bn(unet, images) -> None:
    """Set every BatchNorm's running statistics of `unet` to the batch
    statistics that a train-mode pass over `images` (dropout off) uses, so
    that its eval pass computes what that train pass computes."""
    import torch
    from mladversarialobjectdetection_torch.models.unet import BatchNorm

    seen = {}

    def record(mod, args):  # returns None: the module's arguments stay as they are
        seen[mod] = args[0].detach().float().clone()

    hooks = [m.register_forward_pre_hook(record)
             for m in unet.modules() if isinstance(m, BatchNorm)]
    drops = {m: m.dropout for m in unet.modules() if hasattr(m, "dropout")}
    try:
        for m in drops:
            m.dropout = 0.0
        with torch.no_grad():
            unet(images, training=True)
    finally:
        for h in hooks:
            h.remove()
        for m, rate in drops.items():
            m.dropout = rate
    with torch.no_grad():
        for m, x in seen.items():
            mu = x.mean(dim=(0, 2, 3))
            m.running_mean.copy_(mu)
            m.running_var.copy_(torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mu * mu, 0.0))


class Float64Convs:
    """In its block the U-Nets' `ops/cmconv.cmconv` calls (whose kernels take
    float32 and bf16 only) are float64 `F.conv2d`s, the same 3x3 SAME conv,
    so that a float64 copy of a U-Net, packed or not, computes its function
    in float64 on the card."""

    def __enter__(self):
        import torch.nn.functional as F
        from mladversarialobjectdetection_torch.models import unet, unet_packed

        def conv(x, w, bias=None):
            return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), bias, padding=1)

        self.mods = (unet, unet_packed)
        self.originals = [m.cmconv for m in self.mods]
        for m in self.mods:
            m.cmconv = conv
        return self

    def __exit__(self, *exc):
        for m, orig in zip(self.mods, self.originals):
            m.cmconv = orig


def mbconv_case(dev, b, h, w, c, e, co, k, seed):
    """x [B, H, W, C] and a FoldedBlock with fan-in scaled random weights."""
    import torch
    from mladversarialobjectdetection_torch.ops.mbconv import FoldedBlock

    g = torch.Generator(dev).manual_seed(seed)
    r = lambda *shape, s=1.0: torch.randn(shape, generator=g, device=dev) * s
    fb = FoldedBlock(we=r(c, e, s=2 / c ** 0.5), be=r(e, s=0.5), wd=r(k, k, e, s=2 / k),
                     bd=r(e, s=0.5), wp=r(e, co, s=2 / e ** 0.5), bp=r(co, s=0.5))
    return r(b, h, w, c), fb


def check_mbconv(name, x, g, fb, act_type, residual):
    """Both fused MBConv kernels against the plain versions on the same CUDA
    tensors, each launched twice bit-equal, in x's dtype (float32, or bf16
    with a bf16 fold and the MBCONV_BF16_* tolerances; there every forward
    output must also lie within the roundings the bf16 function allows,
    `ops/mbconv.rounding_bound`). For relu6 / relu, dx is held to the plain
    dx fed the masks the kernel's masks instance wrote, and every mask that
    differs from the plain version's must lie within the kink tolerance of
    its kink. Returns (fwd error, dx error, (z0 flips, z1 flips, worst flip
    distance of scale), the forward's `RoundingBound` or None)."""
    import torch
    from mladversarialobjectdetection_torch.ops import mbconv, mbconv_cuda

    bf16 = x.dtype == torch.bfloat16
    fwd_tol, dx_tol, kink_tol = ((MBCONV_BF16_FWD_TOL, MBCONV_BF16_DX_TOL,
                                  MBCONV_BF16_KINK_TOL) if bf16 else
                                 (MBCONV_FWD_TOL, MBCONV_DX_TOL, MBCONV_KINK_TOL))
    kw = dict(act_type=act_type, residual=residual)
    y = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    dx = mbconv_cuda.mbconv_dx_cuda(x, g, fb, **kw)
    plain_y = mbconv.mbconv_plain(x, fb, **kw)
    rounding = mbconv.rounding_bound(y, x, fb, **kw) if bf16 else None
    if rounding is not None and rounding.outside:
        fail(f"mbconv fwd {name}: {rounding.outside} outputs lie beyond every rounding "
             f"of the bf16 function within float32 distance of a boundary ({rounding})")
    flips = (0, 0, 0.0)
    if act_type in ("relu6", "relu"):
        b, h, w, _ = x.shape
        masks = torch.empty((2, b, h, w, fb.we.shape[1]), dtype=torch.uint8, device=x.device)
        mbconv_cuda.mbconv_dx_cuda(x, g, fb, masks_out=masks, **kw)
        plain_masks, z0, z1 = mbconv.dx_masks(x, fb, act_type=act_type)
        flips = mbconv.kink_flips(masks, plain_masks, z0, z1, act_type)
        del plain_masks, z0, z1
        plain_dx = mbconv.mbconv_dx_plain(x, g, fb, masks=masks, **kw)
        del masks
        if not flips[2] <= kink_tol:
            fail(f"mbconv dx {name}: a mask flip lies {flips[2]} of scale from its "
                 f"kink (> {kink_tol}); flips z0 {flips[0]}, z1 {flips[1]}")
    else:
        plain_dx = mbconv.mbconv_dx_plain(x, g, fb, **kw)
    errs = (float((y.float() - plain_y.float()).abs().max()),
            float((dx.float() - plain_dx.float()).abs().max()))
    limits = (fwd_tol * max(1.0, float(plain_y.float().abs().max())),
              dx_tol * float(plain_dx.float().abs().max()))
    for what, err, limit in zip(("fwd", "dx"), errs, limits):
        if not err <= limit:
            fail(f"mbconv {what} {name}: kernel and plain differ by {err} > {limit}")
    if not (torch.equal(mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw), y)
            and torch.equal(mbconv_cuda.mbconv_dx_cuda(x, g, fb, **kw), dx)):
        fail(f"mbconv {name}: two launches differ")
    return errs + (flips, rounding)


def mbconv_bound(x_shape, e: int, co: int, k: int, residual: bool, dx: bool,
                 itemsize: int = 4):
    """(bound ms, bound_by, bytes, ops, 3xTF32 bound ms, operations ms) of one fused MBConv
    launch on x [B, H, W, C]: x, g and the output read or written once and
    the folded weights read once, over the HBM rate; the multiply-adds and
    bias adds per output pixel (the activations not counted), over the fp32
    rate. Forward: expand 2CE + E, depthwise 2k^2E + E, project 2ECo + Co (+
    Co residual). dx: the recomputed expand and depthwise, g . Wp^T 2ECo,
    act'(z1) E, the depthwise transpose 2k^2E, act'(z0) E, . We^T 2EC (+ C).
    The second bound takes the 1x1 products (2CE, 2ECo, and in dx 2ECo and
    2EC) at the 3xTF32 rate of the tensor cores and the rest at the fp32
    rate, or the bytes where they take longer.

    itemsize 2, the bf16 instance: x, g, the output, We and Wp in 2 bytes;
    the bound takes the products at the bf16 rate of the tensor cores
    (989 TFLOP/s) and the rest at the fp32 rate, or the bytes, and the
    second figure is the same bound."""
    b, h, w, c = x_shape
    pixels = b * h * w
    w_cd = c * e + e * co  # We and Wp, in the activations' type
    f32 = e + k * k * e + e + (0 if dx else co)
    if dx:
        products = 2 * c * e + 2 * e * co + 2 * e * c
        rest = e + 2 * k * k * e + e + e + 2 * k * k * e + e + (c if residual else 0)
        nbytes = itemsize * (pixels * (2 * c + co) + w_cd) + 4 * f32
    else:
        products = 2 * c * e + 2 * e * co
        rest = e + 2 * k * k * e + e + co + (co if residual else 0)
        nbytes = itemsize * (pixels * (c + co) + w_cd) + 4 * f32
    ops = pixels * (products + rest)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if itemsize == 2:
        ops_ms = (pixels * products / BF16_FLOP_PER_S + pixels * rest / FP32_FLOP_PER_S) * 1e3
        bound = max(bytes_ms, ops_ms)
        return (bound, "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops, bound,
                ops_ms)
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    tc_ms = (pixels * products / TC3_FLOP_PER_S + pixels * rest / FP32_FLOP_PER_S) * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            nbytes, ops, max(bytes_ms, tc_ms), ops_ms)


def same_detections(name, a, b, exact_scores: bool = True) -> float:
    """Detections a and b (numpy or torch) with equal valid, valid_len,
    classes and boxes; scores equal or within SCORE_TOL. Returns the score
    error."""
    a = [np.asarray(t.cpu() if hasattr(t, "cpu") else t) for t in a]
    b = [np.asarray(t.cpu() if hasattr(t, "cpu") else t) for t in b]
    for field, x, y in zip(("boxes", "scores", "classes", "valid", "valid_len"), a, b):
        if field != "scores" and not np.array_equal(x, y):
            fail(f"{name}: {field} differ")
    err = float(np.abs(a[1] - b[1]).max()) if a[1].size else 0.0
    if err > (0.0 if exact_scores else SCORE_TOL):
        fail(f"{name}: scores differ by {err}")
    return err


class PlainNMS:
    """Runs the plain NMS version wherever `nms.batched_nms_auto` is called."""

    def __enter__(self):
        from mladversarialobjectdetection_torch.ops import nms
        self.nms, self.orig = nms, nms.batched_nms_auto
        nms.batched_nms_auto = nms.batched_nms
        return self

    def __exit__(self, *exc):
        self.nms.batched_nms_auto = self.orig


class UnfusedRoute:
    """Records, for each block that runs `MBConvBlock._forward_unfused` in
    its block, whether that block is fuseable (it holds no tensor)."""

    def __enter__(self):
        from mladversarialobjectdetection_torch.models.efficientnet import MBConvBlock
        self.cls, self.orig, self.calls = MBConvBlock, MBConvBlock._forward_unfused, []

        def spy(block, x, *args, _orig=self.orig):
            self.calls.append(block.fuseable)
            return _orig(block, x, *args)

        MBConvBlock._forward_unfused = spy
        return self

    def __exit__(self, *exc):
        self.cls._forward_unfused = self.orig


class AllUnfused:
    """Every MBConv block runs `_forward_unfused` (cuDNN) in its block: the
    reference the fused victim is held against."""

    def __enter__(self):
        from mladversarialobjectdetection_torch.models.efficientnet import MBConvBlock
        self.cls, self.orig = MBConvBlock, MBConvBlock.forward
        MBConvBlock.forward = MBConvBlock._forward_unfused
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.orig


def fused_vs_unfused(label, atk, state, images, override, logit_tol, cos_min,
                     grad_cos_min, ref_net=None, ref_margin=None):
    """The fused victim against the unfused one (every block through
    `_forward_unfused`, cuDNN): logits within logit_tol of max(1, max|ref|);
    the victim's input gradient of a smooth function of its outputs (a
    seeded cotangent on every class and box output, no max over anchors) at
    cosine >= grad_cos_min; and on one attack loss with fixed draws (the
    step's boxes, a fresh seeded generator) the patch gradient at cosine >=
    cos_min. Prints the cosine of the attack gradient's part through the
    warp and the detector (no TV term), which is not held.

    With `ref_net` (the same weights in float32, fused), both input
    gradients are also held to its: the fused one's cosine to it at least
    the unfused one's less `ref_margin`."""
    import torch

    dev = images.device
    gen = torch.Generator(dev).manual_seed(11)
    with torch.no_grad():
        cots = [torch.randn(o.shape, generator=gen, device=dev)
                for outs in atk.net(images) for o in outs]

    def input_grad(net=atk.net):
        x = images.detach().clone().requires_grad_(True)
        outs = [o for group in net(x) for o in group]
        sum((o.float() * c).sum() for o, c in zip(outs, cots)).backward()
        return x.grad

    def attack_grad(tv_weight):
        patch_v = state.patch.detach().clone().requires_grad_(True)
        scale_v = state.scale.detach().clone().requires_grad_(True)
        loss, _ = atk._loss_from_images(patch_v, scale_v, images, *override,
                                        torch.Generator(dev).manual_seed(7),
                                        tv_weight=tv_weight)
        loss.backward()
        return float(loss.detach()), patch_v.grad

    def cosine(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm()))

    with torch.no_grad():
        logits = [t for outs in atk.net(images) for t in outs]
    igrad = input_grad()
    grads = (attack_grad(1e-5), attack_grad(0.0))
    with AllUnfused():
        with torch.no_grad():
            ref_logits = [t for outs in atk.net(images) for t in outs]
        ref_igrad = input_grad()
        ref_grads = (attack_grad(1e-5), attack_grad(0.0))
    logit_err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for a, b in zip(logits, ref_logits))
    icos = cosine(igrad, ref_igrad)
    irel = float((igrad - ref_igrad).abs().max() / ref_igrad.abs().max())
    cos, cos_det = (cosine(g[1], r[1]) for g, r in zip(grads, ref_grads))
    if not logit_err <= logit_tol or not icos >= grad_cos_min or not cos >= cos_min:
        fail(f"{label}: logits differ by {logit_err} of scale (> {logit_tol}?), input "
             f"gradient cosine {icos} (< {grad_cos_min}?), patch gradient cosine {cos} "
             f"(< {cos_min}?)")
    if ref_net is not None:
        g32 = input_grad(ref_net)
        fcos, ucos = cosine(igrad, g32), cosine(ref_igrad, g32)
        del g32
        if not fcos >= ucos - ref_margin:
            fail(f"{label}: the fused input gradient lies at cosine {fcos} of the float32 "
                 f"one, the unfused at {ucos} (margin {ref_margin})")
        print(f"{label}: input gradients against the float32 victim's: fused cosine "
              f"{fcos:.8f}, unfused (cuDNN) {ucos:.8f} (the fused at least the unfused "
              f"less {ref_margin})")
    print(f"{label}: logits within {logit_err:.3g} of max(1, max|ref|) (limit "
          f"{logit_tol}); victim input gradient of a seeded cotangent on every "
          f"output at cosine {icos:.8f} (limit {grad_cos_min}; largest difference "
          f"{irel:.3g} of max|ref|); loss {grads[0][0]:.6f} vs {ref_grads[0][0]:.6f}; "
          f"patch gradient cosine {cos:.8f} (limit {cos_min}; without the TV term, the "
          f"part through the warp and the detector: {cos_det:.8f})")


def mbconv_step_numbers(label, atk, cap, mb_errs):
    """The fused MBConv kernels on the inputs a captured attack step gave
    them (the second, gradient-carrying pass's 25 forward launches and their
    25 dx launches), in the step's dtype: each against the plain versions
    (`check_mbconv`), timed by CUDA events beside its bound, the plain time
    and the unfused block (cuDNN, in the same dtype), and in float32 beside
    the SIMT ablation on the same plan. Returns (per-pass totals per kind,
    the max errors so far per kind)."""
    import torch
    from mladversarialobjectdetection_torch.ops import mbconv, mbconv_cuda

    fwd_calls = cap.args["mbconv_fwd_cuda"]  # the first pass, then the second
    dx_calls = cap.args["mbconv_dx_cuda"]    # the last block first
    if (len(fwd_calls), len(dx_calls)) != (2 * MBCONV_PER_PASS, MBCONV_PER_PASS):
        fail(f"{label}: captured {len(fwd_calls)} fused forward and {len(dx_calls)} "
             f"dx calls")
    blocks = [(i, b) for i, b in enumerate(
        getattr(atk.net.backbone, f"blocks_{i}")
        for i in range(len(atk.net.backbone.spec.blocks))) if b.fuseable]
    mb_tot = {k: dict.fromkeys(("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
                                "unfused_ms", "simt_ms", "bound_tc_ms"), 0.0)
              for k in ("fwd", "dx")}
    mb_flips, rounding = [0, 0, 0.0], [0] * 5  # flips, e_near, d_near, y_open, outputs
    for j, (idx, blk) in enumerate(blocks):
        (x, fb), kw = fwd_calls[MBCONV_PER_PASS + j]
        (xd, g, _), _ = dx_calls[MBCONV_PER_PASS - 1 - j]
        if xd.data_ptr() != x.data_ptr():
            fail(f"{label} block {idx}: the dx call's x is not the forward's")
        kw = dict(act_type=kw["act_type"], residual=kw["residual"])
        bf16 = x.dtype == torch.bfloat16
        errs = check_mbconv(f"{label} block {idx} step inputs", x, g, fb, **kw)
        mb_errs = {"fwd": max(mb_errs["fwd"], errs[0]), "dx": max(mb_errs["dx"], errs[1])}
        mb_flips = [mb_flips[0] + errs[2][0], mb_flips[1] + errs[2][1],
                    max(mb_flips[2], errs[2][2])]
        if bf16:
            rb = errs[3]
            rounding = [n + m for n, m in zip(rounding, (rb.flips, rb.e_near, rb.d_near,
                                                         rb.y_open, g.numel()))]
        xr = x.permute(0, 3, 1, 2)
        xg = xr.detach().requires_grad_(True)
        gr = g.permute(0, 3, 1, 2)

        def unfused_fwd_dx():
            with torch.enable_grad():
                torch.autograd.grad(blk._forward_unfused(xg), xg, gr)

        e, co = fb.wp.shape
        k = fb.wd.shape[0]
        b_, h_, w_, c_ = x.shape
        plans = {"fwd": mbconv_cuda.plan_fwd(h_, w_, c_, e, co, k, b_, dtype=x.dtype),
                 "dx": mbconv_cuda.plan_dx(h_, w_, c_, e, co, k, b_, dtype=x.dtype)}
        # kernel, plain, unfused (cuDNN), and in float32 the SIMT ablation on
        # the same plan, in turns with the kernel: kernel, ablation, ablation, kernel
        fns = {"fwd": (lambda: mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw),
                       lambda: mbconv_cuda.mbconv_fwd_simt(x, fb, **kw)),
               "dx": (lambda: mbconv_cuda.mbconv_dx_cuda(x, g, fb, **kw),
                      lambda: mbconv_cuda.mbconv_dx_simt(x, g, fb, **kw))}
        times, simt_err = {}, {}
        for kind, (kern_fn, simt_fn) in fns.items():
            if bf16:
                times[kind] = (cuda_ms(kern_fn, iters=5), float("nan"))
                continue
            ref = kern_fn()
            simt_err[kind] = float((simt_fn() - ref).abs().max()) / max(
                1.0, float(ref.abs().max()))
            del ref
            t = [cuda_ms(kern_fn, iters=5), cuda_ms(simt_fn, iters=3),
                 cuda_ms(simt_fn, iters=3), cuda_ms(kern_fn, iters=5)]
            times[kind] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        times = {
            "fwd": times["fwd"] + (
                cuda_ms(lambda: mbconv.mbconv_plain(x, fb, **kw), iters=1, warmup=1),
                cuda_ms(lambda: blk._forward_unfused(xr), iters=5)),
            "dx": times["dx"] + (
                cuda_ms(lambda: mbconv.mbconv_dx_plain(x, g, fb, **kw), iters=1, warmup=1),
                cuda_ms(unfused_fwd_dx, iters=3))}
        if not bf16 and not simt_err["fwd"] <= MBCONV_FWD_TOL:
            fail(f"block {idx}: the SIMT ablation's forward differs from the "
                 f"kernel's by {simt_err['fwd']} of scale")
        line = []
        for kind, (kern_ms, simt_ms, plain_ms, unf_ms) in times.items():
            bound_ms, bound_by, nbytes, ops, bound_tc_ms, ops_ms = mbconv_bound(
                tuple(x.shape), e, co, k, kw["residual"], kind == "dx", x.element_size())
            tot = mb_tot[kind]
            tot["ms"] += kern_ms
            tot["simt_ms"] += simt_ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound_ms
            tot["bound_tc_ms"] += bound_tc_ms
            tot["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
            tot["ops_ms"] += ops_ms
            tot["unfused_ms"] += unf_ms
            p = plans[kind]
            simt = ("" if bf16 else f", SIMT ablation {simt_ms:.4f} (off the kernel by "
                    f"{simt_err[kind]:.3g} of scale)")
            line.append(f"{kind} kernel {kern_ms:.4f} ms (plan {p.th}x{p.tw} npw {p.npw} "
                        f"split {p.split} slice {p.n_per_slice}){simt}, plain "
                        f"{plain_ms:.4f}, unfused "
                        f"{'fwd+dx ' if kind == 'dx' else ''}{unf_ms:.4f} (kernel / "
                        f"unfused {kern_ms / unf_ms:.3f}), bound {bound_ms:.6f} "
                        f"({bound_by}: {nbytes} B, {ops} ops; {bound_ms / kern_ms:.1%})"
                        + ("" if bf16 else f", 3xTF32 bound {bound_tc_ms:.6f} "
                           f"({bound_tc_ms / kern_ms:.1%})")
                        + f", error {errs[kind == 'dx']:.3g}")
        print(f"  mbconv {x.dtype} block {idx:2d} {tuple(x.shape)} E {e} Co {co} k{k}"
              f"{' res' if kw['residual'] else ''}: " + "; ".join(line)
              + f"; dx mask flips z0 {errs[2][0]}, z1 {errs[2][1]} (at most "
              f"{errs[2][2]:.3g} of scale from the kink)"
              + (f"; forward outputs off plain {errs[3].flips}, none beyond the "
                 f"roundings" if bf16 else ""))
    for kind, tot in mb_tot.items():
        tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
        rates = ("bf16 products at 989 TFLOP/s, the rest at 67 TFLOP/s" if bf16 else
                 f"fp32, {tot['bound_ms'] / tot['ms']:.1%} of it; 3xTF32 bound "
                 f"{tot['bound_tc_ms']:.6f} ms, {tot['bound_tc_ms'] / tot['ms']:.1%}")
        print(f"  mbconv {x.dtype} {kind} per pass ({MBCONV_PER_PASS} launches): kernel "
              f"{tot['ms']:.4f} ms"
              + ("" if bf16 else f", SIMT ablation {tot['simt_ms']:.4f} ms")
              + f", plain {tot['plain_ms']:.4f} ms, unfused "
              f"{'forward + input gradient ' if kind == 'dx' else ''}(cuDNN) "
              f"{tot['unfused_ms']:.4f} ms (kernel / unfused "
              f"{tot['ms'] / tot['unfused_ms']:.3f}), bound {tot['bound_ms']:.6f} ms "
              f"({tot['bound_by']}; {tot['bound_ms'] / tot['ms']:.1%} of it; {rates})")
    print(f"  mbconv {x.dtype} dx mask flips at the step's inputs: z0 {mb_flips[0]}, "
          f"z1 {mb_flips[1]}, each within {mb_flips[2]:.3g} of scale of its kink"
          + (f"; forward outputs off the plain version's {rounding[0]}, every one "
             f"within the roundings of the bf16 function (e near a bf16 boundary "
             f"{rounding[1]}, d {rounding[2]}; {rounding[3]} of {rounding[4]} outputs "
             f"may take more than one bf16 value)" if bf16 else ""))
    print(f"{label} mbconv kernels at the step's inputs: max errors {mb_errs}")
    return mb_tot, mb_errs


def check_fused_route(label, launches, route, fwd, dx, passes):
    """Fail unless the fused kernels launched fwd / dx times and only the
    UNFUSED_PER_PASS other blocks of each of `passes` victim passes ran
    unfused."""
    want = {"mbconv_fwd": fwd, "mbconv_dx": dx}
    if launches != want:
        fail(f"{label}: fused MBConv launches {launches}, want {want}")
    if len(route.calls) != passes * UNFUSED_PER_PASS or any(route.calls):
        fail(f"{label}: {len(route.calls)} blocks ran unfused "
             f"({sum(route.calls)} of them fuseable) in {passes} passes")


class InMemorySource:
    """A frame source for `serve_streams`: what `MultiStream` asks of a Stream."""

    def __init__(self, frames):
        self.frames = frames

    def play(self):
        yield from self.frames


def random_gt(rng, b, hw, slots=4):
    """Random person boxes, 1..slots valid an image, class 0."""
    boxes = np.zeros((b, slots, 4), np.float32)
    valid = np.zeros((b, slots), bool)
    for i in range(b):
        for k in range(rng.integers(1, slots + 1)):
            h, w = rng.uniform(0.2, 0.8, 2) * hw
            y0, x0 = rng.uniform(0, hw - h), rng.uniform(0, hw - w)
            boxes[i, k] = (y0, x0, y0 + h, x0 + w)
            valid[i, k] = True
    return boxes, np.zeros((b, slots), np.int32), valid


def leaf_err(a_module, b_module) -> float:
    """Max over state_dict leaves of max|a - b| / max(1, max|b|)."""
    worst = 0.0
    sa, sb = a_module.state_dict(), b_module.state_dict()
    for k, v in sb.items():
        v = v.detach().cpu().double()
        d = float((sa[k].detach().cpu().double() - v).abs().max())
        worst = max(worst, d / max(1.0, float(v.abs().max())))
    return worst


class CountUnfused:
    """Counts `MBConvBlock._forward_unfused` calls."""

    def __enter__(self):
        from mladversarialobjectdetection_torch.models.efficientnet import MBConvBlock
        self.cls, self.orig, self.n = MBConvBlock, MBConvBlock._forward_unfused, 0

        def spy(block, x, *args, _orig=self.orig):
            self.n += 1
            return _orig(block, x, *args)

        MBConvBlock._forward_unfused = spy
        return self

    def __exit__(self, *exc):
        self.cls._forward_unfused = self.orig


def trainer_card_vs_cpu(dev, config_lib) -> None:
    """Phase 14: one train step on the card and on the CPU, same weights and
    scenes, lite0@128 b2, float64 and float32."""
    import torch
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer

    cfg = config_lib.get_efficientdet_config("efficientdet-lite0")
    cfg.image_size = 128
    rng = np.random.default_rng(14)
    images = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    gt = random_gt(rng, 2, 128)
    errs = {}
    for dtype, tol in ((torch.float64, TRAIN_F64_TOL), (torch.float32, TRAIN_F32_TOL)):
        states, losses = {}, {}
        for where in ("cpu", dev):
            tr = DetectorTrainer(cfg, steps_per_epoch=10, device=where)
            st = tr.init_state(seed=0)
            if dtype == torch.float64:
                st.net.double()
                st.net.compute_dtype = torch.float64
            st, m = tr.train_step(st, images.astype(np.float64 if dtype == torch.float64
                                                     else np.float32), *gt)
            states[str(where)], losses[str(where)] = st, float(m["loss"])
        err = leaf_err(states[str(dev)].net, states["cpu"].net)
        loss_rel = abs(losses[str(dev)] - losses["cpu"]) / abs(losses["cpu"])
        errs[str(dtype)] = (err, loss_rel)
        if not err <= tol or not loss_rel <= tol:
            fail(f"trainer card vs CPU ({dtype}): parameters and statistics within "
                 f"{err:.3g} of scale, loss {loss_rel:.3g} relative > {tol}")
    print("phase 14 trainer card vs CPU (lite0@128 b2, one step): " + ", ".join(
        f"{k}: parameters and statistics within {e:.3g} of scale, loss {l:.3g} "
        f"relative (limit {TRAIN_F64_TOL if 'float64' in k else TRAIN_F32_TOL})"
        for k, (e, l) in errs.items()))


def trainer_full_size(dev, pool, mixed_precision: bool):
    """Phase 15: the trainer at lite4@640 b24 on the scene pool; returns
    (trainer, state, p50 ms)."""
    import torch
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    from mladversarialobjectdetection_torch.train.victim import make_config

    label = "bf16" if mixed_precision else "fp32"
    cfg = make_config(mixed_precision)
    tr = DetectorTrainer(cfg, steps_per_epoch=800, device=dev)
    st = tr.init_state(seed=0)
    rng = np.random.default_rng(15)
    held = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    mbconv_cuda.reset_counts()
    with CountUnfused() as unfused:
        for i in range(TRAIN_STEPS + 2):
            batch = pool.sample(rng, TRAIN_BATCH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = tr.train_step(st, *batch)
            losses.append(float(m["det_loss"]))  # synchronizes
            times.append((time.perf_counter() - t0) * 1e3)
    fused = sum(mbconv_cuda.LAUNCHES.values())
    n_blocks = len(st.net.spec.backbone.blocks)
    if fused or unfused.n != n_blocks * (TRAIN_STEPS + 2):
        fail(f"trainer {label}: {fused} fused MBConv launches, {unfused.n} unfused "
             f"block calls (want 0 and {n_blocks * (TRAIN_STEPS + 2)})")
    if not all(np.isfinite(losses)):
        fail(f"trainer {label}: det_loss {losses}")
    p50 = statistics.median(times[2:])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"phase 15 trainer {label} (lite4@640 b{TRAIN_BATCH}, {TRAIN_STEPS} timed "
          f"steps after 2): step p50 {p50:.3f} ms ({1e3 * TRAIN_BATCH / p50:.2f} "
          f"images/s), peak {peak:.3f} GB ({held:.3f} GB held before the "
          f"phase: the trainer, the pool), 0 fused MBConv launches and "
          f"{unfused.n} unfused block calls in {TRAIN_STEPS + 2} steps; det_loss "
          + " ".join(f"{v:.4f}" for v in losses))
    profile_device(lambda: tr.train_step(st, *pool.sample(rng, TRAIN_BATCH)),
                   f"trainer {label} step", top=8)
    return tr, st, p50


def resume_err(label, ref, res) -> float:
    """0.0 where the uninterrupted and the resumed run's states (the resume
    file's arrays) are bit-equal, else the largest difference of scale
    (failing above RESUME_TOL); steps and generator states must be equal."""
    if int(ref["step"]) != int(res["step"]) or not np.array_equal(
            ref["generator"], res["generator"]):
        fail(f"{label}: step {ref['step']} vs {res['step']} or generator state differ")
    worst = 0.0
    flat = lambda d, p="": ([(p + k, v) for k, v in d.items() if not isinstance(v, dict)]
                            + [x for k, v in d.items() if isinstance(v, dict)
                               for x in flat(v, p + k + "/")])
    rd = dict(flat({k: v for k, v in res.items() if k not in ("step", "generator")}))
    for name, a in flat({k: v for k, v in ref.items() if k not in ("step", "generator")}):
        a, b = np.asarray(a, np.float64), np.asarray(rd[name], np.float64)
        if not np.array_equal(a, b):
            worst = max(worst, float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max())))
    if worst > RESUME_TOL:
        fail(f"{label}: resumed run differs by {worst:.3g} of scale > {RESUME_TOL}")
    return worst


def path_counts() -> dict:
    """The launch counts of every kernel of the workflows' path, the MBConv
    and cmconv ones split by dtype."""
    from mladversarialobjectdetection_torch.ops import (
        cmconv_cuda, mbconv_cuda, nms_cuda, warp_cuda)
    mb = mbconv_cuda.DTYPE_LAUNCHES
    return dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES,
                mbconv_fwd_bf16=mb["bfloat16"]["mbconv_fwd"],
                mbconv_dx_bf16=mb["bfloat16"]["mbconv_dx"],
                mbconv_fp32=sum(mb["float32"].values()),
                cmconv_bf16=cmconv_cuda.DTYPE_LAUNCHES["bfloat16"],
                cmconv_fp32=cmconv_cuda.DTYPE_LAUNCHES["float32"])


def reset_path_counts() -> None:
    from mladversarialobjectdetection_torch.ops import (
        cmconv_cuda, mbconv_cuda, nms_cuda, warp_cuda)
    nms_cuda.LAUNCHES = 0
    warp_cuda.reset_counts()
    mbconv_cuda.reset_counts()
    cmconv_cuda.reset_counts()


class PerCall:
    """In its block, every call of `cls.name` records (its keyword
    arguments, the launch counts it added), and `hook(self, *args, **kw)`
    where given runs before the call."""

    def __init__(self, cls, name: str, hook=None):
        self.cls, self.name, self.hook = cls, name, hook
        self.calls = []

    def __enter__(self):
        import torch
        self.orig = getattr(self.cls, self.name)

        def wrapped(obj, *a, **kw):
            if self.hook is not None:
                self.hook(obj, *a, **kw)
            before = path_counts()
            out = self.orig(obj, *a, **kw)
            torch.cuda.synchronize()
            after = path_counts()
            self.calls.append((kw, {k: after[k] - before[k] for k in after}))
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def attack_step_launches(label: str, calls) -> None:
    """Each bf16 attack train step: every warp kernel once, NMS once (twice
    with the ASR pass), 50 bf16 MBConv forward and 25 dx launches and no
    float32 MBConv or cmconv launch."""
    for kw, got in calls:
        want = dict.fromkeys(WARP_KERNELS, 1)
        want.update(nms=1 + bool(kw.get("with_asr")),
                    mbconv_fwd_bf16=2 * MBCONV_PER_PASS,
                    mbconv_dx_bf16=MBCONV_PER_PASS, mbconv_fp32=0,
                    cmconv_bf16=0, cmconv_fp32=0)
        if got != want:
            fail(f"{label}: a train step launched {got}, want {want}")


def launched_every(label: str, counts: dict, kernels) -> None:
    """The path run between a reset and `counts` launched each kernel."""
    idle = [k for k in kernels if counts[k] == 0]
    if idle:
        fail(f"{label}: no launch of {idle} in the run ({counts})")


def soak_phases(dev, vpath: str, work: str) -> None:
    """Phases 19a-19c: the example workflows' stage functions at full width
    (lite4@640, b24, bf16, `train/victim.make_config`) on phase 16's victim
    file. That victim trained 12 steps and would fail the production soak's
    detection gate at score .5, so the stages run at score threshold .0099
    and are called directly (the gate's own check runs in the card runs of
    the workflows, PERF.md)."""
    from pathlib import Path

    import torch
    from mladversarialobjectdetection_torch.attack import artifacts
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.ckpt import bridge
    from mladversarialobjectdetection_torch.ckpt.io import load_pytree
    from mladversarialobjectdetection_torch.data.pipeline import ScenePool
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
    from mladversarialobjectdetection_torch.examples import northstar_soak as ns
    from mladversarialobjectdetection_torch.examples import production_soak as ps
    from mladversarialobjectdetection_torch.ops import eot, warp_cuda
    from mladversarialobjectdetection_torch.train.victim import make_config

    t0 = time.perf_counter()
    cfg = make_config()
    cfg.nms_configs.update({"score_thresh": DEFEND_THRESH})
    rng = np.random.default_rng(19)
    pool = ScenePool(rng, n_batches=TRAIN_POOL_BATCHES, batch=ATTACK_BATCH,
                     hw=640, device=dev)
    net = ps.victim(cfg, pool, rng, work, det_steps=0, batch=ATTACK_BATCH,
                    seed=0, victim_ckpt=vpath, device=dev)
    doc = lambda name: json.loads((Path(__file__).resolve().parent / "docs" / name)
                                  .read_text())

    def covers(got, want, where):
        missing = set(want) - set(got)
        for k, v in want.items():
            if isinstance(v, dict):
                missing |= {f"{k}.{x}" for x in set(v) - set(got.get(k) or {})}
            elif isinstance(v, list) and v and isinstance(v[0], dict):
                missing |= {f"{k}[0].{x}" for x in set(v[0]) - set(
                    (got.get(k) or [{}])[0])}
        if missing:
            fail(f"{where}: keys of the TPU record missing: {sorted(missing)}")

    # phase 19a: the north-star epoch loop, 2 epochs of 3 steps, 1 val batch
    # x 2 draws; each epoch's state read at its first eval
    states = []
    snap = lambda atk, st, images, batch_idx=0, **kw: batch_idx == 0 and states.append(
        (st.patch.detach().clone(), st.scale.detach().clone()))
    val_imgs = ns.val_pool(0, 1, ATTACK_BATCH, dev)
    args = ns.parse_args(["--epochs", "2", "--steps-per-epoch", "3",
                          "--val-batches", "1"])
    record = {"config": ns.config_record(cfg, args)}
    out = str(Path(work) / "northstar.json")
    reset_path_counts()
    with PerCall(PatchAttacker, "train_step") as steps, \
            PerCall(PatchAttacker, "eval_step", hook=snap):
        astate = ns.epoch_soak(cfg, net, pool, rng, val_imgs, work, epochs=2,
                               steps_per_epoch=3, batch=ATTACK_BATCH, seed=0,
                               window=ATTACK_WINDOW, eot_draws=2, max_hours=10.0,
                               record=record, out_json=out, device=dev)
    torch.cuda.synchronize()
    counts = path_counts()
    launched_every("phase 19a", counts, (*WARP_KERNELS, "nms", "mbconv_fwd_bf16",
                                         "mbconv_dx_bf16"))
    if len(steps.calls) != 6 or [bool(kw.get("with_asr")) for kw, _ in steps.calls] \
            != [False, False, True] * 2:
        fail(f"phase 19a: train steps {[kw for kw, _ in steps.calls]}")
    attack_step_launches("phase 19a", steps.calls)
    rec = json.loads(Path(out).read_text())
    rows = rec["attack_trajectory"]
    if len(rows) != 2 or any(r["val_asr_to_scale"] != r["val_asr"] / (r["scale"] + 1e-7)
                             for r in rows):
        fail(f"phase 19a: northstar.json rows {rows}")
    covers(rec, doc("NORTHSTAR_phase1.json"), "northstar.json")
    best = rec["best"]
    patch, scale = artifacts.load_patch_dir(best["artifact"])
    want_patch, want_scale = states[best["epoch"] - 1]
    if Path(best["artifact"]).name != f"patch_{best['epoch']}_{best['val_asr_to_scale']:.4f}" \
            or not np.array_equal(patch, want_patch.cpu().numpy()) \
            or scale != float(want_scale):
        fail(f"phase 19a: best artifact {best['artifact']} is not epoch "
             f"{best['epoch']}'s state")
    lr = float(astate.optimizer.param_groups[0]["lr"])
    restart = ns.epoch_soak(cfg, net, pool, rng, val_imgs, str(Path(work) / "r"),
                            epochs=0, steps_per_epoch=3, batch=ATTACK_BATCH, seed=0,
                            window=ATTACK_WINDOW, eot_draws=2, max_hours=10.0,
                            initial_patch=best["artifact"], initial_lr=lr,
                            record={}, out_json=str(Path(work) / "r.json"),
                            device=dev)
    if not (np.array_equal(restart.patch.detach().cpu().numpy(), patch)
            and float(restart.scale.detach()) == scale
            and restart.optimizer.param_groups[0]["lr"] == lr):
        fail("phase 19a: the --initial-patch restart does not start from the best "
             "artifact's patch, scale and the given lr")
    del astate, restart, states
    print(f"phase 19a north-star epoch loop (lite4@640 b{ATTACK_BATCH} bf16, window "
          f"{ATTACK_WINDOW}, score threshold {DEFEND_THRESH}; 2 epochs of 3 steps, 1 "
          f"val batch x 2 draws): {time.perf_counter() - t0:.2f} s with the pool and "
          f"the victim file; launches {counts}; per train step "
          f"{steps.calls[0][1]}; rows {[(r['epoch'], r['val_asr'], r['scale'], r['lr']) for r in rows]}; "
          f"best {Path(best['artifact']).name} equal to its epoch's state; the "
          f"restart from it starts there at lr {lr}")

    # phase 19b: the frontier, one scale at window 448, 3 steps and the
    # converged evaluation over 4 val batches x 4 draws
    t0 = time.perf_counter()
    scales = []
    frozen = lambda atk, st, images, batch_idx=0, **kw: scales.append(
        (atk.window, atk.freeze_scale, st.scale.detach().clone()))
    val4 = ns.val_pool(0, 4, ATTACK_BATCH, dev)
    record = {"config": ns.config_record(cfg, ns.parse_args(["--val-batches", "4"]))}
    fout = str(Path(work) / "frontier.json")
    reset_path_counts()
    with PerCall(PatchAttacker, "train_step") as fsteps, \
            PerCall(PatchAttacker, "eval_step", hook=frozen):
        ns.frontier(cfg, net, pool, rng, val4, [0.6], steps=3, batch=ATTACK_BATCH,
                    seed=0, record=record, out_json=fout, device=dev)
    torch.cuda.synchronize()
    fcounts = path_counts()
    fwindows = warp_cuda.WINDOWS
    launched_every("phase 19b", fcounts, (*WARP_KERNELS, "nms", "mbconv_fwd_bf16",
                                          "mbconv_dx_bf16"))
    if len(fsteps.calls) != 3:
        fail(f"phase 19b: {len(fsteps.calls)} train steps")
    attack_step_launches("phase 19b", fsteps.calls)
    if len(scales) != 16 or any(w != FRONTIER_WINDOW or not fz or
                                not torch.equal(sc, torch.tensor(0.6, device=dev))
                                for w, fz, sc in scales):
        fail(f"phase 19b: evaluations (window, freeze_scale, scale) {scales}")
    frec = json.loads(Path(fout).read_text())
    covers(frec, doc("FRONTIER.json"), "frontier.json")
    frow = frec["frontier"][0]
    print(f"phase 19b frontier (scale .6 frozen, window {FRONTIER_WINDOW}, 3 steps, "
          f"4 val batches x 4 draws): {time.perf_counter() - t0:.2f} s; launches "
          f"{fcounts}, {fwindows} windows warped; scale bit-equal to .6 in all 16 "
          f"evaluations; val_asr {frow['val_asr']}, val mean max score "
          f"{frow['val_mean_max_score']}")

    # the warp kernels at window 448 on a frontier step's inputs, the b24 live
    # regime's boxes (phase 6 at window 320), against the plain passes, timed
    t0 = time.perf_counter()
    atk = PatchAttacker(cfg, net, window=FRONTIER_WINDOW, freeze_scale=True, device=dev)
    st = atk.init_state(11, initial_scale=0.6)
    boxes, valid = make_live_slot_boxes(ATTACK_BATCH, atk.image_hw, atk.max_boxes)
    override = (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))
    images = pool.sample(rng, ATTACK_BATCH)[0]
    with Capture([(warp_cuda, k) for k in WARP_KERNELS]) as cap:
        atk.train_step(st, images, with_asr=False, boxes_override=override)
    torch.cuda.synchronize()
    (canvases, table, w), _ = cap.args["pass1_fwd"][0]
    (t_in, _), _ = cap.args["pass2_fwd"][0]
    (g_in, _, p0), _ = cap.args["pass2_bwd"][0]
    (dt_in, _, n_img), _ = cap.args["pass1_bwd"][0]
    with torch.no_grad():
        errs, _ = check_warp("w448 step inputs", canvases, table, w, g=g_in)
        bounds = warp_bounds(n_img, table.shape[0], p0, w, warp_taps(table, n_img, p0, w))
        calls = {
            "pass1_fwd": (lambda: warp_cuda.pass1_fwd(canvases, table, w),
                          lambda: eot.pass1_fwd(canvases, table, w)),
            "pass2_fwd": (lambda: warp_cuda.pass2_fwd(t_in, table),
                          lambda: eot.pass2_fwd(t_in, table)),
            "pass2_bwd": (lambda: warp_cuda.pass2_bwd(g_in, table, p0),
                          lambda: eot.pass2_bwd(g_in, table, p0)),
            "pass1_bwd": (lambda: warp_cuda.pass1_bwd(dt_in, table, n_img),
                          lambda: eot.pass1_bwd(dt_in, table, n_img)),
        }
        for k, (kern_fn, plain_fn) in calls.items():
            kern_ms = kernel_device_ms(kern_fn, f"{k}_kernel")
            plain_ms = cuda_ms(plain_fn, iters=3, warmup=1)
            bound_ms, bound_by, nbytes, ops = bounds[k]
            print(f"  warp {k} at window {w}, a frontier step's {table.shape[0]} "
                  f"windows (scale .6, p0 {p0}, {n_img} canvases): kernel "
                  f"{kern_ms:.4f} ms on the card, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} fp32 ops), "
                  f"{bound_ms / kern_ms:.1%} of the bound; max error {errs[k]:.3g}")
    del cap, canvases, t_in, g_in, dt_in, atk, st, val4
    print(f"phase 19b warp kernels at window {FRONTIER_WINDOW} on a frontier step's "
          f"inputs: within {WARP_TOL} of the plain passes, two launches bit-equal, in "
          f"{time.perf_counter() - t0:.2f} s")

    # phase 19c: the production soak's attack stage (3 steps) and its
    # defender stage against that patch (2 steps, one eval of 2 batches)
    t0 = time.perf_counter()
    evals = []

    def clean_max(dfd, st, images, batch_idx=0, **kw):
        """(boxes the masker can patch, the highest clean score) of a batch:
        valid boxes of its first max_boxes slots at least 4 px a side."""
        bx, sc, ok = dfd.odet_boxes(torch.as_tensor(images).to(dev))
        k = dfd.max_boxes
        big = ((bx[:, :k, 2] - bx[:, :k, 0]) >= 4) & ((bx[:, :k, 3] - bx[:, :k, 1]) >= 4)
        evals.append((int((ok[:, :k] & big).sum()),
                      float(torch.where(ok, sc.float(), 0.0).max())))

    record = {"config": {}}
    reset_path_counts()
    with PerCall(PatchAttacker, "train_step") as asteps:
        atk = PatchAttacker(cfg, net, window=ps.WINDOW, device=dev)
        astate = ps.attack(atk, pool, rng, work, attack_steps=3, batch=ATTACK_BATCH,
                           seed=0, log_every=2, record=record)
    patch = astate.patch.detach().cpu().numpy()
    scale = float(astate.scale.detach())
    del atk, astate
    with PerCall(PatchAttackDefender, "train_step") as dsteps, \
            PerCall(PatchAttackDefender, "eval_step", hook=clean_max) as devals:
        dstate = ps.defend(cfg, net, patch, scale, pool, rng, work, defend_steps=2,
                           batch=ATTACK_BATCH, seed=0, log_every=2, record=record,
                           device=dev)
    torch.cuda.synchronize()
    scounts = path_counts()
    launched_every("phase 19c", scounts, (*WARP_KERNELS, "nms", "mbconv_fwd_bf16",
                                          "mbconv_dx_bf16", "cmconv_bf16"))
    attack_step_launches("phase 19c attack", asteps.calls)
    for _, got in dsteps.calls:
        if (got["cmconv_bf16"], got["cmconv_fp32"], got["nms"],
                got["mbconv_fwd_bf16"], got["mbconv_fp32"]) != (
                    CMCONV_PER_STEP, 0, 1, MBCONV_PER_PASS, 0):
            fail(f"phase 19c: a defender step launched {got}")
    if len(dsteps.calls) != 2 or len(devals.calls) != 2:
        fail(f"phase 19c: {len(dsteps.calls)} defender steps, {len(devals.calls)} evals")
    row = record["defense_trajectory"][-1]
    detections = sum(n for n, _ in evals)
    eligible = any(m > 0.55 for _, m in evals)
    if not np.isfinite(row["val_loss"]):
        fail(f"phase 19c: val_loss {row['val_loss']}")
    if np.isnan(row["recovery_psnr"]) and detections:
        fail(f"phase 19c: recovery PSNR NaN with {detections} detections to patch")
    if not np.isfinite(row["recovery_psnr"]) and not np.isnan(row["recovery_psnr"]):
        fail(f"phase 19c: recovery PSNR {row['recovery_psnr']}")
    if np.isnan(row["adr"]) and eligible and detections:
        fail("phase 19c: ADR NaN though an image's clean score exceeds .55")
    adr_case = ("finite" if np.isfinite(row["adr"]) else
                "NaN: no patched region" if not detections else
                "NaN: no image whose clean score exceeds .55 (clean max "
                f"{max(m for _, m in evals):.4f})")
    path = ps.write_json(str(Path(work) / "soak.json"), record)
    covers(json.loads(Path(path).read_text()),
           {k: v for k, v in doc("SOAK_r03_1k.json").items()
            if k not in ("config", "victim")}, "soak.json")
    best = record["defense_best"]
    saved = load_pytree(best["artifact"])
    mem = bridge.torch_to_flax(dstate.unet)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    if [k for k, _ in leaves(saved)] != [k for k, _ in leaves(mem)] or not all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(leaves(saved), leaves(mem))):
        fail(f"phase 19c: {best['artifact']}.pkl does not read back as the U-Net")
    del dstate, pool, net
    torch.cuda.empty_cache()
    print(f"phase 19c production soak stages (attack 3 steps, defender 2 steps and "
          f"one eval of 2 batches): {time.perf_counter() - t0:.2f} s; launches "
          f"{scounts}; per defender step {dsteps.calls[0][1]}; attack rows "
          f"{[(r['step'], r['asr'], r['scale']) for r in record['attack_trajectory']]}; "
          f"val_loss {row['val_loss']}, recovery PSNR {row['recovery_psnr']} dB "
          f"({detections} clean detections in the eval batches), ADR {row['adr']} "
          f"({adr_case}); {Path(best['artifact']).parent.name}/antipatch.pkl reads back "
          f"equal; soak.json keys cover the TPU record's")


DEMO_FRAMES = 8
DEMO_HW = (720, 1280)
DEMO_CMCONV_PER_FRAME = 8  # the U-Net's forward ConvBlocks of at most 16 filters


def demo_phase(dev, work: str) -> dict:
    """Phase 20: the video demos' device path (`demo/`) at lite4@640 on
    720x1280 frames of the synthetic clip: `make_demo_detector`'s `infer`
    (NMS at score 0: every candidate stays valid and the chain runs to the
    end) and `RecoveryDemo.recover`, the U-Net on one normalized frame, its
    seeded weights written with `ckpt/io` and read back through
    `load_antipatch`. Returns the launches per frame and the kernels' numbers
    at the phase's own inputs. The demos' cv2 parts (reading, drawing,
    writing, the recovered frame's resize) are held to JAX on the CPU by
    tests/test_torch_demo.py; none runs here."""
    from pathlib import Path

    import torch
    from mladversarialobjectdetection_torch.ckpt import bridge
    from mladversarialobjectdetection_torch.ckpt.io import save_pytree
    from mladversarialobjectdetection_torch.demo import make_demo_detector
    from mladversarialobjectdetection_torch.demo import synthetic_clip
    from mladversarialobjectdetection_torch.demo.demo_v2 import RecoveryDemo
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.models.init import init_weights
    from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer
    from mladversarialobjectdetection_torch.ops import cmconv, cmconv_cuda, postprocess
    from mladversarialobjectdetection_torch.ops.preprocess import preprocess_host

    t0 = time.perf_counter()
    frames, _ = synthetic_clip.render_frames(DEMO_FRAMES, *DEMO_HW, n_persons=2,
                                             seed=20)
    det = make_demo_detector("efficientdet-lite4", device=dev)
    nms_cfg = det.config.nms_configs
    if (nms_cfg.score_thresh, nms_cfg.iou_thresh, nms_cfg.method) != (0.0, 0.5, "gaussian"):
        fail(f"phase 20: the demo detector's NMS {det._params_dict['nms_configs']}")
    unet = PatchNeutralizer()
    init_weights(unet, torch.Generator().manual_seed(20))
    upath = str(Path(work) / "antipatch")
    save_pytree(upath, bridge.torch_to_flax(unet))
    rd = RecoveryDemo(upath, det)
    want = unet.state_dict()
    if any(not torch.equal(v.cpu(), want[k]) for k, v in rd.unet.state_dict().items()):
        fail("phase 20: the U-Net read back through load_antipatch differs")
    cfg = det.config
    pre = [preprocess_host(f, cfg.image_size, cfg.mean_rgb, cfg.stddev_rgb)[0]
           for f in frames]
    normalized = lambda i: torch.from_numpy(pre[i])[None].to(dev)
    det.infer(frames[0])
    rd.recover(normalized(0))
    torch.cuda.synchronize()

    reset_path_counts()
    dets, recs = [], []
    with PerCall(Detector, "infer") as infers, PerCall(RecoveryDemo, "recover") as recovers:
        for i, frame in enumerate(frames):
            dets.append(det.infer(frame))
            recs.append(rd.recover(normalized(i)))
    torch.cuda.synchronize()
    counts = path_counts()
    launched_every("phase 20", counts, ("nms", "mbconv_fp32", "cmconv_fp32"))
    zero = dict.fromkeys(counts, 0)
    for _, got in infers.calls:
        if got != dict(zero, nms=1, mbconv_fp32=MBCONV_PER_PASS):
            fail(f"phase 20: an infer launched {got}")
    for _, got in recovers.calls:
        if got != dict(zero, cmconv_fp32=DEMO_CMCONV_PER_FRAME):
            fail(f"phase 20: a recover launched {got}")
    for bb, sc in dets:
        if len(bb) != len(sc) or not all(np.isfinite(b).all() for b in bb) or \
                not all(0.0 <= s <= 1.0 for s in sc):
            fail(f"phase 20: infer gave {len(bb)} boxes, scores {sc[:4]}")
    hw = tuple(pre[0].shape[:2])
    for r in recs:
        if r.shape != (1, *hw, 3) or not bool(torch.isfinite(r).all()) or \
                float(r.abs().max()) > 1.0:
            fail(f"phase 20: recovery {tuple(r.shape)}, max |r| {float(r.abs().max())}")
    full = det.serve(frames[:1])
    m = nms_cfg.max_output_size
    if int(full.valid_len[0]) != m:
        fail(f"phase 20: valid_len {full.valid_len} at score 0, want all {m}")
    det_ms = statistics.median(
        host_p50_ms(lambda f=f: det.infer(f), iters=3, warmup=1) for f in frames)
    pre_ms = host_p50_ms(lambda: preprocess_host(frames[0], cfg.image_size,
                                                 cfg.mean_rgb, cfg.stddev_rgb),
                         iters=DEMO_FRAMES)
    x0 = normalized(0)
    rec_ms = host_p50_ms(lambda: rd.recover(x0), iters=DEMO_FRAMES)
    rec_host_ms = host_p50_ms(lambda: rd.recover(normalized(0)).cpu().numpy(),
                              iters=DEMO_FRAMES)
    profile_device(lambda: rd.recover(x0), "recover b1")
    print(f"phase 20 demos' device path ({cfg.name}@{hw[0]}, seeded weights, {DEMO_FRAMES} "
          f"synthetic {DEMO_HW[0]}x{DEMO_HW[1]} frames): launches {counts}; per frame "
          f"{infers.calls[0][1]['nms']} NMS and {infers.calls[0][1]['mbconv_fp32']} "
          f"fused MBConv forward (infer), {recovers.calls[0][1]['cmconv_fp32']} cmconv "
          f"(recover); persons per frame "
          f"{[len(bb) for bb, _ in dets]} of {m} valid slots; detection p50 "
          f"{det_ms:.3f} ms/frame (infer: host preprocess {pre_ms:.3f} ms, forward, "
          f"NMS, to host); recovery p50 {rec_ms:.3f} ms/frame on the card "
          f"({rec_host_ms:.3f} with the copies to and from the host); cv2 parts held "
          f"on the CPU "
          f"(tests/test_torch_demo.py), cv2 imported here: {'cv2' in sys.modules}")

    # NMS at score 0 on the phase's own candidates, beside its serve row
    images, _ = det.preprocess(frames[:1])
    with torch.no_grad():
        cls_out, box_out = det.net(torch.from_numpy(images).to(dev))
        cand_boxes, cand_scores, _ = postprocess._pre_nms_select(
            det._params_dict, cls_out, box_out)
    nms_ms, nms_plain_ms, nms_bound_ms, nms_bound_by, nms_err = nms_numbers(
        cand_boxes.contiguous(), cand_scores.contiguous(),
        postprocess.nms_kwargs_from_config(nms_cfg), "demo score 0")

    # cmconv at the U-Net's b1 inputs against the plain version, timed
    with Capture([(cmconv_cuda, "cmconv3x3_cuda")]) as cap:
        rd.recover(normalized(1))
    torch.cuda.synchronize()
    calls = [a for a, _ in cap.args["cmconv3x3_cuda"]]
    if len(calls) != DEMO_CMCONV_PER_FRAME:
        fail(f"phase 20: captured {len(calls)} cmconv calls in a recover")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    cm_err = 0.0
    with torch.no_grad():
        for i, (x, w, bias) in enumerate(calls):
            c, co = w.shape[2], w.shape[3]
            cm_err = max(cm_err, kernel_err(f"phase 20 cmconv call {i}",
                                            cmconv_cuda.cmconv3x3_cuda(x, w, bias),
                                            cmconv.cmconv_plain(x, w, bias)))
            pick = cmconv_cuda.plan(c, co, x.shape[2], x.shape[3]).instance
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            ms = kernel_device_ms(lambda: cmconv_cuda.cmconv3x3_cuda(x, w, bias),
                                  CMCONV_KERNEL[pick], iters=5, sessions=2)
            plain_ms = cuda_ms(lambda: cmconv.cmconv_plain(x, w, bias), iters=2,
                               warmup=1)
            lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
                x, w_oihw, bias, padding=1), iters=10)
            _, bound_by, nbytes, ops = cmconv_bound(x, co, bias is not None)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes_ms", nbytes / HBM_BYTES_PER_S * 1e3),
                         ("ops_ms", ops / FP32_FLOP_PER_S * 1e3)):
                tot[k] += v
            print(f"  cmconv recover call {i} {c}->{co} {tuple(x.shape)}: plan {pick}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.conv2d {lib_ms:.4f} "
                  f"ms, bound {max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3:.6f} "
                  f"ms ({bound_by})")
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    print(f"phase 20 kernels at the demo's inputs: NMS at score 0 {nms_ms:.4f} ms "
          f"(bound {nms_bound_ms:.6f} ms, {nms_bound_by}; plain {nms_plain_ms:.4f} ms; "
          f"max error {nms_err}); cmconv over a recover's {len(calls)} launches "
          f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.6f} ms, {tot['bound_by']}; "
          f"plain {tot['plain_ms']:.4f} ms, F.conv2d {tot['library_ms']:.4f} ms), max "
          f"error {cm_err:.3g} (limit {WARP_TOL} of scale); "
          f"{time.perf_counter() - t0:.2f} s")
    del det, rd, recs, cand_boxes, cand_scores, cls_out, box_out, calls, cap
    torch.cuda.empty_cache()
    return {"launches_per_frame": {"nms": 1, "mbconv_fwd": MBCONV_PER_PASS,
                                   "cmconv": DEMO_CMCONV_PER_FRAME},
            "detect_p50_ms": det_ms, "recover_p50_ms": rec_ms,
            "nms_ms": nms_ms, "nms_bound_ms": nms_bound_ms, "cmconv": tot,
            "cmconv_err": cm_err}


class StepTimes:
    """Host wall time of every call of `cls.name` in its block, each call
    bracketed by synchronizes (ms, in call order)."""

    def __init__(self, cls, name: str):
        self.cls, self.name, self.ms = cls, name, []

    def __enter__(self):
        import torch
        self.orig = getattr(self.cls, self.name)

        def timed(obj, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(obj, *a, **kw)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


class PlainMBConv:
    """Runs the plain fused-MBConv forward (`ops/mbconv.mbconv_plain`)
    wherever the op would launch its kernel, in its block."""

    def __enter__(self):
        from mladversarialobjectdetection_torch.ops import mbconv
        self.mod, self.orig = mbconv, mbconv._forward
        mbconv._forward = lambda x, fb, act_type, residual: mbconv.mbconv_plain(
            x, fb, act_type=act_type, residual=residual)
        return self

    def __exit__(self, *exc):
        self.mod._forward = self.orig


def grad_checkpoint_phase(dev) -> None:
    """Phase 21d: one fp32 train step at the trainer's operating point with
    `grad_checkpoint` on and off from the same state and batch, then a
    timed second step of each; peak memory of each."""
    import torch
    from mladversarialobjectdetection_torch.data.pipeline import synthetic_person_batch
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    from mladversarialobjectdetection_torch.train.victim import make_config

    rng = np.random.default_rng(21)
    images, boxes, classes, valid = synthetic_person_batch(rng, TRAIN_BATCH)
    images = torch.from_numpy(images).to(dev)
    torch.backends.cudnn.deterministic = True
    runs = {}
    for gc in (True, False):
        cfg = make_config(mixed_precision=False)
        cfg.grad_checkpoint = gc
        tr = DetectorTrainer(cfg, steps_per_epoch=800, device=dev)
        st = tr.init_state(seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        st, m = tr.train_step(st, images, boxes, classes, valid)
        loss = float(m["loss"])
        grads = {n: p.grad.detach().clone() for n, p in st.net.named_parameters()}
        stats = {n: b.detach().clone() for n, b in st.net.named_buffers()}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = tr.train_step(st, images, boxes, classes, valid)
        float(m["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        runs[gc] = dict(loss=loss, grads=grads, stats=stats, peak=peak, ms=step_ms)
        del tr, st, m
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    on, off = runs[True], runs[False]
    worst = 0.0
    for key in ("grads", "stats"):
        for n, ref in off[key].items():
            d = float((on[key][n] - ref).abs().max())
            worst = max(worst, d / max(1.0, float(ref.abs().max())))
    loss_rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    if worst > TRAIN_F32_TOL or loss_rel > TRAIN_F32_TOL or not np.isfinite(on["loss"]):
        fail(f"grad_checkpoint: gradients and statistics {worst:.3g} of scale, loss "
             f"{loss_rel:.3g} relative from no checkpointing (limit {TRAIN_F32_TOL})")
    print(f"phase 21d grad_checkpoint (train/victim.make_config, lite4@640 b{TRAIN_BATCH}, "
          f"fp32, one step from the same state, cuDNN deterministic): loss "
          f"{on['loss']:.6f} vs {off['loss']:.6f}, gradients and BatchNorm statistics "
          f"{'bit-equal' if worst == 0.0 and loss_rel == 0.0 else f'within {worst:.3g} of scale'}"
          f" (limit {TRAIN_F32_TOL}); on: peak {on['peak']:.3f} GB, step "
          f"{on['ms']:.3f} ms; off: peak {off['peak']:.3f} GB, step {off['ms']:.3f} ms "
          f"(phase 15's fp32 peak: 79.8 GB, PERF.md)")


def supervised_driver_phase(dev, work: str) -> None:
    """Phase 21a: `train.train` at lite4@640 b8 with synthetic input: two
    epochs, a resume to three, and a pruned run."""
    from pathlib import Path

    import torch
    from mladversarialobjectdetection_torch.ckpt import bridge
    from mladversarialobjectdetection_torch.ckpt.io import load_pytree
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    from mladversarialobjectdetection_torch.train import train as sup
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer

    kw = dict(train_pattern=None, batch_size=SUP_BATCH, steps_per_epoch=SUP_STEPS,
              device=dev)
    mdir = str(Path(work) / "detector")
    mbconv_cuda.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with StepTimes(DetectorTrainer, "train_step") as steps:
        first = sup.train("efficientdet-lite4", model_dir=mdir, num_epochs=2, **kw)
    driver_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    fused = dict(mbconv_cuda.LAUNCHES)
    files = sorted(p.name for p in Path(mdir).iterdir())
    if files != ["ckpt-0.pkl", "ckpt-1.pkl", "logs", "state-latest.msgpack"] or \
            first.step != 2 * SUP_STEPS or sum(fused.values()):
        fail(f"phase 21a: files {files}, step {first.step}, fused launches {fused}")
    # ckpt-1 holds the inference net of the state at the end of epoch 1
    saved = bridge.torch_to_flax(DetectorTrainer(
        sup.config_lib.get_efficientdet_config("efficientdet-lite4"),
        device=dev).eval_variables(first))
    read = load_pytree(str(Path(mdir) / "ckpt-1"))
    flat = lambda d, p="": ([(p + k, v) for k, v in d.items() if not isinstance(v, dict)]
                            + [x for k, v in d.items() if isinstance(v, dict)
                               for x in flat(v, p + k + "/")])
    rd = dict(flat(read))
    if sorted(rd) != sorted(k for k, _ in flat(saved)) or not all(
            np.array_equal(v, rd[k]) for k, v in flat(saved)):
        fail("phase 21a: ckpt-1 does not read back equal to the state it was saved from")
    del first
    res = sup.train("efficientdet-lite4", model_dir=mdir, num_epochs=3, resume=True, **kw)
    with open(Path(mdir) / "logs" / "metrics.jsonl") as f:
        logged = [json.loads(line)["step"] for line in f]
    if res.step != 3 * SUP_STEPS or logged != [SUP_STEPS, 2 * SUP_STEPS, 3 * SUP_STEPS]:
        fail(f"phase 21a resume: step {res.step}, logged steps {logged}")
    del res
    pdir = str(Path(work) / "pruned")
    pruned = sup.train("efficientdet-lite4", model_dir=pdir, num_epochs=2,
                       prune_sparsity=0.5, prune_end=2 * SUP_STEPS, **kw)
    named = {id(p): n for n, p in pruned.net.named_parameters()}
    off_by, n_kernels = 0, 0
    for path, p in bridge.named_kernel_parameters(pruned.net):
        zeros = int((p == 0).sum())
        off_by = max(off_by, abs(zeros - 0.5 * p.numel()))
        n_kernels += 1
        if not bool((pruned.ema[named[id(p)]][p == 0] == 0).all()):
            fail(f"phase 21a prune: the EMA of {path} is not zero where it is")
    if off_by > 1:
        fail(f"phase 21a prune: a kernel is {off_by} weights off .5")
    with open(Path(pdir) / "logs" / "metrics.jsonl") as f:
        sparsity = json.loads(f.readlines()[-1])["train/sparsity"]
    del pruned
    torch.cuda.empty_cache()
    p50 = statistics.median(steps.ms[1:])
    print(f"phase 21a supervised driver (train.train efficientdet-lite4, synthetic, fp32, "
          f"batch {SUP_BATCH}, 2 epochs of {SUP_STEPS} steps) in {driver_s:.2f} s: files "
          f"{files}, 0 fused MBConv launches while training, step p50 {p50:.3f} ms "
          f"({1e3 * SUP_BATCH / p50:.2f} images/s; steps {' '.join(f'{v:.1f}' for v in steps.ms)}), "
          f"peak {peak:.3f} GB; ckpt-1 reads back equal; resume to 3 epochs: "
          f"epoch 2 only, step {3 * SUP_STEPS}; prune .5 by step {2 * SUP_STEPS}: "
          f"{n_kernels} kernels within {off_by:g} weight of .5, overall {sparsity:.6f}, "
          f"EMA zero with them")


def evaluate_map_phase(dev, vpath: str) -> dict:
    """Phase 21b: `evaluate_map` on the phase 16 victim over held-out
    scenes, with the kernels and with the plain versions on the card; the
    NMS kernel and the 25 bf16 forward launches at an eval batch's inputs."""
    import torch
    from mladversarialobjectdetection_torch.ckpt.io import load_pytree
    from mladversarialobjectdetection_torch.data.pipeline import ScenePool
    from mladversarialobjectdetection_torch.ops import mbconv, mbconv_cuda, nms_cuda
    from mladversarialobjectdetection_torch.train import train as sup
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    from mladversarialobjectdetection_torch.train.victim import make_config

    # the 12-step victim scores about .01: NMS and the evaluation at
    # DEFEND_THRESH, as phase 19's stages, so that detections are ranked
    cfg = make_config(mixed_precision=True)
    cfg.nms_configs.update({"score_thresh": DEFEND_THRESH})
    tr = DetectorTrainer(cfg, device=dev)
    st = tr.init_state(variables=load_pytree(vpath))
    pool = ScenePool(np.random.default_rng(2121), n_batches=EVAL_BATCHES,
                     batch=TRAIN_BATCH, hw=640, device=dev)

    def batches():
        for i in range(EVAL_BATCHES):
            rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
            yield {"images": pool.images[rows], "boxes": pool.boxes[rows],
                   "classes": pool.classes[rows], "valid": pool.valid[rows]}

    sup.evaluate_map(tr, st, batches(), 1)  # warm-up
    reset_path_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Capture([(nms_cuda, "batched_nms_cuda"),
                  (mbconv_cuda, "mbconv_fwd_cuda")]) as cap:
        res = sup.evaluate_map(tr, st, batches(), EVAL_BATCHES, score_thresh=DEFEND_THRESH)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = path_counts()
    want = dict.fromkeys(counts, 0)
    want.update(nms=EVAL_BATCHES, mbconv_fwd_bf16=EVAL_BATCHES * MBCONV_PER_PASS)
    if counts != want:
        fail(f"phase 21b: evaluate_map launched {counts}, want {want}")
    with PlainNMS(), PlainMBConv():
        plain = sup.evaluate_map(tr, st, batches(), EVAL_BATCHES, score_thresh=DEFEND_THRESH)
    if path_counts() != want:
        fail(f"phase 21b: the plain evaluation launched kernels {path_counts()}")
    diffs = {k: abs(res[k] - plain[k]) for k in res}
    if not all(np.isfinite(v) for v in res.values()) or max(diffs.values()) > EVAL_AP_TOL:
        fail(f"phase 21b: kernels {res} vs plain {plain} (limit {EVAL_AP_TOL})")
    # the kernels at the last eval batch's inputs
    (boxes, scores), nkw = cap.args["batched_nms_cuda"][-1]
    nms_ms, nms_plain_ms, nms_bound_ms, nms_bound_by, nms_err = nms_numbers(
        boxes, scores, nkw, "evaluate_map per_class")
    fwd = cap.args["mbconv_fwd_cuda"][-MBCONV_PER_PASS:]
    mb = dict.fromkeys(("ms", "plain_ms", "bytes_ms", "ops_ms"), 0.0)
    mb_err = 0.0
    with torch.no_grad():
        for (x, fb), kw in fwd:
            kw = dict(act_type=kw["act_type"], residual=kw["residual"])
            kern = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
            ref = mbconv.mbconv_plain(x, fb, **kw)
            mb_err = max(mb_err, float((kern.float() - ref.float()).abs().max())
                         / max(1.0, float(ref.float().abs().max())))
            mb["ms"] += cuda_ms(lambda: mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw), iters=10)
            mb["plain_ms"] += cuda_ms(lambda: mbconv.mbconv_plain(x, fb, **kw), iters=2,
                                      warmup=1)
            _, _, nbytes, _, _, ops_ms = mbconv_bound(
                tuple(x.shape), fb.we.shape[1], fb.wp.shape[1], fb.wd.shape[0],
                kw["residual"], False, x.element_size())
            mb["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
            mb["ops_ms"] += ops_ms
    if mb_err > MBCONV_BF16_FWD_TOL:
        fail(f"phase 21b: bf16 fused forward {mb_err:.3g} of scale from plain")
    mb["bound_ms"] = max(mb["bytes_ms"], mb["ops_ms"])
    mb["bound_by"] = "bytes" if mb["bytes_ms"] >= mb["ops_ms"] else "operations"
    n_det = sum(int((a[1] > DEFEND_THRESH).sum()) for a, _ in cap.args["batched_nms_cuda"])
    print(f"phase 21b evaluate_map (phase 16's bf16 victim, {EVAL_BATCHES} batches of "
          f"{TRAIN_BATCH} held-out scenes, NMS and score {DEFEND_THRESH}: {n_det} "
          f"candidates above it) in {eval_s:.3f} s "
          f"({1e3 * eval_s / EVAL_BATCHES:.3f} ms a batch): launches {counts} "
          f"({MBCONV_PER_PASS} bf16 fused forward and 1 NMS a batch); AP {res['AP']:.6f} "
          f"AP50 {res['AP50']:.6f} AP75 {res['AP75']:.6f} ARmax100 {res['ARmax100']:.6f}; "
          f"plain versions of both ops: AP {plain['AP']:.6f} AP50 {plain['AP50']:.6f} "
          f"AP75 {plain['AP75']:.6f} (all 12 metrics within {max(diffs.values()):.3g}, "
          f"limit {EVAL_AP_TOL}); "
          f"at the last batch's inputs: NMS {nms_ms:.4f} ms (bound {nms_bound_ms:.6f} ms, "
          f"{nms_bound_by}; plain {nms_plain_ms:.4f} ms), the 25 bf16 forward launches "
          f"{mb['ms']:.4f} ms (bound {mb['bound_ms']:.6f} ms, {mb['bound_by']}; plain "
          f"{mb['plain_ms']:.4f} ms), max error {mb_err:.3g} of scale")
    del tr, st, pool, cap, fwd
    torch.cuda.empty_cache()
    return {"launches_per_batch": {"nms": 1, "mbconv_fwd_bf16": MBCONV_PER_PASS},
            "ms_per_batch": 1e3 * eval_s / EVAL_BATCHES, "AP": res["AP"],
            "nms_ms": nms_ms, "nms_bound_ms": nms_bound_ms, "nms_err": nms_err,
            "mbconv": mb, "mbconv_err": mb_err}


def segmentation_phase(dev, work: str) -> None:
    """Phase 21c: `segmentation.train` at lite4@640, heads ("segmentation",),
    batch 8, 3 steps; then the logits of one batch."""
    from pathlib import Path

    import torch
    from mladversarialobjectdetection_torch.train import segmentation as seg

    torch.cuda.reset_peak_memory_stats(dev)
    with StepTimes(seg.SegmentationTrainer, "train_step") as steps:
        state, metrics = seg.train("efficientdet-lite4", image_size=640,
                                   batch_size=SUP_BATCH, steps=SUP_STEPS, log_every=1,
                                   model_dir=str(Path(work) / "seg"), device=dev)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    size = seg.output_size(640, state.net.spec.min_level)
    images = next(seg.synthetic_seg_batches(SUP_BATCH, 640, size, seed=5))["images"]
    with torch.no_grad():
        (logits,) = state.net(torch.from_numpy(images).to(dev))
    shape = tuple(logits.shape)
    if shape != (SUP_BATCH, 160, 160, 3) or size != 160 or \
            not np.isfinite(metrics["loss"]) or not bool(torch.isfinite(logits).all()):
        fail(f"phase 21c: logits {shape}, output_size {size}, metrics {metrics}")
    p50 = statistics.median(steps.ms[1:])
    print(f"phase 21c segmentation trainer (efficientdet-lite4@640, heads "
          f"('segmentation',), batch {SUP_BATCH}, {SUP_STEPS} steps): loss "
          f"{metrics['loss']:.4f}, accuracy {metrics['accuracy']:.4f}, val accuracy "
          f"{metrics['val_accuracy']:.4f}; logits {shape}; step p50 {p50:.3f} ms "
          f"({1e3 * SUP_BATCH / p50:.2f} images/s; steps "
          f"{' '.join(f'{v:.1f}' for v in steps.ms)}), peak {peak:.3f} GB")
    del state, logits
    torch.cuda.empty_cache()


def tfrecord_native_phase(work: str) -> None:
    """Phase 21e: the native TFRecord reader built on the host, against the
    pure-python framing, on records of raw image bytes."""
    from pathlib import Path

    from mladversarialobjectdetection_torch import _build
    from mladversarialobjectdetection_torch.data import tfrecord
    from mladversarialobjectdetection_torch.data.create_coco_tfrecord import (
        make_example, write_records)

    t0 = time.perf_counter()
    lib = _build.build_tfrecord_native()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(215)
    recs = [make_example(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8).tobytes(),
                         64, 80, rng.uniform(0, 1, (i % 4, 4)), [1] * (i % 4),
                         [0] * (i % 4), str(i)) for i in range(32)]
    path = Path(work) / "raw.tfrecord"
    write_records(recs, str(path))
    native = tfrecord._native()
    got = list(native.read_records(str(path)))
    orig = tfrecord._native
    tfrecord._native = lambda: None
    try:
        python = list(tfrecord.read_tfrecord_file(str(path)))
    finally:
        tfrecord._native = orig
    if got != python or got != recs or list(tfrecord.read_tfrecord_file(str(path))) != recs:
        fail("phase 21e: the native reader's payloads differ from the python framing's")
    data = bytearray(path.read_bytes())
    data[12 + len(recs[0])] ^= 0x04  # the first payload's CRC
    bad = Path(work) / "bad.tfrecord"
    bad.write_bytes(bytes(data))
    try:
        list(tfrecord.read_tfrecord_file(str(bad)))
    except ValueError as e:
        raised = str(e)
    else:
        fail("phase 21e: a flipped CRC did not raise")
    print(f"phase 21e native TFRecord reader: built {lib.name} in {build_s:.2f} s; "
          f"{len(recs)} records ({path.stat().st_size} bytes) equal to the python "
          f"framing's; a flipped CRC raises: {raised!r}")


def stdlib_png(img: np.ndarray) -> bytes:
    """An RGB uint8 image as a PNG (filter 0 rows, zlib), without PIL."""
    import struct
    import zlib

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w, _ = img.shape
    rows = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


class StdlibPngDecode:
    """In its block the TFRecord reader decodes `stdlib_png` images with zlib:
    `data/tfrecord.decode_detection_example` opens images with PIL, which the
    card's machine lacks. Boxes, labels and crowd flags as it reads them."""

    def __enter__(self):
        import struct
        import zlib

        from mladversarialobjectdetection_torch.data import tfrecord
        self.mod, self.orig = tfrecord, tfrecord.decode_detection_example

        def decode(example):
            data = example["image/encoded"][0]
            w, h = struct.unpack(">II", data[16:24])
            pos, idat = 8, b""
            while pos < len(data):
                n, kind = struct.unpack(">I4s", data[pos:pos + 8])
                if kind == b"IDAT":
                    idat += data[pos + 8:pos + 8 + n]
                pos += 12 + n
            rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
            if rows[:, 0].any():
                fail("phase 22d: a PNG row with a filter other than 0")
            coords = [np.asarray(example.get(f"image/object/bbox/{k}", []), np.float32)
                      for k in ("ymin", "xmin", "ymax", "xmax")]
            return {"image": rows[:, 1:].reshape(h, w, 3).copy(),
                    "boxes": (np.stack(coords, -1) if len(coords[0])
                              else np.zeros((0, 4), np.float32)),
                    "classes": np.asarray(example.get("image/object/class/label", []),
                                          np.int64),
                    "is_crowd": np.asarray(example.get("image/object/is_crowd", []),
                                           np.int64)}

        tfrecord.decode_detection_example = decode
        return self

    def __exit__(self, *exc):
        self.mod.decode_detection_example = self.orig


class PlainInt8:
    """In its block every int8 conv of the int8 serve runs `conv_int8_plain`
    (the plain version, on the card), not the kernel."""

    def __enter__(self):
        from mladversarialobjectdetection_torch.ops import conv_int8
        self.mod, self.orig = conv_int8, conv_int8.conv_int8
        conv_int8.conv_int8 = conv_int8.conv_int8_plain
        return self

    def __exit__(self, *exc):
        self.mod.conv_int8 = self.orig


def int8_call(call):
    """(x, a_s, wq, scale, bias, keywords) of a captured `conv_int8_cuda` call."""
    (x, a_s, wq, scale, *rest), kw = call
    kw = dict(kw)
    bias = rest[0] if rest else kw.pop("bias", None)
    return x, a_s, wq, scale, bias, kw


def conv_int8_bound(x, wq, bias, kw):
    """(bound ms, bound_by, bytes, ops) of one int8 conv call: x in its
    dtype, the int8 weights, scale, bias and the output once over HBM; two
    int8 operations per product at the dense int8 tensor-core rate."""
    import torch
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    b, _, h, w = x.shape
    co, cg, kh, kw_ = wq.shape
    _, (oh, ow) = ci.geometry(h, w, kh, kw_, kw.get("stride", 1), kw.get("padding", "SAME"))
    out_dtype = kw.get("out_dtype") or x.dtype
    out_bytes = b * co * oh * ow * torch.empty((), dtype=out_dtype).element_size()
    nbytes = (x.numel() * x.element_size() + wq.numel() + 4 * co * (1 + (bias is not None))
              + out_bytes)
    ops = 2 * b * co * oh * ow * cg * kh * kw_
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            nbytes, ops, bytes_ms, ops_ms)


def check_conv_int8(name, x, a_s, wq, scale, bias, kw) -> None:
    """The kernel's int32 sums and output bit-equal to the plain version's,
    and two launches bit-equal; fails otherwise."""
    import torch
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    geo = {k: kw[k] for k in ("stride", "padding", "groups") if k in kw}
    sums = ci.sums_cuda(x, a_s, wq, **geo)
    plain_sums = ci.sums_plain(ci.quantize_plain(x, a_s), wq, **geo)
    y = ci.conv_int8_cuda(x, a_s, wq, scale, bias, **kw)
    y2 = ci.conv_int8_cuda(x, a_s, wq, scale, bias, **kw)
    plain = ci.conv_int8_plain(x, a_s, wq, scale, bias, **kw)
    torch.cuda.synchronize()
    if not torch.equal(sums, plain_sums):
        fail(f"{name}: int32 sums differ from the plain version's in "
             f"{int((sums != plain_sums).sum())} places")
    if y.dtype != plain.dtype or not torch.equal(y, plain):
        fail(f"{name}: output differs from the plain version's by "
             f"{float((y.float() - plain.float()).abs().max())}")
    if not torch.equal(y, y2):
        fail(f"{name}: two launches differ")


def int8_numbers(calls) -> dict:
    """The int8 conv kernel at a serve's own inputs (its captured calls):
    each call held bit-equal to the plain version, then timed by CUDA events
    beside its bound, the plain version, `torch._int_mm` (cuBLASLt's int8
    product: the 1x1 convs only) and cuDNN's bf16 conv of the same shape."""
    import torch
    import torch.nn.functional as F
    from mladversarialobjectdetection_torch.models.efficientnet import pad_same
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, intmm_ms=0.0,
               intmm_kernel_ms=0.0, cudnn_bf16_ms=0.0, n_1x1=0, n_intmm=0, n=0,
               dense_ms=0.0, depthwise_ms=0.0, dense_bound_ms=0.0, depthwise_bound_ms=0.0)
    for i, call in enumerate(calls):
        x, a_s, wq, scale, bias, kw = int8_call(call)
        check_conv_int8(f"phase 22a serve conv {i}", x, a_s, wq, scale, bias, kw)
        ms = cuda_ms(lambda: ci.conv_int8_cuda(x, a_s, wq, scale, bias, **kw), iters=5)
        tot["ms"] += ms
        tot["plain_ms"] += cuda_ms(lambda: ci.conv_int8_plain(x, a_s, wq, scale, bias, **kw),
                                   iters=1, warmup=1)
        _, _, _, _, bytes_ms, ops_ms = conv_int8_bound(x, wq, bias, kw)
        tot["bytes_ms"] += bytes_ms
        tot["ops_ms"] += ops_ms
        part = "depthwise" if kw.get("groups", 1) != 1 else "dense"
        tot[f"{part}_ms"] += ms
        tot[f"{part}_bound_ms"] += max(bytes_ms, ops_ms)
        stride = kw.get("stride", 1)
        xb, wb = x.to(torch.bfloat16), wq.to(torch.bfloat16)
        tot["cudnn_bf16_ms"] += cuda_ms(lambda: F.conv2d(
            pad_same(xb, wq.shape[2:], stride if isinstance(stride, tuple) else (stride,) * 2),
            wb, None, stride, 0, 1, kw.get("groups", 1)), iters=5)
        if wq.shape[2:] == (1, 1) and kw.get("groups", 1) == 1:
            tot["n_1x1"] += 1
            xq = ci.quantize_plain(x, a_s).permute(0, 2, 3, 1).reshape(-1, x.shape[1]).contiguous()
            wt = wq[:, :, 0, 0].t().contiguous()
            try:
                torch._int_mm(xq, wt)
            except RuntimeError:
                continue  # shapes cuBLASLt's int8 product refuses
            tot["n_intmm"] += 1
            tot["intmm_ms"] += cuda_ms(lambda: torch._int_mm(xq, wt), iters=5)
            tot["intmm_kernel_ms"] += ms
        tot["n"] += 1
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    return tot


def top_agreement(a, b) -> int:
    """Images whose top detection agrees (class equal, IoU >= .5)."""
    agree = 0
    for i in range(a.boxes.shape[0]):
        if not (a.valid[i][0] and b.valid[i][0]) or a.classes[i][0] != b.classes[i][0]:
            continue
        (y0, x0, y1, x1), (v0, u0, v1, u1) = a.boxes[i][0], b.boxes[i][0]
        inter = max(0.0, min(y1, v1) - max(y0, v0)) * max(0.0, min(x1, u1) - max(x0, u0))
        union = (y1 - y0) * (x1 - x0) + (v1 - v0) * (u1 - u0) - inter
        agree += bool(union > 0 and inter / union >= 0.5)
    return agree


def int8_export_phase(dev, vpath: str, work: str) -> dict:
    """Phase 22: the int8 conv kernel (22a), the int8 serve (22b), export and
    the artifact driver (22c), the inspector and eval's artifact mode (22d)."""
    import torch
    import torch.nn.functional as F
    from pathlib import Path
    from mladversarialobjectdetection_torch.data.create_coco_tfrecord import (
        make_example, write_records)
    from mladversarialobjectdetection_torch.inference import drivers
    from mladversarialobjectdetection_torch.inference import quantize as pquant
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    from mladversarialobjectdetection_torch.ops import library, mbconv_cuda, nms_cuda
    from mladversarialobjectdetection_torch.train import eval as peval

    # 22a: the kernel against its plain version on odd shapes
    g = torch.Generator().manual_seed(22)
    for name, b, c, h, w, co, k, s, pad, dw, has_bias, od in CONV_INT8_ODD:
        dtype = getattr(torch, od)
        x = (torch.randn((b, c, h, w), generator=g) * 3).to(dev, dtype)
        wq = torch.randint(-127, 128, (co, 1 if dw else c, k, k), generator=g,
                           dtype=torch.int8).to(dev)
        a_s = ci.activation_scale(float(x.float().abs().max()))
        scale = torch.from_numpy(ci.dequant_scale(
            a_s, (torch.rand(co, generator=g) * 0.01 + 1e-3).numpy())).to(dev)
        bias = torch.randn(co, generator=g).to(dev) if has_bias else None
        check_conv_int8(f"phase 22a {name}", x, a_s, wq, scale, bias,
                        dict(stride=s, padding=pad, groups=c if dw else 1, out_dtype=dtype))
    a8 = torch.full((1, 64, 2, 2), 100, dtype=torch.int8, device=dev)
    w8 = torch.full((1, 64, 1, 1), 100, dtype=torch.int8, device=dev)
    try:
        r = F.conv2d(a8, w8)
        torch.cuda.synchronize()
        fconv = f"returns {r.dtype} {r.flatten()[:2].tolist()} where the sum is 640000"
    except Exception as e:  # a record of what PyTorch does, not a route
        fconv = f"raises {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    print(f"phase 22a conv_int8 kernel vs plain: {len(CONV_INT8_ODD)} odd shapes "
          f"({', '.join(c[0] for c in CONV_INT8_ODD)}): int32 sums and outputs "
          f"bit-equal, two launches bit-equal; F.conv2d on int8 CUDA tensors {fconv}")

    # 22b: the int8 serve at lite4@640, fp32 and bf16
    rng = np.random.default_rng(2222)
    calib = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
             for _ in range(INT8_CALIB_FRAMES)]
    frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(8)]
    batches = {1: frames[:1], 8: frames}
    dets, out = {}, {"serve": {}}
    for label, params in (("fp32", None), ("bf16", {"mixed_precision": True})):
        det = Detector("efficientdet-lite4", params=params, seed=0, device=dev)
        det.serve(frames[:1])
        t0 = time.perf_counter()
        det.quantize_int8(calib)
        calib_s = time.perf_counter() - t0
        dets[label] = det
        int8 = det._int8
        eligible = pquant.eligible_convs(det.net)
        shared = [p for p in eligible if p.startswith(("class_net/", "box_net/"))]
        levels = det.spec.max_level - det.spec.min_level + 1
        calls = len(eligible) + (levels - 1) * len(shared)
        if set(int8.qkernels) != set(eligible) or any("predict" in p for p in int8.qkernels):
            fail(f"phase 22b {label}: {len(int8.qkernels)} quantised convs of "
                 f"{len(eligible)} eligible")
        det.serve(frames[:1])  # warm-up of the int8 route
        torch.cuda.synchronize()
        reset_path_counts()
        ci.reset_counts()
        with Capture([(ci, "conv_int8_cuda")]) as cap:
            res = {b: det.serve(batch) for b, batch in batches.items()}
        torch.cuda.synchronize()
        counts = path_counts()
        want = dict.fromkeys(counts, 0)
        want["nms"] = len(batches)
        if counts != want or ci.CALLS != len(batches) * calls or ci.LAUNCHES != 2 * ci.CALLS:
            fail(f"phase 22b {label}: launches {counts} (want {want}), conv_int8 "
                 f"{ci.LAUNCHES} launches in {ci.CALLS} calls (want {len(batches) * calls} "
                 f"calls)")
        launches = ci.LAUNCHES
        with PlainInt8():
            ci.reset_counts()
            plain = det.serve(frames)
            if ci.LAUNCHES:
                fail(f"phase 22b {label}: the plain route launched the kernel")
        same_detections(f"phase 22b {label} int8 kernel vs plain route", res[8], plain)
        det._int8 = None
        fl = det.serve(frames)
        det._int8 = int8
        score_diff = float(np.abs(fl.scores - res[8].scores).max())
        agree = top_agreement(res[8], fl)
        print(f"phase 22b int8 serve {label} (lite4@640, {len(int8.qkernels)} quantised "
              f"convs of {len(eligible)} eligible, {len(shared)} head convs shared by "
              f"{levels} levels: {calls} conv calls a serve; calibration on "
              f"{INT8_CALIB_FRAMES} frames {calib_s:.2f} s): in b1 + b8 conv_int8 "
              f"{launches} launches ({launches // len(batches)} a serve, two a call), NMS "
              f"{counts['nms']}, fused MBConv 0; b8 detections equal to the plain int8 "
              f"route's (valid_len {res[8].valid_len.tolist()}); against the float "
              f"serve: largest score difference {score_diff:.4g}, top detection agrees "
              f"in {agree} of 8")
        out["serve"][label] = dict(calls=calls, launches=launches, score_diff=score_diff,
                                   agree=agree, n_quantised=len(int8.qkernels))
        out[f"calls_{label}"] = cap.args["conv_int8_cuda"][-calls:]
        del cap, res, plain, fl
    # p50s in one call: float and int8, fp32 and bf16, b1 and b8
    for label, det in dets.items():
        int8 = det._int8
        images, scales = det.preprocess(frames)
        images_d = torch.from_numpy(images).to(dev)
        scales_d = torch.from_numpy(scales).to(dev)
        for mode in ("float", "int8"):
            det._int8 = int8 if mode == "int8" else None
            for b, batch in batches.items():
                ms = host_p50_ms(lambda: det.serve(batch), iters=7)
                dms = host_p50_ms(lambda: det.serve_tensors(images_d[:b], scales_d[:b]),
                                  iters=10)
                out["serve"][f"{label} {mode} b{b}"] = (ms, dms)
                print(f"  serve {label} {mode} b{b}: p50 {ms:.3f} ms/batch "
                      f"({b * 1e3 / ms:.2f} images/s); device part (forward + "
                      f"postprocess) p50 {dms:.3f} ms")
            torch.cuda.reset_peak_memory_stats()
            det.serve_tensors(images_d, scales_d)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            print(f"  {label} {mode} b8 device part: peak memory {peak:.3f} GB")
            profile_device(lambda: det.serve_tensors(images_d, scales_d),
                           f"{label} {mode} device part b8")
        det._int8 = int8
        del images_d, scales_d
    # 22a continued: the kernel at every conv call of a b8 serve
    for label in ("fp32", "bf16"):
        tot = int8_numbers(out.pop(f"calls_{label}"))
        out[f"numbers_{label}"] = tot
        print(f"phase 22a conv_int8 at the {tot['n']} conv calls of a {label} b8 int8 "
              f"serve: every call's sums and output bit-equal to the plain version's; "
              f"{tot['ms']:.4f} ms in all (dense {tot['dense_ms']:.4f}, depthwise "
              f"{tot['depthwise_ms']:.4f}), bound {tot['bound_ms']:.6f} ms "
              f"({tot['bound_by']}: bytes {tot['bytes_ms']:.6f}, int8 operations "
              f"{tot['ops_ms']:.6f}; dense {tot['dense_bound_ms']:.6f}, depthwise "
              f"{tot['depthwise_bound_ms']:.6f}), plain {tot['plain_ms']:.4f} ms, "
              f"cuDNN bf16 convs of the same shapes {tot['cudnn_bf16_ms']:.4f} ms; the "
              f"{tot['n_1x1']} 1x1 convs: torch._int_mm {tot['intmm_ms']:.4f} ms on "
              f"{tot['n_intmm']} of them against the kernel's {tot['intmm_kernel_ms']:.4f}")

    # 22c: export, fp32 and bf16, and the artifact driver
    for label, det in dets.items():
        int8 = det._int8
        path = str(Path(work) / f"lite4_{label}.pt2")
        t0 = time.perf_counter()
        det.export(path, batch_size=1)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        drv = drivers.ExportedProgramDriver(path, "efficientdet-lite4",
                                            {"mixed_precision": label == "bf16"}, device=dev)
        load_s = time.perf_counter() - t0
        ops = library.op_counts(drv.program.graph)
        if ops != {"batched_nms": 1, "mbconv_fwd": MBCONV_PER_PASS}:
            fail(f"phase 22c {label}: the exported graph holds {ops}")
        drv.serve(frames[:1])
        det._int8 = None
        try:
            ref = det.serve(frames[:1])
            reset_path_counts()
            got = drv.serve(frames[:1])
            torch.cuda.synchronize()
            counts = path_counts()
            key = "mbconv_fp32" if label == "fp32" else "mbconv_fwd_bf16"
            if counts["nms"] != 1 or counts[key] != MBCONV_PER_PASS:
                fail(f"phase 22c {label}: the program launched {counts}")
            same_detections(f"phase 22c {label} driver vs Detector.serve", got, ref)
            live_ms = host_p50_ms(lambda: det.serve(frames[:1]), iters=10)
            drv_ms = host_p50_ms(lambda: drv.serve(frames[:1]), iters=10)
        finally:
            det._int8 = int8
        out[f"export_{label}"] = dict(export_s=export_s, load_s=load_s, live_ms=live_ms,
                                      drv_ms=drv_ms, mb=Path(path).stat().st_size / 1e6)
        print(f"phase 22c export {label} (lite4@640 b1, after quantize_int8: the float "
              f"program): torch.export + save {export_s:.2f} s ({out[f'export_{label}']['mb']:.1f} "
              f"MB), load {load_s:.2f} s; graph holds {ops}; the driver launched NMS 1 and "
              f"{MBCONV_PER_PASS} fused forward, detections equal to Detector.serve "
              f"(valid_len {got.valid_len.tolist()}); p50 b1 driver {drv_ms:.3f} ms, "
              f"Detector.serve {live_ms:.3f} ms")
        Path(path).unlink()
        del drv
    del dets, det
    torch.cuda.empty_cache()

    # 22d: the inspector's benchmark and dry modes, and eval's artifact mode
    for argv in (["--mode", "benchmark", "--batch-size", "8"],
                 ["--mode", "dry", "--export-ckpt", str(Path(work) / "dry")]):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mladversarialobjectdetection_torch.inference.inspector",
             "--model", "efficientdet-lite4", *argv], capture_output=True, text=True,
            timeout=600, cwd=str(Path(__file__).resolve().parent))
        if proc.returncode != 0:
            fail(f"phase 22d inspector {argv[1]}: exit {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        print(f"phase 22d inspector --mode {argv[1]} ({time.perf_counter() - t0:.1f} s): "
              f"{lines[-1] if lines else '(no output)'}")
    dry = Detector("efficientdet-lite4", ckpt_path=str(Path(work) / "dry"), device=dev)
    same_detections("phase 22d dry checkpoint", dry.serve(frames[:2]),
                    Detector("efficientdet-lite4", seed=0, device=dev).serve(frames[:2]))
    print(f"phase 22d dry checkpoint ({Path(work, 'dry.pkl').stat().st_size / 1e6:.1f} MB) "
          f"serves as the seeded detector")
    del dry
    # NMS at score 0 (the demos' setting): every image's top box is valid,
    # whatever the 12-step victim's scores, and is the image's ground truth
    hp = {"mixed_precision": True, "nms_configs": {"score_thresh": 0.0}}
    live_det = Detector("efficientdet-lite4", params=hp, ckpt_path=vpath,
                        post_mode="per_class", device=dev)
    scenes = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
              for _ in range(EVAL_ARTIFACT_BATCHES * 8)]
    top = live_det.serve(scenes)
    recs = []
    for i, img in enumerate(scenes):
        h, w = img.shape[:2]
        box = top.boxes[i][:1] / np.asarray([h, w, h, w], np.float32)
        cls = int(top.classes[i][0])
        recs.append(make_example(stdlib_png(img), h, w, np.clip(box, 0, 1), [cls], [0],
                                 str(i)))
    val = str(Path(work) / "val.tfrecord")
    write_records(recs, val)
    artifact = str(Path(work) / "victim.pt2")
    live_det.export(artifact, batch_size=8)
    kw = dict(ckpt=vpath, batch_size=8, hparams=hp, score_thresh=0.0, device=dev)
    with StdlibPngDecode():
        live = peval.evaluate("efficientdet-lite4", val, **kw)
        arte = peval.evaluate("efficientdet-lite4", val, artifact=artifact, **kw)
    diff = max(abs(live[k] - arte[k]) for k in live)
    if set(live) != set(arte) or not diff <= 1e-6 or not live["AP50"] > 0:
        fail(f"phase 22d: eval of the exported victim {arte} vs the live victim {live} "
             f"(a top box that is its own ground truth must match)")
    print(f"phase 22d eval --artifact (phase 16's bf16 victim exported per_class at b8, "
          f"NMS at score 0, {len(scenes)} 480x640 scenes whose ground truth is the "
          f"victim's top box): "
          f"AP {arte['AP']:.6f} AP50 {arte['AP50']:.6f}, all {len(live)} metrics within "
          f"{diff:.3g} of the live victim's")
    del live_det
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import tempfile
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from mladversarialobjectdetection_torch import _build
    from mladversarialobjectdetection_torch import config as config_lib
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.attack.train import (
        attack_state_arrays, get_victim, train)
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.ops import eot, nms, nms_cuda, postprocess
    from mladversarialobjectdetection_torch.ops import warp_cuda
    from mladversarialobjectdetection_torch.ops import cmconv, cmconv_cuda
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
    from mladversarialobjectdetection_torch.defense.train import defender_state_arrays
    from mladversarialobjectdetection_torch.defense.train import train as defense_train
    from mladversarialobjectdetection_torch.models.efficientnet import MBConvBlock
    from mladversarialobjectdetection_torch.ops import mbconv, mbconv_cuda, preprocess
    from mladversarialobjectdetection_torch.ckpt import bridge
    from mladversarialobjectdetection_torch.ckpt.io import save_pytree
    from mladversarialobjectdetection_torch.data.pipeline import ScenePool

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
    print_ptxas(libs)

    # phase 1a: the fused MBConv kernels vs plain on odd shapes
    mb_errs = {"fwd": 0.0, "dx": 0.0}
    for i, (name, b, h, w, c, e, co, k, res, act) in enumerate(MBCONV_ODD):
        x, fb = mbconv_case(dev, b, h, w, c, e, co, k, seed=10 + i)
        g = torch.randn((b, h, w, co), device=dev,
                        generator=torch.Generator(dev).manual_seed(i))
        errs = check_mbconv(name, x, g, fb, act, res)
        mb_errs = {"fwd": max(mb_errs["fwd"], errs[0]), "dx": max(mb_errs["dx"], errs[1])}
        pf = mbconv_cuda.plan_fwd(h, w, c, e, co, k, b)
        pd = mbconv_cuda.plan_dx(h, w, c, e, co, k, b)
        print(f"  mbconv {name} (b{b} {h}x{w}, C {c}, E {e}, Co {co}, k{k}, "
              f"{act}{', residual' if res else ''}): max errors fwd {errs[0]:.3g}, "
              f"dx {errs[1]:.3g} (mask flips z0 {errs[2][0]}, z1 {errs[2][1]}, at most "
              f"{errs[2][2]:.3g} of scale from the kink), two launches bit-equal; "
              f"plans fwd {pf.th}x{pf.tw} npw {pf.npw} split {pf.split} slice "
              f"{pf.n_per_slice}, dx {pd.th}x{pd.tw} npw {pd.npw} split {pd.split} "
              f"slice {pd.n_per_slice}")
    print(f"phase 1a mbconv kernels vs plain: {len(MBCONV_ODD)} shapes, max "
          f"errors {mb_errs}")
    # and their bf16 instances against the bf16 plain versions
    mb16_errs = {"fwd": 0.0, "dx": 0.0}
    for i, (name, b, h, w, c, e, co, k, res, act) in enumerate(MBCONV_ODD):
        x, fb = mbconv_case(dev, b, h, w, c, e, co, k, seed=10 + i)
        g = torch.randn((b, h, w, co), device=dev,
                        generator=torch.Generator(dev).manual_seed(i))
        errs = check_mbconv(f"bf16 {name}", x.bfloat16(), g.bfloat16(),
                            fb.in_dtype(torch.bfloat16), act, res)
        mb16_errs = {"fwd": max(mb16_errs["fwd"], errs[0]),
                     "dx": max(mb16_errs["dx"], errs[1])}
        pf = mbconv_cuda.plan_fwd(h, w, c, e, co, k, b, dtype=torch.bfloat16)
        pd = mbconv_cuda.plan_dx(h, w, c, e, co, k, b, dtype=torch.bfloat16)
        print(f"  mbconv bf16 {name}: max errors fwd {errs[0]:.3g}, dx {errs[1]:.3g} "
              f"(mask flips z0 {errs[2][0]}, z1 {errs[2][1]}, at most {errs[2][2]:.3g} "
              f"of scale from the kink; forward outputs off the plain version's "
              f"{errs[3].flips}, none beyond the roundings of e ({errs[3].e_near} near "
              f"a bf16 boundary) and d ({errs[3].d_near}); {errs[3].y_open} of "
              f"{b * h * w * co} outputs may take more than one bf16 value), "
              f"two launches bit-equal; plans fwd {pf.th}x{pf.tw} npw {pf.npw} split "
              f"{pf.split}, dx {pd.th}x{pd.tw} npw {pd.npw} split {pd.split}")
    print(f"phase 1a mbconv bf16 instances vs bf16 plain: {len(MBCONV_ODD)} shapes, "
          f"max errors {mb16_errs} (limits {MBCONV_BF16_FWD_TOL} and "
          f"{MBCONV_BF16_DX_TOL} of scale)")
    del x, g, fb

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
    div_pairs = 1 << 36
    div_bad = [nms_cuda.division_mismatches(div_pairs, r, dev) for r in (0, 1)]
    if any(div_bad):
        fail(f"the NMS kernel's fast division differs from div.rn: {div_bad}")
    print(f"phase 2 kernel vs plain: {n_cases} cases exact, "
          f"max score error {max_err}; fast division equal to div.rn on "
          f"{div_pairs} pairs of each of its two ranges")

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
    mbconv_cuda.reset_counts()
    copies0 = mbconv.LAYOUT_COPIES
    with UnfusedRoute() as unfused:
        results = {b: det.serve(batch) for b, batch in batches.items()}
    launches = nms_cuda.LAUNCHES
    serve_mb = dict(mbconv_cuda.LAUNCHES)
    if launches != len(batches):
        fail(f"NMS kernel launched {launches} times in {len(batches)} serve calls")
    check_fused_route("serve", serve_mb, unfused, len(batches) * MBCONV_PER_PASS, 0,
                      passes=len(batches))
    if sum(warp_cuda.LAUNCHES.values()):
        fail("a warp kernel launched while serving")
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
    print(f"phase 3 serve: NMS kernel launches {launches}, fused MBConv "
          f"launches {serve_mb}, NHWC layout copies "
          f"{mbconv.LAYOUT_COPIES - copies0}, in "
          f"{len(batches)} serve calls; valid_len b1 "
          f"{results[1].valid_len.tolist()} b8 {results[8].valid_len.tolist()}")

    images, scales = det.preprocess(frames)
    images_d = torch.from_numpy(images).to(dev)
    scales_d = torch.from_numpy(scales).to(dev)
    with torch.no_grad():
        cls_out, box_out = det.net(images_d)
        cand_boxes, cand_scores, _ = postprocess._pre_nms_select(
            det._params_dict, cls_out, box_out)
    cand_boxes, cand_scores = cand_boxes.contiguous(), cand_scores.contiguous()
    kw = postprocess.nms_kwargs_from_config(det.config.nms_configs)

    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for b, batch in batches.items():
            serve_ms = host_p50_ms(lambda: det.serve(batch), iters=10)
            dev_ms = host_p50_ms(lambda: det.serve_tensors(
                images_d[:b], scales_d[:b]), iters=10)
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
    *_, err = nms_numbers(cand_boxes, cand_scores, kw, "served candidates")
    max_err = max(max_err, err)

    # phase 3a: the other post modes, approximate top-k, device
    # preprocessing, several streams and the pipelined server, at batch 8
    params = det._params_dict
    approx = dict(params, nms_configs=dict(params["nms_configs"],
                                           pre_nms_approx_topk=True))
    modes = {"per_class": lambda p: postprocess.postprocess_per_class(
                 p, cls_out, box_out, image_scales=scales_d),
             "combined": lambda p: postprocess.postprocess_combined(
                 p, cls_out, box_out, image_scales=scales_d),
             "tflite": lambda p: postprocess.postprocess_tflite(p, cls_out, box_out),
             "global approx top-k": lambda p: postprocess.postprocess_global(
                 approx, cls_out, box_out, image_scales=scales_d)}
    with torch.no_grad():
        for mode, post in modes.items():
            nms_cuda.LAUNCHES = 0
            kern = post(params)
            if nms_cuda.LAUNCHES != 1:
                fail(f"post mode {mode}: {nms_cuda.LAUNCHES} NMS kernel launches")
            with PlainNMS():
                plain = post(params)
            err = same_detections(f"post mode {mode}", kern, plain, exact_scores=False)
            max_err = max(max_err, err)
            print(f"  post mode {mode} b8: valid_len {kern.valid_len.tolist()}, "
                  f"equal to the plain NMS's (score error {err})")
        exact = postprocess.postprocess_global(params, cls_out, box_out,
                                               image_scales=scales_d)
        same_detections("approximate top-k", modes["global approx top-k"](params), exact)
    for mode in ("per_class", "combined", "tflite"):
        det.post_mode = mode
        res = det.serve(frames)
        if res.boxes.shape != (8, m, 4) or not np.all(np.isfinite(res.boxes)):
            fail(f"serve post_mode {mode}: boxes {res.boxes.shape}")
        print(f"  serve post_mode {mode} b8: p50 "
              f"{host_p50_ms(lambda: det.serve(frames), iters=3, warmup=1):.3f} ms")
    det.post_mode = "global"
    raw_d = torch.from_numpy(np.stack(frames)).to(dev)
    dev_images, dev_scales = preprocess.preprocess_device(
        raw_d, det.config.image_size, det.config.mean_rgb, det.config.stddev_rgb)
    pre_err = float((dev_images - images_d).abs().max())
    if not pre_err <= 1e-4 or not torch.equal(dev_scales, scales_d):
        fail(f"preprocess_device differs from the host path by {pre_err}")
    mbconv_cuda.reset_counts()
    res = det.serve(frames, device_preprocess=True)
    if mbconv_cuda.LAUNCHES["mbconv_fwd"] != MBCONV_PER_PASS or \
            res.boxes.shape != (8, m, 4) or not np.all(res.valid_len > 0):
        fail(f"serve(device_preprocess=True): {mbconv_cuda.LAUNCHES}, "
             f"valid_len {res.valid_len}")
    for b, batch in batches.items():
        ms = host_p50_ms(lambda: det.serve(batch, device_preprocess=True), iters=10)
        print(f"  serve b{b} device_preprocess=True: p50 {ms:.3f} ms/batch "
              f"({b * 1e3 / ms:.2f} images/s)")
    print(f"  preprocess_device vs host: max difference {pre_err:.3g} (normalized "
          f"units); detections with device preprocessing: valid_len "
          f"{res.valid_len.tolist()} (host {results[8].valid_len.tolist()})")
    sources = [frames[0:3], frames[3:5], frames[5:6]]
    ticks = list(det.serve_streams([InMemorySource(f) for f in sources]))
    for t, tick in enumerate(ticks):
        alive = [i for i in range(3) if t < len(sources[i])]
        if [i for i, r in enumerate(tick) if r is not None] != alive:
            fail(f"serve_streams tick {t}: {[r is None for r in tick]}")
        batch = [sources[i][t] if i in alive else sources[0][0] for i in range(3)]
        ref = det.serve(batch)
        for i in alive:
            same_detections(f"serve_streams tick {t} source {i}", tick[i],
                            [a[i] for a in ref])
    stream_frames = frames + frames[:4]  # 12 frames: batches of 8 and 4 + 4 pads
    for device_pre in (False, True):
        out = list(det.serve_pipelined(iter(stream_frames), batch_size=8,
                                       device_preprocess=device_pre))
        if len(out) != len(stream_frames):
            fail(f"serve_pipelined yielded {len(out)} of {len(stream_frames)}")
        for start in (0, 8):
            part = stream_frames[start:start + 8]
            ref = det.serve(part + [part[-1]] * (8 - len(part)),
                            device_preprocess=device_pre)
            for i in range(len(part)):
                same_detections(f"serve_pipelined frame {start + i}", out[start + i],
                                [a[i] for a in ref])
        ms = host_p50_ms(lambda: list(det.serve_pipelined(
            iter(stream_frames), batch_size=8, device_preprocess=device_pre)), iters=3)
        print(f"  serve_pipelined b8 device_preprocess={device_pre}: "
              f"{len(stream_frames)} frames in {ms:.3f} ms p50")
    print(f"phase 3a serving: post modes per_class, combined, tflite and "
          f"approximate top-k equal to the plain NMS's; device preprocessing "
          f"within {pre_err:.3g}; serve_streams over {len(ticks)} ticks and "
          f"serve_pipelined equal to serve of the same batches")
    del det, images_d, scales_d, cls_out, box_out, raw_d, dev_images

    # phase 3b: a bf16 serve (config.mixed_precision, as the JAX Detector
    # serves it), lite4@640 at b1 / b8
    bdet = Detector("efficientdet-lite4", params={"mixed_precision": True}, seed=0,
                    device="cuda")
    bdet.serve(frames[:1])
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    mbconv_cuda.reset_counts()
    with UnfusedRoute() as unfused:
        bresults = {b: bdet.serve(batch) for b, batch in batches.items()}
    serve_dtypes = {k: dict(v) for k, v in mbconv_cuda.DTYPE_LAUNCHES.items()}
    if nms_cuda.LAUNCHES != len(batches):
        fail(f"bf16 serve: NMS kernel launched {nms_cuda.LAUNCHES} times")
    check_fused_route("bf16 serve", dict(mbconv_cuda.LAUNCHES), unfused,
                      len(batches) * MBCONV_PER_PASS, 0, passes=len(batches))
    if serve_dtypes["bfloat16"]["mbconv_fwd"] != len(batches) * MBCONV_PER_PASS:
        fail(f"bf16 serve ran a float32 instance: {serve_dtypes}")
    for b, res in bresults.items():
        if res.boxes.shape != (b, m, 4) or not all(
                np.all(np.isfinite(getattr(res, f))) for f in res._fields) or not (
                np.array_equal(res.valid.sum(1), res.valid_len)):
            fail(f"bf16 serve b{b}: {res.boxes.shape}, valid_len {res.valid_len}")
    for b, batch in batches.items():
        ms = host_p50_ms(lambda: bdet.serve(batch), iters=10)
        dms = host_p50_ms(lambda: bdet.serve(batch, device_preprocess=True), iters=10)
        print(f"  bf16 serve b{b}: p50 {ms:.3f} ms/batch ({b * 1e3 / ms:.2f} images/s); "
              f"device_preprocess=True {dms:.3f} ms/batch; valid_len "
              f"{bresults[b].valid_len.tolist()} (fp32 {results[b].valid_len.tolist()})")
    profile_device(lambda: bdet.serve(frames, device_preprocess=True), "bf16 serve b8")
    print(f"phase 3b bf16 serve: fused MBConv launches per dtype in {len(batches)} "
          f"serve calls {serve_dtypes}, NMS once per serve")
    del bdet, bresults


    # phase 4: warp kernels vs plain on the card
    warp_errs = dict.fromkeys(WARP_KERNELS, 0.0)
    n_cases = 0
    for name, w, canvases, table in warp_cases(rng):
        errs, zero = check_warp(name, canvases, table, w)
        if name == "wholly outside" and not zero:
            fail("a window wholly outside the canvas support sampled non-zero")
        warp_errs = {k: max(warp_errs[k], errs[k]) for k in WARP_KERNELS}
        n_cases += 1
        print(f"  warp {name}: {table.shape[0]} windows, p0 {canvases.shape[1]}, "
              f"w {w}: max errors " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    print(f"phase 4 warp kernels vs plain: {n_cases} cases within {WARP_TOL} "
          f"of scale, two launches bit-equal; max errors {warp_errs}")

    # phase 5: the attack step, lite4@640, b24, fp32, live regime
    t0 = time.perf_counter()
    cfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    cfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5,
                            "pre_nms_topk": 256})
    atk = PatchAttacker(cfg, get_victim(cfg, seed=0, device=dev),
                        window=ATTACK_WINDOW, device=dev)
    state = atk.init_state(1)
    images = torch.rand((ATTACK_BATCH, *atk.image_hw, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(2)) * 2 - 1
    boxes, valid = make_live_slot_boxes(ATTACK_BATCH, atk.image_hw, atk.max_boxes)
    override = (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))
    n_windows = int(valid.sum())
    step = lambda asr=False: atk.train_step(state, images, with_asr=asr,
                                            boxes_override=override)
    step()  # warm-up outside the counted run
    torch.cuda.synchronize()
    print(f"  attacker efficientdet-lite4 {atk.image_hw}, batch {ATTACK_BATCH}, "
          f"window {ATTACK_WINDOW}, {n_windows} live windows (batch max "
          f"{int(valid.sum(1).max())}), built and warmed up in "
          f"{time.perf_counter() - t0:.2f} s")
    patch0 = state.patch.detach().clone()
    torch.cuda.reset_peak_memory_stats(dev)
    nms_cuda.LAUNCHES = 0
    warp_cuda.reset_counts()
    mbconv_cuda.reset_counts()
    copies0 = mbconv.LAYOUT_COPIES
    with UnfusedRoute() as unfused:
        for _ in range(ATTACK_STEPS):
            _, metrics = step()
    torch.cuda.synchronize()
    attack_launches = dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES)
    attack_mb = dict(mbconv_cuda.LAUNCHES)
    attack_copies = mbconv.LAYOUT_COPIES - copies0
    windows_seen = warp_cuda.WINDOWS
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if attack_launches != dict.fromkeys(attack_launches, ATTACK_STEPS):
        fail(f"{ATTACK_STEPS} attack steps launched {attack_launches}; want "
             f"one launch of each kernel per step")
    if windows_seen != ATTACK_STEPS * n_windows:
        fail(f"the warp saw {windows_seen} windows in {ATTACK_STEPS} steps, "
             f"want {ATTACK_STEPS * n_windows}")
    # two victim passes a step (the no-grad first pass and the patched one)
    # and the patched pass's input gradient
    check_fused_route("attack step", attack_mb, unfused,
                      2 * MBCONV_PER_PASS * ATTACK_STEPS,
                      MBCONV_PER_PASS * ATTACK_STEPS, passes=2 * ATTACK_STEPS)
    patch = state.patch.detach()
    scale = float(state.scale.detach())
    if not np.isfinite(float(metrics.loss)):
        fail(f"attack loss {float(metrics.loss)}")
    if torch.equal(patch, patch0) or float(patch.abs().max()) > 1.0:
        fail("the patch did not move, or left [-1, 1]")
    if not 0.0 <= scale <= 1.0:
        fail(f"scale {scale} outside [0, 1]")
    nms_cuda.LAUNCHES = 0
    _, m_asr = step(asr=True)
    torch.cuda.synchronize()
    if nms_cuda.LAUNCHES != 2:
        fail(f"a step with the ASR pass launched NMS {nms_cuda.LAUNCHES} times")
    print(f"phase 5 attack step: launches in {ATTACK_STEPS} steps "
          f"{attack_launches}, fused MBConv {attack_mb}, NHWC layout copies "
          f"{attack_copies}, {windows_seen} windows warped; loss "
          f"{float(metrics.loss):.6f}, scale {scale:.6f}, asr with the ASR "
          f"pass {float(m_asr.asr):.4f}; peak memory {peak_gb:.3f} GB")
    step_ms = host_p50_ms(step, iters=5, warmup=1)
    print(f"  attack step b{ATTACK_BATCH} p50 {step_ms:.3f} ms "
          f"({ATTACK_BATCH * 1e3 / step_ms:.2f} images/s)")
    profile_device(step, f"attack step b{ATTACK_BATCH}", top=10)

    # phase 5a: the fused victim against the unfused one, on one attack
    # loss with fixed draws (the step's boxes, a fresh seeded generator)
    fused_vs_unfused("phase 5a fused vs unfused victim", atk, state, images, override,
                     VICTIM_TOL, VICTIM_COS, VICTIM_GRAD_COS)

    # phase 6: each kernel on the inputs a step gave it
    with Capture([(warp_cuda, k) for k in WARP_KERNELS]
                 + [(nms_cuda, "batched_nms_cuda"),
                    (mbconv_cuda, "mbconv_fwd_cuda"),
                    (mbconv_cuda, "mbconv_dx_cuda")]) as cap:
        step()
    torch.cuda.synchronize()
    torch.set_grad_enabled(False)  # the comparisons and timings build no graph
    (canvases, table, w), _ = cap.args["pass1_fwd"][0]
    (t_in, _), _ = cap.args["pass2_fwd"][0]
    (g_in, _, p0), _ = cap.args["pass2_bwd"][0]
    (dt_in, _, n_img), _ = cap.args["pass1_bwd"][0]
    errs, _ = check_warp("step inputs", canvases, table, w, g=g_in)
    warp_errs = {k: max(warp_errs[k], errs[k]) for k in WARP_KERNELS}
    taps = warp_taps(table, n_img, p0, w)
    bounds = warp_bounds(n_img, table.shape[0], p0, w, taps)
    calls = {
        "pass1_fwd": (lambda: warp_cuda.pass1_fwd(canvases, table, w),
                      lambda: eot.pass1_fwd(canvases, table, w)),
        "pass2_fwd": (lambda: warp_cuda.pass2_fwd(t_in, table),
                      lambda: eot.pass2_fwd(t_in, table)),
        "pass2_bwd": (lambda: warp_cuda.pass2_bwd(g_in, table, p0),
                      lambda: eot.pass2_bwd(g_in, table, p0)),
        "pass1_bwd": (lambda: warp_cuda.pass1_bwd(dt_in, table, n_img),
                      lambda: eot.pass1_bwd(dt_in, table, n_img)),
    }
    warp_times = {}
    for k, (kern_fn, plain_fn) in calls.items():
        kern_ms = kernel_device_ms(kern_fn, f"{k}_kernel")
        wrapper_ms = cuda_ms(kern_fn, iters=20)
        plain_ms = cuda_ms(plain_fn, iters=3, warmup=1)
        bound_ms, bound_by, nbytes, ops = bounds[k]
        warp_times[k] = (kern_ms, plain_ms, bound_ms, bound_by)
        print(f"  warp {k} at the step's {table.shape[0]} windows (p0 {p0}, w "
              f"{w}, {n_img} canvases): kernel {kern_ms:.4f} ms on the card "
              f"(wrapper with its host checks {wrapper_ms:.4f} ms per call), "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
              f"{nbytes} B, {ops} fp32 ops), {bound_ms / kern_ms:.1%} of the "
              f"bound; {attack_launches[k] // ATTACK_STEPS} launch per step")
    print(f"phase 6 warp kernels at the step's inputs: {int((table[:, 6] == 1).sum())} "
          f"of {table.shape[0]} windows at r = 1 (the kernels' instance without the "
          f"hat's division); non-zero taps pass 1 {taps[0]}, pass 2 {taps[1]}; input "
          f"positions a non-zero tap reads {taps[2]}; max errors {warp_errs}")
    (nms_boxes, nms_scores), nms_kw = cap.args["batched_nms_cuda"][0]
    nms_ms, nms_plain_ms, nms_bound_ms, nms_bound_by, err = nms_numbers(
        nms_boxes, nms_scores, nms_kw, "attack first pass")
    max_err = max(max_err, err)

    # phase 6a: the fused MBConv kernels on the inputs the step gave them
    mb_tot, mb_errs = mbconv_step_numbers("phase 6a", atk, cap, mb_errs)
    del cap, canvases, t_in, g_in, dt_in, atk, state, images, patch, patch0
    torch.set_grad_enabled(True)

    # phase 7: the driver entry point, 3 steps at batch 12; a score threshold
    # below the random victim's scores (about 0.01) gives it live slots
    with tempfile.TemporaryDirectory() as tmp:
        nms_cuda.LAUNCHES = 0
        warp_cuda.reset_counts()
        mbconv_cuda.reset_counts()
        t0 = time.perf_counter()
        final = train("efficientdet-lite4", synthetic=True, mixed_precision=False,
                      batch_size=12, epochs=1, steps_per_epoch=3,
                      visualize_freq=0, save_dir=tmp, device=dev,
                      config_override={"nms_configs": {"score_thresh": 0.0099}})
        torch.cuda.synchronize()
        driver_s = time.perf_counter() - t0
        driver_launches = dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES,
                               **mbconv_cuda.LAUNCHES)
        logs = Path(tmp) / "logs" / "metrics.jsonl"
        records = [json.loads(line) for line in logs.read_text().splitlines()]
        dirs = sorted(p.name for p in Path(tmp).glob("patch_00_*"))
        if final.step != 3 or not any("val/loss" in r for r in records):
            fail(f"driver: step {final.step}, log records {records}")
        if len(dirs) != 1 or not {"patch.npy", "scale.txt"} <= {
                p.name for p in (Path(tmp) / dirs[0]).iterdir()}:
            fail(f"driver: patch artifacts {dirs}")
        # each of the 3 train steps runs all four kernels; the 5 validation
        # batches run the forward passes where they find live slots
        if (driver_launches["pass1_bwd"] != 3 or driver_launches["pass2_bwd"] != 3
                or driver_launches["pass1_fwd"] < 3
                or driver_launches["mbconv_dx"] != 3 * MBCONV_PER_PASS
                or driver_launches["mbconv_fwd"] < 3 * 2 * MBCONV_PER_PASS):
            fail(f"driver: kernel launches {driver_launches}")
    print(f"phase 7 driver: train(efficientdet-lite4, batch 12, 3 steps) "
          f"in {driver_s:.2f} s, launches {driver_launches}, "
          f"{warp_cuda.WINDOWS} windows warped, artifacts {dirs}, "
          f"{len(records)} log records")

    # phase 5b: the bf16 attack step (config.mixed_precision, the JAX attack
    # driver's default and bench.py's attack workload): lite4@640, b24, the
    # live regime; bf16 victim, float32 patch, EOT composite, warp and loss
    t0 = time.perf_counter()
    bcfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    bcfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5,
                             "pre_nms_topk": 256})
    bcfg.mixed_precision = True
    batk = PatchAttacker(bcfg, get_victim(bcfg, seed=0, device=dev),
                         window=ATTACK_WINDOW, device=dev)
    bstate = batk.init_state(1)
    bimages = torch.rand((ATTACK_BATCH, *batk.image_hw, 3), device=dev,
                         generator=torch.Generator(dev).manual_seed(2)) * 2 - 1
    boxes, valid = make_live_slot_boxes(ATTACK_BATCH, batk.image_hw, batk.max_boxes)
    boverride = (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))
    bstep = lambda asr=False: batk.train_step(bstate, bimages, with_asr=asr,
                                              boxes_override=boverride)
    bstep()  # warm-up outside the counted run
    torch.cuda.synchronize()
    print(f"  bf16 attacker efficientdet-lite4 {batk.image_hw}, batch {ATTACK_BATCH}, "
          f"window {ATTACK_WINDOW}, {int(valid.sum())} live windows, built and warmed "
          f"up in {time.perf_counter() - t0:.2f} s")
    patch0 = bstate.patch.detach().clone()
    torch.cuda.reset_peak_memory_stats(dev)
    nms_cuda.LAUNCHES = 0
    warp_cuda.reset_counts()
    mbconv_cuda.reset_counts()
    with UnfusedRoute() as unfused:
        for _ in range(ATTACK_STEPS):
            _, bm = bstep()
    torch.cuda.synchronize()
    bf16_launches = dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES)
    bf16_mb = {k: dict(v) for k, v in mbconv_cuda.DTYPE_LAUNCHES.items()}
    bpeak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if bf16_launches != dict.fromkeys(bf16_launches, ATTACK_STEPS):
        fail(f"{ATTACK_STEPS} bf16 attack steps launched {bf16_launches}; want one "
             f"launch of each kernel per step")
    check_fused_route("bf16 attack step", dict(mbconv_cuda.LAUNCHES), unfused,
                      2 * MBCONV_PER_PASS * ATTACK_STEPS,
                      MBCONV_PER_PASS * ATTACK_STEPS, passes=2 * ATTACK_STEPS)
    want = {"bfloat16": {"mbconv_fwd": 2 * MBCONV_PER_PASS * ATTACK_STEPS,
                         "mbconv_dx": MBCONV_PER_PASS * ATTACK_STEPS},
            "float32": {"mbconv_fwd": 0, "mbconv_dx": 0}}
    if bf16_mb != want:
        fail(f"bf16 attack step: fused MBConv launches per dtype {bf16_mb}, want {want}")
    bpatch = bstate.patch.detach()
    if bpatch.dtype != torch.float32 or not np.isfinite(float(bm.loss)) or \
            not bool(torch.isfinite(bpatch).all()):
        fail(f"bf16 attack step: loss {float(bm.loss)}, patch {bpatch.dtype}")
    if torch.equal(bpatch, patch0) or float(bpatch.abs().max()) > 1.0 or \
            not 0.0 <= float(bstate.scale.detach()) <= 1.0:
        fail("bf16 attack step: the patch did not move, or a variable left its range")
    print(f"phase 5b bf16 attack step: launches in {ATTACK_STEPS} steps {bf16_launches}, "
          f"fused MBConv per dtype {bf16_mb}; loss {float(bm.loss):.6f}, scale "
          f"{float(bstate.scale.detach()):.6f}; peak memory {bpeak_gb:.3f} GB")
    bstep_ms = host_p50_ms(bstep, iters=5, warmup=1)
    print(f"  bf16 attack step b{ATTACK_BATCH} p50 {bstep_ms:.3f} ms "
          f"({ATTACK_BATCH * 1e3 / bstep_ms:.2f} images/s; fp32 in phase 5 "
          f"{step_ms:.3f} ms)")
    profile_device(bstep, f"bf16 attack step b{ATTACK_BATCH}", top=10)

    # phase 5a, bf16: the fused bf16 victim against the unfused bf16 one
    # (cuDNN's bf16 convs), which rounds after each conv, BN and activation
    # where the fused block rounds e once: logits within BF16_VICTIM_TOL
    # and both bf16 input gradients held to the float32 victim's
    cfg32 = copy.deepcopy(bcfg)
    cfg32.mixed_precision = False
    fused_vs_unfused("phase 5a bf16 fused vs unfused victim", batk, bstate, bimages,
                     boverride, BF16_VICTIM_TOL, BF16_VICTIM_COS, BF16_VICTIM_GRAD_COS,
                     ref_net=get_victim(cfg32, seed=0, device=dev),
                     ref_margin=BF16_VS_FP32_MARGIN)

    # phase 6a, bf16: the bf16 instances on the inputs the bf16 step gave them
    with Capture([(mbconv_cuda, "mbconv_fwd_cuda"),
                  (mbconv_cuda, "mbconv_dx_cuda")]) as cap:
        bstep()
    torch.cuda.synchronize()
    torch.set_grad_enabled(False)
    mb16_tot, mb16_errs = mbconv_step_numbers("phase 6a bf16", batk, cap, mb16_errs)
    torch.set_grad_enabled(True)
    del cap, batk, bstate, bimages, bpatch, patch0, bstep, bm, boverride
    torch.cuda.empty_cache()

    # phase 7b: the driver with its defaults (bf16), 3 steps at batch 12
    with tempfile.TemporaryDirectory() as tmp:
        nms_cuda.LAUNCHES = 0
        warp_cuda.reset_counts()
        mbconv_cuda.reset_counts()
        t0 = time.perf_counter()
        final = train("efficientdet-lite4", synthetic=True, batch_size=12, epochs=1,
                      steps_per_epoch=3, visualize_freq=0, save_dir=tmp, device=dev,
                      config_override={"nms_configs": {"score_thresh": 0.0099}})
        torch.cuda.synchronize()
        bdriver_s = time.perf_counter() - t0
        per_dtype = {k: dict(v) for k, v in mbconv_cuda.DTYPE_LAUNCHES.items()}
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "metrics.jsonl").read_text().splitlines()]
        dirs = sorted(p.name for p in Path(tmp).glob("patch_00_*"))
        if final.step != 3 or not any("val/loss" in r for r in records) or len(dirs) != 1:
            fail(f"bf16 driver: step {final.step}, artifacts {dirs}")
        if (sum(per_dtype["float32"].values())
                or per_dtype["bfloat16"]["mbconv_dx"] != 3 * MBCONV_PER_PASS
                or per_dtype["bfloat16"]["mbconv_fwd"] < 3 * 2 * MBCONV_PER_PASS
                or warp_cuda.LAUNCHES["pass1_bwd"] != 3):
            fail(f"bf16 driver: launches {per_dtype}, warp {warp_cuda.LAUNCHES}")
    print(f"phase 7b driver with its defaults (bf16): train(efficientdet-lite4, batch "
          f"12, 3 steps) in {bdriver_s:.2f} s, fused MBConv launches per dtype "
          f"{per_dtype}, warp {warp_cuda.LAUNCHES}, artifacts {dirs}")
    del final

    # phase 8: both cmconv instances and the plan's pick vs plain at the
    # path's shapes, full size
    torch.set_grad_enabled(False)
    cm_err = 0.0
    gen = torch.Generator(dev).manual_seed(5)
    for role, c, co, side in CMCONV_SHAPES:
        x = torch.randn((DEFEND_BATCH, c, side, side), device=dev, generator=gen)
        w = torch.randn((3, 3, c, co), device=dev, generator=gen) * 0.3
        bias = torch.randn((co,), device=dev, generator=gen) if role == "fwd" else None
        plain = cmconv.cmconv_plain(x, w, bias)
        errs = {}
        for inst in CMCONV_INSTANCES:
            kern = cmconv_cuda.cmconv3x3_instance(x, w, bias, inst)
            errs[inst] = kernel_err(f"cmconv {inst} {role} {c}->{co} at {side}", kern, plain)
            if not torch.equal(cmconv_cuda.cmconv3x3_instance(x, w, bias, inst), kern):
                fail(f"cmconv {inst} {role} {c}->{co} at {side}: two launches differ")
        pick = cmconv_cuda.plan(c, co, side, side).instance
        if not torch.equal(cmconv_cuda.cmconv3x3_cuda(x, w, bias),
                           cmconv_cuda.cmconv3x3_instance(x, w, bias, pick)):
            fail(f"cmconv {role} {c}->{co} at {side}: the wrapper did not run {pick}")
        cm_err = max(cm_err, *errs.values())
        print(f"  cmconv {role} {c}->{co} b{DEFEND_BATCH} {side}x{side}: max errors "
              f"{errs}, two launches bit-equal, plan {pick}")
    print(f"phase 8 cmconv instances vs plain: {len(CMCONV_SHAPES)} shapes within "
          f"{WARP_TOL} of scale, max error {cm_err}")
    # the bf16 instance at the bf16 step's shapes: bf16 x and bias, the
    # kernel's bf16 values in float32 (as the bf16 U-Net hands them)
    cm16_err = 0.0
    f32_before = cmconv_cuda.DTYPE_LAUNCHES["float32"]
    for role, c, co, side in CMCONV_SHAPES:
        x = torch.randn((DEFEND_BATCH, c, side, side), device=dev,
                        generator=gen).bfloat16()
        w = (torch.randn((3, 3, c, co), device=dev, generator=gen) * 0.3).bfloat16().float()
        bias = (torch.randn((co,), device=dev, generator=gen).bfloat16()
                if role == "fwd" else None)
        plain = cmconv.cmconv_plain(x, w, bias)
        kern = cmconv_cuda.cmconv3x3_cuda(x, w, bias)
        cm16_err = max(cm16_err, check_cmconv_bf16(
            f"cmconv bf16 {role} {c}->{co} at {side}", kern, plain))
        if not torch.equal(cmconv_cuda.cmconv3x3_instance(x, w, bias, "simt"), kern):
            fail(f"cmconv bf16 {role} {c}->{co} at {side}: two launches differ")
        print(f"  cmconv bf16 {role} {c}->{co} b{DEFEND_BATCH} {side}x{side}: "
              f"bit-equal to the bf16 plain version, two launches bit-equal")
    if cmconv_cuda.DTYPE_LAUNCHES["float32"] != f32_before:
        fail("a bf16 cmconv call launched the float32 instance")
    del x, w, bias, kern, plain
    torch.set_grad_enabled(True)
    print(f"phase 8 cmconv bf16 instance vs bf16 plain: {len(CMCONV_SHAPES)} shapes "
          f"bit-equal (tolerance {BF16_CMCONV_TOL} of scale), max error {cm16_err}")

    # phase 9: the defender step, lite4@640, b24, fp32
    t0 = time.perf_counter()
    dcfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    dcfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": DEFEND_THRESH})
    eval_patch = np.random.default_rng(0).uniform(-1, 1, (640, 640, 3)).astype(
        np.float32)
    dfd = PatchAttackDefender(dcfg, get_victim(dcfg, seed=0, device=dev),
                              eval_patch=eval_patch, eval_scale=0.4, device=dev)
    dstate = dfd.init_state(3)
    n_unet = sum(p.numel() for p in dstate.unet.parameters())
    dimages = torch.rand((DEFEND_BATCH, *dfd.image_hw, 3), device=dev,
                         generator=torch.Generator(dev).manual_seed(4)) * 2 - 1
    dstep = lambda: dfd.train_step(dstate, dimages)
    dstep()  # warm-up outside the counted run
    torch.cuda.synchronize()
    print(f"  defender efficientdet-lite4 {dfd.image_hw}, U-Net n_filters "
          f"{dfd.n_filters} ({n_unet} parameters), batch {DEFEND_BATCH}, "
          f"built and warmed up in {time.perf_counter() - t0:.2f} s")
    params0 = [p.detach().clone() for p in dstate.unet.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    nms_cuda.LAUNCHES = 0
    warp_cuda.reset_counts()
    cmconv_cuda.LAUNCHES = 0
    mbconv_cuda.reset_counts()
    with UnfusedRoute() as unfused:
        for _ in range(DEFEND_STEPS):
            _, dm = dstep()
    torch.cuda.synchronize()
    defend_launches = dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES,
                           cmconv=cmconv_cuda.LAUNCHES)
    check_fused_route("defender step", dict(mbconv_cuda.LAUNCHES), unfused,
                      MBCONV_PER_PASS * DEFEND_STEPS, 0, passes=DEFEND_STEPS)
    defend_windows = warp_cuda.WINDOWS
    dpeak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict(pass1_fwd=DEFEND_STEPS, pass2_fwd=DEFEND_STEPS, pass2_bwd=0,
                pass1_bwd=0, nms=DEFEND_STEPS,
                cmconv=CMCONV_PER_STEP * DEFEND_STEPS)
    if defend_launches != want:
        fail(f"{DEFEND_STEPS} defender steps launched {defend_launches}; want {want}")
    if not defend_windows:
        fail("the masker planted no patch")
    if not (np.isfinite(float(dm.loss)) and 0 < float(dm.mean_clean_score) < 1):
        fail(f"defender metrics {dm}")
    if all(torch.equal(p, q) for p, q in zip(dstate.unet.parameters(), params0)):
        fail("the U-Net did not move")
    print(f"phase 9 defender step: launches in {DEFEND_STEPS} steps "
          f"{defend_launches}, fused MBConv {mbconv_cuda.LAUNCHES}, "
          f"{defend_windows // DEFEND_STEPS} windows planted "
          f"per step; loss {float(dm.loss):.6f}, mean clean score "
          f"{float(dm.mean_clean_score):.6f}; peak memory {dpeak_gb:.3f} GB")
    dstep_ms = host_p50_ms(dstep, iters=5, warmup=1)
    print(f"  defender step b{DEFEND_BATCH} p50 {dstep_ms:.3f} ms "
          f"({DEFEND_BATCH * 1e3 / dstep_ms:.2f} images/s)")
    profile_device(dstep, f"defender step b{DEFEND_BATCH}", top=10)

    # phase 10: eval_step and recover
    nms_cuda.LAUNCHES = 0
    cmconv_cuda.LAUNCHES = 0
    mbconv_cuda.reset_counts()
    with UnfusedRoute() as unfused:
        em = dfd.eval_step(dstate, dimages, 1)
    torch.cuda.synchronize()
    check_fused_route("eval_step", dict(mbconv_cuda.LAUNCHES), unfused,
                      3 * MBCONV_PER_PASS, 0, passes=3)
    if (cmconv_cuda.LAUNCHES, nms_cuda.LAUNCHES) != (8, 3):
        fail(f"eval_step launched cmconv {cmconv_cuda.LAUNCHES}, NMS "
             f"{nms_cuda.LAUNCHES} times; want 8, 3")
    if not (np.isfinite(float(em.loss)) and np.isfinite(float(em.recovery_psnr))):
        fail(f"eval metrics {em}")
    cmconv_cuda.LAUNCHES = 0
    mbconv_cuda.reset_counts()
    rec = dfd.recover(dstate, dimages)
    torch.cuda.synchronize()
    if sum(mbconv_cuda.LAUNCHES.values()):
        fail(f"recover ran the victim: {mbconv_cuda.LAUNCHES}")
    if cmconv_cuda.LAUNCHES != 8 or rec.shape != dimages.shape or not (
            float(rec.abs().max()) <= 1.0):
        fail(f"recover: {cmconv_cuda.LAUNCHES} cmconv launches, shape "
             f"{tuple(rec.shape)}")
    eval_ms = host_p50_ms(lambda: dfd.eval_step(dstate, dimages, 1), iters=3,
                          warmup=1)
    recover_ms = host_p50_ms(lambda: dfd.recover(dstate, dimages), iters=5)
    print(f"phase 10 eval_step: loss {float(em.loss):.6f}, recovery PSNR "
          f"{float(em.recovery_psnr):.4f} dB, ADR {float(em.adr)} (NaN: no "
          f"clean score above .55 at random weights), p50 {eval_ms:.3f} ms; "
          f"recover b{DEFEND_BATCH} p50 {recover_ms:.3f} ms "
          f"({DEFEND_BATCH * 1e3 / recover_ms:.2f} images/s)")
    del rec

    # phase 11: cmconv, the warp forward passes and NMS on the inputs a step
    # gave them
    with Capture([(cmconv_cuda, "cmconv3x3_cuda"), (warp_cuda, "pass1_fwd"),
                  (warp_cuda, "pass2_fwd"),
                  (nms_cuda, "batched_nms_cuda")]) as cap:
        dstep()
    torch.cuda.synchronize()
    calls = [a for a, _ in cap.args["cmconv3x3_cuda"]]  # (x, w, bias)
    if len(calls) != CMCONV_PER_STEP:
        fail(f"captured {len(calls)} cmconv calls in a step")
    torch.set_grad_enabled(False)
    cm_tot = dict(ms=0.0, ablation_ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_tc_ms=0.0,
                  library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                  **{f"{k}_ms": 0.0 for k in CMCONV_INSTANCES})
    cm_fwd = dict(cm_tot)  # the 8 forward launches: recover's and eval_step's
    for i, (x, w, bias) in enumerate(calls):
        role = "fwd" if i < 8 else "dx"
        c, co = w.shape[2], w.shape[3]
        pick = cmconv_cuda.plan(c, co, x.shape[2], x.shape[3]).instance
        plain = cmconv.cmconv_plain(x, w, bias)
        for inst in CMCONV_INSTANCES:
            cm_err = max(cm_err, kernel_err(
                f"cmconv {inst} step call {i}", cmconv_cuda.cmconv3x3_instance(
                    x, w, bias, inst), plain))
        kern = cmconv_cuda.cmconv3x3_cuda(x, w, bias)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        lib = torch.nn.functional.conv2d(x, w_oihw, bias, padding=1)
        lib_err = float((lib - kern).abs().max())
        t = {f"{inst}_ms": kernel_device_ms(
            lambda: cmconv_cuda.cmconv3x3_instance(x, w, bias, inst),
            CMCONV_KERNEL[inst], iters=5) for inst in CMCONV_INSTANCES}
        t["ms"] = t[f"{pick}_ms"]
        # the ablation: the instance the plan did not pick
        t["ablation_ms"] = next(t[f"{o}_ms"] for o in CMCONV_INSTANCES if o != pick)
        t["plain_ms"] = cuda_ms(lambda: cmconv.cmconv_plain(x, w, bias), iters=2,
                                warmup=1)
        t["library_ms"] = cuda_ms(lambda: torch.nn.functional.conv2d(
            x, w_oihw, bias, padding=1), iters=10)
        t["bound_ms"], bound_by, nbytes, ops = cmconv_bound(x, co, bias is not None)
        t["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = ops / FP32_FLOP_PER_S * 1e3
        t["bound_tc_ms"] = max(t["bytes_ms"], ops / TC3_FLOP_PER_S * 1e3)
        for k in cm_tot:
            cm_tot[k] += t[k]
            if role == "fwd":
                cm_fwd[k] += t[k]
        print(f"  cmconv step call {i:2d} {role} {c}->{co} "
              f"{tuple(x.shape)}{' +bias' if bias is not None else ''}: plan {pick}, "
              + ", ".join(f"{inst} {t[f'{inst}_ms']:.4f} ms ({t['bound_ms'] / t[f'{inst}_ms']:.1%}"
                          f" of the fp32 bound, {t['bound_tc_ms'] / t[f'{inst}_ms']:.1%} of "
                          f"the 3xTF32 one)" for inst in CMCONV_INSTANCES)
              + f"; plain {t['plain_ms']:.4f} ms, F.conv2d {t['library_ms']:.4f} ms "
              f"(differs by {lib_err:.3g}); bound {t['bound_ms']:.6f} ms ({bound_by}: "
              f"{nbytes} B, {ops} fp32 ops), at 3xTF32 {t['bound_tc_ms']:.6f} ms")
    # the weight gradients of these convs stay with cuDNN (conv2d_weight):
    # forward call 7 - j and input-gradient call 8 + j belong to one conv
    wgrad_ms = 0.0
    for j in range(CMCONV_PER_STEP - 8):
        (x, w, _), (g, _, _) = calls[7 - j], calls[8 + j]
        wgrad_ms += cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            x, (w.shape[3], w.shape[2], 3, 3), g, padding=1), iters=5)
    print(f"  cuDNN weight gradient (conv2d_weight) of the {CMCONV_PER_STEP - 8} "
          f"cmconv convs that get an input gradient: {wgrad_ms:.4f} ms per step")
    cm_bound_by = "bytes" if cm_tot["bytes_ms"] >= cm_tot["ops_ms"] else "operations"
    for label, tot in ((f"per step ({CMCONV_PER_STEP} launches)", cm_tot),
                       ("over the 8 forward launches (recover, eval_step)", cm_fwd)):
        print(f"phase 11 cmconv at the step's inputs, {label}: the plan's picks "
              f"{tot['ms']:.4f} ms, the other instance {tot['ablation_ms']:.4f} ms, "
              + ", ".join(f"{inst} everywhere {tot[f'{inst}_ms']:.4f} ms"
                          for inst in CMCONV_INSTANCES)
              + f", plain {tot['plain_ms']:.4f} ms, F.conv2d {tot['library_ms']:.4f} "
              f"ms, bound {tot['bound_ms']:.6f} ms (bytes {tot['bytes_ms']:.6f}, "
              f"operations {tot['ops_ms']:.6f}), at 3xTF32 {tot['bound_tc_ms']:.6f} ms; "
              f"max error {cm_err}")
    (canvases, table, win_w), _ = cap.args["pass1_fwd"][0]
    (t_in, _), _ = cap.args["pass2_fwd"][0]
    errs = check_warp_fwd("defender step inputs", canvases, table, win_w, t_in)
    warp_errs = {k: max(warp_errs[k], errs.get(k, 0.0)) for k in WARP_KERNELS}
    dwarp_ms = {k: kernel_device_ms(fn, f"{k}_kernel", iters=5) for k, fn in (
        ("pass1_fwd", lambda: warp_cuda.pass1_fwd(canvases, table, win_w)),
        ("pass2_fwd", lambda: warp_cuda.pass2_fwd(t_in, table)))}
    print(f"  warp forward kernels at the defender step's {table.shape[0]} "
          f"windows (p0 {canvases.shape[1]}, w {win_w}, {canvases.shape[0]} "
          f"canvases): max errors {errs}, two launches bit-equal; kernel "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dwarp_ms.items()))
    (nms_boxes, nms_scores), nms_kw = cap.args["batched_nms_cuda"][0]
    *_, err = nms_numbers(nms_boxes, nms_scores, nms_kw, "defender victim pass")
    max_err = max(max_err, err)
    del cap, calls, x, w, g, bias, kern, lib, params0
    del canvases, table, t_in, nms_boxes, nms_scores
    torch.set_grad_enabled(True)
    torch.cuda.empty_cache()

    # phase 9b: the bf16 defender step (config.mixed_precision, the JAX
    # driver's --bf16): bf16 victim and U-Net, float32 parameters and loss;
    # lite4@640, b24, n_filters 8, the phase 9 images
    t0 = time.perf_counter()
    bdcfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    bdcfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": DEFEND_THRESH})
    bdcfg.mixed_precision = True
    bdfd = PatchAttackDefender(bdcfg, get_victim(bdcfg, seed=0, device=dev),
                               eval_patch=eval_patch, eval_scale=0.4, device=dev)
    bdstate = bdfd.init_state(3)
    bdstep = lambda: bdfd.train_step(bdstate, dimages)
    bdstep()  # warm-up outside the counted run
    torch.cuda.synchronize()
    print(f"  bf16 defender efficientdet-lite4 {bdfd.image_hw}, U-Net n_filters "
          f"{bdfd.n_filters} in {bdstate.unet.dtype}, batch {DEFEND_BATCH}, built and "
          f"warmed up in {time.perf_counter() - t0:.2f} s")
    params0 = [p.detach().clone() for p in bdstate.unet.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    nms_cuda.LAUNCHES = 0
    warp_cuda.reset_counts()
    cmconv_cuda.reset_counts()
    mbconv_cuda.reset_counts()
    with UnfusedRoute() as unfused:
        for _ in range(DEFEND_STEPS):
            _, bdm = bdstep()
    torch.cuda.synchronize()
    bdefend_launches = dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES,
                            cmconv_bf16=cmconv_cuda.DTYPE_LAUNCHES["bfloat16"],
                            cmconv_fp32=cmconv_cuda.DTYPE_LAUNCHES["float32"])
    bd_mb = {k: dict(v) for k, v in mbconv_cuda.DTYPE_LAUNCHES.items()}
    check_fused_route("bf16 defender step", dict(mbconv_cuda.LAUNCHES), unfused,
                      MBCONV_PER_PASS * DEFEND_STEPS, 0, passes=DEFEND_STEPS)
    bdpeak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict(pass1_fwd=DEFEND_STEPS, pass2_fwd=DEFEND_STEPS, pass2_bwd=0,
                pass1_bwd=0, nms=DEFEND_STEPS,
                cmconv_bf16=CMCONV_PER_STEP * DEFEND_STEPS, cmconv_fp32=0)
    if bdefend_launches != want:
        fail(f"{DEFEND_STEPS} bf16 defender steps launched {bdefend_launches}; want {want}")
    if (sum(bd_mb["float32"].values())
            or bd_mb["bfloat16"]["mbconv_fwd"] != MBCONV_PER_PASS * DEFEND_STEPS
            or bd_mb["bfloat16"]["mbconv_dx"]):
        fail(f"bf16 defender steps: fused MBConv launches per dtype {bd_mb}")
    if not warp_cuda.WINDOWS:
        fail("bf16 defender: the masker planted no patch")
    if not (np.isfinite(float(bdm.loss)) and 0 < float(bdm.mean_clean_score) < 1):
        fail(f"bf16 defender metrics {bdm}")
    if all(torch.equal(p, q) for p, q in zip(bdstate.unet.parameters(), params0)):
        fail("the bf16 U-Net did not move")
    if any(p.dtype != torch.float32 for p in bdstate.unet.parameters()):
        fail("the bf16 U-Net's parameters are not float32")
    print(f"phase 9b bf16 defender step: launches in {DEFEND_STEPS} steps "
          f"{bdefend_launches}, fused MBConv per dtype {bd_mb}, "
          f"{warp_cuda.WINDOWS // DEFEND_STEPS} windows planted per step; loss "
          f"{float(bdm.loss):.6f}, mean clean score {float(bdm.mean_clean_score):.6f}; "
          f"peak memory {bdpeak_gb:.3f} GB (fp32 {dpeak_gb:.3f} GB)")
    bdstep_ms = host_p50_ms(bdstep, iters=5, warmup=1)
    print(f"  bf16 defender step b{DEFEND_BATCH} p50 {bdstep_ms:.3f} ms "
          f"({DEFEND_BATCH * 1e3 / bdstep_ms:.2f} images/s; fp32 {dstep_ms:.3f} ms in "
          f"phase 9)")
    profile_device(bdstep, f"bf16 defender step b{DEFEND_BATCH}", top=10)
    cmconv_cuda.reset_counts()
    nms_cuda.LAUNCHES = 0
    bem = bdfd.eval_step(bdstate, dimages, 1)
    brec = bdfd.recover(bdstate, dimages)
    torch.cuda.synchronize()
    if (cmconv_cuda.DTYPE_LAUNCHES["bfloat16"], cmconv_cuda.DTYPE_LAUNCHES["float32"],
            nms_cuda.LAUNCHES) != (16, 0, 3):
        fail(f"bf16 eval_step + recover launched cmconv {cmconv_cuda.DTYPE_LAUNCHES}, "
             f"NMS {nms_cuda.LAUNCHES}; want 8 + 8 bf16, 3")
    if not (np.isfinite(float(bem.loss)) and np.isfinite(float(bem.recovery_psnr))):
        fail(f"bf16 eval metrics {bem}")
    if brec.dtype != torch.float32 or not float(brec.abs().max()) <= 1.0:
        fail(f"bf16 recover: {brec.dtype}")
    beval_ms = host_p50_ms(lambda: bdfd.eval_step(bdstate, dimages, 1), iters=3,
                           warmup=1)
    brecover_ms = host_p50_ms(lambda: bdfd.recover(bdstate, dimages), iters=5)
    print(f"  bf16 eval_step: loss {float(bem.loss):.6f}, recovery PSNR "
          f"{float(bem.recovery_psnr):.4f} dB, p50 {beval_ms:.3f} ms (fp32 "
          f"{eval_ms:.3f}); bf16 recover b{DEFEND_BATCH} p50 {brecover_ms:.3f} ms "
          f"({DEFEND_BATCH * 1e3 / brecover_ms:.2f} images/s; fp32 {recover_ms:.3f})")
    del brec

    # phase 11, bf16: the bf16 instance on the 15 inputs the bf16 step gave
    # it, against the bf16 plain version, timed beside its bound (2-byte x,
    # bias and output; the products at the bf16 tensor-core rate, since the
    # U-Net's kernels hold bf16 values and one bf16 product of them is
    # exact), the fp32-FMA bound that the instance's SIMT sums meet, the
    # plain time and F.conv2d in bf16 (cuDNN)
    with Capture([(cmconv_cuda, "cmconv3x3_cuda")]) as cap:
        bdstep()
    torch.cuda.synchronize()
    calls = [a for a, _ in cap.args["cmconv3x3_cuda"]]
    if len(calls) != CMCONV_PER_STEP or any(x.dtype != torch.bfloat16 for x, _, _ in calls):
        fail(f"captured {len(calls)} cmconv calls in a bf16 step, dtypes "
             f"{sorted({str(x.dtype) for x, _, _ in calls})}")
    torch.set_grad_enabled(False)
    cm16_tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                    ops_ms=0.0, bound_simt_ms=0.0)
    cm16_fwd = dict(cm16_tot)
    for i, (x, w, bias) in enumerate(calls):
        role = "fwd" if i < 8 else "dx"
        c, co = w.shape[2], w.shape[3]
        if not torch.equal(w, w.bfloat16().float()):
            fail(f"cmconv bf16 step call {i}: the kernel holds values off bf16")
        plain = cmconv.cmconv_plain(x, w, bias)
        kern = cmconv_cuda.cmconv3x3_cuda(x, w, bias)
        cm16_err = max(cm16_err, check_cmconv_bf16(f"cmconv bf16 step call {i}", kern,
                                                   plain))
        w_oihw = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        lib = torch.nn.functional.conv2d(x, w_oihw, bias, padding=1)
        lib_err = float((lib.float() - kern.float()).abs().max())
        t = {"ms": kernel_device_ms(lambda: cmconv_cuda.cmconv3x3_instance(
            x, w, bias, "simt"), CMCONV_KERNEL["simt"], iters=5)}
        t["plain_ms"] = cuda_ms(lambda: cmconv.cmconv_plain(x, w, bias), iters=2,
                                warmup=1)
        t["library_ms"] = cuda_ms(lambda: torch.nn.functional.conv2d(
            x, w_oihw, bias, padding=1), iters=10)
        t["bound_ms"], bound_by, nbytes, ops = cmconv_bound(x, co, bias is not None,
                                                           BF16_FLOP_PER_S)
        t["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = ops / BF16_FLOP_PER_S * 1e3
        t["bound_simt_ms"] = cmconv_bound(x, co, bias is not None)[0]
        for k in cm16_tot:
            cm16_tot[k] += t[k]
            if role == "fwd":
                cm16_fwd[k] += t[k]
        print(f"  cmconv bf16 step call {i:2d} {role} {c}->{co} {tuple(x.shape)}"
              f"{' +bias' if bias is not None else ''}: {t['ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.1%} of its bound, "
              f"{t['bound_simt_ms'] / t['ms']:.1%} of the fp32-FMA one); plain "
              f"{t['plain_ms']:.4f} ms, F.conv2d bf16 {t['library_ms']:.4f} ms (differs "
              f"by {lib_err:.3g}); bound {t['bound_ms']:.6f} ms ({bound_by}: {nbytes} B, "
              f"{ops} ops at the bf16 rate), at fp32 FMAs {t['bound_simt_ms']:.6f} ms")
    cm16_bound_by = ("bytes" if cm16_tot["bytes_ms"] >= cm16_tot["ops_ms"]
                     else "operations")
    for label, tot in ((f"per step ({CMCONV_PER_STEP} launches)", cm16_tot),
                       ("over the 8 forward launches (recover, eval_step)", cm16_fwd)):
        print(f"phase 11 cmconv bf16 at the bf16 step's inputs, {label}: "
              f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, F.conv2d bf16 "
              f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.6f} ms (bytes "
              f"{tot['bytes_ms']:.6f}, operations at the bf16 rate {tot['ops_ms']:.6f}; "
              f"{tot['bound_ms'] / tot['ms']:.1%}), at fp32 FMAs "
              f"{tot['bound_simt_ms']:.6f} ms; fp32 instance "
              f"{cm_tot['ms'] if 'per step' in label else cm_fwd['ms']:.4f} ms; max "
              f"error {cm16_err}")
    del cap, calls, x, w, bias, kern, lib, plain, bdfd, bdstate, params0
    torch.set_grad_enabled(True)
    torch.cuda.empty_cache()

    # phase 9c: the packed defender (models/unet_packed.py) at packed_levels
    # 1, 2 and 3, fp32, on phase 9's victim and images: its train step timed
    # with its peak memory, and its recover against the unpacked recover on
    # the same weights. A few train steps leave the running statistics near
    # their initial values, so an eval pass would not normalise: its logits
    # reach 1e7 and every recovered pixel clips to +-1, where any two
    # functions agree. The statistics are first set to these images' batch
    # statistics (`calibrate_bn`), so that eval computes what train mode
    # does and the comparison sees the function.
    calibrate_bn(dstate.unet, dimages)
    rec_logits = []
    hook = dstate.unet.output.register_forward_hook(
        lambda mod, args, out: rec_logits.append(out))
    rec_ref = dfd.recover(dstate, dimages)
    hook.remove()
    if not float(rec_logits[0].abs().max()) < 100.0:
        fail(f"packed recover: the unpacked logits reach {rec_logits[0].abs().max()}")
    rec_tol = RECOVER_TOL * max(1.0, float(rec_logits[0].abs().max()))
    # one train step's masked images and targets: the packed gradients
    # here and remat's in phase 9d are taken on them
    with torch.no_grad():
        boxes, _, valid = dfd.odet_boxes(dimages)
        patched, targets = dfd._mask(dstate, dimages, boxes, valid, None)

    def unet_grads(net, dtype=torch.float32):
        """{name: gradient} of one train-mode pass of a copy of `net` in
        `dtype` at dropout 0 (the packed and unpacked modules draw their
        masks otherwise)."""
        net = copy.deepcopy(net).to(dtype)
        net.zero_grad(set_to_none=True)
        for m in net.modules():
            if isinstance(getattr(m, "dropout", None), float):
                m.dropout = 0.0
        with Float64Convs() if dtype == torch.float64 else contextlib.nullcontext():
            loss, _ = dfd._loss(net, patched.to(dtype), targets.to(dtype), True)
            loss.backward()
        return {k: p.grad for k, p in net.named_parameters()}

    def flat(grads):
        return torch.cat([g.double().flatten() for g in grads.values()])

    def worst_leaf(grads):
        """(largest error of a leaf against the unpacked float64 gradient
        in units of its largest entry, that leaf's name); the biases of the
        convs that feed a BatchNorm have a true gradient of 0 and only
        rounding noise is left of them."""
        return max((float((g.double() - ref_grads[k]).abs().max())
                    / float(ref_grads[k].abs().max()), k) for k, g in grads.items()
                   if not k.endswith(("cnv1.bias", "cnv2.bias", "conv3.bias")))

    ref_grads = unet_grads(dstate.unet, torch.float64)
    ref_flat = flat(ref_grads)
    unpacked32 = unet_grads(dstate.unet)
    unpacked_l2 = float((flat(unpacked32) - ref_flat).norm() / ref_flat.norm())
    unpacked_leaf = worst_leaf(unpacked32)
    del unpacked32
    packed_rows = {}
    route = {}
    for level in PACKED_LEVELS:
        pdfd = PatchAttackDefender(dcfg, dfd.net, eval_patch=eval_patch, eval_scale=0.4,
                                   packed=level, device=dev)
        pstate = pdfd.init_state(3)
        pstate.unet.load_state_dict(dstate.unet.state_dict())
        rec = pdfd.recover(pstate, dimages)
        rec_err = float((rec - rec_ref).abs().max())
        if not rec_err <= rec_tol:
            fail(f"packed {level} recover differs from the unpacked by {rec_err} > {rec_tol}")
        # the function: the float64 gradients against the unpacked U-Net's,
        # leaf by leaf
        grad_err, k = worst_leaf(unet_grads(pstate.unet, torch.float64))
        if not grad_err <= PACKED_GRAD_F64_TOL:
            fail(f"packed {level}: float64 gradient of {k} differs from the "
                 f"unpacked by {grad_err} of its scale > {PACKED_GRAD_F64_TOL}")
        # the float32 route (the cmconv kernels among it): the whole float32
        # gradient against the float64 one
        packed_l2 = float((flat(unet_grads(pstate.unet)) - ref_flat).norm()
                          / ref_flat.norm())
        if not packed_l2 <= PACKED_GRAD_TOL:
            fail(f"packed {level}: float32 gradient off the float64 one by {packed_l2} "
                 f"(relative L2) > {PACKED_GRAD_TOL}")
        pstep = lambda: pdfd.train_step(pstate, dimages)
        # every cmconv call of a step against the plain version, two
        # launches bit-equal
        with Capture([(cmconv_cuda, "cmconv3x3_cuda")]) as cap:
            pstep()  # also the warm-up
        torch.cuda.synchronize()
        calls = [a for a, _ in cap.args["cmconv3x3_cuda"]]
        if len(calls) != PACKED_CMCONV_PER_STEP[level]:
            fail(f"packed {level}: captured {len(calls)} cmconv calls in a step")
        with torch.no_grad():
            for i, (x, w, bias) in enumerate(calls):
                kern = cmconv_cuda.cmconv3x3_cuda(x, w, bias)
                cm_err = max(cm_err, kernel_err(f"cmconv packed {level} step call {i}",
                                                kern, cmconv.cmconv_plain(x, w, bias)))
                if not torch.equal(cmconv_cuda.cmconv3x3_cuda(x, w, bias), kern):
                    fail(f"cmconv packed {level} step call {i}: two launches differ")
                c, co = w.shape[2], w.shape[3]
                if 12 in (c, co) or (c, co) == (32, 32):  # a packed conv
                    w_oihw = w.permute(3, 2, 0, 1).contiguous()
                    kern_ms = cuda_ms(lambda: cmconv_cuda.cmconv3x3_cuda(x, w, bias),
                                      iters=10)
                    lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
                        x, w_oihw, bias, padding=1), iters=10)
                    route[(level, i)] = (f"{'fwd' if bias is not None else 'dx'} "
                                         f"{c}->{co} {tuple(x.shape)} cmconv "
                                         f"{kern_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms")
        del cap, calls, x, w, bias, kern
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cmconv_cuda.reset_counts()
        nms_cuda.LAUNCHES = 0
        for _ in range(DEFEND_STEPS):
            _, pm = pstep()
        torch.cuda.synchronize()
        ppeak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        got = (cmconv_cuda.LAUNCHES, nms_cuda.LAUNCHES)
        if got != (PACKED_CMCONV_PER_STEP[level] * DEFEND_STEPS, DEFEND_STEPS):
            fail(f"packed {level}: cmconv and NMS launches {got} in {DEFEND_STEPS} steps")
        if not np.isfinite(float(pm.loss)):
            fail(f"packed {level} metrics {pm}")
        pstep_ms = host_p50_ms(pstep, iters=5, warmup=1)
        precover_ms = host_p50_ms(lambda: pdfd.recover(pstate, dimages), iters=5)
        packed_rows[level] = (pstep_ms, ppeak_gb, precover_ms)
        print(f"  packed {level}: train step p50 {pstep_ms:.3f} ms "
              f"({DEFEND_BATCH * 1e3 / pstep_ms:.2f} images/s), peak memory "
              f"{ppeak_gb:.3f} GB, cmconv {PACKED_CMCONV_PER_STEP[level]} a step, each "
              f"within {WARP_TOL} of the plain version's scale and two launches "
              f"bit-equal, loss {float(pm.loss):.6f}; float64 parameter gradients "
              f"within {grad_err:.3g} of scale of the unpacked (limit "
              f"{PACKED_GRAD_F64_TOL}), float32 gradient {packed_l2:.3g} off the "
              f"float64 one in relative L2 (the unpacked {unpacked_l2:.3g}, its "
              f"worst leaf {unpacked_leaf[0]:.3g} of scale on {unpacked_leaf[1]}; "
              f"limit {PACKED_GRAD_TOL}); "
              f"recover p50 {precover_ms:.3f} ms, within {rec_err:.3g} of the unpacked "
              f"recover (limit {rec_tol:.3g})")
        del pdfd, pstate, pstep, rec
    # the routing of a packed 3x3 conv: cmconv where both packed channel
    # counts are at most 32, against cuDNN (TF32 off) on the same tensors
    print(f"  packed 3x3 convs of the packed steps at b{DEFEND_BATCH} (CUDA events): "
          + "; ".join(f"level {lv} call {i} {r}" for (lv, i), r in route.items()))
    print(f"phase 9c packed defender, fp32 b{DEFEND_BATCH}: unpacked step {dstep_ms:.3f} "
          f"ms / {dpeak_gb:.3f} GB, recover {recover_ms:.3f} ms; "
          + "; ".join(f"packed {lv} step {r[0]:.3f} ms ({dstep_ms / r[0]:.3f}x the "
                      f"unpacked images/s) / {r[1]:.3f} GB, recover {r[2]:.3f} ms"
                      for lv, r in packed_rows.items()))
    del rec_ref, rec_logits, ref_grads
    torch.cuda.empty_cache()

    # phase 9d: remat (every ConvBlock and DeconvBlock recomputed in the
    # backward pass), fp32: one train step's parameter gradients against
    # remat=False on the same weights, masks and images; then the defender
    # step with the remat U-Net, timed, with its peak memory
    import dataclasses
    from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer
    rnet = PatchNeutralizer(dfd.n_filters, remat=True).to(dev)
    rnet.load_state_dict(dstate.unet.state_dict())
    torch.backends.cudnn.deterministic = True
    grads, stats = {}, {}
    for name, net in (("plain", dstate.unet), ("remat", rnet)):
        snapshot = copy.deepcopy(net.state_dict())
        net.zero_grad(set_to_none=True)
        loss, _ = dfd._loss(net, patched, targets, True,
                            torch.Generator(dev).manual_seed(11))
        loss.backward()
        torch.cuda.synchronize()
        grads[name] = [p.grad.detach().clone() for p in net.parameters()]
        stats[name] = [b.detach().clone() for b in net.buffers()]
        net.load_state_dict(snapshot)
        net.zero_grad(set_to_none=True)
    torch.backends.cudnn.deterministic = False
    bit_equal = all(torch.equal(a, b) for a, b in zip(grads["plain"], grads["remat"]))
    remat_err = max(float((a - b).abs().max()) / max(1e-30, float(a.abs().max()))
                    for a, b in zip(grads["plain"], grads["remat"]))
    if not (bit_equal or remat_err <= REMAT_TOL):
        fail(f"remat gradients differ by {remat_err} of scale > {REMAT_TOL}")
    if not all(torch.equal(a, b) for a, b in zip(stats["plain"], stats["remat"])):
        fail("remat moved the BatchNorm statistics otherwise than one pass")
    rstate = dataclasses.replace(dstate, unet=rnet, optimizer=torch.optim.Adam(
        rnet.parameters(), lr=dfd.learning_rate, betas=(0.9, 0.999), eps=1e-8))
    rstep = lambda: dfd.train_step(rstate, dimages)
    rstep()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cmconv_cuda.reset_counts()
    rstep()
    torch.cuda.synchronize()
    rpeak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if cmconv_cuda.LAUNCHES != CMCONV_PER_STEP + 8:
        fail(f"remat step: {cmconv_cuda.LAUNCHES} cmconv launches, want "
             f"{CMCONV_PER_STEP} + 8 (the recompute's forwards)")
    rstep_ms = host_p50_ms(rstep, iters=5, warmup=1)
    torch.cuda.reset_peak_memory_stats(dev)
    dstep()
    torch.cuda.synchronize()
    dpeak2_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"phase 9d remat: one step's {len(grads['plain'])} parameter gradients "
          f"{'bit-equal to' if bit_equal else f'within {remat_err:.3g} of scale of'} "
          f"remat=False's, BatchNorm statistics bit-equal; defender step with remat "
          f"p50 {rstep_ms:.3f} ms, peak {rpeak_gb:.3f} GB (without remat {dstep_ms:.3f} "
          f"ms in phase 9, peak {dpeak2_gb:.3f} GB now), {CMCONV_PER_STEP + 8} cmconv "
          f"launches a step")
    del rnet, rstate, rstep, grads, stats, patched, targets, boxes, valid
    del dfd, dstate, dimages
    torch.cuda.empty_cache()

    # phase 12: the defense driver, 3 steps at batch 12
    with tempfile.TemporaryDirectory() as tmp:
        nms_cuda.LAUNCHES = 0
        warp_cuda.reset_counts()
        cmconv_cuda.LAUNCHES = 0
        mbconv_cuda.reset_counts()
        t0 = time.perf_counter()
        dfinal = defense_train("efficientdet-lite4", synthetic=True, batch_size=12,
                               epochs=1, steps_per_epoch=3, save_dir=tmp,
                               device=dev, config_override={
                                   "nms_configs": {"score_thresh": DEFEND_THRESH}})
        torch.cuda.synchronize()
        ddriver_s = time.perf_counter() - t0
        ddriver_launches = dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES,
                                cmconv=cmconv_cuda.LAUNCHES, **mbconv_cuda.LAUNCHES)
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "metrics.jsonl").read_text().splitlines()]
        arts = sorted(str(p.relative_to(tmp)) for p in Path(tmp).glob(
            "patch_00_*/antipatch.pkl"))
        if dfinal.step != 3 or not any("val/loss" in r for r in records):
            fail(f"defense driver: step {dfinal.step}, log records {records}")
        if len(arts) != 1:
            fail(f"defense driver: artifacts {arts}")
        # 3 train steps (15 each) and 5 validation batches (8 each)
        if ddriver_launches["cmconv"] != 3 * CMCONV_PER_STEP + 5 * 8 or \
                ddriver_launches["pass1_fwd"] < 3 or ddriver_launches["mbconv_dx"] or \
                ddriver_launches["mbconv_fwd"] < 3 * MBCONV_PER_PASS:
            fail(f"defense driver: kernel launches {ddriver_launches}")
    print(f"phase 12 defense driver: train(efficientdet-lite4, batch 12, 3 "
          f"steps) in {ddriver_s:.2f} s, launches {ddriver_launches}, artifact "
          f"{arts}, {len(records)} log records")
    del dfinal
    # the driver with --bf16 and with --packed (3 levels), 3 steps each
    for opts, want_cm in ((dict(bf16=True), ("bfloat16", 3 * CMCONV_PER_STEP + 5 * 8)),
                          (dict(packed=3), ("float32", 3 * PACKED_CMCONV_PER_STEP[3]
                                            + 5 * 3))):
        with tempfile.TemporaryDirectory() as tmp:
            cmconv_cuda.reset_counts()
            mbconv_cuda.reset_counts()
            t0 = time.perf_counter()
            dfinal = defense_train("efficientdet-lite4", synthetic=True, batch_size=12,
                                   epochs=1, steps_per_epoch=3, save_dir=tmp,
                                   device=dev, config_override={
                                       "nms_configs": {"score_thresh": DEFEND_THRESH}},
                                   **opts)
            torch.cuda.synchronize()
            odriver_s = time.perf_counter() - t0
            arts = sorted(str(p.relative_to(tmp)) for p in Path(tmp).glob(
                "patch_00_*/antipatch.pkl"))
            cm = dict(cmconv_cuda.DTYPE_LAUNCHES)
            mb = {k: dict(v) for k, v in mbconv_cuda.DTYPE_LAUNCHES.items()}
            other = "float32" if want_cm[0] == "bfloat16" else "bfloat16"
            if dfinal.step != 3 or len(arts) != 1:
                fail(f"defense driver {opts}: step {dfinal.step}, artifacts {arts}")
            if cm[want_cm[0]] != want_cm[1] or cm[other] or sum(mb[other].values()):
                fail(f"defense driver {opts}: cmconv launches {cm}, MBConv {mb}")
        print(f"phase 12 defense driver {opts}: train(efficientdet-lite4, batch 12, 3 "
              f"steps) in {odriver_s:.2f} s, cmconv launches per dtype {cm}, fused "
              f"MBConv per dtype {mb}, artifact {arts}")
        del dfinal

    # phases 14-18: the supervised trainer, its checkpoint, and both drivers
    # killed and resumed
    trainer_card_vs_cpu(dev, config_lib)
    t0 = time.perf_counter()
    pool = ScenePool(np.random.default_rng(0), n_batches=TRAIN_POOL_BATCHES,
                     batch=TRAIN_BATCH, hw=640, device=dev)
    print(f"phase 15 scene pool: {pool.n} scenes at 640 rendered and on the card "
          f"in {time.perf_counter() - t0:.2f} s")
    trainer_full_size(dev, pool, mixed_precision=False)
    torch.cuda.empty_cache()
    btr, bst, _ = trainer_full_size(dev, pool, mixed_precision=True)
    del pool
    torch.cuda.empty_cache()

    # phase 16: eval_variables -> torch_to_flax -> save_pytree, served back by
    # Detector(ckpt_path=) against the victim in memory
    with tempfile.TemporaryDirectory() as ckdir:
        victim = btr.eval_variables(bst)
        del btr, bst
        vpath = str(Path(ckdir) / "victim")
        save_pytree(vpath, bridge.torch_to_flax(victim))
        # the victim was trained at bf16 (northstar's operating point) and
        # serves so: both detectors compute in bf16
        bf16 = {"mixed_precision": True}
        det_file = Detector("efficientdet-lite4", params=bf16, device=dev,
                            ckpt_path=vpath)
        det_mem = Detector("efficientdet-lite4", params=bf16, device=dev)
        det_mem.net = victim
        rng16 = np.random.default_rng(16)
        sframes = [rng16.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
                   for _ in range(8)]
        det_file.serve(sframes[:1])
        nms_cuda.LAUNCHES = 0
        mbconv_cuda.reset_counts()
        from_file = det_file.serve(sframes)
        torch.cuda.synchronize()
        serve_launches = dict(nms=nms_cuda.LAUNCHES, **mbconv_cuda.LAUNCHES)
        same_detections("Detector(ckpt_path) against the victim in memory",
                        from_file, det_mem.serve(sframes))
        if serve_launches["nms"] != 1 or serve_launches["mbconv_fwd"] != MBCONV_PER_PASS:
            fail(f"Detector(ckpt_path) serve launches {serve_launches}")
        n_valid = int(np.asarray(from_file.valid).sum())
        print(f"phase 16 save and serve: eval_variables -> torch_to_flax -> "
              f"save_pytree ({Path(vpath + '.pkl').stat().st_size / 1e6:.1f} MB); "
              f"Detector(ckpt_path) serves b8 detections equal to the victim in "
              f"memory ({n_valid} valid), launches {serve_launches}")
        del det_file, det_mem, victim

        # phases 17-18: each driver uninterrupted, and killed after its first
        # epoch and resumed, from the victim file
        torch.backends.cudnn.deterministic = True
        low = {"nms_configs": {"score_thresh": DEFEND_THRESH}}
        akw = dict(synthetic=True, batch_size=DRIVER_BATCH, steps_per_epoch=2,
                   victim_ckpt=vpath, config_override=low, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ref = attack_state_arrays(train("efficientdet-lite4", epochs=2,
                                            save_dir=str(Path(tmp) / "ref"), **akw))
            rdir = str(Path(tmp) / "resumed")
            train("efficientdet-lite4", epochs=1, save_dir=rdir, **akw)
            res = attack_state_arrays(train("efficientdet-lite4", epochs=2,
                                            save_dir=rdir, resume=True, **akw))
            attack_s = time.perf_counter() - t0
        err = resume_err("attack driver resume", ref, res)
        print(f"phase 17 attack driver (victim_ckpt, bf16, batch {DRIVER_BATCH}, two "
              f"epochs of 2 steps): uninterrupted against 1 epoch + resume: "
              f"{'bit-equal' if err == 0.0 else f'within {err:.3g} of scale'} "
              f"(patch, scale, Adam moments and LR, step {ref['step']}, generator) "
              f"in {attack_s:.2f} s")
        dkw = dict(synthetic=True, batch_size=DRIVER_BATCH, steps_per_epoch=2,
                   victim_ckpt=vpath, config_override=low, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            defense_train("efficientdet-lite4", epochs=1, save_dir=str(Path(tmp) / "w"),
                          **dkw)
            (art,) = Path(tmp, "w").glob("patch_00_*/antipatch.pkl")
            dkw["initial_weights"] = str(art)[:-len(".pkl")]
            ref = defender_state_arrays(defense_train(
                "efficientdet-lite4", epochs=2, save_dir=str(Path(tmp) / "ref"), **dkw))
            rdir = str(Path(tmp) / "resumed")
            defense_train("efficientdet-lite4", epochs=1, save_dir=rdir, **dkw)
            res = defender_state_arrays(defense_train(
                "efficientdet-lite4", epochs=2, save_dir=rdir, resume=True, **dkw))
            defend_s = time.perf_counter() - t0
        torch.backends.cudnn.deterministic = False
        err = resume_err("defense driver resume", ref, res)
        print(f"phase 18 defense driver (victim_ckpt, initial_weights from a first "
              f"run's antipatch.pkl, batch {DRIVER_BATCH}, two epochs of 2 steps): "
              f"uninterrupted against 1 epoch + resume: "
              f"{'bit-equal' if err == 0.0 else f'within {err:.3g} of scale'} "
              f"(U-Net, Adam moments and LR, step {ref['step']}, generator) in "
              f"{defend_s:.2f} s")

        # phases 19a-19c: the example workflows' stages on the victim file
        with tempfile.TemporaryDirectory() as work:
            soak_phases(dev, vpath, work)

        # phase 21: the rest of the supervised trainer; 21d first, while
        # the card holds nothing else (the fp32 b24 step peaks near 80 GB)
        torch.cuda.empty_cache()
        grad_checkpoint_phase(dev)
        with tempfile.TemporaryDirectory() as work:
            supervised_driver_phase(dev, work)
            sup_eval = evaluate_map_phase(dev, vpath)
            segmentation_phase(dev, work)
            tfrecord_native_phase(work)

        # phase 22: export and quantize (the int8 conv kernel, the int8
        # serve, torch.export and its driver, the inspector, eval --artifact)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as work:
            q8 = int8_export_phase(dev, vpath, work)

    # phase 20: the video demos' device path
    with tempfile.TemporaryDirectory() as work:
        demo = demo_phase(dev, work)

    # phase 13: card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi.splitlines()[0]}")
    kernels = [{
        "name": "nms", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/nms.cu",
        "replaces": "mladversarialobjectdetection_tpu/ops/pallas_nms.py:34",
        "launches": attack_launches["nms"], "max_abs_err": max_err,
        "ms": nms_ms, "plain_ms": nms_plain_ms, "bound_ms": nms_bound_ms,
        "bound_by": nms_bound_by, "library_ms": None,
        "demo_launches_per_frame": demo["launches_per_frame"]["nms"],
        "demo_score0_ms": demo["nms_ms"], "demo_score0_bound_ms": demo["nms_bound_ms"],
        "eval_launches_per_batch": sup_eval["launches_per_batch"]["nms"],
        "eval_ms": sup_eval["nms_ms"], "eval_bound_ms": sup_eval["nms_bound_ms"],
        "eval_max_abs_err": sup_eval["nms_err"]}]
    for k in WARP_KERNELS:
        kern_ms, plain_ms, bound_ms, bound_by = warp_times[k]
        kernels.append({
            "name": f"warp_{k}", "route": "cuda",
            "source": "mladversarialobjectdetection_torch/csrc/warp.cu",
            "replaces": WARP_REPLACES[k], "launches": attack_launches[k],
            "max_abs_err": warp_errs[k], "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    kernels.append({
        "name": "cmconv", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/cmconv.cu",
        "replaces": "tools/proto_cmconv.py:28",
        "launches": defend_launches["cmconv"], "max_abs_err": cm_err,
        "ms": cm_tot["ms"], "plain_ms": cm_tot["plain_ms"],
        "bound_ms": cm_tot["bound_ms"], "bound_by": cm_bound_by,
        "library_ms": cm_tot["library_ms"], "ablation_ms": cm_tot["ablation_ms"],
        "bound_tc_ms": cm_tot["bound_tc_ms"],
        "demo_launches_per_frame": demo["launches_per_frame"]["cmconv"],
        "demo_recover_ms": demo["cmconv"]["ms"],
        "demo_recover_bound_ms": demo["cmconv"]["bound_ms"],
        "demo_max_abs_err": demo["cmconv_err"]})
    kernels.append({
        "name": "cmconv_bf16", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/cmconv_bf16.cu",
        "replaces": "tools/proto_cmconv.py:28",
        "launches": bdefend_launches["cmconv_bf16"], "max_abs_err": cm16_err,
        "ms": cm16_tot["ms"], "plain_ms": cm16_tot["plain_ms"],
        "bound_ms": cm16_tot["bound_ms"], "bound_by": cm16_bound_by,
        "library_ms": cm16_tot["library_ms"], "bound_simt_ms": cm16_tot["bound_simt_ms"]})
    for kind in ("fwd", "dx"):  # per pass of the 25 fuseable blocks
        tot = mb_tot[kind]
        kernels.append({
            "name": f"mbconv_{kind}", "route": "cuda",
            "source": "mladversarialobjectdetection_torch/csrc/mbconv.cu",
            "replaces": MBCONV_REPLACES[kind],
            "launches": attack_mb[f"mbconv_{kind}"], "max_abs_err": mb_errs[kind],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": None,
            "unfused_ms": tot["unfused_ms"], "bound_tc_ms": tot["bound_tc_ms"],
            **({"demo_launches_per_frame": demo["launches_per_frame"]["mbconv_fwd"]}
               if kind == "fwd" else {})})
    for kind in ("fwd", "dx"):  # the bf16 instances, per pass of the bf16 step
        tot = mb16_tot[kind]
        kernels.append({
            "name": f"mbconv_{kind}_bf16", "route": "cuda",
            "source": ("mladversarialobjectdetection_torch/csrc/mbconv_bf16.cu" if kind == "fwd"
                       else "mladversarialobjectdetection_torch/csrc/mbconv_bf16_dx.cu"),
            "replaces": MBCONV_REPLACES[kind],
            "launches": bf16_mb["bfloat16"][f"mbconv_{kind}"],
            "max_abs_err": mb16_errs[kind], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"], "library_ms": None,
            "unfused_ms": tot["unfused_ms"],
            **({"eval_launches_per_batch": sup_eval["launches_per_batch"]["mbconv_fwd_bf16"],
                "eval_ms": sup_eval["mbconv"]["ms"],
                "eval_bound_ms": sup_eval["mbconv"]["bound_ms"],
                "eval_plain_ms": sup_eval["mbconv"]["plain_ms"],
                "eval_max_abs_err": sup_eval["mbconv_err"]} if kind == "fwd" else {})})
    c8, c8b = q8["numbers_fp32"], q8["numbers_bf16"]
    kernels.append({
        "name": "conv_int8", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/conv_int8.cu",
        "replaces": CONV_INT8_REPLACES, "launches": q8["serve"]["fp32"]["launches"],
        "max_abs_err": 0.0, "ms": c8["ms"], "plain_ms": c8["plain_ms"],
        "bound_ms": c8["bound_ms"], "bound_by": c8["bound_by"], "library_ms": c8["intmm_ms"],
        "library_covers": f"torch._int_mm on {c8['n_intmm']} of the {c8['n_1x1']} 1x1 convs",
        "kernel_ms_on_library_convs": c8["intmm_kernel_ms"],
        "cudnn_bf16_ms": c8["cudnn_bf16_ms"], "conv_calls_per_serve": c8["n"],
        "bf16_ms": c8b["ms"], "bf16_bound_ms": c8b["bound_ms"],
        "bf16_launches": q8["serve"]["bf16"]["launches"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
