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
   bf16 boundary); the bf16 forward there is the template's instance
   (`mbconv_fwd_bf16_instance`); then the Hopper bf16 forward
   (`csrc/mbconv_fwd_sm90.cu`, `check_sm90`) on the odd shapes its rule
   takes (the others must run the instance), on lite4's 7 fused shapes at
   b1, b8 and b24 and on their heights under phase 25's split: within
   MBCONV_BF16_FWD_TOL, every output within the roundings, two launches
   bit-equal, counted on it and not on the instance; then the Hopper bf16
   input gradient (`csrc/mbconv_dx_sm90.cu`, `check_sm90_dx`) on the same
   shapes and on the spatial heights at phase 25d's batch: dx within
   MBCONV_BF16_DX_TOL of max|plain| of the plain dx fed the kernel's own
   masks, every element and mask within `ops/mbconv.dx_rounding_bound`, the
   mask flips against `dx_masks` counted, two launches bit-equal, counted on
   it and not on the instance (the odd shapes outside its rule on the
   instance);
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
   25 bf16 forward launches per serve, all on the Hopper kernel (none on the
   bf16 instance, none of the float32 one), NMS once per serve, the outputs
   checked and timed; the b8 serve with device preprocessing also with
   every bf16 forward on the bf16 instance, in turns (`sm90_ab`);
4. warp kernels vs plain: the four EOT warp kernels (two forward passes and
   both transposes) against their plain versions on the card, on the
   lite4 window, on edge cases, on an image with 16 windows beside images
   with none, and on the b24 live regime's windows, within WARP_TOL of the
   output's scale, and at the frontier's window 448 (16 windows of one
   image, regions of 300 px, the b24 live regime at scale .6); two
   launches of each kernel must be bit-equal, pass 2's forward bit-equal to
   its ablation (`pass2_fwd_ablation`, the thread-per-output kernel) here
   and wherever it is checked, and an image with no window must get an
   exactly zero canvas gradient;
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
   and the plain time, with the windows at r = 1 counted; pass 2's forward
   and its ablation in turns in one profiler session (`pass2_turns`), each
   beside the bound; the ablation never launched on the path (phases 5,
   5b, 9, 9b, 19a, 19b);
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
   step, 50 bf16 forward (all on the Hopper kernel) and 25 bf16 dx launches
   a step (every dx on the Hopper dx) and no float32 MBConv launch; loss and
   patch checked; timed, profiled, peak memory; timed again with the bf16
   forward on the bf16 instance, in turns (`sm90_ab`);
   then phase 5a's check on it (the fused bf16 victim against the unfused
   bf16 one, BF16_VICTIM_TOL, BF16_VICTIM_GRAD_COS and BF16_VICTIM_COS) and
   phase 6a's on the bf16 instances at the bf16 step's own inputs (with
   1a's rounding bounds; bounds with the products at the bf16 rate; beside
   cuDNN's unfused bf16 block; the Hopper forward and dx each in turns with
   its bf16 instance); then the step timed with the bf16 dx on the Hopper
   kernel and on its instance, in turns (`sm90_ab(kind="dx")`);
7b. driver with its defaults (bf16): `attack.train.train` for 3 steps at
   batch 12; only bf16 MBConv launches, every forward and dx on the Hopper
   kernels;
8. cmconv kernels vs plain: both instances of the channel-major 3x3 conv
   (`simt` and the 3xTF32 `tc`) against the plain version at every shape of
   the defender's path at full size (batch 24 at 640x640 and 320x320,
   forward with bias and input gradient), within WARP_TOL of the output's
   scale; two launches bit-equal; the wrapper runs the plan's instance; then
   the bf16 Hopper instance (`csrc/cmconv_bf16_sm90.cu`, the plan's pick) on
   CMCONV_BF16_CASES (the path's shapes at full size, the packed U-Net's
   12 -> 32, 32 -> 32, 32 -> 12, the test file's edge cases and heights 322,
   162, 13 and 1), with the U-Net's kernels (bf16 values in float32) and
   general float32 ones, with and without a bias: every element within
   `ops/cmconv.cmconv_rounding_bound` of the float64 sum and within
   BF16_CMCONV_TOL of the plain version's scale, two launches bit-equal,
   no float32 launch; and the SIMT instance (`csrc/cmconv_bf16.cu`) at the
   path's shapes bit-equal to the bf16 plain version;
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
   step gave them, against their plain versions, the warp kernels timed
   beside their bounds (pass 2's in turns with its ablation);
9b. bf16 defender step: phase 9's step with `config.mixed_precision`
   (bf16 victim and U-Net): 15 bf16 cmconv launches a step, all on the
   Hopper instance, and no float32 one, 25 bf16 fused MBConv forward (on the
   Hopper kernel) and no dx, NMS and the two forward warp passes once; loss
   and metrics checked; timed, profiled, peak memory beside the fp32 step's;
   the step and `recover` with their cmconv on the Hopper instance and on
   the SIMT instance in turns (`cmconv_ab`: host p50 and device busy ms);
   its `eval_step` and `recover` (8 Hopper cmconv launches each) checked and
   timed;
11, bf16: the bf16 instances on the 15 inputs the bf16 step gave them: the
   Hopper instance within the rounding bound, for the step's kernels and
   the same kernels made general float32, two launches bit-equal; the SIMT
   instance bit-equal to the bf16 plain version; each launch timed on both
   in turns beside its bound with 2-byte x, bias and output and the products
   at the bf16 tensor-core rate (the kernels hold bf16 values: checked),
   beside the bound at fp32 FMAs, the plain time and `F.conv2d` in bf16
   (cuDNN) on the same tensors;
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
   timed beside their bounds (pass 2's in turns with its ablation);
   19c: the production soak's attack stage (3 steps) and defender stage (2
   steps of 15 bf16 cmconv launches, all on the Hopper instance, 1 NMS and 25
   bf16 MBConv forward, one eval of 2 batches): recovery PSNR and ADR finite, or NaN only where the
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
   forward (on the Hopper kernel) and 1 NMS launches; AP, AP50, AP75 and the other 9 metrics within
   EVAL_AP_TOL of the same evaluation with the plain versions of both ops
   on the card; AP and
   ms a batch; the NMS kernel and the 25 bf16 forward launches timed at an
   eval batch's inputs beside their bounds and plain versions (the forward
   also beside the bf16 instance);
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
   22a: the int8 conv kernel (`csrc/conv_int8_sm90.cu`) and its SIMT
   ablation (`csrc/conv_int8.cu`) against `conv_int8_plain` on odd shapes
   (a 1x1 map, 13x37, C not a multiple of 4, stride 2 at odd sizes, k5
   depthwise, the pooled [B, C, 1, 1] case, a bias, bf16 x and output,
   VALID, Co over many tiles, K and M tails, explicit pads on halo rows,
   the b1 level-7 5x5 map) and then at every conv call of a b8 int8 serve,
   fp32 and bf16: the int32 sums and the outputs bit-equal, two launches
   bit-equal, one launch a call of the Hopper kernel; each serve call timed
   by CUDA events on a queue filled ahead (device time, not the wrappers'
   host work) with both instances in turns (Hopper, SIMT, SIMT, Hopper)
   beside its bound (int8 products at 1,979 TOPS, bytes at 3.35 TB/s),
   split as the stem, the 1x1 convs and the depthwise convs, the plain
   version, `torch._int_mm` on the 1x1 convs and cuDNN's bf16 conv of the
   same shape; what `F.conv2d` does with int8 CUDA tensors, as a record;
   22b: `Detector.quantize_int8` on 16 seeded 720x1280 frames, fp32 and
   bf16: every eligible conv quantised (no `predict`), a b1 and a b8 serve
   with conv_int8 at one launch a conv call, all of the Hopper kernel (the
   heads' shared convs at each level), NMS once a serve, no fused MBConv
   launch; b8 detections equal to those of the same detector on
   `conv_int8_plain`; against the float serve the largest score difference
   and the top detection's agreement; p50 at b1 and b8 of the float and
   int8 serves in both dtypes, peak memory and the device's busy share; the
   b8 int8 device part's busy ms with each conv_int8 instance in turns;
   22c: `Detector.export` (the float program after `quantize_int8`) fp32
   and bf16 at b1: the graph holds the NMS op once and the fused MBConv op
   25 times; `ExportedProgramDriver.serve` launches them and equals
   `Detector.serve`; export, load and both p50s;
   22d: `python -m ...inference.inspector --mode benchmark --batch-size 8`
   and `--mode dry` (whose checkpoint serves as the seeded detector); the
   victim exported per_class at b8 and `train.eval.evaluate(artifact=)`
   over TFRecords of zlib PNGs (no PIL on the card's machine) equal to the
   live victim's metrics within 1e-6;
23. the packed backbone entry (`models/efficientnet_packed.py`) at JAX's
   lite4 operating point, `packed_entry` 10 (blocks 0-9 packed, the fuseable
   2-4 and 6-8 among them), beside the unpacked net on the same weights:
   23a: `Detector(packed_entry=10)` at b1 and b8, fp32 and bf16, seeded
   weights: head outputs within VICTIM_TOL (bf16 PACKED_BF16_SERVE_TOL) of
   max(1, max|ref|), the top detection agreeing in every image, 19 fused
   forward launches and one unfused block a serve, NMS once; p50 (host path
   and device part), peak memory and busy share of both, and the device
   part with the packed kernels built on every call;
   23b: `PatchAttacker(packed_entry=10)` at b24, window 320, the live
   regime, fp32 and bf16, from the unpacked attacker's state: the loss with
   fixed draws within PACKED_LOSS_REL, the patch gradient at cosine >=
   PACKED_COS, 38 fused forward and 19 dx launches a step (bf16: every dx
   on the Hopper dx); step p50, images/s and peak memory of both;
   23c: one `PatchAttackDefender(packed_entry=10)` step at b24, fp32: loss
   and mean clean score within PACKED_DEFENDER_REL of the unpacked step's,
   19 fused forward launches;
   23d: phase 16's victim written by this script's own TF1 bundle writer
   (`write_tf_bundle`) under the reference's names (raw values off by U(1,
   2), EMA shadows true) and packed as a release tarball; on a machine
   without TensorFlow, `Detector(ckpt_path=<tgz>)` serves b8 detections
   bit-equal to the victim `.pkl`'s and `attack.train.get_victim_variables`
   returns its variables bit-equal; read and convert seconds;
24. data parallelism (`parallel/`): the mesh path in a world-size-1 NCCL
   group against the plain steps (24a), two ranks on the one card through
   gloo against one process (24b), the attack driver at two ranks (24c);
25. spatial partitioning (`parallel/spatial.py`): two ranks on the one card
   through gloo at mesh ('data', 'spatial') = (1, 2), each image's rows
   split over them, against the one-process steps in this process:
   25a: the lite4@640 fp32 b2 serve, host and device preprocessing, classes
   equal, scores within 1e-5 and boxes within 1e-3 px, 25 fused forward
   launches a rank a pass at halo-extended heights and NMS once;
   25b: the b4 fp32 attack step (window 320, the live boxes): loss within
   1e-4 relative, patch-gradient cosine >= 0.9999 and norm within 1e-4, the
   patch after Adam within lr, the ranks' patches bit-equal, each warp
   kernel once, NMS twice, 50 fused forward and 25 dx launches a rank; the
   warp kernels and the fused forward and dx (every fifth block) against
   their plain versions at rank 0's own inputs;
   25c: the float64 b2 supervised step within 1e-8 of scale; the b8 fp32
   step's peak memory a rank below 0.75x the one-process peak, no fused
   launch;
   25d: `attack.train.train(spatial=2)` for 2 steps in bf16 (score threshold
   .0099: live slots), every warp kernel, NMS and the bf16 fused kernels
   launched (every forward and dx on the Hopper kernels), the ranks' patches
   bit-equal; the ranks' peak memory and step
   times (gloo stages the exchanges through the host: no rate of spatial
   partitioning);
   25e: the defender under the same mesh (its steps, eval_step, recover,
   `defense.train.train(spatial=2)`);
   25f: the rest under the same mesh, each against one process: the
   `packed_entry=2` serve at b2 (scores within 1e-5, boxes within 1e-3 px,
   25 fused forward launches a rank, the NMS kernel against the plain
   version on a rank's candidates), the packed b4 fp32 attack step (loss
   within 1e-4 relative, patch-gradient cosine >= 0.9999, the warp and
   fused kernels against their plain versions at a rank's inputs) and the
   packed b8 bf16 step (its peak memory a rank against one process's; every
   fifth Hopper forward and dx against the plain versions); `quantize_int8`
   at b8 (the activation scales bit-equal, one Hopper `conv_int8` launch a
   call, each bit-equal to the plain version at its halo-extended inputs, the
   head outputs at most 1% off by more than 1e-4); the b4 segmentation
   step in float64 (loss and summed gradient within 1e-8 of scale) and fp32
   (loss within 1e-4 relative, the summed gradient no farther from the
   float64 one than twice one process's: the fp32 step is ill-conditioned,
   ROADMAP Queue 3 item 22; a rank's peak memory); the gather backend's rows
   within 1e-6, the regions equal; `attack.train.train(spatial=2,
   packed_entry=2)` for 2 steps (the ranks' patches bit-equal, rank 0 alone
   writing files); every kernel's launches a rank against the expected
   counts;
13. card: the `nvidia-smi` name and power limit, and one JSON line with each
   kernel's launches, error, times and bound (cmconv's also with its
   ablation, the instance the plan did not pick, and its bound at 3xTF32;
   cmconv's bf16 Hopper instance with its per-launch times, the SIMT
   instance's in turns and the defender step's and `recover`'s host and
   device ms on each, and the SIMT instance (0 launches on the path), the
   fused MBConv's float32 and bf16 instances
   and the Hopper bf16 forward (`mbconv_fwd_bf16_sm90`, the bf16 forward's
   main path; the instance's forward row then has 0 launches on it and the
   instance's times in turns with it), each a row; NMS, cmconv and the fused forward also with phase
   20's launches per frame, and NMS and cmconv with their times there; NMS
   and the bf16 fused forward also with phase 21b's launches per
   `evaluate_map` batch and their times at its inputs; NMS, the warp
   kernels and the fused MBConv's float32 rows also with phase 25b's
   launches a rank in the spatial attack step; `conv_int8` (the Hopper
   kernel) with phase 22b's launches in a b1 and a b8 fp32 int8 serve and
   phase 22a's times summed over a b8 serve's calls, split as stem, 1x1 and
   depthwise beside their bounds, `torch._int_mm` as its library time on
   the 1x1 convs, cuDNN's bf16 convs beside it; `conv_int8_simt`, the
   ablation, with 0 launches on the path and its times in turns).

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
# phase 23: the packed entry at JAX's lite4 operating point (bench.py
# --packed-entry 10, docs/PACKED_BACKBONE.md): blocks 0-9 packed, among them
# the fuseable 2-4 and 6-8, so 19 fused blocks a pass and one unfused (21)
PACKED_ENTRY = 10
PACKED_MBCONV_PER_PASS = 19
PACKED_UNFUSED_PER_PASS = 1
# packed against unpacked serve: fp32 head outputs within VICTIM_TOL of
# max(1, max|ref|); bf16 within .05 of it (the packed region rounds after each
# conv, BatchNorm and activation as Flax does, the fused blocks it replaces
# round e once: the two bf16 nets' distance, ROADMAP Queue 3 item 17)
PACKED_BF16_SERVE_TOL = 0.05
PACKED_LOSS_REL = 1e-3
PACKED_COS = 0.999
PACKED_DEFENDER_REL = 1e-4
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
# phase 24: data parallelism (parallel/). 24a: a world-size-1 NCCL group in
# this process, every collective issued; 24b-c: two ranks on the one card
# through gloo (NCCL refuses two ranks on one device; parallel's helpers stage
# the CUDA tensors through the host for gloo). The two-rank times check the
# path; they are not a scaling figure.
DP_STEPS = 2            # 24a: timed steps of each path
DP_SUP_BATCH = 4        # 24b: the float64 supervised step, 2 a rank
DP_SUP_F64_TOL = 1e-9   # of max(1, max|ref|) per leaf (phase 14 read 6.52e-12)
DP_SERVE_FRAMES = 5     # 24b: Detector(mesh=), padded to 6, 3 a rank
DP_LOSS_REL = 1e-4      # 24b: attack and defender losses, relative
DP_SERVE_SCORE_TOL = 1e-5  # 24b: Detector(mesh=) against one process
DP_SERVE_BOX_TOL = 1e-3    # px, as tests/test_parallel.py:95-119
DP_GRAD_COS = 0.9999    # 24b: the attack's patch gradient
DP_TIMEOUT_S = 600.0    # 24b-c: the two ranks' join
# phase 25: spatial partitioning (parallel/spatial.py), two ranks at mesh
# ('data', 'spatial') = (1, 2) on the one card through gloo; each check
# against the one-process step in this process, at the limits of 24b
SP_HW = 640             # lite4's input side: 320 rows a rank
SP_SERVE_BATCH = 2      # 25a: frames served, each image's rows over 2 ranks
SP_ATTACK_BATCH = 4     # 25b: the fp32 attack step
SP_LR = 1e-2            # the attacker's Adam lr: a pixel's first step
SP_SUP64_BATCH = 2      # 25c: the float64 supervised step
SP_SUP_F64_TOL = 1e-8   # of max(1, max|ref|) per leaf
SP_SUP_BATCH = 8        # 25c: the fp32 step whose peak memory is read
SP_PEAK_RATIO = 0.75    # a rank's peak against the one-process peak
SP_TIMEOUT_S = 600.0    # 25: the two ranks' join
# phase 25e: the defender under the same mesh, lite4@640 at full width and
# depth, U-Net n_filters 8, each run against one process in this process.
# The victim's pass and NMS run in every step; their boxes are replaced by
# the live boxes at score .9 (a random victim's near-tied scores would let
# conv rounding move the masker; 25b pins the attack's boxes alike)
SPD_BATCH = 8           # the fp32 and bf16 steps, eval_step and recover
SPD_DRIVER_BATCH = 12   # defense.train.train(spatial=2), bf16, 2 steps
SPD_LOSS_REL = 1e-4     # a step's loss and eval's loss, PSNR and ADR, relative
SPD_GRAD_COS = 0.9999   # the fp32 U-Net gradient summed over the ranks
# bf16: tests/test_torch_spatial_defense.py reads cosine 0.99999399 between
# the bf16 step at (1, 2) and one process on the CPU and holds it to this
# limit; one run of this phase on an H100 80GB HBM3 at 700 W read 0.99997441
SPD_BF16_GRAD_COS = 0.999
SPD_RECOVER_TOL = 2e-4  # recover's rows, of max(1, max|ref|)
SPD_HEIGHTS = [SP_HW // 4 + 2, SP_HW // 2 + 2]  # cmconv shards plus 2 halo rows
# phase 25f: the packed entry, the int8 serve, the segmentation step, the
# gather backend and the packed attack driver under the same mesh, each run
# against one process in this process
SPR_PACKED = 2          # packed_entry of 25f's serve, attack steps and driver
SPR_PEAK_BATCH = 8      # the bf16 packed attack step whose peak memory is read
SPR_INT8_BATCH = 8      # the int8 serve: frames calibrated on and served
SPR_SEG_BATCH = 4       # the fp32 segmentation step
SPR_DRIVER_BATCH = 4    # attack.train.train(spatial=2, packed_entry=2), 2 steps
SPR_GATHER_TOL = 1e-6   # the gather backend's rows against one process
SPR_INT8_SHARE = 0.01   # the int8 head outputs: at most 1% off by more than
SPR_INT8_ATOL = 1e-4    # 1e-4 (ROADMAP Queue 3 item 28)
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
    ("K tail C 40, M tail 169", 1, 40, 13, 13, 56, 1, 1, "SAME", False, True, "bfloat16"),
    ("M tail 432", 3, 40, 12, 12, 24, 1, 1, "SAME", False, False, "float32"),
    ("Co 300 over two 160-channel tiles", 1, 32, 130, 130, 300, 1, 1, "SAME", False, True,
     "float32"),
    ("stem on halo rows", 1, 3, 321, 640, 32, 3, 2, ((0, 0), (0, 1)), False, True,
     "float32"),
    ("k3 s2 depthwise on halo rows", 2, 144, 81, 160, 144, 3, 2, ((0, 0), (0, 1)), True,
     True, "bfloat16"),
    ("b1 level-7 5x5 1x1", 1, 224, 5, 5, 224, 1, 1, "SAME", False, True, "float32"),
    ("b1 level-7 5x5 depthwise", 1, 224, 5, 5, 224, 3, 1, "SAME", True, True, "bfloat16"),
]
CONV_INT8_INSTANCES = ("sm90", "simt")  # the path's kernel, then its ablation
# the cmconv instances (ops/cmconv_cuda.ENTRIES) and their kernels' names
CMCONV_INSTANCES = ("simt", "tc")
CMCONV_KERNEL = {"simt": "cmconv3x3_kernel", "tc": "cmconv3x3_tc_kernel"}
# the bf16 instances: the Hopper kernel the plan picks and the SIMT instance
CMCONV_BF16_KERNEL = {"sm90": "cmconv3x3_bf16_sm90_kernel", "simt": "cmconv3x3_kernel"}
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
# (name, B, C, Co, H, W) of phase 8's bf16 cases: the path's shapes at full size (each
# (C, Co, side) of CMCONV_SHAPES once), the packed U-Net's level-1 convs at b24 on the
# 320 grid, the edge cases of tests/test_torch_cuda.py (W 37, 33, 9, 1, 36; x off 16-byte
# alignment) and heights off every tile height: 322 and 162, a two-way row shard of 640
# and 320 with a halo row each side, and 13 and 1
CMCONV_BF16_CASES = (
    [(f"path {c}->{co} at {side}", DEFEND_BATCH, c, co, side, side)
     for c, co, side in dict.fromkeys((c, co, side) for _, c, co, side in CMCONV_SHAPES)]
    + [(f"packed {c}->{co} at 320", DEFEND_BATCH, c, co, 320, 320)
       for c, co in ((12, 32), (32, 32), (32, 12))]
    + [("ragged_13x37", 2, 8, 8, 13, 37), ("1x1", 3, 8, 16, 1, 1), ("b1", 1, 16, 16, 24, 40),
       ("c1", 2, 1, 8, 20, 20), ("c32_co32", 1, 32, 32, 17, 33), ("co1", 2, 8, 1, 9, 9),
       ("co3", 2, 5, 3, 10, 11), ("co20", 1, 12, 20, 8, 70), ("w_even_not_8", 2, 8, 8, 12, 36),
       ("misaligned_x", 2, 8, 16, 9, 24)]
    + [("h322 8->8", DEFEND_BATCH, 8, 8, 322, 640), ("h162 16->32", DEFEND_BATCH, 16, 32, 162, 320),
       ("h13 3->8", 2, 3, 8, 13, 640), ("h1 32->16", 2, 32, 16, 1, 320)])


START = time.perf_counter()


def mark(label: str) -> None:
    """Print the seconds since the script started, at the start of a phase."""
    print(f"[{time.perf_counter() - START:.1f} s] {label}", flush=True)


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


def queued_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    """Mean device milliseconds per call of fn by CUDA events, the stream's
    queue filled ahead: a spin kernel of about a millisecond holds the card
    while the host enqueues the calls, so the events time the calls back to
    back (with the gaps between launches) and not the host's work between
    them, as `cuda_ms` does where a call is shorter than its host work."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
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


def profile_device(fn, label: str, top: int = 6, sessions: int = 3):
    """One traced call of fn: device busy share of the wall time, top kernels.
    A session that records no device activity is tried again, up to
    `sessions` times, and then reported as not measured (None). Returns the
    busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
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
        return None
    launches = sum(e.count for e in kernels)
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%), {launches} kernel launches; the "
          f"profile took {time.perf_counter() - start:.1f} s with its warm-up call and "
          f"the trace's processing")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")
    return busy_us / wall_us


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


def kernel_turns_ms(fns: dict, iters: int = 10, sessions: int = 3) -> dict:
    """{key: mean device ms per launch} of the CUDA kernel whose name
    contains `key`, launched by fns[key], from one torch.profiler session in
    which the calls run in turns: each `iters` times in order, then again in
    the reverse order (A, B, B, A). A session that records no device time of
    one of them is tried again; after `sessions` such ones each is timed by
    CUDA events in the same turns (host work between launches included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    order = list(fns) + list(fns)[::-1]
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for key in order:
                for _ in range(iters):
                    fns[key]()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out = {}
        for key in fns:
            hits = [e for e in events if key in e.key]
            total_us = sum(e.self_device_time_total for e in hits)
            count = sum(e.count for e in hits)
            if count and total_us > 0:
                out[key] = total_us / 1e3 / count
        if len(out) == len(fns):
            return out
        print(f"  profiler session {attempt} of {sessions} saw no device time of "
              f"{sorted(set(fns) - set(out))}")
    times = {key: [] for key in fns}
    for key in order:
        times[key].append(cuda_ms(fns[key], iters=max(iters, 10)))
    print(f"  {list(fns)}: timed by CUDA events instead, in turns (host work "
          f"between launches included)")
    return {key: sum(v) / len(v) for key, v in times.items()}


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
MAIN_PATH_LIBS = ("nms", "warp", "cmconv", "cmconv_bf16", "cmconv_bf16_sm90", "cmconv_tc", "mbconv",
                  "mbconv_dx", "mbconv_bf16", "mbconv_bf16_dx", "mbconv_fwd_sm90",
                  "mbconv_dx_sm90")


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
    check_pass2_ablation(name, t, table, out)
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
    check_pass2_ablation(name, t_in, table, out)
    return errs


def check_pass2_ablation(name, t, table, out) -> None:
    """pass2_fwd's output `out` bit-equal to its ablation's on the same t:
    the same taps summed in the same order, plus taps that are zero."""
    import torch
    from mladversarialobjectdetection_torch.ops import warp_cuda

    if not torch.equal(warp_cuda.pass2_fwd_ablation(t, table), out):
        fail(f"warp {name} pass2_fwd: differs from its ablation, the thread-per-output kernel")


def no_ablation(label: str) -> None:
    """The run since the last count reset launched no warp ablation."""
    from mladversarialobjectdetection_torch.ops import warp_cuda

    if any(warp_cuda.ABLATION_LAUNCHES.values()):
        fail(f"{label}: the path launched the pass 2 ablation "
             f"{warp_cuda.ABLATION_LAUNCHES}")


def pass2_turns(t, table, iters: int = 10):
    """(kernel ms, ablation ms): the device ms per launch of pass2_fwd's
    kernel and of its ablation on the same inputs, in turns."""
    from mladversarialobjectdetection_torch.ops import warp_cuda

    ms = kernel_turns_ms({"pass2_fwd_kernel": lambda: warp_cuda.pass2_fwd(t, table),
                          "pass2_fwd_per_output_kernel":
                              lambda: warp_cuda.pass2_fwd_ablation(t, table)}, iters)
    return ms["pass2_fwd_kernel"], ms["pass2_fwd_per_output_kernel"]


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


def check_cmconv_sm90(name, x, w, bias, kern, plain) -> float:
    """The Hopper bf16 instance against the bf16 function: within
    BF16_CMCONV_TOL of the plain version's scale, and every element within
    `ops/cmconv.cmconv_rounding_bound` of the float64 sum (its float32 sums
    of each weight's bf16 hi and lo terms run in another order than the plain
    version's, so it is not bit-equal to it)."""
    from mladversarialobjectdetection_torch.ops import cmconv

    if kern.dtype != plain.dtype or kern.shape != plain.shape:
        fail(f"{name}: kernel {kern.dtype} {tuple(kern.shape)}, plain "
             f"{plain.dtype} {tuple(plain.shape)}")
    err = float((kern.float() - plain.float()).abs().max())
    scale = max(1.0, float(plain.float().abs().max()))
    if not err <= BF16_CMCONV_TOL * scale:
        fail(f"{name}: kernel and plain differ by {err} > {BF16_CMCONV_TOL} * {scale}")
    over = (kern.double() - cmconv.cmconv_sum64(x, w, bias)).abs() - \
        cmconv.cmconv_rounding_bound(x, w, bias)
    outside = int((over > 0).sum())
    if outside:
        fail(f"{name}: {outside} elements outside cmconv_rounding_bound (by up to "
             f"{float(over.max())})")
    return err


def cmconv_sm90_route(label: str, n: int) -> None:
    """Fail unless the run since the last count reset sent its n bf16 cmconv
    launches to the Hopper instance and none to the SIMT instance."""
    from mladversarialobjectdetection_torch.ops import cmconv_cuda
    got = {k: v for k, v in cmconv_cuda.PLAN_LAUNCHES.items() if k.endswith("_bf16")}
    if got != {"simt_bf16": 0, "sm90_bf16": n}:
        fail(f"{label}: bf16 cmconv launches by instance {got}, want {n} of the Hopper "
             f"instance and none of the SIMT instance")


class CmconvInstanceRoute:
    """In its block every bf16 cmconv runs the SIMT instance (`csrc/cmconv_bf16.cu`):
    the ablation that `cmconv_ab` times in turns with the Hopper instance."""

    def __enter__(self):
        import torch
        from mladversarialobjectdetection_torch.ops import cmconv_cuda
        self.orig = cmconv_cuda.plan

        def simt(c, co, h, w, dtype=torch.float32):
            pick = self.orig(c, co, h, w, dtype)
            return pick._replace(instance="simt") if dtype == torch.bfloat16 else pick
        cmconv_cuda.plan = simt
        return self

    def __exit__(self, *exc):
        from mladversarialobjectdetection_torch.ops import cmconv_cuda
        cmconv_cuda.plan = self.orig


def device_busy_ms(fn, sessions: int = 3):
    """Device ms (the sum of every kernel's time, torch.profiler) of one call
    of fn after a warm-up call; None where no session saw device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy > 0:
            return busy / 1e3
    return None


def cmconv_ab(label: str, fn, iters: int = 3) -> dict:
    """fn (ending in a synchronize) with its bf16 cmconv launches on the
    Hopper instance and on the SIMT instance, in turns (Hopper, instance,
    instance, Hopper): host p50 ms and device busy ms of each, printed and
    returned as {"host_ms": (Hopper, instance), "busy_ms": (Hopper,
    instance)}."""
    host, busy = [], []
    for on_instance in (False, True, True, False):
        with CmconvInstanceRoute() if on_instance else contextlib.nullcontext():
            host.append(host_p50_ms(fn, iters=iters, warmup=1))
            busy.append(device_busy_ms(fn))
    out = {"host_ms": ((host[0] + host[3]) / 2, (host[1] + host[2]) / 2)}
    out["busy_ms"] = (None if None in busy else
                      ((busy[0] + busy[3]) / 2, (busy[1] + busy[2]) / 2))
    print(f"  {label}, bf16 cmconv on the Hopper instance vs the SIMT instance in turns: host "
          f"p50 {out['host_ms'][0]:.3f} vs {out['host_ms'][1]:.3f} ms (turns "
          f"{[round(v, 3) for v in host]}); device busy "
          + ("not measured" if out["busy_ms"] is None else
             f"{out['busy_ms'][0]:.3f} vs {out['busy_ms'][1]:.3f} ms (turns "
             f"{[round(v, 3) for v in busy]}), {out['busy_ms'][1] - out['busy_ms'][0]:.3f} ms"))
    return out


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


def check_mbconv(name, x, g, fb, act_type, residual, fwd=None, dx_fn=None, dx_bound=False):
    """Both fused MBConv kernels against the plain versions on the same CUDA
    tensors, each launched twice bit-equal, in x's dtype (float32, or bf16
    with a bf16 fold and the MBCONV_BF16_* tolerances; there every forward
    output must also lie within the roundings the bf16 function allows,
    `ops/mbconv.rounding_bound`). For relu6 / relu, dx is held to the plain
    dx fed the masks the kernel's masks instance wrote, and every mask that
    differs from the plain version's must lie within the kink tolerance of
    its kink. Returns (fwd error, dx error, (z0 flips, z1 flips, worst flip
    distance of scale), the forward's `RoundingBound` or None). `fwd` is
    the forward's wrapper, `mbconv_fwd_cuda` by default (bf16: the Hopper
    kernel where its rule takes the shape), `dx_fn` dx's, `mbconv_dx_cuda`
    by default (bf16: the Hopper dx where its rule takes the shape). With
    `dx_bound` (bf16, relu6 / relu), dx and its masks must also lie within
    `ops/mbconv.dx_rounding_bound`."""
    import torch
    from mladversarialobjectdetection_torch.ops import mbconv, mbconv_cuda
    fwd = fwd or mbconv_cuda.mbconv_fwd_cuda
    dx_fn = dx_fn or mbconv_cuda.mbconv_dx_cuda

    bf16 = x.dtype == torch.bfloat16
    fwd_tol, dx_tol, kink_tol = ((MBCONV_BF16_FWD_TOL, MBCONV_BF16_DX_TOL,
                                  MBCONV_BF16_KINK_TOL) if bf16 else
                                 (MBCONV_FWD_TOL, MBCONV_DX_TOL, MBCONV_KINK_TOL))
    kw = dict(act_type=act_type, residual=residual)
    y = fwd(x, fb, **kw)
    dx = dx_fn(x, g, fb, **kw)
    plain_y = mbconv.mbconv_plain(x, fb, **kw)
    rounding = mbconv.rounding_bound(y, x, fb, **kw) if bf16 else None
    if rounding is not None and rounding.outside:
        fail(f"mbconv fwd {name}: {rounding.outside} outputs lie beyond every rounding "
             f"of the bf16 function within float32 distance of a boundary ({rounding})")
    flips = (0, 0, 0.0)
    if act_type in ("relu6", "relu"):
        b, h, w, _ = x.shape
        masks = torch.empty((2, b, h, w, fb.we.shape[1]), dtype=torch.uint8, device=x.device)
        dx_fn(x, g, fb, masks_out=masks, **kw)
        plain_masks, z0, z1 = mbconv.dx_masks(x, fb, act_type=act_type)
        flips = mbconv.kink_flips(masks, plain_masks, z0, z1, act_type)
        del plain_masks, z0, z1
        plain_dx = mbconv.mbconv_dx_plain(x, g, fb, masks=masks, **kw)
        if dx_bound:
            db = mbconv.dx_rounding_bound(dx, x, g, fb, masks=masks, **kw)
            if db.outside or db.mask_faults:
                fail(f"mbconv dx {name}: {db.outside} elements beyond the roundings of the "
                     f"bf16 function, {db.mask_faults} masks beyond the sums' error ({db})")
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
    if not (torch.equal(fwd(x, fb, **kw), y)
            and torch.equal(dx_fn(x, g, fb, **kw), dx)):
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


# the heights of lite4@640's 7 fused block shapes (`ops/mbconv_sweep.LITE4_FUSED`:
# H, W, C, E, Co, k, residual) on a rank of phase 25's two-way spatial split
# (each shard plus one halo of k // 2 rows)
LITE4_SPATIAL = [(81, 160, 32, 192, 32, 3, True), (42, 80, 56, 336, 56, 5, True),
                 (21, 40, 112, 672, 112, 3, True), (22, 40, 160, 960, 160, 5, True),
                 (11, 20, 272, 1632, 272, 5, True), (12, 20, 272, 1632, 448, 3, False)]


def check_sm90(name, x, fb, act_type, residual):
    """The Hopper bf16 forward (`csrc/mbconv_fwd_sm90.cu`) against the bf16
    plain version on the same CUDA tensors: within MBCONV_BF16_FWD_TOL of
    max(1, max|plain|), every output within `ops/mbconv.rounding_bound`, two
    launches bit-equal, both counted on the Hopper kernel and none on the
    bf16 instance. Returns (largest absolute error, RoundingBound, plan)."""
    import torch
    from mladversarialobjectdetection_torch.ops import mbconv, mbconv_cuda

    kw = dict(act_type=act_type, residual=residual)
    b, h, w, c = x.shape
    e, co = fb.wp.shape
    plan = mbconv_cuda.plan_fwd_sm90(h, w, c, e, co, fb.wd.shape[0], b)
    if plan is None:
        fail(f"mbconv sm90 {name}: the Hopper kernel's rule refuses the shape")
    before = dict(mbconv_cuda.BF16_FWD_LAUNCHES)
    y = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    again = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in mbconv_cuda.BF16_FWD_LAUNCHES.items()}
    if got != {"sm90": 2, "instance": 0}:
        fail(f"mbconv sm90 {name}: launches by kernel {got}")
    if not torch.equal(y, again):
        fail(f"mbconv sm90 {name}: two launches differ")
    ref = mbconv.mbconv_plain(x, fb, **kw).float()
    err = float((y.float() - ref).abs().max())
    limit = MBCONV_BF16_FWD_TOL * max(1.0, float(ref.abs().max()))
    rb = mbconv.rounding_bound(y, x, fb, **kw)
    if not err <= limit or rb.outside:
        fail(f"mbconv sm90 {name}: {err:.3g} from plain (limit {limit:.3g}), "
             f"{rb.outside} outputs beyond the roundings ({rb})")
    return err, rb, plan


def check_sm90_dx(name, x, g, fb, act_type, residual):
    """The Hopper bf16 input gradient (`csrc/mbconv_dx_sm90.cu`) against the
    bf16 plain dx on the same CUDA tensors: for relu6 / relu the first launch
    writes the kernel's masks, dx is held to the plain dx fed them, every
    element and every mask within `ops/mbconv.dx_rounding_bound` and each
    mask flip against `dx_masks` counted; within MBCONV_BF16_DX_TOL of
    max|plain|; two launches bit-equal, both counted on the Hopper kernel
    and none on the bf16 instance. Returns (largest absolute error,
    DxRoundingBound, (z0 flips, z1 flips, worst flip distance of scale),
    plan)."""
    import torch
    from mladversarialobjectdetection_torch.ops import mbconv, mbconv_cuda

    kw = dict(act_type=act_type, residual=residual)
    b, h, w, c = x.shape
    e, co = fb.wp.shape
    plan = mbconv_cuda.plan_dx_sm90(h, w, c, e, co, fb.wd.shape[0], b)
    if plan is None:
        fail(f"mbconv dx sm90 {name}: the Hopper dx's rule refuses the shape")
    relu = act_type in ("relu6", "relu")
    masks = torch.empty((2, b, h, w, e), dtype=torch.uint8, device=x.device) if relu else None
    before = dict(mbconv_cuda.BF16_DX_LAUNCHES)
    dx = mbconv_cuda.mbconv_dx_cuda(x, g, fb, masks_out=masks, **kw)
    again = mbconv_cuda.mbconv_dx_cuda(x, g, fb, **kw)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in mbconv_cuda.BF16_DX_LAUNCHES.items()}
    if got != {"sm90": 2, "instance": 0}:
        fail(f"mbconv dx sm90 {name}: launches by kernel {got}")
    if not torch.equal(dx, again):
        fail(f"mbconv dx sm90 {name}: two launches differ")
    flips = (0, 0, 0.0)
    if relu:
        plain_masks, z0, z1 = mbconv.dx_masks(x, fb, act_type=act_type)
        flips = mbconv.kink_flips(masks, plain_masks, z0, z1, act_type)
        del plain_masks, z0, z1
    ref = mbconv.mbconv_dx_plain(x, g, fb, masks=masks, **kw).float()
    err = float((dx.float() - ref).abs().max())
    limit = MBCONV_BF16_DX_TOL * float(ref.abs().max())
    del ref
    db = mbconv.dx_rounding_bound(dx, x, g, fb, masks=masks, **kw)
    if not err <= limit or db.outside or db.mask_faults or not flips[2] <= MBCONV_BF16_KINK_TOL:
        fail(f"mbconv dx sm90 {name}: {err:.3g} from plain (limit {limit:.3g}), "
             f"{db.outside} elements beyond the roundings, {db.mask_faults} masks beyond the "
             f"sums' error ({db}), mask flips {flips}")
    return err, db, flips, plan


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
        errs = check_mbconv(f"{label} block {idx} step inputs", x, g, fb, **kw,
                            dx_bound=bf16)
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
        inst_fns = {"fwd": lambda: mbconv_cuda.mbconv_fwd_bf16_instance(x, fb, **kw),
                    "dx": lambda: mbconv_cuda.mbconv_dx_bf16_instance(x, g, fb, **kw)}
        for kind, (kern_fn, simt_fn) in fns.items():
            if bf16:
                # the Hopper kernel and the template's bf16 instance, in turns
                inst_fn = inst_fns[kind]
                t = [cuda_ms(kern_fn, iters=5), cuda_ms(inst_fn, iters=3),
                     cuda_ms(inst_fn, iters=3), cuda_ms(kern_fn, iters=5)]
                times[kind] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
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
            simt = (f", bf16 instance {simt_ms:.4f}" if bf16 else
                    f", SIMT ablation {simt_ms:.4f} (off the kernel by "
                    f"{simt_err[kind]:.3g} of scale)")
            if bf16:
                p = (mbconv_cuda.plan_fwd_sm90 if kind == "fwd" else mbconv_cuda.plan_dx_sm90)(
                    h_, w_, c_, e, co, k, b_)
                plan_s = (f"sm90 {p.th}x{p.tw} ec {p.ec} {p.minb} a SM wn {p.wn} "
                          f"split {p.split}")
            else:
                plan_s = f"{p.th}x{p.tw} npw {p.npw} split {p.split} slice {p.n_per_slice}"
            line.append(f"{kind} kernel {kern_ms:.4f} ms (plan {plan_s}){simt}, plain "
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
        if bf16:
            tot["instance_ms"] = tot.pop("simt_ms")
            print(f"  mbconv bf16 {kind} per pass: the Hopper kernel {tot['ms']:.4f} ms against "
                  f"the template's bf16 instance {tot['instance_ms']:.4f} ms in turns "
                  f"({tot['instance_ms'] / tot['ms']:.2f}x), bound {tot['bound_ms']:.6f} ms "
                  f"({tot['bound_ms'] / tot['ms']:.1%} of the kernel)")
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


# kind: the bf16 forward (`csrc/mbconv_fwd_sm90.cu`) or the bf16 input
# gradient (`csrc/mbconv_dx_sm90.cu`): its launch counts by kernel and its
# planner, which the instance routes replace
SM90_KINDS = {"fwd": ("BF16_FWD_LAUNCHES", "plan_fwd_sm90", "forward"),
              "dx": ("BF16_DX_LAUNCHES", "plan_dx_sm90", "input gradient")}


def sm90_route(label: str, n: int, kind: str = "fwd") -> dict:
    """Fail unless the run since the last count reset sent its n bf16 fused
    forward (kind "dx": input gradient) launches to the Hopper kernel and
    none to the template's bf16 instance (every lite4 shape is one the
    Hopper kernels take). Returns the counts."""
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    counts, _, what = SM90_KINDS[kind]
    got = dict(getattr(mbconv_cuda, counts))
    if got != {"sm90": n, "instance": 0}:
        fail(f"{label}: bf16 fused {what} launches by kernel {got}, want {n} of "
             f"the Hopper kernel and none of the bf16 instance")
    return got


class InstanceRoute:
    """In its block every bf16 fused forward (kind "dx": input gradient)
    runs the template's bf16 instance (`mbconv_bf16.cu`, `mbconv_bf16_dx.cu`):
    the Hopper kernel's rule takes no shape. The ablation that `sm90_ab`
    times in turns with the main path."""

    def __init__(self, kind: str = "fwd"):
        self.planner = SM90_KINDS[kind][1]

    def __enter__(self):
        from mladversarialobjectdetection_torch.ops import mbconv_cuda
        self.mod, self.orig = mbconv_cuda, getattr(mbconv_cuda, self.planner)
        setattr(mbconv_cuda, self.planner, lambda *args, **kwargs: None)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.planner, self.orig)


def sm90_ab(label: str, fn, iters: int = 3, kind: str = "fwd") -> tuple:
    """The host p50 ms of fn (ending in a synchronize) with its bf16 fused
    forwards (kind "dx": input gradients) on the Hopper kernel and on the
    bf16 instance, in turns (Hopper, instance, instance, Hopper); printed and
    returned as (Hopper ms, instance ms)."""
    t = []
    for on_instance in (False, True, True, False):
        with InstanceRoute(kind) if on_instance else contextlib.nullcontext():
            t.append(host_p50_ms(fn, iters=iters, warmup=1))
    new, old = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"  {label}: {new:.3f} ms with the Hopper bf16 {SM90_KINDS[kind][2]}, {old:.3f} ms "
          f"with the bf16 instance (p50s in turns {[round(v, 3) for v in t]}): "
          f"{old - new:.3f} ms, {old / new:.3f}x")
    return new, old


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
    and cmconv ones split by dtype (`cmconv_bf16_simt`: the bf16 ones the
    plan sent to the SIMT instance, none on any path)."""
    from mladversarialobjectdetection_torch.ops import (
        cmconv_cuda, mbconv_cuda, nms_cuda, warp_cuda)
    mb = mbconv_cuda.DTYPE_LAUNCHES
    return dict(warp_cuda.LAUNCHES, nms=nms_cuda.LAUNCHES,
                mbconv_fwd_bf16=mb["bfloat16"]["mbconv_fwd"],
                mbconv_dx_bf16=mb["bfloat16"]["mbconv_dx"],
                mbconv_fp32=sum(mb["float32"].values()),
                cmconv_bf16=cmconv_cuda.DTYPE_LAUNCHES["bfloat16"],
                cmconv_bf16_simt=cmconv_cuda.PLAN_LAUNCHES["simt_bf16"],
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
                    cmconv_bf16=0, cmconv_bf16_simt=0, cmconv_fp32=0)
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
    no_ablation("phase 19a")
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
    no_ablation("phase 19b")
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
            if k == "pass2_fwd":
                kern_ms, ablation_ms = pass2_turns(t_in, table)
            else:
                kern_ms = kernel_device_ms(kern_fn, f"{k}_kernel")
            plain_ms = cuda_ms(plain_fn, iters=3, warmup=1)
            bound_ms, bound_by, nbytes, ops = bounds[k]
            print(f"  warp {k} at window {w}, a frontier step's {table.shape[0]} "
                  f"windows (scale .6, p0 {p0}, {n_img} canvases, "
                  f"{int((table[:, 6] == 1).sum())} at r = 1): kernel "
                  f"{kern_ms:.4f} ms on the card, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} fp32 ops), "
                  f"{bound_ms / kern_ms:.1%} of the bound; max error {errs[k]:.3g}")
            if k == "pass2_fwd":
                print(f"  warp pass2_fwd's ablation in turns with it: {ablation_ms:.4f} "
                      f"ms, {bound_ms / ablation_ms:.1%} of the bound; the kernel "
                      f"{ablation_ms / kern_ms:.3f}x faster")
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
        if (got["cmconv_bf16"], got["cmconv_bf16_simt"], got["cmconv_fp32"], got["nms"],
                got["mbconv_fwd_bf16"], got["mbconv_fp32"]) != (
                    CMCONV_PER_STEP, 0, 0, 1, MBCONV_PER_PASS, 0):
            fail(f"phase 19c: a defender step launched {got}")
    if scounts["cmconv_bf16_simt"]:
        fail(f"phase 19c: {scounts['cmconv_bf16_simt']} bf16 cmconv launches on the SIMT "
             f"instance")
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
    sm90_route("phase 21b", EVAL_BATCHES * MBCONV_PER_PASS)
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
    mb = dict.fromkeys(("ms", "plain_ms", "bytes_ms", "ops_ms", "instance_ms"), 0.0)
    mb_err = 0.0
    with torch.no_grad():
        for (x, fb), kw in fwd:
            kw = dict(act_type=kw["act_type"], residual=kw["residual"])
            kern = mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw)
            ref = mbconv.mbconv_plain(x, fb, **kw)
            mb_err = max(mb_err, float((kern.float() - ref.float()).abs().max())
                         / max(1.0, float(ref.float().abs().max())))
            mb["ms"] += cuda_ms(lambda: mbconv_cuda.mbconv_fwd_cuda(x, fb, **kw), iters=10)
            mb["instance_ms"] += cuda_ms(
                lambda: mbconv_cuda.mbconv_fwd_bf16_instance(x, fb, **kw), iters=5)
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
          f"{mb['ms']:.4f} ms on the Hopper kernel (bound {mb['bound_ms']:.6f} ms, "
          f"{mb['bound_by']}; plain {mb['plain_ms']:.4f} ms; the template's bf16 instance "
          f"{mb['instance_ms']:.4f} ms), max error {mb_err:.3g} of scale")
    eval_ab = sm90_ab("evaluate_map, one batch",
                      lambda: sup.evaluate_map(tr, st, batches(), 1,
                                               score_thresh=DEFEND_THRESH))
    del tr, st, pool, cap, fwd
    torch.cuda.empty_cache()
    return {"launches_per_batch": {"nms": 1, "mbconv_fwd_bf16": MBCONV_PER_PASS},
            "ms_per_batch": 1e3 * eval_s / EVAL_BATCHES, "AP": res["AP"],
            "nms_ms": nms_ms, "nms_bound_ms": nms_bound_ms, "nms_err": nms_err,
            "mbconv": mb, "mbconv_err": mb_err, "sm90_ab_ms": eval_ab}


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


class SimtInt8:
    """In its block every int8 conv of the int8 serve launches the SIMT
    ablation (`conv_int8.cu`, instance "simt"), not the Hopper kernel."""

    def __enter__(self):
        from mladversarialobjectdetection_torch.ops import conv_int8
        self.mod, self.orig = conv_int8, conv_int8.conv_int8_cuda
        orig = self.orig
        conv_int8.conv_int8_cuda = lambda *a, **kw: orig(*a, instance="simt", **kw)
        return self

    def __exit__(self, *exc):
        self.mod.conv_int8_cuda = self.orig


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


def check_conv_int8(name, x, a_s, wq, scale, bias, kw, instances=("sm90",)) -> None:
    """Each instance's int32 sums and output bit-equal to the plain
    version's, and two launches bit-equal; the Hopper instance one launch a
    call. Fails otherwise."""
    import torch
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    geo = {k: kw[k] for k in ("stride", "padding", "groups") if k in kw}
    plain_sums = ci.sums_plain(ci.quantize_plain(x, a_s), wq, **geo)
    plain = ci.conv_int8_plain(x, a_s, wq, scale, bias, **kw)
    for inst in instances:
        launches = ci.INSTANCE_LAUNCHES[inst]
        sums = ci.sums_cuda(x, a_s, wq, instance=inst, **geo)
        y = ci.conv_int8_cuda(x, a_s, wq, scale, bias, instance=inst, **kw)
        y2 = ci.conv_int8_cuda(x, a_s, wq, scale, bias, instance=inst, **kw)
        torch.cuda.synchronize()
        if not torch.equal(sums, plain_sums):
            fail(f"{name}: {inst} int32 sums differ from the plain version's in "
                 f"{int((sums != plain_sums).sum())} places")
        if y.dtype != plain.dtype or not torch.equal(y, plain):
            fail(f"{name}: {inst} output differs from the plain version's by "
                 f"{float((y.float() - plain.float()).abs().max())}")
        if not torch.equal(y, y2):
            fail(f"{name}: two {inst} launches differ")
        if inst == "sm90" and ci.INSTANCE_LAUNCHES[inst] != launches + 3:
            fail(f"{name}: {ci.INSTANCE_LAUNCHES[inst] - launches} Hopper launches in 3 calls")


def int8_part(wq, kw) -> str:
    """The part of the int8 serve a conv belongs to: stem, 1x1 or depthwise."""
    if kw.get("groups", 1) != 1:
        return "depthwise"
    return "1x1" if tuple(wq.shape[2:]) == (1, 1) else "stem"


def int8_numbers(calls) -> dict:
    """The int8 conv kernel at a serve's own inputs (its captured calls):
    each call held bit-equal to the plain version with both instances, then
    timed by CUDA events on a queue filled ahead (`queued_ms`: device time,
    not the wrappers' host work) with the Hopper kernel and the SIMT
    ablation in turns (Hopper, SIMT, SIMT, Hopper; each the mean of its two
    turns) beside its bound, the plain version (`cuda_ms`), `torch._int_mm`
    (cuBLASLt's int8 product on x quantised beforehand: the 1x1 convs only)
    and cuDNN's bf16 conv of the same shape on x padded beforehand, both
    timed as the kernel; summed in all and by part (stem, 1x1, depthwise)."""
    import torch
    import torch.nn.functional as F
    from mladversarialobjectdetection_torch.models.efficientnet import pad_same
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    parts = ("stem", "1x1", "depthwise")
    tot = dict(ms=0.0, simt_ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, intmm_ms=0.0,
               intmm_kernel_ms=0.0, cudnn_bf16_ms=0.0, n_intmm=0, n=0,
               **{f"{p}_{k}": 0.0 for p in parts for k in ("ms", "simt_ms", "bound_ms")},
               **{f"n_{p}": 0 for p in parts})
    for i, call in enumerate(calls):
        x, a_s, wq, scale, bias, kw = int8_call(call)
        check_conv_int8(f"phase 22a serve conv {i}", x, a_s, wq, scale, bias, kw,
                        CONV_INT8_INSTANCES)
        turns = {inst: 0.0 for inst in CONV_INT8_INSTANCES}
        for inst in ("sm90", "simt", "simt", "sm90"):
            turns[inst] += queued_ms(lambda: ci.conv_int8_cuda(x, a_s, wq, scale, bias,
                                                               instance=inst, **kw)) / 2
        ms, simt_ms = turns["sm90"], turns["simt"]
        tot["ms"] += ms
        tot["simt_ms"] += simt_ms
        tot["plain_ms"] += cuda_ms(lambda: ci.conv_int8_plain(x, a_s, wq, scale, bias, **kw),
                                   iters=1, warmup=0)  # the check ran it
        _, _, _, _, bytes_ms, ops_ms = conv_int8_bound(x, wq, bias, kw)
        tot["bytes_ms"] += bytes_ms
        tot["ops_ms"] += ops_ms
        part = int8_part(wq, kw)
        tot[f"n_{part}"] += 1
        tot[f"{part}_ms"] += ms
        tot[f"{part}_simt_ms"] += simt_ms
        tot[f"{part}_bound_ms"] += max(bytes_ms, ops_ms)
        stride = kw.get("stride", 1)
        xb, wb = x.to(torch.bfloat16), wq.to(torch.bfloat16)
        xb = pad_same(xb, wq.shape[2:], stride if isinstance(stride, tuple) else (stride,) * 2)
        tot["cudnn_bf16_ms"] += queued_ms(lambda: F.conv2d(xb, wb, None, stride, 0, 1,
                                                           kw.get("groups", 1)))
        if part == "1x1":
            xq = ci.quantize_plain(x, a_s).permute(0, 2, 3, 1).reshape(-1, x.shape[1]).contiguous()
            wt = wq[:, :, 0, 0].t().contiguous()
            try:
                torch._int_mm(xq, wt)
            except RuntimeError:
                xq = None  # shapes cuBLASLt's int8 product refuses
            if xq is not None:
                tot["n_intmm"] += 1
                tot["intmm_ms"] += queued_ms(lambda: torch._int_mm(xq, wt))
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
                        dict(stride=s, padding=pad, groups=c if dw else 1, out_dtype=dtype),
                        CONV_INT8_INSTANCES)
    a8 = torch.full((1, 64, 2, 2), 100, dtype=torch.int8, device=dev)
    w8 = torch.full((1, 64, 1, 1), 100, dtype=torch.int8, device=dev)
    try:
        r = F.conv2d(a8, w8)
        torch.cuda.synchronize()
        fconv = f"returns {r.dtype} {r.flatten()[:2].tolist()} where the sum is 640000"
    except Exception as e:  # a record of what PyTorch does, not a route
        fconv = f"raises {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    print(f"phase 22a conv_int8 kernels ({', '.join(CONV_INT8_INSTANCES)}) vs plain: "
          f"{len(CONV_INT8_ODD)} odd shapes ({', '.join(c[0] for c in CONV_INT8_ODD)}): "
          f"int32 sums and outputs bit-equal, two launches bit-equal, one Hopper launch a "
          f"call; F.conv2d on int8 CUDA tensors {fconv}")

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
        if (counts != want or ci.CALLS != len(batches) * calls or ci.LAUNCHES != ci.CALLS
                or ci.INSTANCE_LAUNCHES != {"sm90": ci.CALLS, "simt": 0}):
            fail(f"phase 22b {label}: launches {counts} (want {want}), conv_int8 "
                 f"{ci.LAUNCHES} launches {ci.INSTANCE_LAUNCHES} in {ci.CALLS} calls (want "
                 f"{len(batches) * calls} calls, one Hopper launch each)")
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
              f"{launches} launches ({launches // len(batches)} a serve, one a call, all of "
              f"the Hopper kernel), NMS "
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
                ms = host_p50_ms(lambda: det.serve(batch), iters=3, warmup=1)
                dms = host_p50_ms(lambda: det.serve_tensors(images_d[:b], scales_d[:b]),
                                  iters=5, warmup=1)
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
            if mode == "int8":  # the Hopper kernel against its ablation, in turns
                busy = []
                for simt in (False, True, True, False):
                    with SimtInt8() if simt else contextlib.nullcontext():
                        busy.append(device_busy_ms(
                            lambda: det.serve_tensors(images_d, scales_d)))
                ab = (None if None in busy else
                      ((busy[0] + busy[3]) / 2, (busy[1] + busy[2]) / 2))
                out["serve"][f"{label} int8 b8 busy"] = ab
                print(f"  {label} int8 b8 device part, device busy with conv_int8 on the "
                      f"Hopper kernel vs the SIMT ablation in turns: " +
                      ("not measured" if ab is None else
                       f"{ab[0]:.3f} vs {ab[1]:.3f} ms ({ab[1] - ab[0]:.3f} ms; turns "
                       f"{[round(v, 3) for v in busy]})"))
        det._int8 = int8
        del images_d, scales_d
    # 22a continued: the kernel at every conv call of a b8 serve
    for label in ("fp32", "bf16"):
        tot = int8_numbers(out.pop(f"calls_{label}"))
        out[f"numbers_{label}"] = tot
        split = "; ".join(
            f"{tot[f'n_{p}']} {p} {tot[f'{p}_ms']:.4f} (SIMT {tot[f'{p}_simt_ms']:.4f}, bound "
            f"{tot[f'{p}_bound_ms']:.6f})" for p in ("stem", "1x1", "depthwise"))
        print(f"phase 22a conv_int8 at the {tot['n']} conv calls of a {label} b8 int8 "
              f"serve: every call's sums and output bit-equal to the plain version's with "
              f"both instances, one Hopper launch a call; in turns the Hopper kernel "
              f"{tot['ms']:.4f} ms in all, the SIMT ablation {tot['simt_ms']:.4f} ms "
              f"({tot['simt_ms'] / tot['ms']:.2f}x); bound {tot['bound_ms']:.6f} ms "
              f"({tot['bound_by']}: bytes {tot['bytes_ms']:.6f}, int8 operations "
              f"{tot['ops_ms']:.6f}; the kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}%); "
              f"{split}; plain {tot['plain_ms']:.4f} ms, cuDNN bf16 convs of the same "
              f"shapes {tot['cudnn_bf16_ms']:.4f} ms; torch._int_mm {tot['intmm_ms']:.4f} ms "
              f"on {tot['n_intmm']} of the {tot['n_1x1']} 1x1 convs against the kernel's "
              f"{tot['intmm_kernel_ms']:.4f}")

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
            live_ms = host_p50_ms(lambda: det.serve(frames[:1]), iters=5)
            drv_ms = host_p50_ms(lambda: drv.serve(frames[:1]), iters=5)
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


# -- phase 23: the packed backbone entry and a reference TF checkpoint ------

def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(num: int, wire: int, payload) -> bytes:
    key = _pb_varint(num << 3 | wire)
    if wire == 0:
        return key + _pb_varint(payload)
    if wire == 5:
        return key + payload.to_bytes(4, "little")
    return key + _pb_varint(len(payload)) + payload


TF_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3,
             np.dtype(np.int64): 9, np.dtype(np.bool_): 10, np.dtype(np.float16): 19}


def _table_block(entries) -> bytes:
    """A LevelDB table block: every entry a restart point (no shared key
    prefix), then the restart array and its count."""
    body, restarts = bytearray(), []
    for key, value in entries:
        restarts.append(len(body))
        body += _pb_varint(0) + _pb_varint(len(key)) + _pb_varint(len(value)) + key + value
    for r in restarts or [0]:
        body += r.to_bytes(4, "little")
    body += len(restarts or [0]).to_bytes(4, "little")
    return bytes(body)


def write_tf_bundle(prefix: str, tensors: dict) -> None:
    """Write `tensors` ({name: array}) as a TF tensor bundle, the format of a
    TF1 name-based checkpoint (`<prefix>.index`, a LevelDB table of
    `BundleEntryProto`s after the `BundleHeaderProto` keyed "", and
    `<prefix>.data-00000-of-00001`), without TensorFlow. Its own writer, for
    phase 23d; tests/test_torch_convert.py holds its files readable by
    `tf.train.load_checkpoint`."""
    from mladversarialobjectdetection_torch.data.tfrecord import masked_crc32c

    data, entries = bytearray(), []
    header = _pb_field(1, 0, 1) + _pb_field(3, 2, _pb_field(1, 0, 1))  # 1 shard, producer 1
    entries.append((b"", header))
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()  # C order
        shape = b"".join(_pb_field(2, 2, _pb_field(1, 0, d) if d else b"")
                         for d in arr.shape)
        entry = (_pb_field(1, 0, TF_DTYPES[arr.dtype]) + _pb_field(2, 2, shape)
                 + (_pb_field(4, 0, len(data)) if data else b"")
                 + (_pb_field(5, 0, len(raw)) if raw else b"")
                 + _pb_field(6, 5, masked_crc32c(raw)))
        entries.append((name.encode(), entry))
        data += raw
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(data)
    out = bytearray()

    def block(contents: bytes) -> bytes:
        handle = _pb_varint(len(out)) + _pb_varint(len(contents))
        out.extend(contents + b"\x00")
        out.extend(masked_crc32c(contents + b"\x00").to_bytes(4, "little"))
        return handle

    data_handle = block(_table_block(entries))
    meta_handle = block(_table_block([]))
    index_handle = block(_table_block([(entries[-1][0], data_handle)]))
    footer = (meta_handle + index_handle).ljust(40, b"\x00")
    out += footer + (0xDB4775248B80FB57).to_bytes(8, "little")
    with open(f"{prefix}.index", "wb") as f:
        f.write(out)


def tf_release_names(config, variables, rng) -> dict:
    """The detector's Flax variables under the reference's TF1 names
    (`ckpt/convert_tf._NameMapper`, its transforms undone; each fnode's WSM
    vector split into the scalars WSM, WSM_1, ...): each raw name holds its
    value + U(1, 2) and its `/ExponentialMovingAverage` shadow the value, as
    tests/test_ckpt_file_restore.py:69-90 writes them."""
    from mladversarialobjectdetection_torch.ckpt import convert_tf
    from mladversarialobjectdetection_torch.models.efficientdet import spec_from_config

    mapper = convert_tf._NameMapper(config, spec_from_config(config))
    out = {}
    for collection, tree in variables.items():
        for path, leaf in convert_tf._leaves(tree):
            name, transform = mapper(collection, path)
            leaf = np.asarray(leaf, np.float32)
            if path[-1] == "WSM":
                vals = {name if i == 0 else f"{name}_{i}": leaf[i]
                        for i in range(leaf.shape[0])}
            else:
                vals = {name: leaf.transpose(0, 1, 3, 2)
                        if transform is convert_tf._dw_to_flax else leaf}
            for n, v in vals.items():
                v = np.asarray(v, np.float32)
                out[f"{n}/ExponentialMovingAverage"] = v
                out[n] = (v + rng.uniform(1.0, 2.0, v.shape)).astype(np.float32)
    return out


def packed_serve_phase(dev) -> dict:
    """Phase 23a: `Detector(packed_entry=PACKED_ENTRY)` at lite4@640 beside the
    unpacked serve on the same seeded weights, fp32 and bf16, b1 and b8."""
    import torch
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.models.efficientnet_packed import (
        PackedEntryEfficientNet)

    rng = np.random.default_rng(2323)
    frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(8)]
    batches = {1: frames[:1], 8: frames}
    out = {}
    for label, params, tol in (("fp32", None, VICTIM_TOL),
                               ("bf16", {"mixed_precision": True}, PACKED_BF16_SERVE_TOL)):
        t0 = time.perf_counter()
        pdet = Detector("efficientdet-lite4", params=params, seed=0, device=dev,
                        packed_entry=PACKED_ENTRY)
        build_s = time.perf_counter() - t0
        if not isinstance(pdet.net.backbone, PackedEntryEfficientNet):
            fail(f"phase 23a {label}: Detector(packed_entry) built no packed backbone")
        udet = copy.copy(pdet)
        udet.net = pdet.net.with_packed_entry(0)
        images, scales = pdet.preprocess(frames)
        images_d = torch.from_numpy(images).to(dev)
        scales_d = torch.from_numpy(scales).to(dev)
        with torch.no_grad():
            p_out = [o for group in pdet.net(images_d) for o in group]
            u_out = [o for group in udet.net(images_d) for o in group]
        err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                  for a, b in zip(p_out, u_out))
        del p_out, u_out
        if not err <= tol:
            fail(f"phase 23a {label}: packed head outputs {err} of scale from the "
                 f"unpacked ones (limit {tol})")
        pdet.serve(frames[:1])  # warm-up outside the counted run
        torch.cuda.synchronize()
        reset_path_counts()
        with UnfusedRoute() as route:
            res = {b: pdet.serve(batch) for b, batch in batches.items()}
        torch.cuda.synchronize()
        counts = path_counts()
        want = dict.fromkeys(counts, 0)
        want["nms"] = len(batches)
        want["mbconv_fwd_bf16" if params else "mbconv_fp32"] = (
            len(batches) * PACKED_MBCONV_PER_PASS)
        if counts != want or len(route.calls) != len(batches) * PACKED_UNFUSED_PER_PASS \
                or any(route.calls):
            fail(f"phase 23a {label}: launches {counts} (want {want}), {len(route.calls)} "
                 f"blocks unfused ({sum(route.calls)} fuseable)")
        ures = {b: udet.serve(batch) for b, batch in batches.items()}
        agree = {b: top_agreement(res[b], ures[b]) for b in batches}
        if any(agree[b] != b for b in batches):
            fail(f"phase 23a {label}: the top detection agrees in {agree} images")
        score_diff = float(np.abs(res[8].scores - ures[8].scores).max())
        row = {"err": err, "launches": counts, "build_s": build_s, "score_diff": score_diff}
        for name, det in (("packed", pdet), ("unpacked", udet)):
            for b, batch in batches.items():
                row[f"{name} b{b}"] = (
                    host_p50_ms(lambda: det.serve(batch), iters=3, warmup=1),
                    host_p50_ms(lambda: det.serve_tensors(images_d[:b], scales_d[:b]),
                                iters=5, warmup=1))
            torch.cuda.reset_peak_memory_stats(dev)
            det.serve_tensors(images_d, scales_d)
            torch.cuda.synchronize()
            row[f"{name} peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            row[f"{name} busy"] = profile_device(
                lambda: det.serve_tensors(images_d, scales_d), f"23a {label} {name} b8",
                top=4)
        # the packed kernels cached (the serve above) against built every call
        backbone = pdet.net.backbone

        def rebuilt():
            backbone._kernels.clear()
            return pdet.serve_tensors(images_d, scales_d)

        row["rebuilt b8"] = host_p50_ms(rebuilt, iters=5)
        with torch.no_grad():
            row["build_ms"] = cuda_ms(lambda: (backbone._kernels.clear(),
                                               backbone.packed_kernels(pdet.net.compute_dtype)),
                                      iters=5)
        out[label] = row
        print(f"phase 23a packed serve {label} (lite4@640, packed_entry {PACKED_ENTRY}, "
              f"built in {build_s:.2f} s): head outputs within {err:.3g} of the unpacked "
              f"serve's scale (limit {tol}); in b1 + b8 launches {counts}, "
              f"{len(route.calls)} blocks unfused; top detection agrees in {agree}; "
              f"largest b8 score difference {score_diff:.3g}")
        for b in batches:
            (pm, pd), (um, ud) = row[f"packed b{b}"], row[f"unpacked b{b}"]
            print(f"  serve {label} b{b}: packed p50 {pm:.3f} ms (device part {pd:.3f}), "
                  f"unpacked {um:.3f} ms (device part {ud:.3f})")
        busy = {k: "not measured" if row[f"{k} busy"] is None
                else f"{100 * row[f'{k} busy']:.1f}%" for k in ("packed", "unpacked")}
        print(f"  {label} b8 device part: peak memory packed {row['packed peak_gb']:.3f} "
              f"GB, unpacked {row['unpacked peak_gb']:.3f} GB; busy packed "
              f"{busy['packed']}, unpacked {busy['unpacked']}; the packed "
              f"kernels built every call: device part p50 {row['rebuilt b8']:.3f} ms "
              f"(building them alone {row['build_ms']:.4f} ms)")
        del pdet, udet, images_d, scales_d, res, ures
        torch.cuda.empty_cache()
    return out


def packed_attack_phase(dev) -> dict:
    """Phase 23b: `PatchAttacker(packed_entry=PACKED_ENTRY)` beside the unpacked
    attacker on one victim, b24, window 320, the live regime, fp32 and bf16."""
    import torch
    from mladversarialobjectdetection_torch import config as config_lib
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.attack.train import get_victim
    from mladversarialobjectdetection_torch.ops import mbconv_cuda, nms_cuda

    def cosine(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm()))

    out = {}
    for label, mixed in (("fp32", False), ("bf16", True)):
        cfg = config_lib.get_efficientdet_config("efficientdet-lite4")
        cfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5,
                                "pre_nms_topk": 256})
        cfg.mixed_precision = mixed
        victim = get_victim(cfg, seed=0, device=dev)
        atks = {"unpacked": PatchAttacker(cfg, victim, window=ATTACK_WINDOW, device=dev),
                "packed": PatchAttacker(cfg, victim, window=ATTACK_WINDOW,
                                        packed_entry=PACKED_ENTRY, device=dev)}
        images = torch.rand((ATTACK_BATCH, *atks["packed"].image_hw, 3), device=dev,
                            generator=torch.Generator(dev).manual_seed(2)) * 2 - 1
        boxes, valid = make_live_slot_boxes(ATTACK_BATCH, atks["packed"].image_hw,
                                            atks["packed"].max_boxes)
        override = (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))
        row = {}
        for name, atk in atks.items():
            state = atk.init_state(1)
            patch = state.patch.detach().clone().requires_grad_(True)
            scale = state.scale.detach().clone().requires_grad_(True)
            loss, _ = atk._loss_from_images(patch, scale, images, *override,
                                            torch.Generator(dev).manual_seed(7))
            loss.backward()
            row[f"{name} loss"], row[f"{name} grad"] = float(loss.detach()), patch.grad
            step = lambda atk=atk, state=state: atk.train_step(
                state, images, with_asr=False, boxes_override=override)
            step()  # warm-up outside the counted run
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_path_counts()
            step()
            torch.cuda.synchronize()
            row[f"{name} launches"] = dict(
                nms=nms_cuda.LAUNCHES,
                **{k: dict(v) for k, v in mbconv_cuda.DTYPE_LAUNCHES.items()})
            if mixed:  # every bf16 dx on the Hopper kernel
                row[f"{name} dx_sm90"] = sm90_route(
                    f"phase 23b {label} {name}",
                    PACKED_MBCONV_PER_PASS if name == "packed" else MBCONV_PER_PASS, kind="dx")
            row[f"{name} peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            row[f"{name} ms"] = host_p50_ms(step, iters=3, warmup=1)
        rel = abs(row["packed loss"] - row["unpacked loss"]) / abs(row["unpacked loss"])
        cos = cosine(row.pop("packed grad"), row.pop("unpacked grad"))
        got = row["packed launches"]
        zero = {"mbconv_fwd": 0, "mbconv_dx": 0}
        want = {"nms": 1, "float32": dict(zero), "bfloat16": dict(zero)}
        want["bfloat16" if mixed else "float32"] = {
            "mbconv_fwd": 2 * PACKED_MBCONV_PER_PASS, "mbconv_dx": PACKED_MBCONV_PER_PASS}
        if not (rel <= PACKED_LOSS_REL and cos >= PACKED_COS and got == want):
            fail(f"phase 23b {label}: loss {rel} relative (limit {PACKED_LOSS_REL}), patch "
                 f"gradient cosine {cos} (limit {PACKED_COS}), launches {got}")
        row.update(rel=rel, cos=cos)
        out[label] = row
        print(f"phase 23b packed attack step {label} (b{ATTACK_BATCH}, window "
              f"{ATTACK_WINDOW}, packed_entry {PACKED_ENTRY}): loss "
              f"{row['packed loss']:.6f} vs {row['unpacked loss']:.6f} ({rel:.3g} "
              f"relative), patch gradient cosine {cos:.8f}; launches a step packed "
              f"{got}, unpacked {row['unpacked launches']}")
        for name in ("packed", "unpacked"):
            ms = row[f"{name} ms"]
            print(f"  {label} {name} step p50 {ms:.3f} ms ({ATTACK_BATCH * 1e3 / ms:.2f} "
                  f"images/s), peak memory {row[f'{name} peak_gb']:.3f} GB")
        del atks, victim, images
        torch.cuda.empty_cache()
    return out


def packed_defender_phase(dev) -> dict:
    """Phase 23c: one `PatchAttackDefender(packed_entry=PACKED_ENTRY)` step
    beside the unpacked defender's, b24, fp32, from the same state."""
    import torch
    from mladversarialobjectdetection_torch import config as config_lib
    from mladversarialobjectdetection_torch.attack.train import get_victim
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender

    dcfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    dcfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": DEFEND_THRESH})
    eval_patch = np.random.default_rng(0).uniform(-1, 1, (640, 640, 3)).astype(np.float32)
    victim = get_victim(dcfg, seed=0, device=dev)
    images = torch.rand((DEFEND_BATCH, 640, 640, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(4)) * 2 - 1
    row = {}
    for name, pe in (("unpacked", 0), ("packed", PACKED_ENTRY)):
        dfd = PatchAttackDefender(dcfg, victim, eval_patch=eval_patch, eval_scale=0.4,
                                  packed_entry=pe, device=dev)
        state = dfd.init_state(3)
        reset_path_counts()
        _, m = dfd.train_step(state, images)
        torch.cuda.synchronize()
        row[name] = (float(m.loss), float(m.mean_clean_score), path_counts())
        row[f"{name} ms"] = host_p50_ms(lambda: dfd.train_step(state, images), iters=3,
                                        warmup=1)
    rel = abs(row["packed"][0] - row["unpacked"][0]) / abs(row["unpacked"][0])
    srel = abs(row["packed"][1] - row["unpacked"][1]) / abs(row["unpacked"][1])
    if not (rel <= PACKED_DEFENDER_REL and srel <= PACKED_DEFENDER_REL) or \
            row["packed"][2]["mbconv_fp32"] != PACKED_MBCONV_PER_PASS:
        fail(f"phase 23c: packed defender loss {rel} relative, clean score {srel} "
             f"(limit {PACKED_DEFENDER_REL}), launches {row['packed'][2]}")
    print(f"phase 23c packed defender step (b{DEFEND_BATCH}, fp32): loss "
          f"{row['packed'][0]:.8f} vs {row['unpacked'][0]:.8f} ({rel:.3g} relative), mean "
          f"clean score {srel:.3g} relative; launches packed {row['packed'][2]}; step p50 "
          f"packed {row['packed ms']:.3f} ms, unpacked {row['unpacked ms']:.3f} ms")
    del victim, images
    torch.cuda.empty_cache()
    return {"rel": rel, "packed_ms": row["packed ms"], "unpacked_ms": row["unpacked ms"]}


def tf_checkpoint_phase(dev, vpath: str, work: str) -> dict:
    """Phase 23d: phase 16's victim written as a reference TF1 release
    tarball (raw names off by U(1, 2), EMA shadows true) and read back on a
    machine without TensorFlow by `Detector(ckpt_path=<tgz>)` and
    `attack.train.get_victim_variables`."""
    import importlib.util
    import tarfile
    from pathlib import Path
    import torch
    from mladversarialobjectdetection_torch import _build
    from mladversarialobjectdetection_torch import config as config_lib
    from mladversarialobjectdetection_torch.attack.train import get_victim_variables
    from mladversarialobjectdetection_torch.ckpt import convert_tf, io as ckpt_io
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.models.efficientdet import spec_from_config

    no_tf = importlib.util.find_spec("tensorflow") is None
    bf16 = {"mixed_precision": True}
    cfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    cfg.update(bf16)
    flax_vars = ckpt_io.load_pytree(vpath)
    _build.build_tfrecord_native()  # the native CRC, for the writer too
    t0 = time.perf_counter()
    tensors = tf_release_names(cfg, flax_vars, np.random.default_rng(23))
    root = Path(work) / "efficientdet-lite4"
    root.mkdir(parents=True)
    write_tf_bundle(str(root / "model"), tensors)
    (root / "checkpoint").write_text('model_checkpoint_path: "model"\n')
    tgz = str(Path(work) / "efficientdet-lite4.tgz")
    with tarfile.open(tgz, "w:gz", compresslevel=1) as tar:
        tar.add(str(root), arcname="efficientdet-lite4")
    write_s = time.perf_counter() - t0
    mb = Path(tgz).stat().st_size / 1e6
    t0 = time.perf_counter()
    prefix = convert_tf.find_tf_checkpoint(tgz)
    weights = convert_tf.load_tf_checkpoint(prefix)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_tf.convert_tf_weights(weights, cfg, spec_from_config(cfg), flax_vars)
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    det_tf = Detector("efficientdet-lite4", params=bf16, device=dev, ckpt_path=tgz)
    det_s = time.perf_counter() - t0
    det_pkl = Detector("efficientdet-lite4", params=bf16, device=dev, ckpt_path=vpath)
    rng = np.random.default_rng(2324)
    frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(8)]
    det_tf.serve(frames[:1])
    reset_path_counts()
    from_tf = det_tf.serve(frames)
    torch.cuda.synchronize()
    counts = path_counts()
    same_detections("phase 23d Detector(<tgz>) against Detector(<victim .pkl>)",
                    from_tf, det_pkl.serve(frames))
    if counts["nms"] != 1 or counts["mbconv_fwd_bf16"] != MBCONV_PER_PASS:
        fail(f"phase 23d: a serve from the tarball launched {counts}")
    t0 = time.perf_counter()
    vv = get_victim_variables(cfg, tgz)
    victim_s = time.perf_counter() - t0
    leaves = dict(convert_tf._leaves(vv))
    want = dict(convert_tf._leaves(flax_vars))
    if leaves.keys() != want.keys() or not all(
            np.array_equal(leaves[k], np.asarray(want[k], np.float32)) for k in want):
        fail("phase 23d: get_victim_variables(<tgz>) differs from the victim's variables")
    if "tensorflow" in sys.modules:
        fail("phase 23d: TensorFlow was imported")
    n_valid = int(np.asarray(from_tf.valid).sum())
    print(f"phase 23d reference TF checkpoint: {len(tensors)} tensors ({len(tensors) // 2} "
          f"variables and their EMA shadows) written as a {mb:.1f} MB release tarball in "
          f"{write_s:.2f} s; TensorFlow installed: {not no_tf}; read without it in "
          f"{read_s:.2f} s, converted in {convert_s:.2f} s; Detector(ckpt_path=<tgz>) "
          f"built in {det_s:.2f} s serves b8 detections bit-equal to the victim .pkl's "
          f"({n_valid} valid, launches {counts}); get_victim_variables(<tgz>) in "
          f"{victim_s:.2f} s, every leaf bit-equal")
    return {"read_s": read_s, "convert_s": convert_s, "detector_s": det_s}


def dp_inputs() -> dict:
    """Phase 24's global batches, from a seeded numpy generator: the b24
    attack and defender images with phase 5's live boxes, the float64
    supervised batch with its boxes, and 720x1280 frames to serve."""
    rng = np.random.default_rng(24)
    boxes, valid = make_live_slot_boxes(ATTACK_BATCH, (640, 640), 16)
    return {"images": rng.uniform(-1, 1, (ATTACK_BATCH, 640, 640, 3)).astype(np.float32),
            "boxes": boxes, "valid": valid,
            "sup": rng.uniform(-1, 1, (DP_SUP_BATCH, 640, 640, 3)),
            "gt": random_gt(rng, DP_SUP_BATCH, 640),
            "frames": [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
                       for _ in range(DP_SERVE_FRAMES)]}


def dp_lite4(score_thresh: float = 0.5):
    from mladversarialobjectdetection_torch import config as config_lib
    cfg = config_lib.get_efficientdet_config("efficientdet-lite4")
    cfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": score_thresh,
                            "pre_nms_topk": 256})
    return cfg


def dp_attack_step(atk, inp, rows, dev, timed: int = 0) -> dict:
    """One fp32 attack step of phase 5's setup (state seed 1, window 320, the
    live boxes) on rows of phase 24's batch; with `timed`, the p50 of that
    many more steps."""
    import torch
    state = atk.init_state(1)
    images = torch.from_numpy(inp["images"][rows]).to(dev)
    override = (torch.from_numpy(inp["boxes"][rows]).to(dev),
                torch.from_numpy(inp["valid"][rows]).to(dev))
    state, m = atk.train_step(state, images, boxes_override=override)
    out = {"loss": float(m.loss), "grad": state.patch.grad.detach().cpu().clone(),
           "patch": state.patch.detach().cpu().clone()}
    if timed:
        out["p50_ms"] = host_p50_ms(
            lambda: atk.train_step(state, images, boxes_override=override), timed, 1)
    return out


def dp_defender_step(dfd, inp, rows, dev) -> dict:
    """One fp32 defender step (U-Net seed 3) on rows of phase 24's batch,
    the victim's boxes stubbed with the live boxes at score .9 (a random
    victim's near-tied scores would let conv rounding move the masker)."""
    import torch
    boxes = torch.from_numpy(inp["boxes"][rows]).to(dev)
    valid = torch.from_numpy(inp["valid"][rows]).to(dev)
    dfd.odet_boxes = lambda images, score_thresh=None: (
        boxes, torch.full(valid.shape, 0.9, device=dev), valid)
    state = dfd.init_state(3)
    state, m = dfd.train_step(state, torch.from_numpy(inp["images"][rows]).to(dev))
    return {"loss": float(m.loss)}


def dp_supervised_step(inp, rows, dev) -> dict:
    """One float64 supervised step at lite4@640 (seed 0) on rows of phase
    24's supervised batch."""
    import torch
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    tr = DetectorTrainer(dp_lite4(), steps_per_epoch=10, device=dev)
    st = tr.init_state(seed=0)
    st.net.double()
    st.net.compute_dtype = torch.float64
    if st.ema is not None:
        st.ema = {n: e.double() for n, e in st.ema.items()}
    boxes, classes, valid = inp["gt"]
    st, m = tr.train_step(st, inp["sup"][rows], boxes[rows], classes[rows], valid[rows])
    return {"loss": float(m["loss"]),
            "net": {k: v.detach().cpu() for k, v in st.net.state_dict().items()}}


def dp_rank(rank: int, work: str) -> None:
    """Phases 24b-c on one of two ranks (gloo, both on the one card): the
    attack, defender and float64 supervised steps on this rank's rows of the
    global batch and `Detector(mesh=)` on the whole one, then
    `attack.train.train` for 2 synthetic steps; results to work/r{rank}.pt."""
    import os
    import torch
    from mladversarialobjectdetection_torch import parallel
    from mladversarialobjectdetection_torch.attack.train import get_victim, train
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
    from mladversarialobjectdetection_torch.inference.detector import Detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    inp = dp_inputs()
    mesh = parallel.make_mesh(device=dev)
    half = lambda n: slice(rank * n // 2, (rank + 1) * n // 2)
    out = {}
    t0 = time.perf_counter()
    with parallel.use_mesh(mesh):
        cfg = dp_lite4()
        out["attack"] = dp_attack_step(
            PatchAttacker(cfg, get_victim(cfg, seed=0, device=dev),
                          window=ATTACK_WINDOW, device=dev), inp, half(ATTACK_BATCH), dev)
        dcfg = dp_lite4(DEFEND_THRESH)
        out["defend"] = dp_defender_step(
            PatchAttackDefender(dcfg, get_victim(dcfg, seed=0, device=dev), device=dev),
            inp, half(ATTACK_BATCH), dev)
        out["sup64"] = dp_supervised_step(inp, half(DP_SUP_BATCH), dev)
    det = Detector("efficientdet-lite4", seed=0, device=dev, mesh=mesh)
    out["serve"] = det.serve(inp["frames"])
    out["serve_rows"] = det._rows(inp["frames"])
    torch.cuda.synchronize()
    out["steps_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = train("efficientdet-lite4", synthetic=True, batch_size=DRIVER_BATCH, epochs=1,
               steps_per_epoch=2, visualize_freq=0, device=dev,
               save_dir=os.path.join(work, f"driver{rank}"))
    out["driver_patch"] = st.patch.detach().cpu()
    out["driver_scale"] = float(st.scale.detach())
    out["driver_s"] = time.perf_counter() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(out, os.path.join(work, f"r{rank}.pt"))


def dp_leaf_err(got: dict, ref: dict) -> float:
    """Max over leaves of max|got - ref| / max(1, max|ref|)."""
    worst = 0.0
    for k, v in ref.items():
        v = v.double()
        worst = max(worst, float((got[k].double() - v).abs().max())
                    / max(1.0, float(v.abs().max())))
    return worst


def data_parallel_phase(dev, work: str) -> dict:
    """Phase 24: the mesh path in a world-size-1 NCCL group (24a), two ranks
    on the one card through gloo (24b), the attack driver at two ranks (24c);
    every step held against the one-process step on the global batch."""
    import os
    import socket
    import torch
    import torch.distributed as dist
    from mladversarialobjectdetection_torch import parallel
    from mladversarialobjectdetection_torch.attack.train import get_victim
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.parallel import launch
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer

    t24 = time.perf_counter()
    inp = dp_inputs()
    every = slice(None)
    # 24a: a group of one rank in this process: every collective is issued
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(device=dev)
        cfg = dp_lite4()
        atk = PatchAttacker(cfg, get_victim(cfg, seed=0, device=dev),
                            window=ATTACK_WINDOW, device=dev)
        # bit-equality needs cuDNN's deterministic algorithms (its backward
        # passes sum with atomics otherwise, as phases 17-18 note)
        torch.backends.cudnn.deterministic = True
        try:
            plain = dp_attack_step(atk, inp, every, dev)
            with parallel.use_mesh(mesh):
                meshed = dp_attack_step(atk, inp, every, dev)
        finally:
            torch.backends.cudnn.deterministic = False
        if not torch.equal(meshed["patch"], plain["patch"]):
            fail("phase 24a: the attack step through the mesh path moved the patch "
                 "otherwise than the plain step")
        plain["p50_ms"] = dp_attack_step(atk, inp, every, dev, timed=DP_STEPS)["p50_ms"]
        with parallel.use_mesh(mesh):
            meshed["p50_ms"] = dp_attack_step(atk, inp, every, dev,
                                              timed=DP_STEPS)["p50_ms"]
        del atk
        rng = np.random.default_rng(8)
        images = rng.uniform(-1, 1, (SUP_BATCH, 640, 640, 3)).astype(np.float32)
        gt = random_gt(rng, SUP_BATCH, 640)
        sup = {}
        for label in ("plain", "mesh"):
            tr = DetectorTrainer(dp_lite4(), steps_per_epoch=10, device=dev)
            st = tr.init_state(seed=0)
            with parallel.use_mesh(mesh if label == "mesh" else None):
                st, m = tr.train_step(st, images, *gt)
                net = {k: v.detach().cpu().clone() for k, v in st.net.state_dict().items()}
                p50 = host_p50_ms(lambda: tr.train_step(st, images, *gt), DP_STEPS, 1)
            sup[label] = (net, float(m["loss"]), p50)
            del tr, st
        sup_err = dp_leaf_err(sup["mesh"][0], sup["plain"][0])
        sup_loss = abs(sup["mesh"][1] - sup["plain"][1]) / abs(sup["plain"][1])
        if sup_err > TRAIN_F32_TOL or sup_loss > TRAIN_F32_TOL:
            fail(f"phase 24a: the supervised step through the global-BatchNorm path "
                 f"lies {sup_err:.3g} of scale (loss {sup_loss:.3g}) off the plain step")
    finally:
        dist.destroy_process_group()
    print(f"phase 24a world-size-1 NCCL group: the lite4@640 b{ATTACK_BATCH} fp32 attack "
          f"step through the mesh path bit-equal to the plain step (patch, cuDNN "
          f"deterministic), step p50 "
          f"{meshed['p50_ms']:.3f} ms against {plain['p50_ms']:.3f} ms plain (collectives "
          f"{meshed['p50_ms'] - plain['p50_ms']:+.3f} ms); the b{SUP_BATCH} fp32 supervised "
          f"step with global BatchNorm within {sup_err:.3g} of scale of the plain one "
          f"(loss {sup_loss:.3g} relative, limit {TRAIN_F32_TOL}), step p50 "
          f"{sup['mesh'][2]:.3f} ms against {sup['plain'][2]:.3f} ms plain (collectives "
          f"{sup['mesh'][2] - sup['plain'][2]:+.3f} ms)")
    del sup
    torch.cuda.empty_cache()

    # 24b-c: two ranks through gloo on the one card
    t0 = time.perf_counter()
    launch.spawn(dp_rank, 2, (work,), init_method=f"file://{work}/store",
                 backend="gloo", timeout_s=DP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"r{r}.pt"), weights_only=False)
             for r in range(2)]
    # the one-process references on the global batch, in this process
    dcfg = dp_lite4(DEFEND_THRESH)
    ref_defend = dp_defender_step(
        PatchAttackDefender(dcfg, get_victim(dcfg, seed=0, device=dev), device=dev),
        inp, every, dev)
    torch.cuda.empty_cache()
    ref_sup = dp_supervised_step(inp, every, dev)
    torch.cuda.empty_cache()
    ref_serve = Detector("efficientdet-lite4", seed=0, device=dev).serve(inp["frames"])
    r0, r1 = ranks
    a0, a1 = r0["attack"], r1["attack"]
    att_rel = abs(a0["loss"] - plain["loss"]) / abs(plain["loss"])
    g, gr = a0["grad"].double().ravel(), plain["grad"].double().ravel()
    att_cos = float(g @ gr / (g.norm() * gr.norm()))
    if not (att_rel <= DP_LOSS_REL and att_cos >= DP_GRAD_COS
            and torch.equal(a0["patch"], a1["patch"])):
        fail(f"phase 24b attack: loss {att_rel:.3g} relative, patch gradient cosine "
             f"{att_cos:.6f}, ranks' patches equal {torch.equal(a0['patch'], a1['patch'])}")
    def_rel = abs(r0["defend"]["loss"] - ref_defend["loss"]) / abs(ref_defend["loss"])
    if def_rel > DP_LOSS_REL:
        fail(f"phase 24b defender: loss {def_rel:.3g} relative off one process")
    sup_err = dp_leaf_err(r0["sup64"]["net"], ref_sup["net"])
    sup_rel = abs(r0["sup64"]["loss"] - ref_sup["loss"]) / abs(ref_sup["loss"])
    if sup_err > DP_SUP_F64_TOL or sup_rel > DP_SUP_F64_TOL:
        fail(f"phase 24b supervised float64: {sup_err:.3g} of scale, loss "
             f"{sup_rel:.3g} relative (limit {DP_SUP_F64_TOL})")
    serve_err = box_err = 0.0
    for r in ranks:
        got, ref = r["serve"], [t.cpu().numpy() if hasattr(t, "cpu") else t
                                for t in ref_serve]
        for field, x, y in zip(("classes", "valid", "valid_len"), got[2:], ref[2:]):
            if not np.array_equal(x, y):
                fail(f"phase 24b Detector(mesh=): {field} differ from one process")
        serve_err = max(serve_err, float(np.abs(got.scores - ref[1]).max()))
        box_err = max(box_err, float(np.abs(got.boxes - ref[0]).max()))
    if serve_err > DP_SERVE_SCORE_TOL or box_err > DP_SERVE_BOX_TOL:
        fail(f"phase 24b Detector(mesh=): scores within {serve_err:.3g}, boxes within "
             f"{box_err:.3g} of one process")
    own = Detector("efficientdet-lite4", seed=0, device=dev).serve(r0["serve_rows"])
    same_detections("phase 24b Detector(mesh=) rank 0 rows against their own serve",
                    [t[:len(r0["serve_rows"])] for t in r0["serve"]], own)
    print(f"phase 24b two ranks on one card (gloo, b{ATTACK_BATCH} global, "
          f"{ATTACK_BATCH // 2} a rank): attack loss {att_rel:.3g} relative to one "
          f"process, patch gradient cosine {att_cos:.7f}, the ranks' patches bit-equal; "
          f"defender (stubbed boxes) loss {def_rel:.3g} relative; supervised lite4@640 "
          f"float64 b{DP_SUP_BATCH} within {sup_err:.3g} of scale (loss {sup_rel:.3g}, "
          f"limit {DP_SUP_F64_TOL}); Detector(mesh=) b{DP_SERVE_FRAMES}: classes and valid "
          f"equal, scores within {serve_err:.3g}, boxes within {box_err:.3g} px, rank 0's "
          f"rows bit-equal to their own one-process serve; ranks' steps "
          f"{r0['steps_s']:.2f} / {r1['steps_s']:.2f} s, peak {r0['peak_gb']:.2f} / "
          f"{r1['peak_gb']:.2f} GB each (a correctness check on one card, not a "
          f"scaling figure)")
    files = lambda d: sorted(os.path.relpath(os.path.join(p, f), d)
                             for p, _, fs in os.walk(d) for f in fs)
    if files(os.path.join(work, "driver1")) != ["logs/metrics.p1.jsonl"]:
        fail(f"phase 24c: rank 1 wrote {files(os.path.join(work, 'driver1'))}")
    main_files = files(os.path.join(work, "driver0"))
    if not {"logs/metrics.jsonl", "state-latest.msgpack"} <= set(main_files):
        fail(f"phase 24c: rank 0 wrote {main_files}")
    if not (torch.equal(r0["driver_patch"], r1["driver_patch"])
            and r0["driver_scale"] == r1["driver_scale"]):
        fail("phase 24c: the ranks' patches differ after attack.train.train")
    print(f"phase 24c attack.train.train at 2 ranks (b{DRIVER_BATCH}, bf16, 2 steps and "
          f"5 val batches): rank 0 wrote {len(main_files)} files, rank 1 only "
          f"logs/metrics.p1.jsonl; the ranks' patches bit-equal; {r0['driver_s']:.2f} s")
    print(f"phase 24 took {time.perf_counter() - t24:.2f} s (the two ranks "
          f"{spawn_s:.2f} s with their start)")
    return {"attack_p50_ms": (plain["p50_ms"], meshed["p50_ms"])}


def sp_inputs() -> dict:
    """Phase 25's batches, from a seeded numpy generator: 2 frames to serve,
    the b4 attack images with phase 5's live boxes, the b2 float64 and b8
    float32 supervised batches with their boxes, 25e's b8 defender images
    and their live boxes."""
    rng = np.random.default_rng(25)
    hw = SP_HW
    boxes, valid = make_live_slot_boxes(SP_ATTACK_BATCH, (hw, hw), 16)
    return {"frames": [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
                       for _ in range(SP_SERVE_BATCH)],
            "images": rng.uniform(-1, 1, (SP_ATTACK_BATCH, hw, hw, 3)).astype(np.float32),
            "boxes": boxes, "valid": valid,
            "sup64": rng.uniform(-1, 1, (SP_SUP64_BATCH, hw, hw, 3)),
            "gt64": random_gt(rng, SP_SUP64_BATCH, hw),
            "sup32": rng.uniform(-1, 1, (SP_SUP_BATCH, hw, hw, 3)).astype(np.float32),
            "gt32": random_gt(rng, SP_SUP_BATCH, hw),
            "d_images": rng.uniform(-1, 1, (SPD_BATCH, hw, hw, 3)).astype(np.float32),
            "d_live": make_live_slot_boxes(SPD_BATCH, (hw, hw), 16, seed=1),
            "pk_images": rng.uniform(-1, 1, (SPR_PEAK_BATCH, hw, hw, 3)).astype(np.float32),
            "pk_live": make_live_slot_boxes(SPR_PEAK_BATCH, (hw, hw), 16, seed=2),
            "q_frames": [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
                         for _ in range(SPR_INT8_BATCH)],
            "seg_images": rng.uniform(-1, 1, (SPR_SEG_BATCH, hw, hw, 3)).astype(np.float32),
            "seg_masks": rng.integers(0, 3, (SPR_SEG_BATCH, hw // 4, hw // 4)),
            "g_patch": rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)}


def sp_serve(dev, frames, mesh=None, packed_entry: int = 0, check: bool = False) -> dict:
    """The lite4@640 fp32 serve of `frames` (seed 0), host and device
    preprocessing, each after one untimed call: the detections, the fused
    forward and NMS launches, the heights of the fused forward's inputs and
    the host milliseconds of the call; with `check`, the NMS kernel against
    the plain version on the candidates each serve gave it."""
    import torch
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.ops import mbconv_cuda, nms, nms_cuda
    det = Detector("efficientdet-lite4", seed=0, device=dev, mesh=mesh,
                   packed_entry=packed_entry)
    out = {}
    for label, kw in (("host", {}), ("device", {"device_preprocess": True})):
        det.serve(frames, **kw)  # first-call costs: cuDNN plans, kernel loads
        reset_path_counts()
        with Capture([(mbconv_cuda, "mbconv_fwd_cuda"),
                      (nms_cuda, "batched_nms_cuda")]) as cap:
            t0 = time.perf_counter()
            res = det.serve(frames, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = path_counts()
        out[label] = {"det": res, "fwd": counts["mbconv_fp32"], "nms": counts["nms"],
                      "heights": sorted({a[0].shape[1] for a, _ in cap.args["mbconv_fwd_cuda"]}),
                      "ms": ms}
        if check:
            (boxes, scores), nkw = cap.args["batched_nms_cuda"][0]
            out[label]["nms_err"] = compare_nms(
                f"phase 25f {label} serve NMS", nms_cuda.batched_nms_cuda(boxes, scores, **nkw),
                nms.batched_nms(boxes, scores, **nkw))
    return out


def sp_attack_step(dev, inp, images, check: bool = False, packed_entry: int = 0,
                   label: str = "phase 25b") -> dict:
    """One fp32 attack step of phase 5's setup (state seed 1, window 320,
    the live boxes) on `images` (this rank's rows under a spatial mesh),
    with its launches; with `check`, the fused forward and dx (every fifth
    block) and the four warp kernels against their plain versions at the
    inputs this step gave them. `ms`: the host time of a second step (the
    first pays the process's first-call costs)."""
    import torch
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.attack.train import get_victim
    from mladversarialobjectdetection_torch.ops import mbconv_cuda, warp_cuda
    cfg = dp_lite4()
    atk = PatchAttacker(cfg, get_victim(cfg, seed=0, device=dev), window=ATTACK_WINDOW,
                        packed_entry=packed_entry, device=dev)
    state = atk.init_state(1)
    images = torch.as_tensor(images).to(dev)
    override = (torch.from_numpy(inp["boxes"]).to(dev), torch.from_numpy(inp["valid"]).to(dev))
    reset_path_counts()
    with Capture([(warp_cuda, k) for k in WARP_KERNELS]
                 + [(mbconv_cuda, "mbconv_fwd_cuda"), (mbconv_cuda, "mbconv_dx_cuda")]) as cap:
        state, m = atk.train_step(state, images, boxes_override=override)
        torch.cuda.synchronize()
    out = {"loss": float(m.loss), "grad": state.patch.grad.detach().cpu().clone(),
           "patch": state.patch.detach().cpu().clone(), "scale": float(state.scale.detach()),
           "counts": path_counts(),
           "heights": sorted({a[0].shape[1] for a, _ in cap.args["mbconv_fwd_cuda"]}),
           "mbconv": dict(mbconv_cuda.DTYPE_LAUNCHES["float32"]),
           "warp_errs": None, "mbconv_errs": None}
    if check:
        torch.set_grad_enabled(False)
        try:
            (canvases, table, w), _ = cap.args["pass1_fwd"][0]
            (g_in, _, _), _ = cap.args["pass2_bwd"][0]
            out["warp_errs"], _ = check_warp(f"{label} shard", canvases, table, w, g=g_in)
            errs = []
            for i, ((x, g, fb), kw) in enumerate(cap.args["mbconv_dx_cuda"]):
                if i % 5 == 0:
                    errs.append(check_mbconv(f"{label} block call {i} at H {x.shape[1]}",
                                             x, g, fb, kw["act_type"], kw["residual"])[:2])
            out["mbconv_errs"] = tuple(max(e[j] for e in errs) for j in range(2))
        finally:
            torch.set_grad_enabled(True)
    out["ms"] = host_p50_ms(lambda: atk.train_step(state, images, boxes_override=override),
                            iters=1, warmup=0)
    return out


def sp_supervised(dev, images, gt, float64: bool) -> dict:
    """One lite4@640 supervised step (seed 0) on `images` (this rank's rows
    under a spatial mesh): its loss, its fused launches (0: train mode runs
    every block unfused) and its peak memory above what was allocated
    before it (the trainer's state included); in float64 the net after it,
    in float32 the host time of a second step (`ms`)."""
    import gc
    import torch
    from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = DetectorTrainer(dp_lite4(), steps_per_epoch=10, device=dev)
    st = tr.init_state(seed=0)
    if float64:
        st.net.double()
        st.net.compute_dtype = torch.float64
        st.ema = {n: e.double() for n, e in st.ema.items()}
    reset_path_counts()
    st, m = tr.train_step(st, images, *gt)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]),
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "fused": path_counts()["mbconv_fp32"]}
    if float64:
        out["net"] = {k: v.detach().cpu() for k, v in st.net.state_dict().items()}
    else:
        out["ms"] = host_p50_ms(lambda: tr.train_step(st, images, *gt), iters=1, warmup=0)
    del tr, st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spd_defender(dev, inp, bf16: bool):
    """Phase 25e's defender: lite4@640 (victim seed 0) at score threshold
    DEFEND_THRESH, U-Net n_filters 8, fp32 or bf16. Its victim pass and NMS
    run on every call; their boxes are replaced by 25e's live boxes at
    score .9."""
    import torch
    from mladversarialobjectdetection_torch.attack.train import get_victim
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
    cfg = dp_lite4(DEFEND_THRESH)
    cfg.mixed_precision = bf16
    eval_patch = np.random.default_rng(0).uniform(-1, 1, (640, 640, 3)).astype(np.float32)
    dfd = PatchAttackDefender(cfg, get_victim(cfg, seed=0, device=dev),
                              eval_patch=eval_patch, eval_scale=0.4, device=dev)
    boxes, valid = (torch.from_numpy(a).to(dev) for a in inp["d_live"])
    victim_pass = dfd.odet_boxes

    def pinned(images, score_thresh=None):
        victim_pass(images, score_thresh)
        return boxes, torch.full(valid.shape, 0.9, device=dev), valid

    dfd.odet_boxes = pinned
    return dfd


def spd_cmconv_errs(label: str, calls) -> float:
    """Every captured cmconv launch of a step held against the plain version
    at its shard's inputs: fp32 within WARP_TOL of scale (`kernel_err`), bf16
    every element within `cmconv_rounding_bound` (`check_cmconv_sm90`). The
    launches made here are outside every counted run."""
    import torch
    from mladversarialobjectdetection_torch.ops import cmconv, cmconv_cuda
    err = 0.0
    with torch.no_grad():
        for i, ((x, w, bias), _) in enumerate(calls):
            kern = cmconv_cuda.cmconv3x3_cuda(x, w, bias)
            plain = cmconv.cmconv_plain(x, w, bias)
            name = f"phase 25e {label} cmconv call {i} on {tuple(x.shape)}"
            err = max(err, check_cmconv_sm90(name, x, w, bias, kern, plain)
                      if x.dtype == torch.bfloat16 else kernel_err(name, kern, plain))
    return err


def spd_steps(dev, inp, images, check: bool = False) -> dict:
    """Phase 25e's steps on `images` (this rank's rows under the mesh), fp32
    and bf16, each from the U-Net seed 3: one step's loss, U-Net gradient
    (summed over the ranks), launches and peak memory above what was
    allocated before the defender was built; a second step's host ms and
    cmconv calls (their heights; with `check`, each held against the plain
    version). At fp32 also `eval_step` and `recover` from a fresh state."""
    import gc
    import torch
    from mladversarialobjectdetection_torch.ops import cmconv_cuda
    out = {}
    for label, bf16 in (("fp32", False), ("bf16", True)):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dfd = spd_defender(dev, inp, bf16)
        state = dfd.init_state(3)
        reset_path_counts()
        state, m = dfd.train_step(state, images)
        torch.cuda.synchronize()
        r = {"peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
             "loss": float(m.loss), "counts": path_counts(),
             "plan": dict(cmconv_cuda.PLAN_LAUNCHES),
             "grad": torch.cat([p.grad.detach().double().ravel()
                                for p in state.unet.parameters()]).cpu()}
        with Capture([(cmconv_cuda, "cmconv3x3_cuda")]) as cap:
            t0 = time.perf_counter()
            dfd.train_step(state, images)
            torch.cuda.synchronize()
            r["ms"] = (time.perf_counter() - t0) * 1e3
        calls = cap.args["cmconv3x3_cuda"]
        r["heights"] = sorted({a[0].shape[2] for a, _ in calls})
        if check:
            r["err"] = spd_cmconv_errs(label, calls)
        del cap, calls
        if not bf16:
            fresh = dfd.init_state(3)
            reset_path_counts()
            em = dfd.eval_step(fresh, images, 0)
            r["recover"] = dfd.recover(fresh, images).cpu()
            torch.cuda.synchronize()
            r["eval"] = {k: float(v) for k, v in em._asdict().items()}
            r["eval_counts"] = path_counts()
        out[label] = r
        del dfd, state
    return out


def spd_driver(dev, work: str, rank: int) -> dict:
    """25e: `defense.train.train(spatial=2)` on this rank, b12 bf16, 2
    synthetic steps and 5 val batches: its U-Net, launches and seconds."""
    import os
    import torch
    from mladversarialobjectdetection_torch.defense.train import train as defense_train
    from mladversarialobjectdetection_torch.ops import cmconv_cuda
    t0 = time.perf_counter()
    reset_path_counts()
    st = defense_train("efficientdet-lite4", synthetic=True, batch_size=SPD_DRIVER_BATCH,
                       epochs=1, steps_per_epoch=2, bf16=True, spatial=2, device=dev,
                       save_dir=os.path.join(work, f"ddriver{rank}"),
                       config_override={"nms_configs": {"score_thresh": DEFEND_THRESH}})
    torch.cuda.synchronize()
    return {"unet": {k: v.detach().cpu() for k, v in st.unet.state_dict().items()},
            "s": time.perf_counter() - t0, "counts": path_counts(),
            "plan": dict(cmconv_cuda.PLAN_LAUNCHES)}


def sp_rank(rank: int, work: str, device: str = "cuda") -> None:
    """Phase 25 on one of two ranks (gloo, both on the one card), at mesh
    ('data', 'spatial') = (1, 2): each image's rows split over the ranks.
    Results to work/s{rank}.pt."""
    import os
    import torch
    from mladversarialobjectdetection_torch import parallel
    from mladversarialobjectdetection_torch.attack.train import train

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    inp = sp_inputs()
    mesh = parallel.make_train_mesh(SP_ATTACK_BATCH, 2, image_h=SP_HW, device=dev)
    mine = lambda x: parallel.shard_batch(mesh, x)  # this rank's rows, on the card
    out = {"serve": sp_serve(dev, inp["frames"], mesh)}
    with parallel.use_mesh(mesh):
        out["attack"] = sp_attack_step(dev, inp, mine(inp["images"]),
                                       check=dev.type == "cuda")
        out["sup64"] = sp_supervised(dev, mine(inp["sup64"]), inp["gt64"], True)
        out["sup32"] = sp_supervised(dev, mine(inp["sup32"]), inp["gt32"], False)
    t0 = time.perf_counter()
    reset_path_counts()
    # a score threshold under the random victim's scores gives it live slots
    st = train("efficientdet-lite4", synthetic=True, batch_size=DRIVER_BATCH, epochs=1,
               steps_per_epoch=2, visualize_freq=0, spatial=2, device=dev,
               save_dir=os.path.join(work, f"sdriver{rank}"),
               config_override={"nms_configs": {"score_thresh": DEFEND_THRESH}})
    torch.cuda.synchronize()
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    out["driver"] = {"patch": st.patch.detach().cpu(), "scale": float(st.scale.detach()),
                     "s": time.perf_counter() - t0, "counts": path_counts(),
                     "sm90": dict(mbconv_cuda.BF16_FWD_LAUNCHES),
                     "sm90_dx": dict(mbconv_cuda.BF16_DX_LAUNCHES)}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # 25e: the defender
    t0 = time.perf_counter()
    with parallel.use_mesh(mesh):
        out["defender"] = spd_steps(dev, inp, mine(inp["d_images"]), check=True)
    out["ddriver"] = spd_driver(dev, work, rank)
    out["defender_s"] = time.perf_counter() - t0
    # 25f: the packed entry, int8, segmentation, the gather backend
    out["rest"] = spr_run(dev, inp, work, mesh, rank)
    torch.save(out, os.path.join(work, f"s{rank}.pt"))


def spatial_defender_checks(ranks, ref, work: str) -> dict:
    """Phase 25e's checks, each rank against one process: the steps' losses
    and summed gradients, their launches (15 cmconv on shards of SPD_HEIGHTS,
    all fp32 or all on the Hopper bf16 instance; 25 fused forward, 2 warp
    forwards and 1 NMS), a rank's peak memory, eval_step, recover's rows and
    the driver. Returns each step's launches on rank 0."""
    import os
    import torch
    r0, r1 = (r["defender"] for r in ranks)
    lines = []
    for label, cos_min in (("fp32", SPD_GRAD_COS), ("bf16", SPD_BF16_GRAD_COS)):
        bf16 = label == "bf16"
        want = dict.fromkeys(WARP_KERNELS, 0)
        want.update(pass1_fwd=1, pass2_fwd=1, nms=1,
                    mbconv_fwd_bf16=MBCONV_PER_PASS if bf16 else 0, mbconv_dx_bf16=0,
                    mbconv_fp32=0 if bf16 else MBCONV_PER_PASS,
                    cmconv_bf16=CMCONV_PER_STEP if bf16 else 0, cmconv_bf16_simt=0,
                    cmconv_fp32=0 if bf16 else CMCONV_PER_STEP)
        for i, r in enumerate((r0, r1)):
            got = r[label]
            if got["counts"] != want:
                fail(f"phase 25e {label} step: rank {i} launched {got['counts']}, want {want}")
            if got["heights"] != SPD_HEIGHTS:
                fail(f"phase 25e {label} step: rank {i}'s cmconv launches at heights "
                     f"{got['heights']}, want {SPD_HEIGHTS}")
            if bf16 and got["plan"]["sm90_bf16"] != CMCONV_PER_STEP:
                fail(f"phase 25e bf16 step: rank {i}'s cmconv launches by instance "
                     f"{got['plan']}, want all {CMCONV_PER_STEP} on the Hopper instance")
        a, b, one = r0[label], r1[label], ref[label]
        loss_rel = abs(a["loss"] - one["loss"]) / abs(one["loss"])
        cos = float(a["grad"] @ one["grad"] / (a["grad"].norm() * one["grad"].norm()))
        if not (loss_rel <= SPD_LOSS_REL and cos >= cos_min and a["loss"] == b["loss"]
                and torch.equal(a["grad"], b["grad"])):
            fail(f"phase 25e {label} step: loss {loss_rel:.3g} relative (limit "
                 f"{SPD_LOSS_REL}), U-Net gradient cosine {cos:.8f} (limit {cos_min}), "
                 f"ranks alike {a['loss'] == b['loss'] and torch.equal(a['grad'], b['grad'])}")
        lines.append(f"{label}: loss {loss_rel:.3g} relative to one process, U-Net gradient "
                     f"cosine {cos:.8f} (limit {cos_min}), the ranks alike; a rank launched "
                     f"{ {k: v for k, v in a['counts'].items() if v} }, cmconv at heights "
                     f"{a['heights']} (one process {one['heights']}), each held against the "
                     f"plain version at its shard's inputs: max error {a['err']:.3g} / "
                     f"{b['err']:.3g}; peak {a['peak_gb']:.3f} / {b['peak_gb']:.3f} GB a rank, "
                     f"one process {one['peak_gb']:.3f} GB "
                     f"({max(a['peak_gb'], b['peak_gb']) / one['peak_gb']:.3f}x); second step "
                     f"{a['ms']:.1f} / {b['ms']:.1f} ms a rank, one process {one['ms']:.1f}")
    peak = max(r0["fp32"]["peak_gb"], r1["fp32"]["peak_gb"]) / ref["fp32"]["peak_gb"]
    if peak >= SP_PEAK_RATIO:
        fail(f"phase 25e: a rank's b{SPD_BATCH} fp32 defender step peaks at {peak:.3f}x "
             f"the one-process step, not below {SP_PEAK_RATIO}")
    # eval_step and recover
    em = ref["fp32"]["eval"]
    want = dict.fromkeys(WARP_KERNELS, 0)
    want.update(pass1_fwd=1, pass2_fwd=1, nms=3, mbconv_fwd_bf16=0, mbconv_dx_bf16=0,
                mbconv_fp32=3 * MBCONV_PER_PASS, cmconv_bf16=0, cmconv_bf16_simt=0,
                cmconv_fp32=CMCONV_PER_STEP + 1)  # 8 forward in each
    for i, r in enumerate((r0, r1)):
        got = r["fp32"]
        if got["eval_counts"] != want:
            fail(f"phase 25e eval_step and recover: rank {i} launched {got['eval_counts']}, "
                 f"want {want}")
        for k in ("loss", "recovery_psnr", "adr"):
            a, one = got["eval"][k], em[k]
            same = (np.isnan(a) and np.isnan(one)) or abs(a - one) <= SPD_LOSS_REL * abs(one)
            if not same:
                fail(f"phase 25e eval_step: rank {i}'s {k} {a} against one process's {one}")
    rec = torch.cat([r0["fp32"]["recover"], r1["fp32"]["recover"]], dim=1)
    one = ref["fp32"]["recover"]
    rec_err = float((rec - one).abs().max()) / max(1.0, float(one.abs().max()))
    if rec_err > SPD_RECOVER_TOL:
        fail(f"phase 25e recover: the ranks' rows within {rec_err:.3g} of scale of one "
             f"process (limit {SPD_RECOVER_TOL})")
    # the driver
    d0, d1 = (r["ddriver"] for r in ranks)
    if any(not torch.equal(v, d1["unet"][k]) for k, v in d0["unet"].items()):
        fail("phase 25e: the ranks' U-Nets differ after defense.train.train(spatial=2)")
    main_files = set(os.path.relpath(os.path.join(p, f), os.path.join(work, "ddriver0"))
                     for p, _, fs in os.walk(os.path.join(work, "ddriver0")) for f in fs)
    if not ({"logs/metrics.jsonl", "state-latest.msgpack"} <= main_files
            and any(f.endswith("antipatch.pkl") for f in main_files)):
        fail(f"phase 25e: rank 0 of the driver wrote {sorted(main_files)}")
    rank1_files = [os.path.join(p, f) for p, _, fs in os.walk(os.path.join(work, "ddriver1"))
                   for f in fs]
    if [os.path.basename(f) for f in rank1_files] != ["metrics.p1.jsonl"]:
        fail(f"phase 25e: rank 1 of the driver wrote {rank1_files}")
    launched_every("phase 25e driver", d0["counts"], ("pass1_fwd", "pass2_fwd", "nms",
                                                      "mbconv_fwd_bf16", "cmconv_bf16"))
    if d0["counts"]["cmconv_fp32"] or d0["plan"]["sm90_bf16"] != d0["counts"]["cmconv_bf16"]:
        fail(f"phase 25e driver: cmconv launches {d0['counts']}, by instance {d0['plan']}")
    print("phase 25e spatial defender, lite4@640 b" + str(SPD_BATCH) + ", U-Net n_filters "
          "8, mesh (1, 2), the live boxes: " + "; ".join(lines)
          + f"; eval_step loss {em['loss']:.6f}, PSNR {em['recovery_psnr']:.4f} dB, ADR "
          f"{em['adr']} as one process's (a rank launched "
          f"{ {k: v for k, v in r0['fp32']['eval_counts'].items() if v} } for eval_step "
          f"and recover), recover's rows within {rec_err:.3g} of scale; "
          f"defense.train.train(spatial=2) at b{SPD_DRIVER_BATCH} bf16 (2 steps, 5 val "
          f"batches): the ranks' U-Nets bit-equal, rank 0 alone wrote files, launches a "
          f"rank {d0['counts']} in {d0['s']:.2f} s")
    return {label: r0[label]["counts"] for label in ("fp32", "bf16")}


def spr_peak(dev, inp, images, check: bool = False) -> dict:
    """25f: one packed (`SPR_PACKED`) bf16 attack step at b`SPR_PEAK_BATCH`
    on `images` (this rank's rows under the mesh), state seed 1, the live
    boxes: its loss, launches (by Hopper kernel too) and peak memory above
    what was allocated before the victim was built, and a second step's
    host ms; with `check`, every fifth Hopper forward and dx call against the
    plain versions at the inputs this step gave them."""
    import gc
    import torch
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.attack.train import get_victim
    from mladversarialobjectdetection_torch.ops import mbconv_cuda
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = dp_lite4()
    cfg.mixed_precision = True
    atk = PatchAttacker(cfg, get_victim(cfg, seed=0, device=dev), window=ATTACK_WINDOW,
                        packed_entry=SPR_PACKED, device=dev)
    state = atk.init_state(1)
    images = torch.as_tensor(images).to(dev)
    override = tuple(torch.from_numpy(a).to(dev) for a in inp["pk_live"])
    reset_path_counts()
    with Capture([(mbconv_cuda, "mbconv_fwd_cuda"), (mbconv_cuda, "mbconv_dx_cuda")]) as cap:
        state, m = atk.train_step(state, images, with_asr=False, boxes_override=override)
        torch.cuda.synchronize()
    out = {"loss": float(m.loss), "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "counts": path_counts(), "sm90": dict(mbconv_cuda.BF16_FWD_LAUNCHES),
           "sm90_dx": dict(mbconv_cuda.BF16_DX_LAUNCHES), "errs": None}
    if check:
        torch.set_grad_enabled(False)
        try:
            fwd = [check_sm90(f"phase 25f bf16 forward call {i} at H {x.shape[1]}", x, fb,
                              kw["act_type"], kw["residual"])[0]
                   for i, ((x, fb), kw) in enumerate(cap.args["mbconv_fwd_cuda"]) if i % 5 == 0]
            dx = [check_sm90_dx(f"phase 25f bf16 dx call {i} at H {x.shape[1]}", x, g, fb,
                                kw["act_type"], kw["residual"])[0]
                  for i, ((x, g, fb), kw) in enumerate(cap.args["mbconv_dx_cuda"]) if i % 5 == 0]
            out["errs"] = (max(fwd), max(dx))
        finally:
            torch.set_grad_enabled(True)
    del cap
    out["ms"] = host_p50_ms(lambda: atk.train_step(state, images, with_asr=False,
                                                   boxes_override=override), iters=1, warmup=0)
    del atk, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spr_int8(dev, frames, work: str, mesh=None) -> dict:
    """25f: `Detector.quantize_int8` on `frames` (lite4@640 fp32, seed 0),
    then the int8 forward of the same frames, preprocessed on the host (this
    rank's rows under `mesh`): the activation scales, the launches and calls
    of `conv_int8`, and the head outputs. One process writes its outputs to
    `work`; a rank holds its own against them (at most SPR_INT8_SHARE off by
    more than SPR_INT8_ATOL) and every `conv_int8` call it made bit-equal to
    the plain version at its inputs."""
    import gc
    import os
    import torch
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.ops import conv_int8 as ci
    det = Detector("efficientdet-lite4", seed=0, device=dev, mesh=mesh)
    det.quantize_int8(frames)
    images = torch.from_numpy(det.preprocess(frames)[0])
    x = det._own_rows(images).to(dev)
    with torch.no_grad(), det._in_mesh():
        det._int8(x)  # first-call costs
        torch.cuda.synchronize()
        reset_path_counts()
        ci.reset_counts()
        with Capture([(ci, "conv_int8_cuda")]) as cap:
            cls, box = det._int8(x)
            torch.cuda.synchronize()
    flat = torch.cat([o.reshape(o.shape[0], -1) for o in cls + box], 1)
    out = {"scales": dict(det._int8.act_scales), "launches": ci.LAUNCHES, "calls": ci.CALLS,
           "instances": dict(ci.INSTANCE_LAUNCHES), "counts": path_counts(),
           "halo_calls": sum(isinstance(kw.get("padding"), tuple)
                             for _, kw in cap.args["conv_int8_cuda"])}
    path = os.path.join(work, "int8_ref.pt")
    if mesh is None:
        torch.save(flat.cpu(), path)
    else:
        ref = torch.load(path).to(dev)
        diff = (flat - ref).abs()
        out.update(share=float((diff > SPR_INT8_ATOL).double().mean()),
                   max_err=float(diff.max()))
        del ref, diff
        with torch.no_grad():
            for i, call in enumerate(cap.args["conv_int8_cuda"]):
                x_, a_s, wq, scale, bias, kw = int8_call(call)
                check_conv_int8(f"phase 25f int8 conv {i} on {tuple(x_.shape)} "
                                f"({kw.get('padding')})", x_, a_s, wq, scale, bias, kw)
    del cap, det, flat, cls, box
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spr_seg(dev, images, masks, float64: bool) -> dict:
    """25f: one lite4@640 segmentation step (seed 0) on `images` (this rank's
    rows under the mesh) and the data shard's masks, fp32 or float64: its
    loss, the gradient summed over the ranks, its fused launches (0: train
    mode), its peak memory above what was allocated before the trainer was
    built; in fp32 a second step's host ms."""
    import gc
    import torch
    from mladversarialobjectdetection_torch.train.segmentation import SegmentationTrainer
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = SegmentationTrainer(dp_lite4(), device=dev)
    st = tr.init_state(seed=0)
    images = torch.as_tensor(images).to(dev)
    if float64:
        st.net.double()
        st.net.compute_dtype = torch.float64
        images = images.double()
    reset_path_counts()
    st, m = tr.train_step(st, images, masks)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "counts": path_counts(),
           "grad": torch.cat([p.grad.detach().double().ravel()
                              for p in st.net.parameters()]).cpu()}
    if not float64:
        out["ms"] = host_p50_ms(lambda: tr.train_step(st, images, masks), iters=1, warmup=0)
    del tr, st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spr_gather(dev, inp, images) -> tuple:
    """25f: `eot.apply_patches(backend="gather")` on `images` (this rank's
    rows under the mesh) and the live boxes: (patched rows, region rows)."""
    import torch
    from mladversarialobjectdetection_torch.ops import eot
    out, region = eot.apply_patches(
        images, inp["boxes"], inp["valid"], inp["g_patch"], 0.4, backend="gather",
        generator=torch.Generator(dev).manual_seed(5), device=dev, height=SP_HW)
    return out.cpu(), region.cpu()


def spr_driver(dev, work: str, rank: int) -> dict:
    """25f: `attack.train.train(spatial=2, packed_entry=SPR_PACKED)` on this
    rank, b`SPR_DRIVER_BATCH` bf16, 2 synthetic steps: its patch, launches
    and seconds."""
    import os
    import torch
    from mladversarialobjectdetection_torch.attack.train import train
    t0 = time.perf_counter()
    reset_path_counts()
    st = train("efficientdet-lite4", synthetic=True, batch_size=SPR_DRIVER_BATCH, epochs=1,
               steps_per_epoch=2, visualize_freq=0, spatial=2, packed_entry=SPR_PACKED,
               device=dev, save_dir=os.path.join(work, f"pdriver{rank}"),
               config_override={"nms_configs": {"score_thresh": DEFEND_THRESH}})
    torch.cuda.synchronize()
    return {"patch": st.patch.detach().cpu(), "scale": float(st.scale.detach()),
            "s": time.perf_counter() - t0, "counts": path_counts()}


def spr_run(dev, inp, work: str, mesh=None, rank: int = 0) -> dict:
    """Phase 25f's runs: on this rank under `mesh` (each kernel then held
    against its plain version at the rank's inputs, and the driver), or in
    one process without a mesh."""
    import contextlib
    import torch
    from mladversarialobjectdetection_torch import parallel
    ranked = mesh is not None
    t0 = time.perf_counter()
    mine = ((lambda x: parallel.shard_batch(mesh, x)) if ranked
            else (lambda x: torch.from_numpy(x).to(dev)))
    out = {"serve": sp_serve(dev, inp["frames"], mesh, packed_entry=SPR_PACKED, check=ranked),
           "int8": spr_int8(dev, inp["q_frames"], work, mesh)}
    with parallel.use_mesh(mesh) if ranked else contextlib.nullcontext():
        out["attack"] = sp_attack_step(dev, inp, mine(inp["images"]), check=ranked,
                                       packed_entry=SPR_PACKED, label="phase 25f")
        out["peak"] = spr_peak(dev, inp, mine(inp["pk_images"]), check=ranked)
        out["seg"] = spr_seg(dev, mine(inp["seg_images"]), inp["seg_masks"], False)
        out["seg64"] = spr_seg(dev, mine(inp["seg_images"]), inp["seg_masks"], True)
        out["gather"] = spr_gather(dev, inp, mine(inp["images"]))
    if ranked:
        out["driver"] = spr_driver(dev, work, rank)
    out["s"] = time.perf_counter() - t0
    return out


def spatial_rest_checks(ranks, ref, work: str) -> dict:
    """Phase 25f's checks, each rank against one process, and each rank's
    launches against the expected counts. Returns rank 0's launches of each
    run."""
    import os
    import torch
    r0, r1 = (r["rest"] for r in ranks)
    lines = []
    # the packed serve
    s_err = b_err = 0.0
    for r in (r0, r1):
        for label in ("host", "device"):
            got, want = r["serve"][label], ref["serve"][label]
            if (got["fwd"], got["nms"]) != (MBCONV_PER_PASS, 1):
                fail(f"phase 25f packed {label} serve: {got['fwd']} fused forward and "
                     f"{got['nms']} NMS launches a rank, want {MBCONV_PER_PASS} and 1")
            for field in ("classes", "valid", "valid_len"):
                if not np.array_equal(getattr(got["det"], field), getattr(want["det"], field)):
                    fail(f"phase 25f packed {label} serve: {field} differ from one process")
            s_err = max(s_err, float(np.abs(got["det"].scores - want["det"].scores).max()))
            b_err = max(b_err, float(np.abs(got["det"].boxes - want["det"].boxes).max()))
    if s_err > DP_SERVE_SCORE_TOL or b_err > DP_SERVE_BOX_TOL:
        fail(f"phase 25f packed serve: scores within {s_err:.3g}, boxes within {b_err:.3g} px "
             f"of one process")
    sv = r0["serve"]["host"]
    lines.append(f"the packed_entry={SPR_PACKED} b{SP_SERVE_BATCH} serve (host and device "
                 f"preprocessing): scores within {s_err:.3g}, boxes within {b_err:.3g} px of "
                 f"one process, {sv['fwd']} fused forward launches a rank a pass at heights "
                 f"{sv['heights']}, the NMS kernel within {sv['nms_err']:.3g} of the plain "
                 f"version at a rank's candidates; second serve {sv['ms']:.1f} / "
                 f"{r1['serve']['host']['ms']:.1f} ms a rank, one process "
                 f"{ref['serve']['host']['ms']:.1f}")
    # the packed fp32 attack step
    a0, a1, ar = r0["attack"], r1["attack"], ref["attack"]
    loss_rel = abs(a0["loss"] - ar["loss"]) / abs(ar["loss"])
    g, gr = a0["grad"].double().ravel(), ar["grad"].double().ravel()
    cos = float(g @ gr / (g.norm() * gr.norm()))
    if not (loss_rel <= DP_LOSS_REL and cos >= DP_GRAD_COS
            and torch.equal(a0["patch"], a1["patch"])):
        fail(f"phase 25f packed attack: loss {loss_rel:.3g} relative, patch gradient cosine "
             f"{cos:.7f}, ranks' patches equal {torch.equal(a0['patch'], a1['patch'])}")
    want = dict.fromkeys(WARP_KERNELS, 1)
    want.update(nms=2, mbconv_fwd=2 * MBCONV_PER_PASS, mbconv_dx=MBCONV_PER_PASS)
    for r in (r0, r1):
        got = {**{k: r["attack"]["counts"][k] for k in (*WARP_KERNELS, "nms")},
               **r["attack"]["mbconv"]}
        if got != want:
            fail(f"phase 25f packed attack: a rank launched {got}, want {want}")
    lines.append(f"the packed b{SP_ATTACK_BATCH} fp32 attack step: loss {loss_rel:.3g} "
                 f"relative, patch gradient cosine {cos:.7f}, the ranks' patches bit-equal; "
                 f"a rank launched {want} (fused forward at heights {a0['heights']}); the "
                 f"warp kernels within {a0['warp_errs']} and the fused forward / dx within "
                 f"{a0['mbconv_errs']} of their plain versions at rank 0's inputs; second "
                 f"step {a0['ms']:.1f} / {a1['ms']:.1f} ms a rank, one process {ar['ms']:.1f}")
    # the packed bf16 step's peak
    p0, p1, pr = r0["peak"], r1["peak"], ref["peak"]
    want = dict.fromkeys(WARP_KERNELS, 1)
    want.update(nms=1, mbconv_fwd_bf16=2 * MBCONV_PER_PASS, mbconv_dx_bf16=MBCONV_PER_PASS,
                mbconv_fp32=0, cmconv_bf16=0, cmconv_bf16_simt=0, cmconv_fp32=0)
    for r in (p0, p1):
        if r["counts"] != want:
            fail(f"phase 25f packed bf16 step: a rank launched {r['counts']}, want {want}")
        if (r["sm90"]["instance"], r["sm90_dx"]["instance"]) != (0, 0):
            fail(f"phase 25f packed bf16 step: bf16 launches by kernel {r['sm90']}, "
                 f"{r['sm90_dx']}, want all on the Hopper kernels")
    bloss_rel = abs(p0["loss"] - pr["loss"]) / abs(pr["loss"])
    if not (bloss_rel <= PACKED_LOSS_REL and p0["loss"] == p1["loss"]):
        fail(f"phase 25f packed bf16 step: loss {bloss_rel:.3g} relative to one process "
             f"(limit {PACKED_LOSS_REL}), ranks alike {p0['loss'] == p1['loss']}")
    peak = max(p0["peak_gb"], p1["peak_gb"]) / pr["peak_gb"]
    lines.append(f"the packed b{SPR_PEAK_BATCH} bf16 attack step: loss {bloss_rel:.3g} "
                 f"relative, a rank launched { {k: v for k, v in p0['counts'].items() if v} } "
                 f"(all bf16 MBConv on the Hopper kernels), every fifth Hopper forward / dx "
                 f"within {p0['errs']} of the plain versions; peak {p0['peak_gb']:.3f} / "
                 f"{p1['peak_gb']:.3f} GB a rank, one process {pr['peak_gb']:.3f} GB "
                 f"({peak:.3f}x); second step {p0['ms']:.1f} / {p1['ms']:.1f} ms a rank, one "
                 f"process {pr['ms']:.1f}")
    # the int8 serve
    q0, q1, qr = r0["int8"], r1["int8"], ref["int8"]
    for i, q in enumerate((q0, q1)):
        if q["scales"] != qr["scales"]:
            fail(f"phase 25f int8: rank {i}'s activation scales differ from one process's")
        if (q["calls"] != qr["calls"] or q["launches"] != qr["calls"]
                or q["instances"] != {"sm90": qr["calls"], "simt": 0}):
            fail(f"phase 25f int8: rank {i} made {q['calls']} conv_int8 calls and "
                 f"{q['launches']} launches {q['instances']}, one process {qr['calls']} "
                 f"calls (want one Hopper launch a call)")
        if any(q["counts"].values()):
            fail(f"phase 25f int8: rank {i} launched {q['counts']} beside conv_int8")
        if not q["share"] <= SPR_INT8_SHARE:
            fail(f"phase 25f int8: rank {i}'s head outputs {q['share']:.4g} off by more than "
                 f"{SPR_INT8_ATOL} (limit {SPR_INT8_SHARE})")
    lines.append(f"quantize_int8 at b{SPR_INT8_BATCH}: the {len(q0['scales'])} activation "
                 f"scales bit-equal to one process's; a rank made {q0['calls']} conv_int8 "
                 f"calls ({q0['launches']} launches, all of the Hopper kernel; "
                 f"{q0['halo_calls']} on halo-extended rows), each bit-equal to the plain "
                 f"version at its inputs; the head "
                 f"outputs {q0['share']:.4g} / {q1['share']:.4g} off by more than "
                 f"{SPR_INT8_ATOL} (max {q0['max_err']:.3g} / {q1['max_err']:.3g})")
    # the segmentation step: the function in float64 (within 1e-8 of scale,
    # 25c's rule); the fp32 step is ill-conditioned (train-mode BatchNorm's
    # E[x^2] - E[x]^2 in float32, ROADMAP Queue 3 item 22), so its gradient is
    # held to the float64 one: no farther than twice one process's own
    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()))
    g0, g1, gr, gr64 = r0["seg"], r1["seg"], ref["seg"], ref["seg64"]
    h0, h1 = r0["seg64"], r1["seg64"]
    seg64_rel = abs(h0["loss"] - gr64["loss"]) / abs(gr64["loss"])
    seg64_err = float((h0["grad"] - gr64["grad"]).abs().max()) / max(
        1.0, float(gr64["grad"].abs().max()))
    if not (seg64_rel <= SP_SUP_F64_TOL and seg64_err <= SP_SUP_F64_TOL
            and torch.equal(h0["grad"], h1["grad"])):
        fail(f"phase 25f float64 segmentation step: loss {seg64_rel:.3g} relative, gradient "
             f"within {seg64_err:.3g} of scale (limit {SP_SUP_F64_TOL}), ranks alike "
             f"{torch.equal(h0['grad'], h1['grad'])}")
    seg_rel = abs(g0["loss"] - gr["loss"]) / abs(gr["loss"])
    seg_cos = cos(g0["grad"], gr["grad"])
    own, mine = 1.0 - cos(gr["grad"], gr64["grad"]), 1.0 - cos(g0["grad"], gr64["grad"])
    if not (seg_rel <= DP_LOSS_REL and mine <= 2 * own and g0["loss"] == g1["loss"]
            and torch.equal(g0["grad"], g1["grad"])):
        fail(f"phase 25f segmentation step: loss {seg_rel:.3g} relative, gradient cosine "
             f"{1 - mine:.8f} to the float64 one (one process's {1 - own:.8f}), ranks alike "
             f"{torch.equal(g0['grad'], g1['grad'])}")
    if any(g["counts"]["mbconv_fp32"] or g["counts"]["mbconv_fwd_bf16"]
           for g in (g0, g1, h0, h1)):
        fail(f"phase 25f segmentation step: fused launches in a train step {g0['counts']}")
    seg_peak = max(g0["peak_gb"], g1["peak_gb"]) / gr["peak_gb"]
    lines.append(f"the b{SPR_SEG_BATCH} segmentation step: float64 loss {seg64_rel:.3g} "
                 f"relative, gradient within {seg64_err:.3g} of scale; fp32 loss "
                 f"{seg_rel:.3g} relative, gradient cosine {seg_cos:.8f} to one process's "
                 f"fp32 and {1 - mine:.8f} to the float64 one (one process's fp32 "
                 f"{1 - own:.8f}), the ranks alike, no fused launch; fp32 peak "
                 f"{g0['peak_gb']:.3f} / {g1['peak_gb']:.3f} GB a rank, one process "
                 f"{gr['peak_gb']:.3f} GB ({seg_peak:.3f}x); second step {g0['ms']:.1f} / "
                 f"{g1['ms']:.1f} ms a rank, one process {gr['ms']:.1f}")
    # the gather backend
    out, region = ref["gather"]
    h = SP_HW // 2
    g_err = 0.0
    for i, r in enumerate((r0, r1)):
        got_out, got_region = r["gather"]
        if not torch.equal(got_region, region[:, i * h:(i + 1) * h]):
            fail(f"phase 25f gather backend: rank {i}'s regions differ from one process's")
        g_err = max(g_err, float((got_out - out[:, i * h:(i + 1) * h]).abs().max()))
    if not (g_err <= SPR_GATHER_TOL and bool(region.any())):
        fail(f"phase 25f gather backend: rows within {g_err:.3g} (limit {SPR_GATHER_TOL}), "
             f"{int(region.sum())} region pixels")
    lines.append(f"the gather backend: a rank's rows within {g_err:.3g} of one process's, the "
                 f"regions equal ({int(region.sum())} pixels)")
    # the packed driver
    d0, d1 = r0["driver"], r1["driver"]
    if not (torch.equal(d0["patch"], d1["patch"]) and d0["scale"] == d1["scale"]):
        fail("phase 25f: the ranks' patches differ after attack.train.train(spatial=2, "
             f"packed_entry={SPR_PACKED})")
    main_files = set(os.path.relpath(os.path.join(p, f), os.path.join(work, "pdriver0"))
                     for p, _, fs in os.walk(os.path.join(work, "pdriver0")) for f in fs)
    if not {"logs/metrics.jsonl", "state-latest.msgpack"} <= main_files:
        fail(f"phase 25f driver: rank 0 wrote {sorted(main_files)}")
    rank1_files = [os.path.basename(f) for p, _, fs in os.walk(os.path.join(work, "pdriver1"))
                   for f in fs]
    if rank1_files != ["metrics.p1.jsonl"]:
        fail(f"phase 25f driver: rank 1 wrote {rank1_files}")
    launched_every("phase 25f driver", d0["counts"], ("pass1_fwd", "pass2_fwd", "pass2_bwd",
                                                      "pass1_bwd", "nms", "mbconv_fwd_bf16",
                                                      "mbconv_dx_bf16"))
    lines.append(f"attack.train.train(spatial=2, packed_entry={SPR_PACKED}) at "
                 f"b{SPR_DRIVER_BATCH} bf16 (2 steps and 5 val batches): the ranks' patches "
                 f"bit-equal, rank 0 alone wrote files, launches a rank {d0['counts']} in "
                 f"{d0['s']:.2f} s")
    print("phase 25f spatial partitioning of the rest, lite4@640, mesh (1, 2): "
          + "; ".join(lines))
    print(f"phase 25f took {ref['s'] + max(r0['s'], r1['s']):.2f} s (one process "
          f"{ref['s']:.2f} s, then a rank's share of the two ranks' run {r0['s']:.2f} / "
          f"{r1['s']:.2f} s)")
    return {"serve": sv["fwd"], "serve_nms": sv["nms"], "attack": r0["attack"]["counts"],
            "attack_mbconv": r0["attack"]["mbconv"], "peak": p0["counts"],
            "int8": q0["launches"], "driver": d0["counts"],
            "peak_ratio": peak, "seg_peak_ratio": seg_peak}


def spatial_phase(dev, work: str, rank_fn=sp_rank) -> dict:
    """Phase 25: spatial partitioning (`parallel/spatial.py`), two ranks at
    mesh (1, 2) on the one card through gloo, each step against the
    one-process step in this process. Returns the kernels' launches a rank
    in the b4 attack step."""
    import os
    import torch
    from mladversarialobjectdetection_torch.parallel import launch

    t25 = time.perf_counter()
    inp = sp_inputs()
    ref = {"serve": sp_serve(dev, inp["frames"]),
           "attack": sp_attack_step(dev, inp, inp["images"]),
           "sup64": sp_supervised(dev, inp["sup64"], inp["gt64"], True),
           "sup32": sp_supervised(dev, inp["sup32"], inp["gt32"], False)}
    t0 = time.perf_counter()
    ref["defender"] = spd_steps(dev, inp, inp["d_images"])
    ref_defender_s = time.perf_counter() - t0
    ref["rest"] = spr_run(dev, inp, work)
    t0 = time.perf_counter()
    launch.spawn(rank_fn, 2, (work, dev.type), init_method=f"file://{work}/sstore",
                 backend="gloo", timeout_s=SP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"s{r}.pt"), weights_only=False)
             for r in range(2)]
    r0, r1 = ranks
    # 25a: the serve
    s_err = b_err = 0.0
    for r in ranks:
        for label in ("host", "device"):
            got, want = r["serve"][label], ref["serve"][label]
            if (got["fwd"], got["nms"]) != (MBCONV_PER_PASS, 1):
                fail(f"phase 25a {label} serve: {got['fwd']} fused forward and "
                     f"{got['nms']} NMS launches a rank, want {MBCONV_PER_PASS} and 1")
            for field in ("classes", "valid", "valid_len"):
                if not np.array_equal(getattr(got["det"], field), getattr(want["det"], field)):
                    fail(f"phase 25a {label} serve: {field} differ from one process")
            s_err = max(s_err, float(np.abs(got["det"].scores - want["det"].scores).max()))
            b_err = max(b_err, float(np.abs(got["det"].boxes - want["det"].boxes).max()))
            if s_err > DP_SERVE_SCORE_TOL or b_err > DP_SERVE_BOX_TOL:
                fail(f"phase 25a {label} serve: scores within {s_err:.3g}, boxes within "
                     f"{b_err:.3g} px of one process")
    sv = r0["serve"]
    print(f"phase 25a spatial serve, lite4@640 fp32 b{SP_SERVE_BATCH}, mesh (1, 2): host "
          f"and device preprocessing, classes and valid equal to one process, scores "
          f"within {s_err:.3g} and boxes within {b_err:.3g} px of it (limits "
          f"{DP_SERVE_SCORE_TOL} / {DP_SERVE_BOX_TOL}); "
          f"{sv['host']['fwd']} fused forward launches a rank a pass at heights "
          f"{sv['host']['heights']} (one process: {ref['serve']['host']['heights']}); "
          f"second serve {sv['host']['ms']:.1f} / {r1['serve']['host']['ms']:.1f} ms a "
          f"rank (host path), {sv['device']['ms']:.1f} / {r1['serve']['device']['ms']:.1f} "
          f"(device), one process {ref['serve']['host']['ms']:.1f} / "
          f"{ref['serve']['device']['ms']:.1f}")
    # 25b: the attack step
    a0, a1, ar = r0["attack"], r1["attack"], ref["attack"]
    loss_rel = abs(a0["loss"] - ar["loss"]) / abs(ar["loss"])
    g, gr = a0["grad"].double().ravel(), ar["grad"].double().ravel()
    cos = float(g @ gr / (g.norm() * gr.norm()))
    norm_rel = abs(float(g.norm()) / float(gr.norm()) - 1.0)
    patch_err = float((a0["patch"] - ar["patch"]).abs().max())
    if not (loss_rel <= DP_LOSS_REL and cos >= DP_GRAD_COS and norm_rel <= DP_LOSS_REL
            and patch_err <= SP_LR and torch.equal(a0["patch"], a1["patch"])):
        fail(f"phase 25b attack: loss {loss_rel:.3g} relative, patch gradient cosine "
             f"{cos:.7f}, norm {norm_rel:.3g} relative, patch {patch_err:.3g} off one "
             f"process, ranks' patches equal {torch.equal(a0['patch'], a1['patch'])}")
    want = dict.fromkeys(WARP_KERNELS, 1)
    want.update(nms=2, mbconv_fwd=2 * MBCONV_PER_PASS, mbconv_dx=MBCONV_PER_PASS)
    for r in ranks:
        got = {**{k: r["attack"]["counts"][k] for k in (*WARP_KERNELS, "nms")},
               **r["attack"]["mbconv"]}
        if got != want:
            fail(f"phase 25b attack: a rank launched {got}, want {want}")
    print(f"phase 25b spatial attack step, b{SP_ATTACK_BATCH} fp32, window "
          f"{ATTACK_WINDOW}, the live boxes: loss {loss_rel:.3g} relative to one process, "
          f"patch gradient cosine {cos:.7f}, norm {norm_rel:.3g} relative, patch after "
          f"Adam within {patch_err:.3g} (lr {SP_LR}), the ranks' patches bit-equal; a "
          f"rank launched {want} (fused forward at heights {a0['heights']}); at rank "
          f"0's own inputs the warp kernels within {a0['warp_errs']} of their plain "
          f"passes and the fused forward / dx within {a0['mbconv_errs']} (every fifth "
          f"block); second step {a0['ms']:.1f} / {a1['ms']:.1f} ms a rank, one process "
          f"{ar['ms']:.1f}")
    # 25c: the supervised step
    s0 = r0["sup64"]
    sup_err = dp_leaf_err(s0["net"], ref["sup64"]["net"])
    sup_rel = abs(s0["loss"] - ref["sup64"]["loss"]) / abs(ref["sup64"]["loss"])
    if sup_err > SP_SUP_F64_TOL or sup_rel > SP_SUP_F64_TOL:
        fail(f"phase 25c supervised float64: {sup_err:.3g} of scale, loss {sup_rel:.3g} "
             f"relative (limit {SP_SUP_F64_TOL})")
    one = ref["sup32"]["peak_gb"]
    peaks = [r["sup32"]["peak_gb"] for r in ranks]
    fused = [r["sup32"]["fused"] for r in ranks] + [r["sup64"]["fused"] for r in ranks]
    if any(fused):
        fail(f"phase 25c: fused MBConv launches in a train step ({fused})")
    if max(peaks) >= SP_PEAK_RATIO * one:
        fail(f"phase 25c: a rank's b{SP_SUP_BATCH} fp32 supervised step peaks at "
             f"{max(peaks):.3f} GB, not below {SP_PEAK_RATIO} x the one-process "
             f"{one:.3f} GB")
    print(f"phase 25c spatial supervised step: float64 b{SP_SUP64_BATCH} within "
          f"{sup_err:.3g} of scale (loss {sup_rel:.3g}, limit {SP_SUP_F64_TOL}); fp32 "
          f"b{SP_SUP_BATCH} peak {peaks[0]:.3f} / {peaks[1]:.3f} GB a rank against "
          f"{one:.3f} GB in one process ({max(peaks) / one:.3f}x, limit {SP_PEAK_RATIO}); "
          f"second step {r0['sup32']['ms']:.1f} / {r1['sup32']['ms']:.1f} ms a rank, one "
          f"process {ref['sup32']['ms']:.1f}")
    # 25d: the attack driver
    d0, d1 = r0["driver"], r1["driver"]
    if not (torch.equal(d0["patch"], d1["patch"]) and d0["scale"] == d1["scale"]):
        fail("phase 25d: the ranks' patches differ after attack.train.train(spatial=2)")
    if not {"logs/metrics.jsonl", "state-latest.msgpack"} <= set(
            os.path.relpath(os.path.join(p, f), os.path.join(work, "sdriver0"))
            for p, _, fs in os.walk(os.path.join(work, "sdriver0")) for f in fs):
        fail("phase 25d: rank 0 wrote no metrics log or state")
    launched_every("phase 25d", d0["counts"], ("pass1_fwd", "pass2_fwd", "pass2_bwd",
                                               "pass1_bwd", "nms", "mbconv_fwd_bf16",
                                               "mbconv_dx_bf16"))
    for r in (d0, d1):
        if r["sm90"] != {"sm90": r["counts"]["mbconv_fwd_bf16"], "instance": 0}:
            fail(f"phase 25d: a rank's bf16 fused forward launches by kernel {r['sm90']}, "
                 f"want all {r['counts']['mbconv_fwd_bf16']} on the Hopper kernel")
        if r["sm90_dx"] != {"sm90": r["counts"]["mbconv_dx_bf16"], "instance": 0}:
            fail(f"phase 25d: a rank's bf16 dx launches by kernel {r['sm90_dx']}, "
                 f"want all {r['counts']['mbconv_dx_bf16']} on the Hopper dx")
    print(f"phase 25d attack.train.train(spatial=2) at 2 ranks (b{DRIVER_BATCH}, bf16, "
          f"score threshold {DEFEND_THRESH}, 2 steps and 5 val batches): the ranks' "
          f"patches bit-equal, launches a rank "
          f"{d0['counts']}; {d0['s']:.2f} s")
    spd = spatial_defender_checks(ranks, ref["defender"], work)
    spr = spatial_rest_checks(ranks, ref["rest"], work)
    print(f"phase 25e took {ref_defender_s + max(r['defender_s'] for r in ranks):.2f} s "
          f"(one process {ref_defender_s:.2f} s, then a rank's share of the two ranks' "
          f"run {r0['defender_s']:.2f} / {r1['defender_s']:.2f} s)")
    print(f"phase 25 took {time.perf_counter() - t25:.2f} s (the two ranks {spawn_s:.2f} "
          f"s with their start); peak memory a rank {r0['peak_gb']:.2f} / "
          f"{r1['peak_gb']:.2f} GB. Gloo stages every exchanged row and reduced "
          f"statistic through the host, and the two ranks share one card: these times "
          f"are no rate of spatial partitioning")
    return {**{k: a0["counts"][k] for k in (*WARP_KERNELS, "nms")}, **a0["mbconv"],
            **{f"{k}_driver": d0["counts"][k] for k in ("mbconv_fwd_bf16", "mbconv_dx_bf16")},
            "mbconv_fwd_sm90_driver": d0["sm90"]["sm90"],
            "mbconv_fwd_instance_driver": d0["sm90"]["instance"],
            "mbconv_dx_sm90_driver": d0["sm90_dx"]["sm90"],
            "mbconv_dx_instance_driver": d0["sm90_dx"]["instance"], "defender": spd,
            "rest": spr}


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
    mark("phase 1")
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
                            fb.in_dtype(torch.bfloat16), act, res,
                            fwd=mbconv_cuda.mbconv_fwd_bf16_instance,
                            dx_fn=mbconv_cuda.mbconv_dx_bf16_instance)
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
    # and the Hopper bf16 forward: the odd shapes its rule takes (the others
    # must go to the instance), lite4's 7 fused shapes at b1, b8 and b24 and
    # their heights under phase 25's spatial split
    sm90_err, n_sm90, n_odd = 0.0, 0, 0
    cases = [(f"odd {m[0]}", *m[1:]) for m in MBCONV_ODD]
    from mladversarialobjectdetection_torch.ops.mbconv_sweep import LITE4_FUSED
    cases += [(f"lite4 b{b} {s[0]}x{s[1]} C{s[2]} E{s[3]} Co{s[4]} k{s[5]}", b, *s, "relu6")
              for b in (1, 8, 24) for s in LITE4_FUSED]
    cases += [(f"spatial b2 {s[0]}x{s[1]} C{s[2]} k{s[5]}", 2, *s, "relu6") for s in LITE4_SPATIAL]
    for i, (name, b, h, w, c, e, co, k, res, act) in enumerate(cases):
        x, fb = mbconv_case(dev, b, h, w, c, e, co, k, seed=40 + i)
        x, fb = x.bfloat16(), fb.in_dtype(torch.bfloat16)
        if not mbconv_cuda.sm90_supported(h, w, c, e, co, k, b):
            if not name.startswith("odd"):
                fail(f"phase 1a: the Hopper kernel's rule refuses lite4's shape {name}")
            before = dict(mbconv_cuda.BF16_FWD_LAUNCHES)
            mbconv_cuda.mbconv_fwd_cuda(x, fb, act_type=act, residual=res)
            if dict(mbconv_cuda.BF16_FWD_LAUNCHES) != dict(before, instance=before["instance"] + 1):
                fail(f"phase 1a: {name} outside the Hopper kernel's rule did not run the instance")
            n_odd += 1
            print(f"  mbconv sm90 {name}: outside the rule (C {c}, E {e}, Co {co}), ran the "
                  f"bf16 instance")
            continue
        err, rb, p = check_sm90(name, x, fb, act, res)
        sm90_err, n_sm90 = max(sm90_err, err), n_sm90 + 1
        print(f"  mbconv sm90 {name}: error {err:.3g}, outputs off plain {rb.flips}, "
              f"none beyond the roundings; plan {p.th}x{p.tw} ec {p.ec} {p.minb} a SM "
              f"wn {p.wn} split {p.split}, {p.blocks} blocks, {p.smem} B shared")
    print(f"phase 1a mbconv sm90 (csrc/mbconv_fwd_sm90.cu) vs bf16 plain: {n_sm90} shapes, "
          f"max error {sm90_err:.3g} (limit {MBCONV_BF16_FWD_TOL} of scale), every output "
          f"within the roundings, two launches bit-equal; {n_odd} odd shapes on the instance")
    # and the Hopper bf16 input gradient on the same shapes, and on the
    # spatial heights at phase 25d's batch too
    dx90_err, n_dx90, n_odd = 0.0, 0, 0
    cases += [(f"spatial b{DRIVER_BATCH} {s[0]}x{s[1]} C{s[2]} k{s[5]}", DRIVER_BATCH, *s, "relu6")
              for s in LITE4_SPATIAL]
    for i, (name, b, h, w, c, e, co, k, res, act) in enumerate(cases):
        x, fb = mbconv_case(dev, b, h, w, c, e, co, k, seed=40 + i)
        g = torch.randn((b, h, w, co), device=dev,
                        generator=torch.Generator(dev).manual_seed(i)) * 0.1
        x, g, fb = x.bfloat16(), g.bfloat16(), fb.in_dtype(torch.bfloat16)
        if not mbconv_cuda.sm90_dx_supported(h, w, c, e, co, k, b):
            if not name.startswith("odd"):
                fail(f"phase 1a: the Hopper dx's rule refuses lite4's shape {name}")
            before = dict(mbconv_cuda.BF16_DX_LAUNCHES)
            mbconv_cuda.mbconv_dx_cuda(x, g, fb, act_type=act, residual=res)
            if dict(mbconv_cuda.BF16_DX_LAUNCHES) != dict(before, instance=before["instance"] + 1):
                fail(f"phase 1a: {name} outside the Hopper dx's rule did not run the instance")
            n_odd += 1
            print(f"  mbconv dx sm90 {name}: outside the rule (C {c}, E {e}, Co {co}), ran the "
                  f"bf16 instance")
            continue
        err, db, flips, p = check_sm90_dx(name, x, g, fb, act, res)
        dx90_err, n_dx90 = max(dx90_err, err), n_dx90 + 1
        print(f"  mbconv dx sm90 {name}: error {err:.3g}, elements off plain {db.flips}, none "
              f"beyond the roundings (gd near a bf16 boundary {db.gd_near}, ge {db.ge_near}; "
              f"{db.dx_open} of {x.numel()} may take more than one value); mask flips z0 "
              f"{flips[0]}, z1 {flips[1]} (at most {flips[2]:.3g} of scale from the kink, none "
              f"beyond the sums' error); plan {p.th}x{p.tw} ec {p.ec} {p.minb} a SM wn {p.wn} "
              f"split {p.split}, {p.blocks} blocks, {p.smem} B shared")
    print(f"phase 1a mbconv dx sm90 (csrc/mbconv_dx_sm90.cu) vs bf16 plain: {n_dx90} shapes, "
          f"max error {dx90_err:.3g} (limit {MBCONV_BF16_DX_TOL} of scale), every element and "
          f"mask within the roundings, two launches bit-equal; {n_odd} odd shapes on the instance")
    del x, g, fb

    mark("phase 2")
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

    mark("phase 3")
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
            serve_ms = host_p50_ms(lambda: det.serve(batch), iters=5)
            dev_ms = host_p50_ms(lambda: det.serve_tensors(
                images_d[:b], scales_d[:b]), iters=5)
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
        ms = host_p50_ms(lambda: det.serve(batch, device_preprocess=True), iters=5)
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
            iter(stream_frames), batch_size=8, device_preprocess=device_pre)), iters=3,
            warmup=0)  # the check above ran it
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
    serve_sm90 = sm90_route("bf16 serve", len(batches) * MBCONV_PER_PASS)
    for b, res in bresults.items():
        if res.boxes.shape != (b, m, 4) or not all(
                np.all(np.isfinite(getattr(res, f))) for f in res._fields) or not (
                np.array_equal(res.valid.sum(1), res.valid_len)):
            fail(f"bf16 serve b{b}: {res.boxes.shape}, valid_len {res.valid_len}")
    for b, batch in batches.items():
        ms = host_p50_ms(lambda: bdet.serve(batch), iters=5)
        dms = host_p50_ms(lambda: bdet.serve(batch, device_preprocess=True), iters=5)
        print(f"  bf16 serve b{b}: p50 {ms:.3f} ms/batch ({b * 1e3 / ms:.2f} images/s); "
              f"device_preprocess=True {dms:.3f} ms/batch; valid_len "
              f"{bresults[b].valid_len.tolist()} (fp32 {results[b].valid_len.tolist()})")
    profile_device(lambda: bdet.serve(frames, device_preprocess=True), "bf16 serve b8")
    serve_ab = sm90_ab("bf16 serve b8 (device preprocessing)",
                       lambda: bdet.serve(frames, device_preprocess=True), iters=10)
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

    mark("phase 5")
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
    no_ablation("phase 5")
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
    step_ms = host_p50_ms(step, iters=3, warmup=1)
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
        if k == "pass2_fwd":
            kern_ms, ablation_ms = pass2_turns(t_in, table)
        else:
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
        if k == "pass2_fwd":
            print(f"  warp pass2_fwd's ablation (the thread-per-output kernel) in "
                  f"turns with it: {ablation_ms:.4f} ms, {bound_ms / ablation_ms:.1%} "
                  f"of the bound; the kernel {ablation_ms / kern_ms:.3f}x faster")
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

    mark("phase 5b")
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
    no_ablation("phase 5b")
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
    attack_sm90 = sm90_route("bf16 attack step", 2 * MBCONV_PER_PASS * ATTACK_STEPS)
    attack_dx90 = sm90_route("bf16 attack step", MBCONV_PER_PASS * ATTACK_STEPS, kind="dx")
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
    bstep_ms = host_p50_ms(bstep, iters=3, warmup=1)
    print(f"  bf16 attack step b{ATTACK_BATCH} p50 {bstep_ms:.3f} ms "
          f"({ATTACK_BATCH * 1e3 / bstep_ms:.2f} images/s; fp32 in phase 5 "
          f"{step_ms:.3f} ms)")
    profile_device(bstep, f"bf16 attack step b{ATTACK_BATCH}", top=10)
    attack_ab = sm90_ab(f"bf16 attack step b{ATTACK_BATCH}", bstep)

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
    inst16_err = mb16_errs["fwd"]  # phase 1a's, on the odd shapes
    inst16_dx_err = mb16_errs["dx"]
    mb16_tot, mb16_errs = mbconv_step_numbers("phase 6a bf16", batk, cap,
                                              {"fwd": sm90_err, "dx": dx90_err})
    torch.set_grad_enabled(True)
    # phase 5b's step again with its bf16 dx on the Hopper kernel and on the
    # instance, in turns (after 5a and 6a: the steps move the patch)
    attack_dx_ab = sm90_ab(f"bf16 attack step b{ATTACK_BATCH}", bstep, kind="dx")
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
        sm90_route("bf16 driver", per_dtype["bfloat16"]["mbconv_fwd"])
        sm90_route("bf16 driver", per_dtype["bfloat16"]["mbconv_dx"], kind="dx")
    print(f"phase 7b driver with its defaults (bf16): train(efficientdet-lite4, batch "
          f"12, 3 steps) in {bdriver_s:.2f} s, fused MBConv launches per dtype "
          f"{per_dtype}, warp {warp_cuda.LAUNCHES}, artifacts {dirs}")
    del final

    mark("phase 8")
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
    # the bf16 instances. The plan's pick, the Hopper instance, on every case of
    # CMCONV_BF16_CASES with the kernel's bf16 values in float32 (as the bf16 U-Net hands
    # them) and with general float32 weights, with and without a bias: within the rounding
    # bound, two launches bit-equal; the SIMT instance at the path's shapes with bf16
    # values and a bias: bit-equal to the bf16 plain version
    cm16_err = 0.0
    f32_before = cmconv_cuda.DTYPE_LAUNCHES["float32"]
    plan_before = dict(cmconv_cuda.PLAN_LAUNCHES)
    n16 = 0
    for name, b, c, co, h, wd in CMCONV_BF16_CASES:
        off = 1 if name == "misaligned_x" else 0
        flat = torch.randn((b * c * h * wd + off,), device=dev, generator=gen).bfloat16()
        x = flat[off:].view(b, c, h, wd)
        wg = torch.randn((3, 3, c, co), device=dev, generator=gen) * 0.3
        bias = torch.randn((co,), device=dev, generator=gen).bfloat16()
        for wkind, w in (("bf16 w", wg.bfloat16().float()), ("float32 w", wg)):
            for bb in (bias, None):
                label = f"cmconv bf16 {name} {wkind}{' +bias' if bb is not None else ''}"
                plain = cmconv.cmconv_plain(x, w, bb)
                kern = cmconv_cuda.cmconv3x3_cuda(x, w, bb)
                cm16_err = max(cm16_err, check_cmconv_sm90(label, x, w, bb, kern, plain))
                if not torch.equal(cmconv_cuda.cmconv3x3_cuda(x, w, bb), kern):
                    fail(f"{label}: two launches differ")
                n16 += 2
        if name.startswith("path"):
            w = wg.bfloat16().float()
            check_cmconv_bf16(f"cmconv bf16 SIMT instance {name}",
                              cmconv_cuda.cmconv3x3_instance(x, w, bias, "simt"),
                              cmconv.cmconv_plain(x, w, bias))
        print(f"  cmconv bf16 {name} b{b} {h}x{wd}: Hopper instance "
              f"{cmconv_cuda.plan(c, co, h, wd, torch.bfloat16)} within the rounding bound "
              f"(bf16 and float32 w, with and without a bias), two launches bit-equal"
              + ("; SIMT instance bit-equal to the plain version" if name.startswith("path")
                 else ""))
    if cmconv_cuda.DTYPE_LAUNCHES["float32"] != f32_before:
        fail("a bf16 cmconv call launched the float32 instance")
    if cmconv_cuda.PLAN_LAUNCHES != dict(plan_before,
                                         sm90_bf16=plan_before["sm90_bf16"] + n16):
        fail(f"phase 8: bf16 launches by instance {cmconv_cuda.PLAN_LAUNCHES}, want {n16} "
             f"more on the Hopper instance")
    del x, w, wg, bias, kern, plain, flat
    torch.set_grad_enabled(True)
    print(f"phase 8 cmconv bf16 Hopper instance: {len(CMCONV_BF16_CASES)} cases, {n16} "
          f"launches, every element within cmconv_rounding_bound, max error {cm16_err} "
          f"(tolerance {BF16_CMCONV_TOL} of scale); SIMT instance bit-equal to the bf16 "
          f"plain version at the path's shapes")

    mark("phase 9")
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
    no_ablation("phase 9")
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
    dstep_ms = host_p50_ms(dstep, iters=3, warmup=1)
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
    recover_ms = host_p50_ms(lambda: dfd.recover(dstate, dimages), iters=3)
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
    d_img, d_p0 = canvases.shape[0], canvases.shape[1]
    dbounds = warp_bounds(d_img, table.shape[0], d_p0, win_w,
                          warp_taps(table, d_img, d_p0, win_w))
    dwarp_ms = {"pass1_fwd": kernel_device_ms(
        lambda: warp_cuda.pass1_fwd(canvases, table, win_w), "pass1_fwd_kernel", iters=5)}
    dwarp_ms["pass2_fwd"], dablation_ms = pass2_turns(t_in, table, iters=5)
    print(f"  warp forward kernels at the defender step's {table.shape[0]} "
          f"windows (p0 {d_p0}, w {win_w}, {d_img} canvases, "
          f"{int((table[:, 6] == 1).sum())} at r = 1): max errors {errs}, two launches "
          f"bit-equal; kernel " + ", ".join(
              f"{k} {v:.4f} ms, bound {dbounds[k][0]:.6f} ms ({dbounds[k][1]}: "
              f"{dbounds[k][2]} B), {dbounds[k][0] / v:.1%} of it"
              for k, v in dwarp_ms.items())
          + f"; pass2_fwd's ablation in turns with it {dablation_ms:.4f} ms, "
          f"{dbounds['pass2_fwd'][0] / dablation_ms:.1%} of the bound")
    (nms_boxes, nms_scores), nms_kw = cap.args["batched_nms_cuda"][0]
    defend_nms = nms_numbers(nms_boxes, nms_scores, nms_kw, "defender victim pass")
    max_err = max(max_err, defend_nms[-1])
    del cap, calls, x, w, g, bias, kern, lib, params0
    del canvases, table, t_in, nms_boxes, nms_scores
    torch.set_grad_enabled(True)
    torch.cuda.empty_cache()

    mark("phase 9b")
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
    no_ablation("phase 9b")
    bd_mb = {k: dict(v) for k, v in mbconv_cuda.DTYPE_LAUNCHES.items()}
    check_fused_route("bf16 defender step", dict(mbconv_cuda.LAUNCHES), unfused,
                      MBCONV_PER_PASS * DEFEND_STEPS, 0, passes=DEFEND_STEPS)
    bdpeak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict(pass1_fwd=DEFEND_STEPS, pass2_fwd=DEFEND_STEPS, pass2_bwd=0,
                pass1_bwd=0, nms=DEFEND_STEPS,
                cmconv_bf16=CMCONV_PER_STEP * DEFEND_STEPS, cmconv_fp32=0)
    if bdefend_launches != want:
        fail(f"{DEFEND_STEPS} bf16 defender steps launched {bdefend_launches}; want {want}")
    cmconv_sm90_route("bf16 defender steps", CMCONV_PER_STEP * DEFEND_STEPS)
    bdefend_launches["cmconv_bf16_sm90"] = cmconv_cuda.PLAN_LAUNCHES["sm90_bf16"]
    if (sum(bd_mb["float32"].values())
            or bd_mb["bfloat16"]["mbconv_fwd"] != MBCONV_PER_PASS * DEFEND_STEPS
            or bd_mb["bfloat16"]["mbconv_dx"]):
        fail(f"bf16 defender steps: fused MBConv launches per dtype {bd_mb}")
    sm90_route("bf16 defender step", MBCONV_PER_PASS * DEFEND_STEPS)
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
    bdstep_ms = host_p50_ms(bdstep, iters=3, warmup=1)
    print(f"  bf16 defender step b{DEFEND_BATCH} p50 {bdstep_ms:.3f} ms "
          f"({DEFEND_BATCH * 1e3 / bdstep_ms:.2f} images/s; fp32 {dstep_ms:.3f} ms in "
          f"phase 9)")
    profile_device(bdstep, f"bf16 defender step b{DEFEND_BATCH}", top=10)
    defend_ab = sm90_ab(f"bf16 defender step b{DEFEND_BATCH}", bdstep)
    defend_cm_ab = cmconv_ab(f"bf16 defender step b{DEFEND_BATCH}", bdstep)
    cmconv_cuda.reset_counts()
    nms_cuda.LAUNCHES = 0
    bem = bdfd.eval_step(bdstate, dimages, 1)
    torch.cuda.synchronize()
    cmconv_sm90_route("bf16 eval_step", 8)
    brec = bdfd.recover(bdstate, dimages)
    torch.cuda.synchronize()
    cmconv_sm90_route("bf16 eval_step and recover", 16)
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
    brecover_ms = host_p50_ms(lambda: bdfd.recover(bdstate, dimages), iters=3)
    print(f"  bf16 eval_step: loss {float(bem.loss):.6f}, recovery PSNR "
          f"{float(bem.recovery_psnr):.4f} dB, p50 {beval_ms:.3f} ms (fp32 "
          f"{eval_ms:.3f}); bf16 recover b{DEFEND_BATCH} p50 {brecover_ms:.3f} ms "
          f"({DEFEND_BATCH * 1e3 / brecover_ms:.2f} images/s; fp32 {recover_ms:.3f})")
    recover_cm_ab = cmconv_ab(f"bf16 recover b{DEFEND_BATCH}",
                              lambda: bdfd.recover(bdstate, dimages))
    del brec

    # phase 11, bf16: the bf16 instances on the 15 inputs the bf16 step gave
    # them: the Hopper instance within the rounding bound (the U-Net's
    # kernels, bf16 values in float32, and the same kernels made general
    # float32), two launches bit-equal; the SIMT instance bit-equal to the
    # bf16 plain version; each timed in turns (Hopper, SIMT, SIMT, Hopper)
    # beside its bound (2-byte x, bias and output; the products at the bf16
    # tensor-core rate, since the kernels hold bf16 values and one bf16
    # product of them is exact), the fp32-FMA bound that the SIMT instance's
    # SIMT sums meet, the plain time and F.conv2d in bf16 (cuDNN)
    with Capture([(cmconv_cuda, "cmconv3x3_cuda")]) as cap:
        bdstep()
    torch.cuda.synchronize()
    calls = [a for a, _ in cap.args["cmconv3x3_cuda"]]
    if len(calls) != CMCONV_PER_STEP or any(x.dtype != torch.bfloat16 for x, _, _ in calls):
        fail(f"captured {len(calls)} cmconv calls in a bf16 step, dtypes "
             f"{sorted({str(x.dtype) for x, _, _ in calls})}")
    torch.set_grad_enabled(False)
    cm16_tot = dict(ms=0.0, instance_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bytes_ms=0.0, ops_ms=0.0, bound_simt_ms=0.0)
    cm16_fwd = dict(cm16_tot)
    cm16_rows = []
    gen11 = torch.Generator(dev).manual_seed(11)
    for i, (x, w, bias) in enumerate(calls):
        role = "fwd" if i < 8 else "dx"
        c, co = w.shape[2], w.shape[3]
        if not torch.equal(w, w.bfloat16().float()):
            fail(f"cmconv bf16 step call {i}: the kernel holds values off bf16")
        # the same kernel made general float32: each weight moved off its bf16 value
        wg = w + (torch.rand(w.shape, device=dev, generator=gen11) - 0.5) * 2.0 ** -9 * w.abs()
        for wkind, w_ in (("the step's w", w), ("general float32 w", wg)):
            label = f"cmconv bf16 step call {i} {wkind}"
            plain = cmconv.cmconv_plain(x, w_, bias)
            kern = cmconv_cuda.cmconv3x3_cuda(x, w_, bias)
            cm16_err = max(cm16_err, check_cmconv_sm90(label, x, w_, bias, kern, plain))
            if not torch.equal(cmconv_cuda.cmconv3x3_cuda(x, w_, bias), kern):
                fail(f"{label}: two launches differ")
            if w_ is w:
                kern_step = kern
        plain = cmconv.cmconv_plain(x, w, bias)
        check_cmconv_bf16(f"cmconv bf16 step call {i}, the SIMT instance",
                          cmconv_cuda.cmconv3x3_instance(x, w, bias, "simt"), plain)
        w_oihw = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        lib = torch.nn.functional.conv2d(x, w_oihw, bias, padding=1)
        lib_err = float((lib.float() - kern_step.float()).abs().max())
        turns = {"sm90": [], "simt": []}
        for inst in ("sm90", "simt", "simt", "sm90"):
            turns[inst].append(kernel_device_ms(
                lambda: cmconv_cuda.cmconv3x3_instance(x, w, bias, inst),
                CMCONV_BF16_KERNEL[inst], iters=5))
        t = {"ms": sum(turns["sm90"]) / 2, "instance_ms": sum(turns["simt"]) / 2}
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
        pick = cmconv_cuda.plan(c, co, x.shape[2], x.shape[3], torch.bfloat16)
        cm16_rows.append(dict(call=i, role=role, c=c, co=co, shape=list(x.shape),
                              bias=bias is not None, tile_h=pick.tile_h, **t))
        print(f"  cmconv bf16 step call {i:2d} {role} {c}->{co} {tuple(x.shape)}"
              f"{' +bias' if bias is not None else ''}: Hopper {t['ms']:.4f} ms (tile "
              f"{pick.tile_h}x64, Co {pick.cob}; turns {[round(v, 4) for v in turns['sm90']]}, "
              f"{t['bound_ms'] / t['ms']:.1%} of its bound), SIMT instance "
              f"{t['instance_ms']:.4f} ms (turns {[round(v, 4) for v in turns['simt']]}, "
              f"{t['instance_ms'] / t['ms']:.2f}x); plain {t['plain_ms']:.4f} ms, F.conv2d "
              f"bf16 {t['library_ms']:.4f} ms (differs by {lib_err:.3g}); bound "
              f"{t['bound_ms']:.6f} ms ({bound_by}: {nbytes} B, {ops} ops at the bf16 rate), "
              f"at fp32 FMAs {t['bound_simt_ms']:.6f} ms")
    cm16_bound_by = ("bytes" if cm16_tot["bytes_ms"] >= cm16_tot["ops_ms"]
                     else "operations")
    for label, tot in ((f"per step ({CMCONV_PER_STEP} launches)", cm16_tot),
                       ("over the 8 forward launches (recover, eval_step)", cm16_fwd)):
        print(f"phase 11 cmconv bf16 at the bf16 step's inputs, {label}: Hopper instance "
              f"{tot['ms']:.4f} ms ({tot['bound_ms'] / tot['ms']:.1%} of the bound), SIMT "
              f"instance {tot['instance_ms']:.4f} ms in turns ({tot['instance_ms'] / tot['ms']:.2f}x), "
              f"plain {tot['plain_ms']:.4f} ms, F.conv2d bf16 {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.6f} ms (bytes {tot['bytes_ms']:.6f}, operations at the bf16 "
              f"rate {tot['ops_ms']:.6f}), at fp32 FMAs {tot['bound_simt_ms']:.6f} ms; fp32 "
              f"instance {cm_tot['ms'] if 'per step' in label else cm_fwd['ms']:.4f} ms; max "
              f"error {cm16_err}")
    del cap, calls, x, w, wg, bias, kern, kern_step, lib, plain, bdfd, bdstate, params0
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
        pstep_ms = host_p50_ms(pstep, iters=3, warmup=1)
        precover_ms = host_p50_ms(lambda: pdfd.recover(pstate, dimages), iters=3)
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
    rstep_ms = host_p50_ms(rstep, iters=3, warmup=1)
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

    mark("phase 12")
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
            if want_cm[0] == "bfloat16":
                cmconv_sm90_route(f"defense driver {opts}", want_cm[1])
        print(f"phase 12 defense driver {opts}: train(efficientdet-lite4, batch 12, 3 "
              f"steps) in {odriver_s:.2f} s, cmconv launches per dtype {cm}, fused "
              f"MBConv per dtype {mb}, artifact {arts}")
        del dfinal

    # phases 14-18: the supervised trainer, its checkpoint, and both drivers
    # killed and resumed
    mark("phase 14")
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

    mark("phase 16")
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

        mark("phase 21")
        # phase 21: the rest of the supervised trainer; 21d first, while
        # the card holds nothing else (the fp32 b24 step peaks near 80 GB)
        torch.cuda.empty_cache()
        grad_checkpoint_phase(dev)
        with tempfile.TemporaryDirectory() as work:
            supervised_driver_phase(dev, work)
            sup_eval = evaluate_map_phase(dev, vpath)
            segmentation_phase(dev, work)
            tfrecord_native_phase(work)

        mark("phase 22")
        # phase 22: export and quantize (the int8 conv kernel, the int8
        # serve, torch.export and its driver, the inspector, eval --artifact)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as work:
            q8 = int8_export_phase(dev, vpath, work)

        mark("phase 23")
        # phase 23: the packed backbone entry (serve, attack step, defender
        # step) beside the unpacked one, and the victim as a TF tarball
        torch.cuda.empty_cache()
        t23 = time.perf_counter()
        packed_serve_phase(dev)
        packed_attack = packed_attack_phase(dev)
        packed_defender_phase(dev)
        with tempfile.TemporaryDirectory() as work:
            tf_checkpoint_phase(dev, vpath, work)
        print(f"phase 23 took {time.perf_counter() - t23:.2f} s")

    mark("phase 20")
    # phase 20: the video demos' device path
    with tempfile.TemporaryDirectory() as work:
        demo = demo_phase(dev, work)

    mark("phase 24")
    # phase 24: data parallelism, last, so that no process group outlives it
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        data_parallel_phase(dev, work)

    mark("phase 25")
    # phase 25: spatial partitioning, two ranks on the one card
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        spatial = spatial_phase(dev, work)

    mark("phase 13")
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
        "eval_max_abs_err": sup_eval["nms_err"],
        "defender_ms": defend_nms[0], "defender_plain_ms": defend_nms[1],
        "defender_bound_ms": defend_nms[2], "defender_bound_by": defend_nms[3],
        "spatial_step_launches_per_rank": spatial["nms"],
        "spatial_defender_step_launches_per_rank": spatial["defender"]["fp32"]["nms"],
        "spatial_packed_step_launches_per_rank": spatial["rest"]["attack"]["nms"],
        "spatial_packed_serve_launches_per_rank": spatial["rest"]["serve_nms"]}]
    for k in WARP_KERNELS:
        kern_ms, plain_ms, bound_ms, bound_by = warp_times[k]
        kernels.append({
            "name": f"warp_{k}", "route": "cuda",
            "source": "mladversarialobjectdetection_torch/csrc/warp.cu",
            "replaces": WARP_REPLACES[k], "launches": attack_launches[k],
            "max_abs_err": warp_errs[k], "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "spatial_step_launches_per_rank": spatial[k],
            "spatial_defender_step_launches_per_rank": spatial["defender"]["fp32"][k],
            "spatial_packed_step_launches_per_rank": spatial["rest"]["attack"][k]})
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
        "demo_max_abs_err": demo["cmconv_err"],
        "spatial_defender_step_launches_per_rank":
            spatial["defender"]["fp32"]["cmconv_fp32"]})
    kernels.append({
        "name": "cmconv_bf16_sm90", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/cmconv_bf16_sm90.cu",
        "replaces": "tools/proto_cmconv.py:28",
        "launches": bdefend_launches["cmconv_bf16_sm90"], "max_abs_err": cm16_err,
        "ms": cm16_tot["ms"], "plain_ms": cm16_tot["plain_ms"],
        "bound_ms": cm16_tot["bound_ms"], "bound_by": cm16_bound_by,
        "library_ms": cm16_tot["library_ms"], "instance_ms": cm16_tot["instance_ms"],
        "fwd_ms": cm16_fwd["ms"], "fwd_instance_ms": cm16_fwd["instance_ms"],
        "fwd_bound_ms": cm16_fwd["bound_ms"], "per_launch": cm16_rows,
        # (Hopper instance, SIMT instance), in turns in one call
        "ab_defender_step_host_ms": defend_cm_ab["host_ms"],
        "ab_defender_step_busy_ms": defend_cm_ab["busy_ms"],
        "ab_recover_host_ms": recover_cm_ab["host_ms"],
        "ab_recover_busy_ms": recover_cm_ab["busy_ms"],
        "spatial_defender_step_launches_per_rank":
            spatial["defender"]["bf16"]["cmconv_bf16"]})
    # the SIMT instance is off the path (0 launches there): its time is the
    # ablation's, in turns with the Hopper instance
    kernels.append({
        "name": "cmconv_bf16", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/cmconv_bf16.cu",
        "replaces": "tools/proto_cmconv.py:28",
        "launches": bdefend_launches["cmconv_bf16"] - bdefend_launches["cmconv_bf16_sm90"],
        "max_abs_err": 0.0, "ms": cm16_tot["instance_ms"], "plain_ms": cm16_tot["plain_ms"],
        "bound_ms": cm16_tot["bound_ms"], "bound_by": cm16_bound_by,
        "library_ms": cm16_tot["library_ms"], "bound_simt_ms": cm16_tot["bound_simt_ms"],
        "on_defender_path": False})
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
            "spatial_step_launches_per_rank": spatial[f"mbconv_{kind}"],
            "spatial_packed_step_launches_per_rank":
                spatial["rest"]["attack_mbconv"][f"mbconv_{kind}"],
            **({"demo_launches_per_frame": demo["launches_per_frame"]["mbconv_fwd"],
                "spatial_defender_step_launches_per_rank":
                    spatial["defender"]["fp32"]["mbconv_fp32"],
                "spatial_packed_serve_launches_per_rank": spatial["rest"]["serve"]}
               if kind == "fwd" else {})})
    tot = mb16_tot["fwd"]  # the Hopper bf16 forward, per pass of the bf16 step
    kernels.append({
        "name": "mbconv_fwd_bf16_sm90", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/mbconv_fwd_sm90.cu",
        "replaces": MBCONV_REPLACES["fwd"], "launches": attack_sm90["sm90"],
        "max_abs_err": mb16_errs["fwd"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"], "library_ms": None,
        "unfused_ms": tot["unfused_ms"], "instance_ms": tot["instance_ms"],
        "serve_launches": serve_sm90["sm90"],
        "spatial_driver_launches_per_rank": spatial["mbconv_fwd_sm90_driver"],
        "spatial_defender_step_launches_per_rank":
            spatial["defender"]["bf16"]["mbconv_fwd_bf16"],
        "spatial_packed_bf16_step_launches_per_rank": spatial["rest"]["peak"]["mbconv_fwd_bf16"],
        "spatial_packed_driver_launches_per_rank": spatial["rest"]["driver"]["mbconv_fwd_bf16"],
        "eval_launches_per_batch": sup_eval["launches_per_batch"]["mbconv_fwd_bf16"],
        "eval_ms": sup_eval["mbconv"]["ms"], "eval_instance_ms": sup_eval["mbconv"]["instance_ms"],
        "eval_bound_ms": sup_eval["mbconv"]["bound_ms"],
        "eval_plain_ms": sup_eval["mbconv"]["plain_ms"],
        "eval_max_abs_err": sup_eval["mbconv_err"],
        # host p50 ms (Hopper forward, bf16 instance), in turns in one call
        "ab_serve_b8_ms": serve_ab, "ab_attack_step_ms": attack_ab,
        "ab_defender_step_ms": defend_ab, "ab_eval_batch_ms": sup_eval["sm90_ab_ms"]})
    tot = mb16_tot["dx"]  # the Hopper bf16 input gradient, per pass of the bf16 step
    kernels.append({
        "name": "mbconv_dx_bf16_sm90", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/mbconv_dx_sm90.cu",
        "replaces": MBCONV_REPLACES["dx"], "launches": attack_dx90["sm90"],
        "max_abs_err": mb16_errs["dx"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"], "library_ms": None,
        "unfused_ms": tot["unfused_ms"], "instance_ms": tot["instance_ms"],
        "packed_attack_launches": packed_attack["bf16"]["packed dx_sm90"]["sm90"],
        "spatial_driver_launches_per_rank": spatial["mbconv_dx_sm90_driver"],
        "spatial_packed_bf16_step_launches_per_rank": spatial["rest"]["peak"]["mbconv_dx_bf16"],
        "spatial_packed_driver_launches_per_rank": spatial["rest"]["driver"]["mbconv_dx_bf16"],
        # host p50 ms (Hopper dx, bf16 instance), in turns in one call
        "ab_attack_step_ms": attack_dx_ab})
    for kind in ("fwd", "dx"):  # the bf16 instances, per pass of the bf16 step
        tot = mb16_tot[kind]
        # both instances are off lite4's path (0 launches there): their time
        # is the ablation's, in turns with the Hopper kernels
        kernels.append({
            "name": f"mbconv_{kind}_bf16", "route": "cuda",
            "source": ("mladversarialobjectdetection_torch/csrc/mbconv_bf16.cu" if kind == "fwd"
                       else "mladversarialobjectdetection_torch/csrc/mbconv_bf16_dx.cu"),
            "replaces": MBCONV_REPLACES[kind],
            "launches": (attack_sm90 if kind == "fwd" else attack_dx90)["instance"],
            "max_abs_err": inst16_err if kind == "fwd" else inst16_dx_err,
            "ms": tot["instance_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"], "library_ms": None,
            "unfused_ms": tot["unfused_ms"], "on_lite4_path": False,
            "spatial_driver_launches_per_rank": spatial[f"mbconv_{kind}_instance_driver"],
            **({"eval_instance_ms": sup_eval["mbconv"]["instance_ms"]} if kind == "fwd" else {})})
    c8, c8b = q8["numbers_fp32"], q8["numbers_bf16"]
    parts = ("stem", "1x1", "depthwise")
    common = {"replaces": CONV_INT8_REPLACES, "max_abs_err": 0.0, "plain_ms": c8["plain_ms"],
              "bound_ms": c8["bound_ms"], "bound_by": c8["bound_by"],
              "library_ms": c8["intmm_ms"],
              "library_covers": f"torch._int_mm on {c8['n_intmm']} of the {c8['n_1x1']} 1x1 "
                                f"convs",
              "cudnn_bf16_ms": c8["cudnn_bf16_ms"], "conv_calls_per_serve": c8["n"],
              "bf16_bound_ms": c8b["bound_ms"],
              **{f"{p}_bound_ms": c8[f"{p}_bound_ms"] for p in parts}}
    kernels.append({
        "name": "conv_int8", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/conv_int8_sm90.cu",
        "launches": q8["serve"]["fp32"]["launches"], "ms": c8["ms"], **common,
        **{f"{p}_ms": c8[f"{p}_ms"] for p in parts},
        "simt_ms": c8["simt_ms"], "kernel_ms_on_library_convs": c8["intmm_kernel_ms"],
        "bf16_ms": c8b["ms"], "bf16_simt_ms": c8b["simt_ms"],
        "bf16_launches": q8["serve"]["bf16"]["launches"],
        # device busy ms of the b8 int8 device part, Hopper kernel vs SIMT, in turns
        "b8_busy_ms": q8["serve"]["fp32 int8 b8 busy"],
        "bf16_b8_busy_ms": q8["serve"]["bf16 int8 b8 busy"],
        "spatial_int8_serve_launches_per_rank": spatial["rest"]["int8"]})
    # the SIMT instance is off every path (0 launches there): its time is the
    # ablation's, in turns with the Hopper kernel
    kernels.append({
        "name": "conv_int8_simt", "route": "cuda",
        "source": "mladversarialobjectdetection_torch/csrc/conv_int8.cu", "launches": 0,
        "ms": c8["simt_ms"], **common, **{f"{p}_ms": c8[f"{p}_simt_ms"] for p in parts},
        "bf16_ms": c8b["simt_ms"], "on_lite4_path": False})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
