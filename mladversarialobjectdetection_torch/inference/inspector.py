"""Model inspection CLI: infer / benchmark / export / dry / video modes.

Port of `mladversarialobjectdetection_tpu/inference/inspector.py` (the
reference inspector tool, tf2/inspector.py:30-198): one command that builds
the serving stack and annotates an image (`infer`), times the serve program
(`benchmark`), exports a deployable artifact (`export`), writes the restored
weights as a native checkpoint (`dry`), or annotates a whole video
(`video`, through `Detector.serve_pipelined`).

The detector runs on the card unless `--device cpu`. `benchmark` times
`Detector.serve_tensors` (or the bare net with `--only-network`) through
`utils.debug.benchmark`, fenced with `torch.cuda.synchronize()`; its
`compile_s` is the first call's time (the kernels' build, if not built yet,
and the warm-up). `infer` and `video` read and write images with PIL and
cv2, which the card's machine lacks: they run on the CPU there. `export`
writes `--export-format exported_program`; `saved_model` and `tflite` raise
(`inference/export.py`).
"""
from __future__ import annotations

import argparse
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..utils.log import get_logger

logger = get_logger(__name__)


def build_detector(model_name: str, *, ckpt: Optional[str] = None,
                   hparams: Optional[str] = None,
                   image_size: Optional[int] = None,
                   post_mode: str = "global", device=None):
    """Detector with CLI-style overrides (inspector.py:80-87: config,
    --hparams string/yaml, --image_size)."""
    from .. import config as config_lib
    from .detector import Detector

    cfg = config_lib.get_efficientdet_config(model_name)
    if hparams:
        cfg.override(hparams)  # 'a.b=1,c=2' string or yaml path
    if image_size:
        cfg.image_size = image_size
    return Detector(model_name=model_name, params=cfg.as_dict(),
                    ckpt_path=ckpt, post_mode=post_mode, device=device)


def _annotate(det, frame: np.ndarray, detections, i: int,
              min_score: float, max_boxes: int) -> np.ndarray:
    """Draw all classes with label-map names (inspector.py:113-119)."""
    from ..demo import draw
    from ..utils import label_util

    label_map = label_util.get_label_map(
        getattr(det.config, "label_map", None))
    boxes, scores = detections.boxes[i], detections.scores[i]
    classes, valid = detections.classes[i], detections.valid[i]
    keep = np.asarray(valid) & (np.asarray(scores) >= min_score)
    idx = np.nonzero(keep)[0][:max_boxes]
    names = [label_map.get(int(classes[j]), str(int(classes[j])))
             for j in idx]
    return draw.draw_boxes(frame, [np.asarray(boxes[j]) for j in idx],
                           [float(scores[j]) for j in idx], labels=names)


def run_infer(det, input_image: str, output_image_dir: str, *,
              min_score: Optional[float] = None,
              max_boxes: Optional[int] = None) -> str:
    """Annotate one image; returns the written path (inspector.py:101-122,
    output name '0.jpg' kept)."""
    from PIL import Image

    frame = np.asarray(Image.open(input_image).convert("RGB"))
    detections = det.serve(frame[None])
    min_score = (det.config.nms_configs.score_thresh or 0.4
                 if min_score is None else min_score)
    max_boxes = max_boxes or det.config.nms_configs.max_output_size
    img = _annotate(det, frame, detections, 0, min_score, max_boxes)
    os.makedirs(output_image_dir, exist_ok=True)
    out = os.path.join(output_image_dir, "0.jpg")
    Image.fromarray(img).save(out)
    logger.info(f"writing file to {out}")
    return out


def run_benchmark(det, *, batch_size: int = 1, bm_runs: int = 10,
                  input_image: Optional[str] = None,
                  trace_dir: Optional[str] = None,
                  only_network: bool = False) -> dict:
    """Benchmark the serve program (inspector.py:93-129). Synthetic input
    (ones) when no image is given. Returns {'ms', 'fps', 'compile_s'}."""
    from ..ops.preprocess import preprocess_host
    from ..utils.debug import benchmark

    if input_image:
        from PIL import Image
        frame = np.asarray(Image.open(input_image).convert("RGB"))
    else:
        frame = np.ones((*det.spec.image_size, 3), np.uint8)
    img, scale = preprocess_host(frame, det.config.image_size,
                                 det.config.mean_rgb, det.config.stddev_rgb)
    images = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(img, (batch_size, *img.shape)))).to(det.device)
    scales = torch.full((batch_size,), float(scale), dtype=torch.float32,
                        device=det.device)

    if only_network:
        def fn(x):
            with torch.no_grad():
                return det.net(x)
        args = (images,)
    else:
        fn, args = det.serve_tensors, (images, scales)
    t0 = time.perf_counter()
    fn(*args)
    if det.device.type == "cuda":
        torch.cuda.synchronize(det.device)
    compile_s = time.perf_counter() - t0
    dt = benchmark(fn, *args, iters=bm_runs, warmup=3, trace_dir=trace_dir)
    res = {"ms": dt * 1e3, "fps": batch_size / dt, "compile_s": compile_s}
    logger.info(f"batch {batch_size}: {res['ms']:.2f} ms/batch, "
                f"{res['fps']:.1f} img/s (first call {compile_s:.1f} s)")
    return res


def run_dry(det, export_ckpt: Optional[str] = None) -> None:
    """Build and restore only; optionally write the restored variables as a
    native checkpoint (inspector.py:131-143): Flax-named variables through
    `ckpt/io.save_pytree`, which either package's `load_pytree` reads."""
    n_params = sum(int(v.numel()) for v in det.net.state_dict().values())
    logger.info(f"model built: {n_params / 1e6:.2f}M weights")
    if export_ckpt:
        from ..ckpt import bridge
        from ..ckpt import io as ckpt_io
        ckpt_io.save_pytree(export_ckpt, bridge.torch_to_flax(det.net))
        logger.info(f"native checkpoint written to {export_ckpt}")


def run_video(det, input_video: str, output_video: str, *,
              min_score: Optional[float] = None, batch_size: int = 4,
              max_frames: Optional[int] = None) -> int:
    """Annotate a video end to end; returns frames written
    (inspector.py:146-193). Detection runs through serve_pipelined, so the
    host side of batch t+1 overlaps the device's batch t."""
    import cv2

    from .streaming import Stream

    if not output_video:
        # the whole video would be served and annotated for nothing
        raise ValueError("run_video needs an output_video path")
    stream = Stream(input_video)
    min_score = (det.config.nms_configs.score_thresh or 0.4
                 if min_score is None else min_score)
    max_boxes = det.config.nms_configs.max_output_size

    pending: deque = deque()

    def frames():
        for n, frame in enumerate(stream.play()):
            if max_frames is not None and n >= max_frames:
                return
            pending.append(frame)
            yield frame

    writer = None
    written = 0
    for detections in det.serve_pipelined(frames(), batch_size=batch_size):
        frame = pending.popleft()
        # serve_pipelined strips the batch dim; _annotate indexes dim 0
        batched = type(detections)(*(np.asarray(a)[None] for a in detections))
        img = _annotate(det, frame, batched, 0, min_score, max_boxes)
        if writer is None:
            h, w = img.shape[:2]
            writer = cv2.VideoWriter(
                output_video, cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
        writer.write(np.ascontiguousarray(img[:, :, ::-1]))  # RGB->BGR
        written += 1
    if writer is not None:
        writer.release()
        logger.info(f"wrote {written} annotated frames to {output_video}")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="model inspection tool")
    p.add_argument("--mode", default="infer",
                   choices=["infer", "dry", "export", "benchmark", "video"])
    p.add_argument("--model", default="efficientdet-d0")
    p.add_argument("--ckpt", default=None,
                   help="pytree checkpoint path (<ckpt>.pkl)")
    p.add_argument("--hparams", default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--bm-runs", type=int, default=10)
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace during benchmark")
    p.add_argument("--only-network", action="store_true",
                   help="benchmark the bare forward without postprocess")
    p.add_argument("--input-image", default=None)
    p.add_argument("--output-image-dir", default=None)
    p.add_argument("--input-video", default=None)
    p.add_argument("--output-video", default=None)
    p.add_argument("--min-score", type=float, default=None)
    p.add_argument("--export-ckpt", default=None,
                   help="dry mode: write restored weights as native ckpt")
    p.add_argument("--saved-model-dir", default=None,
                   help="export mode: artifact output path")
    p.add_argument("--export-format", default="exported_program",
                   choices=["exported_program", "saved_model", "tflite"])
    p.add_argument("--tflite", default="",
                   choices=["", "FP32", "FP16", "INT8"],
                   help="tflite quantization (implies --export-format "
                        "tflite; not ported: raises)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    det = build_detector(args.model, ckpt=args.ckpt, hparams=args.hparams,
                         image_size=args.image_size, device=args.device)
    if args.mode == "infer":
        if not args.input_image or not args.output_image_dir:
            p.error("infer mode needs --input-image and --output-image-dir")
        run_infer(det, args.input_image, args.output_image_dir,
                  min_score=args.min_score)
    elif args.mode == "benchmark":
        res = run_benchmark(det, batch_size=args.batch_size, bm_runs=args.bm_runs,
                            input_image=args.input_image, trace_dir=args.trace_dir,
                            only_network=args.only_network)
        print(args.model, f"batch {args.batch_size}", res)
    elif args.mode == "dry":
        run_dry(det, args.export_ckpt)
    elif args.mode == "export":
        if not args.saved_model_dir:
            p.error("export mode needs --saved-model-dir")
        fmt = "tflite" if args.tflite else args.export_format
        quant = {"": None, "FP32": None, "FP16": "fp16",
                 "INT8": "int8"}[args.tflite]
        det.export(args.saved_model_dir, fmt=fmt, batch_size=args.batch_size,
                   quantize=quant)
        logger.info(f"model exported to {args.saved_model_dir}")
    elif args.mode == "video":
        if not args.input_video or not args.output_video:
            p.error("video mode needs --input-video and --output-video")
        run_video(det, args.input_video, args.output_video,
                  min_score=args.min_score, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
