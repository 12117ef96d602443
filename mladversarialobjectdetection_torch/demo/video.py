"""Video frame extraction and reassembly (PIL and cv2, imported where
used).

Copy of `mladversarialobjectdetection_tpu/demo/video.py` (reference
extract_video_frames.py:16-31 and frames_to_video.py:14-29).
"""
from __future__ import annotations

import os

import numpy as np

from ..inference.streaming import Stream


def extract_video_frames(input_file: str, out_dir: str, *,
                         set_width: int = 0) -> int:
    """mp4 -> numbered pngs; returns frame count."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    stream = Stream(input_file, set_width=set_width, frame_delay=0)
    n = 0
    for i, frame in enumerate(stream.play()):
        Image.fromarray(frame).save(os.path.join(out_dir, f"{i:06d}.png"))
        n += 1
    return n


def frames_to_video(frames_dir: str, output_file: str, *, fps: int = 24) -> int:
    """Numbered frames -> mp4; returns frame count."""
    import cv2
    from PIL import Image
    files = sorted(os.listdir(frames_dir))
    writer = None
    n = 0
    for f in files:
        frame = np.asarray(Image.open(os.path.join(frames_dir, f)).convert("RGB"))
        if writer is None:
            h, w = frame.shape[:2]
            writer = cv2.VideoWriter(output_file,
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        n += 1
    if writer is not None:
        writer.release()
    return n
