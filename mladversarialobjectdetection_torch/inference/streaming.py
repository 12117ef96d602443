"""Frame sources: video file, webcam, or image directory; and their zip.

Port of `mladversarialobjectdetection_tpu/inference/streaming.py`
(reference streaming.py:21-103): path=None -> webcam device 0, file ->
`cv2.VideoCapture`, directory -> sorted, filtered image list;
aspect-preserving width resize. `cv2` and PIL are imported only where a
source reads frames, as in the JAX package, so the module imports without
them. `MultiStream` needs only an object with `play()` per source, so any
in-memory frame source can ride `Detector.serve_streams`.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..utils.log import get_logger

logger = get_logger(__name__)


class Stream:
    """Stream frames from file, directory or webcam."""

    def __init__(self, path=None, *, filter_func=None, sort_func=None,
                 set_width: int = 640, frame_delay: float = 1 / 24):
        self.path = path = path if path is not None else 0
        self.set_width = set_width
        self.frame_delay = frame_delay
        self.cap = None
        self.files = None
        if os.path.isdir(path if isinstance(path, str) else ""):
            self.files = sorted(os.listdir(path))
            if filter_func:
                self.files = list(filter(filter_func, self.files))
            if sort_func:
                self.files.sort(key=sort_func)
        else:
            # webcam index, file, or any other cv2-openable source: the
            # capture is always built, so play() logs an unopened one
            import cv2
            self.cap = cv2.VideoCapture(path)
            if not self.cap.isOpened():
                logger.error(f"Error opening input video: {path}")

    def change_frame_size(self, frame: np.ndarray) -> np.ndarray:
        import cv2
        h, w, _ = frame.shape
        scale = self.set_width / w
        return cv2.resize(frame, (self.set_width, int(h * scale)))

    def play_from_video(self):
        import cv2
        try:
            while self.cap.isOpened():
                ret, frame = self.cap.read()
                if not ret:
                    logger.info("end of stream")
                    break
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if self.set_width:
                    frame = self.change_frame_size(frame)
                yield frame
        finally:
            self.cap.release()

    def play_from_list(self):
        from PIL import Image
        for file in self.files:
            if self.frame_delay:
                time.sleep(self.frame_delay)
            frame = np.asarray(
                Image.open(os.path.join(self.path, file)).convert("RGB"))
            if self.set_width:
                frame = self.change_frame_size(frame)
            yield frame

    def play(self):
        if isinstance(self.path, str) and os.path.isdir(self.path):
            yield from self.play_from_list()
        else:
            yield from self.play_from_video()


class MultiStream:
    """Zip several sources into per-tick frame batches for batched serving.

    Yields (indices, frames): the sources still alive this tick and their
    frames. Ends when every source is exhausted.
    """

    def __init__(self, streams):
        self.streams = list(streams)

    def play(self):
        iters = [s.play() for s in self.streams]
        alive = [True] * len(iters)
        while any(alive):
            indices, frames = [], []
            for i, it in enumerate(iters):
                if not alive[i]:
                    continue
                try:
                    frames.append(next(it))
                    indices.append(i)
                except StopIteration:
                    alive[i] = False
            if indices:
                yield indices, frames
