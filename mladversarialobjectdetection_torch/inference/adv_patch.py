"""Adversarial-patch application to raw frames on the host (numpy, cv2).

Port of `mladversarialobjectdetection_tpu/inference/adv_patch.py`
(reference adv_patch.py:16-201, `AdversarialPatch`): the deterministic
print transform (x0.5 gain), box -> patch coordinates (no rotation, as the
reference's TODO at adv_patch.py:65), the grey-padded rescale for the
brightness match, the YUV mean brightness match, INTER_AREA / INTER_CUBIC
resizing, sensor noise from `np.random`, and the paste loop. It is the
demos' mirror of the training-time compositor `ops/eot.py`. cv2 and PIL
are imported where they are used.
"""
from __future__ import annotations

import numpy as np


class AdversarialPatch:
    """Add an adversarial patch to raw RGB frames."""

    def __init__(self, *, scale: float, h: int = 640, w: int = 640,
                 patch_file: str | None = None,
                 patch_array: np.ndarray | None = None):
        """
        Args:
          scale: patch side relative to the longer person-box side.
          h, w: detector input size (for the grey-band rescale).
          patch_file: png/tiff of the patch, or None for a random patch.
          patch_array: raw float32 patch in [-1, 1] (takes precedence).
        """
        if patch_array is not None:
            arr = np.clip(patch_array * 128.0 + 127.0, 0, 255)
            self._patch_img = arr.astype("uint8")
        elif patch_file is not None:
            from PIL import Image
            self._patch_img = np.asarray(Image.open(patch_file).convert("RGB"))
        else:
            self._patch_img = (np.random.rand(h, w, 3) * 255).astype("uint8")
        self.scale = scale
        self.mean_rgb = 127.0
        self.stddev_rgb = 128.0
        self.output_size = (h, w)
        self._patch_img = self._print_patch(self._patch_img)

    def _print_patch(self, img: np.ndarray) -> np.ndarray:
        """Deterministic print transform: x.5 gain in normalized space
        (adv_patch.py:40-59)."""
        patch = (img.astype(np.float64) - self.mean_rgb) / self.stddev_rgb
        patch *= 0.5
        patch = patch * self.stddev_rgb + self.mean_rgb
        return np.clip(patch, 0.0, 255.0).astype("uint8")

    def _create(self, img: np.ndarray, bbox) -> list:
        """Patch coordinates from a person box (adv_patch.py:61-92)."""
        ymin, xmin, ymax, xmax = bbox
        h, w = ymax - ymin, xmax - xmin
        long_side = max(h, w)
        patch_w = int(long_side * self.scale)
        patch_h = patch_w
        orig_y = ymin + h / 2.0
        orig_x = xmin + w / 2.0
        ymin_patch = max(orig_y - patch_h / 2.0, 0.0)
        xmin_patch = max(orig_x - patch_w / 2.0, 0.0)
        img_h, img_w, _ = img.shape
        if ymin_patch + patch_h > img_h:
            ymin_patch = img_h - patch_h
        if xmin_patch + patch_w > img_w:
            xmin_patch = img_w - patch_w
        return list(map(int, (ymin_patch, xmin_patch, patch_h, patch_w)))

    def _rescale(self, image: np.ndarray) -> np.ndarray:
        """Aspect-preserving rescale with grey padding (adv_patch.py:94-111)."""
        import cv2
        h, w, c = image.shape
        scale = min(self.output_size[1] / w, self.output_size[0] / h)
        sh, sw = int(h * scale), int(w * scale)
        scaled = cv2.resize(image, (sw, sh))
        out = 127 + np.zeros((*self.output_size, c), dtype="uint8")
        out[:sh, :sw, :] = scaled
        return out

    def brightness_match(self, tgt: np.ndarray) -> np.ndarray:
        """YUV mean brightness match (adv_patch.py:113-132)."""
        import cv2
        tgt = self._rescale(tgt)
        tgt = cv2.cvtColor(tgt, cv2.COLOR_RGB2YUV)
        src = cv2.cvtColor(self._patch_img, cv2.COLOR_RGB2YUV)
        source, target = src[:, :, 0], tgt[:, :, 0]
        res = np.clip(source - np.mean(source) + np.mean(target), 0.0, 255.0)
        src = src.copy()
        src[:, :, 0] = res.astype("uint8")
        return cv2.cvtColor(src, cv2.COLOR_YUV2RGB)

    @staticmethod
    def random_noise(tgt: np.ndarray, delta: float) -> np.ndarray:
        noise = np.random.uniform(low=-delta, high=delta, size=tgt.shape)
        return np.clip(tgt + noise, -1.0, 1.0)

    @staticmethod
    def _resize(patch: np.ndarray, ph: int, pw: int) -> np.ndarray:
        """Area interp down, cubic up (adv_patch.py:154-169)."""
        import cv2
        h = patch.shape[0]
        if h > ph:
            return cv2.resize(patch, (pw, ph), interpolation=cv2.INTER_AREA)
        if h < ph:
            return cv2.resize(patch, (pw, ph), interpolation=cv2.INTER_CUBIC)
        return patch

    def _transformed(self, img: np.ndarray, ph: int, pw: int) -> np.ndarray:
        patch = self.brightness_match(img)
        patch = self._resize(patch, ph, pw)
        patch = (patch - self.mean_rgb) / self.stddev_rgb
        patch = self.random_noise(patch, 0.01)
        patch = patch * self.stddev_rgb + self.mean_rgb
        return np.clip(patch, 0.0, 255.0).astype("uint8")

    def add_adv_to_img(self, img: np.ndarray, bboxes) -> np.ndarray:
        """Paste the patch over every person box (adv_patch.py:189-201)."""
        img = img.copy()
        for bbox in bboxes:
            y0, x0, ph, pw = self._create(img, bbox)
            if ph <= 0 or pw <= 0:
                continue
            patch = self._transformed(img, ph, pw)
            img[y0:y0 + ph, x0:x0 + pw] = patch
        return img
