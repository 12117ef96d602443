"""Single-frame serving detector (PyTorch).

Port of `mladversarialobjectdetection_tpu/inference/detector.py:30-120,
187-210,313-352`: raw RGB frames in, padded person detections out, with the
host preprocessing, the EfficientDet forward and the global postprocess
(whose NMS is the CUDA kernel on the card).

`serve_streams`, `serve_pipelined`, device preprocessing, `quantize_int8`,
`export`, checkpoint paths and meshes are not ported yet; the post modes
other than "global" raise.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np
import torch

from .. import config as config_lib
from ..ckpt import bridge
from ..models.efficientdet import EfficientDetNet, spec_from_config
from ..models.init import init_weights
from ..ops import postprocess
from ..ops.preprocess import preprocess_host
from ..utils.device import resolve_device
from ..utils.log import get_logger

logger = get_logger(__name__)


class Detector:
    """Inference with the EfficientDet person detector."""

    def __init__(self, model_name: str = "efficientdet-lite4", *,
                 params=None, seed: int = 0, device=None,
                 post_mode: str = "global"):
        """
        Args:
          model_name: efficientdet variant.
          params: config override dict (e.g. {'nms_configs': {...}}).
          seed: seed of the random initial weights (`models/init.py`); load
            trained weights with `load_flax_variables`.
          device: "cuda" (the default) or "cpu".
          post_mode: only "global" is ported.
        """
        if post_mode != "global":
            raise NotImplementedError(f"post_mode {post_mode!r} is not ported yet")
        self.device = resolve_device(device)
        self.post_mode = post_mode
        self.config = config_lib.get_efficientdet_config(model_name)
        if params:
            self.config.override(params, allow_new_keys=False)
        self.spec = spec_from_config(self.config)
        self.net = EfficientDetNet(self.spec).eval()
        init_weights(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self._params_dict = self.config.as_dict()

    def load_flax_variables(self, variables: Mapping) -> None:
        """Load the JAX package's Flax `{'params', 'batch_stats'}` variables."""
        self.net.cpu()
        bridge.load_flax_variables(self.net, variables)
        self.net.to(self.device)

    @torch.no_grad()
    def serve_tensors(self, images: torch.Tensor, scales: torch.Tensor
                      ) -> postprocess.Detections:
        """Preprocessed [B, H, W, 3] images and scales -> Detections on device."""
        cls_out, box_out = self.net(images)
        return postprocess.postprocess_global(self._params_dict, cls_out,
                                              box_out, image_scales=scales)

    def preprocess(self, raw_frames) -> Tuple[np.ndarray, np.ndarray]:
        """Host preprocessing of raw frames: (images [B, H, W, 3], scales [B])."""
        imgs, scales = zip(*[
            preprocess_host(np.asarray(f), self.config.image_size,
                            self.config.mean_rgb, self.config.stddev_rgb)
            for f in raw_frames])
        return np.stack(imgs), np.asarray(scales, np.float32)

    def serve(self, raw_frames) -> postprocess.Detections:
        """Batch of raw RGB frames -> padded Detections (numpy) in original coords."""
        images, scales = self.preprocess(raw_frames)
        det = self.serve_tensors(torch.from_numpy(images).to(self.device),
                                 torch.from_numpy(scales).to(self.device))
        return postprocess.Detections(*(t.cpu().numpy() for t in det))

    def infer(self, frame: np.ndarray, max_boxes: int = 200
              ) -> Tuple[List[tuple], List[float]]:
        """Person detections for one raw frame (detector.py:339-352)."""
        det = self.serve(np.asarray(frame)[None])
        boxes, scores, classes, valid = (det.boxes[0], det.scores[0],
                                         det.classes[0], det.valid[0])
        bb, sc = [], []
        for i in range(boxes.shape[0]):
            if len(bb) == max_boxes:
                break
            if valid[i] and classes[i] == 1:  # person after CLASS_OFFSET
                bb.append(tuple(boxes[i].tolist()))
                sc.append(float(scores[i]))
        return bb, sc
