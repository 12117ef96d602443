"""Re-inference drivers for exported artifacts.

Port of `mladversarialobjectdetection_tpu/inference/drivers.py`: after
`Detector.export(...)`, these classes load the artifact back and `serve`
raw uint8 frames with the same Detections contract as `Detector.serve`,
with no model rebuild and no checkpoint.

- `ExportedProgramDriver`, the counterpart of `StableHloDriver`, re-serves
  a `torch.export` program (`Detector.export(fmt="exported_program")`) on
  the device it was exported on (the card unless `device="cpu"`); its NMS
  and fused MBConv kernels are custom ops (`ops/library.py`), registered
  before the load.
- `SavedModelDriver` and `TfliteDriver` re-serve a TF SavedModel or TFLite
  file that the JAX package wrote (the port cannot write one,
  `inference/export.py`). TF is imported in them alone, when one is built;
  they run on the host.

Host preprocessing is `ops/preprocess.preprocess_host`, as `Detector`'s.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import config as config_lib
from ..ops.postprocess import Detections
from ..ops.preprocess import preprocess_host
from ..utils.log import get_logger

logger = get_logger(__name__)

class _ArtifactDriver:
    """Shared preprocess + output repacking for artifact drivers."""

    def __init__(self, model_name: str = "efficientdet-lite4", params=None):
        self.config = config_lib.get_efficientdet_config(model_name)
        if params:
            self.config.override(params, allow_new_keys=False)

    def _predict(self, images: np.ndarray, scales: np.ndarray):
        raise NotImplementedError

    def predict(self, images: np.ndarray, scales: np.ndarray) -> Detections:
        """Already-preprocessed images + scales -> Detections (numpy) in the
        artifact's output contract (normalized tflite boxes when
        `normalized_boxes`; original-coord boxes otherwise)."""
        out = self._predict(np.asarray(images, np.float32),
                            np.asarray(scales, np.float32))
        return Detections(*[np.asarray(o) for o in out])

    # True for artifacts emitting the TFLite contract (normalized [0,1]
    # boxes, 0-based classes); TfliteDriver sets it per layout
    normalized_boxes = False

    def serve(self, raw_frames: Sequence[np.ndarray]) -> Detections:
        """Batch of raw RGB frames -> padded Detections in original coords
        (drivers.py:64-85). Artifacts emitting the normalized TFLite
        contract are rescaled to original coords and 1-based classes here."""
        from ..ops.postprocess import CLASS_OFFSET
        from ..utils.image import parse_image_size

        imgs, scales = zip(*[
            preprocess_host(np.asarray(f), self.config.image_size,
                            self.config.mean_rgb, self.config.stddev_rgb)
            for f in raw_frames])
        scales = np.asarray(scales, np.float32)
        det = self.predict(np.stack(imgs), scales)
        if self.normalized_boxes:
            h, w = parse_image_size(self.config.image_size)
            factor = (np.asarray([h, w, h, w], np.float32)
                      * scales[:, None, None])
            det = det._replace(boxes=det.boxes * factor,
                               classes=det.classes + CLASS_OFFSET)
        return det


def program_device(program) -> torch.device:
    """The device an exported program's weights lie on."""
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"exported program's tensors on {sorted(map(str, devices))}")
    return devices.pop()


class ExportedProgramDriver(_ArtifactDriver):
    """Serve from a `torch.export` program (`export.export_program`), the
    port's `StableHloDriver`. `device`: "cuda" (the default) or "cpu"; the
    program must have been exported on that device."""

    def __init__(self, artifact_path: str,
                 model_name: str = "efficientdet-lite4", params=None, device=None):
        super().__init__(model_name, params)
        from ..utils.device import resolve_device
        from . import export as export_lib
        self.device = resolve_device(device)
        program = export_lib.load_program(artifact_path)
        on = program_device(program)
        if on.type != self.device.type:
            raise ValueError(f"{artifact_path} was exported on {on}; this driver serves "
                             f"on {self.device}: export on the device that serves it")
        self.device = on
        self.program = program
        self._fn = program.module()

    @torch.no_grad()
    def predict_tensors(self, images: torch.Tensor, scales: torch.Tensor) -> tuple:
        """The program on preprocessed tensors on its device: the five
        Detections fields as tensors there."""
        return tuple(self._fn(images, scales))

    def _predict(self, images, scales):
        out = self.predict_tensors(torch.from_numpy(images).to(self.device),
                                   torch.from_numpy(scales).to(self.device))
        return [t.cpu().numpy() for t in out]


class SavedModelDriver(_ArtifactDriver):
    """Serve from a jax2tf SavedModel (reference SavedModelDriver,
    infer_lib.py:270-319), on the host."""

    def __init__(self, saved_model_dir: str,
                 model_name: str = "efficientdet-lite4", params=None):
        super().__init__(model_name, params)
        import tensorflow as tf
        self._module = tf.saved_model.load(saved_model_dir)

    def _predict(self, images, scales):
        return [np.asarray(o) for o in self._module.serve(images, scales)]


class TfliteDriver(_ArtifactDriver):
    """Serve from a TFLite flatbuffer (reference TfliteDriver,
    infer_lib.py:322-380) via the interpreter's signature runner, on the
    host."""

    def __init__(self, tflite_path: str,
                 model_name: str = "efficientdet-lite4", params=None):
        super().__init__(model_name, params)
        import tensorflow as tf
        self._interp = tf.lite.Interpreter(model_path=tflite_path)
        self._runner = self._interp.get_signature_runner("serving_default")
        details = self._runner.get_input_details()
        names = list(details)
        # jax2tf names positional args args_0/args_1; map by rank
        self._img_key = next(n for n in names if len(details[n]["shape"]) == 4)
        self._scale_key = next((n for n in names if n != self._img_key), None)
        self._n_out = len(self._runner.get_output_details())
        # int8 3-output artifacts finish with NMS in the TFLite output
        # contract (normalized boxes, 0-based classes)
        self.normalized_boxes = self._n_out == 3

    def _predict(self, images, scales):
        feeds = {self._img_key: images.astype(np.float32)}
        if self._scale_key is not None:
            feeds[self._scale_key] = scales.astype(np.float32)
        out = self._runner(**feeds)
        # signature outputs keyed output_0..output_N in flat order
        outs = [out[f"output_{i}"] for i in range(self._n_out)]
        if self._n_out == 3:
            # int8 artifact layout: (box encodings, scores, anchors), the
            # TFLite NMS op's inputs; finish with the op's semantics on the
            # host (the plain NMS), keeping the normalized contract
            from ..ops.postprocess import tflite_detections_from_pre
            det = tflite_detections_from_pre(self.config.as_dict(),
                                             *(torch.from_numpy(np.asarray(o)) for o in outs))
            return [t.numpy() for t in det]
        return outs
