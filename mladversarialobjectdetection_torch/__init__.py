"""PyTorch / CUDA port of `mladversarialobjectdetection_tpu`, for NVIDIA Hopper.

The layout mirrors the JAX package module for module, so each counterpart
sits at the same path. Public functions keep the JAX layouts (NHWC images,
per-level NHWC head outputs, [B, N, 4] (ymin, xmin, ymax, xmax) boxes);
NCHW is internal to the models. The port imports `torch` and numpy, never
JAX or anything of the JAX package.

Ported so far: the serving path, `inference.detector.Detector.serve`, with
the NMS suppression loop as a hand-written CUDA kernel (`csrc/nms.cu`); the
attack train step, `attack.attacker.PatchAttacker.train_step`, and its
driver `attack.train.train`, with the EOT compositor's two-pass warp as
four hand-written CUDA kernels (`csrc/warp.cu`); the defender,
`defense.defender.PatchAttackDefender` and its driver
`defense.train.train`, with the U-Net's small-channel 3x3 convs as a
hand-written CUDA kernel (`csrc/cmconv.cu`).
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import Config, get_detection_config, get_efficientdet_config  # noqa: F401
