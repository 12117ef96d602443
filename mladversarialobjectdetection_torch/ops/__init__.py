"""Anchors, NMS (with its CUDA kernel; `nms_np` the host mirror), weighted
boxes fusion, pre- and postprocessing, colour and the EOT compositor."""
from . import (anchors, color, eot, iou_loss, nms, nms_np,  # noqa: F401
               postprocess, preprocess, wbf)
