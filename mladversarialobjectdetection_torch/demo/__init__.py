"""The video demos (port of `mladversarialobjectdetection_tpu/demo/`):
clean, attacked and recovered views of a stream (`demo_v2`), the
four-quadrant composite with its score graph (`demo`), the synthetic clip
they run on, and their drawing and video helpers. The detections and the
U-Net's recovery run on the card; cv2, PIL and matplotlib are imported
where a frame is read, drawn on or written, on the host."""
from . import draw  # noqa: F401


def make_demo_detector(model_name, detector_ckpt=None, detector_params=None,
                       device=None):
    """Detector with the demos' permissive NMS defaults (iou .5, score 0:
    the demos threshold each overlay instead; demo.py:55-63), shared by
    `demo` and `demo_v2` (JAX demo/__init__.py:4-15)."""
    from ..inference.detector import Detector
    params = dict(detector_params or {})
    nms = dict(params.get("nms_configs") or {})
    nms.setdefault("iou_thresh", 0.5)
    nms.setdefault("score_thresh", 0.0)
    params["nms_configs"] = nms
    return Detector(model_name=model_name, ckpt_path=detector_ckpt,
                    params=params, device=device)
