"""Serving entry points: the detector, frame sources and the host patch
compositor of the demos."""
from .detector import Detector  # noqa: F401
from .adv_patch import AdversarialPatch  # noqa: F401
from .streaming import Stream  # noqa: F401
