"""EfficientDet detector modules (PyTorch, eval mode)."""
