"""Anchors, NMS (with its CUDA kernel), pre- and postprocessing."""
