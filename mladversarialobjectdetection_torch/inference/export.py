"""Model export: `torch.export` programs with the weights inside.

Port of `mladversarialobjectdetection_tpu/inference/export.py`:

- `export_program` / `load_program` are the counterparts of
  `export_stablehlo` / `load_stablehlo`: `torch.export.export` of a module
  at fixed example shapes, saved as a `.pt2` file that holds the weights and
  loads with no model rebuild. The kernels of the program (NMS, the fused
  MBConv forward) are custom ops (`ops/library.py`), which the file names and
  `load_program` registers before it loads; the program runs them on the
  device it was exported on.
- `export_saved_model` and `export_tflite` raise: JAX writes them through
  `jax2tf`, and nothing here converts a PyTorch program to TF (no onnx, no
  onnxruntime, no ai_edge_torch). `inference/drivers.py` still re-serves
  such files that the JAX package wrote.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import torch

from ..utils.log import get_logger

logger = get_logger(__name__)

TF_NOT_PORTED = ("writing a TF SavedModel or a TFLite file is not ported: the JAX "
                 "package converts through jax2tf, and no PyTorch-to-TF converter is "
                 "installed (onnx, onnxruntime, ai_edge_torch). The port exports "
                 "fmt='exported_program' (torch.export); inference/drivers.SavedModelDriver "
                 "and TfliteDriver re-serve files the JAX package wrote")


def export_program(module: torch.nn.Module, example_args, out_path: str) -> None:
    """`torch.export` of `module(*example_args)` (no autograd) to a `.pt2`."""
    from ..ops import library  # noqa: F401  (registers the custom ops)

    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    logger.info(f"wrote exported program ({os.path.getsize(out_path)} bytes) to {out_path}")


def load_program(path: str) -> torch.export.ExportedProgram:
    """Load a `.pt2` written by `export_program`; `.module()` calls it."""
    from ..ops import library  # noqa: F401  (the custom ops, before the load)

    return torch.export.load(path)


def export_saved_model(fn, example_args, out_dir: str,
                       input_names: Optional[Iterable[str]] = None) -> None:
    raise NotImplementedError(TF_NOT_PORTED)


def export_tflite(saved_model_dir: str, out_path: str, *, quantize: Optional[str] = None,
                  representative_dataset: Optional[Iterable] = None) -> None:
    raise NotImplementedError(TF_NOT_PORTED)
