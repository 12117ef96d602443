"""Pytree files in the JAX package's pickle format.

Port of the pickle fallback of `mladversarialobjectdetection_tpu/ckpt/io.py`
`save_pytree` (io.py:27-31): `<path>.pkl` holds a nested dict of numpy
arrays, which the JAX package's `load_pytree` (io.py:57-60) reads. Orbax
checkpoint directories, and reading files back, are not ported (ROADMAP
Queue 1 item 1).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_pytree(path: str, tree: Any) -> str:
    """Write `tree` (nested dicts of arrays) to `<path>.pkl`; returns that file."""
    out = os.path.abspath(path) + ".pkl"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(_to_numpy(tree), f)
    return out

