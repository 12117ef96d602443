"""Debugging, determinism and profiling switches (PyTorch).

Port of `mladversarialobjectdetection_tpu/utils/debug.py:50-107`, the
counterpart of the reference's auxiliary debug machinery (SURVEY.md §5):
op determinism and a seed (tf2/train.py:166-168), NaN checks, and the
ServingDriver benchmark and trace harness (infer_lib.py:181-206).

Not ported, on purpose:
- `enable_compilation_cache`: it sets XLA's persistent compilation cache,
  and nothing in the port compiles just in time. The port's kernels are
  built once by nvcc and kept by content hash in `_build/` (`_build.py`).
- `enable_debug(disable_jit=...)`: PyTorch already runs op by op.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, Optional

import torch

from .log import get_logger

logger = get_logger(__name__)


def enable_debug(nans: bool = True) -> None:
    """Debug mode: autograd anomaly detection with its NaN checks (the
    counterpart of `jax_debug_nans`)."""
    torch.autograd.set_detect_anomaly(nans, check_nan=nans)
    logger.info(f"debug mode: nans={nans}")


def set_deterministic(seed: int = 0) -> torch.Generator:
    """Op determinism and the seed discipline (the reference's
    `enable_op_determinism` + seed): deterministic algorithms on, cuDNN
    deterministic with its autotuner off; returns a generator seeded with
    `seed` (the counterpart of JAX's root key)."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.Generator().manual_seed(seed)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profiler trace context: `torch.profiler` over the CPU and, where
    there is one, the card, written as a Chrome trace into `log_dir`."""
    if not log_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 3,
              trace_dir: Optional[str] = None) -> float:
    """Latency benchmark harness (ServingDriver._benchmark parity,
    infer_lib.py:181-206). Returns seconds per call, on the host clock,
    fenced with `torch.cuda.synchronize()` where a card is in use (JAX's
    version reads one output leaf on the host instead)."""
    for _ in range(warmup):
        fn(*args)
    _fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _fence()
    dt = (time.perf_counter() - t0) / iters
    logger.info(f"per call: {dt * 1000:.2f} ms, {1.0 / dt:.1f} calls/sec")
    if trace_dir:
        with trace(trace_dir):
            fn(*args)
            _fence()
    return dt
