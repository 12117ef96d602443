"""The CUDA channel-major 3x3 convolution kernels (`csrc/cmconv.cu`, `csrc/cmconv_tc.cu`),
their plan and wrappers.

Replace the Pallas TPU kernel `_kernel` of `tools/proto_cmconv.py` (launched
by `cmconv`). `cmconv3x3_cuda` has the signature of `ops/cmconv.cmconv_plain`:
x [B, C, H, W] and w [3, 3, C, Co] (HWIO), an optional bias [Co], 1 <= C, Co
<= 32. It takes only contiguous float32 CUDA tensors on one device (a tensor
in the channels-last memory format is not contiguous: make it so at the
call site), launches on PyTorch's current stream, allocates its output and
nothing else, and raises on any refusal; it never falls back to the plain
version or to another instance. `LAUNCHES` counts its launches.

Two instances compute the function: `simt` (`csrc/cmconv.cu`, float32 FMAs,
register-blocked over a halo tile in shared memory) and `tc` (`csrc/cmconv_tc.cu`,
the same tile as an implicit GEMM with 3xTF32 tensor-core products). `plan`
picks one per shape (pure Python, tested on the CPU, cached), by a rule
written from the two instances' times on an H100 (PERF.md) that depends on
the shape alone; today it picks `simt` everywhere. `cmconv3x3_instance`
launches a named instance whatever the plan: the tests and `chip_smoke.py`'s
ablation use it, and it counts in `INSTANCE_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

LAUNCHES = 0  # kernel launches made by cmconv3x3_cuda in this process
INSTANCE_LAUNCHES = {"simt": 0, "tc": 0}  # launches made by cmconv3x3_instance
MAX_CHANNELS = 32  # input and output channels the kernels take
# instance -> (library, C entry); both entries take the same arguments
ENTRIES = {"simt": ("cmconv", "mlad_cmconv3x3"),
           "tc": ("cmconv_tc", "mlad_cmconv3x3_tc")}

_P = ctypes.c_void_p
_I = ctypes.c_int


class Plan(NamedTuple):
    """One launch: the instance, Co padded to its channel blocks of 8, and
    the rows of one block's output tile (64 wide)."""
    instance: str
    cob: int
    tile_h: int


@functools.lru_cache(maxsize=None)
def plan(c: int, co: int, h: int, w: int) -> Plan:
    """The instance for x [*, C, H, W] -> Co; raises outside 1..MAX_CHANNELS
    or for an empty image.

    Every shape goes to `simt`: on an H100 the `tc` instance took 1.06-2.49x
    the SIMT instance's time on every one of the defender's 15 launches
    (`chip_smoke.py` phase 11; PERF.md)."""
    if not (1 <= c <= MAX_CHANNELS and 1 <= co <= MAX_CHANNELS):
        raise ValueError(f"channels {c} -> {co} outside 1..{MAX_CHANNELS}")
    if min(h, w) < 1:
        raise ValueError(f"empty image {h}x{w}")
    cob = 8 if co <= 8 else (16 if co <= 16 else 32)
    return Plan("simt", cob, 256 // cob)  # csrc/cmconv.cu tile_h(NS)


@functools.lru_cache(maxsize=None)
def _kernel(instance: str):
    """The C entry of an instance, built on first use."""
    lib, name = ENTRIES[instance]
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
            instance: str | None) -> torch.Tensor:
    """Check the arguments, launch `instance` (None: the plan's) and return
    the output."""
    tensors = (x, w) if bias is None else (x, w, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"float32 only, got {[t.dtype for t in tensors]}")
    if not all(t.is_cuda for t in tensors):
        raise ValueError("cmconv3x3_cuda takes CUDA tensors; use "
                         "ops/cmconv.cmconv_plain on the CPU")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or \
            w.shape[2] != x.shape[1]:
        raise ValueError(f"want x [B, C, H, W] and w [3, 3, C, Co], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, c, h, wd = x.shape
    co = w.shape[3]
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias {tuple(bias.shape)}, want ({co},)")
    if not (1 <= c <= MAX_CHANNELS and 1 <= co <= MAX_CHANNELS):
        raise ValueError(f"channels {c} -> {co} outside 1..{MAX_CHANNELS}")
    if min(b, h, wd) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, w and bias must be contiguous (x in NCHW)")
    if instance is None:
        instance = plan(c, co, h, wd).instance
    elif instance not in ENTRIES:
        raise ValueError(f"no cmconv instance {instance!r}; have {sorted(ENTRIES)}")
    out = torch.empty((b, co, h, wd), dtype=torch.float32, device=x.device)
    fn = _kernel(instance)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), b, c, co, h, wd,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cmconv {instance} kernel launch failed: cudaError_t "
                           f"{err} (x {tuple(x.shape)}, Co {co})")
    return out


def cmconv3x3_cuda(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """`ops/cmconv.cmconv_plain` as one kernel launch, of the plan's instance."""
    global LAUNCHES
    out = _launch(x, w, bias, None)
    LAUNCHES += 1
    return out


def cmconv3x3_instance(x: torch.Tensor, w: torch.Tensor,
                       bias: torch.Tensor | None, instance: str) -> torch.Tensor:
    """`cmconv3x3_cuda` through a named instance ("simt" or "tc")."""
    out = _launch(x, w, bias, instance)
    INSTANCE_LAUNCHES[instance] += 1
    return out
