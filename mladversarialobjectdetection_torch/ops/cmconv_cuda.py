"""The CUDA channel-major 3x3 convolution kernels (`csrc/cmconv.cu`,
`csrc/cmconv_bf16.cu`, `csrc/cmconv_bf16_sm90.cu`, `csrc/cmconv_tc.cu`),
their plan and wrappers.

Replace the Pallas TPU kernel `_kernel` of `tools/proto_cmconv.py` (launched
by `cmconv`). `cmconv3x3_cuda` has the signature of `ops/cmconv.cmconv_plain`:
x [B, C, H, W] and w [3, 3, C, Co] (HWIO), an optional bias [Co], 1 <= C, Co
<= 32. It takes contiguous CUDA tensors on one device (a tensor in the
channels-last memory format is not contiguous: make it so at the call site)
in one of two dtypes: float32 (x, w, bias), or bf16, the TPU kernel's own
signature (x and bias bf16, w float32; the output bf16). It dispatches by
x's dtype, never casts, launches on PyTorch's current stream, allocates its
output and nothing else, and raises on any refusal; it never falls back to
the plain version or to another instance. `LAUNCHES` counts its launches,
`DTYPE_LAUNCHES` each again under its dtype, so that a bf16 pass can show
that it launched no float32 instance, and `PLAN_LAUNCHES` each again under
the instance its plan picked.

Instances: at float32 `simt` (`csrc/cmconv.cu`, float32 FMAs,
register-blocked over a halo tile in shared memory) and `tc`
(`csrc/cmconv_tc.cu`, the same tile as an implicit GEMM with 3xTF32
tensor-core products); at bf16 `sm90` (`csrc/cmconv_bf16_sm90.cu`, written
for Hopper: a channels-last halo tile staged once, the products on the bf16
tensor cores with each float32 weight as bf16 hi + lo terms, persistent
blocks) and `simt` (`csrc/cmconv_bf16.cu`, the float32 SIMT template with
the tile staged in bf16, kept as the ablation). `plan` picks one per shape
and dtype (pure Python, tested on the CPU, cached), by a rule written from
the instances' times on an H100 (PERF.md) that depends on the shape alone:
`simt` at float32, `sm90` at bf16. `cmconv3x3_instance` launches a named
instance of x's dtype whatever the plan: the tests and `chip_smoke.py`'s
ablation use it, and it counts in `INSTANCE_LAUNCHES` (the bf16 instances
as `simt_bf16` and `sm90_bf16`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

LAUNCHES = 0  # kernel launches made by cmconv3x3_cuda in this process
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
DTYPE_LAUNCHES = {d: 0 for d in DTYPES.values()}  # the same, per dtype of x
MAX_CHANNELS = 32  # input and output channels the kernels take
# dtype of x -> instance -> (library, C entry); the entries of a dtype take
# the same arguments
INSTANCES = {torch.float32: {"simt": ("cmconv", "mlad_cmconv3x3"),
                             "tc": ("cmconv_tc", "mlad_cmconv3x3_tc")},
             torch.bfloat16: {"sm90": ("cmconv_bf16_sm90", "mlad_cmconv3x3_bf16_sm90"),
                              "simt": ("cmconv_bf16", "mlad_cmconv3x3_bf16")}}
ENTRIES = INSTANCES[torch.float32]
# launches made by cmconv3x3_instance, by `_instance_key`
INSTANCE_LAUNCHES = {"simt": 0, "tc": 0, "simt_bf16": 0, "sm90_bf16": 0}
# launches made by cmconv3x3_cuda, by `_instance_key` of the plan's pick
PLAN_LAUNCHES = dict(INSTANCE_LAUNCHES)

_P = ctypes.c_void_p
_I = ctypes.c_int


class Plan(NamedTuple):
    """One launch: the instance, Co padded to the instance's channel blocks
    of 8, the rows of one block's output tile (64 wide), and the dtype of x."""
    instance: str
    cob: int
    tile_h: int
    dtype: torch.dtype = torch.float32


def sm90_tile_h(c: int, co: int) -> int:
    """Output rows of a tile of the Hopper bf16 instance (`dispatch_nt` of
    `csrc/cmconv_bf16_sm90.cu`): by C's blocks of 8 channels, 16 (Co <= 8)
    or 8, 6, 4 or 4 rows where Co <= 16, else 4 (C <= 24) or 2."""
    cp8 = -(-c // 8)
    if co <= 16:
        return 16 if cp8 == 1 and co <= 8 else {1: 8, 2: 6}.get(cp8, 4)
    return 4 if cp8 <= 3 else 2


@functools.lru_cache(maxsize=None)
def plan(c: int, co: int, h: int, w: int,
         dtype: torch.dtype = torch.float32) -> Plan:
    """The instance for x [*, C, H, W] -> Co of `dtype`; raises outside
    1..MAX_CHANNELS, for an empty image or a dtype without an instance.

    float32 goes to `simt` at every shape: on an H100 the `tc` instance took
    1.06-2.49x the SIMT instance's time on every one of the defender's 15
    launches (`chip_smoke.py` phase 11; PERF.md). bf16 goes to `sm90` at
    every shape (1 <= C, Co <= 32, any B, H, W): Co in n-tiles of 8, and
    tiles of `sm90_tile_h(C, Co)` rows (`csrc/cmconv_bf16_sm90.cu`)."""
    if dtype not in INSTANCES:
        raise TypeError(f"no cmconv instance for {dtype}; have {list(DTYPES)}")
    if not (1 <= c <= MAX_CHANNELS and 1 <= co <= MAX_CHANNELS):
        raise ValueError(f"channels {c} -> {co} outside 1..{MAX_CHANNELS}")
    if min(h, w) < 1:
        raise ValueError(f"empty image {h}x{w}")
    if dtype == torch.bfloat16:
        return Plan("sm90", -(-co // 8) * 8, sm90_tile_h(c, co), dtype)
    cob = 8 if co <= 8 else (16 if co <= 16 else 32)
    return Plan("simt", cob, 256 // cob, dtype)  # csrc/cmconv.cu tile_h(NS)


def _instance_key(instance: str, dtype: torch.dtype) -> str:
    return instance if dtype == torch.float32 else f"{instance}_bf16"


@functools.lru_cache(maxsize=None)
def _kernel(instance: str, dtype: torch.dtype):
    """The C entry of an instance, built on first use."""
    lib, name = INSTANCES[dtype][instance]
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
            instance: str | None) -> tuple[torch.Tensor, str]:
    """Check the arguments, launch `instance` (None: the plan's) and return
    the output and the instance."""
    tensors = (x, w) if bias is None else (x, w, bias)
    if x.dtype not in INSTANCES or w.dtype != torch.float32 or (
            bias is not None and bias.dtype != x.dtype):
        raise TypeError(
            "float32 or bfloat16 x, float32 w, a bias in x's dtype; got x "
            f"{x.dtype}, w {w.dtype}, bias {None if bias is None else bias.dtype}")
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
        instance = plan(c, co, h, wd, x.dtype).instance
    elif instance not in INSTANCES[x.dtype]:
        raise ValueError(f"no {DTYPES[x.dtype]} cmconv instance {instance!r}; "
                         f"have {sorted(INSTANCES[x.dtype])}")
    out = torch.empty((b, co, h, wd), dtype=x.dtype, device=x.device)
    fn = _kernel(instance, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), b, c, co, h, wd,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cmconv {instance} kernel launch failed: cudaError_t "
                           f"{err} (x {tuple(x.shape)}, Co {co})")
    return out, instance


def cmconv3x3_cuda(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """`ops/cmconv.cmconv_plain` as one kernel launch, of the plan's instance
    for x's dtype."""
    global LAUNCHES
    out, instance = _launch(x, w, bias, None)
    LAUNCHES += 1
    DTYPE_LAUNCHES[DTYPES[x.dtype]] += 1
    PLAN_LAUNCHES[_instance_key(instance, x.dtype)] += 1
    return out


def cmconv3x3_instance(x: torch.Tensor, w: torch.Tensor,
                       bias: torch.Tensor | None, instance: str) -> torch.Tensor:
    """`cmconv3x3_cuda` through a named instance of x's dtype (float32
    "simt" or "tc", bf16 "sm90" or "simt")."""
    out, _ = _launch(x, w, bias, instance)
    INSTANCE_LAUNCHES[_instance_key(instance, x.dtype)] += 1
    return out


def reset_counts() -> None:
    """Set every launch count of this module to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for counts in (DTYPE_LAUNCHES, INSTANCE_LAUNCHES, PLAN_LAUNCHES):
        for k in counts:
            counts[k] = 0
