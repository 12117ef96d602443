"""The CUDA fused frozen-MBConv kernels (`csrc/mbconv.cu`), their tile plans and wrappers.

Replace the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
`tools/experiments/fused_mbconv.py` (launched by `_mbconv_fwd_pallas` and
`_mbconv_bwd_pallas`). `mbconv_fwd_cuda` and `mbconv_dx_cuda` have the
signatures of `ops/mbconv.mbconv_plain` and `mbconv_dx_plain`: x [B, H, W, C]
and g [B, H, W, Co] NHWC, the folded weights of `ops/mbconv.FoldedBlock`, a
k of 3 or 5, an act of `ops/mbconv.SUPPORTED_ACTS`. They take only
contiguous CUDA tensors on one device whose data start on a 16-byte
boundary: x, g and the fold's We and Wp all float32, or all bf16 (the bf16
instance, `mbconv_bf16.cu` and `mbconv_bf16_dx.cu`; `FoldedBlock.in_dtype`),
the other folded weights float32. Any other dtype raises: there is no
float16 instance. They launch on PyTorch's current stream, allocate their
output (in x's dtype; and, where the plan splits E, a float32 workspace) and
nothing else, and raise on any refusal; neither falls back to the plain
version.

`plan_fwd` / `plan_dx` choose each launch's tiling on the host (pure Python,
tested on the CPU, cached per shape and dtype: the search takes
milliseconds; a bf16 plan counts 2-byte buffers and bf16 products): the output tile, the accumulator width (a template
instance of the kernel, `built`), a split of E across blocks whose partials
`mbconv_reduce_kernel` adds in a fixed order, and a slice of the output
channels per block. A launch with a split runs two kernels; `LAUNCHES`
counts it once, as one call of the op, and `DTYPE_LAUNCHES` counts it again
under its dtype, so that a bf16 pass can show that it launched no float32
instance.

`mbconv_fwd_simt` / `mbconv_dx_simt` run the kernels' ablation (the 1x1
products as SIMT FMAs instead of 3xTF32 tensor-core products, the same
plan); the main path never calls them, and they count in
`ABLATION_LAUNCHES`.

The bf16 forward has a kernel of its own written for Hopper,
`csrc/mbconv_fwd_sm90.cu` (x staged once; each chunk's weights packed once
per fold, `sm90_pack`, and streamed through an mbarrier ring, one TMA bulk
copy a slot; a register-windowed depthwise; two blocks a SM where they
fit). `mbconv_fwd_cuda` takes it for every bf16 input whose shape
`sm90_supported` accepts (C, E
and Co multiples of 8, k 3 or 5, and a `plan_fwd_sm90` that fits the
budgets), and the template's bf16 instance (`mbconv_bf16.cu`) for every
other bf16 shape: the choice is by shape alone, and neither is a fallback
for the other. `BF16_FWD_LAUNCHES` counts the bf16 forward launches by
kernel ("sm90", "instance"), beside `LAUNCHES` and `DTYPE_LAUNCHES`, which
count both. `mbconv_fwd_bf16_instance` runs the instance on any bf16 shape:
the ablation timed beside the new kernel, which the main path never calls.

The bf16 input gradient has one too, `csrc/mbconv_dx_sm90.cu` (the x tile
with a halo of 2h and the g tile with a halo of h staged once; the chunks'
weights, `sm90_pack`'s slot images, through the same kind of mbarrier ring;
both depthwise passes register-windowed; 16 warps, or two blocks of 8 a
SM).
`mbconv_dx_cuda` takes it for every bf16 input whose shape
`sm90_dx_supported` accepts (`plan_dx_sm90`), the template's bf16 instance
(`mbconv_bf16_dx.cu`) elsewhere, by shape alone; `BF16_DX_LAUNCHES` counts
the bf16 dx launches by kernel, and `mbconv_dx_bf16_instance` is its
ablation.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .mbconv import SUPPORTED_ACTS, FoldedBlock

LAUNCHES = {"mbconv_fwd": 0, "mbconv_dx": 0}  # op calls that launched, this process
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}  # the instances
ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
DTYPE_LAUNCHES = {d: {"mbconv_fwd": 0, "mbconv_dx": 0} for d in DTYPES.values()}
ABLATION_LAUNCHES = {"mbconv_fwd": 0, "mbconv_dx": 0}
BF16_FWD_LAUNCHES = {"sm90": 0, "instance": 0}  # bf16 forward op calls, by kernel
BF16_DX_LAUNCHES = {"sm90": 0, "instance": 0}  # bf16 dx op calls, by kernel
ACT_CODES = {"relu6": 0, "relu": 1, "swish": 2, "silu": 2, "swish_native": 2}
assert set(ACT_CODES) == set(SUPPORTED_ACTS)

# csrc/mbconv.cu's constants
WARPS = 8                          # of 32 threads, a block's 256
EC = 32                            # a split of E is a multiple of this
MAX_SMEM = 232448                  # bytes a block may use
MAX_REGS = 255                     # per thread under __launch_bounds__(256, 1)
MAX_SPLIT = 8
# (TH, TW, NPW, EC, KC) instances of MLAD_MBCONV_FWD_CONFIGS / _DX_CONFIGS:
# the output tile, the accumulator's n-tiles per warp, E per chunk and the
# contraction channels staged at once
FWD_CONFIGS = ((8, 8, 8, 64, 32), (8, 8, 20, 64, 32), (8, 8, 28, 32, 32),
               (16, 8, 8, 64, 32), (16, 8, 20, 32, 32), (16, 16, 4, 32, 32))
DX_CONFIGS = ((8, 8, 8, 32, 32), (8, 8, 20, 32, 32), (8, 8, 28, 32, 32),
              (16, 8, 8, 32, 16), (16, 8, 20, 32, 16), (16, 16, 4, 32, 16))
MASKS_CONFIG = (8, 8, 8)
# registers besides the accumulators (fragments, addresses, loop state): an
# estimate, set from ptxas's counts on the H100 (chip_smoke.py phase 1 prints
# them), which it matches within 20
REG_OVERHEAD = {"fwd": 80, "dx": 110}
# H100 SXM per-SM rates for the cost model: 3xTF32 products, bf16 products,
# fp32 FMAs
SMS = 132
TC_FLOP_PER_US = 495e6 / 3 / SMS
BF16_FLOP_PER_US = 989e6 / SMS
FP_FLOP_PER_US = 67e6 / SMS

_P = ctypes.c_void_p
_I = ctypes.c_int


class Plan(NamedTuple):
    """One launch's tiling: output tile th x tw, npw accumulator n-tiles per
    warp, E split over `split` blocks of `e_per_split` channels, the output
    channels in slices of `n_per_slice`; its shared memory (bytes), an
    estimate of its registers per thread and of its time (us)."""
    th: int
    tw: int
    npw: int
    split: int
    e_per_split: int
    n_per_slice: int
    smem: int
    regs: int
    cost_us: float


def reset_counts() -> None:
    """Set the launch counts (main path, per dtype and ablation) to 0."""
    for counts in (LAUNCHES, ABLATION_LAUNCHES, BF16_FWD_LAUNCHES, BF16_DX_LAUNCHES,
                   *DTYPE_LAUNCHES.values()):
        for name in counts:
            counts[name] = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round(a: int, b: int) -> int:
    return _ceil(a, b) * b


def configs(kind: str):
    """The (TH, TW, NPW, EC, KC) instances of one kernel."""
    return FWD_CONFIGS if kind == "fwd" else DX_CONFIGS


def built(kind: str, k: int, th: int, tw: int, npw: int, v16: bool,
          masks: bool = False) -> bool:
    """Whether csrc/mbconv.cu builds this instance (its `built()`)."""
    if not any(cfg[:3] == (th, tw, npw) for cfg in configs(kind)):
        return False
    if masks:
        return kind == "dx" and (th, tw, npw) == MASKS_CONFIG
    if not v16:
        return (th, tw) == (8, 8) and npw in (8, 28)
    return not (kind == "dx" and k == 5 and (th, tw) == (16, 16))


def _config(kind: str, th: int, tw: int, npw: int):
    return next(cfg for cfg in configs(kind) if cfg[:3] == (th, tw, npw))


def warp_layout(th: int, tw: int):
    """(warps per output m-tile, output m-tiles per warp) of a th x tw tile."""
    mt = th * tw // 16
    return (1, mt // WARPS) if mt >= WARPS else (WARPS // mt, 1)


def smem_bytes(kind: str, k: int, th: int, tw: int, npw: int, n_cols: int,
               itemsize: int = 4) -> int:
    """Dynamic shared memory of a block (`fwd_smem_bytes` / `dx_smem_bytes`)
    whose widest output slice has n_cols channels; itemsize 4 for float32,
    2 for bf16 (whose rows pad by 8 elements, not 4)."""
    _, _, _, ec, kc = _config(kind, th, tw, npw)
    pad = 16 // itemsize
    ldx, ldw, lde = kc + pad, ec + 8, ec + pad
    h = k // 2
    tp = th * tw
    if kind == "fwd":
        fnh = (th + 2 * h) * (tw + 2 * h)
        ldp = _round(_round(n_cols, 8), 32) + 8
        nhp = _round(fnh, 16)  # the packed rows' offsets, then the rings, e, d, Wp
        return 4 * nhp + itemsize * (2 * nhp * ldx + 2 * kc * ldw + fnh * lde
                                     + tp * lde + ec * ldp)
    n2 = (th + 4 * h) * (tw + 4 * h)
    n1 = (th + 2 * h) * (tw + 2 * h)
    region = max(2 * _round(n2, 16) * ldx + 2 * kc * ldw,
                 2 * _round(n1, 16) * ldx + 2 * ec * ldx, _round(n_cols, 8) * lde)
    # offsets, staging and e in the element type; act'(z1) / gd, act'(z0) / ge float32
    return (4 * (_round(n2, 16) + _round(n1, 16)) + itemsize * (region + n2 * lde)
            + 4 * (n1 + tp) * (ec + 4))


def regs_estimate(kind: str, k: int, th: int, tw: int, npw: int) -> int:
    """Registers per thread: the accumulators of the expand (or g . Wp^T) and
    of the output sum, plus REG_OVERHEAD."""
    ec = _config(kind, th, tw, npw)[3]
    h = k // 2
    halo = h if kind == "fwd" else 2 * h
    units = _ceil((th + 2 * halo) * (tw + 2 * halo), 16) * (ec // 32)
    _, mpw = warp_layout(th, tw)
    return _ceil(units, WARPS) * 4 * 4 + mpw * npw * 4 + REG_OVERHEAD[kind]


def _clipped(n: int, t: int, halo: int):
    """The image-clipped extent of each tile's halo along one axis."""
    return [min(n, y + t + halo) - max(0, y - halo) for y in range(0, n, t)]


def _cost_us(kind, b, hgt, wid, c, e, co, k, th, tw, npw, split, eps, n_slice, n_out,
             itemsize=4):
    """A rough time model: waves of one block per SM; per block the 3xTF32
    (or bf16) products over its rows and the depthwise on the FP32 pipe, plus
    a fixed cost per staged chunk; then the reduction's bytes."""
    h = k // 2
    tiles = _ceil(hgt, th) * _ceil(wid, tw)
    blocks = tiles * b * split * _ceil(n_out, n_slice)
    n_cols = _round(min(n_slice, n_out), 8)
    tp_rows = sum(min(th, hgt - y) for y in range(0, hgt, th)) / _ceil(hgt, th) * tw

    def rows(halo):  # mean packed rows of the clipped halo, padded to 16
        return sum(_round(ry * rx, 16) for ry in _clipped(hgt, th, halo)
                   for rx in _clipped(wid, tw, halo)) / tiles

    _, _, _, ec, kc = _config(kind, th, tw, npw)
    if kind == "fwd":
        tc = rows(h) * _round(c, 8) + _round(tp_rows, 16) * n_cols
        fp = th * tw * k * k
        stages = _ceil(c, kc) + 1
    else:
        tc = rows(2 * h) * _round(c, 8) + rows(h) * _round(co, 8) + _round(tp_rows, 16) * n_cols
        fp = ((th + 2 * h) * (tw + 2 * h) + th * tw) * k * k
        stages = _ceil(c, kc) + _ceil(co, kc) + 1
    products = (3 * 2 * tc * ec / TC_FLOP_PER_US if itemsize == 4
                else 2 * tc * ec / BF16_FLOP_PER_US)
    per_chunk = products + 2 * fp * ec / FP_FLOP_PER_US + 0.3 * stages
    t = _ceil(blocks, SMS) * _ceil(eps, ec) * per_chunk
    if split > 1:
        t += (split + 2) * b * hgt * wid * n_out * 4 / 3.0e6
    return t


@functools.lru_cache(maxsize=None)
def _plan(kind, hgt, wid, c, e, co, k, batch, masks, itemsize):
    n_out = co if kind == "fwd" else c
    vec = 16 // itemsize  # elements of a 16-byte copy
    v16 = c % vec == 0 and e % vec == 0 and co % vec == 0
    best = None
    for th, tw, npw, _, _ in configs(kind) if k in (3, 5) else ():
        if not built(kind, k, th, tw, npw, v16, masks):
            continue
        wpm, _ = warp_layout(th, tw)
        cover = npw * wpm * 8
        n_slices = _ceil(n_out, cover)
        n_slice = _round(_ceil(n_out, n_slices), 8)
        smem = smem_bytes(kind, k, th, tw, npw, min(n_slice, n_out), itemsize)
        regs = regs_estimate(kind, k, th, tw, npw)
        if smem > MAX_SMEM or regs > MAX_REGS:
            continue
        for split in range(1, MAX_SPLIT + 1):
            eps = _round(_ceil(e, split), EC)
            if (split - 1) * eps >= e:
                continue
            cost = _cost_us(kind, batch, hgt, wid, c, e, co, k, th, tw, npw, split, eps,
                            n_slice, n_out, itemsize)
            plan = Plan(th, tw, npw, split, eps, n_slice, smem, regs, cost)
            if best is None or cost < best.cost_us:
                best = plan
    if best is None:
        raise ValueError(f"no fused MBConv {kind} plan for H {hgt} W {wid} C {c} "
                         f"E {e} Co {co} k {k}")
    return best


def _itemsize(dtype) -> int:
    if dtype not in ITEMSIZE:
        raise TypeError(f"no fused MBConv instance for {dtype} (float32 or bfloat16)")
    return ITEMSIZE[dtype]


def plan_fwd(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1,
             dtype=torch.float32) -> Plan:
    """The forward's tile plan for x [batch, H, W, C] (E, Co, k) in `dtype`."""
    return _plan("fwd", H, W, C, E, Co, k, batch, False, _itemsize(dtype))


def plan_dx(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1,
            masks: bool = False, dtype=torch.float32) -> Plan:
    """dx's tile plan; `masks` plans the instance that also writes the masks."""
    return _plan("dx", H, W, C, E, Co, k, batch, masks, _itemsize(dtype))


# csrc/mbconv_fwd_sm90.cu: its instances, (TH, TW, EC, MPW, NPW, STAGES,
# MINB) of MLAD_SM90_CONFIGS: the output tile, E per chunk, each warp's
# share of the project's sum in m-tiles (16 pixels) by n-tiles (8
# channels), the slots of the ring, and the blocks an SM holds (2: at most
# 128 registers and SM90_MAX_SMEM2 bytes a block)
SM90_CONFIGS = ((16, 16, 32, 2, 4, 3, 2), (16, 8, 32, 1, 7, 3, 2), (8, 8, 32, 4, 3, 2, 2),
                (8, 8, 64, 4, 3, 2, 1), (8, 8, 32, 4, 7, 2, 1))
SM90_WARPS = 8            # a block's 256 threads
SM90_MAX_SMEM2 = 115712   # each of two blocks on an SM: 228 KB, 1 KB reserved a block
SM90_BAR_BYTES = 128
SM90_SPLITS = (1, 2, 3, 4, 8, 16)  # the splits of E the planner weighs (and the sweep times)
SM90_MAX_REGS = {1: 255, 2: 128}  # per thread under __launch_bounds__(256, MINB)
# registers per thread of each instance at k = 3 and 5, ptxas's counts on
# the H100 (chip_smoke.py phase 1 prints them); none spills
SM90_REGS = {(16, 16, 32, 2, 4, 3, 2): (118, 114), (16, 8, 32, 1, 7, 3, 2): (109, 110),
             (8, 8, 32, 4, 3, 2, 2): (124, 125), (8, 8, 64, 4, 3, 2, 1): (159, 161),
             (8, 8, 32, 4, 7, 2, 1): (224, 226)}
# The cost model's constants (`_sm90_basis`): a block's fixed us, a chunk's
# fixed us, us per MFLOP of a chunk's products and of its depthwise, us per
# MB of a split's reduction, and the stretch of a block's time with two
# blocks on an SM. Fitted by
# `python3 -m mladversarialobjectdetection_torch.ops.mbconv_sweep` (every
# plan at lite4@640's 7 fused shapes, b1 and b24) on an NVIDIA H100 80GB
# HBM3 at 700 W.
SM90_COST = (3.1122, 1.0051, 0.6853, 6.5977, 0.3222, 1.30)


class Sm90Plan(NamedTuple):
    """One launch of the Hopper bf16 forward: instance (th, tw, ec, mpw,
    npw, stages, minb), `wn` warps along the output channels, E split over
    `split` blocks of `e_per_split` channels; the staged x tile's rows, the
    block's shared memory (bytes), an estimate of its registers per thread,
    its blocks, and the cost model's time (us)."""
    th: int
    tw: int
    ec: int
    mpw: int
    npw: int
    stages: int
    minb: int
    wn: int
    split: int
    e_per_split: int
    nhp: int
    smem: int
    regs: int
    blocks: int
    cost_us: float


def sm90_region_rows(hgt: int, wid: int, th: int, tw: int, k: int, halo: int | None = None) -> int:
    """The largest image-clipped region of a th x tw tile with a halo of
    `halo` (k // 2 by default), in pixels, padded to 16 (the rows of a staged
    tile; `region_rows`)."""
    h = k // 2 if halo is None else halo
    my = max(min(y + th + h, hgt) - max(y - h, 0) for y in range(0, hgt, th))
    mx = max(min(x + tw + h, wid) - max(x - h, 0) for x in range(0, wid, tw))
    return _round(my * mx, 16)


def sm90_smem_bytes(k, th, tw, ec, stages, c, co, nhp) -> int:
    """A block's shared memory (`smem_bytes` of the source): the barriers,
    the staged rows' positions and offsets, the x tile, the ring, e and d. A slot holds
    We [round16(C)][EC + 8] and Wp [EC][round16(Co) + 8] in bf16, then be,
    bd and wd [k * k] of the chunk in float32; bf16 rows pad by 8."""
    slot = (2 * (_round(c, 16) * (ec + 8) + ec * (_round(co, 16) + 8))
            + 4 * (2 + k * k) * ec)
    return (SM90_BAR_BYTES + 8 * nhp + 2 * nhp * (_round(c, 16) + 8) + stages * slot
            + 2 * (ec + 8) * ((th + k - 1) * (tw + k - 1) + _round(th * tw, 16)))


def _sm90_wn(cfg, co: int, nw: int = SM90_WARPS):
    """The warps along the output channels (a divisor of the block's nw)
    that fits the instance's accumulator and leaves the fewest fragments to
    the busiest warp, or None."""
    th, tw, _, mpw, npw = cfg[:5]
    nt, mtp = co // 8, _ceil(th * tw, 16)
    best = None
    for wn in (d for d in range(1, nw + 1) if nw % d == 0):
        wm = nw // wn
        if _ceil(nt, wn) > npw or _ceil(mtp, wm) > mpw:
            continue
        load = _ceil(mtp, wm) * _ceil(nt, wn)
        if best is None or load < best[0]:
            best = (load, wn)
    return None if best is None else best[1]


def _sm90_terms(cfg, b, hgt, wid, c, e, co, k, split):
    """What a plan's time depends on: (waves of blocks over the SMs, chunks
    a block, MFLOP of a chunk's products (the expand over the clipped halo's
    rows, the project), MFLOP of its depthwise, MB a split's reduction reads
    and writes, blocks a SM)."""
    th, tw, ec = cfg[:3]
    minb = cfg[6]
    h = k // 2
    tiles = _ceil(hgt, th) * _ceil(wid, tw)
    rows = sum(_round(ry * rx, 16) for ry in _clipped(hgt, th, h)
               for rx in _clipped(wid, tw, h)) / tiles
    tensor = 2 * ec * (rows * _round(c, 16) + th * tw * co) / 1e6
    fp = 2 * ec * th * tw * k * k / 1e6
    reduce_mb = (split + 2) * b * hgt * wid * co * 4 / 1e6 if split > 1 else 0.0
    waves = _ceil(tiles * b * split, SMS * minb)
    return waves, _ceil(_round(_ceil(e, split), ec), ec), tensor, fp, reduce_mb, minb


def _sm90_basis(terms, two_blocks):
    """The cost model's basis: time = this . SM90_COST[:5]. Waves times a
    block's time (stretched where two blocks share an SM), a block's time
    its fixed cost and its chunks' (fixed, products, depthwise); then a
    split's reduction."""
    waves, chunks, tensor, fp, reduce_mb, minb = terms
    m = waves * (two_blocks if minb == 2 else 1.0)
    return (m, m * chunks, m * chunks * tensor, m * chunks * fp, reduce_mb)


def _sm90_cost_us(cfg, b, hgt, wid, c, e, co, k, split):
    """The cost model's time (us) of a plan, and its blocks."""
    terms = _sm90_terms(cfg, b, hgt, wid, c, e, co, k, split)
    cost = sum(x * y for x, y in zip(_sm90_basis(terms, SM90_COST[5]), SM90_COST))
    th, tw = cfg[:2]
    return cost, _ceil(hgt, th) * _ceil(wid, tw) * b * split


def sm90_plans(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1):
    """Every plan of the Hopper bf16 forward for x [batch, H, W, C] (E, Co,
    k) that fits its budgets: each instance whose accumulator holds Co, that
    fits 227 KB of shared memory (113 KB with two blocks a SM) and ptxas's
    registers in the budget, with each
    split of E into whole chunks. None where C, E or Co is not a multiple of
    8 (16-byte bulk copies of whole rows) or k is not 3 or 5."""
    if C % 8 or E % 8 or Co % 8 or k not in (3, 5) or min(H, W, C, E, Co, batch) < 1:
        return []
    plans = []
    for cfg in SM90_CONFIGS:
        th, tw, ec, mpw, npw, stages, minb = cfg
        wn = _sm90_wn(cfg, Co)
        if wn is None:
            continue
        nhp = sm90_region_rows(H, W, th, tw, k)
        smem = sm90_smem_bytes(k, th, tw, ec, stages, C, Co, nhp)
        regs = SM90_REGS[cfg][k == 5]
        if smem > (MAX_SMEM if minb == 1 else SM90_MAX_SMEM2) or regs > SM90_MAX_REGS[minb]:
            continue
        for split in SM90_SPLITS:
            eps = _round(_ceil(E, split), ec)
            if (split - 1) * eps >= E:
                continue
            cost, blocks = _sm90_cost_us(cfg, batch, H, W, C, E, Co, k, split)
            plans.append(Sm90Plan(th, tw, ec, mpw, npw, stages, minb, wn, split, eps, nhp,
                                  smem, regs, blocks, cost))
    return plans


@functools.lru_cache(maxsize=None)
def plan_fwd_sm90(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1):
    """The Hopper bf16 forward's plan for x [batch, H, W, C] (E, Co, k): the
    cost model's fastest of `sm90_plans`, or None where there is none (the
    shape then runs the template's bf16 instance). A split of E is taken only
    where the model says it pays for its reduction; where the grid has fewer
    blocks than SMs and none does, the plan leaves SMs idle."""
    plans = sm90_plans(H, W, C, E, Co, k, batch)
    return min(plans, key=lambda p: p.cost_us) if plans else None


def sm90_supported(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1) -> bool:
    """Whether the bf16 forward of this shape runs the Hopper kernel (else
    the template's bf16 instance)."""
    return plan_fwd_sm90(H, W, C, E, Co, k, batch) is not None


# csrc/mbconv_dx_sm90.cu, the Hopper bf16 input gradient: its instances,
# (TH, TW, EC, MPW, NPW, STAGES, MINB, NW) of MLAD_DX_SM90_CONFIGS, as
# SM90_CONFIGS with the block's warps NW; MPW by NPW is each warp's share
# of the dx sum (pixels by C)
DX_SM90_CONFIGS = ((16, 16, 32, 1, 4, 2, 1, 16), (8, 8, 16, 1, 7, 2, 2, 8),
                   (8, 8, 32, 1, 4, 2, 1, 16), (8, 8, 16, 1, 5, 2, 1, 16),
                   (4, 8, 16, 1, 5, 2, 1, 16))


def dx_reg_cap(minb: int, nw: int) -> int:
    """Registers a thread may use under __launch_bounds__(32 nw, minb): the
    SM's 65536 over the threads of minb blocks, at most 255."""
    return min(255, 65536 // (32 * nw * minb) // 8 * 8)


# registers per thread of each instance at k = 3 and 5, ptxas's counts on
# the H100 (chip_smoke.py phase 1 prints them); none spills
DX_SM90_REGS = {(16, 16, 32, 1, 4, 2, 1, 16): (128, 128), (8, 8, 16, 1, 7, 2, 2, 8): (116, 126),
                (8, 8, 32, 1, 4, 2, 1, 16): (127, 128), (8, 8, 16, 1, 5, 2, 1, 16): (127, 128),
                (4, 8, 16, 1, 5, 2, 1, 16): (127, 128)}
# the dx cost model's constants, as SM90_COST (`_sm90_basis`; its terms
# `_dx_sm90_terms`), fitted by `python3 -m
# mladversarialobjectdetection_torch.ops.mbconv_sweep --kind dx` (every
# plan at lite4@640's 7 fused shapes, b1 and b24) on an NVIDIA H100 80GB
# HBM3 at 700 W
DX_SM90_COST = (3.4724, 1.3139, 0.8263, 7.9258, 0.4118, 1.40)


class Sm90DxPlan(NamedTuple):
    """One launch of the Hopper bf16 input gradient: instance (th, tw, ec,
    mpw, npw, stages, minb, nw), `wn` of its nw warps along C, E split over
    `split` blocks of `e_per_split` channels; the staged x tile's rows (halo
    2h) and g tile's (halo h), the block's shared memory (bytes), ptxas's
    registers per thread, its blocks, and the cost model's time (us)."""
    th: int
    tw: int
    ec: int
    mpw: int
    npw: int
    stages: int
    minb: int
    nw: int
    wn: int
    split: int
    e_per_split: int
    n2p: int
    n1p: int
    smem: int
    regs: int
    blocks: int
    cost_us: float


def dx_sm90_smem_bytes(k, th, tw, ec, stages, c, co, n2p, n1p) -> int:
    """A block's shared memory (`smem_bytes` of mbconv_dx_sm90.cu): the
    barriers, the staged rows' positions and offsets, the x and g tiles, the
    ring of `sm90_pack` slots, e and ge (bf16), act'(z1) / gd and act'(z0)
    (float32); bf16 rows pad by 8, float32 rows by 4."""
    h = k // 2
    slot = (2 * (_round(c, 16) * (ec + 8) + ec * (_round(co, 16) + 8))
            + 4 * (2 + k * k) * ec)
    return (SM90_BAR_BYTES + 8 * (n2p + n1p)
            + 2 * (n2p * (_round(c, 16) + 8) + n1p * (_round(co, 16) + 8)) + stages * slot
            + 2 * (ec + 8) * ((th + 4 * h) * (tw + 4 * h) + th * tw)
            + 4 * (ec + 4) * ((th + 2 * h) * (tw + 2 * h) + th * tw))


def _dx_sm90_terms(cfg, b, hgt, wid, c, e, co, k, split):
    """What a dx plan's time depends on, as `_sm90_terms`: (waves, chunks a
    block, MFLOP of a chunk's products (the expand over the clipped x rows,
    g . Wp^T over the clipped g rows, ge . We^T), MFLOP of its two depthwise
    passes, MB of a split's reduction, blocks a SM)."""
    th, tw, ec = cfg[:3]
    minb = cfg[6]
    h = k // 2
    tiles = _ceil(hgt, th) * _ceil(wid, tw)

    def rows(halo, pad):  # mean clipped region of a tile
        return sum(_round(ry * rx, 16) if pad else ry * rx for ry in _clipped(hgt, th, halo)
                   for rx in _clipped(wid, tw, halo)) / tiles

    tensor = 2 * ec * (rows(2 * h, True) * _round(c, 16) + rows(h, True) * _round(co, 16)
                       + th * tw * c) / 1e6
    fp = 2 * ec * (rows(h, False) + th * tw) * k * k / 1e6
    reduce_mb = (split + 2) * b * hgt * wid * c * 4 / 1e6 if split > 1 else 0.0
    waves = _ceil(tiles * b * split, SMS * minb)
    return waves, _ceil(_round(_ceil(e, split), ec), ec), tensor, fp, reduce_mb, minb


def sm90_dx_plans(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1):
    """Every plan of the Hopper bf16 input gradient for x [batch, H, W, C]
    (E, Co, k) that fits its budgets, as `sm90_plans`: each instance whose
    accumulator holds C, that fits 227 KB of shared memory (113 KB with two
    blocks a SM) and ptxas's registers, at each split of E into whole
    chunks. None where C, E or Co is not a multiple of 8 or k is not 3 or 5."""
    if C % 8 or E % 8 or Co % 8 or k not in (3, 5) or min(H, W, C, E, Co, batch) < 1:
        return []
    plans = []
    for cfg in DX_SM90_CONFIGS:
        th, tw, ec, mpw, npw, stages, minb, nw = cfg
        wn = _sm90_wn(cfg, C, nw)
        if wn is None:
            continue
        n2p = sm90_region_rows(H, W, th, tw, k, halo=2 * (k // 2))
        n1p = sm90_region_rows(H, W, th, tw, k)
        smem = dx_sm90_smem_bytes(k, th, tw, ec, stages, C, Co, n2p, n1p)
        regs = DX_SM90_REGS[cfg][k == 5]
        if smem > (MAX_SMEM if minb == 1 else SM90_MAX_SMEM2) or regs > dx_reg_cap(minb, nw):
            continue
        for split in SM90_SPLITS:
            eps = _round(_ceil(E, split), ec)
            if (split - 1) * eps >= E:
                continue
            terms = _dx_sm90_terms(cfg, batch, H, W, C, E, Co, k, split)
            cost = sum(a * b for a, b in zip(_sm90_basis(terms, DX_SM90_COST[5]), DX_SM90_COST))
            blocks = _ceil(H, th) * _ceil(W, tw) * batch * split
            plans.append(Sm90DxPlan(th, tw, ec, mpw, npw, stages, minb, nw, wn, split, eps, n2p,
                                    n1p, smem, regs, blocks, cost))
    return plans


@functools.lru_cache(maxsize=None)
def plan_dx_sm90(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1):
    """The Hopper bf16 input gradient's plan for x [batch, H, W, C] (E, Co,
    k): the cost model's fastest of `sm90_dx_plans`, or None where there is
    none (the shape then runs the template's bf16 instance)."""
    plans = sm90_dx_plans(H, W, C, E, Co, k, batch)
    return min(plans, key=lambda p: p.cost_us) if plans else None


def sm90_dx_supported(H: int, W: int, C: int, E: int, Co: int, k: int, batch: int = 1) -> bool:
    """Whether the bf16 input gradient of this shape runs the Hopper kernel
    (else the template's bf16 instance)."""
    return plan_dx_sm90(H, W, C, E, Co, k, batch) is not None


@functools.lru_cache(maxsize=None)
def _entry(lib: str, name: str):
    """A C entry of csrc/<lib>.cu, built on first use."""
    fn = getattr(_build.load(lib), name)
    tail = [_P, _P, _P] if "fwd" in name else [_P, _P, _P, _P]  # out, ws, [masks,] stream
    fn.argtypes = [_P] * 7 + [_I] * 15 + tail
    fn.restype = ctypes.c_int
    return fn


# (kind, instance): (library, C entry)
_LIBS = {("fwd", "float32"): ("mbconv", "mlad_mbconv_fwd"),
         ("dx", "float32"): ("mbconv_dx", "mlad_mbconv_dx"),
         ("fwd", "simt"): ("mbconv_simt_fwd", "mlad_mbconv_fwd_simt"),
         ("dx", "simt"): ("mbconv_simt_dx", "mlad_mbconv_dx_simt"),
         ("fwd", "bfloat16"): ("mbconv_bf16", "mlad_mbconv_fwd_bf16"),
         ("dx", "bfloat16"): ("mbconv_bf16_dx", "mlad_mbconv_dx_bf16")}


def _check(data, fb: FoldedBlock, c: int, act_type: str, residual: bool):
    """Raise unless x (and g) are contiguous CUDA tensors of one dtype,
    float32 or bf16, the fold's We and Wp in that dtype and its other
    weights float32, all on one device, 16-byte aligned, and the folded
    weights fit x's C. Returns (E, Co, k)."""
    dtype = data[0].dtype
    weights = list(fb)
    want = [dtype] + [torch.float32] * 3 + [dtype, torch.float32]
    if (dtype not in DTYPES or any(t.dtype != dtype for t in data)
            or [t.dtype for t in weights] != want):
        raise TypeError(f"float32 only, or bf16 x and g with a bf16 fold's We and "
                        f"Wp (the rest float32); got {[t.dtype for t in data + weights]}")
    tensors = data + weights
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the fused MBConv kernels take CUDA tensors; use "
                         "ops/mbconv.mbconv_plain on the CPU")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, g and the folded weights must be contiguous (x "
                         "and g in NHWC)")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the fused MBConv kernels need each tensor's data on a "
                         "16-byte boundary (cp.async)")
    if act_type not in ACT_CODES:
        raise ValueError(f"unsupported act {act_type}")
    e, co = fb.wp.shape
    k = fb.wd.shape[0]
    want = {"we": (c, e), "be": (e,), "wd": (k, k, e), "bd": (e,),
            "wp": (e, co), "bp": (co,)}
    got = {name: tuple(getattr(fb, name).shape) for name in want}
    if got != want or k not in (3, 5):
        raise ValueError(f"folded weights {got} for C={c}: want {want} with "
                         f"k 3 or 5")
    if residual and c != co:
        raise ValueError(f"a residual block needs C == Co, got {c} and {co}")
    return e, co, k


def _launch(kind, variant, ptrs, shape, e, co, k, act_type, residual, out, plan,
            masks_out=None):
    b, h, w, c = shape
    if min(b, h, w, c) < 1:
        raise ValueError(f"empty input {tuple(shape)}")
    n_out = co if kind == "fwd" else c
    ws = None
    if plan.split > 1:
        ws = torch.empty((plan.split, b, h, w, n_out), dtype=torch.float32,
                         device=out.device)
    tail = [out.data_ptr(), ws.data_ptr() if ws is not None else None]
    if kind == "dx":
        tail.append(masks_out.data_ptr() if masks_out is not None else None)
    lib, name = _LIBS[(kind, variant)]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _entry(lib, name)(*ptrs, b, h, w, c, e, co, k, ACT_CODES[act_type],
                                int(residual), plan.th, plan.tw, plan.npw, plan.split,
                                plan.e_per_split, plan.n_per_slice, *tail, stream)
    if err != 0:
        raise RuntimeError(f"mbconv {kind} kernel launch failed: cudaError_t "
                           f"{err} (x {tuple(shape)}, E {e}, Co {co}, k {k}, {plan})")
    if variant == "simt":
        ABLATION_LAUNCHES[f"mbconv_{kind}"] += 1
    else:
        LAUNCHES[f"mbconv_{kind}"] += 1
        DTYPE_LAUNCHES[variant][f"mbconv_{kind}"] += 1
        if variant == "bfloat16":
            (BF16_FWD_LAUNCHES if kind == "fwd" else BF16_DX_LAUNCHES)["instance"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm90_entry():
    """The C entry of csrc/mbconv_fwd_sm90.cu, built on first use."""
    fn = _build.load("mbconv_fwd_sm90").mlad_mbconv_fwd_sm90
    fn.argtypes = [_P] * 3 + [_I] * 16 + [_P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def sm90_pack(fb: FoldedBlock, ec: int) -> torch.Tensor:
    """The Hopper kernel's weights: for each chunk of ec expanded channels,
    the slot image it copies into shared memory in one piece, uint8
    [ceil(E / ec), slot bytes]: We[:, chunk] as [round16(C)][ec + 8] bf16,
    Wp[chunk, :] as [ec][round16(Co) + 8] bf16, then be, bd and wd [k * k]
    of the chunk [ec each] in float32; zero in the padding and past E."""
    (c, e), co, k = fb.we.shape, fb.wp.shape[1], fb.wd.shape[0]
    n = _ceil(e, ec)
    c16, lp = _round(c, 16), _round(co, 16) + 8
    we = fb.we.new_zeros((c16, n * ec))
    we[:c, :e] = fb.we
    we = torch.nn.functional.pad(we.view(c16, n, ec).permute(1, 0, 2), (0, 8))
    wp = fb.wp.new_zeros((n * ec, lp))
    wp[:e, :co] = fb.wp
    f = fb.be.new_zeros((2 + k * k, n * ec))
    f[0, :e], f[1, :e], f[2:, :e] = fb.be, fb.bd, fb.wd.reshape(k * k, e)
    parts = (we.reshape(n, -1), wp.view(n, -1), f.view(-1, n, ec).permute(1, 0, 2).reshape(n, -1))
    return torch.cat([t.contiguous().view(torch.uint8) for t in parts], dim=1)


def _sm90_packed(fb: FoldedBlock, ec: int) -> torch.Tensor:
    """`sm90_pack(fb, ec)`, cached on the fold's We tensor per ec while the
    five weight tensors keep their storage and version (a frozen fold packs
    once for each chunk width its forward and dx plans use)."""
    key = tuple((t.data_ptr(), t._version) for t in fb[:5])
    cache = getattr(fb.we, "_mlad_sm90_packs", None)
    if cache is None or cache[0] != key:
        cache = (key, {})
        fb.we._mlad_sm90_packs = cache
    if ec not in cache[1]:
        cache[1][ec] = sm90_pack(fb, ec)
    return cache[1][ec]


def _launch_sm90(x, fb, e, co, k, act_type, residual, plan: Sm90Plan):
    b, h, w, c = x.shape
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    ws = None
    if plan.split > 1:
        ws = torch.empty((plan.split, b, h, w, co), dtype=torch.float32, device=x.device)
    packed = _sm90_packed(fb, plan.ec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _sm90_entry()(x.data_ptr(), packed.data_ptr(), fb.bp.data_ptr(), b, h, w, c, e, co, k,
                            ACT_CODES[act_type], int(residual), plan.th, plan.tw, plan.ec,
                            plan.npw, plan.wn, plan.split, plan.e_per_split, out.data_ptr(),
                            ws.data_ptr() if ws is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"mbconv_fwd_sm90 kernel launch failed: cudaError_t {err} (x "
                           f"{tuple(x.shape)}, E {e}, Co {co}, k {k}, {plan})")
    LAUNCHES["mbconv_fwd"] += 1
    DTYPE_LAUNCHES["bfloat16"]["mbconv_fwd"] += 1
    BF16_FWD_LAUNCHES["sm90"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm90_dx_entry():
    """The C entry of csrc/mbconv_dx_sm90.cu, built on first use."""
    fn = _build.load("mbconv_dx_sm90").mlad_mbconv_dx_sm90
    fn.argtypes = [_P] * 3 + [_I] * 16 + [_P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _launch_sm90_dx(x, g, fb, e, co, k, act_type, residual, plan: Sm90DxPlan, masks_out):
    b, h, w, c = x.shape
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ws = None
    if plan.split > 1:
        ws = torch.empty((plan.split, b, h, w, c), dtype=torch.float32, device=x.device)
    packed = _sm90_packed(fb, plan.ec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _sm90_dx_entry()(x.data_ptr(), g.data_ptr(), packed.data_ptr(), b, h, w, c, e, co,
                               k, ACT_CODES[act_type], int(residual), plan.th, plan.tw, plan.ec,
                               plan.npw, plan.wn, plan.split, plan.e_per_split, out.data_ptr(),
                               ws.data_ptr() if ws is not None else None,
                               masks_out.data_ptr() if masks_out is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"mbconv_dx_sm90 kernel launch failed: cudaError_t {err} (x "
                           f"{tuple(x.shape)}, E {e}, Co {co}, k {k}, {plan})")
    LAUNCHES["mbconv_dx"] += 1
    DTYPE_LAUNCHES["bfloat16"]["mbconv_dx"] += 1
    BF16_DX_LAUNCHES["sm90"] += 1
    return out


def _variant(x, simt):
    if simt and x.dtype != torch.float32:
        raise TypeError("the SIMT ablation has a float32 instance only")
    return "simt" if simt else DTYPES[x.dtype]


def _fwd(x, fb, act_type, residual, plan, simt, instance=False):
    if x.dim() != 4:
        raise ValueError(f"want x [B, H, W, C], got {tuple(x.shape)}")
    e, co, k = _check([x], fb, x.shape[3], act_type, residual)
    b, h, w, c = x.shape
    if x.dtype == torch.bfloat16 and not (simt or instance or plan):
        p90 = plan_fwd_sm90(h, w, c, e, co, k, b)
        if p90 is not None:
            return _launch_sm90(x, fb, e, co, k, act_type, residual, p90)
    plan = plan or plan_fwd(h, w, c, e, co, k, b, dtype=x.dtype)
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, *fb)]
    return _launch("fwd", _variant(x, simt), ptrs, x.shape, e, co, k, act_type,
                   residual, out, plan)


def _dx(x, g, fb, act_type, residual, masks_out, plan, simt, instance=False):
    if x.dim() != 4 or g.dim() != 4 or g.shape[:3] != x.shape[:3]:
        raise ValueError(f"want x [B, H, W, C] and g [B, H, W, Co], got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    e, co, k = _check([x, g], fb, x.shape[3], act_type, residual)
    if g.shape[3] != co:
        raise ValueError(f"g has {g.shape[3]} channels, the block {co}")
    b, h, w, c = x.shape
    if masks_out is not None:
        if ACT_CODES[act_type] == ACT_CODES["swish"] or simt:
            raise ValueError("masks_out: relu6 / relu on the main kernel only")
        if (masks_out.dtype != torch.uint8 or masks_out.shape != (2, b, h, w, e)
                or not masks_out.is_contiguous() or masks_out.device != x.device):
            raise ValueError(f"masks_out must be a contiguous uint8 [2, {b}, {h}, "
                             f"{w}, {e}] tensor on {x.device}")
    if x.dtype == torch.bfloat16 and not (simt or instance or plan):
        p90 = plan_dx_sm90(h, w, c, e, co, k, b)
        if p90 is not None:
            return _launch_sm90_dx(x, g, fb, e, co, k, act_type, residual, p90, masks_out)
    plan = plan or plan_dx(h, w, c, e, co, k, b, masks=masks_out is not None,
                           dtype=x.dtype)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, g, *fb[:5])]  # bp: no part in dx
    return _launch("dx", _variant(x, simt), ptrs, x.shape, e, co, k, act_type,
                   residual, out, plan, masks_out)


def mbconv_fwd_cuda(x: torch.Tensor, fb: FoldedBlock, *, act_type: str,
                    residual: bool) -> torch.Tensor:
    """`ops/mbconv.mbconv_plain` as one op call: y [B, H, W, Co] in x's
    dtype. bf16 runs the Hopper kernel where `sm90_supported` takes the
    shape, the template's bf16 instance elsewhere."""
    return _fwd(x, fb, act_type, residual, None, False)


def mbconv_fwd_bf16_instance(x: torch.Tensor, fb: FoldedBlock, *, act_type: str,
                             residual: bool) -> torch.Tensor:
    """The bf16 forward on the template's bf16 instance (`mbconv_bf16.cu`)
    whatever the shape: the ablation timed beside the Hopper kernel."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 instance takes bf16 x, got {x.dtype}")
    return _fwd(x, fb, act_type, residual, None, False, instance=True)


def mbconv_dx_cuda(x: torch.Tensor, g: torch.Tensor, fb: FoldedBlock, *,
                   act_type: str, residual: bool,
                   masks_out: torch.Tensor | None = None) -> torch.Tensor:
    """`ops/mbconv.mbconv_dx_plain` as one op call: dx [B, H, W, C] in x's
    dtype. Given `masks_out` (uint8 [2, B, H, W, E], relu6 / relu), the masks
    instance also writes act'(z0) != 0 and act'(z1) != 0 into it; the main
    path passes none. bf16 runs the Hopper kernel where `sm90_dx_supported`
    takes the shape (it writes the masks too), the template's bf16 instance
    elsewhere."""
    return _dx(x, g, fb, act_type, residual, masks_out, None, False)


def mbconv_dx_bf16_instance(x: torch.Tensor, g: torch.Tensor, fb: FoldedBlock, *,
                            act_type: str, residual: bool,
                            masks_out: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 input gradient on the template's bf16 instance
    (`mbconv_bf16_dx.cu`) whatever the shape: the ablation timed beside the
    Hopper kernel."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 instance takes bf16 x, got {x.dtype}")
    return _dx(x, g, fb, act_type, residual, masks_out, None, False, instance=True)


def mbconv_fwd_simt(x: torch.Tensor, fb: FoldedBlock, *, act_type: str,
                    residual: bool) -> torch.Tensor:
    """The forward's ablation (SIMT 1x1 products, float32), on the main
    kernel's plan."""
    return _fwd(x, fb, act_type, residual, None, True)


def mbconv_dx_simt(x: torch.Tensor, g: torch.Tensor, fb: FoldedBlock, *,
                   act_type: str, residual: bool) -> torch.Tensor:
    """dx's ablation (SIMT 1x1 products, float32), on the main kernel's plan."""
    return _dx(x, g, fb, act_type, residual, None, None, True)
