"""Fused frozen (eval-mode) MBConv block: BN fold, plain versions, autograd.

Port of `tools/experiments/fused_mbconv.py` (`fold_block_params`,
`mbconv_eval_xla`, `mbconv_eval` with its `custom_vjp`, `fuseable`), whose
Pallas kernels `_fwd_kernel` and `_bwd_kernel` are the CUDA kernels of
`csrc/mbconv.cu` (`ops/mbconv_cuda.py`). One block in eval mode:

    e = act(BN0(x . We));  d = act(BN1(dwconv_k(e)));  y = BN2(d . Wp) [+ x]

With frozen BatchNorm statistics each BN is an affine map folded into its
conv (`fold_bn`), which gives `FoldedBlock`. x and y are NHWC, the TPU
kernel's layout.

- `mbconv_plain` / `mbconv_dx_plain`: the forward and the input gradient in
  plain PyTorch, with the kernels' structure (the dx version recomputes e
  and z1, then applies the transposes). They run on any device. The dx
  version sums z0 = x . We + be (C ascending, then be) and the depthwise
  pre-activation z1 (bd, then the taps row by row) with a separate multiply
  and add. Its relu6 / relu masks act'(z0), act'(z1) decide whole terms of
  dx: an element within rounding of a kink whose mask flips moves dx by a
  term, not by a rounding. The CUDA kernels sum z0 on the tensor cores
  (3xTF32, another order), so their masks can differ from these at such
  elements: `mbconv_dx_plain(masks=...)` takes a kernel's own masks, and
  `kink_flips` bounds where the two differ. The forward has no such mask
  (act is continuous), so its expand is one matmul, which keeps the CPU
  path as fast as the unfused blocks.
- bf16: a `FoldedBlock` holds We and Wp in its compute dtype
  (`FoldedBlock.in_dtype`; `MBConvBlock.folded(dtype)` caches one per
  dtype), the rest in float32, and x comes in that dtype. Given bf16, each
  function computes the Pallas kernels' bf16 instance (`_fwd_kernel` /
  `_bwd_kernel` with bf16 inputs, fused_mbconv.py:212-242, :282-339): every
  product of two bf16 values summed in float32 (exact products, as
  `preferred_element_type=f32` takes them), the biases and wd in float32,
  and a rounding to bf16 at the kernels' points: e after the activation, d,
  and the output once (the residual added in float32 before it); in dx, g
  on entry, gd = (g . Wp^T) act'(z1) and ge act'(z0). The relu masks come
  from the float32 z0 and z1. `rounding_bound` holds a kernel's bf16
  forward to where those roundings may go, `dx_rounding_bound` its input
  gradient.
- `FusedMBConv` / `mbconv`: the op. Forward: the custom op
  `mlad::mbconv_fwd` (`ops/library.py`, which `torch.export` traces): the
  CUDA kernel for CUDA tensors (which launches or raises), the plain
  version for CPU tensors; without autograd `mbconv` calls it alone.
  Backward: the dx kernel or `mbconv_dx_plain`; it saves x and the folded
  weights, no activation. A gradient for the folded weights is refused with
  an error, as the JAX op refuses one: never silently zero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

SUPPORTED_ACTS = ("relu6", "relu", "swish", "silu", "swish_native")
LAYOUT_COPIES = 0  # NHWC copies the fused blocks made of inputs or gradients


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class FoldedBlock(NamedTuple):
    """BN-folded weights of one MBConv block: We and Wp in the compute
    dtype (the products' operands), the rest float32."""
    we: torch.Tensor  # [C, E]
    be: torch.Tensor  # [E]
    wd: torch.Tensor  # [k, k, E]
    bd: torch.Tensor  # [E]
    wp: torch.Tensor  # [E, Co]
    bp: torch.Tensor  # [Co]

    @property
    def dtype(self) -> torch.dtype:
        return self.we.dtype

    def in_dtype(self, dtype: torch.dtype) -> "FoldedBlock":
        """This fold with We and Wp in `dtype`, rounded to nearest even
        (fused_mbconv.py:261, :380)."""
        if dtype not in COMPUTE_DTYPES:
            raise TypeError(f"fused MBConv: no {dtype} instance (float32 or bfloat16)")
        if dtype == self.dtype:
            return self
        return self._replace(we=self.we.to(dtype).contiguous(),
                             wp=self.wp.to(dtype).contiguous())


def fold_bn(scale, bias, mean, var, eps: float):
    """(s, b) with BN(z) = z * s + b: s = scale * rsqrt(var + eps), b = bias
    - mean * s (fused_mbconv.py:79-81)."""
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def fold_block(block) -> FoldedBlock:
    """Fold the three BatchNorms of a port `models.efficientnet.MBConvBlock`
    into its convs (fused_mbconv.py:84-104); the convs hold OIHW weights."""
    s0, b0 = fold_bn(block.bn0.weight, block.bn0.bias, block.bn0.running_mean,
                     block.bn0.running_var, block.bn0.eps)
    s1, b1 = fold_bn(block.bn1.weight, block.bn1.bias, block.bn1.running_mean,
                     block.bn1.running_var, block.bn1.eps)
    s2, b2 = fold_bn(block.bn2.weight, block.bn2.bias, block.bn2.running_mean,
                     block.bn2.running_var, block.bn2.eps)
    we = block.expand_conv.weight[:, :, 0, 0].t() * s0[None, :]
    wd = block.depthwise_conv.weight[:, 0].permute(1, 2, 0) * s1[None, None, :]
    wp = block.project_conv.weight[:, :, 0, 0].t() * s2[None, :]
    return FoldedBlock(*(t.contiguous() for t in (we, b0, wd, b1, wp, b2)))


def fuseable(args, use_se: bool, act_type: str) -> bool:
    """Can this block take the fused path? (fused_mbconv.py:436-441)"""
    return (args.expand_ratio != 1 and tuple(args.strides) == (1, 1)
            and not (use_se and args.se_ratio) and act_type in SUPPORTED_ACTS)


def act(z: torch.Tensor, act_type: str) -> torch.Tensor:
    if act_type == "relu6":
        return torch.clamp(z, 0.0, 6.0)
    if act_type == "relu":
        return torch.clamp_min(z, 0.0)
    if act_type in ("swish", "silu", "swish_native"):
        return z * torch.sigmoid(z)
    raise ValueError(f"fused MBConv: unsupported act {act_type}")


def dact(z: torch.Tensor, act_type: str) -> torch.Tensor:
    """d act / d z, from the pre-activation z."""
    if act_type == "relu6":
        return ((z > 0.0) & (z < 6.0)).to(z.dtype)
    if act_type == "relu":
        return (z > 0.0).to(z.dtype)
    if act_type in ("swish", "silu", "swish_native"):
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    raise ValueError(f"fused MBConv: unsupported act {act_type}")


def _operands(x: torch.Tensor, fb: FoldedBlock):
    """(x, fb, rnd) in float32: for bf16, x and the fold's bf16 We and Wp as
    float32 values, and `rnd` the rounding of a float32 intermediate to bf16
    (kept as float32); for float32, as given and no rounding."""
    if x.dtype != fb.dtype:
        raise TypeError(f"fused MBConv: x in {x.dtype}, We and Wp in {fb.dtype}; "
                        f"fold in x's dtype (FoldedBlock.in_dtype)")
    if x.dtype == torch.float32:
        return x, fb, lambda t: t
    f32, cd = torch.float32, x.dtype
    return (x.to(f32), fb._replace(we=fb.we.to(f32), wp=fb.wp.to(f32)),
            lambda t: t.to(cd).to(f32))


def expand_z0(x: torch.Tensor, fb: FoldedBlock) -> torch.Tensor:
    """z0 = x . We + be over C in ascending order, multiply and add apart
    (float32)."""
    x, fb, _ = _operands(x, fb)
    z = torch.zeros((*x.shape[:-1], fb.we.shape[1]), dtype=x.dtype,
                    device=x.device)
    for c in range(x.shape[-1]):
        z += x[..., c:c + 1] * fb.we[c]
    return z + fb.be


def depthwise_z1(e: torch.Tensor, fb: FoldedBlock) -> torch.Tensor:
    """z1 = bd + the k x k SAME depthwise of e (zero-padded), taps row by
    row, in float32."""
    e = e.to(torch.float32)
    k = fb.wd.shape[0]
    h = k // 2
    height, width = e.shape[1], e.shape[2]
    ep = F.pad(e, (0, 0, h, h, h, h))
    z = torch.zeros_like(e) + fb.bd
    for i in range(k):
        for j in range(k):
            z += ep[:, i:i + height, j:j + width, :] * fb.wd[i, j]
    return z


def _plain_f32(x, fb, act_type, residual):
    """The forward in float32, before the output's rounding to x's dtype."""
    x, fb, rnd = _operands(x, fb)
    e = rnd(act(torch.matmul(x, fb.we) + fb.be, act_type))
    d = rnd(act(depthwise_z1(e, fb), act_type))
    y = torch.matmul(d, fb.wp) + fb.bp
    return y + x if residual else y


def mbconv_plain(x: torch.Tensor, fb: FoldedBlock, *, act_type: str,
                 residual: bool) -> torch.Tensor:
    """x [B, H, W, C] -> y [B, H, W, Co] in x's dtype (as `mbconv_eval_xla`
    in fp32; as the Pallas forward kernel in bf16)."""
    return _plain_f32(x, fb, act_type, residual).to(x.dtype)


class RoundingBound(NamedTuple):
    """A bf16 kernel forward held to the bf16 function's roundings."""
    flips: int    # outputs that differ from `mbconv_plain`'s
    outside: int  # outputs no choice of those roundings reaches: faults
    e_near: int   # e within the sums' float32 error of a bf16 boundary
    d_near: int   # d likewise
    y_open: int   # outputs whose interval holds more than one bf16 value


F32_ULP = 2.0 ** -23  # float32 spacing at 1: an add that rounds or truncates


def _sum_slack(n_terms: int, abs_sum: torch.Tensor) -> torch.Tensor:
    """How far two float32 sums of the same n_terms terms, in any order and
    with adds that round or truncate, can lie apart: (n + 1) ulps of the sum
    of |terms| each."""
    return 2.0 * (n_terms + 1) * F32_ULP * abs_sum


def _act_interval(z: torch.Tensor, rad: torch.Tensor, act_type: str):
    """(lo, hi) holding act over [z - rad, z + rad]: the clamps are monotone;
    swish's slope is at most 1.1 in magnitude, and the kernel's `expf` form
    may differ from `torch.sigmoid`'s by a few float32 ulps (2^-18 of the
    value allowed)."""
    if act_type in ("relu6", "relu"):
        return act(z - rad, act_type), act(z + rad, act_type)
    a = act(z, act_type)
    r = 1.1 * rad + 2.0 ** -18 * a.abs() + 1e-30
    return a - r, a + r


def _mid_rad(lo: torch.Tensor, hi: torch.Tensor):
    """(midpoint, radius, largest magnitude) of [lo, hi] (bf16 values in
    float32: exact)."""
    return (lo + hi) / 2, (hi - lo) / 2, torch.maximum(lo.abs(), hi.abs())


def rounding_bound(y: torch.Tensor, x: torch.Tensor, fb: FoldedBlock, *,
                   act_type: str, residual: bool) -> RoundingBound:
    """Hold a bf16 kernel's forward y to the bf16 function of `mbconv_plain`.

    The kernel sums z0, z1 and y in float32 in another order (its 1x1 sums
    on the tensor cores), so an e or d whose float32 value lies within that
    sum's error of a bf16 rounding boundary may round the other way, and so
    may the output. Intervals carry every such choice downstream: z0 and z1
    within `_sum_slack` of the plain sums, act over them (`_act_interval`),
    e and d as the bf16 roundings of its ends, then y = d . Wp + bp (+ x)
    within its own slack. A kernel output outside [bf16(lo), bf16(hi)] is
    counted in `outside`: no rounding within float32 distance of a bf16
    boundary explains it."""
    xf, f, rnd = _operands(x, fb)
    c, (e, co), k = xf.shape[-1], f.wp.shape, f.wd.shape[0]
    pad = 1.0 + 2.0 ** -16  # the radii's own float32 rounding
    z0 = torch.matmul(xf, f.we) + f.be
    r0 = _sum_slack(c + 1, torch.matmul(xf.abs(), f.we.abs()) + f.be.abs())
    e_lo, e_hi = (rnd(a) for a in _act_interval(z0, r0 * pad, act_type))
    del z0, r0
    e_near = int((e_lo != e_hi).sum())
    e_mid, e_rad, e_abs = _mid_rad(e_lo, e_hi)
    del e_lo, e_hi
    fa = f._replace(wd=f.wd.abs(), bd=f.bd.abs())
    z1 = depthwise_z1(e_mid, f)
    r1 = (depthwise_z1(e_rad, fa._replace(bd=torch.zeros_like(f.bd)))
          + _sum_slack(k * k + 1, depthwise_z1(e_abs, fa)))
    del e_mid, e_rad, e_abs
    d_lo, d_hi = (rnd(a) for a in _act_interval(z1, r1 * pad, act_type))
    del z1, r1
    d_near = int((d_lo != d_hi).sum())
    d_mid, d_rad, d_abs = _mid_rad(d_lo, d_hi)
    del d_lo, d_hi
    y_mid = torch.matmul(d_mid, f.wp) + f.bp
    y_abs = torch.matmul(d_abs, f.wp.abs()) + f.bp.abs()
    if residual:
        y_mid, y_abs = y_mid + xf, y_abs + xf.abs()
    y_rad = (torch.matmul(d_rad, f.wp.abs()) + _sum_slack(e + 2, y_abs)) * pad
    del d_mid, d_rad, d_abs, y_abs
    lo, hi = rnd(y_mid - y_rad), rnd(y_mid + y_rad)
    del y_mid, y_rad
    yf = y.to(torch.float32)
    outside = int(((yf < lo) | (yf > hi)).sum())
    y_open = int((lo != hi).sum())
    del lo, hi, yf
    flips = int((y != _plain_f32(x, fb, act_type, residual).to(y.dtype)).sum())
    return RoundingBound(flips, outside, e_near, d_near, y_open)


def mbconv_dx_plain(x: torch.Tensor, g: torch.Tensor, fb: FoldedBlock, *,
                    act_type: str, residual: bool,
                    masks: torch.Tensor | None = None) -> torch.Tensor:
    """dL/dx from x [B, H, W, C] and g = dL/dy [B, H, W, Co]: recompute z0 and
    z1, then Wp^T, act'(z1), the depthwise transpose, act'(z0), We^T.

    `masks` [2, B, H, W, E] (0 / 1, any dtype; relu6 / relu) replaces
    act'(z0) and act'(z1): given a kernel's own masks, dx differs from the
    kernel's by rounding only, even where z0 or z1 lies within rounding of a
    kink and the two versions' masks differ (`kink_flips`). dx comes in x's
    dtype; a bf16 x rounds g to bf16 first."""
    cd = x.dtype
    x, fb, rnd = _operands(x, fb)
    g = rnd(g.to(torch.float32))
    k = fb.wd.shape[0]
    h = k // 2
    height, width = x.shape[1], x.shape[2]
    z0 = expand_z0(x, fb)
    if masks is None:
        dz0 = dact(z0, act_type)
        dz1 = dact(depthwise_z1(rnd(act(z0, act_type)), fb), act_type)
    else:
        if act_type not in ("relu6", "relu"):
            raise ValueError(f"masks replace the 0/1 act' of relu6 / relu, not {act_type}")
        dz0, dz1 = (m.to(x.dtype) for m in masks)
    gd = rnd(torch.matmul(g, fb.wp.t()) * dz1)
    gx = torch.matmul(rnd(depthwise_t(gd, fb.wd) * dz0), fb.we.t())
    return (gx + g if residual else gx).to(cd)


def depthwise_t(gd: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """The transpose of the k x k SAME depthwise on gd [B, H, W, E]: from
    zero, the taps row by row (ky, then kx ascending), multiply and add
    apart."""
    k = wd.shape[0]
    h = k // 2
    height, width = gd.shape[1], gd.shape[2]
    gp = F.pad(gd, (0, 0, h, h, h, h))
    ge = torch.zeros_like(gd)
    for i in range(k):
        for j in range(k):
            ge += (gp[:, 2 * h - i:2 * h - i + height, 2 * h - j:2 * h - j + width, :]
                   * wd[i, j])
    return ge


class DxRoundingBound(NamedTuple):
    """A bf16 kernel's input gradient held to the bf16 function's roundings."""
    flips: int    # elements of dx that differ from `mbconv_dx_plain`'s
    outside: int  # elements no choice of those roundings reaches: faults
    gd_near: int  # gd within the sums' float32 error of a bf16 boundary
    ge_near: int  # ge likewise
    dx_open: int  # elements of dx whose interval holds more than one bf16 value
    mask_faults: int  # given masks: those no z0 or z1 within the sums' error reaches


def _dact_interval(z: torch.Tensor, rad: torch.Tensor, act_type: str):
    """(mid, radius) holding act' over [z - rad, z + rad]: relu6 / relu's
    step is 1 inside (0, 6) / (0, inf), so the interval is [0, 1] where it
    straddles a kink; swish's derivative has slope at most 0.5 in magnitude
    (its `expf` form within 2^-18 of the value)."""
    if act_type in ("relu6", "relu"):
        top = 6.0 if act_type == "relu6" else float("inf")
        hi = ((z + rad > 0.0) & (z - rad < top)).to(z.dtype)
        lo = ((z - rad > 0.0) & (z + rad < top)).to(z.dtype)
        return (lo + hi) / 2, (hi - lo) / 2
    d = dact(z, act_type)
    return d, 0.5 * rad + 2.0 ** -18 * d.abs() + 1e-30


def _times(a, b):
    """(mid, radius) of the product of two intervals given as (mid, radius)."""
    return a[0] * b[0], a[0].abs() * b[1] + a[1] * b[0].abs() + a[1] * b[1]


def dx_rounding_bound(dx: torch.Tensor, x: torch.Tensor, g: torch.Tensor, fb: FoldedBlock, *,
                      act_type: str, residual: bool,
                      masks: torch.Tensor | None = None) -> DxRoundingBound:
    """Hold a bf16 kernel's input gradient dx to the bf16 function of
    `mbconv_dx_plain`, as `rounding_bound` holds a forward.

    The kernel sums z0, z1, g . Wp^T, the depthwise transpose and ge . We^T
    in float32 in other orders, so gd, ge and dx may round the other way
    where their float32 values lie within those sums' error of a bf16
    boundary. Intervals carry every such choice: z0 and z1 as in
    `rounding_bound`; act'(z0) and act'(z1) over them (`_dact_interval`),
    or exact from `masks` (a kernel's own relu6 / relu masks, each held to
    its interval first); gd = bf16((g .
    Wp^T) act'(z1)) and ge = bf16(dwconv^T(gd) act'(z0)) as the bf16
    roundings of their ends; dx = ge . We^T (+ g) within its slack. An
    element of dx outside [bf16(lo), bf16(hi)] is counted in `outside`, a
    given mask that differs from the plain version's where its z lies
    farther from the kink than the sums' error in `mask_faults`."""
    xf, f, rnd = _operands(x, fb)
    gf = rnd(g.to(torch.float32))
    c, (e, co), k = xf.shape[-1], f.wp.shape, f.wd.shape[0]
    pad = 1.0 + 2.0 ** -16  # the radii's own float32 rounding
    wa = f.wd.abs()
    z0 = torch.matmul(xf, f.we) + f.be
    r0 = _sum_slack(c + 1, torch.matmul(xf.abs(), f.we.abs()) + f.be.abs()) * pad
    e_lo, e_hi = (rnd(a) for a in _act_interval(z0, r0, act_type))
    dz0 = _dact_interval(z0, r0, act_type)
    del z0, r0
    e_mid, e_rad, e_abs = _mid_rad(e_lo, e_hi)
    del e_lo, e_hi
    fa = f._replace(wd=wa, bd=f.bd.abs())
    z1 = depthwise_z1(e_mid, f)
    r1 = (depthwise_z1(e_rad, fa._replace(bd=torch.zeros_like(f.bd)))
          + _sum_slack(k * k + 1, depthwise_z1(e_abs, fa))) * pad
    del e_mid, e_rad, e_abs
    dz1 = _dact_interval(z1, r1, act_type)
    del z1, r1
    mask_faults = 0
    if masks is not None:  # each mask within its interval, then exact
        zero = torch.zeros(masks.shape[1:], dtype=torch.float32, device=x.device)
        for m, (mid, rad) in zip(masks, (dz0, dz1)):
            m = m.to(torch.float32)
            mask_faults += int(((m < mid - rad) | (m > mid + rad)).sum())
        dz0, dz1 = (masks[0].to(torch.float32), zero), (masks[1].to(torch.float32), zero)
    gw = torch.matmul(gf, f.wp.t())
    gw = (gw, _sum_slack(co, torch.matmul(gf.abs(), f.wp.abs().t())) * pad)
    mid, rad = _times(gw, dz1)
    del gw, dz1
    gd_lo, gd_hi = rnd(mid - rad * pad), rnd(mid + rad * pad)
    gd_near = int((gd_lo != gd_hi).sum())
    gd_mid, gd_rad, gd_abs = _mid_rad(gd_lo, gd_hi)
    del gd_lo, gd_hi, mid, rad
    t = (depthwise_t(gd_mid, f.wd),
         (depthwise_t(gd_rad, wa) + _sum_slack(k * k, depthwise_t(gd_abs, wa))) * pad)
    del gd_mid, gd_rad, gd_abs
    mid, rad = _times(t, dz0)
    del t, dz0
    ge_lo, ge_hi = rnd(mid - rad * pad), rnd(mid + rad * pad)
    ge_near = int((ge_lo != ge_hi).sum())
    ge_mid, ge_rad, ge_abs = _mid_rad(ge_lo, ge_hi)
    del ge_lo, ge_hi, mid, rad
    dx_mid = torch.matmul(ge_mid, f.we.t())
    dx_abs = torch.matmul(ge_abs, f.we.abs().t())
    if residual:
        dx_mid, dx_abs = dx_mid + gf, dx_abs + gf.abs()
    dx_rad = (torch.matmul(ge_rad, f.we.abs().t()) + _sum_slack(e + 1, dx_abs)) * pad
    del ge_mid, ge_rad, ge_abs, dx_abs
    lo, hi = rnd(dx_mid - dx_rad), rnd(dx_mid + dx_rad)
    del dx_mid, dx_rad
    df = dx.to(torch.float32)
    outside = int(((df < lo) | (df > hi)).sum())
    dx_open = int((lo != hi).sum())
    del lo, hi, df
    plain = mbconv_dx_plain(x, g, fb, act_type=act_type, residual=residual, masks=masks)
    flips = int((dx != plain).sum())
    return DxRoundingBound(flips, outside, gd_near, ge_near, dx_open, mask_faults)


def dx_masks(x: torch.Tensor, fb: FoldedBlock, *, act_type: str):
    """(masks [2, B, H, W, E] uint8, z0, z1) of the plain dx: act'(z0) != 0
    and act'(z1) != 0 (relu6 / relu), with the float32 pre-activations they
    come from (z1 from the bf16 e, for a bf16 x)."""
    x, fb, rnd = _operands(x, fb)
    z0 = expand_z0(x, fb)
    z1 = depthwise_z1(rnd(act(z0, act_type)), fb)
    masks = torch.stack([dact(z0, act_type) != 0, dact(z1, act_type) != 0])
    return masks.to(torch.uint8), z0, z1


def kink_flips(masks: torch.Tensor, plain_masks: torch.Tensor, z0: torch.Tensor,
               z1: torch.Tensor, act_type: str):
    """Where a kernel's masks differ from the plain version's: (flips of
    act'(z0), flips of act'(z1), the largest distance of a flipped z from its
    nearest kink over max(1, max|z|)). A flip is rounding, not a fault, when
    that distance is a few float32 ulps."""
    kinks = (0.0, 6.0) if act_type == "relu6" else (0.0,)
    counts, worst = [], 0.0
    for m, pm, z in zip(masks, plain_masks, (z0, z1)):
        flip = m != pm
        counts.append(int(flip.sum()))
        if counts[-1]:
            dist = torch.stack([(z[flip] - kink).abs() for kink in kinks]).amin(0)
            worst = max(worst, float(dist.max()) / max(1.0, float(z.abs().max())))
    return counts[0], counts[1], worst


def _forward(x, fb: FoldedBlock, act_type: str, residual: bool):
    """The custom op `mlad::mbconv_fwd` (`ops/library.py`): the kernel for
    CUDA tensors, `mbconv_plain` for CPU tensors."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused MBConv for device {x.device}")
    from . import library
    return library.mbconv_fwd(x, *fb, act_type, residual)


def _dx(x, g, fb: FoldedBlock, act_type: str, residual: bool):
    if x.is_cuda:
        from . import mbconv_cuda
        return mbconv_cuda.mbconv_dx_cuda(x, g, fb, act_type=act_type, residual=residual)
    if x.device.type == "cpu":
        return mbconv_dx_plain(x, g, fb, act_type=act_type, residual=residual)
    raise ValueError(f"no fused MBConv for device {x.device}")


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """A contiguous NHWC tensor of t; copied (and counted) only where t's
    strides are not already NHWC-contiguous."""
    global LAYOUT_COPIES
    if not t.is_contiguous():
        LAYOUT_COPIES += 1
        t = t.contiguous()
    return t


class FusedMBConv(torch.autograd.Function):
    """Frozen MBConv whose forward and input gradient run the kernels, in
    x's dtype (the fold's: float32 or bf16)."""

    @staticmethod
    def forward(ctx, x, we, be, wd, bd, wp, bp, act_type, residual):
        fb = FoldedBlock(we, be, wd, bd, wp, bp)
        ctx.save_for_backward(x, *fb)
        ctx.act_type, ctx.residual = act_type, residual
        return _forward(x, fb, act_type, residual)

    @staticmethod
    def backward(ctx, g):
        if any(ctx.needs_input_grad[1:7]):
            raise RuntimeError(
                "fused MBConv: the folded weights are frozen and have no "
                "gradient; a block whose weights train cannot take this op")
        x, *weights = ctx.saved_tensors
        dx = _dx(x, nhwc(g), FoldedBlock(*weights), ctx.act_type, ctx.residual)
        return (dx,) + (None,) * 8


def mbconv(x: torch.Tensor, fb: FoldedBlock, *, act_type: str,
           residual: bool) -> torch.Tensor:
    """The frozen MBConv on x [B, H, W, C] (contiguous NHWC, in the fold's
    dtype: float32 or bf16), differentiable in x only (`mbconv_eval`,
    fused_mbconv.py:405-433)."""
    if act_type not in SUPPORTED_ACTS:
        raise ValueError(f"fused MBConv: unsupported act {act_type}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *fb)):
        return FusedMBConv.apply(x, *fb, act_type, residual)
    return _forward(x, fb, act_type, residual)  # no autograd: the op alone
