"""Time every plan of the Hopper bf16 MBConv kernels and fit the planners' cost models.

    python3 -m mladversarialobjectdetection_torch.ops.mbconv_sweep [--kind fwd|dx] [--out sweep.json]

On one CUDA card: for lite4@640's 7 fused block shapes at batch 1 and 24
(seeded random weights; for dx a seeded g), every instance of
`csrc/mbconv_fwd_sm90.cu` (kind fwd, `mbconv_cuda.SM90_CONFIGS`) or of
`csrc/mbconv_dx_sm90.cu` (kind dx, `DX_SM90_CONFIGS`) that fits the shape,
at each split of E the planner weighs (`SM90_SPLITS`), is timed by CUDA
events; then the constants of the kind's cost model (`SM90_COST` or
`DX_SM90_COST`) are fitted to those times (non-negative least squares on
the relative error, with a grid over the factor of two blocks a SM) and
printed with the card's name and power limit, beside each shape's fastest
plan and the one the planner picks. The planners' constants come from this
script's fit.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from . import mbconv_cuda as mc
from .mbconv import FoldedBlock

# (H, W, C, E, Co, k, residual) of lite4@640's 7 fused block shapes
LITE4_FUSED = [(160, 160, 32, 192, 32, 3, True), (80, 80, 56, 336, 56, 5, True),
               (40, 40, 112, 672, 112, 3, True), (40, 40, 112, 672, 160, 5, False),
               (40, 40, 160, 960, 160, 5, True), (20, 20, 272, 1632, 272, 5, True),
               (20, 20, 272, 1632, 448, 3, False)]
SWEEP_BATCHES = (1, 24)
LITE4_BLOCKS = (3, 3, 5, 1, 5, 7, 1)  # lite4's fused blocks of each shape (25 a pass)
# kind: (plans, the cost model's terms, the planner, its instances' length)
KINDS = {"fwd": (mc.sm90_plans, mc._sm90_terms, mc.plan_fwd_sm90, 7),
         "dx": (mc.sm90_dx_plans, mc._dx_sm90_terms, mc.plan_dx_sm90, 8)}


def _case(dev, b, h, w, c, e, co, k, seed):
    g = torch.Generator(dev).manual_seed(seed)
    r = lambda *shape, s=1.0: torch.randn(shape, generator=g, device=dev) * s
    fb = FoldedBlock(we=r(c, e, s=2 / c ** 0.5), be=r(e, s=0.5), wd=r(k, k, e, s=2 / k),
                     bd=r(e, s=0.5), wp=r(e, co, s=2 / e ** 0.5), bp=r(co, s=0.5))
    return r(b, h, w, c).bfloat16(), (r(b, h, w, co) * 0.1).bfloat16(), fb.in_dtype(torch.bfloat16)


def _ms(fn, iters=10, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def sweep(dev, kind: str = "fwd") -> list:
    """[(shape (B, H, W, C, E, Co, k), instance, split, ms)] of every plan
    of the kind that fits."""
    plans, _, _, n_cfg = KINDS[kind]
    rows = []
    for j, (h, w, c, e, co, k, res) in enumerate(LITE4_FUSED):
        x, g, fb = _case(dev, max(SWEEP_BATCHES), h, w, c, e, co, k, seed=100 + j)
        for b in SWEEP_BATCHES:
            xb, gb = x[:b].contiguous(), g[:b].contiguous()
            for p in plans(h, w, c, e, co, k, b):
                if kind == "fwd":
                    fn = lambda: mc._launch_sm90(xb, fb, e, co, k, "relu6", res, p)
                else:
                    fn = lambda: mc._launch_sm90_dx(xb, gb, fb, e, co, k, "relu6", res, p, None)
                rows.append(((b, h, w, c, e, co, k), tuple(p[:n_cfg]), p.split, _ms(fn)))
    return rows


def fit(rows, kind: str = "fwd"):
    """The cost model's constants (block_us, chunk_us, us_per_tensor_mflop,
    us_per_fp_mflop, us_per_reduce_mb, two_blocks) that fit the times best,
    and the mean and largest relative error."""
    from scipy.optimize import nnls

    terms = KINDS[kind][1]
    feats = [(terms(cfg, *shape, split), ms * 1e3) for shape, cfg, split, ms in rows]
    best = None
    for f2 in np.arange(1.0, 2.001, 0.05):
        a = np.array([np.array(mc._sm90_basis(t, f2)) / us for t, us in feats])
        coef, _ = nnls(a, np.ones(len(a)))
        err = np.abs(a @ coef - 1.0)
        if best is None or err.mean() < best[0]:
            best = (err.mean(), err.max(), (*coef, f2))
    return best[2], best[0], best[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=sorted(KINDS), default="fwd",
                    help="the forward (mbconv_fwd_sm90.cu) or the input gradient (mbconv_dx_sm90.cu)")
    ap.add_argument("--out", default=None, help="write the timed plans here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mbconv_sweep: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows = sweep(torch.device("cuda"), args.kind)
    consts, mean_err, max_err = fit(rows, args.kind)
    names = ("block_us", "chunk_us", "us_per_tensor_mflop", "us_per_fp_mflop",
             "us_per_reduce_mb", "two_blocks")
    print(f"{card}: {args.kind}, {len(rows)} plans timed; fitted constants "
          + ", ".join(f"{n} {v:.4f}" for n, v in zip(names, consts))
          + f"; relative error mean {mean_err:.3f}, largest {max_err:.3f}")
    planner, n_cfg = KINDS[args.kind][2], KINDS[args.kind][3]
    terms = KINDS[args.kind][1]
    fitted = lambda cfg, shape, split: sum(a * b for a, b in zip(
        mc._sm90_basis(terms(cfg, *shape, split), consts[5]), consts))
    per_pass = {"fastest": 0.0, "planner": 0.0, "fitted": 0.0}
    for shape in sorted({r[0] for r in rows}):
        mine = sorted((ms, cfg, split) for s, cfg, split, ms in rows if s == shape)
        pick = planner(*shape[1:], shape[0])
        picked = [ms for ms, cfg, split in mine
                  if cfg == tuple(pick[:n_cfg]) and split == pick.split]
        # the plan the planner would pick with the constants just fitted
        refit = min(mine, key=lambda m: fitted(m[1], shape, m[2]))
        print(f"  b{shape[0]} {shape[1]}x{shape[2]} C{shape[3]} E{shape[4]} Co{shape[5]} "
              f"k{shape[6]}: fastest {mine[0][0]:.4f} ms {mine[0][1]} split {mine[0][2]}; the "
              f"planner's {pick[:n_cfg]} split {pick.split}: "
              f"{picked[0] if picked else float('nan'):.4f} ms; with the fitted constants "
              f"{refit[1]} split {refit[2]}: {refit[0]:.4f} ms")
        if shape[0] == max(SWEEP_BATCHES):
            n = LITE4_BLOCKS[[s[:6] for s in LITE4_FUSED].index(shape[1:])]
            per_pass["fastest"] += n * mine[0][0]
            per_pass["planner"] += n * (picked[0] if picked else float("nan"))
            per_pass["fitted"] += n * refit[0]
    print(f"  a b{max(SWEEP_BATCHES)} pass of lite4's 25 fused blocks: the fastest plans "
          f"{per_pass['fastest']:.4f} ms, the planner's {per_pass['planner']:.4f}, with the "
          f"fitted constants {per_pass['fitted']:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kind": args.kind,
                       "constants": dict(zip(names, consts)), "rows": rows}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
