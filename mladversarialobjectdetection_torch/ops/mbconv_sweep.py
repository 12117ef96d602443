"""Time every plan of the Hopper bf16 MBConv forward and fit the planner's cost model.

    python3 -m mladversarialobjectdetection_torch.ops.mbconv_sweep [--out sweep.json]

On one CUDA card: for lite4@640's 7 fused block shapes at batch 1 and 24
(seeded random weights), every instance of `csrc/mbconv_fwd_sm90.cu` that
fits the shape (`mbconv_cuda.SM90_CONFIGS`) at each split of E the
planner weighs (`SM90_SPLITS`) is timed by CUDA events; then the constants of
`mbconv_cuda._sm90_cost_us` are fitted to those times (non-negative least
squares on the relative error, with a grid over the factor of two blocks
a SM) and printed with the card's name and power limit,
beside each shape's fastest plan and the one the planner picks. The
planner's constants come from this script's fit.
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


def _case(dev, b, h, w, c, e, co, k, seed):
    g = torch.Generator(dev).manual_seed(seed)
    r = lambda *shape, s=1.0: torch.randn(shape, generator=g, device=dev) * s
    fb = FoldedBlock(we=r(c, e, s=2 / c ** 0.5), be=r(e, s=0.5), wd=r(k, k, e, s=2 / k),
                     bd=r(e, s=0.5), wp=r(e, co, s=2 / e ** 0.5), bp=r(co, s=0.5))
    return r(b, h, w, c).bfloat16(), fb.in_dtype(torch.bfloat16)


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


def sweep(dev) -> list:
    """[(shape (B, H, W, C, E, Co, k), instance, split, ms)] of every plan
    that fits."""
    rows = []
    for j, (h, w, c, e, co, k, res) in enumerate(LITE4_FUSED):
        x, fb = _case(dev, max(SWEEP_BATCHES), h, w, c, e, co, k, seed=100 + j)
        for b in SWEEP_BATCHES:
            xb = x[:b].contiguous()
            for p in mc.sm90_plans(h, w, c, e, co, k, b):
                ms = _ms(lambda: mc._launch_sm90(xb, fb, e, co, k, "relu6", res, p))
                rows.append(((b, h, w, c, e, co, k), tuple(p[:7]), p.split, ms))
    return rows


def fit(rows):
    """The cost model's constants (block_us, chunk_us, us_per_tensor_mflop,
    us_per_fp_mflop, us_per_reduce_mb, two_blocks) that fit the times best,
    and the mean and largest relative error."""
    from scipy.optimize import nnls

    feats = [(mc._sm90_terms(cfg, *shape, split), ms * 1e3)
             for shape, cfg, split, ms in rows]
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
    ap.add_argument("--out", default=None, help="write the timed plans here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mbconv_sweep: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows = sweep(torch.device("cuda"))
    consts, mean_err, max_err = fit(rows)
    names = ("block_us", "chunk_us", "us_per_tensor_mflop", "us_per_fp_mflop",
             "us_per_reduce_mb", "two_blocks")
    print(f"{card}: {len(rows)} plans timed; fitted constants "
          + ", ".join(f"{n} {v:.4f}" for n, v in zip(names, consts))
          + f"; relative error mean {mean_err:.3f}, largest {max_err:.3f}")
    for shape in sorted({r[0] for r in rows}):
        mine = sorted((ms, cfg, split) for s, cfg, split, ms in rows if s == shape)
        pick = mc.plan_fwd_sm90(*shape[1:], shape[0])
        picked = [ms for ms, cfg, split in mine if cfg == tuple(pick[:7]) and split == pick.split]
        print(f"  b{shape[0]} {shape[1]}x{shape[2]} C{shape[3]} E{shape[4]} Co{shape[5]} "
              f"k{shape[6]}: fastest {mine[0][0]:.4f} ms {mine[0][1]} split {mine[0][2]}; the "
              f"planner's {pick[:7]} split {pick.split}: "
              f"{picked[0] if picked else float('nan'):.4f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "constants": dict(zip(names, consts)),
                       "rows": rows}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
