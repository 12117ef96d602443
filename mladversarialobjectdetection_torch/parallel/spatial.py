"""Spatial partitioning: each image's rows split over the 'spatial' mesh axis.

The port's counterpart of the row-sharded images of JAX's ('data',
'spatial') meshes (`mladversarialobjectdetection_tpu/parallel/mesh.py:
109-158`), where GSPMD turns every conv into per-shard convs and a halo
exchange. Here the exchange is explicit: under an active mesh
(`parallel.use_mesh`) whose 'spatial' axis is larger than 1, in a process
group, the ranks of one spatial group hold one image's rows, and the ops
that read across rows fetch the rows they need from their neighbours.

**The layout rule** (`is_sharded`). A tensor of global height H is
*row-sharded* over the n ranks of the spatial group where n divides H and
every shard holds at least `MAX_HALO` rows (the largest halo an op reading
it needs: 2 rows for a k5 depthwise conv); rank i holds rows [i H / n,
(i + 1) H / n). Otherwise it is *replicated*: every rank of the group holds
all of it. The layout follows from the global height alone, which the
modules know from the net's static shapes (a replicated 10-row level and a
10-row shard of a 20-row level look the same).

**The primitives**, each differentiable, over gloo (card tensors staged
through the host, as `mesh._transport` does) or NCCL:

- `rows(x, lo, hi, fill)`: the global rows [lo, hi) of a sharded tensor;
  rows of other shards come from their owners (`dist.batch_isend_irecv`
  in the spatial group), `fill` stands beyond the image's edges only.
  Backward: each fetched row's gradient goes back to its owner, which adds
  it in.
- `gather_rows(x)`: sharded (or split in uneven counts) to replicated, an
  all-gather in spatial order. Backward: the sum over the group, then this
  rank's rows.
- `local_rows(x)`: replicated to sharded, a slice (autograd's backward of a
  slice places the gradient into zeros).

**Random draws** (`draw_rows`) are made at the global batch's and the
global height's shape from the replicated generator, and each rank keeps its
rows of both, so the ranks draw what one process draws.

**The gradient rule.** On a replicated tensor each rank holds a partial
gradient and the true one is their sum over the spatial group. So a loss
computed on replicated values (after `gather_rows`) counts once in the
group (`count_once`), parameter gradients are summed over data x spatial
(`mesh.all_reduce_grads`), and batch statistics reduce over data x spatial
for a sharded tensor and over the data axes for a replicated one
(`stats_axes`). Without an active spatial group every helper is the
identity, and the nets run as in one process.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import mesh as mesh_lib

MAX_HALO = 2  # rows: a k5 depthwise conv's halo, the largest on the victim


class SpatialGroup(NamedTuple):
    """The active mesh's spatial group as this rank sees it."""
    group: Any      # the process group of this rank's spatial ranks
    size: int       # n: ranks a row-sharded tensor is split over
    index: int      # this rank's position along 'spatial'
    ranks: tuple    # the group's global ranks in spatial order


def active() -> Optional[SpatialGroup]:
    """The spatial group of the active mesh, or None: no active mesh, a
    'spatial' axis of 1, or no process group (every collective the
    identity, the nets unpartitioned)."""
    mesh = mesh_lib.current_mesh()
    if mesh is None or mesh.shape.get(mesh_lib.SPATIAL_AXIS, 1) <= 1:
        return None
    sp = getattr(mesh, "_spatial_group", None)  # the mesh's, found once
    if sp is None:
        g = mesh_lib.axis_group(mesh_lib.SPATIAL_AXIS)
        if g is None:
            return None
        ranks = tuple(sorted(dist.get_process_group_ranks(g.group),
                             key=lambda r: mesh.axis_index(mesh_lib.SPATIAL_AXIS, r)))
        sp = mesh._spatial_group = SpatialGroup(g.group, g.size, g.index, ranks)
    return sp


def is_sharded(height: int, n_spatial: int) -> bool:
    """The layout rule: whether a tensor of global `height` is row-sharded
    over `n_spatial` ranks (else replicated over them)."""
    return (n_spatial > 1 and height % n_spatial == 0
            and height // n_spatial >= MAX_HALO)


def sharded(height: Optional[int]) -> bool:
    """`is_sharded` under the active spatial group (False without one, or
    for a tensor of unknown height)."""
    sp = active()
    return sp is not None and height is not None and is_sharded(height, sp.size)


def span(height: int, n: int, i: int) -> Tuple[int, int]:
    """Rank i's rows [lo, hi) of `height` rows split as evenly as they go."""
    return i * height // n, (i + 1) * height // n


def check_rows(x: torch.Tensor, height: int, dim: int = 2) -> None:
    """Raise unless x holds what the layout gives this rank of a tensor of
    global `height`: its shard when sharded, all of it when replicated."""
    sp = active()
    if sp is None:
        return
    want = height // sp.size if is_sharded(height, sp.size) else height
    if x.shape[dim] != want:
        raise ValueError(
            f"under a spatial mesh of {sp.size} a tensor of global height "
            f"{height} is held as {want} rows a rank, got {x.shape[dim]}")


def count_once(loss: torch.Tensor) -> torch.Tensor:
    """`loss` on the spatial group's first rank and 0 (with its graph, so the
    backward's collectives still run) on the others: a loss every rank of
    the group computes alike on replicated values counts once."""
    sp = active()
    return loss if sp is None or sp.index == 0 else loss * 0.0


def reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the active spatial group, without gradient (the
    parts of a sum each rank of the group holds one of); t itself without
    one."""
    if active() is None:
        return t
    return mesh_lib.reduce_sum(t, mesh_lib.SPATIAL_AXIS)


def draw_rows(draw: Callable[[int, int], torch.Tensor], b: int,
              height: int, dim: int = 2) -> torch.Tensor:
    """`draw(n, h)` makes a random tensor of n rows along dim 0 and h along
    `dim`; returns this rank's b rows of the global batch's draw
    (`mesh.draw_rows`) at the global `height`, cut to this rank's rows of
    that height where the layout shards it: the ranks of a replicated
    generator draw what one process draws."""
    out = mesh_lib.draw_rows(lambda n: draw(n, height), b)
    if not sharded(height):
        return out
    sp = active()
    h = height // sp.size
    return out.narrow(dim, sp.index * h, h)


def stats_axes(axis_name, height: Optional[int]):
    """The mesh axes a batch statistic of a tensor of global `height`
    reduces over: `axis_name` (None: the data axes) with 'spatial' added
    where the tensor is row-sharded."""
    if not sharded(height):
        return axis_name
    mesh = mesh_lib.current_mesh()
    if axis_name is None:
        base = mesh_lib.data_axis_names(mesh)
    else:
        base = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return base + (mesh_lib.SPATIAL_AXIS,)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of t on the device the group's backend takes."""
    out = mesh_lib._transport(t.contiguous(), group)
    return out.clone() if out is t else out


def _exchange(group, ranks, sends, recvs, like: torch.Tensor) -> list:
    """Point-to-point in the spatial group: `sends` [(j, tensor)] go to
    spatial rank j; `recvs` [(j, shape)] come from spatial rank j. Returns
    the received tensors on like's device, in the order of `recvs`."""
    ops, bufs = [], []
    for j, t in sends:
        ops.append(dist.P2POp(dist.isend, _staged(t, group), ranks[j], group))
    staging = mesh_lib._transport(like.new_empty(0), group).device
    for j, shape in recvs:
        buf = torch.empty(shape, dtype=like.dtype, device=staging)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[j], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(like.device) for b in bufs]


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    return max(a[0], b[0]), min(a[1], b[1])


class _Rows(torch.autograd.Function):
    """Forward: this rank's span of global rows of a row-sharded x, the rows
    of other shards fetched from their owners, `fill` beyond the edges.
    Backward: the fetched rows' gradients sent back and added in."""

    @staticmethod
    def forward(ctx, x, spans, fill, dim, sp):
        n, i, h = sp.size, sp.index, x.shape[dim]
        own = (i * h, (i + 1) * h)
        lo, hi = spans[i]
        shape = list(x.shape)
        shape[dim] = hi - lo
        out = x.new_full(shape, fill)
        a, b = _overlap((lo, hi), own)
        if a < b:
            out.narrow(dim, a - lo, b - a).copy_(x.narrow(dim, a - own[0], b - a))
        sends, recvs, placed = [], [], []
        for j in range(n):
            if j == i:
                continue
            c, d = _overlap(spans[j], own)  # my rows rank j reads
            if c < d:
                sends.append((j, x.narrow(dim, c - own[0], d - c)))
            c, d = _overlap((lo, hi), (j * h, (j + 1) * h))  # rank j's rows I read
            if c < d:
                rshape = list(x.shape)
                rshape[dim] = d - c
                recvs.append((j, rshape))
                placed.append((c, d))
        for (c, d), t in zip(placed, _exchange(sp.group, sp.ranks, sends, recvs, x)):
            out.narrow(dim, c - lo, d - c).copy_(t)
        ctx.meta = (spans, dim, sp, h)
        return out

    @staticmethod
    def backward(ctx, g):
        spans, dim, sp, h = ctx.meta
        n, i = sp.size, sp.index
        own = (i * h, (i + 1) * h)
        lo, hi = spans[i]
        shape = list(g.shape)
        shape[dim] = h
        gx = g.new_zeros(shape)
        a, b = _overlap((lo, hi), own)
        if a < b:
            gx.narrow(dim, a - own[0], b - a).add_(g.narrow(dim, a - lo, b - a))
        sends, recvs, placed = [], [], []
        for j in range(n):
            if j == i:
                continue
            c, d = _overlap((lo, hi), (j * h, (j + 1) * h))  # back to their owner
            if c < d:
                sends.append((j, g.narrow(dim, c - lo, d - c)))
            c, d = _overlap(spans[j], own)  # my rows rank j read
            if c < d:
                rshape = list(g.shape)
                rshape[dim] = d - c
                recvs.append((j, rshape))
                placed.append((c, d))
        for (c, d), t in zip(placed, _exchange(sp.group, sp.ranks, sends, recvs, g)):
            gx.narrow(dim, c - own[0], d - c).add_(t)
        return gx, None, None, None, None


def rows(x: torch.Tensor, lo, hi, fill: float = 0.0, dim: int = 2) -> torch.Tensor:
    """The global rows [lo, hi) of the row-sharded x (this rank's shard
    along `dim`), with `fill` beyond the image's edges (rows < 0 or >=
    H). `lo` and `hi` are this rank's (every rank then reads the same
    offsets from its own shard) or sequences indexed by spatial rank (every
    rank passes the same). x itself where each rank reads its own shard."""
    sp = active()
    if sp is None:
        raise RuntimeError("rows() needs an active spatial group")
    h, n, i = x.shape[dim], sp.size, sp.index
    if isinstance(lo, int):
        spans = [(lo + (j - i) * h, hi + (j - i) * h) for j in range(n)]
    else:
        spans = [(int(a), int(b)) for a, b in zip(lo, hi)]
    if all(s == (j * h, (j + 1) * h) for j, s in enumerate(spans)):
        return x
    return _Rows.apply(x, spans, float(fill), dim, sp)


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows concatenated in spatial order (`counts`
    rows a rank). Backward: the gradients summed over the group, then this
    rank's rows."""

    @staticmethod
    def forward(ctx, x, counts, dim, sp):
        top = max(counts)
        src = x
        if x.shape[dim] < top:
            pad = [0, 0] * (x.dim() - dim - 1) + [0, top - x.shape[dim]]
            src = F.pad(x, pad)
        src = mesh_lib._transport(src.contiguous(), sp.group)
        parts = [torch.empty_like(src) for _ in range(sp.size)]
        dist.all_gather(parts, src, group=sp.group)
        ranks = dist.get_process_group_ranks(sp.group)
        by_rank = dict(zip(ranks, parts))
        out = torch.cat([by_rank[r].narrow(dim, 0, c)
                         for r, c in zip(sp.ranks, counts)], dim=dim)
        ctx.meta = (counts, dim, sp)
        return out.to(x.device)

    @staticmethod
    def backward(ctx, g):
        counts, dim, sp = ctx.meta
        total = mesh_lib._sum(g.contiguous(), sp.group)
        start = sum(counts[:sp.index])
        return total.narrow(dim, start, counts[sp.index]).contiguous(), None, None, None


def gather_rows(x: torch.Tensor, dim: int = 2,
                counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's rows of x along `dim` in spatial order: a sharded tensor
    made replicated (`counts`: the rows each spatial rank holds, where they
    differ). x itself without an active spatial group."""
    sp = active()
    if sp is None:
        return x
    counts = [x.shape[dim]] * sp.size if counts is None else [int(c) for c in counts]
    return _GatherRows.apply(x, counts, dim, sp)


def _slice_rows(x: torch.Tensor, lo: int, hi: int, fill: float,
                dim: int) -> torch.Tensor:
    """Rows [lo, hi) of x, `fill` beyond its edges (a slice: its backward
    places the gradient into zeros)."""
    height = x.shape[dim]
    a, b = max(lo, 0), min(hi, height)
    out = x if (a, b) == (0, height) else x.narrow(dim, a, max(b - a, 0))
    if a > lo or b < hi:
        pad = [0, 0] * (x.dim() - dim - 1) + [a - lo, hi - b]
        out = F.pad(out, pad, value=fill)
    return out


def local_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's shard of the replicated x: replicated to sharded. x
    itself without an active spatial group."""
    sp = active()
    if sp is None:
        return x
    lo, hi = span(x.shape[dim], sp.size, sp.index)
    return _slice_rows(x, lo, hi, 0.0, dim)


def whole(x: torch.Tensor, height: int, dim: int = 2) -> torch.Tensor:
    """A tensor of global `height` made replicated: gathered where the layout
    shards it, as it is otherwise."""
    return gather_rows(x, dim) if sharded(height) else x


# ---------------------------------------------------------------------------
# ops over rows
# ---------------------------------------------------------------------------

def window(x: torch.Tensor, height: int, out_height: int,
           need: Callable[[int, int], Tuple[int, int]],
           op: Callable[[torch.Tensor, int, int, int], torch.Tensor],
           *, fill: float = 0.0, dim: int = 2) -> torch.Tensor:
    """Run a row-reading op under the active spatial group: x of global
    `height` (in its layout) -> y of global `out_height` (in its layout).

    Each rank computes its output rows [o_lo, o_hi): its shard where y is
    sharded; where y is replicated but x sharded, an even split of y's rows,
    gathered after. `need(o_lo, o_hi)` gives the global input rows [lo, hi)
    those output rows read; `op(xe, o_lo, o_hi, lo)` computes them from
    xe, those input rows (`fill` beyond the edges). Where both are
    replicated, `op(x with `fill` rows around it, 0, out_height, lo)` runs
    whole."""
    sp = active()
    n, i = sp.size, sp.index
    in_sh, out_sh = is_sharded(height, n), is_sharded(out_height, n)
    if not in_sh and not out_sh:
        lo, hi = need(0, out_height)
        return op(_slice_rows(x, lo, hi, fill, dim), 0, out_height, lo)
    spans = [span(out_height, n, j) for j in range(n)]
    needs = [need(*s) for s in spans]
    lo, hi = needs[i]
    if in_sh:
        xe = rows(x, [a for a, _ in needs], [b for _, b in needs], fill, dim)
    else:
        xe = _slice_rows(x, lo, hi, fill, dim)
    y = op(xe, *spans[i], lo)
    if not out_sh:
        y = gather_rows(y, dim, [b - a for a, b in spans])
    return y


def same_window(x: torch.Tensor, height: int, kernel: int, stride: int, top: int,
                op: Callable[[torch.Tensor], torch.Tensor], *,
                fill: float = 0.0, dim: int = 2) -> torch.Tensor:
    """`window` for a SAME-padded op of `kernel` rows at `stride` whose row
    padding puts `top` rows above the image (a conv, a max pool): `op(xe)`
    computes the output rows of xe, its input rows with the row padding in
    place (it pads no row itself)."""
    out_height = -(-height // stride)
    need = lambda o_lo, o_hi: (o_lo * stride - top, (o_hi - 1) * stride - top + kernel)
    return window(x, height, out_height, need, lambda xe, *_: op(xe),
                  fill=fill, dim=dim)


def halo_rows(x: torch.Tensor, height: Optional[int], halo: int,
              op: Callable[[torch.Tensor], torch.Tensor], *,
              dim: int = 2) -> torch.Tensor:
    """A stride-1 op that reads `halo` rows on each side and pads its own
    input's edges with zeros (a 3x3 SAME conv kernel), under the active
    spatial group: where x (global height `height`) is row-sharded, op runs
    on x extended by `halo` rows from each neighbour (zeros beyond the
    image's edges) and its output loses `halo` rows at each side, so only
    the dropped rows read the op's own padding. `op(x)` otherwise."""
    if not sharded(height):
        return op(x)
    sp = active()
    h = x.shape[dim]
    xe = rows(x, sp.index * h - halo, (sp.index + 1) * h + halo, 0.0, dim)
    return op(xe).narrow(dim, halo, h)
