"""Meshes of ranks, batch placement and the collectives of data parallelism.

Port of `mladversarialobjectdetection_tpu/parallel/mesh.py` to
`torch.distributed`. JAX runs one program over a mesh of devices and XLA
inserts the collectives; the port runs one process per device, and the
steps call the collectives themselves (`all_reduce_sum`, `reduce_sum`,
`all_gather_rows`, `all_reduce_grads`, `draw_rows`). The JAX names keep
their meaning, with these differences from JAX's single controller:

- **A device is a rank** of the default process group: one card, or the
  CPU, per process. Every process takes part in every mesh, so a mesh holds
  all the ranks, and `make_mesh_for_batch` follows JAX's multi-host branch
  (mesh.py:98-103): the batch must divide the world size, with JAX's error.
- **A host is a node** of `LOCAL_WORLD_SIZE` ranks (torchrun sets it; all
  ranks on one host without it). `make_hybrid_mesh`'s `dcn_size` defaults to
  the number of hosts, as JAX's defaults to the process count.
- **A sharding** (`NamedSharding`) records the mesh axes each dimension is
  split over; `shard_batch` reads it. Nothing else is laid out by it.
- `shard_batch(mesh, global_batch)` returns this rank's rows (the
  process-major slice that JAX's `addressable_shards` hold) on this rank's
  device; `shard_batch_local` puts a rank's own rows on its device;
  `replicate` broadcasts from rank 0; `is_main_process` is rank 0;
  `local_batch_size` divides by the world size, with JAX's error.
- **`spatial > 1`**: `make_train_mesh` (after JAX's divisibility errors)
  and `make_serve_mesh` return a ('data', 'spatial') mesh laid out
  data-major, the ranks of one image's rows adjacent, as JAX's. Each image's
  rows are split over the 'spatial' axis (`parallel/spatial.py`: the layout
  rule, the halo exchange and the gradient rule); `shard_batch*` routes a
  4-D image leaf whose height the axis divides by batch over the data axes
  and by rows over 'spatial', every other leaf by batch.

The steps find the mesh through `use_mesh(mesh)` (JAX: the mesh of the
arrays' shardings). Under an active mesh with a process group, every batch a
step is given is this rank's rows of the global batch: random draws are made
at the global batch's shape from the replicated generator and this rank keeps
its rows (`draw_rows`), train-mode BatchNorm normalises by the global batch's
statistics, and losses, metrics and gradients are reduced over the data axes.
Without a process group (one process, no `initialize`), every collective is
the identity. `initialize()` is `jax.distributed.initialize()`'s
counterpart: it joins the group that torchrun's environment describes.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
DCN_AXIS = "dcn"
SPATIAL_AXIS = "spatial"
INIT_TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if _distributed() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _distributed() else 0


def host_count() -> int:
    """Hosts of the group: `LOCAL_WORLD_SIZE` ranks a host (torchrun's)."""
    n = world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n) or n)
    return max(1, n // max(1, per_host))


def initialize(device=None, timeout_s: float = INIT_TIMEOUT_S) -> int:
    """Join the process group torchrun's environment describes (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`); returns the
    world size.

    NCCL where `device` is CUDA (the default; this process's card is set to
    `LOCAL_RANK`), gloo on the CPU, with `timeout_s` on every collective.
    Without `WORLD_SIZE` > 1 there is no group and the world size is 1. When
    `WORLD_SIZE` > 1 and the group cannot form, this raises: a rank never
    carries on alone."""
    if _distributed():
        return world_size()
    n = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if n <= 1:
        return 1
    device = resolve_device(device)
    try:
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if device.type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method="env://",
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"WORLD_SIZE={n} is set but this process could not join the "
            f"process group: {e}") from e
    return n


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

class Mesh:
    """The ranks of the process group laid out in a JAX mesh's shape, with
    its axis names. `devices` is an int array of ranks; `shape` maps each
    axis name to its size, as JAX's; `device` is this rank's torch device.
    In a group of several ranks, a mesh of two or more axes makes a process
    group for each proper subset of its axes (every rank must build the same
    meshes in the same order, as with any collective)."""

    def __init__(self, devices, axis_names: Sequence[str], device=None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device = resolve_device(device)
        n = world_size()
        if n > 1 and sorted(self.devices.ravel().tolist()) != list(range(n)):
            raise ValueError(
                f"a mesh must hold every one of the {n} ranks once (each "
                f"process takes part in the program), got "
                f"{self.devices.tolist()}")
        self._groups = {}
        if n > 1:
            rank = process_index()
            for r in range(1, len(self.axis_names)):
                for axes in itertools.combinations(self.axis_names, r):
                    for ranks in self._rank_sets(axes):
                        group = dist.new_group(ranks)
                        if rank in ranks:
                            self._groups[axes] = group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{sorted(unknown)}")
        return tuple(a for a in self.axis_names if a in axes)

    def _rank_sets(self, axes) -> list:
        """The lists of ranks that differ only along `axes` (row-major)."""
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        moved = np.moveaxis(self.devices, keep, list(range(-len(keep), 0)))
        return [row.tolist() for row in
                moved.reshape(-1, self.axis_size(axes))]

    def axis_size(self, axes) -> int:
        return int(math.prod(self.shape[a] for a in self._axes(axes)))

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """The row-major position of `rank` (this one by default) along
        `axes`: the index of its shard of a dimension split over them."""
        axes = self._axes(axes)
        rank = process_index() if rank is None else rank
        coord = dict(zip(self.axis_names,
                         np.argwhere(self.devices == rank)[0].tolist()))
        index = 0
        for a in axes:
            index = index * self.shape[a] + coord[a]
        return index

    def group(self, axes):
        """The process group of this rank's ranks along `axes`."""
        axes = self._axes(axes)
        if self.axis_size(axes) == self.size:
            return dist.group.WORLD
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _ranks(devices) -> list:
    return list(range(world_size())) if devices is None else list(devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[int]] = None,
              axis_name: str = DATA_AXIS, *, device=None) -> Mesh:
    """1-D data-parallel mesh over all (or the first n) ranks."""
    devices = _ranks(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,), device)


def make_hybrid_mesh(dcn_size: Optional[int] = None,
                     devices: Optional[Sequence[int]] = None, *,
                     device=None) -> Mesh:
    """2-D ('dcn', 'data') mesh for multi-host data parallelism: hosts on
    the outer axis, each host's ranks on the inner one (ranks are host-major
    under torchrun). The batch shards over both axes. One host may pass
    `dcn_size` to lay the mesh out virtually, as in JAX."""
    devices = _ranks(devices)
    n = len(devices)
    hosts = host_count()
    if dcn_size is None:
        dcn_size = hosts
    if n % dcn_size != 0:
        raise ValueError(f"{n} devices not divisible into dcn_size={dcn_size}")
    if hosts > 1 and dcn_size != hosts:
        raise ValueError(
            f"hybrid mesh on {hosts} processes requires dcn_size == "
            f"process_count, got dcn_size={dcn_size}; pass dcn_size=None to "
            "use the process count")
    return Mesh(np.asarray(devices).reshape(dcn_size, n // dcn_size),
                (DCN_AXIS, DATA_AXIS), device)


def make_mesh_for_batch(batch_size: int, axis_name: str = DATA_AXIS, *,
                        device=None) -> Mesh:
    """The data-parallel mesh of a global batch. One rank: a 1-D mesh of
    it. Several: every rank takes part (JAX's multi-host branch), so the
    batch must divide the world size, and the mesh is the hybrid one."""
    n = world_size()
    if n == 1:
        return Mesh(np.asarray([0]), (axis_name,), device)
    if batch_size % n != 0:
        raise ValueError(
            f"multi-host training needs batch_size divisible by the "
            f"{n} global devices, got {batch_size}")
    return make_hybrid_mesh(device=device)


def make_train_mesh(batch_size: int, spatial: int = 1,
                    image_h: Optional[int] = None, *, device=None) -> Mesh:
    """The train drivers' mesh: data-parallel (`make_mesh_for_batch`). With
    `spatial > 1`, JAX's divisibility checks, then the ('data', 'spatial')
    mesh of `make_serve_mesh`, whose 'spatial' axis row-shards the images."""
    if spatial <= 1:
        return make_mesh_for_batch(batch_size, device=device)
    n_dev = world_size()
    if n_dev % spatial != 0:
        raise ValueError(f"--spatial {spatial} must divide the "
                         f"{n_dev} devices")
    n_data = n_dev // spatial
    if batch_size % n_data != 0:
        raise ValueError(f"batch_size {batch_size} must be divisible by "
                         f"the data-axis size {n_data} "
                         f"({n_dev} devices / spatial {spatial})")
    if image_h is not None and image_h % spatial != 0:
        raise ValueError(f"image height {image_h} must be divisible by "
                         f"--spatial {spatial}")
    return make_serve_mesh(n_data, spatial, device=device)


def make_serve_mesh(n_data: int, n_spatial: int,
                    devices: Optional[Sequence[int]] = None, *,
                    device=None) -> Mesh:
    """2-D ('data', 'spatial') mesh, laid out data-major (the `n_spatial`
    ranks of one image's rows adjacent); the batch shards over 'data', each
    image's rows over 'spatial'. The model's input height must divide by
    `n_spatial` (`Detector` checks)."""
    devices = _ranks(devices)
    need = n_data * n_spatial
    if len(devices) < need:
        raise ValueError(f"serve mesh ({n_data}, {n_spatial}) needs {need} "
                         f"devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:need]).reshape(n_data, n_spatial),
                (DATA_AXIS, SPATIAL_AXIS), device)


# ---------------------------------------------------------------------------
# shardings and batch placement
# ---------------------------------------------------------------------------

class NamedSharding(NamedTuple):
    """`spec[i]`: the mesh axis (a name, a tuple of names, or None) that
    dimension i splits over, as JAX's `PartitionSpec`."""
    mesh: Mesh
    spec: tuple


def data_axis_names(mesh: Mesh) -> tuple:
    """The axes the batch dim shards over: every axis but 'spatial'."""
    return tuple(n for n in mesh.axis_names if n != SPATIAL_AXIS)


def image_sharding(mesh: Mesh) -> NamedSharding:
    """[B, H, W, C] images: the batch over the data axes, rows over
    'spatial' when the mesh has one."""
    names = data_axis_names(mesh)
    batch_spec = names if len(names) > 1 else (names[0] if names else None)
    if SPATIAL_AXIS in mesh.axis_names:
        return NamedSharding(mesh, (batch_spec, SPATIAL_AXIS, None, None))
    return NamedSharding(mesh, (batch_spec,))


def batch_sharding(mesh: Mesh, axis_name: Optional[str] = None) -> NamedSharding:
    """Dim 0 over the mesh's data axes (or over `axis_name`)."""
    if axis_name is not None:
        return NamedSharding(mesh, (axis_name,))
    names = data_axis_names(mesh)
    return NamedSharding(mesh, (names if len(names) > 1 else names[0],))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_device(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                           ).to(device)


def shard_batch(mesh: Mesh, batch, axis_name: Optional[str] = None):
    """This rank's rows of a global host batch (a tensor, an array or a
    tree of them), on the mesh's device: the rows `shard_batch` of the JAX
    package puts on this rank's device, split over every data axis (or over
    `axis_name`), process-major."""
    axes = batch_sharding(mesh, axis_name).spec[0]
    n = mesh.axis_size(axes)
    i = mesh.axis_index(axes)
    image_rows = _image_rows(mesh, axis_name)

    def put(x):
        b = x.shape[0]
        if b % n != 0:
            raise ValueError(f"a batch of {b} rows does not split over the "
                             f"{n} shards of mesh axes {axes}")
        rows = b // n
        return _to_device(image_rows(x[i * rows:(i + 1) * rows]), mesh.device)

    return _tree_map(put, batch)


def _image_rows(mesh: Mesh, axis_name: Optional[str]) -> Callable:
    """x -> this rank's rows of x where `shard_batch` splits them over
    'spatial' (a 4-D leaf whose height the axis divides, JAX mesh.py:
    189-204), x itself otherwise."""
    n_sp = mesh.shape.get(SPATIAL_AXIS, 1)
    if axis_name is not None or n_sp <= 1:
        return lambda x: x
    j = mesh.axis_index(SPATIAL_AXIS)

    def take(x):
        if getattr(x, "ndim", 0) == 4 and x.shape[1] % n_sp == 0:
            h = x.shape[1] // n_sp
            return x[:, j * h:(j + 1) * h]
        return x

    return take


def shard_batch_local(mesh: Mesh, local_batch, axis_name: Optional[str] = None):
    """Multi-process input: this rank's own examples (each process loads
    its data shard's `data_shard(mesh)` examples; the ranks of one spatial
    group load the same), put on the mesh's device, a 4-D image leaf cut to
    this rank's rows as `shard_batch` cuts it."""
    image_rows = _image_rows(mesh, axis_name)
    return _tree_map(lambda x: _to_device(image_rows(x), mesh.device), local_batch)


def shard_batch_auto(mesh: Mesh, batch, axis_name: Optional[str] = None):
    """`shard_batch` in one process, `shard_batch_local` in several: the
    drivers' device put for both."""
    if world_size() > 1:
        return shard_batch_local(mesh, batch, axis_name)
    return shard_batch(mesh, batch, axis_name)


def is_main_process() -> bool:
    """True on the rank that writes shared files (rank 0)."""
    return process_index() == 0


def data_shard(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """(examples a rank loads, the index of its data shard) of a global
    batch on `mesh`: the batch over the data axes, so the ranks of one
    spatial group load the same examples (each keeps its rows of them).
    On a mesh of data axes alone: (`local_batch_size`, the rank)."""
    axes = data_axis_names(mesh)
    n = mesh.axis_size(axes)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} data shards")
    return global_batch // n, mesh.axis_index(axes)


def local_batch_size(global_batch: int) -> int:
    """This process's share of a global batch."""
    n = world_size()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def _leaves(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def replicate(mesh: Mesh, tree):
    """Give every rank rank 0's values of `tree` (a module's parameters and
    buffers, tensors, or dicts / lists of them), in place; returns it."""
    del mesh  # every mesh holds every rank
    if world_size() > 1:
        with torch.no_grad():
            for t in _leaves(tree):
                out = _transport(t, dist.group.WORLD)
                dist.broadcast(out, src=0)
                if out is not t:
                    t.copy_(out)
    return tree


# ---------------------------------------------------------------------------
# the active mesh and the collectives of the steps
# ---------------------------------------------------------------------------

_ACTIVE: list = []  # a stack; process-wide, since autograd's backward
                    # runs on threads of its own


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` the one the steps inside reduce over (None: none)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


class DataGroup(NamedTuple):
    """The data-parallel group of the active mesh: its process group, its
    size and this rank's index in it (its rows of the global batch)."""
    group: Any
    size: int
    index: int


def axis_group(axes=None) -> Optional[DataGroup]:
    """The active mesh's group along `axes` (any of its axes; default: its
    data axes), or None where there is nothing to reduce over (no active
    mesh, or no process group)."""
    mesh = current_mesh()
    if mesh is None:
        if axes is not None:
            raise ValueError(f"axis {axes!r} names no axis: no mesh is active "
                             "(parallel.use_mesh)")
        return None
    axes = data_axis_names(mesh) if axes is None else mesh._axes(axes)
    if not _distributed():
        return None
    return DataGroup(mesh.group(axes), mesh.axis_size(axes),
                     mesh.axis_index(axes))


def data_group(axes=None) -> Optional[DataGroup]:
    """`axis_group` of data axes only (a BatchNorm's `axis_name`): naming
    an axis that is not a data axis raises."""
    mesh = current_mesh()
    if mesh is not None and axes is not None and not set(
            (axes,) if isinstance(axes, str) else axes) <= set(data_axis_names(mesh)):
        raise ValueError(f"axis {axes!r} is not a data axis of the active "
                         f"mesh {mesh.axis_names}")
    return axis_group(axes)


def _transport(t: torch.Tensor, group) -> torch.Tensor:
    """`t`, or a copy on the device the group's backend takes: gloo takes
    host tensors, NCCL card tensors (the same values, staged)."""
    backend = dist.get_backend(group)
    if backend == "gloo" and t.is_cuda:
        return t.detach().cpu()
    if backend == "nccl" and not t.is_cuda:
        return t.detach().cuda()
    return t


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group, a new tensor on t's device."""
    out = _transport(t, group)
    out = out.clone() if out is t else out
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the sum of the incoming
    gradients over the group (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, axes=None) -> torch.Tensor:
    """The sum of x over the active mesh's data group (or `axes`), with the
    gradient of a sum; x itself where there is no group."""
    g = axis_group(axes)
    return x if g is None else _AllReduceSum.apply(x, g.group)


@torch.no_grad()
def reduce_sum(x: torch.Tensor, axes=None) -> torch.Tensor:
    """The sum of x over the data group (or `axes`), without gradient
    (metrics)."""
    g = axis_group(axes)
    return x if g is None else _sum(x.detach(), g.group)


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, axes=None) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in the order of the ranks'
    rows of the global batch (all ranks' x of one shape)."""
    g = data_group(axes)
    if g is None:
        return x
    mesh = current_mesh()
    if x.dtype == torch.bool:  # not every backend gathers bools
        return all_gather_rows(x.to(torch.uint8), axes) > 0
    src = _transport(x.contiguous(), g.group)
    parts = [torch.empty_like(src) for _ in range(g.size)]
    dist.all_gather(parts, src, group=g.group)
    ranks = dist.get_process_group_ranks(g.group)
    names = data_axis_names(mesh) if axes is None else axes
    order = sorted(range(g.size), key=lambda k: mesh.axis_index(names, ranks[k]))
    return torch.cat([parts[k] for k in order]).to(x.device)


def global_rows(b: int) -> Tuple[int, int]:
    """(global batch, this rank's first row) of a local batch of b rows
    under the active mesh; (b, 0) without a group."""
    g = data_group()
    return (b, 0) if g is None else (b * g.size, b * g.index)


def draw_rows(draw: Callable[[int], torch.Tensor], b: int) -> torch.Tensor:
    """`draw(n)` makes a random tensor whose dim 0 has n rows; returns this
    rank's b rows of the draw at the global batch's n, so the ranks of a
    replicated generator draw what one process would draw for the global
    batch. Without a group: `draw(b)`."""
    n, start = global_rows(b)
    out = draw(n)
    return out if n == b else out[start:start + b]


def is_first_rank(axes=None) -> bool:
    """Whether this rank holds the global batch's first rows: where a term
    that depends on replicated values alone enters a loss that the ranks
    sum, it counts once, on this rank."""
    g = data_group(axes)
    return g is None or g.index == 0


@torch.no_grad()
def all_reduce_grads(params, axes=None) -> None:
    """Sum the gradients of `params` over every axis of the active mesh (or
    `axes`): data x spatial, each rank's gradient of a replicated parameter
    being a partial one. One flat buffer per dtype and device (a parameter
    without a gradient gets a zero one, as optax sees it)."""
    mesh = current_mesh()
    g = axis_group(mesh.axis_names if axes is None and mesh is not None else axes)
    if g is None:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    buckets: dict = {}
    for p in params:
        buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in buckets.values():
        flat = _sum(torch.cat([t.reshape(-1) for t in grads]), g.group)
        offset = 0
        for t in grads:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
