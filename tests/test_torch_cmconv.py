"""The cmconv kernels' host plan (`ops/cmconv_cuda.plan`) on the CPU.

The plan is pure Python: it picks the instance (`simt`, `csrc/cmconv.cu`,
or `tc`, `csrc/cmconv_tc.cu`) for a shape, by a rule written from the two
instances' times on an H100 (PERF.md), and raises where no instance takes
the shape. The kernels themselves run only on the card
(`test_torch_cuda.py`).
"""
import pytest
import torch

from mladversarialobjectdetection_torch import _build
from mladversarialobjectdetection_torch.ops import cmconv_cuda
from test_torch_cuda import CMCONV_EDGES, CMCONV_PATH

# (C, Co) of the defender's path -> the instance the plan must pick: the
# tensor-core one only where it beat the SIMT one on the card, which it did
# on none (PERF.md)
PATH_PICKS = {(3, 8): "simt", (8, 8): "simt", (8, 16): "simt", (16, 16): "simt",
              (32, 16): "simt", (16, 8): "simt", (16, 32): "simt"}


def test_path_picks_cover_the_path():
    assert sorted(PATH_PICKS) == sorted(CMCONV_PATH)


@pytest.mark.parametrize("side", [640, 320])
@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
def test_plan_picks_an_instance_on_every_path_shape(c, co, side):
    p = cmconv_cuda.plan(c, co, side, side)
    assert p.instance == PATH_PICKS[(c, co)]
    assert p.instance in cmconv_cuda.ENTRIES
    assert p.cob == min(v for v in (8, 16, 32) if v >= co)
    assert p.tile_h == 256 // p.cob


@pytest.mark.parametrize("name,b,c,co,h,w", CMCONV_EDGES, ids=[e[0] for e in CMCONV_EDGES])
def test_plan_takes_the_edge_shapes(name, b, c, co, h, w):
    assert cmconv_cuda.plan(c, co, h, w).instance in cmconv_cuda.ENTRIES


@pytest.mark.parametrize("c,co,h,w", [(0, 8, 8, 8), (33, 8, 8, 8), (8, 0, 8, 8),
                                      (8, 33, 8, 8), (8, 8, 0, 8), (8, 8, 8, 0)])
def test_plan_raises_outside_the_kernels_range(c, co, h, w):
    with pytest.raises(ValueError):
        cmconv_cuda.plan(c, co, h, w)


def test_plan_is_cached():
    assert cmconv_cuda.plan(16, 32, 320, 320) is cmconv_cuda.plan(16, 32, 320, 320)


def test_entries_are_in_the_sources():
    """Each instance's library is a csrc/<lib>.cu that defines its C entry."""
    for lib, name in cmconv_cuda.ENTRIES.values():
        src = (_build.CSRC_DIR / f"{lib}.cu").read_text()
        assert f'extern "C" int {name}(' in src


def test_instance_wrapper_refuses_cpu_tensors():
    x, w = torch.zeros((1, 8, 8, 8)), torch.zeros((3, 3, 8, 8))
    before = dict(cmconv_cuda.INSTANCE_LAUNCHES)
    for inst in cmconv_cuda.ENTRIES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cmconv_cuda.cmconv3x3_instance(x, w, None, inst)
    assert cmconv_cuda.INSTANCE_LAUNCHES == before
