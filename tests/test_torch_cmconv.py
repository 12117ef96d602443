"""The cmconv kernels' host plan (`ops/cmconv_cuda.plan`) on the CPU.

The plan is pure Python: it picks the instance (`simt`, `csrc/cmconv.cu`,
or `tc`, `csrc/cmconv_tc.cu`; at bf16 `simt`, `csrc/cmconv_bf16.cu`) for a
shape and dtype, by a rule written from the instances' times on an H100
(PERF.md), and raises where no instance takes the shape. The kernels themselves run only on the card
(`test_torch_cuda.py`).
"""
import pytest
import torch

from mladversarialobjectdetection_torch import _build
from mladversarialobjectdetection_torch.ops import cmconv_cuda
from test_torch_cuda import CMCONV_EDGES, CMCONV_PATH

# (C, Co) of the defender's path, the packed U-Net's level-1 convs among
# them -> the instance the plan must pick: the tensor-core one only where it
# beat the SIMT one on the card, which it did on none (PERF.md)
PATH_PICKS = {(3, 8): "simt", (8, 8): "simt", (8, 16): "simt", (16, 16): "simt",
              (32, 16): "simt", (16, 8): "simt", (16, 32): "simt",
              (12, 32): "simt", (32, 32): "simt", (32, 12): "simt"}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_entries_are_in_the_sources(dtype):
    """Each instance's library is a csrc/<lib>.cu that defines its C entry,
    itself or in the file it includes (cmconv_bf16.cu includes cmconv.cu
    and sets the macro that selects the bf16 entry: one template over the
    element type)."""
    for lib, name in cmconv_cuda.INSTANCES[dtype].values():
        src = "".join(t.decode() for t in _build._sources(_build.CSRC_DIR / f"{lib}.cu"))
        assert f'extern "C" int {name}(' in src
    bf16 = (_build.CSRC_DIR / "cmconv_bf16.cu").read_text()
    assert "#define MLAD_CMCONV_BF16" in bf16 and '#include "cmconv.cu"' in bf16


@pytest.mark.parametrize("side", [640, 320])
@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
def test_plan_picks_the_bf16_instance_on_every_path_shape(c, co, side):
    """bf16 x runs the bf16 instance (its only one), with the float32
    instance's tile; a dtype without an instance raises."""
    p = cmconv_cuda.plan(c, co, side, side, torch.bfloat16)
    assert (p.instance, p.dtype) == ("simt", torch.bfloat16)
    assert p.instance in cmconv_cuda.INSTANCES[torch.bfloat16]
    assert p[:3] == cmconv_cuda.plan(c, co, side, side)[:3]
    with pytest.raises(TypeError, match="no cmconv instance"):
        cmconv_cuda.plan(c, co, side, side, torch.float16)


def test_instance_wrapper_refuses_cpu_tensors():
    x, w = torch.zeros((1, 8, 8, 8)), torch.zeros((3, 3, 8, 8))
    before = dict(cmconv_cuda.INSTANCE_LAUNCHES)
    for inst in cmconv_cuda.ENTRIES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cmconv_cuda.cmconv3x3_instance(x, w, None, inst)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cmconv_cuda.cmconv3x3_instance(x.bfloat16(), w, None, "simt")
    assert cmconv_cuda.INSTANCE_LAUNCHES == before


def test_reset_counts_zeroes_every_count():
    cmconv_cuda.DTYPE_LAUNCHES["bfloat16"] += 1
    cmconv_cuda.INSTANCE_LAUNCHES["simt_bf16"] += 1
    cmconv_cuda.reset_counts()
    assert cmconv_cuda.LAUNCHES == 0
    assert set(cmconv_cuda.DTYPE_LAUNCHES.values()) == {0}
    assert set(cmconv_cuda.INSTANCE_LAUNCHES.values()) == {0}
