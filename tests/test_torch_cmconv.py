"""The cmconv kernels' host plan (`ops/cmconv_cuda.plan`) and the bf16
rounding bound (`ops/cmconv.cmconv_rounding_bound`) on the CPU.

The plan is pure Python: it picks the instance (`simt`, `csrc/cmconv.cu`,
or `tc`, `csrc/cmconv_tc.cu`; at bf16 `sm90`, `csrc/cmconv_bf16_sm90.cu`,
with `simt`, `csrc/cmconv_bf16.cu`, as the ablation) for a shape and dtype,
by a rule written from the instances' times on an H100 (PERF.md), and
raises where no instance takes the shape. The kernels themselves run only
on the card (`test_torch_cuda.py`). Here a float64 / float32 emulation of
the Hopper bf16 kernel's arithmetic (each weight split into bf16 hi and lo
terms, the exact products summed chunk by chunk in its K order, dy-major,
into a float32 accumulator, one bf16 rounding, the bias added in bf16) is held
within `cmconv_rounding_bound` of the float64 sum, as the plain version is,
and emulations that drop the lo terms or a tap are shown to fall outside it.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mladversarialobjectdetection_torch import _build
from mladversarialobjectdetection_torch.ops import cmconv, cmconv_cuda
from test_torch_cuda import CMCONV_EDGES, CMCONV_PATH

# heights off the tiles' 8 and 4 rows: a spatial shard's halo-extended rows
ODD_HEIGHTS = (1, 13, 162, 322)

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


# (C's blocks of 8, Co's n-tiles of 8) -> the Hopper bf16 instance's tile rows
# (`dispatch_nt` of csrc/cmconv_bf16_sm90.cu)
SM90_TILE_H = {(1, 1): 16, (1, 2): 8, (1, 3): 4, (1, 4): 4, (2, 1): 6, (2, 2): 6, (2, 3): 4,
               (2, 4): 4, (3, 1): 4, (3, 2): 4, (3, 3): 4, (3, 4): 4, (4, 1): 4, (4, 2): 4,
               (4, 3): 2, (4, 4): 2}


def _sm90_plan(c, co):
    """The Hopper bf16 instance's tile: Co in n-tiles of 8, SM90_TILE_H rows."""
    return cmconv_cuda.Plan("sm90", 8 * -(-co // 8), SM90_TILE_H[(-(-c // 8), -(-co // 8))],
                            torch.bfloat16)


@pytest.mark.parametrize("side", [640, 320])
@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
def test_plan_picks_the_bf16_instance_on_every_path_shape(c, co, side):
    """bf16 x runs the Hopper bf16 instance at every path shape (the SIMT
    instance `simt` is the ablation); a dtype without an instance raises."""
    p = cmconv_cuda.plan(c, co, side, side, torch.bfloat16)
    assert p == _sm90_plan(c, co)
    assert p.instance in cmconv_cuda.INSTANCES[torch.bfloat16]
    assert "simt" in cmconv_cuda.INSTANCES[torch.bfloat16]
    with pytest.raises(TypeError, match="no cmconv instance"):
        cmconv_cuda.plan(c, co, side, side, torch.float16)


@pytest.mark.parametrize("h", ODD_HEIGHTS)
@pytest.mark.parametrize("c,co", [(12, 32), (32, 32), (32, 12), (3, 8), (16, 32)],
                         ids=["p12to32", "p32to32", "p32to12", "3to8", "16to32"])
def test_bf16_plan_picks_sm90_at_packed_shapes_and_odd_heights(c, co, h):
    """The packed U-Net's level-1 shapes and any height go to the Hopper
    instance: its rule is 1 <= C, Co <= 32 and any B, H, W."""
    for w in (h, 320, 37):
        assert cmconv_cuda.plan(c, co, h, w, torch.bfloat16) == _sm90_plan(c, co)


@pytest.mark.parametrize("name,b,c,co,h,w", CMCONV_EDGES, ids=[e[0] for e in CMCONV_EDGES])
def test_bf16_plan_takes_the_edge_shapes(name, b, c, co, h, w):
    assert cmconv_cuda.plan(c, co, h, w, torch.bfloat16) == _sm90_plan(c, co)


@pytest.mark.parametrize("c,co,h,w", [(0, 8, 8, 8), (33, 8, 8, 8), (8, 0, 8, 8),
                                      (8, 33, 8, 8), (8, 8, 0, 8), (8, 8, 8, 0)])
def test_bf16_plan_raises_outside_the_kernels_range(c, co, h, w):
    with pytest.raises(ValueError):
        cmconv_cuda.plan(c, co, h, w, torch.bfloat16)


def test_instance_wrapper_refuses_cpu_tensors():
    x, w = torch.zeros((1, 8, 8, 8)), torch.zeros((3, 3, 8, 8))
    before = dict(cmconv_cuda.INSTANCE_LAUNCHES)
    for inst in cmconv_cuda.ENTRIES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cmconv_cuda.cmconv3x3_instance(x, w, None, inst)
    for inst in cmconv_cuda.INSTANCES[torch.bfloat16]:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cmconv_cuda.cmconv3x3_instance(x.bfloat16(), w, None, inst)
    assert cmconv_cuda.INSTANCE_LAUNCHES == before


def test_reset_counts_zeroes_every_count():
    cmconv_cuda.DTYPE_LAUNCHES["bfloat16"] += 1
    cmconv_cuda.INSTANCE_LAUNCHES["simt_bf16"] += 1
    cmconv_cuda.PLAN_LAUNCHES["sm90_bf16"] += 1
    cmconv_cuda.reset_counts()
    assert cmconv_cuda.LAUNCHES == 0
    assert set(cmconv_cuda.DTYPE_LAUNCHES.values()) == {0}
    assert set(cmconv_cuda.INSTANCE_LAUNCHES.values()) == {0}
    assert set(cmconv_cuda.PLAN_LAUNCHES.values()) == {0}
    assert set(cmconv_cuda.PLAN_LAUNCHES) == set(cmconv_cuda.INSTANCE_LAUNCHES)


# ---------------------------------------------------------------------------
# the bf16 rounding bound, against an emulation of the Hopper kernel's sums
# ---------------------------------------------------------------------------

def _emulate_sm90(x, w, bias=None, drop_lo=False, drop_tap=None):
    """csrc/cmconv_bf16_sm90.cu's arithmetic on the CPU: w split into bf16
    hi = bf16(w) and lo = bf16(w - hi); K in groups of 8 channels, for each
    dy the groups (dx, channel block) of its row, two a chunk (the last of a
    row padded where the row has an odd count); per chunk, in (dy, chunk)
    order, the 16 exact products of hi, then of lo, summed in float64 and
    added to a float32 accumulator (one mma: exact products, one rounding);
    the sum rounded to bf16, the bias added in bf16. drop_lo / drop_tap: the
    mutations the bound must catch."""
    b, c, h, wd = x.shape
    co = w.shape[3]
    cp8 = -(-c // 8)
    xp = F.pad(x.double(), (1, 1, 1, 1, 0, 8 * cp8 - c))
    hi = w.bfloat16()
    lo = (w - hi.float()).bfloat16()
    terms = [F.pad(t.double(), (0, 0, 0, 8 * cp8 - c)) for t in ((hi,) if drop_lo else (hi, lo))]
    acc = torch.zeros((b, co, h, wd), dtype=torch.float32)
    for dy in range(3):
        row = [(dx, cb) for dx in range(3) for cb in range(cp8) if 3 * dy + dx != drop_tap]
        for k in range(0, len(row), 2):
            chunk = row[k:k + 2]
            a = torch.cat([xp[:, cb * 8:cb * 8 + 8, dy:dy + h, dx:dx + wd] for dx, cb in chunk], 1)
            for t in terms:
                wt = torch.cat([t[dy, dx, cb * 8:cb * 8 + 8] for dx, cb in chunk], 0)
                acc = (acc.double() + torch.einsum("bkhw,ko->bohw", a, wt)).float()
    out = acc.bfloat16()
    return out if bias is None else out + bias.view(1, -1, 1, 1)


def _bf16_case(b, c, co, h, w, seed, bf16_w):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w))).bfloat16()
    wt = torch.from_numpy(rng.standard_normal((3, 3, c, co)) * 0.3).float()
    bias = torch.from_numpy(rng.standard_normal(co)).bfloat16()
    return x, (wt.bfloat16().float() if bf16_w else wt), bias


def _within_bound(out, x, wt, bias):
    err = (out.double() - cmconv.cmconv_sum64(x, wt, bias)).abs()
    return bool((err <= cmconv.cmconv_rounding_bound(x, wt, bias)).all())


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("bf16_w", [True, False], ids=["bf16w", "f32w"])
@pytest.mark.parametrize("c,co", CMCONV_PATH, ids=[f"{c}to{co}" for c, co in CMCONV_PATH])
def test_sm90_emulation_within_rounding_bound(c, co, bf16_w, with_bias):
    """The emulated kernel and the plain version both lie within the bound of
    the float64 sum at every path shape (small H, W), for weights that hold
    bf16 values (lo 0, the U-Net's) and for general float32 weights."""
    x, wt, bias = _bf16_case(2, c, co, 5, 11, c * 100 + co, bf16_w)
    bias = bias if with_bias else None
    emu = _emulate_sm90(x, wt, bias)
    assert emu.dtype == torch.bfloat16 and emu.shape == (2, co, 5, 11)
    assert _within_bound(emu, x, wt, bias)
    assert _within_bound(cmconv.cmconv_plain(x, wt, bias), x, wt, bias)


@pytest.mark.parametrize("mutation", ["drop_lo", "drop_tap"])
@pytest.mark.parametrize("c,co", [(8, 16), (16, 8), (32, 16)], ids=["8to16", "16to8", "32to16"])
def test_rounding_bound_catches_a_mutated_emulation(c, co, mutation):
    """The bound bites: an emulation that drops the lo terms of general
    float32 weights, or one tap, leaves it somewhere (and the unmutated one
    at the same inputs does not)."""
    x, wt, bias = _bf16_case(2, c, co, 8, 16, 7 + c + co, bf16_w=False)
    assert _within_bound(_emulate_sm90(x, wt, bias), x, wt, bias)
    kw = {"drop_lo": True} if mutation == "drop_lo" else {"drop_tap": 4}
    assert not _within_bound(_emulate_sm90(x, wt, bias, **kw), x, wt, bias)


def test_cmconv_profile_stamps_every_phase():
    """`ops/cmconv_profile.py` still finds every line of the Hopper kernel's
    tile loop that its clock64 stamps follow (it raises where one is gone)."""
    from mladversarialobjectdetection_torch.ops import cmconv_profile
    src = cmconv_profile.instrumented_source()
    assert src.count("MARK(") == 1 + len(cmconv_profile.PHASES)
    assert "mlad_cmconv_profile" in src and "mlad_cmconv3x3_bf16_sm90" in src
