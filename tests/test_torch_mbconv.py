"""The fused frozen MBConv of the port (`ops/mbconv.py`) against the JAX package.

The same numpy-seeded inputs go through the archived JAX module
`tools/experiments/fused_mbconv.py` and the port:
- the BatchNorm fold against `fold_block_params` (1e-6 relative: rsqrt may
  differ by an ulp between XLA and ATen);
- `mbconv_plain` against `mbconv_eval_xla` and against the Pallas forward
  kernel in interpret mode, on the JAX test's `CASES` at relu6 and swish,
  within 1e-5 (the JAX test's bound);
- the op's autograd input gradient (`mbconv_dx_plain` on the CPU) against
  `jax.grad` of `mbconv_eval(impl="pallas", interpret=True)`, whose backward
  is the Pallas dx kernel, within 1e-4 of the gradient's scale;
- a port `MBConvBlock` against the JAX `MBConvBlock` in eval, 2e-4;
- a lite0 backbone at 64 px, endpoints within 2e-4 * max(1, max|ref|) and the
  input gradient at cosine >= 0.9999;
- the refusal of a weight gradient, the fold cache and the layout copies;
- bf16: `mbconv_plain` / `mbconv_dx_plain` on bf16 inputs against the Pallas
  kernels in interpret mode with bf16 inputs (the same rounding points,
  float32 sums in another order: within BF16_PALLAS_TOL, two bf16 ulps),
  and against `mbconv_eval_xla(compute_dtype=bf16)` and its `jax.vjp`
  (which also round wd and the depthwise sum to bf16: BF16_XLA_TOL); the
  bf16 tile plans.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.models import efficientnet as jeff
from mladversarialobjectdetection_torch.ckpt.bridge import load_flax_variables
from mladversarialobjectdetection_torch.models import efficientnet as peff
from mladversarialobjectdetection_torch.ops import mbconv as pmb
from mladversarialobjectdetection_torch.ops import mbconv_cuda

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools" / "experiments"))
import fused_mbconv as fm  # noqa: E402  the archived TPU kernels

# (C, Co, k, expand, H, W, residual): tools/experiments/test_fused_mbconv.py:45-50
CASES = [(8, 8, 3, 6, 16, 16, True), (8, 12, 3, 6, 16, 16, False),
         (8, 8, 5, 6, 20, 20, True)]
CASE_IDS = ["k3_res", "k3_8to12", "k5_res"]
ACTS = ["relu6", "swish"]


def _folded(rng, c, co, k, e):
    """A random FoldedBlock as float32 numpy arrays (scale .3, as the JAX test)."""
    draw = lambda *shape: (rng.normal(size=shape) * 0.3).astype(np.float32)
    return fm.FoldedBlock(we=draw(c, e), be=draw(e), wd=draw(k, k, e), bd=draw(e),
                          wp=draw(e, co), bp=draw(co))


def _torch_fb(fb):
    return pmb.FoldedBlock(*(torch.from_numpy(np.asarray(a)) for a in fb))


def _jax_fb(fb):
    return fm.FoldedBlock(*(jnp.asarray(a) for a in fb))


def _case(case, seed):
    c, co, k, expand, h, w, residual = case
    rng = np.random.RandomState(seed)
    fb = _folded(rng, c, c if residual else co, k, c * expand)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    return fb, x, residual


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_matches_xla_and_pallas(case, act):
    fb, x, residual = _case(case, 1)
    out = pmb.mbconv_plain(torch.from_numpy(x), _torch_fb(fb), act_type=act,
                           residual=residual).numpy()
    ref = fm.mbconv_eval_xla(jnp.asarray(x), _jax_fb(fb), act_type=act,
                             residual=residual)
    kern = fm._mbconv_fwd_pallas(jnp.asarray(x), _jax_fb(fb), act_type=act,
                                 residual=residual, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(kern), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_autograd_dx_matches_pallas_grad(case, act):
    fb, x, residual = _case(case, 2)
    co = fb.wp.shape[1]
    w = np.random.RandomState(3).normal(size=x.shape[:3] + (co,)).astype(np.float32)

    def loss(xx):
        y = fm.mbconv_eval(xx, _jax_fb(fb), act_type=act, residual=residual,
                           impl="pallas", interpret=True)
        return jnp.sum(y * w)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (pmb.mbconv(xt, _torch_fb(fb), act_type=act, residual=residual)
     * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(xt.grad.numpy() / scale, ref / scale,
                               rtol=0, atol=1e-4)
    direct = pmb.mbconv_dx_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 _torch_fb(fb), act_type=act, residual=residual)
    np.testing.assert_allclose(direct.numpy() / scale, ref / scale,
                               rtol=0, atol=1e-4)


def _block_pair(case, act="relu6", seed=0):
    """(JAX block, its variables with redrawn BN, port block, x NHWC)."""
    c, co, k, expand, h, w, _ = case
    ba = jeff.BlockArgs(kernel_size=k, num_repeat=1, input_filters=c,
                        output_filters=co, expand_ratio=expand, id_skip=True,
                        se_ratio=None, strides=(1, 1))
    spec = jeff.BackboneSpec(blocks=(), stem_filters=32, act_type=act,
                             use_se=False, bn_momentum=0.99, bn_epsilon=1e-3,
                             survival_prob=None)
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    blk = jeff.MBConvBlock(ba, spec)
    variables = blk.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x),
                         training=False)
    p = jax.tree.map(np.asarray, variables["params"])
    s = jax.tree.map(np.asarray, variables["batch_stats"])
    for bn in ("bn0", "bn1", "bn2"):
        n = p[bn]["bn"]["scale"].shape
        p[bn]["bn"]["scale"] = (np.abs(rng.normal(1.0, 0.3, n)) + 0.1).astype(np.float32)
        p[bn]["bn"]["bias"] = rng.normal(0.0, 0.5, n).astype(np.float32)
        s[bn]["bn"]["mean"] = rng.normal(0.0, 0.5, n).astype(np.float32)
        s[bn]["bn"]["var"] = (np.abs(rng.normal(1.0, 0.3, n)) + 0.1).astype(np.float32)
    variables = {"params": p, "batch_stats": s}
    pblk = peff.MBConvBlock(peff.BlockArgs(*ba), peff.BackboneSpec(*spec), c).eval()
    load_flax_variables(pblk, variables)
    return blk, variables, pblk, x


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fold_matches_fold_block_params(case):
    _, variables, pblk, _ = _block_pair(case)
    ref = fm.fold_block_params(variables["params"], variables["batch_stats"], 1e-3)
    with torch.no_grad():
        folded = pblk.folded()
    for name, out, want in zip(pmb.FoldedBlock._fields, folded, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_block_matches_jax_block(case, act):
    blk, variables, pblk, x = _block_pair(case, act, seed=4)
    ref = np.asarray(blk.apply(variables, jnp.asarray(x), training=False))
    assert pblk.fuseable
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        fused = pblk(xt).permute(0, 2, 3, 1).numpy()
        unfused = pblk._forward_unfused(xt).permute(0, 2, 3, 1).numpy()
    tol = 2e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(fused, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(unfused, ref, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def lite0_backbone():
    """(JAX EfficientNet, variables with redrawn BN, port EfficientNet, x)."""
    spec = jeff.get_backbone_spec("efficientnet-lite0")
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    net = jeff.EfficientNet(spec)
    variables = jax.jit(net.init, static_argnames=("training",))(
        {"params": jax.random.PRNGKey(6)}, jnp.asarray(x), training=False)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(leaf)).astype(np.float32))
        if name in ("mean", "bias"):
            return jnp.asarray(rng.uniform(-0.3, 0.3, np.shape(leaf)).astype(np.float32))
        return leaf

    variables = jax.tree_util.tree_map_with_path(draw, variables)
    pnet = peff.EfficientNet(peff.get_backbone_spec("efficientnet-lite0")).eval()
    load_flax_variables(pnet, variables)
    for p in pnet.parameters():
        p.requires_grad_(False)
    return net, variables, pnet, x


def test_lite0_backbone_matches_jax(lite0_backbone):
    net, variables, pnet, x = lite0_backbone
    blocks = [getattr(pnet, f"blocks_{i}") for i in range(len(pnet.spec.blocks))]
    # lite0: block 0 is e1; blocks 1, 3, 5 and 11 have stride 2
    assert [i for i, b in enumerate(blocks) if not b.fuseable] == [0, 1, 3, 5, 11]
    rng = np.random.RandomState(7)
    refs = net.apply(variables, jnp.asarray(x), training=False)
    ws = [rng.normal(size=np.shape(r)).astype(np.float32) for r in refs]

    def loss(xx):
        outs = net.apply(variables, xx, training=False)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    ref_grad = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    outs = pnet(xt.permute(0, 3, 1, 2))
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        got = out.detach().permute(0, 2, 3, 1).numpy()
        tol = 2e-4 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
        for o, w in zip(outs, ws)).backward()
    g, r = xt.grad.numpy().ravel(), ref_grad.ravel()
    cosine = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
    assert cosine >= 0.9999, cosine


def test_lite4_has_25_fuseable_blocks():
    spec = peff.get_backbone_spec("efficientnet-lite4")
    unfused = [i for i, ba in enumerate(spec.blocks)
               if not pmb.fuseable(ba, spec.use_se, spec.act_type)]
    assert len(spec.blocks) == 30 and unfused == [0, 1, 5, 9, 21]
    # the non-lite backbones have squeeze-excite: nothing fuses
    b0 = peff.get_backbone_spec("efficientnet-b0")
    assert not any(pmb.fuseable(ba, b0.use_se, b0.act_type) for ba in b0.blocks)


def test_weight_gradient_raises():
    """A backward that would need the folded weights' gradient refuses, as
    the JAX op does (test_fused_mbconv.py:143-161): never a silent zero."""
    _, _, pblk, x = _block_pair(CASES[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = pblk(xt)  # trainable-flagged weights: the forward still runs
    with pytest.raises(RuntimeError, match="frozen"):
        y.sum().backward()
    fb = _torch_fb(_case(CASES[0], 8)[0])
    we = fb.we.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="frozen"):
        pmb.mbconv(torch.from_numpy(x), fb._replace(we=we), act_type="relu6",
                   residual=True).sum().backward()
    for p in pblk.parameters():
        p.requires_grad_(False)
    xt.grad = None
    pblk(xt).sum().backward()  # frozen weights: the input gradient only
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_fold_cache_follows_the_weights():
    _, variables, pblk, _ = _block_pair(CASES[1])
    with torch.no_grad():
        first = pblk.folded()
        assert pblk.folded() is first  # cached: no refold per call
        pblk.bn1.running_var.mul_(2.0)
        second = pblk.folded()
        assert second is not first and not torch.equal(second.wd, first.wd)
        load_flax_variables(pblk, variables)
        third = pblk.folded()
        assert third is not second and torch.equal(third.wd, first.wd)


def test_layout_copies_only_where_strides_demand():
    _, _, pblk, x = _block_pair(CASES[0])
    before = pmb.LAYOUT_COPIES
    with torch.no_grad():
        pblk(torch.from_numpy(x).permute(0, 3, 1, 2))  # NHWC memory: no copy
        assert pmb.LAYOUT_COPIES == before
        pblk(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        assert pmb.LAYOUT_COPIES == before + 1


def test_op_refuses_unsupported_act_and_device():
    fb = _torch_fb(_case(CASES[0], 9)[0])
    with pytest.raises(ValueError, match="unsupported act"):
        pmb.mbconv(torch.zeros((1, 4, 4, 8)), fb, act_type="hswish", residual=True)
    with pytest.raises(ValueError, match="device"):
        pmb.mbconv(torch.zeros((1, 4, 4, 8), device="meta"), fb,
                   act_type="relu6", residual=True)


def test_cuda_wrappers_refuse_before_any_build():
    """dtype, device and layout are checked before the kernel is built."""
    fb = _torch_fb(_case(CASES[0], 10)[0])
    x = torch.zeros((1, 4, 4, 8))
    before = dict(mbconv_cuda.LAUNCHES)
    with pytest.raises(TypeError, match="float32 only"):
        mbconv_cuda.mbconv_fwd_cuda(x.double(), fb, act_type="relu6", residual=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mbconv_cuda.mbconv_fwd_cuda(x, fb, act_type="relu6", residual=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mbconv_cuda.mbconv_dx_cuda(x, x, fb, act_type="relu6", residual=True)
    assert mbconv_cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# the CUDA kernels' relu masks, tile plan and 3xTF32 arithmetic, on the CPU
# ---------------------------------------------------------------------------

MBCONV_FWD_TOL = 1e-5  # chip_smoke.py: of max(1, max|plain|)
KINK_TOL = 1e-5        # chip_smoke.py MBCONV_KINK_TOL: of max(1, max|z|)


def _lite4_blocks(image_size=640):
    """(H, W, C, E, Co, k, residual) of each fuseable lite4 block, in order."""
    spec = peff.get_backbone_spec("efficientnet-lite4")
    side, channels, out = image_size // 2, spec.stem_filters, []  # after the stem
    for ba in spec.blocks:
        if pmb.fuseable(ba, spec.use_se, spec.act_type):
            out.append((side, side, channels, ba.input_filters * ba.expand_ratio,
                        ba.output_filters, ba.kernel_size,
                        ba.id_skip and ba.input_filters == ba.output_filters))
        side //= ba.strides[0]
        channels = ba.output_filters
    return out


def test_lite4_block_shapes():
    blocks = _lite4_blocks()
    assert len(blocks) == 25
    assert sorted(set(b[:6] for b in blocks)) == sorted([
        (160, 160, 32, 192, 32, 3), (80, 80, 56, 336, 56, 5),
        (40, 40, 112, 672, 112, 3), (40, 40, 112, 672, 160, 5),
        (40, 40, 160, 960, 160, 5), (20, 20, 272, 1632, 272, 5),
        (20, 20, 272, 1632, 448, 3)])


def _plan_shapes():
    """(B, H, W, C, E, Co, k) of the 25 lite4@640 blocks at the path's
    batches, and of the card tests' and chip_smoke.py's odd shapes."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_cuda  # noqa: E402  no JAX: the card tests' shapes
    import chip_smoke  # noqa: E402
    shapes = [(b, *blk[:6]) for b in (1, 8, 12, 24) for blk in _lite4_blocks()]
    shapes += [m[1:8] for m in test_torch_cuda.MBCONV_CASES]
    shapes += [m[1:8] for m in chip_smoke.MBCONV_ODD]
    return sorted(set(shapes))


def _check_plans(kind, dtype):
    """Every plan fits shared memory and registers, splits E at most 8 ways,
    names a built instance, and covers each output pixel, each E channel and
    each output channel exactly once."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for b, h, w, c, e, co, k in _plan_shapes():
        if kind == "fwd":
            p = mbconv_cuda.plan_fwd(h, w, c, e, co, k, b, dtype=dtype)
        else:
            p = mbconv_cuda.plan_dx(h, w, c, e, co, k, b, masks=kind == "dx_masks",
                                    dtype=dtype)
        base = kind[:3].rstrip("_")
        shape = (b, h, w, c, e, co, k)
        vec = 16 // itemsize
        v16 = c % vec == 0 and e % vec == 0 and co % vec == 0
        assert mbconv_cuda.built(base, k, p.th, p.tw, p.npw, v16, kind == "dx_masks"), shape
        assert p.smem <= mbconv_cuda.MAX_SMEM and p.regs <= mbconv_cuda.MAX_REGS, (shape, p)
        assert 1 <= p.split <= mbconv_cuda.MAX_SPLIT and p.e_per_split % mbconv_cuda.EC == 0
        n_out = co if base == "fwd" else c
        assert p.smem == mbconv_cuda.smem_bytes(base, k, p.th, p.tw, p.npw,
                                                min(p.n_per_slice, n_out), itemsize)
        wpm, _ = mbconv_cuda.warp_layout(p.th, p.tw)
        assert p.n_per_slice % 8 == 0 and p.npw * wpm * 8 >= min(p.n_per_slice, n_out)
        for n, step in ((e, p.e_per_split), (n_out, p.n_per_slice)):
            seen = np.zeros(n, int)
            for s in range(-(-n // step)):
                assert s * step < n  # no empty split or slice
                seen[s * step:(s + 1) * step] += 1
            assert (seen == 1).all()
            if n == e:
                assert -(-n // step) == p.split
        ys = np.zeros((h, w), int)
        for y0 in range(0, h, p.th):
            for x0 in range(0, w, p.tw):
                ys[y0:y0 + p.th, x0:x0 + p.tw] += 1
        assert (ys == 1).all()


@pytest.mark.parametrize("kind", ["fwd", "dx", "dx_masks"])
def test_tile_plans_cover_and_fit(kind):
    _check_plans(kind, torch.float32)


@pytest.mark.parametrize("kind", ["fwd", "dx", "dx_masks"])
def test_bf16_tile_plans_cover_and_fit(kind):
    """The bf16 instance's plans, on 2-byte buffers (16-byte copies of 8
    channels), keyed apart from the float32 ones."""
    _check_plans(kind, torch.bfloat16)
    shape = (160, 160, 32, 192, 32, 3, 24)
    f32, bf = (mbconv_cuda.plan_fwd(*shape, dtype=d) if kind == "fwd" else
               mbconv_cuda.plan_dx(*shape, masks=kind == "dx_masks", dtype=d)
               for d in (torch.float32, torch.bfloat16))
    assert bf.smem < f32.smem  # the same shape, two cache entries
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mbconv_cuda.plan_fwd(*shape, dtype=torch.float16)


def test_plans_reach_every_regime():
    """The path's plans split E at 20x20 and take the 16x16 tile at 160x160."""
    assert mbconv_cuda.plan_fwd(20, 20, 272, 1632, 272, 5, 24).split > 1
    assert mbconv_cuda.plan_fwd(20, 20, 272, 1632, 272, 5, 1).split > 1
    assert mbconv_cuda.plan_fwd(160, 160, 32, 192, 32, 3, 24)[:2] == (16, 16)
    assert mbconv_cuda.plan_dx(160, 160, 32, 192, 32, 3, 24)[:2] == (16, 16)
    wide = mbconv_cuda.plan_fwd(8, 8, 8, 48, 4096, 3, 1)  # Co in slices
    assert wide.n_per_slice < 4096
    with pytest.raises(ValueError, match="no fused MBConv"):
        mbconv_cuda.plan_dx(8, 8, 8, 48, 8, 7, 1)


def _np_case(c, e, co, k, h, w, b=2, seed=0):
    rng = np.random.RandomState(seed)
    draw = lambda *shape, s: torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))
    fb = pmb.FoldedBlock(we=draw(c, e, s=2 / c ** 0.5), be=draw(e, s=0.5),
                         wd=draw(k, k, e, s=2 / k), bd=draw(e, s=0.5),
                         wp=draw(e, co, s=2 / e ** 0.5), bp=draw(co, s=0.5))
    return draw(b, h, w, c, s=1.0), fb, draw(b, h, w, co, s=1.0)


@pytest.mark.parametrize("act", ["relu6", "relu"])
@pytest.mark.parametrize("k", [3, 5])
def test_dx_plain_given_its_own_masks_is_bit_equal(act, k):
    x, fb, g = _np_case(16, 96, 16, k, 9, 11)
    masks, _, _ = pmb.dx_masks(x, fb, act_type=act)
    for residual in (True, False):
        ref = pmb.mbconv_dx_plain(x, g, fb, act_type=act, residual=residual)
        got = pmb.mbconv_dx_plain(x, g, fb, act_type=act, residual=residual, masks=masks)
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="relu6 / relu"):
        pmb.mbconv_dx_plain(x, g, fb, act_type="swish", residual=True, masks=masks)


def test_flipped_mask_moves_dx_by_one_term():
    """A relu mask flipped at one element (ROADMAP Queue 3 item 9) moves dx
    at that pixel, and only there, by ge . We^T of that one term: ge =
    dwconv^T(gd) at the pixel and channel, times We[:, e]."""
    k, h = 5, 2
    x, fb, g = _np_case(8, 48, 8, k, 7, 6, b=1, seed=3)
    masks, _, _ = pmb.dx_masks(x, fb, act_type="relu6")
    b, y, xx, e = 0, 3, 2, 17
    flipped = masks.clone()
    flipped[0, b, y, xx, e] ^= 1
    kw = dict(act_type="relu6", residual=False)
    diff = (pmb.mbconv_dx_plain(x, g, fb, masks=flipped, **kw)
            - pmb.mbconv_dx_plain(x, g, fb, masks=masks, **kw)).double()
    gd = (g.double() @ fb.wp.double().t()) * masks[1].double()
    ge = 0.0
    for i in range(k):
        for j in range(k):
            yy, xj = y + h - i, xx + h - j
            if 0 <= yy < x.shape[1] and 0 <= xj < x.shape[2]:
                ge += float(gd[b, yy, xj, e]) * float(fb.wd[i, j, e])
    sign = 1.0 if flipped[0, b, y, xx, e] else -1.0
    want = sign * ge * fb.we[:, e].double()
    assert abs(ge) > 1e-3
    torch.testing.assert_close(diff[b, y, xx], want, rtol=0, atol=1e-5 * float(want.abs().max()))
    others = diff.clone()
    others[b, y, xx] = 0
    assert float(others.abs().max()) == 0.0


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = a.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b as the kernels take it: lo.hi + hi.lo + hi.hi, fp32 sums."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("shape", [(32, 192, 32, 3, 16, 16, 2), (272, 1632, 272, 5, 20, 20, 1)],
                         ids=["stage2_like", "20x20x1632"])
def test_3xtf32_forward_within_tolerance_and_flips_near_kinks(shape):
    """The kernels' 3xTF32 1x1 products, emulated: the forward stays within
    MBCONV_FWD_TOL of `mbconv_plain`; the z0 masks it implies differ from
    the plain version's only within KINK_TOL of a kink (counted)."""
    c, e, co, k, h, w, b = shape
    x, fb, _ = _np_case(c, e, co, k, h, w, b=b, seed=11)
    assert float(_tf32(torch.tensor([1.0 + 2.0 ** -11])).item()) == 1.0 + 2.0 ** -10
    z0 = _mm_3xtf32(x.reshape(-1, c), fb.we).reshape(*x.shape[:3], e) + fb.be
    d = pmb.act(pmb.depthwise_z1(pmb.act(z0, "relu6"), fb), "relu6")
    y = _mm_3xtf32(d.reshape(-1, e), fb.wp).reshape(*x.shape[:3], co) + fb.bp
    ref = pmb.mbconv_plain(x, fb, act_type="relu6", residual=False)
    assert float((y - ref).abs().max()) <= MBCONV_FWD_TOL * max(1.0, float(ref.abs().max()))
    z0_plain = pmb.expand_z0(x, fb)
    flips = pmb.dact(z0, "relu6") != pmb.dact(z0_plain, "relu6")
    if flips.any():
        dist = torch.minimum(z0_plain[flips].abs(), (z0_plain[flips] - 6.0).abs())
        assert float(dist.max()) <= KINK_TOL * max(1.0, float(z0_plain.abs().max()))
    print(f"{shape}: {int(flips.sum())} z0 mask flips of {z0.numel()}")


# ---------------------------------------------------------------------------
# the Hopper bf16 forward (csrc/mbconv_fwd_sm90.cu): its plan, its dispatch
# rule and its order of sums, on the CPU
# ---------------------------------------------------------------------------

def _lite4_sm90_shapes(batch):
    """(B, H, W, C, E, Co, k) of lite4@640's 7 fused shapes at `batch`, and at
    b1 also their heights under a two-way spatial split (each shard plus a
    halo of k // 2 rows: 81, 42, 21, 22, 11, 12)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke  # noqa: E402  no JAX
    from mladversarialobjectdetection_torch.ops.mbconv_sweep import LITE4_FUSED
    shapes = [(batch, *s[:6]) for s in LITE4_FUSED]
    assert sorted(set(s[1:] for s in shapes)) == sorted(set(b[:6] for b in _lite4_blocks()))
    if batch == 1:
        shapes += [(batch, *s[:6]) for s in chip_smoke.LITE4_SPATIAL]
    return shapes


@pytest.mark.parametrize("batch", [1, 8, 24])
def test_sm90_plans_fit_and_cover(batch):
    """Every lite4 plan names a built instance, fits 227 KB of shared memory
    and the register budget, holds Co in the warps' accumulators, stages the
    largest clipped halo region, covers each output pixel and each E channel
    exactly once, and at b1 gives at least 132 blocks unless no plan with as
    many is faster by the cost model (then SMs idle: the tiles are fewer
    than the SMs and a split of E only adds waves and a reduction)."""
    for b, h, w, c, e, co, k in _lite4_sm90_shapes(batch):
        shape = (b, h, w, c, e, co, k)
        p = mbconv_cuda.plan_fwd_sm90(h, w, c, e, co, k, b)
        assert p is not None, shape
        assert p[:7] in mbconv_cuda.SM90_CONFIGS
        assert p.smem == mbconv_cuda.sm90_smem_bytes(k, p.th, p.tw, p.ec, p.stages, c, co, p.nhp)
        assert p.smem <= (mbconv_cuda.MAX_SMEM if p.minb == 1 else mbconv_cuda.SM90_MAX_SMEM2)
        assert p.regs <= mbconv_cuda.SM90_MAX_REGS[p.minb], (shape, p)
        nw = mbconv_cuda.SM90_WARPS
        assert nw % p.wn == 0
        assert -(-co // 8 // p.wn) <= p.npw and -(-(p.th * p.tw // 16) // (nw // p.wn)) <= p.mpw
        hh = k // 2
        rows = max((min(y + p.th + hh, h) - max(y - hh, 0)) * (min(x + p.tw + hh, w) - max(x - hh, 0))
                   for y in range(0, h, p.th) for x in range(0, w, p.tw))
        assert rows <= p.nhp and p.nhp % 16 == 0 and p.nhp - rows < 16
        seen = np.zeros(e, int)
        for s in range(p.split):
            assert s * p.e_per_split < e  # no empty split
            seen[s * p.e_per_split:(s + 1) * p.e_per_split] += 1
        assert (seen == 1).all() and p.e_per_split % p.ec == 0
        assert p.split in mbconv_cuda.SM90_SPLITS
        cover = np.zeros((h, w), int)
        for y0 in range(0, h, p.th):
            for x0 in range(0, w, p.tw):
                cover[y0:y0 + p.th, x0:x0 + p.tw] += 1
        assert (cover == 1).all()
        assert p.blocks == -(-h // p.th) * -(-w // p.tw) * b * p.split
        if b == 1 and p.blocks < mbconv_cuda.SMS:
            fuller = [q for q in mbconv_cuda.sm90_plans(h, w, c, e, co, k, b)
                      if q.blocks >= mbconv_cuda.SMS]
            assert all(q.cost_us >= p.cost_us for q in fuller), (shape, p)


def test_sm90_dispatch_rule():
    """Every lite4 bf16 shape (and its spatial heights) goes to the Hopper
    kernel; C, E or Co off a multiple of 8, a k of 7, or a C whose x tile
    and ring overflow shared memory go to the template's bf16 instance."""
    for b in (1, 8, 24):
        for shape in _lite4_sm90_shapes(b):
            assert mbconv_cuda.sm90_supported(*shape[1:], shape[0]), shape
    for h, w, c, e, co, k in [(12, 10, 13, 78, 20, 3), (12, 12, 30, 180, 700, 3),
                              (10, 10, 700, 1400, 700, 3), (8, 8, 16, 100, 16, 3),
                              (8, 8, 16, 96, 20, 3), (8, 8, 16, 96, 16, 7),
                              (20, 20, 2048, 4096, 2048, 5)]:
        assert not mbconv_cuda.sm90_supported(h, w, c, e, co, k, 1), (h, w, c, e, co, k)
        assert mbconv_cuda.plan_fwd_sm90(h, w, c, e, co, k, 1) is None


def test_sm90_wrapper_refuses_before_any_build(monkeypatch):
    """A bf16 CPU tensor of a shape the Hopper kernel takes is refused before
    any build, and nothing is counted."""
    from mladversarialobjectdetection_torch import _build

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    x, fb, _ = _np_case(16, 96, 16, 3, 8, 8)
    assert mbconv_cuda.sm90_supported(8, 8, 16, 96, 16, 3, 2)
    before = (dict(mbconv_cuda.LAUNCHES), dict(mbconv_cuda.BF16_FWD_LAUNCHES))
    for fwd in (mbconv_cuda.mbconv_fwd_cuda, mbconv_cuda.mbconv_fwd_bf16_instance):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fwd(x.bfloat16(), fb.in_dtype(torch.bfloat16), act_type="relu6", residual=True)
    with pytest.raises(TypeError, match="bf16 x"):
        mbconv_cuda.mbconv_fwd_bf16_instance(x, fb, act_type="relu6", residual=True)
    assert (dict(mbconv_cuda.LAUNCHES), dict(mbconv_cuda.BF16_FWD_LAUNCHES)) == before


@pytest.mark.parametrize("c,e,co,k,ec", [(32, 192, 32, 3, 32), (56, 336, 56, 5, 64), (24, 88, 40, 5, 32)],
                         ids=["stage2", "stage3_ec64", "e_past_chunks"])
def test_sm90_pack_layout(c, e, co, k, ec):
    """`sm90_pack`'s slot images hold We[:, chunk] [round16(C)][ec + 8],
    Wp[chunk, :] [ec][round16(Co) + 8] (bf16), then be, bd and wd [k * k]
    of the chunk (float32), zero in every pad and past E; the kernel copies
    a slot in one piece, so its size is a multiple of 16 bytes."""
    _, fb, _ = _np_case(c, e, co, k, 4, 4)
    fb = fb.in_dtype(torch.bfloat16)
    packed = mbconv_cuda.sm90_pack(fb, ec)
    n, c16, lp = -(-e // ec), -(-c // 16) * 16, -(-co // 16) * 16 + 8
    nb_we, nb_wp = 2 * c16 * (ec + 8), 2 * ec * lp
    assert packed.dtype == torch.uint8 and packed.shape == (n, nb_we + nb_wp + 4 * (2 + k * k) * ec)
    assert packed.shape[1] % 16 == 0
    for j in range(n):
        e0, ev = j * ec, min(ec, e - j * ec)
        row = packed[j]
        we = row[:nb_we].view(torch.bfloat16).view(c16, ec + 8)
        wp = row[nb_we:nb_we + nb_wp].view(torch.bfloat16).view(ec, lp)
        f = row[nb_we + nb_wp:].view(torch.float32).view(2 + k * k, ec)
        assert torch.equal(we[:c, :ev], fb.we[:, e0:e0 + ev])
        assert torch.equal(wp[:ev, :co], fb.wp[e0:e0 + ev])
        assert torch.equal(f[0, :ev], fb.be[e0:e0 + ev]) and torch.equal(f[1, :ev], fb.bd[e0:e0 + ev])
        assert torch.equal(f[2:, :ev], fb.wd.reshape(k * k, e)[:, e0:e0 + ev])
        zero = torch.ones_like(we, dtype=torch.bool)
        zero[:c, :ev] = False
        assert not we[zero].float().any()
        zero = torch.ones_like(wp, dtype=torch.bool)
        zero[:ev, :co] = False
        assert not wp[zero].float().any() and not f[:, ev:].any()
    # cached on the fold while its tensors keep their storage and version
    assert mbconv_cuda._sm90_packed(fb, ec) is mbconv_cuda._sm90_packed(fb, ec)
    fb.be.add_(1.0)
    assert torch.equal(mbconv_cuda._sm90_packed(fb, ec), mbconv_cuda.sm90_pack(fb, ec))


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) from float32, kept in t's dtype."""
    return t.float().bfloat16().to(t.dtype)


def _sm90_order(x, fb, act, residual, ec, split, dtype):
    """The Hopper kernel's forward, emulated in `dtype` in its order: z0 over
    C in ascending steps of 16 from zero, then be; e = bf16(act(z0)), zero
    outside the image; z1 = bd, then the taps row by row; d = bf16(act(z1));
    the project per chunk of ec channels in steps of 16, a split's chunks in
    order, the splits' partials in split order, then bp and the residual;
    one rounding to bf16."""
    f = lambda t: t.to(dtype)
    xf, we, be, wd, bd, wp, bp = (f(t) for t in (x, *fb))
    c, (e, co), k = xf.shape[-1], wp.shape, wd.shape[0]
    z0 = torch.zeros((*xf.shape[:-1], e), dtype=dtype)
    for k0 in range(0, c, 16):
        z0 = z0 + xf[..., k0:k0 + 16] @ we[k0:k0 + 16]
    ev = _bf16_round(pmb.act(z0 + be, act))
    hh = k // 2
    ep = torch.nn.functional.pad(ev, (0, 0, hh, hh, hh, hh))
    z1 = torch.zeros_like(ev) + bd
    height, width = ev.shape[1:3]
    for i in range(k):
        for j in range(k):
            z1 = z1 + ep[:, i:i + height, j:j + width, :] * wd[i, j]
    d = _bf16_round(pmb.act(z1, act))
    eps = mbconv_cuda._round(-(-e // split), ec)
    y = None
    for s in range(split):
        part = torch.zeros((*xf.shape[:-1], co), dtype=dtype)
        for e0 in range(s * eps, min(e, (s + 1) * eps), ec):
            for k0 in range(e0, min(e0 + ec, e), 16):
                k1 = min(k0 + 16, e)
                part = part + d[..., k0:k1] @ wp[k0:k1]
        y = part if y is None else y + part
    y = y + bp
    return (y + xf if residual else y).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("split", [1, 3], ids=["whole", "split3"])
@pytest.mark.parametrize("shape", [(32, 192, 32, 3, 16, 16, 2, 32), (272, 1632, 272, 5, 20, 20, 1, 32)],
                         ids=["stage2_like", "20x20x1632"])
def test_sm90_order_within_rounding_bound(shape, split, dtype):
    """The Hopper kernel's order of sums and roundings, emulated (float64, and
    float32 whose adds round), stays within `ops/mbconv.rounding_bound` of
    `mbconv_plain` and within chip_smoke.py's MBCONV_BF16_FWD_TOL (2^-6 of
    max(1, max|plain|)) of it."""
    c, e, co, k, h, w, b, ec = shape
    x, fb, _ = _np_case(c, e, co, k, h, w, b=b, seed=13)
    xb, fbb = x.bfloat16(), fb.in_dtype(torch.bfloat16)
    y = _sm90_order(xb, fbb, "relu6", True, ec, split, dtype)
    bound = pmb.rounding_bound(y, xb, fbb, act_type="relu6", residual=True)
    assert bound.outside == 0, bound
    ref = pmb.mbconv_plain(xb, fbb, act_type="relu6", residual=True).float()
    err = float((y.float() - ref).abs().max())
    assert err <= 2.0 ** -6 * max(1.0, float(ref.abs().max())), err


# ---------------------------------------------------------------------------
# the Hopper bf16 input gradient (csrc/mbconv_dx_sm90.cu): its plan, its
# dispatch rule, its wrapper's refusals and its order of sums, on the CPU
# ---------------------------------------------------------------------------

DX_SPATIAL_BATCHES = (1, 2, 4, 12, 24)  # a rank's batches in phase 25 and beside it


def _dx_sm90_shapes(batch):
    """(B, H, W, C, E, Co, k) of lite4@640's 7 fused shapes at `batch` and
    their heights under phase 25's two-way spatial split (81, 42, 21, 22,
    11, 12 rows)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke  # noqa: E402  no JAX
    from mladversarialobjectdetection_torch.ops.mbconv_sweep import LITE4_FUSED
    return [(batch, *s[:6]) for s in LITE4_FUSED + chip_smoke.LITE4_SPATIAL]


@pytest.mark.parametrize("batch", DX_SPATIAL_BATCHES)
def test_dx_sm90_plans_fit_and_cover(batch):
    """Every lite4 dx plan names a built instance, fits 227 KB of shared
    memory (113 KB with two blocks a SM) and the register budget (65536
    over the SM's threads, at most 255 a thread) with the x
    and g tiles staged once, holds C in the warps' accumulators, stages the
    largest clipped x region (halo 2h) and g region (halo h), covers each
    output pixel and each E channel exactly once, and at b1 gives at least
    132 blocks unless no plan with as many is faster by the cost model."""
    for b, h, w, c, e, co, k in _dx_sm90_shapes(batch):
        shape = (b, h, w, c, e, co, k)
        p = mbconv_cuda.plan_dx_sm90(h, w, c, e, co, k, b)
        assert p is not None, shape
        assert p[:8] in mbconv_cuda.DX_SM90_CONFIGS
        assert p.smem == mbconv_cuda.dx_sm90_smem_bytes(k, p.th, p.tw, p.ec, p.stages, c, co,
                                                        p.n2p, p.n1p)
        assert p.smem <= (mbconv_cuda.MAX_SMEM if p.minb == 1 else mbconv_cuda.SM90_MAX_SMEM2)
        assert p.regs <= mbconv_cuda.dx_reg_cap(p.minb, p.nw) <= 65536 // (32 * p.nw * p.minb)
        nw = p.nw
        assert nw in (8, 16) and p.minb * nw <= 16 and nw % p.wn == 0
        assert -(-c // 8 // p.wn) <= p.npw and -(-(p.th * p.tw // 16) // (nw // p.wn)) <= p.mpw
        for halo, staged in ((2 * (k // 2), p.n2p), (k // 2, p.n1p)):
            rows = max((min(y + p.th + halo, h) - max(y - halo, 0))
                       * (min(x + p.tw + halo, w) - max(x - halo, 0))
                       for y in range(0, h, p.th) for x in range(0, w, p.tw))
            assert rows <= staged and staged % 16 == 0 and staged - rows < 16, (shape, p)
        seen = np.zeros(e, int)
        for s in range(p.split):
            assert s * p.e_per_split < e  # no empty split
            seen[s * p.e_per_split:(s + 1) * p.e_per_split] += 1
        assert (seen == 1).all() and p.e_per_split % p.ec == 0
        assert p.split in mbconv_cuda.SM90_SPLITS
        cover = np.zeros((h, w), int)
        for y0 in range(0, h, p.th):
            for x0 in range(0, w, p.tw):
                cover[y0:y0 + p.th, x0:x0 + p.tw] += 1
        assert (cover == 1).all()
        assert p.blocks == -(-h // p.th) * -(-w // p.tw) * b * p.split
        if b == 1 and p.blocks < mbconv_cuda.SMS:
            fuller = [q for q in mbconv_cuda.sm90_dx_plans(h, w, c, e, co, k, b)
                      if q.blocks >= mbconv_cuda.SMS]
            assert all(q.cost_us >= p.cost_us for q in fuller), (shape, p)
    # (th, tw, ec, npw) names one instance: the C entry dispatches on them
    keys = [(c[0], c[1], c[2], c[4]) for c in mbconv_cuda.DX_SM90_CONFIGS]
    assert len(set(keys)) == len(keys)


class _Routes:
    """Lets `mbconv_dx_cuda` through its device checks on CPU tensors and
    records which kernel each call would launch."""

    def __init__(self, monkeypatch):
        self.calls = []

        def check(data, fb, c, act_type, residual):
            return fb.wp.shape[0], fb.wp.shape[1], fb.wd.shape[0]

        monkeypatch.setattr(mbconv_cuda, "_check", check)
        monkeypatch.setattr(mbconv_cuda, "_launch_sm90_dx",
                            lambda x, *a: self.calls.append(("sm90", x.dtype)))
        monkeypatch.setattr(mbconv_cuda, "_launch",
                            lambda kind, variant, *a, **kw: self.calls.append((variant, kind)))


def test_dx_sm90_dispatch_rule(monkeypatch):
    """Every lite4 bf16 dx shape, and its spatial heights at phase 25's
    batches, goes to the Hopper kernel; C, E or Co off a multiple of 8, a k
    of 7, or tiles that overflow shared memory go to the template's bf16
    instance; float32 never takes the Hopper kernel, and the instance's
    wrapper never does either."""
    for b in DX_SPATIAL_BATCHES:
        for shape in _dx_sm90_shapes(b):
            assert mbconv_cuda.sm90_dx_supported(*shape[1:], shape[0]), shape
    for h, w, c, e, co, k in [(12, 10, 13, 78, 20, 3), (8, 8, 16, 100, 16, 3),
                              (8, 8, 16, 96, 20, 3), (8, 8, 16, 96, 16, 7),
                              (10, 10, 700, 1400, 700, 3), (20, 20, 2048, 4096, 2048, 5)]:
        assert not mbconv_cuda.sm90_dx_supported(h, w, c, e, co, k, 1), (h, w, c, e, co, k)
        assert mbconv_cuda.plan_dx_sm90(h, w, c, e, co, k, 1) is None
    routes = _Routes(monkeypatch)
    kw = dict(act_type="relu6", residual=True)
    x, fb, g = _np_case(16, 96, 16, 3, 8, 8)
    assert mbconv_cuda.sm90_dx_supported(8, 8, 16, 96, 16, 3, 2)
    xb, gb, fbb = x.bfloat16(), g.bfloat16(), fb.in_dtype(torch.bfloat16)
    mbconv_cuda.mbconv_dx_cuda(xb, gb, fbb, **kw)
    mbconv_cuda.mbconv_dx_cuda(x, g, fb, **kw)
    mbconv_cuda.mbconv_dx_bf16_instance(xb, gb, fbb, **kw)
    x13, fb13, g13 = _np_case(13, 78, 20, 3, 12, 10)
    mbconv_cuda.mbconv_dx_cuda(x13.bfloat16(), g13.bfloat16(), fb13.in_dtype(torch.bfloat16),
                               act_type="relu", residual=False)
    assert routes.calls == [("sm90", torch.bfloat16), ("float32", "dx"), ("bfloat16", "dx"),
                            ("bfloat16", "dx")]


def test_dx_sm90_wrapper_refuses_before_any_build(monkeypatch):
    """CPU tensors, float16, mixed dtypes and a bad `masks_out` are refused
    before any build, and nothing is counted."""
    from mladversarialobjectdetection_torch import _build

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    x, fb, g = _np_case(16, 96, 16, 3, 8, 8)
    xb, gb, fbb = x.bfloat16(), g.bfloat16(), fb.in_dtype(torch.bfloat16)
    kw = dict(act_type="relu6", residual=True)
    before = (dict(mbconv_cuda.LAUNCHES), dict(mbconv_cuda.BF16_DX_LAUNCHES))
    for dx in (mbconv_cuda.mbconv_dx_cuda, mbconv_cuda.mbconv_dx_bf16_instance):
        with pytest.raises(ValueError, match="CUDA tensors"):
            dx(xb, gb, fbb, **kw)
        with pytest.raises(TypeError):
            dx(x.half(), g.half(), fbb, **kw)
        with pytest.raises(TypeError):
            dx(xb, g, fbb, **kw)
    with pytest.raises(TypeError, match="bf16 x"):
        mbconv_cuda.mbconv_dx_bf16_instance(x, g, fb, **kw)
    monkeypatch.setattr(mbconv_cuda, "_check", lambda data, fb, c, act, res: (96, 16, 3))
    good = torch.zeros((2, 2, 8, 8, 96), dtype=torch.uint8)
    for bad in (good.float(), good[:, :1], good[..., :95], good.transpose(2, 3)):
        with pytest.raises(ValueError, match="masks_out"):
            mbconv_cuda.mbconv_dx_cuda(xb, gb, fbb, masks_out=bad, **kw)
    with pytest.raises(ValueError, match="masks_out"):
        mbconv_cuda.mbconv_dx_cuda(xb, gb, fbb, masks_out=good, act_type="swish", residual=True)
    assert (dict(mbconv_cuda.LAUNCHES), dict(mbconv_cuda.BF16_DX_LAUNCHES)) == before


def test_sm90_packs_cached_per_chunk_width():
    """The forward and the dx of one fold may plan other chunk widths: each
    width's pack is made once and kept beside the others."""
    _, fb, _ = _np_case(32, 192, 32, 3, 4, 4)
    fb = fb.in_dtype(torch.bfloat16)
    p16, p32 = mbconv_cuda._sm90_packed(fb, 16), mbconv_cuda._sm90_packed(fb, 32)
    assert mbconv_cuda._sm90_packed(fb, 16) is p16 and mbconv_cuda._sm90_packed(fb, 32) is p32
    assert torch.equal(p16, mbconv_cuda.sm90_pack(fb, 16))
    fb.bd.add_(1.0)  # a new version: both repack
    assert torch.equal(mbconv_cuda._sm90_packed(fb, 32), mbconv_cuda.sm90_pack(fb, 32))


def _dx_sm90_order(x, g, fb, act, residual, ec, split, dtype):
    """The Hopper dx kernel emulated in `dtype` in its order: z0 over C in
    ascending steps of 16 from zero, then be; e = bf16(act(z0)), zero
    outside the image; z1 = bd, then the taps row by row; g . Wp^T over Co in
    steps of 16; gd = bf16(that * act'(z1)); ge = bf16(dwconv^T(gd) *
    act'(z0)), the taps from zero, ky then kx ascending; dx per chunk of ec
    channels in steps of 16, a split's chunks in order, the splits' partials
    in split order, then g. Returns (dx in bf16, the masks [2, B, H, W, E]
    uint8, z0, z1)."""
    f = lambda t: t.to(dtype)
    xf, we, be, wd, bd, wp, _ = (f(t) for t in (x, *fb))
    gf = f(g)
    c, (e, co), k = xf.shape[-1], wp.shape, wd.shape[0]
    z0 = torch.zeros((*xf.shape[:-1], e), dtype=dtype)
    for k0 in range(0, c, 16):
        z0 = z0 + xf[..., k0:k0 + 16] @ we[k0:k0 + 16]
    z0 = z0 + be
    ev = _bf16_round(pmb.act(z0, act))
    hh = k // 2
    ep = torch.nn.functional.pad(ev, (0, 0, hh, hh, hh, hh))
    z1 = torch.zeros_like(ev) + bd
    height, width = ev.shape[1:3]
    for i in range(k):
        for j in range(k):
            z1 = z1 + ep[:, i:i + height, j:j + width, :] * wd[i, j]
    gw = torch.zeros((*gf.shape[:-1], e), dtype=dtype)
    for k0 in range(0, co, 16):
        gw = gw + gf[..., k0:k0 + 16] @ wp[:, k0:k0 + 16].t()
    gd = _bf16_round(gw * pmb.dact(z1, act))
    ge = _bf16_round(pmb.depthwise_t(gd, wd) * pmb.dact(z0, act))
    eps = mbconv_cuda._round(-(-e // split), ec)
    dx = None
    for s in range(split):
        part = torch.zeros_like(xf)
        for e0 in range(s * eps, min(e, (s + 1) * eps), ec):
            for k0 in range(e0, min(e0 + ec, e), 16):
                k1 = min(k0 + 16, e)
                part = part + ge[..., k0:k1] @ we[:, k0:k1].t()
        dx = part if dx is None else dx + part
    masks = torch.stack([pmb.dact(z0, act) != 0, pmb.dact(z1, act) != 0]).to(torch.uint8)
    return (dx + gf if residual else dx).to(torch.bfloat16), masks, z0, z1


def _tile_masks_agree(z0, z1, x, fb, act, th, tw):
    """Each tile of a th x tw plan recomputes z0 on its image-clipped region
    with a halo of 2h and z1 on the one with a halo of h (e zero outside the
    image), as the kernel does, in float32: every value it computes is
    bit-equal to the whole image's, so a centre pixel's masks are the ones
    its neighbours' halos use."""
    f32 = torch.float32
    xf, we, be, wd, bd = (t.to(f32) for t in (x, *fb[:4]))
    c, e, k = xf.shape[-1], we.shape[1], wd.shape[0]
    hh = k // 2
    height, width = xf.shape[1:3]
    for y0 in range(0, height, th):
        for x0 in range(0, width, tw):
            ya, yb = max(y0 - 2 * hh, 0), min(y0 + th + 2 * hh, height)
            xa, xb = max(x0 - 2 * hh, 0), min(x0 + tw + 2 * hh, width)
            zt = torch.zeros((xf.shape[0], yb - ya, xb - xa, e), dtype=f32)
            for k0 in range(0, c, 16):
                zt = zt + xf[:, ya:yb, xa:xb, k0:k0 + 16] @ we[k0:k0 + 16]
            zt = zt + be
            assert torch.equal(zt, z0[:, ya:yb, xa:xb])
            canvas = torch.zeros((xf.shape[0], th + 4 * hh, tw + 4 * hh, e), dtype=f32)
            oy, ox = ya - (y0 - 2 * hh), xa - (x0 - 2 * hh)
            canvas[:, oy:oy + yb - ya, ox:ox + xb - xa] = _bf16_round(pmb.act(zt, act))
            z1t = torch.zeros((xf.shape[0], th + 2 * hh, tw + 2 * hh, e), dtype=f32) + bd
            for i in range(k):
                for j in range(k):
                    z1t = z1t + canvas[:, i:i + th + 2 * hh, j:j + tw + 2 * hh] * wd[i, j]
            ya, yb = max(y0 - hh, 0), min(y0 + th + hh, height)
            xa, xb = max(x0 - hh, 0), min(x0 + tw + hh, width)
            oy, ox = ya - (y0 - hh), xa - (x0 - hh)
            assert torch.equal(z1t[:, oy:oy + yb - ya, ox:ox + xb - xa], z1[:, ya:yb, xa:xb])


@pytest.mark.parametrize("act", ["relu6", "swish"])
def test_dx_rounding_bound_counts_faults(act):
    """The plain bf16 dx lies within its own rounding bound; one element
    moved by a few bf16 ulps where no near gd or ge reaches is counted, and
    so is a flipped relu mask whose z lies far from its kink."""
    x, fb, g = _np_case(16, 96, 16, 5, 9, 11)
    xb, gb, fbb = x.bfloat16(), g.bfloat16(), fb.in_dtype(torch.bfloat16)
    kw = dict(act_type=act, residual=True)
    dx = pmb.mbconv_dx_plain(xb, gb, fbb, **kw)
    bound = pmb.dx_rounding_bound(dx, xb, gb, fbb, **kw)
    assert (bound.flips, bound.outside, bound.mask_faults) == (0, 0, 0)
    assert bound.gd_near > 0 and bound.dx_open < dx.numel()
    moved = dx.clone()
    moved.view(-1)[5] = (moved.view(-1)[5].float() * (1 + 2 ** -4) + 0.05).to(torch.bfloat16)
    assert pmb.dx_rounding_bound(moved, xb, gb, fbb, **kw)[:2] == (1, 1)
    if act == "relu6":
        masks, z0, _ = pmb.dx_masks(xb, fbb, act_type=act)
        far = int((z0 - 3.0).abs().flatten().argmin())  # z0 near 3: far from both kinks
        masks[0].view(-1)[far] ^= 1
        assert pmb.dx_rounding_bound(dx, xb, gb, fbb, masks=masks, **kw).mask_faults == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("split", [1, 3], ids=["whole", "split3"])
@pytest.mark.parametrize("shape", [(32, 192, 32, 3, 12, 16, 2, 16, 8, 8),
                                   (272, 1632, 272, 5, 11, 20, 1, 16, 4, 8)],
                         ids=["stage2_like", "20x20x1632_spatial"])
def test_dx_sm90_order_within_rounding_bound(shape, split, dtype):
    """The Hopper dx kernel's order of sums and roundings, emulated (float64,
    and float32 whose adds round), stays within `ops/mbconv.dx_rounding_bound`
    of `mbconv_dx_plain` fed the emulation's own masks and within
    chip_smoke.py's MBCONV_BF16_DX_TOL (2^-6 of max|plain|) of it; its masks
    differ from the plain version's only within the kink tolerance; and in
    float32 a tile's halo computes the same z0 and z1 as the tile that owns
    the pixel."""
    c, e, co, k, h, w, b, ec, th, tw = shape
    x, fb, g = _np_case(c, e, co, k, h, w, b=b, seed=17)
    xb, gb, fbb = x.bfloat16(), (g * 0.1).bfloat16(), fb.in_dtype(torch.bfloat16)
    kw = dict(act_type="relu6", residual=True)
    dx, masks, z0, z1 = _dx_sm90_order(xb, gb, fbb, "relu6", True, ec, split, dtype)
    bound = pmb.dx_rounding_bound(dx, xb, gb, fbb, masks=masks, **kw)
    assert bound.outside == 0 and bound.mask_faults == 0, bound
    ref = pmb.mbconv_dx_plain(xb, gb, fbb, masks=masks, **kw).float()
    err = float((dx.float() - ref).abs().max())
    assert err <= 2.0 ** -6 * float(ref.abs().max()), err
    plain_masks, pz0, pz1 = pmb.dx_masks(xb, fbb, act_type="relu6")
    assert pmb.kink_flips(masks, plain_masks, pz0, pz1, "relu6")[2] <= 2.0 ** -8
    if dtype == torch.float32 and split == 1:
        _tile_masks_agree(z0, z1, xb, fbb, "relu6", th, tw)


# ---------------------------------------------------------------------------
# bf16: the plain versions against the Pallas kernels' bf16 instance
# ---------------------------------------------------------------------------

# (C, Co, k, expand, H, W, residual): CASES and a C that is not a multiple of 8
BF16_CASES = CASES + [(13, 20, 3, 6, 12, 10, False)]
BF16_IDS = CASE_IDS + ["C13_k3"]
# plain vs the Pallas kernel in interpret mode at bf16: the same rounding
# points, float32 sums in another order, so an e or d within float32
# rounding of a bf16 boundary can round the other way; two bf16 ulps (2^-7)
# of max(1, max|ref|) (dx: of max|ref|). Measured: at most 0.0033.
BF16_PALLAS_TOL = 2.0 ** -7
# `mbconv_eval_xla(compute_dtype=bf16)` also rounds wd and the depthwise
# sum to bf16 before bd (fused_mbconv.py:146-151): another function by a
# few bf16 ulps (measured: forward 0.0077)
BF16_XLA_TOL = 2.0 ** -5
# dx against that path's vjp under relu / relu6, where a mask can flip:
# cosine (measured: at least 0.99966)
BF16_XLA_COS = 0.999


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16) of the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _within(out, ref, tol, floor=1.0):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    scale = max(floor, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{err} > {tol} * {scale}"


@pytest.mark.parametrize("act", ["relu6", "relu", "swish"])
@pytest.mark.parametrize("case", BF16_CASES, ids=BF16_IDS)
def test_bf16_plain_matches_pallas_and_xla(case, act):
    fb, x, residual = _case(case, 21)
    xj, xt = _bf16(x)
    tfb = _torch_fb(fb).in_dtype(torch.bfloat16)
    out = pmb.mbconv_plain(xt, tfb, act_type=act, residual=residual)
    assert out.dtype == torch.bfloat16
    kern = fm._mbconv_fwd_pallas(xj, _jax_fb(fb), act_type=act, residual=residual,
                                 interpret=True)
    ref = fm.mbconv_eval_xla(xj, _jax_fb(fb), act_type=act, residual=residual,
                             compute_dtype=jnp.bfloat16)
    assert kern.dtype == ref.dtype == jnp.bfloat16
    _within(out, _f32(kern), BF16_PALLAS_TOL)
    _within(out, _f32(ref), BF16_XLA_TOL)
    # the Pallas kernel, which sums in another order, within the roundings
    # the plain version allows
    kern_t = torch.tensor(_f32(kern)).to(torch.bfloat16)
    assert pmb.rounding_bound(kern_t, xt, tfb, act_type=act, residual=residual).outside == 0


@pytest.mark.parametrize("act", ["relu6", "relu", "swish"])
@pytest.mark.parametrize("case", BF16_CASES, ids=BF16_IDS)
def test_bf16_dx_matches_pallas_and_xla_vjp(case, act):
    """`mbconv_dx_plain` and the op's autograd on bf16 x against the Pallas dx
    kernel (bf16 x, g rounded to bf16) and `jax.vjp` of the bf16 XLA path."""
    fb, x, residual = _case(case, 22)
    co = fb.wp.shape[1]
    g = np.random.RandomState(23).normal(size=x.shape[:3] + (co,)).astype(np.float32)
    xj, xt = _bf16(x)
    gj, gt = _bf16(g)
    kern = _f32(fm._mbconv_bwd_pallas(xj, gj, _jax_fb(fb), act_type=act,
                                      residual=residual, interpret=True))
    _, vjp = jax.vjp(lambda xx: fm.mbconv_eval_xla(
        xx, _jax_fb(fb), act_type=act, residual=residual,
        compute_dtype=jnp.bfloat16), xj)
    (ref,) = vjp(gj)
    tfb = _torch_fb(fb).in_dtype(torch.bfloat16)
    direct = pmb.mbconv_dx_plain(xt, gt, tfb, act_type=act, residual=residual)
    assert direct.dtype == torch.bfloat16
    _within(direct, kern, BF16_PALLAS_TOL, floor=0.0)
    ref = _f32(ref)
    if act == "swish":
        _within(direct, ref, BF16_XLA_TOL, floor=0.0)
    else:
        # the XLA path's bf16 depthwise moves z1, so a relu mask can flip
        # and move a whole term of dx (the relu-mask rule): held by cosine
        a, b = direct.double().numpy().ravel(), ref.astype(np.float64).ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= BF16_XLA_COS
    xg = xt.clone().requires_grad_(True)
    y = pmb.mbconv(xg, tfb, act_type=act, residual=residual)
    assert y.dtype == torch.bfloat16
    y.backward(gt)
    assert xg.grad.dtype == torch.bfloat16
    assert torch.equal(xg.grad, direct)


def test_bf16_masks_and_rounding_flips():
    """The bf16 masks come from float32 z0 and z1 (z1 from the bf16 e). The
    plain forward lies within its own rounding bound; one bf16 ulp moved at
    an output no near e or d reaches is a fault counted there, and a forward
    with the wrong activation is out nearly everywhere."""
    x, fb, g = _np_case(16, 96, 16, 3, 9, 11)
    xb, fb = x.to(torch.bfloat16), fb.in_dtype(torch.bfloat16)
    masks, z0, z1 = pmb.dx_masks(xb, fb, act_type="relu6")
    assert z0.dtype == z1.dtype == torch.float32
    got = pmb.mbconv_dx_plain(xb, g, fb, act_type="relu6", residual=True, masks=masks)
    assert torch.equal(got, pmb.mbconv_dx_plain(xb, g, fb, act_type="relu6", residual=True))
    kw = dict(act_type="relu6", residual=True)
    y = pmb.mbconv_plain(xb, fb, **kw)
    bound = pmb.rounding_bound(y, xb, fb, **kw)
    assert (bound.flips, bound.outside) == (0, 0)
    assert 0 < bound.e_near < z0.numel() // 100 and bound.d_near < z1.numel() // 100
    moved = y.clone()
    moved.view(-1)[5] = (moved.view(-1)[5].float() * (1 + 2 ** -6)).to(torch.bfloat16)
    assert pmb.rounding_bound(moved, xb, fb, **kw)[:2] == (1, 1)
    wrong = pmb.mbconv_plain(xb, fb, act_type="relu", residual=True)
    assert pmb.rounding_bound(wrong, xb, fb, **kw).outside > y.numel() // 10


def test_bf16_lowp_weights_cached_on_the_block():
    """`folded(dtype)`: We and Wp in the dtype, the rest float32, one cached
    fold per dtype, refolded when a statistic changes; no float16 fold."""
    _, _, pblk, x = _block_pair(CASES[0])
    for p in pblk.parameters():
        p.requires_grad_(False)
    fb = pblk.folded(torch.bfloat16)
    assert fb.we.dtype == fb.wp.dtype == fb.dtype == torch.bfloat16
    assert {t.dtype for t in (fb.be, fb.wd, fb.bd, fb.bp)} == {torch.float32}
    assert pblk.folded(torch.bfloat16) is fb and pblk.folded().dtype == torch.float32
    assert torch.equal(fb.we, pblk.folded().we.to(torch.bfloat16))
    with torch.no_grad():
        pblk.bn0.running_mean += 0.1  # a new fold
    assert pblk.folded(torch.bfloat16) is not fb
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pblk.folded(torch.float16)
    with pytest.raises(TypeError, match="in_dtype"):  # x and the fold disagree
        pmb.mbconv_plain(torch.from_numpy(x).to(torch.bfloat16), pblk.folded(),
                         act_type=pblk.act_type, residual=pblk.residual)
