"""The port's packed backbone entry against the JAX package's, on the CPU.

`models/efficientnet_packed.PackedEntryEfficientNet` is the function of
`models/efficientnet.EfficientNet` on the same parameters, with the stem and
the first blocks in the space-to-depth layout. It is held against JAX's
`PackedEntryEfficientNet` on JAX's `tiny_spec` (tests/test_efficientnet_
packed.py:22-35: squeeze-excite on, relu6, k3 and k5, four stride-2 exits)
at 64x64, with JAX's weights (BatchNorm statistics, scales and biases
redrawn off their initial values) carried over by `ckpt/bridge.py`.

Tolerances: the packed kernels exactly (each entry is one weight or 0); the
standalone depthwise rewrites within 1e-5 of the plain convs; eval and
train-mode outputs and the moved BatchNorm statistics within 2e-5 (JAX's own
test's limits); the input gradient against the unpacked net's in float64
within 1e-10 of its scale (two float32 gradient paths are held in float64,
ROADMAP Queue 3 item 25); the detector's raw outputs within 2e-4 *
max(1, max|ref|); the attacker's step within JAX's own limits (loss 1e-3
relative, patch 5e-3, scale 1e-4, JAX tests/test_efficientnet_packed.py:
167-187); bf16 within BF16_PACKED_TOL of scale (see there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mladversarialobjectdetection_tpu.attack.attacker import PatchAttacker as JAttacker
from mladversarialobjectdetection_tpu.models import efficientdet as jdet
from mladversarialobjectdetection_tpu.models import efficientnet as jeff
from mladversarialobjectdetection_tpu.models import efficientnet_packed as jpk
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack import train as ptrain
from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.models import efficientdet as pdet
from mladversarialobjectdetection_torch.models import efficientnet as peff
from mladversarialobjectdetection_torch.models import efficientnet_packed as ppk
from mladversarialobjectdetection_torch.models.unet_packed import space_to_depth
from test_torch_attack import PINNED, step_draws

N_PACKED = [1, 2, 4, 8]
EVAL_TOL = 2e-5
# bf16: the port's packed bf16 backbone against JAX's packed bf16 one, of
# max(1, max|ref|) over the endpoints. Both run the same convs at bf16 with
# float32 BatchNorm, but XLA and ATen round a bf16 conv's sums and the
# squeeze-excite's mean at other points. Measured on the CPU: the port's
# bf16 net 0.00746 away at every n_packed (1, 2, 4, 8), the float32 net
# 0.01107 away: the limit lies between them.
BF16_PACKED_TOL = 0.009


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_spec(mod):
    """JAX's tiny spec (tests/test_efficientnet_packed.py:22-35) in `mod`'s
    types."""
    se = 0.25
    rows = ((3, 8, 8, 1, 1), (3, 8, 12, 6, 2), (5, 12, 12, 6, 1),
            (5, 12, 16, 6, 2), (3, 16, 16, 6, 1), (3, 16, 24, 6, 2),
            (3, 24, 24, 6, 1), (3, 24, 32, 6, 2))
    blocks = tuple(mod.BlockArgs(k, 1, i, o, e, True, se, (s, s))
                   for k, i, o, e, s in rows)
    return mod.BackboneSpec(blocks, stem_filters=8, act_type="relu6", use_se=True,
                            bn_momentum=0.99, bn_epsilon=1e-3, survival_prob=None)


def redraw(variables, seed):
    """BatchNorm statistics, scales and biases off their initial values."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.uniform(-0.3, 0.3, shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(draw, variables)


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def pair():
    """(JAX spec, variables, images, port unpacked net on those variables)."""
    jspec = tiny_spec(jeff)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    init = jax.jit(jeff.EfficientNet(jspec).init, static_argnames=("training",))
    variables = redraw(init({"params": jax.random.PRNGKey(7)}, jnp.asarray(x),
                            training=False), seed=1)
    net = peff.EfficientNet(tiny_spec(peff)).eval()
    bridge.load_flax_variables(net, variables)
    return jspec, variables, x, net


def packed(net, n):
    return ppk.PackedEntryEfficientNet.sharing(net, n)


# ---------------------------------------------------------------------------
# layout and kernels
# ---------------------------------------------------------------------------

def test_state_dict_equals_the_unpacked_nets(pair):
    _, variables, _, net = pair
    pnet = ppk.PackedEntryEfficientNet(tiny_spec(peff), packed_blocks=4)
    got = {k: tuple(v.shape) for k, v in pnet.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in net.state_dict().items()}
    # JAX's packed net has the unpacked pytree (JAX's test_pytree_parity);
    # the port's packed net loads and gives back those variables as they are
    bridge.load_flax_variables(pnet, variables)
    back = bridge.torch_to_flax(pnet)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert np.array_equal(a, np.asarray(b))


def test_layout_helpers_and_packed_kernels_equal_jax():
    rng = np.random.default_rng(1)
    xp = rng.normal(size=(2, 3, 5, 24)).astype(np.float32)
    assert np.array_equal(nhwc(ppk.pm_to_cm(nchw(xp))), np.asarray(jpk.pm_to_cm(xp)))
    assert np.array_equal(nhwc(ppk.cm_to_pm(nchw(xp))), np.asarray(jpk.cm_to_pm(xp)))
    c = 6
    for k in (3, 5):
        kdw = rng.normal(size=(k, k, 1, c)).astype(np.float32)
        w = torch.from_numpy(kdw.transpose(3, 2, 0, 1).copy())  # [C, 1, k, k]
        j1 = np.asarray(jpk.pack_dw_kernel_s1(jnp.asarray(kdw)))  # [pk, pk, 4, 4C]
        assert np.array_equal(ppk.pack_dw_kernel_s1(w).permute(2, 3, 1, 0).numpy(), j1)
        j2, jlo, jhi = jpk.pack_dw_kernel_s2(jnp.asarray(kdw))   # [pk, pk, 4, C]
        k2, lo, hi = ppk.pack_dw_kernel_s2(w)
        assert (lo, hi) == (jlo, jhi)
        assert np.array_equal(k2.permute(2, 3, 1, 0).numpy(), np.asarray(j2))
    ks = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    got = ppk.pack_stem_kernel(torch.from_numpy(ks.transpose(3, 2, 0, 1).copy()))
    assert np.array_equal(got.permute(2, 3, 1, 0).numpy(),
                          np.asarray(jpk.pack_stem_kernel(jnp.asarray(ks))))


@pytest.mark.parametrize("k", [3, 5])
def test_depthwise_rewrites_standalone(k):
    """The s1 and s2 packed depthwise convs against the plain Flax-"SAME"
    depthwise conv, as JAX's test_packed_dw_kernels_standalone."""
    rng = np.random.default_rng(1)
    c = 6
    x = torch.from_numpy(rng.standard_normal((2, c, 12, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((c, 1, k, k)).astype(np.float32))
    ref = F.conv2d(peff.pad_same(x, (k, k), (1, 1)), w, groups=c)
    got = ppk.packed_dw_s1(space_to_depth(x), ppk.pack_dw_kernel_s1(w))
    torch.testing.assert_close(got, space_to_depth(ref), rtol=0, atol=1e-5)
    ref2 = F.conv2d(peff.pad_same(x, (k, k), (2, 2)), w, stride=2, groups=c)
    got2 = ppk.packed_dw_s2(space_to_depth(x), *ppk.pack_dw_kernel_s2(w))
    torch.testing.assert_close(got2, ref2, rtol=0, atol=1e-5)
    # and the packed stem against the Flax-"SAME" stride-2 conv
    img = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((8, 3, 3, 3)).astype(np.float32))
    ref3 = F.conv2d(peff.pad_same(img, (3, 3), (2, 2)), ws, stride=2)
    got3 = ppk.packed_stem(img, ppk.pack_stem_kernel(ws))
    torch.testing.assert_close(got3, space_to_depth(ref3), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_packed", N_PACKED)
def test_eval_forward_matches_jax_and_the_unpacked_net(pair, n_packed):
    """n_packed 2 exits at the first s2 block, 4 packs a second segment
    (k5), 8 runs every block packed."""
    jspec, variables, x, net = pair
    ref = jpk.PackedEntryEfficientNet(jspec, packed_blocks=n_packed).apply(
        variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = packed(net, n_packed)(nchw(x))
        unpacked = net(nchw(x))
    assert len(got) == len(ref) == 5
    for g, r, u in zip(got, ref, unpacked):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), rtol=0, atol=EVAL_TOL)
        torch.testing.assert_close(g, u, rtol=0, atol=EVAL_TOL)


def test_train_forward_and_statistics_match_jax(pair):
    jspec, variables, x, _ = pair
    ref, mut = jpk.PackedEntryEfficientNet(jspec, packed_blocks=4).apply(
        variables, jnp.asarray(x), True, mutable=["batch_stats"])
    net = ppk.PackedEntryEfficientNet(tiny_spec(peff), packed_blocks=4)
    bridge.load_flax_variables(net, variables)
    got = net(nchw(x), training=True)
    for g, r in zip(got, ref):  # outputs normalised by batch statistics reach 5
        r = np.asarray(r)
        np.testing.assert_allclose(nhwc(g), r, rtol=0,
                                   atol=EVAL_TOL * max(1.0, float(np.abs(r).max())))
    moved = bridge.torch_to_flax(net)["batch_stats"]
    want = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    assert jax.tree_util.tree_structure(moved) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(moved), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=EVAL_TOL)
    # train mode carries the weights' gradients (JAX's train-mode test implies it)
    sum(e.square().sum() for e in got).backward()
    blk = net.blocks_2
    for p in (net.stem_conv.weight, blk.expand_conv.weight, blk.depthwise_conv.weight,
              blk.project_conv.weight, blk.bn1.weight, blk.se.reduce.weight):
        assert p.grad is not None and float(p.grad.abs().sum()) > 0


def test_input_gradient_matches_the_unpacked_net_in_float64(pair):
    _, variables, x, _ = pair
    net = peff.EfficientNet(tiny_spec(peff)).eval()
    bridge.load_flax_variables(net, variables)
    net = net.double().requires_grad_(False)

    def grad(model):
        xx = nchw(x, torch.float64).requires_grad_(True)
        sum(e.square().sum() for e in model(xx)).backward()
        return xx.grad

    with peff.unfused_blocks():  # the fused op's plain version takes no float64
        gu = grad(net)
        gp = grad(packed(net, 4))
    assert float((gp - gu).abs().max()) <= 1e-10 * float(gu.abs().max())


def test_kernels_are_cached_and_rebuilt_on_a_weight_change(pair):
    _, _, x, net = pair
    pnet = packed(net, 4)
    with torch.no_grad():
        first = pnet.packed_kernels(torch.float32)
        assert all(a is b for a, b in zip(first, pnet.packed_kernels(torch.float32)))
        net.blocks_2.depthwise_conv.weight.mul_(1.0)  # a new version
        again = pnet.packed_kernels(torch.float32)
    assert again[3] is not first[3] and again[1] is first[1]
    # where a weight trains, the kernels carry its gradient: built every call
    assert net.stem_conv.weight.requires_grad
    assert pnet.packed_kernels(torch.float32)[0].grad_fn is not None
    with pytest.raises(ValueError, match="divisible by 4"):
        pnet(torch.zeros((1, 3, 62, 64)))


def test_bf16_packed_net_matches_jax_bf16(pair):
    jspec, variables, x, net = pair
    ref = jax.jit(jpk.PackedEntryEfficientNet(jspec, packed_blocks=8,
                                              dtype=jnp.bfloat16).apply,
                  static_argnums=2)(variables, jnp.asarray(x), False)
    net16 = peff.EfficientNet(tiny_spec(peff), dtype=torch.bfloat16).eval()
    bridge.load_flax_variables(net16, variables)
    with torch.no_grad():
        got = packed(net16, 8)(nchw(x))
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        tol = BF16_PACKED_TOL * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(nhwc(g), r, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the detector and the attack
# ---------------------------------------------------------------------------

def test_detector_packed_entry_matches_jax(tiny_detector):
    cfg, spec, _, variables = tiny_detector
    x = np.random.default_rng(3).uniform(-1, 1, (2, *spec.image_size, 3)).astype(
        np.float32)
    ref = jax.jit(jdet.EfficientDetNet(spec, packed_entry=2).apply, static_argnums=2)(
        variables, jnp.asarray(x), False)
    pnet = pdet.EfficientDetNet(pdet.spec_from_config(pconfig.Config(cfg.as_dict())),
                                packed_entry=2).eval()
    bridge.load_flax_variables(pnet, jax.tree_util.tree_map(np.asarray, variables))
    assert isinstance(pnet.backbone, ppk.PackedEntryEfficientNet)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x))
    for outs, refs in zip(got, ref):
        for o, r in zip(outs, refs):
            r = np.asarray(r)
            tol = 2e-4 * max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=tol)


@pytest.mark.parametrize("live", [False, True])
def test_attacker_packed_entry_matches_jax(tiny_detector, rand_images, live):
    """One train step of `PatchAttacker(packed_entry=2)` in both packages from
    the same state; the port's unpacked victim is left as it is. Without
    live slots (JAX's own test: the victim finds nobody at score .5) the
    patch within 5e-3; with two live slots, the same EOT draws and the
    gradient through the packed victim, every pixel within Adam's step lr
    (a pixel whose tiny gradient JAX's bf16 warp turns moves the other way,
    tests/test_torch_attack.py)."""
    from test_torch_attack import LR, t
    cfg, _, _, variables = tiny_detector
    images = np.asarray(rand_images)
    boxes = np.zeros((2, 4, 4), np.float32)
    valid = np.zeros((2, 4), bool)
    boxes[0, 0], boxes[1, 0] = (4, 4, 60, 60), (8, 6, 56, 40)
    valid[0, 0] = valid[1, 0] = live
    jatk = JAttacker(cfg, variables, patch_size=32, eot_overrides=PINNED,
                     packed_entry=2)
    jst = jatk.init_state(jax.random.PRNGKey(0))
    draws, _ = step_draws(jst.key, 2, 4)
    jst2, jm = jax.jit(jatk.train_step)(jst, jnp.asarray(images),
                                        boxes_override=(jnp.asarray(boxes),
                                                        jnp.asarray(valid)))
    pcfg = pconfig.Config(cfg.as_dict())
    victim = ptrain.get_victim(pcfg, variables=jax.tree_util.tree_map(np.asarray, variables),
                               device="cpu")
    patk = PatchAttacker(pcfg, victim, patch_size=32, eot_overrides=PINNED,
                         packed_entry=2, device="cpu")
    assert isinstance(patk.net.backbone, ppk.PackedEntryEfficientNet)
    assert type(victim.backbone) is peff.EfficientNet
    pst = patk.init_state(0, initial_patch=np.asarray(jst.patch))
    pst, pm = patk.train_step(pst, t(images), boxes_override=(
        t(boxes), torch.from_numpy(valid)), eot_draws=draws)
    assert float(pm.loss) == pytest.approx(float(jm.loss), rel=1e-3)
    np.testing.assert_allclose(pst.patch.detach().numpy(), np.asarray(jst2.patch),
                               rtol=0, atol=LR if live else 5e-3)
    assert abs(float(pst.scale.detach()) - float(jst2.scale)) < 1e-4


def test_detector_packed_quantize_int8_matches_jax():
    """JAX's `Detector(packed_entry=2).quantize_int8` serves (its packed
    region's lax convs stay float: 68 of lite0's 74 eligible convs are
    quantised), so the port's does the same: the same conv keys and
    activation scales, and the int8 forward held to JAX's as
    tests/test_torch_quantize.py holds the unpacked one."""
    from mladversarialobjectdetection_tpu.inference import quantize as jquant
    from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from test_torch_quantize import ACT_RTOL, INT8_FRACTION, INT8_TOL, PARAMS, _frames
    jdet = JDetector(model_name="efficientdet-lite0", params=PARAMS, seed=0,
                     packed_entry=2)
    pdet = Detector("efficientdet-lite0", params=PARAMS, device="cpu", packed_entry=2)
    pdet.load_flax_variables(jdet.variables)
    frames = _frames(np.random.default_rng(7), 8)
    jint8 = jquant.Int8Serve(jdet.net, jdet.variables, [pdet.preprocess(frames)[0]])
    pdet.quantize_int8(frames)
    got = pdet._int8
    assert set(got.qkernels) == set(jint8.state["qkernels"])
    assert not any(p.startswith(("backbone/stem_conv", "backbone/blocks_0/",
                                 "backbone/blocks_1/")) for p in got.qkernels)
    for p, want in jint8.act_scales.items():
        assert abs(got.act_scales[p] - want) <= ACT_RTOL * want, p
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jc, jb = jax.jit(jint8)(jint8.state, jnp.asarray(x))
    with torch.no_grad():
        pc, pb = got(torch.from_numpy(x))
    off = total = 0
    for j, p in zip(list(jc) + list(jb), list(pc) + list(pb)):
        d = np.abs(np.asarray(j, np.float32) - p.numpy())
        off += int((d > INT8_TOL).sum())
        total += d.size
    assert off <= INT8_FRACTION * total, f"{off} of {total} outputs off by > {INT8_TOL}"


def test_detector_packed_export_reserves_the_live_serve(tmp_path):
    """JAX exports `Detector(packed_entry=2)` (StableHLO); the port's
    `torch.export` program of it holds the packed kernels as ops and serves
    what the live packed detector serves, bit-equal on one route."""
    from mladversarialobjectdetection_torch.inference import drivers, export
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.ops import library
    from test_torch_quantize import PARAMS, _frames
    det = Detector("efficientdet-lite0", params=PARAMS, device="cpu", packed_entry=2)
    frames = _frames(np.random.default_rng(9), 1)
    ref = det.serve(frames)
    path = str(tmp_path / "packed.pt2")
    det.export(path, batch_size=1)
    # lite0's fuseable blocks less the packed range's (blocks 0 and 1: none)
    fused = sum(b.fuseable for b in det.net.backbone.children()
                if isinstance(b, peff.MBConvBlock))
    assert library.op_counts(export.load_program(path).graph) == {
        "batched_nms": 1, "mbconv_fwd": fused}
    out = drivers.ExportedProgramDriver(path, "efficientdet-lite0", PARAMS,
                                        device="cpu").serve(frames)
    for f in out._fields:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f))
