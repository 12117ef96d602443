"""The port's space-to-depth packed U-Net against the JAX package's, on the CPU.

`models/unet_packed.PackedPatchNeutralizer` is the function of
`models/unet.PatchNeutralizer` on the same parameters, in another layout.
It is held against JAX's `PackedPatchNeutralizer` at packed_levels 1, 2 and
3, and against the port's own unpacked module on the same weights. The
weights are JAX's (n_filters 4, BatchNorm statistics moved off their initial
values), carried over by `ckpt/bridge.py`; images 32 px, dropout 0.

Tolerances: the layout helpers and the packed kernels exactly (each packed
kernel entry is one weight or 0); the packed convs within 1e-5 of JAX's; the
module's fp32 outputs within 2e-4 * max(1, max|ref|) and its BatchNorm
statistics within 2e-4 of scale (the ROADMAP rule); its parameter gradients
at cosine >= 0.9999 (0.999 per leaf against the unpacked module's, whose
convs sum over other taps: JAX's own f32 test allows 5% of a leaf's norm,
tests/test_unet_packed.py:158-186); bf16 eval within 0.01 of scale, the
bound `test_torch_unet.py` holds the bf16 U-Net to. Dropout in the packed
deconv blocks draws over the packed shape by design (JAX
unet_packed.py:30-33): only that it runs and keeps about 1 - rate is held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from mladversarialobjectdetection_tpu.models import unet as junet
from mladversarialobjectdetection_tpu.models import unet_packed as jpk
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.models import unet as punet
from mladversarialobjectdetection_torch.models import unet_packed as ppk
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.ops import cmconv as pcmconv
from test_torch_unet import assert_close, cosine, t

LEVELS = [1, 2, 3]
BF16_EVAL_TOL = 0.01


def nchw(a):
    return t(a).permute(0, 3, 1, 2).contiguous()


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


# ---------------------------------------------------------------------------
# layout helpers and packed kernels
# ---------------------------------------------------------------------------

def test_space_to_depth_round_trip_and_layout_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 10, 3)).astype(np.float32)
    y = ppk.space_to_depth(nchw(x))
    assert y.shape == (2, 12, 4, 5)
    assert torch.equal(ppk.depth_to_space(y), nchw(x))
    # channel (p*2 + q)*C + c holds pixel (2i + p, 2j + q, c)
    assert float(y[0, 3 * 3 + 1, 1, 2]) == float(x[0, 3, 5, 1])
    assert np.array_equal(nhwc(y), np.asarray(jpk.space_to_depth(jnp.asarray(x))))


def test_phase_max_is_max_pool_and_phase_concat_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    got = ppk.phase_max(ppk.space_to_depth(nchw(x)))
    assert torch.equal(got, F.max_pool2d(nchw(x), 2, 2))
    assert np.array_equal(nhwc(got), np.asarray(fnn.max_pool(
        jnp.asarray(x), (2, 2), strides=(2, 2))))
    a = rng.normal(size=(2, 4, 4, 12)).astype(np.float32)
    b = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    assert np.array_equal(nhwc(ppk.phase_concat(nchw(a), nchw(b))),
                          np.asarray(jpk.phase_concat(jnp.asarray(a), jnp.asarray(b))))


def test_packed_kernels_equal_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    wp = ppk.pack_conv3_kernel(t(w))
    assert np.array_equal(wp.numpy(), np.asarray(jpk.pack_conv3_kernel(jnp.asarray(w))))
    assert wp.shape == (3, 3, 12, 20) and int((wp != 0).sum()) == 9 * 3 * 5 * 4
    wt = ppk.pack_convT_kernel(t(w))
    assert np.array_equal(wt.numpy(), np.asarray(jpk.pack_convT_kernel(jnp.asarray(w))))
    assert wt.shape == (2, 2, 3, 20)


def test_packed_convs_match_jax_and_the_unpacked_convs():
    """packed_conv3 (through cmconv: 12 -> 20 packed channels; and through
    F.conv2d: 16 -> 36), packed_convT and packed_1x1 against JAX's and the
    unpacked convs."""
    rng = np.random.default_rng(3)
    for ci, co in ((3, 5), (4, 9)):
        x = rng.normal(size=(2, 10, 12, ci)).astype(np.float32)
        w = rng.normal(size=(3, 3, ci, co)).astype(np.float32)
        b = rng.normal(size=(co,)).astype(np.float32)
        got = ppk.packed_conv3(ppk.space_to_depth(nchw(x)), t(w), t(b), None)
        ref = jpk.packed_conv3(jpk.space_to_depth(jnp.asarray(x)), jnp.asarray(w),
                               jnp.asarray(b), None)
        assert_close(nhwc(got), ref, 1e-5, f"packed_conv3 {ci}->{co}")
        plain = pcmconv.cmconv_plain(nchw(x), t(w), t(b))
        assert_close(ppk.depth_to_space(got), plain.numpy(), 1e-5, "vs unpacked")
    x = rng.normal(size=(2, 7, 9, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    got = ppk.packed_convT(nchw(x), t(w), t(b), None)
    ref = jpk.packed_convT(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), None)
    assert_close(nhwc(got), ref, 1e-5, "packed_convT")
    conv = punet.ConvTranspose(4, 6)
    bridge.load_flax_variables(conv, {"params": {"kernel": w, "bias": b}})
    assert_close(ppk.depth_to_space(got), conv(nchw(x)).detach().numpy(), 1e-5,
                 "vs ConvTranspose")
    x = rng.normal(size=(2, 5, 6, 12)).astype(np.float32)
    w = rng.normal(size=(1, 1, 3, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    assert_close(nhwc(ppk.packed_1x1(nchw(x), t(w), t(b), None)),
                 jpk.packed_1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), None),
                 1e-5, "packed_1x1")


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def variables():
    net = junet.PatchNeutralizer(n_filters=4, dropout=0.0)
    v = jax.jit(lambda k: net.init({"params": k}, jnp.zeros((1, 64, 64, 3)),
                                   False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(10)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(11).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


def port_packed(v, levels, dtype=None):
    net = ppk.PackedPatchNeutralizer(4, dropout=0.0, packed_levels=levels, dtype=dtype)
    bridge.load_flax_variables(net, v)
    return net


def _grads(net):
    """The parameter gradients of `net` as Flax params (by path)."""
    holder = punet.PatchNeutralizer(4, dropout=0.0)
    holder.load_state_dict(net.state_dict())
    with torch.no_grad():
        grads = dict(net.named_parameters())
        for name, p in holder.named_parameters():
            p.copy_(grads[name].grad)
    return dict(jax.tree_util.tree_leaves_with_path(bridge.torch_to_flax(holder)["params"]))


@pytest.mark.parametrize("levels", LEVELS)
def test_packed_unet_matches_jax(variables, images, levels):
    """fp32 eval and train forward (batch statistics), the moved statistics
    and every parameter gradient, and the bf16 eval forward, against JAX's
    PackedPatchNeutralizer at the same packed_levels."""
    v = variables
    target = np.random.default_rng(12).normal(size=images.shape).astype(np.float32)
    jnet = jpk.PackedPatchNeutralizer(n_filters=4, dropout=0.0, packed_levels=levels)
    jb = jpk.PackedPatchNeutralizer(n_filters=4, dropout=0.0, packed_levels=levels,
                                    dtype=jnp.bfloat16)

    def jfn(params, x):
        def loss(p):
            out, mut = jnet.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                                  True, mutable=["batch_stats"])
            return jnp.sum((out - target) ** 2), (out, mut["batch_stats"])
        (_, (train, stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        var = {"params": params, "batch_stats": v["batch_stats"]}
        return jnet.apply(var, x, False), train, stats, grads, jb.apply(var, x, False)

    ev, train, stats, grads, ev16 = jax.jit(jfn)(v["params"], jnp.asarray(images))
    net = port_packed(v, levels)
    assert_close(net(t(images)), ev, what="eval")
    out = net(t(images), training=True)
    assert_close(out, train, what="train")
    mine = dict(jax.tree_util.tree_leaves_with_path(bridge.torch_to_flax(net)["batch_stats"]))
    for path, r in jax.tree_util.tree_leaves_with_path(stats):
        assert_close(mine[path], r, what=jax.tree_util.keystr(path))
    torch.sum((out - t(target)) ** 2).backward()
    flat = _grads(net)
    all_port, all_ref = [], []
    for path, r in jax.tree_util.tree_leaves_with_path(grads):
        all_port.append(flat[path].ravel())
        all_ref.append(np.asarray(r).ravel())
        if path[-1].key == "bias" and path[-2].key in ("cnv1", "cnv2", "conv3"):
            continue  # true gradient 0: rounding noise only
        assert cosine(flat[path], r) >= 0.9999, jax.tree_util.keystr(path)
    assert cosine(np.concatenate(all_port), np.concatenate(all_ref)) >= 0.9999
    out16 = port_packed(v, levels, torch.bfloat16)(t(images))
    assert out16.dtype == torch.float32 and ev16.dtype == jnp.float32
    assert_close(out16, ev16, BF16_EVAL_TOL, "bf16 eval")


@pytest.mark.parametrize("levels", LEVELS)
def test_packed_unet_matches_the_ports_unpacked_unet(variables, images, levels):
    """The same weights through the port's packed and unpacked modules:
    eval and train outputs, moved statistics, parameter gradients."""
    v = variables
    ref_net = punet.PatchNeutralizer(4, dropout=0.0)
    bridge.load_flax_variables(ref_net, v)
    net = port_packed(v, levels)
    with torch.no_grad():
        assert_close(net(t(images)), ref_net(t(images)).numpy(), what="eval")
    outs = []
    for m in (ref_net, net):
        out = m(t(images), training=True)
        torch.sum(out * out).backward()
        outs.append(out.detach().numpy())
    assert_close(outs[1], outs[0], what="train")
    for (name, a), b in zip(ref_net.state_dict().items(), net.state_dict().values()):
        if "running" in name:
            assert_close(b, a.numpy(), what=name)
    ref_g, got_g = _grads(ref_net), _grads(net)
    for path, r in ref_g.items():
        if not (path[-1].key == "bias" and path[-2].key in ("cnv1", "cnv2", "conv3")):
            assert cosine(got_g[path], r) >= 0.999, jax.tree_util.keystr(path)
    keys = sorted(ref_g, key=jax.tree_util.keystr)
    assert cosine(np.concatenate([got_g[k].ravel() for k in keys]),
                  np.concatenate([ref_g[k].ravel() for k in keys])) >= 0.9999


@pytest.mark.parametrize("levels", LEVELS)
def test_packed_unet_float64_gradients_match_the_unpacked(variables, images, levels):
    """chip_smoke.py phase 9c's check of the function: both modules in
    float64 (their 3x3 convs as float64 `F.conv2d`s), every parameter
    gradient of a train-mode pass within PACKED_GRAD_F64_TOL of its largest
    entry, the gate BatchNorm's one-channel scale and bias included (in
    float32 each is one sum that may cancel)."""
    import chip_smoke

    v = variables
    ref_net = punet.PatchNeutralizer(4, dropout=0.0)
    bridge.load_flax_variables(ref_net, v)
    grads = []
    for m in (ref_net, port_packed(v, levels)):
        m = m.to(torch.float64)
        with chip_smoke.Float64Convs():
            out = m(t(images).double(), training=True)
            torch.sum(out * out).backward()
        grads.append(dict((k, p.grad) for k, p in m.named_parameters()))
    ref_g, got_g = grads
    assert "deconv0.attention.bn3.bias" in ref_g
    for k, r in ref_g.items():
        if k.endswith(("cnv1.bias", "cnv2.bias", "conv3.bias")):
            continue  # a true gradient of 0: rounding noise only
        assert r.dtype == got_g[k].dtype == torch.float64, k
        err = float((got_g[k] - r).abs().max() / r.abs().max())
        assert err <= chip_smoke.PACKED_GRAD_F64_TOL, (k, err)


def test_packed_unet_has_the_unpacked_parameters_and_fresh_init():
    """The same state_dict keys and shapes, and the same seeded draws."""
    a, b = punet.PatchNeutralizer(4), ppk.PackedPatchNeutralizer(4, packed_levels=3)
    init_weights(a, torch.Generator().manual_seed(0))
    init_weights(b, torch.Generator().manual_seed(0))
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(ValueError, match="packed_levels"):
        ppk.PackedPatchNeutralizer(4, packed_levels=4)


def test_packed_dropout_path_runs_and_keeps_its_rate(variables, images):
    net = ppk.PackedPatchNeutralizer(4, dropout=0.2, packed_levels=3)
    bridge.load_flax_variables(net, variables)
    out = net(t(images), training=True, generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(out).all() and float(out.detach().abs().max()) <= 1.0
    x = torch.ones((4, 32, 32, 32))
    kept = punet.dropout(ppk.space_to_depth(x), 0.2,
                         torch.Generator().manual_seed(3)) != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
