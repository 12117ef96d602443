"""The port's detector forward against `EfficientDetNet.apply` of the JAX package.

The Flax variables (with BatchNorm statistics, scales and biases redrawn so
that every op matters) go through `ckpt/bridge.py` into the port. Backbone
endpoints, BiFPN outputs and head outputs must agree within
2e-4 * max(1, max|ref|), in fp32, on the tiny lite0 at 64 px, at 96 px (the
non-integer nearest upsample) and on a tiny d0 (swish, squeeze-excite,
`fastattn` fusion). Unit tests pin the asymmetric SAME padding, the -inf
max-pool and the nearest-upsample index table. With `mixed_precision` the
port's bf16 net is held to JAX's bf16 net within BF16_VS_JAX_TOL and to its
own float32 net within BF16_VS_FP32_ABS (the reasons beside them).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from mladversarialobjectdetection_tpu import config as jconfig
from mladversarialobjectdetection_tpu.models import bifpn as jbifpn
from mladversarialobjectdetection_tpu.models import efficientdet as jdet
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.ckpt.bridge import load_flax_variables
from mladversarialobjectdetection_torch.models import bifpn as pbifpn
from mladversarialobjectdetection_torch.models import efficientdet as pdet
from mladversarialobjectdetection_torch.models import efficientnet as peff
from mladversarialobjectdetection_torch.models.init import init_weights


def _tiny_d0():
    cfg = jconfig.get_efficientdet_config("efficientdet-d0")
    cfg.image_size = 64
    cfg.fpn_num_filters = 16
    cfg.fpn_cell_repeats = 1
    cfg.box_class_repeats = 1
    return cfg


def _tiny_variants():
    """The config options lite and d0 leave at their defaults."""
    cfg = tiny_config(64)
    cfg.update({"fpn_name": "qufpn", "fpn_weight_method": "channel_fastattn",
                "conv_after_downsample": True, "conv_bn_act_pattern": True,
                "separable_conv": False, "apply_bn_for_resampling": False,
                "survival_prob": 0.8, "act_type": "swish"})
    return cfg


CONFIGS = {"lite0_64": lambda: tiny_config(64),
           "lite0_96": lambda: tiny_config(96),
           "d0_64": _tiny_d0,
           "variants_64": _tiny_variants}


def _redraw(variables, seed):
    """Random BN statistics, scales, biases and fusion weights."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name in ("var", "scale", "WSM"):
            return jnp.asarray(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        if name in ("mean", "bias"):
            return jnp.asarray(rng.uniform(-0.3, 0.3, shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(JAX net, variables, port net, images) for one config."""
    cfg = CONFIGS[request.param]()
    net = jdet.EfficientDetNet(jdet.spec_from_config(cfg))
    size = cfg.image_size
    images = np.random.RandomState(7).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    variables = jax.jit(net.init, static_argnames=("training",))(
        {"params": jax.random.PRNGKey(0)}, images[:1], training=False)
    variables = _redraw(variables, seed=1)
    pnet = pdet.EfficientDetNet(pdet.spec_from_config(
        pconfig.Config(cfg.as_dict()))).eval()
    load_flax_variables(pnet, variables)
    return net, variables, pnet, images


def _assert_close(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        assert out.shape == ref.shape
        tol = 2e-4 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


def _nhwc(tensors):
    return [t.permute(0, 2, 3, 1).numpy() for t in tensors]


def _jax_intermediates(net, variables, images, module):
    _, state = jax.jit(lambda v, x: net.apply(
        v, x, False, capture_intermediates=lambda m, _: m.name == module,
        mutable=["intermediates"]))(variables, images)
    return state["intermediates"][module]["__call__"][0]


def test_backbone_endpoints_match(pair):
    net, variables, pnet, images = pair
    ref = _jax_intermediates(net, variables, images, "backbone")
    with torch.no_grad():
        out = pnet.backbone(torch.from_numpy(images).permute(0, 3, 1, 2))
    _assert_close(_nhwc(out), ref)


def test_bifpn_outputs_match(pair):
    net, variables, pnet, images = pair
    ref = _jax_intermediates(net, variables, images, "fpn_cells")
    with torch.no_grad():
        out = pnet.fpn_cells(pnet.pyramid(
            torch.from_numpy(images).permute(0, 3, 1, 2)))
    _assert_close(_nhwc(out), ref)


def test_head_outputs_match(pair):
    net, variables, pnet, images = pair
    ref_cls, ref_box = jax.jit(lambda v, x: net.apply(v, x, False))(
        variables, images)
    with torch.no_grad():
        out_cls, out_box = pnet(torch.from_numpy(images))
    _assert_close([o.numpy() for o in out_cls], ref_cls)
    _assert_close([o.numpy() for o in out_box], ref_box)


@pytest.mark.parametrize("kernel,size,pads", [(3, 64, (0, 1)), (5, 64, (1, 2)),
                                              (3, 33, (1, 1)), (5, 9, (2, 2))])
def test_same_padding_stride2(kernel, size, pads):
    """k3/s2 and k5/s2 SAME convs pad asymmetrically at even sizes."""
    assert peff.same_pads(size, kernel, 2) == pads
    rng = np.random.RandomState(3)
    x = rng.normal(size=(1, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 4, 6)).astype(np.float32)
    ref = fnn.Conv(6, (kernel, kernel), strides=(2, 2), use_bias=False).apply(
        {"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    conv = peff.Conv2d(4, 6, kernel, 2, bias=False, init="fan_out_normal")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        out = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    _assert_close(_nhwc([out]), [ref])


@pytest.mark.parametrize("size,target", [(64, 32), (10, 5), (7, 4), (3, 2), (9, 3)])
def test_max_pool_pads_with_neg_inf(size, target):
    """The SAME max-pool pads with -inf, so all-negative maps stay negative."""
    x = -np.random.RandomState(4).uniform(1, 2, (1, size, size, 3)).astype(
        np.float32)
    ref = jbifpn._max_pool_to(jnp.asarray(x), target, target)
    out = pbifpn._max_pool_to(torch.from_numpy(x).permute(0, 3, 1, 2),
                              target, target)
    assert float(out.max()) < 0
    np.testing.assert_array_equal(_nhwc([out])[0], np.asarray(ref))


# (2, 3) and (4, 7) are reached at 96 and 448 px; the rest are pairs where
# the naive float32 formula or torch's nearest modes pick another row
@pytest.mark.parametrize("n_in,n_out", [(2, 3), (4, 7), (10, 25), (2, 41),
                                        (6, 37), (14, 49), (18, 57), (5, 9)])
def test_nearest_upsample_index_table(n_in, n_out):
    """The index table equals jax.image.resize('nearest')."""
    ref = jax.image.resize(jnp.arange(n_in, dtype=jnp.float32), (n_out,),
                           "nearest")
    np.testing.assert_array_equal(pbifpn.nearest_source_index(n_in, n_out),
                                  np.asarray(ref).astype(np.int64))


def test_nearest_upsample_non_integer_matches():
    x = np.random.RandomState(5).normal(size=(1, 2, 3, 4)).astype(np.float32)
    ref = jbifpn._nearest_upsample_to(jnp.asarray(x), 3, 7)
    out = pbifpn._nearest_upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 7)
    np.testing.assert_array_equal(_nhwc([out])[0], np.asarray(ref))


@pytest.mark.parametrize("method", ["sum", "attn", "fastattn", "channel_attn",
                                    "channel_fastattn"])
def test_fnode_weight_methods(method):
    """Weighted fusion of one BiFPN node, with fusion weights of both signs."""
    rng = np.random.RandomState(6)
    feats = [rng.normal(size=(2, 4, 4, 8)).astype(np.float32) for _ in range(3)]
    node = jbifpn.FNode(0, (0, 2), 8, (4, 4), weight_method=method)
    variables = node.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats],
                          False)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(rng.uniform(-0.5, 1.5, np.shape(leaf)),
                                       jnp.float32)
        if path[-1].key == "WSM" else leaf, variables)
    ref = node.apply(variables, [jnp.asarray(f) for f in feats], False)
    pnode = pbifpn.FNode((0, 2), [(8, (4, 4))] * 3, 8, (4, 4),
                         weight_method=method).eval()
    load_flax_variables(pnode, variables)
    with torch.no_grad():
        out = pnode([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    _assert_close(_nhwc([out]), [ref])


def test_unported_options_raise():
    """packed_entry is ported (tests/test_torch_efficientnet_packed.py): its
    net has the unpacked one's state_dict; unknown heads still raise."""
    spec = pdet.spec_from_config(pconfig.Config(tiny_config().as_dict()))
    packed, plain = pdet.EfficientDetNet(spec, packed_entry=2), pdet.EfficientDetNet(spec)
    assert {k: v.shape for k, v in packed.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    with pytest.raises(ValueError, match="heads"):
        pdet.EfficientDetNet(spec._replace(heads=("keypoints",)))


# ---------------------------------------------------------------------------
# bf16 mixed precision
# ---------------------------------------------------------------------------

# The port's bf16 net against JAX's bf16 `EfficientDetNet`, on the head
# outputs (float32 in both), of max(1, max|ref|). The two are not the same
# function at bf16: JAX's Flax `MBConvBlock` rounds after the expand conv,
# its BatchNorm and its activation, where the port's fused block (the Pallas
# kernels' function) rounds e once; and XLA and ATen round bf16 convolutions
# and elementwise ops at other points. Measured on the CPU: at most 0.0235
# (lite0 at 96 px), where JAX's own bf16 net is 0.048 away from its float32
# one in absolute terms.
BF16_VS_JAX_TOL = 0.05
# bf16 against float32 logits, absolute: tests/test_heads_extra.py's bound
# for JAX's own two precisions
BF16_VS_FP32_ABS = 0.15
# The input gradient of a smooth function of the head outputs (a seeded
# cotangent on every class and box output; no max over anchors, no TV
# term): the port's bf16 net against JAX's bf16 net and against JAX's
# float32 net, by cosine. Measured on the CPU: 0.9853 / 0.9995 / 0.9988
# against JAX's bf16 (lite0_64, d0_64, variants_64), where JAX's own bf16
# gradient lies at 0.9913 / 0.9996 / 0.9979 of its float32 one, and the
# port's bf16 at 0.9842 / 0.9996 / 0.9979 of its float32 one. A zero or
# sign-flipped victim gradient reads 0 or below.
BF16_INPUT_GRAD_COS = 0.97


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module", params=["lite0_64", "d0_64", "variants_64"])
def bf16_pair(request):
    """(JAX bf16 head outputs, port float32 net, port bf16 net, images,
    (cotangents of the head outputs, JAX's float32 input gradient, JAX's
    bf16 one)): one set of redrawn Flax variables in all of them."""
    cfg = CONFIGS[request.param]()
    size = cfg.image_size
    images = np.random.RandomState(7).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    net = jdet.EfficientDetNet(jdet.spec_from_config(cfg))
    variables = _redraw(jax.jit(net.init, static_argnames=("training",))(
        {"params": jax.random.PRNGKey(0)}, images[:1], training=False), seed=1)
    rng = np.random.RandomState(3)
    cots = [rng.normal(size=o.shape).astype(np.float32)
            for o in jax.tree_util.tree_leaves(jax.eval_shape(
                lambda x: net.apply(variables, x, False), images))]
    grads = []
    for mixed in (False, True):
        cfg.mixed_precision = mixed
        jnet = jdet.EfficientDetNet(jdet.spec_from_config(cfg))
        def out_and_grad(v, x, c, _net=jnet):
            out, vjp = jax.vjp(lambda xx: _net.apply(v, xx, False), x)
            return out, vjp(jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(out), c))[0]

        ref, grad = jax.jit(out_and_grad)(variables, images, cots)
        grads.append(np.asarray(grad))
    nets = []
    for mixed in (False, True):
        d = dict(cfg.as_dict(), mixed_precision=mixed)
        pnet = pdet.EfficientDetNet(pdet.spec_from_config(pconfig.Config(d))).eval()
        load_flax_variables(pnet, variables)
        nets.append(pnet)
    return ref, nets[0], nets[1], images, (cots, *grads)


def test_bf16_net_matches_jax_bf16(bf16_pair):
    ref, _, pnet, images, _ = bf16_pair
    with torch.no_grad():
        out_cls, out_box = pnet(torch.from_numpy(images))
    assert all(o.dtype == torch.float32 for o in out_cls + out_box)
    for outs, refs in ((out_cls, ref[0]), (out_box, ref[1])):
        assert len(outs) == len(refs)
        for out, want in zip(outs, refs):
            want = np.asarray(want)
            assert want.dtype == np.float32 and out.shape == want.shape
            tol = BF16_VS_JAX_TOL * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=tol)


def test_bf16_net_close_to_its_fp32(bf16_pair):
    """bf16 activations: the backbone's and the heads' activations are bf16,
    the parameters stay float32, and the logits stay within 0.15 of the
    float32 net's."""
    _, net32, net16, images, _ = bf16_pair
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    x = torch.from_numpy(images)
    with torch.no_grad():
        a, b = net32(x), net16(x)
        endpoints = net16.backbone(x.to(torch.bfloat16).permute(0, 3, 1, 2))
    assert all(e.dtype == torch.bfloat16 for e in endpoints)
    diff = max(float((p - q).abs().max()) for p, q in zip(a[0] + a[1], b[0] + b[1]))
    assert 0.0 < diff < BF16_VS_FP32_ABS


def test_bf16_input_gradient_matches_jax(bf16_pair):
    """The bf16 victim's input gradient, which the attack follows: through
    the bf16 backbone (the fused blocks' bf16 dx), BiFPN and heads, against
    `jax.vjp` of JAX's bf16 net and of its float32 net on one cotangent."""
    _, _, net16, images, (cots, jgrad32, jgrad16) = bf16_pair
    net16.requires_grad_(False)
    x = torch.from_numpy(images).requires_grad_(True)
    out_cls, out_box = net16(x)
    outs = list(out_cls) + list(out_box)
    assert [tuple(o.shape) for o in outs] == [c.shape for c in cots]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    grad = x.grad
    assert grad.dtype == torch.float32 and bool(torch.isfinite(grad).all())
    assert _cosine(grad, jgrad16) >= BF16_INPUT_GRAD_COS
    assert _cosine(grad, jgrad32) >= BF16_INPUT_GRAD_COS


def test_conv_casts_its_weights_once_per_dtype():
    """A frozen bf16 `Conv2d` casts its kernel and bias once and recasts
    them when a parameter changes; one whose weights train casts with
    autograd on every call, so that the weights get their gradient."""
    conv = peff.Conv2d(4, 6, 3, init="fan_out_normal")
    conv.compute_dtype = torch.bfloat16
    x = torch.from_numpy(np.random.RandomState(0).normal(size=(1, 4, 8, 8)).astype(
        np.float32))
    conv.requires_grad_(False)
    y = conv(x)
    w, b = conv._cast[1:]
    assert y.dtype == w.dtype == b.dtype == torch.bfloat16
    assert torch.equal(conv(x), y) and conv._cast[1] is w  # reused
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert conv(x).dtype == torch.bfloat16 and conv._cast[1] is not w
    assert torch.equal(conv._cast[1], conv.weight.to(torch.bfloat16))
    conv.requires_grad_(True)
    conv(x).float().sum().backward()
    assert conv.weight.grad is not None and conv.bias.grad is not None


def test_seeded_init():
    spec = pdet.spec_from_config(pconfig.Config(tiny_config().as_dict()))
    nets = [init_weights(pdet.EfficientDetNet(spec),
                         torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    s0, s0b, s1 = (n.state_dict() for n in nets)
    key = "backbone.stem_conv.weight"
    assert torch.equal(s0[key], s0b[key]) and not torch.equal(s0[key], s1[key])
    bias = s0["class_net.predict.pw.bias"]
    assert torch.allclose(bias, torch.full_like(bias, -np.log(99.0)))
    assert torch.all(s0["class_net.bn_0_l0.running_var"] == 1)
    # BiFPN pointwise convs: fan_in truncated normal, |w| <= 2 std
    w = s0["fpn_cells.cell_0.fnode0.conv_pw.weight"]
    std = np.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
