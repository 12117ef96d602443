"""The port's U-Net and its channel-major conv against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
U-Net's weights are the JAX package's, carried over by `ckpt/bridge.py`.
Tolerances (the ROADMAP rule):

- fp32 forward outputs within 2e-4 * max(1, max|ref|) (convolutions and
  reductions sum in another order);
- gradients at cosine >= 0.9999;
- BatchNorm running statistics within 2e-4 of their scale;
- the bridge's round trip and the dropout masks exactly.

The plain `cmconv` is held against the archived Pallas TPU kernel
(`tools/proto_cmconv.py`) in interpret mode. That kernel unrolls Co * C * 9
shifted multiply-adds in Python and computes each output channel on its own
(proto_cmconv.py:30-38), so it is run on the first two output channels of
each shape: its trace time grows with Co * C (about 50 s for 32 -> 16 on all
outputs, on one CPU core) while the function of each output channel does
not depend on Co. All outputs are held against `lax.conv_general_dilated` and
`F.conv2d`.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from jax import lax

from mladversarialobjectdetection_tpu.models import unet as junet
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.models import unet as punet
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.ops import cmconv as pcmconv
from mladversarialobjectdetection_torch.ops import cmconv_cuda

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import proto_cmconv  # noqa: E402  the archived TPU kernel

TOL = 2e-4
PATH_SHAPES = [(3, 8), (8, 8), (8, 16), (16, 16), (32, 16), (16, 8)]


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def assert_close(port, ref, tol=TOL, what=""):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def lax_conv(x, w, b=None):
    """NCHW x, HWIO w: the XLA convolution the JAX U-Net runs."""
    y = lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                 dimension_numbers=("NCHW", "HWIO", "NCHW"))
    return y if b is None else y + b[None, :, None, None]


# ---------------------------------------------------------------------------
# cmconv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,co", PATH_SHAPES, ids=[f"{c}to{co}" for c, co in PATH_SHAPES])
def test_cmconv_plain_matches_tpu_kernel_and_convs(c, co):
    rng = np.random.default_rng(c * 100 + co)
    x = rng.normal(size=(2, c, 16, 12)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, co)) * 0.3).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    out = pcmconv.cmconv_plain(t(x), t(w))
    assert_close(out, lax_conv(jnp.asarray(x), jnp.asarray(w)), what="lax")
    assert_close(out, F.conv2d(t(x), t(w).permute(3, 2, 0, 1), padding=1),
                 what="F.conv2d")
    assert_close(pcmconv.cmconv_plain(t(x), t(w), t(b)),
                 lax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
                 what="bias")
    k = 2
    pallas = jax.jit(functools.partial(proto_cmconv.cmconv, th=8, interpret=True))
    assert_close(out[:, :k], pallas(jnp.asarray(x), jnp.asarray(w[..., :k])),
                 what="pallas")


def test_cmconv_gradients_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 10, 14)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 16, 8)) * 0.3).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    g = rng.normal(size=(2, 8, 10, 14)).astype(np.float32)
    _, vjp = jax.vjp(lax_conv, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = vjp(jnp.asarray(g))
    xs, ws, bs = (t(a).requires_grad_(True) for a in (x, w, b))
    pcmconv.cmconv(xs, ws, bs).backward(t(g))
    for name, port, r in zip(("dx", "dw", "db"), (xs.grad, ws.grad, bs.grad), ref):
        assert cosine(port.numpy(), r) >= 0.9999, name
        assert_close(port, r, what=name)


def test_cmconv_gradcheck_float64():
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
            for s in ((2, 3, 5, 6), (3, 3, 3, 4), (4,))]
    assert torch.autograd.gradcheck(pcmconv.cmconv, args)
    x, w, _ = args
    assert torch.autograd.gradcheck(lambda a, v: pcmconv.cmconv(a, v), (x, w))


def test_cmconv_input_gradient_is_the_flipped_conv():
    """dx is the forward function on dy with w flipped and C / Co swapped."""
    rng = np.random.default_rng(7)
    x = t(rng.normal(size=(1, 8, 9, 7))).requires_grad_(True)
    w = t(rng.normal(size=(3, 3, 8, 16)))
    g = t(rng.normal(size=(1, 16, 9, 7)))
    pcmconv.cmconv(x, w).backward(g)
    flipped = pcmconv.cmconv_plain(g, w.flip(0, 1).transpose(2, 3))
    assert torch.equal(x.grad, flipped)


def test_cmconv_kernel_wrapper_refuses_cpu_tensors():
    """Checked before any build: dtype first, then the device."""
    before = cmconv_cuda.LAUNCHES
    x, w = torch.zeros((1, 8, 4, 4)), torch.zeros((3, 3, 8, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        cmconv_cuda.cmconv3x3_cuda(x.double(), w.double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        cmconv_cuda.cmconv3x3_cuda(x, w)
    with pytest.raises(ValueError, match="no cmconv for device"):
        pcmconv.cmconv(x.to("meta"), w.to("meta"))
    assert cmconv_cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# layers with Flax semantics
# ---------------------------------------------------------------------------

def test_conv_transpose_matches_flax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 5, 6)).astype(np.float32)           # NHWC
    layer = fnn.ConvTranspose(4, (3, 3), strides=(2, 2))
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1, v)   # bias != 0
    ref = np.asarray(layer.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    port = punet.ConvTranspose(6, 4)
    bridge.load_flax_variables(port, v)
    xc = t(x).permute(0, 3, 1, 2)
    assert_close(port(xc), ref, what="ConvTranspose")
    # the hazard: torch's own SAME-like transposed conv is another function
    k = t(v["params"]["kernel"])
    naive = F.conv_transpose2d(xc, k.permute(2, 3, 0, 1), t(v["params"]["bias"]),
                               stride=2, padding=1, output_padding=1)
    assert float((naive - t(ref)).abs().max()) > 1e-2


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_batchnorm_matches_flax(training):
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(3, 6, 7, 5)) * 2.0 + 1.5).astype(np.float32)  # NHWC
    layer = fnn.BatchNorm(use_running_average=not training, epsilon=1e-3,
                          momentum=0.99)
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": rng.uniform(0.5, 2, 5).astype(np.float32),
                    "bias": rng.normal(size=5).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=5).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 5).astype(np.float32)}}
    ref, mutated = layer.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = punet.BatchNorm(5)
    bridge.load_flax_variables(port, v)
    y = port(t(x).permute(0, 3, 1, 2), training)
    assert_close(y.permute(0, 2, 3, 1), ref, what="y")
    stats = bridge.torch_to_flax(port)["batch_stats"]
    for k in ("mean", "var"):
        assert_close(stats[k], mutated["batch_stats"][k], what=k)
    if not training:
        assert np.array_equal(stats["var"], v["batch_stats"]["var"])


def test_dropout_keeps_and_scales_deterministically():
    x = torch.ones((4, 8, 32, 32))
    a = punet.dropout(x, 0.2, torch.Generator().manual_seed(3))
    b = punet.dropout(x, 0.2, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.equal(a[kept], torch.full_like(a[kept], 1.0 / 0.8))
    assert not torch.equal(a, punet.dropout(x, 0.2, torch.Generator().manual_seed(4)))


# ---------------------------------------------------------------------------
# the U-Net
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_pair():
    """(JAX PatchNeutralizer, its variables, the port's with those weights),
    n_filters 4, dropout 0 on both sides, BatchNorm statistics moved off
    their initial values."""
    jnet = junet.PatchNeutralizer(n_filters=4, dropout=0.0)
    v = jax.jit(lambda k: jnet.init({"params": k}, jnp.zeros((1, 64, 64, 3)),
                                    False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(10)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    pnet = punet.PatchNeutralizer(4, dropout=0.0)
    bridge.load_flax_variables(pnet, v)
    return jnet, v, pnet


@pytest.fixture(scope="module")
def unet_images():
    return np.random.default_rng(11).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


def test_unet_eval_forward_matches_jax(unet_pair, unet_images):
    jnet, v, pnet = unet_pair
    ref = jax.jit(lambda x: jnet.apply(v, x, False))(jnp.asarray(unet_images))
    out = pnet(t(unet_images))
    assert_close(out, ref, what="eval")


def test_unet_train_forward_and_batch_stats_match_jax(unet_pair, unet_images):
    jnet, v, _ = unet_pair
    ref, mutated = jax.jit(lambda x: jnet.apply(
        v, x, True, mutable=["batch_stats"]))(jnp.asarray(unet_images))
    pnet = punet.PatchNeutralizer(4, dropout=0.0)
    bridge.load_flax_variables(pnet, v)
    out = pnet(t(unet_images), training=True)
    assert_close(out, ref, what="train")
    got = bridge.torch_to_flax(pnet)["batch_stats"]
    want = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, ref_stat in jax.tree_util.tree_leaves_with_path(want):
        assert_close(flat_got[path], ref_stat, what=jax.tree_util.keystr(path))


def test_unet_parameter_gradients_match_jax(unet_pair, unet_images):
    jnet, v, _ = unet_pair
    target = np.random.default_rng(12).normal(size=unet_images.shape).astype(np.float32)

    def jloss(params):
        out, _ = jnet.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(unet_images), True,
                            mutable=["batch_stats"])
        return jnp.sum((out - target) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(v["params"])
    pnet = punet.PatchNeutralizer(4, dropout=0.0)
    bridge.load_flax_variables(pnet, v)
    torch.sum((pnet(t(unet_images), training=True) - t(target)) ** 2).backward()
    grads = {k: p.grad for k, p in pnet.named_parameters()}
    flat = dict(jax.tree_util.tree_leaves_with_path(
        bridge.torch_to_flax(_with_values(pnet, grads))["params"]))
    ref_flat = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jgrads))
    all_port, all_ref = [], []
    for path, r in ref_flat:
        all_port.append(flat[path].ravel())
        all_ref.append(r.ravel())
        # the bias of a conv that feeds a BatchNorm (cnv1, cnv2, conv3) has
        # an exactly-zero gradient: only rounding noise is left of it
        if path[-1].key == "bias" and path[-2].key in ("cnv1", "cnv2", "conv3"):
            continue
        assert cosine(flat[path], r) >= 0.9999, jax.tree_util.keystr(path)
    assert cosine(np.concatenate(all_port), np.concatenate(all_ref)) >= 0.9999


def _with_values(module, values):
    """A copy of `module` whose parameters hold `values` (by name)."""
    out = punet.PatchNeutralizer(4, dropout=0.0)
    out.load_state_dict(module.state_dict())
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(values[name])
    return out


def test_cmconv_runs_the_small_blocks_forward_and_backward(monkeypatch):
    """n_filters 8: the 3x3 convs of conv0, conv1, deconv2 and deconv3 (at
    most 16 filters) go through `cmconv`: 8 forward calls, and 7 input
    gradients in a train step (conv0's first conv sees the image, which
    needs none)."""
    net = punet.PatchNeutralizer(8)
    init_weights(net, torch.Generator().manual_seed(0))
    small = sorted(n for n, m in net.named_modules() if isinstance(m, punet.CMConv2d))
    assert small == sorted(f"{b}.cnv{j}" for b in ("conv0", "conv1",
                                                   "deconv2.convblock",
                                                   "deconv3.convblock")
                           for j in (1, 2))
    calls = []
    orig = pcmconv._conv

    def spy(x, w, bias):
        calls.append((x.shape[1], w.shape[3]))
        return orig(x, w, bias)

    monkeypatch.setattr(pcmconv, "_conv", spy)
    out = net(torch.rand((1, 32, 32, 3)), training=True,
              generator=torch.Generator().manual_seed(1))
    assert calls == [(3, 8), (8, 8), (8, 16), (16, 16), (32, 16), (16, 16),
                     (16, 8), (8, 8)]
    out.sum().backward()
    assert len(calls) == 15


def test_seeded_init_matches_flax_families(unet_pair):
    """He truncated normal for ConvBlock / transposed / output kernels,
    lecun for the attention convs: the per-tensor std within 15% of the
    Flax-initialised one, zero biases, unit BatchNorm."""
    _, v, _ = unet_pair
    pnet = punet.PatchNeutralizer(4)
    init_weights(pnet, torch.Generator().manual_seed(0))
    mine = bridge.torch_to_flax(pnet)["params"]
    ref = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    for path, a in jax.tree_util.tree_leaves_with_path(mine):
        name = path[-1].key
        if name == "kernel" and a.size >= 64:
            assert abs(a.std() / ref[path].std() - 1) < 0.15, jax.tree_util.keystr(path)
        elif name == "bias":
            assert not a.any()
        elif name == "scale":
            assert np.all(a == 1)


def test_bridge_round_trip_is_exact(unet_pair):
    _, v, pnet = unet_pair
    back = bridge.torch_to_flax(pnet)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def _copy(tree):
    return {k: _copy(x) if isinstance(x, dict) else x for k, x in tree.items()}


def test_bridge_raises_on_missing_or_extra_unet_key(unet_pair):
    _, v, _ = unet_pair
    broken = _copy(v)
    del broken["batch_stats"]["conv0"]["bn1"]["var"]
    with pytest.raises(KeyError, match="missing"):
        bridge.load_flax_variables(punet.PatchNeutralizer(4), broken)
    broken = _copy(v)
    broken["params"]["deconv0"]["extra"] = {"kernel": np.zeros((3, 3, 4, 4))}
    with pytest.raises(KeyError, match="unused"):
        bridge.load_flax_variables(punet.PatchNeutralizer(4), broken)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _remat_step(remat, dtype=None, seed=3):
    """One train forward and backward at dropout .2 from seeded weights and
    a seeded mask generator: (output, parameter gradients, running stats)."""
    net = punet.PatchNeutralizer(2, remat=remat, dtype=dtype)
    init_weights(net, torch.Generator().manual_seed(0))
    x = t(np.random.default_rng(13).uniform(-1, 1, (2, 16, 16, 3)))
    out = net(x, training=True, generator=torch.Generator().manual_seed(seed))
    torch.sum(out * out).backward()
    return (out.detach(), [p.grad for p in net.parameters()],
            [b.clone() for b in net.buffers()])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_remat_is_bit_equal_with_dropout_on(dtype):
    """remat recomputes every ConvBlock and DeconvBlock in the backward pass:
    with dropout on and the same generator seed, the output, every parameter
    gradient and the running statistics after the step are bit-equal."""
    ref, got = _remat_step(False, dtype), _remat_step(True, dtype)
    assert torch.equal(got[0], ref[0])
    assert len(got[1]) == len(ref[1]) and all(
        torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
    assert not torch.equal(ref[0], _remat_step(False, dtype, seed=4)[0])


def test_remat_recompute_replays_masks_and_moves_no_statistics(monkeypatch):
    """The two hazards, shown with a naive checkpoint: a recompute that draws
    from the live generator gets new masks and a wrong gradient, and one
    that runs BatchNorm in train mode moves the statistics twice: the test
    above fails on both."""
    from torch.utils.checkpoint import checkpoint

    ref = _remat_step(False)

    def naive(block, tensors, training, generator):
        return checkpoint(lambda *a: block(*a, training, generator), *tensors,
                          use_reentrant=False)

    monkeypatch.setattr(punet, "remat_call", naive)
    bad = _remat_step(True)
    assert torch.equal(bad[0], ref[0])  # the forward is the same
    assert not all(torch.equal(a, b) for a, b in zip(bad[1], ref[1]))
    assert not all(torch.equal(a, b) for a, b in zip(bad[2], ref[2]))


def test_remat_matches_jax_remat(unet_pair, unet_images):
    """JAX's `remat` U-Net and the port's, dropout 0: the train forward and
    the parameter gradients as without remat (the fp32 tolerances)."""
    _, v, _ = unet_pair
    jnet = junet.PatchNeutralizer(n_filters=4, dropout=0.0, remat=True)

    def jloss(params):
        out, _ = jnet.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(unet_images), True, mutable=["batch_stats"])
        return jnp.sum(out * out), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    pnet = punet.PatchNeutralizer(4, dropout=0.0, remat=True)
    bridge.load_flax_variables(pnet, v)
    out = pnet(t(unet_images), training=True)
    assert_close(out, ref, what="remat train")
    torch.sum(out * out).backward()
    _assert_grads_match(pnet, jgrads, 0.9999)


# ---------------------------------------------------------------------------
# bf16: cmconv at the TPU kernel's own signature, the U-Net
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -7  # one bf16 ulp of a value below 2^k is 2^(k-8): <= 2^-7 of scale
BF16_PAIRS = [(3, 8), (8, 16), (16, 8)]


def bf16_np(a):
    """numpy float32 values rounded to bf16, as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("c,co", BF16_PAIRS, ids=[f"{c}to{co}" for c, co in BF16_PAIRS])
def test_cmconv_bf16_plain_matches_tpu_kernel(c, co):
    """x bf16, w float32 (any float32 values, as the TPU kernel takes them):
    the plain version against the Pallas kernel in interpret mode, within
    one bf16 ulp of the output's scale; its output is bf16."""
    rng = np.random.default_rng(c * 10 + co)
    x = bf16_np(rng.normal(size=(2, c, 16, 12)))
    w = (rng.normal(size=(3, 3, c, co)) * 0.3).astype(np.float32)
    out = pcmconv.cmconv_plain(t(x).bfloat16(), t(w))
    assert out.dtype == torch.bfloat16
    k = 2
    pallas = jax.jit(functools.partial(proto_cmconv.cmconv, th=8, interpret=True))
    ref = pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w[..., :k]))
    assert ref.dtype == jnp.bfloat16
    assert_close(out[:, :k].float(), np.asarray(ref, np.float32), BF16_ULP, "pallas")
    # the sum is rounded once: the float32 plain version rounded to bf16
    f32 = pcmconv.cmconv_plain(t(x), t(w))
    assert torch.equal(out, f32.bfloat16())


def test_cmconv_bf16_bias_matches_flax_bf16_conv():
    """The bias is added in bf16 after the rounded conv, as Flax's bf16
    `nn.Conv` adds it: the plain version against Flax's conv (its kernel
    rounded to bf16) within two bf16 ulps of scale (`cmconv.BF16_TOL`)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 12, 10, 8)).astype(np.float32)           # NHWC
    w = (rng.normal(size=(3, 3, 8, 16)) * 0.3).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    layer = fnn.Conv(16, (3, 3), dtype=jnp.bfloat16)
    ref = layer.apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                      jnp.asarray(x))
    assert ref.dtype == jnp.bfloat16
    xb = t(x).permute(0, 3, 1, 2).contiguous().bfloat16()
    out = pcmconv.cmconv_plain(xb, t(w).bfloat16().float(), t(b).bfloat16())
    assert out.dtype == torch.bfloat16
    assert_close(out.float().permute(0, 2, 3, 1), np.asarray(ref, np.float32),
                 pcmconv.BF16_TOL, "bf16 conv + bias")
    rounded = pcmconv.cmconv_plain(xb, t(w).bfloat16().float()) + t(b).bfloat16().view(1, -1, 1, 1)
    assert torch.equal(out, rounded)


def test_cmconv_bf16_gradients_match_float64_reference():
    """The bf16 op's gradients against a float64 reference of the same
    roundings: dx the flipped conv of the bf16 output gradient, rounded once
    to bf16 (within one bf16 ulp of scale); dw and db float32-held bf16
    values (dw from `conv2d_weight` in bf16, cast to w's float32) within two
    ulps of scale of the float64 sums rounded to bf16."""
    rng = np.random.default_rng(22)
    x = bf16_np(rng.normal(size=(2, 8, 10, 12)))
    w = bf16_np(rng.normal(size=(3, 3, 8, 16)) * 0.3)
    b = bf16_np(rng.normal(size=(16,)))
    g = bf16_np(rng.normal(size=(2, 16, 10, 12)))
    xs = t(x).bfloat16().requires_grad_(True)
    ws = t(w).requires_grad_(True)
    bs = t(b).bfloat16().requires_grad_(True)
    out = pcmconv.cmconv(xs, ws, bs)
    assert out.dtype == torch.bfloat16
    out.backward(t(g).bfloat16())
    assert (xs.grad.dtype, ws.grad.dtype, bs.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    x64, w64, g64 = (torch.from_numpy(a.astype(np.float64)) for a in (x, w, g))
    w_oihw = w64.permute(3, 2, 0, 1)
    dx = F.conv_transpose2d(g64, w_oihw, padding=1)
    dw = torch.nn.grad.conv2d_weight(x64, w_oihw.shape, g64, padding=1).permute(2, 3, 1, 0)
    db = g64.sum(dim=(0, 2, 3))
    assert_close(xs.grad.float(), dx.bfloat16().float().numpy(), BF16_ULP, "dx")
    assert torch.equal(ws.grad, ws.grad.bfloat16().float())
    assert_close(ws.grad, dw.bfloat16().float().numpy(), pcmconv.BF16_TOL, "dw")
    assert_close(bs.grad.float(), db.bfloat16().float().numpy(), pcmconv.BF16_TOL, "db")


def test_cmconv_kernel_wrapper_refuses_float16_and_mixed_dtypes():
    """Checked before any build: the wrapper never casts."""
    before = cmconv_cuda.LAUNCHES
    x, w = torch.zeros((1, 8, 4, 4)), torch.zeros((3, 3, 8, 8))
    for args in ((x.half(), w), (x.bfloat16(), w.bfloat16()),
                 (x.bfloat16(), w, torch.zeros(8)), (x, w, torch.zeros(8).bfloat16())):
        with pytest.raises(TypeError, match="float32 or bfloat16 x"):
            cmconv_cuda.cmconv3x3_cuda(*args)
    assert cmconv_cuda.LAUNCHES == before


# The bf16 U-Net against JAX's `PatchNeutralizer(dtype=jnp.bfloat16)`, on the
# fixture's weights, dropout 0. What the two packages share is the function
# and its rounding points; the sums inside each conv and reduction run in
# another order, and an intermediate within float32 rounding of a bf16
# boundary rounds the other way. Train mode normalises by the batch
# statistics of 2 images, down to 4x4 maps at the bottleneck, which magnify
# such a flip. Each limit lies between the port's measured distance from
# JAX's bf16 U-Net and the distance of JAX's own float32 U-Net from it, so
# that a port that computed in float32 fails:
# - train output: at most BF16_OWN_SHARE of JAX's own bf16-vs-float32
#   distance, in the max and the mean (measured 0.103 of 0.207, 0.0068 of
#   0.0123: shares 0.50 and 0.55);
# - eval output: the mean at most BF16_OWN_SHARE of JAX's own (measured
#   0.00022 of 0.00046, 0.47), the max within BF16_EVAL_TOL of
#   max(1, max|ref|) (measured 0.0024, where JAX's own reads 0.0025: the
#   max does not tell the dtypes apart in eval);
# - BatchNorm statistics within BF16_STATS_TOL of scale (measured 9.0e-05);
# - every parameter gradient at cosine >= BF16_GRAD_LEAF_COS, but the
#   biases of convs that feed a BatchNorm (worst leaf measured 0.814,
#   conv2's bn2 scale; JAX's float32 gradient reads 0.620 at conv1's bn1
#   scale), and all at once at cosine >= BF16_GRAD_COS.
BF16_OWN_SHARE = 0.7
BF16_EVAL_TOL = 0.01
BF16_STATS_TOL = 1e-3
BF16_GRAD_LEAF_COS = 0.75
BF16_GRAD_COS = 0.95


def _assert_grads_match(pnet, jgrads, cos_leaf, cos_all=None):
    """Every parameter gradient of `pnet` against JAX's (by Flax path): each
    leaf at cosine >= cos_leaf but the biases of convs that feed a
    BatchNorm, whose true gradient is 0, and all at once at cosine >=
    cos_all (default cos_leaf); the worst leaf is reported."""
    flat = dict(jax.tree_util.tree_leaves_with_path(bridge.torch_to_flax(
        _with_values(pnet, {k: p.grad for k, p in pnet.named_parameters()}))["params"]))
    all_port, all_ref = [], []
    worst = (1.0, "")
    for path, r in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jgrads)):
        all_port.append(flat[path].ravel())
        all_ref.append(r.ravel())
        if path[-1].key == "bias" and path[-2].key in ("cnv1", "cnv2", "conv3"):
            continue
        worst = min(worst, (cosine(flat[path], r), jax.tree_util.keystr(path)))
    assert worst[0] >= cos_leaf, worst
    c = cosine(np.concatenate(all_port), np.concatenate(all_ref))
    assert c >= (cos_leaf if cos_all is None else cos_all), (c, worst)


def test_bf16_unet_matches_jax_bf16(unet_pair, unet_images):
    _, v, _ = unet_pair
    jb = junet.PatchNeutralizer(n_filters=4, dropout=0.0, dtype=jnp.bfloat16)
    j32 = junet.PatchNeutralizer(n_filters=4, dropout=0.0)
    target = np.random.default_rng(12).normal(size=unet_images.shape).astype(np.float32)

    def jfn(params, x):
        def loss(p):
            out, mut = jb.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                                True, mutable=["batch_stats"])
            return jnp.sum((out - target) ** 2), (out, mut["batch_stats"])
        (_, (train, stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        ref32 = j32.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                          True, mutable=["batch_stats"])[0]
        variables = {"params": params, "batch_stats": v["batch_stats"]}
        return (jb.apply(variables, x, False), j32.apply(variables, x, False), train,
                stats, grads, ref32)

    ev, ev32, train, stats, grads, ref32 = jax.jit(jfn)(v["params"],
                                                       jnp.asarray(unet_images))
    pnet = punet.PatchNeutralizer(4, dropout=0.0, dtype=torch.bfloat16)
    bridge.load_flax_variables(pnet, v)
    out = pnet(t(unet_images))
    assert out.dtype == torch.float32 and ev.dtype == jnp.float32
    assert_close(out, ev, BF16_EVAL_TOL, "bf16 eval")
    err = np.abs(out.detach().numpy() - np.asarray(ev)).mean()
    own = np.abs(np.asarray(ev) - np.asarray(ev32)).mean()
    assert err <= BF16_OWN_SHARE * own, (err, own)
    out = pnet(t(unet_images), training=True)
    err = np.abs(out.detach().numpy() - np.asarray(train))
    own = np.abs(np.asarray(train) - np.asarray(ref32))
    assert (err.max() <= BF16_OWN_SHARE * own.max()
            and err.mean() <= BF16_OWN_SHARE * own.mean()), (
        err.max(), own.max(), err.mean(), own.mean())
    flat = dict(jax.tree_util.tree_leaves_with_path(bridge.torch_to_flax(pnet)["batch_stats"]))
    for path, r in jax.tree_util.tree_leaves_with_path(stats):
        assert_close(flat[path], r, BF16_STATS_TOL, jax.tree_util.keystr(path))
    torch.sum((out - t(target)) ** 2).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in pnet.parameters())
    _assert_grads_match(pnet, grads, BF16_GRAD_LEAF_COS, BF16_GRAD_COS)


def test_bf16_unet_runs_cmconv_bf16_and_casts_with_autograd(monkeypatch):
    """n_filters 8, bf16: the 8 small-channel convs hand cmconv bf16 inputs,
    float32 kernels holding bf16 values and bf16 biases (forward), and 7
    bf16 output gradients (backward); every conv's weight gradient reaches
    its float32 parameter."""
    net = punet.PatchNeutralizer(8, dtype=torch.bfloat16)
    init_weights(net, torch.Generator().manual_seed(0))
    calls = []
    orig = pcmconv._conv

    def spy(x, w, bias):
        calls.append((x.dtype, w.dtype, None if bias is None else bias.dtype,
                      bool(torch.equal(w, w.bfloat16().float()))))
        return orig(x, w, bias)

    monkeypatch.setattr(pcmconv, "_conv", spy)
    out = net(torch.rand((1, 32, 32, 3)), training=True,
              generator=torch.Generator().manual_seed(1))
    assert out.dtype == torch.float32
    assert calls == [(torch.bfloat16, torch.float32, torch.bfloat16, True)] * 8
    out.sum().backward()
    assert calls[8:] == [(torch.bfloat16, torch.float32, None, True)] * 7
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in net.parameters())
