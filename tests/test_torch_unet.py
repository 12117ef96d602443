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
    with pytest.raises(TypeError, match="float32 only"):
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


def test_remat_has_no_counterpart():
    with pytest.raises(NotImplementedError, match="remat"):
        punet.PatchNeutralizer(4, remat=True)
