"""The port's supervised trainer against the JAX package's, on the CPU.

`train/{labeler,losses,schedules,trainer}.py` and `ops/iou_loss.py` of the
port are held to the JAX functions on the same seeded numpy inputs, and the
trainer on the conftest's tiny lite0 config with the same weights (the
port's seeded ones, carried to JAX by the bridge). Tolerances:

- `label_anchors`: class targets and positives exact, box targets within
  1e-6; the losses, the four IoU losses, the inverse-DIoU loss and
  `l2_regularization` within 1e-5 relative; the schedules within 1e-7
  relative of optax's at every step; SGD with momentum (and Adam) behind
  the global-norm clip within 1e-6 of optax after 3 updates, with the norm
  above the clip and below it.
- The train step is held twice. In float64 (both packages at 64 bits, the
  port's net and JAX's under `jax.enable_x64`) it computes the same
  function: the loss within 1e-5 relative and the parameters, the EMA and
  the BatchNorm statistics after two steps within 2e-4 * max(1, max|ref|)
  per leaf (measured 6e-8). In float32 the tiny net is badly conditioned:
  train-mode BatchNorm over 2 images of 2x2 to 4x4 maps at stride 32 takes
  E[x^2] - E[x]^2 of activations whose mean dwarfs their spread, and JAX's
  float32 gradient lies up to 44% of a leaf's scale off the float64 one at
  64 px (the port's float32 one 2.8%). So in float32, at grad_accum 1 and
  2, the first loss is held within 1e-5 relative (at 128 px, measured
  1e-7), and each collection's worst leaf after two steps within
  F32_SHARE times JAX's own float32 error there (its worst leaf against the
  float64 step), or 2e-4 of scale.
- bf16 (`config.mixed_precision`): the train-mode forward's class logits
  no further from JAX's bf16 ones than BF16_MAX_SHARE (max) and
  BF16_MEAN_SHARE (mean) of a float32 net's distance from them (measured
  0.46 and 0.80), so that a port computing in float32 fails. The bf16 loss and the parameters
  after a step do not tell the dtypes apart here (a float32 port's lie as
  close to JAX's bf16 ones as the bf16 port's do).

The JAX trainers are compiled once each, in module-scoped fixtures.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import tiny_config
from mladversarialobjectdetection_tpu.ops import iou_loss as jiou
from mladversarialobjectdetection_tpu.train import labeler as jlabeler
from mladversarialobjectdetection_tpu.train import losses as jlosses
from mladversarialobjectdetection_tpu.train import schedules as jsched
from mladversarialobjectdetection_tpu.train import trainer as jtrainer
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.data import pipeline as ppipeline
from mladversarialobjectdetection_torch.models import efficientnet as peffnet
from mladversarialobjectdetection_torch.ops import iou_loss as piou
from mladversarialobjectdetection_torch.ops.anchors import Anchors
from mladversarialobjectdetection_torch.train import labeler as plabeler
from mladversarialobjectdetection_torch.train import losses as plosses
from mladversarialobjectdetection_torch.train import schedules as psched
from mladversarialobjectdetection_torch.train import trainer as ptrainer

SIZE = 128          # the tiny config's image size for the train step
EMA_DECAY = 0.9     # an EMA visibly apart from the parameters
F32_SHARE = 2.0     # float32: the port's distance / JAX's own float32 error
BF16_MAX_SHARE = 0.6    # bf16 logits: the port's distance / a float32 net's
BF16_MEAN_SHARE = 0.9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this file's tests: the tier-1 run
    shares the CPU among six workers, where torch's default of a thread per
    core oversubscribes it and these CPU-heavy steps slow down many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def gt_batch(rng, b, hw, slots=4):
    """Random person boxes, 1..slots valid per image, random classes."""
    boxes = np.zeros((b, slots, 4), np.float32)
    valid = np.zeros((b, slots), bool)
    classes = rng.integers(0, 90, (b, slots)).astype(np.int32)
    for i in range(b):
        for k in range(rng.integers(1, slots + 1)):
            h, w = rng.uniform(0.15, 0.8, 2) * hw
            y0, x0 = rng.uniform(0, hw - h), rng.uniform(0, hw - w)
            boxes[i, k] = (y0, x0, y0 + h, x0 + w)
            valid[i, k] = True
    return boxes, classes, valid


# ---------------------------------------------------------------------------
# labels, losses, schedules, optimizer
# ---------------------------------------------------------------------------

def test_label_anchors_match_jax():
    cfg = tiny_config()
    anchors = Anchors.from_config(pconfig.Config(cfg.as_dict())).boxes
    rng = np.random.default_rng(0)
    boxes, classes, valid = gt_batch(rng, 6, 64, slots=5)
    boxes[0, 4] = anchors[0]           # a gt on anchor 0, where the invalid
    valid[0, 4] = True                 # rows' argmax also lands
    ref = jax.vmap(lambda b, c, v: jlabeler.label_anchors(
        jnp.asarray(anchors), b, c, v))(boxes, classes, valid)
    got = plabeler.label_anchors(t(anchors), t(boxes), t(classes, torch.int32),
                                 t(valid, torch.bool))
    assert np.array_equal(got.cls_targets.numpy(), np.asarray(ref.cls_targets))
    assert np.array_equal(got.num_positives.numpy(), np.asarray(ref.num_positives))
    assert np.abs(got.box_targets.numpy() - np.asarray(ref.box_targets)).max() <= 1e-6
    assert (got.cls_targets.numpy() >= 0).sum() > 20  # positives exist


@pytest.fixture(scope="module")
def head_outputs():
    """Random per-level head outputs of the tiny config, labels of random
    boxes, and the anchors."""
    cfg = tiny_config()
    anchors = Anchors.from_config(pconfig.Config(cfg.as_dict()))
    rng = np.random.default_rng(1)
    cls, box = [], []
    for level in range(cfg.min_level, cfg.max_level + 1):
        hw = anchors.feat_sizes[level]["height"]
        cls.append(rng.normal(0, 2, (2, hw, hw, 9 * 90)).astype(np.float32))
        box.append(rng.normal(0, 0.5, (2, hw, hw, 9 * 4)).astype(np.float32))
    boxes, classes, valid = gt_batch(rng, 2, 64)
    jlab = jax.vmap(lambda b, c, v: jlabeler.label_anchors(
        jnp.asarray(anchors.boxes), b, c, v))(boxes, classes, valid)
    plab = plabeler.AnchorLabels(t(jlab.cls_targets, torch.int32),
                                 t(jlab.box_targets), t(jlab.num_positives))
    return cfg, anchors.boxes, cls, box, jlab, plab


@pytest.mark.parametrize("iou_type,smoothing", [
    (None, 0.0), (None, 0.1), ("iou", 0.0), ("giou", 0.0), ("diou", 0.0),
    ("ciou", 0.0)])
def test_detection_loss_matches_jax(head_outputs, iou_type, smoothing):
    cfg, anchors, cls, box, jlab, plab = head_outputs
    kw = dict(num_classes=90, num_anchors=9, alpha=cfg.alpha, gamma=cfg.gamma,
              delta=cfg.delta, box_loss_weight=cfg.box_loss_weight,
              label_smoothing=smoothing, iou_loss_type=iou_type)
    ref, ref_parts = jlosses.detection_loss(
        [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box], jlab,
        anchor_boxes=jnp.asarray(anchors), **kw)
    got, parts = plosses.detection_loss([t(c) for c in cls], [t(b) for b in box],
                                        plab, anchor_boxes=t(anchors), **kw)
    assert rel(got, ref) <= 1e-5
    assert parts.keys() == ref_parts.keys()
    for name in parts:
        assert rel(parts[name], ref_parts[name]) <= 1e-5, name


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_iou_losses_match_jax(kind):
    rng = np.random.default_rng(2)
    lo = rng.uniform(0, 50, (64, 2))
    pred = np.concatenate([lo, lo + rng.uniform(1, 40, (64, 2))], 1).astype(np.float32)
    lo = rng.uniform(0, 50, (64, 2))
    tgt = np.concatenate([lo, lo + rng.uniform(1, 40, (64, 2))], 1).astype(np.float32)
    tgt[::7] = 0.0  # padding rows
    ref = np.asarray(jiou.iou_loss(jnp.asarray(pred), jnp.asarray(tgt), kind))
    got = piou.iou_loss(t(pred), t(tgt), kind).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    assert np.all(got[::7] == 0.0)


def test_inverse_diou_and_bce_losses_match_jax():
    rng = np.random.default_rng(3)
    pb, _, pv = gt_batch(rng, 3, 64, slots=6)
    gb, _, gv = gt_batch(rng, 3, 64, slots=4)
    pv[2] = False  # an image without predictions
    ref = jiou.inverse_diou_loss(*(jnp.asarray(a) for a in (pb, pv, gb, gv)))
    got = piou.inverse_diou_loss(t(pb), t(pv, torch.bool), t(gb), t(gv, torch.bool))
    assert rel(got, ref) <= 1e-5
    logits = rng.normal(0, 3, (4, 50)).astype(np.float32)
    labels = (rng.random((4, 50)) < 0.3).astype(np.float32)
    ref = jlosses.class_weighted_bce(jnp.asarray(logits), jnp.asarray(labels), 2.0, 0.5)
    got = plosses.class_weighted_bce(t(logits), t(labels), 2.0, 0.5)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5 * np.abs(ref).max()
    probs = 1 / (1 + np.exp(-logits))
    ref = jlosses.self_weighted_binary_ce(jnp.asarray(labels), jnp.asarray(probs))
    assert rel(plosses.self_weighted_binary_ce(t(labels), t(probs)), ref) <= 1e-5
    h_ref = jlosses.huber_loss(jnp.asarray(logits), jnp.asarray(labels), 0.1)
    h_got = plosses.huber_loss(t(logits), t(labels), 0.1)
    assert np.abs(h_got.numpy() - np.asarray(h_ref)).max() <= 1e-6


def test_l2_regularization_sums_flax_kernels(tiny_detector):
    """The leaves the port sums are the Flax `kernel` leaves, depthwise ones
    included, not BatchNorm, biases or WSM; the sum is JAX's."""
    cfg, spec, _, variables = tiny_detector
    from mladversarialobjectdetection_torch.attack.train import get_victim
    net = get_victim(pconfig.Config(cfg.as_dict()), variables=jax.tree_util.tree_map(
        np.asarray, variables), device="cpu")
    kernels = [p for path, p in jax.tree_util.tree_flatten_with_path(
        variables["params"])[0] if path[-1].key == "kernel"]
    assert len(bridge.kernel_parameters(net)) == len(kernels)
    assert any(p.shape[1] == 1 for p in bridge.kernel_parameters(net))  # depthwise
    ref = jlosses.l2_regularization(variables["params"], 4e-5)
    assert rel(plosses.l2_regularization(net, 4e-5), ref) <= 1e-5


def _sched_pairs(cfg, spe):
    return jsched.from_config(cfg, spe), psched.from_config(
        pconfig.Config(cfg.as_dict()), spe)


@pytest.mark.parametrize("method", ["cosine", "stepwise", "polynomial"])
def test_schedules_match_optax(method):
    cfg = tiny_config()
    cfg.lr_decay_method = method
    cfg.num_epochs = 6
    cfg.first_lr_drop_epoch, cfg.second_lr_drop_epoch = 3.0, 5.0
    jfn, pfn = _sched_pairs(cfg, 7)
    steps = np.arange(0, 6 * 7 + 3)
    ref = np.asarray(jax.vmap(jfn)(jnp.asarray(steps, jnp.int32)))
    got = np.array([pfn(int(s)) for s in steps])
    assert np.all(np.abs(got - ref) <= 1e-7 * np.abs(ref)), (got, ref)


@pytest.mark.parametrize("name,clip", [("sgd", 1e-3), ("sgd", 1e3),
                                       ("adam", 1e-3)])
def test_optimizer_matches_optax(name, clip):
    """Three updates of optax's stack against the port's, the clip active
    (1e-3, below the gradients' norm) or not (1e3)."""
    cfg = tiny_config()
    cfg.optimizer, cfg.clip_gradients_norm = name, clip
    rng = np.random.default_rng(4)
    params0 = [rng.normal(size=s).astype(np.float32) for s in ((3, 5), (7,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params0]
             for _ in range(3)]
    tx = jsched.make_optimizer(cfg, 5)
    jp = [jnp.asarray(p) for p in params0]
    st = tx.init(jp)
    tp = [t(p).requires_grad_(True) for p in params0]
    opt = psched.make_optimizer(pconfig.Config(cfg.as_dict()), 5, tp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = t(x)
        opt.step()
    for a, b in zip(tp, jp):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-6


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _cfg(mixed_precision=False, size=SIZE):
    cfg = tiny_config(size)
    cfg.moving_average_decay = EMA_DECAY
    cfg.mixed_precision = mixed_precision
    return cfg


@pytest.fixture(scope="module")
def batch_and_weights():
    """Two seeded images with their boxes, and the port's seeded weights as
    Flax variables."""
    rng = np.random.default_rng(5)
    images = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    gt = gt_batch(rng, 2, SIZE)
    pt = ptrainer.DetectorTrainer(pconfig.Config(_cfg().as_dict()), device="cpu")
    variables = bridge.torch_to_flax(pt.init_state(seed=0).net)
    return images, gt, variables


def _jax_run(cfg, variables, images, gt, *, k=1, x64=False):
    """Two JAX train steps from `variables`: (losses, params, stats, ema)."""
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        jt = jtrainer.DetectorTrainer(cfg, steps_per_epoch=10, grad_accum=k)
        cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), tree)
        params = cast(variables["params"])
        state = jtrainer.TrainState(params, cast(variables["batch_stats"]),
                                    jax.tree_util.tree_map(jnp.copy, params),
                                    jt.tx.init(params), jnp.asarray(0, jnp.int32))
        step = jax.jit(jt.train_step)
        losses = []
        for _ in range(2):
            state, m = step(state, jnp.asarray(images, dt), *gt)
            losses.append(float(m["loss"]))
        out = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats,
                                                  state.ema_params))
    return (losses, *out)


def _port_run(cfg, variables, images, gt, *, k=1, x64=False):
    """The same two steps in the port: (losses, params, stats, ema)."""
    pt = ptrainer.DetectorTrainer(pconfig.Config(cfg.as_dict()), steps_per_epoch=10,
                                  grad_accum=k, device="cpu")
    st = pt.init_state(variables=variables)
    if x64:
        st.net.double()
        st.net.compute_dtype = torch.float64
        st.ema = {n: e.double() for n, e in st.ema.items()}
        images = images.astype(np.float64)
    losses = []
    for _ in range(2):
        st, m = pt.train_step(st, images, *gt)
        losses.append(float(m["loss"]))
    flax = bridge.torch_to_flax(st.net)
    ema = bridge.torch_to_flax(pt.eval_variables(st))["params"]
    return losses, flax["params"], flax["batch_stats"], ema


def _leaf_dists(out, ref):
    """Per leaf max|out - ref| / max(1, max|ref|), with the leaf's path."""
    flat = jax.tree_util.tree_flatten_with_path
    res = []
    for (pa, a), (pb, b) in zip(flat(out)[0], flat(ref)[0]):
        assert pa == pb
        b = np.asarray(b, np.float64)
        res.append((jax.tree_util.keystr(pa),
                    np.abs(np.asarray(a, np.float64) - b).max()
                    / max(1.0, np.abs(b).max())))
    return res


@pytest.fixture(scope="module")
def jax_f32(batch_and_weights):
    """JAX's float32 steps at grad_accum 1 and 2, and JAX's own float32 error
    at grad_accum 1: each collection's worst leaf against the float64 steps
    (the port's, which `test_train_step_float64_matches_jax` holds to JAX's;
    JAX's grad_accum scan does not trace at 64 bits)."""
    images, gt, variables = batch_and_weights
    runs = {k: _jax_run(_cfg(), variables, images, gt, k=k) for k in (1, 2)}
    ref64 = _port_run(_cfg(), variables, images, gt, x64=True)
    own = [max(d for _, d in _leaf_dists(a, b))
           for a, b in zip(runs[1][1:], ref64[1:])]
    return runs, own


def test_train_step_float64_matches_jax(batch_and_weights):
    """At 64 px (JAX's 64-bit step compiles and runs slowly on the CPU)."""
    images, (boxes, classes, valid), variables = batch_and_weights
    cfg = _cfg(size=64)
    images, gt = images[:, :64, :64], (boxes / 2, classes, valid)
    ref = _jax_run(cfg, variables, images, gt, x64=True)
    got = _port_run(cfg, variables, images, gt, x64=True)
    for a, b in zip(got[0], ref[0]):
        assert rel(a, b) <= 1e-5
    for what, out, r in zip(("params", "stats", "ema"), got[1:], ref[1:]):
        worst = max(_leaf_dists(out, r), key=lambda x: x[1])
        assert worst[1] <= 2e-4, (what, worst)


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_float32_matches_jax(batch_and_weights, jax_f32, k):
    images, gt, variables = batch_and_weights
    runs, own = jax_f32
    ref = runs[k]
    got = _port_run(_cfg(), variables, images, gt, k=k)
    assert rel(got[0][0], ref[0][0]) <= 1e-5
    for what, out, r, o in zip(("params", "stats", "ema"), got[1:], ref[1:], own):
        worst = max(_leaf_dists(out, r), key=lambda x: x[1])
        assert worst[1] <= max(2e-4, F32_SHARE * o), (what, worst, o)


def test_train_mode_bf16_forward_matches_jax_bf16(batch_and_weights):
    """The bf16 net in train mode (batch statistics) against JAX's, compiled
    with `xla_allow_excess_precision` off (by default XLA keeps fused
    elementwise chains in float32 and skips Flax's bf16 roundings), at
    limits a float32 net fails: the float32 net's distance from JAX's bf16
    is the port's float32 forward's (held to JAX's by the float32 step
    test); then two bf16 train steps of the port."""
    images, gt, variables = batch_and_weights
    from mladversarialobjectdetection_tpu.models.efficientdet import (
        EfficientDetNet as JNet, spec_from_config as jspec)
    from mladversarialobjectdetection_torch.models.efficientdet import (
        EfficientDetNet, spec_from_config)

    def port_fwd(mp):
        net = EfficientDetNet(spec_from_config(pconfig.Config(_cfg(mp).as_dict())))
        bridge.load_flax_variables(net, variables)
        with torch.no_grad():
            return [c.numpy() for c in net(t(images), training=True)[0]]

    jnet = JNet(jspec(_cfg(True)))
    fwd = jax.jit(lambda v, x: jnet.apply(v, x, True, mutable=["batch_stats"])[0][0])
    x = jnp.asarray(images)
    strict = fwd.lower(variables, x).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref = [np.asarray(c) for c in strict(variables, x)]
    got, got32 = port_fwd(True), port_fwd(False)
    scale = max(np.abs(r).max() for r in ref)
    dmax = lambda a: max(np.abs(x - y).max() for x, y in zip(a, ref)) / scale
    dmean = lambda a: np.mean([np.abs(x - y).mean() for x, y in zip(a, ref)])
    assert dmax(got) <= BF16_MAX_SHARE * dmax(got32), (dmax(got), dmax(got32))
    assert dmean(got) <= BF16_MEAN_SHARE * dmean(got32), (dmean(got), dmean(got32))
    losses = _port_run(_cfg(True), variables, images, gt)[0]
    assert all(np.isfinite(losses))


def test_training_runs_no_fused_block_and_moves_statistics(monkeypatch):
    """A train step takes every block unfused (the fused op is never called)
    and moves each BatchNorm's running statistics once; an eval forward of
    a module left in torch's train mode moves none."""
    calls = []
    orig = peffnet.mbconv_ops.mbconv
    monkeypatch.setattr(peffnet.mbconv_ops, "mbconv",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    cfg = pconfig.Config(tiny_config().as_dict())
    pt = ptrainer.DetectorTrainer(cfg, device="cpu")
    st = pt.init_state(seed=1)
    before = copy.deepcopy(st.net.state_dict())
    rng = np.random.default_rng(6)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    st, m = pt.train_step(st, images, *gt_batch(rng, 2, 64))
    assert not calls and np.isfinite(float(m["loss"]))
    stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats if not torch.equal(before[k], st.net.state_dict()[k])]
    assert len(moved) == len(stats)
    # one move at momentum .99 toward the batch statistics
    bn = st.net.backbone.stem_bn
    x = st.net.backbone.stem_conv(t(images).permute(0, 3, 1, 2)).detach()
    mu = x.mean(dim=(0, 2, 3))
    assert torch.allclose(bn.running_mean, 0.99 * before["backbone.stem_bn.running_mean"]
                          + 0.01 * mu, atol=1e-6)
    net = st.net
    assert net.training  # torch's flag, never read
    frozen = copy.deepcopy(net.state_dict())
    with torch.no_grad():
        out = net(t(images))
        ref = copy.deepcopy(net).eval()(t(images))
    assert calls  # eval takes the fused blocks
    assert all(torch.equal(a, b) for a, b in zip(out[0], ref[0]))
    assert all(torch.equal(frozen[k], net.state_dict()[k]) for k in frozen)


def test_scene_pool_matches_the_jax_examples_generator():
    """The port's scene generator draws what examples/production_soak.py
    draws for a seed, and the pool mirrors boxes with the images."""
    import importlib.util
    import os
    import sys
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "production_soak.py")
    spec = importlib.util.spec_from_file_location("production_soak", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("production_soak", mod)
    spec.loader.exec_module(mod)
    ref = mod.synthetic_person_batch(np.random.default_rng(7), 2)
    got = ppipeline.synthetic_person_batch(np.random.default_rng(7), 2)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    pool = ppipeline.ScenePool(np.random.default_rng(8), n_batches=1, batch=2)
    imgs, boxes, classes, valid = pool.sample(np.random.default_rng(9), 2)
    rng = np.random.default_rng(9)
    idx = rng.choice(2, 2, replace=False)
    flip = rng.random(2) < 0.5
    for i in range(2):
        src = pool.images[idx[i]]
        want = torch.flip(src, dims=(1,)) if flip[i] else src
        assert torch.equal(imgs[i], want)
        b = pool.boxes[idx[i]]
        if flip[i]:
            assert np.array_equal(boxes[i, :, 1], 640 - b[:, 3])
        else:
            assert np.array_equal(boxes[i], b)
    assert valid.any() and (classes == 0).all()


def test_build_victim_trains_saves_and_scores(tmp_path):
    """`train/victim.build_victim` (the port of examples/northstar_soak.py's)
    trains from a pool, writes the eval net's Flax variables as a pytree
    file that `Detector(ckpt_path=)` serves, and scores persons."""
    from mladversarialobjectdetection_torch.inference.detector import Detector
    from mladversarialobjectdetection_torch.train import victim

    cfg = pconfig.Config(tiny_config().as_dict())

    class Pool:  # ScenePool's interface at 64 px
        def sample(self, rng, b):
            boxes, classes, valid = gt_batch(rng, b, 64)
            images = rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32)
            return torch.from_numpy(images), boxes, classes * 0, valid

    path = str(tmp_path / "victim")
    net, log = victim.build_victim(cfg, Pool(), np.random.default_rng(0), 2,
                                   path, batch=2, device="cpu", log_every=1)
    assert [r["step"] for r in log] == [1, 2] and all(np.isfinite(r["loss"]) for r in log)
    det = Detector("efficientdet-lite0", params={
        k: cfg.as_dict()[k] for k in ("image_size", "fpn_num_filters",
                                      "fpn_cell_repeats", "box_class_repeats")},
        device="cpu", ckpt_path=path)
    for (ka, va), (kb, vb) in zip(det.net.state_dict().items(),
                                  net.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    scores = victim.max_person_scores(net, t(np.zeros((3, 64, 64, 3))), 90)
    assert scores.shape == (3,) and np.all((scores > 0) & (scores < 1))
    assert victim.make_config().learning_rate == 0.08


def test_victim_paths_leave_trained_statistics_bit_unchanged():
    """A trained victim's BatchNorm statistics stay bit-equal through an
    attack step, a defender step and a serve: each runs its victim with
    Flax's `training=False`, whatever torch's module flag says."""
    from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
    from mladversarialobjectdetection_torch.inference.detector import Detector

    cfg = pconfig.Config(tiny_config().as_dict())
    cfg.nms_configs["score_thresh"] = 0.0099
    pt = ptrainer.DetectorTrainer(cfg, device="cpu")
    st = pt.init_state(seed=3)
    rng = np.random.default_rng(10)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    st, _ = pt.train_step(st, images, *gt_batch(rng, 2, 64))
    victim = pt.eval_variables(st)
    before = copy.deepcopy(victim.state_dict())
    atk = PatchAttacker(cfg, victim, patch_size=32, device="cpu")
    dfd = PatchAttackDefender(cfg, victim, n_filters=4, device="cpu")
    det = Detector("efficientdet-lite0", params={
        k: cfg.as_dict()[k] for k in ("image_size", "fpn_num_filters",
                                      "fpn_cell_repeats", "box_class_repeats")},
        device="cpu")
    det.net = victim
    victim.train()  # torch's flag on (the constructors set it off): never read
    atk.train_step(atk.init_state(0), t(images))
    dfd.train_step(dfd.init_state(0), t(images))
    det.serve([rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)])
    assert victim.training
    after = victim.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
