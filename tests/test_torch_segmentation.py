"""The port's segmentation head and trainer, and `grad_checkpoint`, against JAX, on the CPU.

- `heads.SegmentationHead` and the net with heads ("segmentation",) and
  ("object_detection", "segmentation") against `EfficientDetNet.apply` of
  the JAX package on the same Flax variables (BatchNorm statistics, scales
  and biases redrawn), eval and train mode (the moved statistics too), at
  lite0 / d0 64 px: within 2e-4 * max(1, max|ref|).
- `train/segmentation.py`: `output_size`, `synthetic_seg_batches` exact;
  `SegmentationTrainer` held as ROADMAP Queue 3 item 22 holds the
  detector's step: in float64 (JAX under `jax.enable_x64`; both nets cast
  their logits to float32, as JAX's does), at the reference's learning rate
  1e-3: the loss of each of two steps within 1e-5 relative; after the first
  step every parameter and statistic within 2e-4 * max(1, max|ref|), Adam's
  moments within ADAM_MOMENT_SHARE of each leaf's largest (1e-12 absolute
  for leaves whose gradient is structurally 0, as a bias before a
  train-mode BatchNorm), `eval_step` and `predict_mask` (of a float32 copy: the frozen net runs
  the fused MBConv op). The parameters
  after two steps are not held: Adam divides by sqrt(v) + 1e-8, so the
  float32 logits' rounding of a gradient near 1e-8 moves an element by up
  to 1.8e-5 after one step, and at this tiny size (train-mode BatchNorm
  over 2x2 maps) the second gradient moves by up to 52% of a leaf's scale
  for such a shift (measured: JAX's own gradient at its parameters against
  at the port's), which shows as 2.9e-4 in the parameters.
- `grad_checkpoint` (FPN cells and head convs recomputed in the backward
  pass) bit-equal on the CPU to no checkpointing: the loss, every
  parameter after the update and the BatchNorm statistics, which a
  recompute must not move a second time.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from mladversarialobjectdetection_tpu import config as jconfig
from mladversarialobjectdetection_tpu.models import efficientdet as jdet
from mladversarialobjectdetection_tpu.train import segmentation as jseg
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.models import efficientdet as pdet
from mladversarialobjectdetection_torch.models import efficientnet as peff
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.train import segmentation as pseg
from mladversarialobjectdetection_torch.train import trainer as ptrainer

HEADS = {"seg": ["segmentation"], "both": ["object_detection", "segmentation"]}
ADAM_MOMENT_SHARE = 1e-4  # Adam's mu / nu: of max|ref| per leaf


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(heads, model="lite0"):
    if model == "lite0":
        cfg = tiny_config(64)
    else:
        cfg = jconfig.get_efficientdet_config("efficientdet-d0")
        cfg.update({"image_size": 64, "fpn_num_filters": 16,
                    "fpn_cell_repeats": 1, "box_class_repeats": 1})
    cfg.heads = list(heads)
    return cfg


def _redraw(variables, seed):
    """Random BatchNorm statistics, scales and biases (every op matters)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name in ("var", "scale", "WSM"):
            return np.float32(rng.uniform(0.5, 1.5, shape))
        if name in ("mean", "bias"):
            return np.float32(rng.uniform(-0.3, 0.3, shape))
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _port_flax(cfg, seed=0):
    """The port's seeded weights of `cfg` as Flax variables, redrawn."""
    net = pdet.EfficientDetNet(pdet.spec_from_config(pconfig.Config(cfg.as_dict())))
    init_weights(net, torch.Generator().manual_seed(seed))
    return _redraw(bridge.torch_to_flax(net), seed + 1)


def _close(out, ref, what=""):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    assert out.shape == ref.shape, what
    tol = 2e-4 * max(1.0, float(np.abs(ref).max()))
    assert np.abs(out - ref).max() <= tol, (what, np.abs(out - ref).max(), tol)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("heads,model", [("seg", "lite0"), ("both", "lite0"),
                                         ("both", "d0")])
def test_segmentation_nets_match_jax(heads, model):
    cfg = _cfg(HEADS[heads], model)
    variables = _port_flax(cfg)
    jnet = jdet.EfficientDetNet(jdet.spec_from_config(cfg))
    pnet = pdet.EfficientDetNet(pdet.spec_from_config(pconfig.Config(cfg.as_dict())))
    bridge.load_flax_variables(pnet, variables)
    images = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jnet.apply, static_argnums=2)(variables, images, False)
    with torch.no_grad():
        got = pnet(torch.from_numpy(images))
    assert len(got) == len(ref) == len(HEADS[heads]) + (heads == "both")
    seg = got[-1].numpy()
    assert seg.shape == (2, 16, 16, 3) and seg.dtype == np.float32
    _close(seg, ref[-1], "seg")
    if heads == "both":
        for outs, refs in zip(got[:2], ref[:2]):
            for o, r in zip(outs, refs):
                _close(o.numpy(), r, "det")
    # train mode: batch statistics, and the moved running statistics
    (ref_t, mutated) = jax.jit(lambda v, x: jnet.apply(
        v, x, True, mutable=["batch_stats"]))(variables, images)
    got_t = pnet(torch.from_numpy(images), training=True)
    _close(got_t[-1].detach().numpy(), ref_t[-1], "seg train")
    stats = _leaves(bridge.torch_to_flax(pnet)["batch_stats"])
    for key, value in _leaves(mutated["batch_stats"]).items():
        _close(stats[key], value, key)
    assert any("seg_head" in k for k in stats)


def test_output_size_and_synthetic_masks_match_jax():
    for size, level in ((64, 3), (128, 3), (640, 3), (100, 2), (512, 4)):
        assert pseg.output_size(size, level) == jseg.output_size(size, level)
    ours = pseg.synthetic_seg_batches(2, 64, 16, seed=4)
    ref = jseg.synthetic_seg_batches(2, 64, 16, seed=4)
    for _ in range(2):
        a, b = next(ours), next(ref)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_segmentation_trainer_float64_matches_jax():
    cfg = _cfg(HEADS["seg"])
    variables = _port_flax(cfg, seed=5)
    batches = jseg.synthetic_seg_batches(2, 64, 16, seed=0)
    data = [next(batches) for _ in range(2)]
    with jax.enable_x64(True):
        images = [jnp.asarray(b["images"], jnp.float64) for b in data]
        jt = jseg.SegmentationTrainer(cfg)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        params = cast(variables["params"])
        state = jseg.SegTrainState(params, cast(variables["batch_stats"]),
                                   jt.tx.init(params), jnp.asarray(0, jnp.int32))
        step = jax.jit(jt.train_step)
        state, m1 = step(state, images[0], data[0]["masks"])
        ref_state = jax.tree_util.tree_map(np.asarray, (
            state.params, state.batch_stats, state.opt_state[0].mu,
            state.opt_state[0].nu))
        ref_eval = jax.jit(jt.eval_step)(state, images[1], data[1]["masks"])
        ref_mask = np.asarray(jax.jit(jt.predict_mask)(state, images[1]))
        _, m2 = step(state, images[1], data[1]["masks"])
        ref_losses = [float(m1["loss"]), float(m2["loss"])]
    pt = pseg.SegmentationTrainer(pconfig.Config(cfg.as_dict()), device="cpu")
    st = pt.init_state(variables=variables)
    st.net.double()
    st.net.compute_dtype = torch.float64
    st, m = pt.train_step(st, data[0]["images"].astype(np.float64), data[0]["masks"])
    assert abs(float(m["loss"]) - ref_losses[0]) <= 1e-5 * abs(ref_losses[0])
    flax = bridge.torch_to_flax(st.net)
    for got, ref in zip((flax["params"], flax["batch_stats"]), ref_state):
        got = _leaves(got)
        for key, value in _leaves(ref).items():
            _close(got[key], value, key)
    named = dict(st.net.named_parameters())
    for slot, ref in zip(("exp_avg", "exp_avg_sq"), ref_state[2:]):
        got = _leaves(bridge.to_flax_tree(st.net, {
            n: st.optimizer.state[p][slot] for n, p in named.items()}))
        for key, value in _leaves(ref).items():
            err = np.abs(got[key] - value).max()
            assert err <= ADAM_MOMENT_SHARE * np.abs(value).max() + 1e-12, \
                (slot, key, err)
    # the frozen net runs the fused MBConv op, whose instances are float32
    # and bf16: eval a float32 copy
    net32 = copy.deepcopy(st.net).float()
    net32.compute_dtype = torch.float32
    st32 = pseg.SegTrainState(net32, st.optimizer, st.step)
    ev = pt.eval_step(st32, data[1]["images"], data[1]["masks"])
    assert abs(float(ev["val_loss"]) - float(ref_eval["val_loss"])) <= \
        1e-5 * abs(float(ref_eval["val_loss"]))
    assert float(ev["val_accuracy"]) == pytest.approx(
        float(ref_eval["val_accuracy"]), abs=1e-3)
    mask = pt.predict_mask(st32, data[1]["images"]).numpy()
    assert mask.shape == ref_mask.shape and (mask == ref_mask).mean() >= 0.999
    st, m = pt.train_step(st, data[1]["images"].astype(np.float64), data[1]["masks"])
    assert st.step == 2
    assert abs(float(m["loss"]) - ref_losses[1]) <= 1e-5 * abs(ref_losses[1])


def test_segmentation_train_cli_writes_logs_and_weights(tmp_path):
    state, metrics = pseg.train(
        "efficientdet-lite0", image_size=64, batch_size=2, steps=2, log_every=1,
        config_override={"fpn_num_filters": 16, "fpn_cell_repeats": 1,
                         "box_class_repeats": 1},
        model_dir=str(tmp_path), device="cpu")
    assert state.step == 2 and np.isfinite(metrics["loss"])
    assert {"loss", "accuracy", "val_loss", "val_accuracy"} <= set(metrics)
    assert (tmp_path / "segmentation.pkl").exists()
    assert len((tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()) == 2


def test_grad_checkpoint_is_bit_equal_and_moves_statistics_once(monkeypatch):
    cfg = pconfig.Config(tiny_config(64).as_dict())
    cfg.update({"fpn_cell_repeats": 2, "box_class_repeats": 2})
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    boxes = np.asarray([[[4, 6, 40, 30]], [[10, 12, 60, 50]]], np.float32)
    classes, valid = np.zeros((2, 1), np.int32), np.ones((2, 1), bool)
    calls = []
    real = peff.checkpointed
    monkeypatch.setattr(peff, "checkpointed",
                        lambda fn, *t: calls.append(1) or real(fn, *t))
    from mladversarialobjectdetection_torch.models import bifpn, heads
    monkeypatch.setattr(bifpn, "checkpointed", peff.checkpointed)
    monkeypatch.setattr(heads, "checkpointed", peff.checkpointed)
    runs = {}
    for gc in (False, True):
        cfg.grad_checkpoint = gc
        tr = ptrainer.DetectorTrainer(cfg, device="cpu")
        st = tr.init_state(seed=3)
        state, m = tr.train_step(st, images, boxes, classes, valid)
        out = {"loss": m["loss"].numpy()}
        out.update({k: v.clone() for k, v in state.net.state_dict().items()})
        out.update({f"ema/{k}": v.clone() for k, v in state.ema.items()})
        runs[gc] = out
    # 2 FPN cells + 2 head convs x 5 levels x 2 heads, in the one checkpointed step
    assert len(calls) == 2 + 2 * 5 * 2
    for key, value in runs[False].items():
        other = runs[True][key]
        assert np.array_equal(np.asarray(value), np.asarray(other)), key
    # one train-mode pass moves a statistic once: momentum .99 from mean 0
    stats = runs[True]["fpn_cells.cell_1.fnode0.bn.running_mean"]
    assert 0 < float(stats.abs().max()) < 0.5
