"""The port's COCO metric, pruning and fine-tune merge against the JAX package's, on the CPU.

`utils/coco_metric.py`, `utils/sparsity.py` and `ckpt/finetune.py`. All
exact: `COCOEvaluator.result(per_class=True)` on seeded detections with
crowds and every area range; the pruning masks (one-shot, at a sparsity
whose k lands on x.5, with weights tied at the threshold, and along the
PolynomialDecay ramp), the schedule's float32 values, `mask_like` and the
reports key for key (Flax paths); `merge_pretrained` in both modes and
`restore_pretrained` from one pytree file.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from mladversarialobjectdetection_tpu.ckpt import finetune as jfinetune
from mladversarialobjectdetection_tpu.utils import coco_metric as jcoco
from mladversarialobjectdetection_tpu.utils import sparsity as jsp
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.ckpt import bridge, finetune
from mladversarialobjectdetection_torch.ckpt import io as pio
from mladversarialobjectdetection_torch.models import efficientdet as pdet
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.utils import coco_metric as pcoco
from mladversarialobjectdetection_torch.utils import sparsity as psp


def _net(seed=0, **cfg_kw):
    cfg = pconfig.Config(tiny_config().as_dict())
    cfg.update(cfg_kw)
    net = pdet.EfficientDetNet(pdet.spec_from_config(cfg))
    return init_weights(net, torch.Generator().manual_seed(seed))


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [jax.tree_util.keystr(p) for p, _ in fa] == \
        [jax.tree_util.keystr(p) for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# COCO metric
# ---------------------------------------------------------------------------

def _coco_images(seed):
    """Ground truths of 3 classes at small / medium / large sizes, crowds
    among them, and noisy detections with false positives and duplicates."""
    rng = np.random.default_rng(seed)
    images = []
    for _ in range(10):
        g = int(rng.integers(0, 6))
        size = rng.choice([12.0, 50.0, 150.0], g) * rng.uniform(0.7, 1.3, g)
        y0, x0 = rng.uniform(0, 300, (2, g))
        gt = np.stack([y0, x0, y0 + size, x0 + size * rng.uniform(0.5, 1.5, g)], -1)
        gcls = rng.integers(1, 4, g)
        crowd = rng.random(g) < 0.2
        dets, dcls = [], []
        for box, c in zip(gt, gcls):
            for _ in range(int(rng.integers(0, 3))):
                dets.append(box + rng.normal(0, 0.08 * (box[2] - box[0]), 4))
                dcls.append(c if rng.random() < 0.9 else rng.integers(1, 4))
        for _ in range(int(rng.integers(0, 4))):  # false positives
            y, x, s = rng.uniform(0, 300), rng.uniform(0, 300), rng.uniform(8, 120)
            dets.append([y, x, y + s, x + s])
            dcls.append(rng.integers(1, 4))
        dets = np.asarray(dets, np.float64).reshape(-1, 4)
        scores = np.round(rng.uniform(0.05, 1.0, len(dets)), 2)  # ties
        images.append((dets, scores, np.asarray(dcls, int), gt, gcls, crowd))
    return images


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {}),
                                     (2, dict(iou_thresholds=[0.3, 0.5, 0.7],
                                              max_dets=(2, 5, 20)))])
def test_coco_evaluator_matches_jax(seed, kw):
    ours, ref = pcoco.COCOEvaluator(**kw), jcoco.COCOEvaluator(**kw)
    for det, sc, dc, gt, gc, crowd in _coco_images(seed):
        ours.add_image(det, sc, dc, gt, gc, gt_is_crowd=crowd)
        ref.add_image(det, sc, dc, gt, gc, gt_is_crowd=crowd)
    got, want = ours.result(per_class=True), ref.result(per_class=True)
    assert got == want
    assert any(k.startswith("AP_/") for k in got) and 0 < got["AP"] < 1


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

def test_one_shot_pruning_masks_and_report_match_jax():
    net = _net(1)
    # ties at a threshold: a layer whose smallest magnitudes repeat
    kernel = net.class_net.conv_0.pw.weight
    with torch.no_grad():
        kernel.view(-1)[:40] = 0.01 * torch.sign(kernel.view(-1)[:40])
    params = bridge.torch_to_flax(net)["params"]
    n = kernel.numel()
    sparsity = (n // 2 + 0.5) / n  # k lands on x.5 for that layer
    ours = copy.deepcopy(net)
    _, report = psp.prune_low_magnitude(ours, sparsity)
    ref, ref_report = jsp.prune_low_magnitude(params, sparsity)
    _assert_trees_equal(bridge.torch_to_flax(ours)["params"],
                        jax.tree_util.tree_map(np.asarray, ref))
    assert report == ref_report
    assert psp.sparsity_report(ours) == jsp.sparsity_report(ref)
    scope = lambda p: not p.startswith("backbone")
    ours = copy.deepcopy(net)
    _, report = psp.prune_low_magnitude(ours, 0.9, scope=scope)
    ref, ref_report = jsp.prune_low_magnitude(params, 0.9, scope=scope)
    assert report == ref_report and report
    _assert_trees_equal(bridge.torch_to_flax(ours)["params"],
                        jax.tree_util.tree_map(np.asarray, ref))


def test_pruned_count_rounds_as_jax():
    """k = round(sparsity * n) as JAX computes it (sparsity.py:50-53): a
    schedule's float32 value times n in float32, a Python sparsity times n
    in float64 then cast; half to even. The sparsities sit at x.5 of some
    layer size, where a product in the other precision rounds the other
    way."""
    rng = np.random.default_rng(0)
    for n in (27, 216, 864, 4608, 147456, 1 << 20):
        ks = rng.integers(0, n, 200)
        for s in np.concatenate([(ks + 0.5) / n, rng.uniform(0, 1, 50)]):
            s32 = np.float32(s)
            want = int(jnp.clip(jnp.round(jnp.asarray(s32) * n).astype(jnp.int32), 0, n - 1))
            assert psp._pruned_count(torch.tensor(s32), n) == want, (n, s32)
            want = int(jnp.clip(jnp.round(float(s) * n).astype(jnp.int32), 0, n - 1))
            assert psp._pruned_count(float(s), n) == want, (n, s)


def test_pruner_schedule_and_mask_like_follow_jax():
    sched_kw = dict(initial_sparsity=0.1, final_sparsity=0.7, begin_step=2,
                    end_step=9, power=3)
    ours_s, ref_s = psp.PolynomialDecaySchedule(**sched_kw), \
        jsp.PolynomialDecaySchedule(**sched_kw)
    for step in range(12):
        a, b = ours_s(step), np.asarray(ref_s(step))
        assert a.dtype == torch.float32 and a.numpy().tobytes() == b.tobytes(), step
    net = _net(2)
    ours, ref = psp.MagnitudePruner(ours_s), jsp.MagnitudePruner(ref_s)
    params = bridge.torch_to_flax(net)["params"]
    prune = jax.jit(ref.prune)
    rng = torch.Generator().manual_seed(0)
    for step in (1, 3, 5, 9, 11):
        with torch.no_grad():  # move the weights between prunes
            for p in net.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=rng))
        params = bridge.torch_to_flax(net)["params"]
        ours.prune(net, step)
        params = jax.tree_util.tree_map(np.asarray, prune(params, step))
        _assert_trees_equal(bridge.torch_to_flax(net)["params"], params)
    ema = {k: p.detach().clone() + 1.0 for k, p in net.named_parameters()}
    ref_ema = jsp.mask_like(params, bridge.to_flax_tree(net, ema))
    psp.mask_like(net, ema)
    _assert_trees_equal(bridge.to_flax_tree(net, ema),
                        jax.tree_util.tree_map(np.asarray, ref_ema))
    assert psp.sparsity_report(net) == jsp.sparsity_report(params)


def test_registry_prunes_and_leaves_quantize_to_its_item():
    net = _net(3)
    psp.set_config({"prune": {"sparsity": 0.25}})
    try:
        _, report = psp.get_method("prune")(net)
        assert all(abs(v - 0.25) < 0.01 for v in report.values())
    finally:
        psp._optimization_methods.clear()
    assert psp.get_method("prune") is psp.prune_low_magnitude
    # 'quantize' is the int8 module, its kwargs bound by set_config as JAX's
    from mladversarialobjectdetection_torch.inference import quantize as pquant
    assert psp.get_method("quantize") is pquant
    psp.set_config({"quantize": {"paths": ["backbone/stem_conv"]}})
    try:
        (k_q, w_scale), = psp.get_method("quantize")(net).values()
        assert k_q.dtype == torch.int8 and tuple(w_scale.shape) == (k_q.shape[0],)
    finally:
        psp._optimization_methods.clear()
    with pytest.raises(KeyError):
        psp.get_method("distill")


# ---------------------------------------------------------------------------
# fine-tune merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["backbone", "trunk"])
def test_merge_and_restore_pretrained_match_jax(mode, tmp_path):
    fresh = bridge.torch_to_flax(_net(4))
    loaded = bridge.torch_to_flax(_net(5, num_classes=20))  # class predict differs
    del loaded["params"]["fpn_cells"]["cell_0"]["fnode0"]["conv_pw"]
    del loaded["batch_stats"]["resample_p6"]
    ours = finetune.merge_pretrained(fresh, loaded, mode)
    ref = jfinetune.merge_pretrained(fresh, loaded, mode)
    _assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, ref))
    head = ours["params"]["class_net"]["conv_0"]["pw"]["kernel"]
    want = (fresh if mode == "backbone" else loaded)["params"]["class_net"]
    assert np.array_equal(head, want["conv_0"]["pw"]["kernel"])
    pio.save_pytree(str(tmp_path / "pre"), loaded)
    got = finetune.restore_pretrained(fresh, str(tmp_path / "pre"), mode=mode)
    ref = jfinetune.restore_pretrained(fresh, str(tmp_path / "pre"), None, None,
                                       mode=mode)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, ref))
    with pytest.raises(ValueError, match="finetune mode"):
        finetune.merge_pretrained(fresh, loaded, "heads")
    tf_dir = tmp_path / "tf"
    tf_dir.mkdir()
    (tf_dir / "model.ckpt-3.index").write_bytes(b"")
    (tf_dir / "checkpoint").write_text('model_checkpoint_path: "model.ckpt-3"\n')
    # the TF1 branch is ported (tests/test_torch_convert.py): an empty index
    # is not a tensor bundle
    with pytest.raises(ValueError, match="table footer"):
        finetune.restore_pretrained(fresh, str(tf_dir), mode=mode)
