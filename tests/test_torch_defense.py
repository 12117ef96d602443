"""The port's defender path against the JAX package's, on the CPU.

A tiny lite0@64 victim (the conftest's `tiny_detector`) goes through the
bridge into the port, and a U-Net of n_filters 4 (`tests/test_defense.py`'s
size) is initialised by the JAX package and carried over, so both packages
run the same weights. The random victim's 90 class logits nearly tie, so
its per-anchor argmax class differs between the packages on about 1% of
anchors and with it the person boxes; the step tests bias its class head
toward persons, as `tests/test_defense.py:65-70` does (person logit 0, so
scores near .5, or 3 where a confident victim is needed), and lower the
score threshold to .0099 so that the masker plants patches on its
detections.

Randomness: the JAX draws of the masker (the batch permutation, the two
flips, the EOT geometry; replayed from the same key splits as
defender.py:167 / masker.py:60 / eot.py:527-534) are fed into the port;
sensor noise, brightness and the print transform are pinned on both sides
(the masker's `eot_kwargs`, as the attack tests pin them), and the U-Net's
dropout is 0 on both sides. The step tests composite with the fp32 `gather`
EOT backend on both sides: the JAX `matmul` backend rounds canvas and hat
weights to bf16 (eot.py:265-278), which the masker test below bounds, and
the port's float32 warp is held against the Pallas kernels in
`test_torch_eot.py`.

Tolerances: fp32 outputs (loss, scores, PSNR, recovered images, BatchNorm
statistics) within 2e-4 * max(1, max|ref|), the ROADMAP rule; the masker on
the matmul backend within 0.02 (the bf16 bound of test_torch_eot.py); after
one Adam step every parameter within 2 * lr of JAX's (Adam's first step
moves each weight by lr * g / (|g| + eps); where g is rounding noise, as for
a conv bias that feeds a BatchNorm, either side may take either sign), and
within 1e-5 where JAX's step is at least .999 lr (|g| >= 999 eps).
"""
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mladversarialobjectdetection_tpu.config as jconfig
from mladversarialobjectdetection_tpu.ckpt import io as jio
from mladversarialobjectdetection_tpu.defense import defender as jdefender
from mladversarialobjectdetection_tpu.defense import masker as jmasker
from mladversarialobjectdetection_tpu.models import unet as junet
from mladversarialobjectdetection_tpu.utils import visualize as jvisualize
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack import train as atrain
from mladversarialobjectdetection_torch.defense import defender as pdefender
from mladversarialobjectdetection_torch.defense import masker as pmasker
from mladversarialobjectdetection_torch.defense import train as dtrain
from mladversarialobjectdetection_torch.models import efficientdet as pdet
from mladversarialobjectdetection_torch.models import unet as punet
from mladversarialobjectdetection_torch.ops import cmconv_cuda, eot as peot
from mladversarialobjectdetection_torch.ops import nms_cuda, warp_cuda
from mladversarialobjectdetection_torch.utils import visualize as pvisualize
from test_torch_eot import jax_draws

PINNED = dict(noise_mag=0.0, brightness_mag=0.0, print_jitter=False)
LOW_THRESH = 0.0099
LR = 1e-2
TOL = 2e-4
K = 4  # max_boxes_per_image of the tiny config


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(port, ref, tol=TOL, what=""):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def gather_maskers(monkeypatch):
    """Both packages' maskers pinned and on the fp32 gather backend."""
    for mod in (jmasker, pmasker):
        monkeypatch.setattr(mod, "apply_masker", functools.partial(
            mod.apply_masker, backend="gather", **PINNED))


def configs(tiny_cfg, thresh=LOW_THRESH):
    d = tiny_cfg.as_dict()
    d["nms_configs"]["score_thresh"] = thresh
    return jconfig.Config(d), pconfig.Config(d)


def make_pair(tiny_detector, *, variables=None, grad_accum=1):
    """(JAX defender, port defender) on the same victim, n_filters 4; the
    JAX U-Net has dropout 0, and `states` sets the port's to 0."""
    cfg, _, _, jvars = tiny_detector
    variables = host(jvars) if variables is None else variables
    jcfg, pcfg = configs(cfg)
    patch = np.random.default_rng(0).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    jdef = jdefender.PatchAttackDefender(
        jcfg, jax.tree_util.tree_map(jnp.asarray, variables), eval_patch=patch,
        eval_scale=0.4, n_filters=4, grad_accum=grad_accum)
    jdef.unet = junet.PatchNeutralizer(n_filters=4, dropout=0.0)
    victim = atrain.get_victim(pcfg, variables=variables, device="cpu")
    pdef = pdefender.PatchAttackDefender(
        pcfg, victim, eval_patch=patch, eval_scale=0.4, n_filters=4,
        grad_accum=grad_accum, device="cpu")
    return jdef, pdef


def states(jdef, pdef, seed=0):
    jst = jdef.init_state(jax.random.PRNGKey(seed))
    pst = pdef.init_state(seed, variables={"params": host(jst.params),
                                           "batch_stats": host(jst.batch_stats)})
    for m in pst.unet.modules():  # dropout 0, as make_pair's JAX U-Net
        if isinstance(m, (punet.ConvBlock, punet.DeconvBlock)):
            m.dropout = 0.0
    return jst, pst


def train_draws(k_mask, b):
    """The masker draws of JAX's apply_masker(k_mask, ..., training=True)."""
    k_patch, k_apply = jax.random.split(k_mask)
    k_shuf, k_lr, k_ud = jax.random.split(k_patch, 3)
    as_t = lambda a: torch.from_numpy(np.array(a))
    return pmasker.MaskerDraws(
        perm=as_t(jax.random.permutation(k_shuf, b)).long(),
        flip_lr=as_t(jax.random.bernoulli(k_lr, 0.5, (b,))),
        flip_ud=as_t(jax.random.bernoulli(k_ud, 0.5, (b,))),
        eot=jax_draws(k_apply, b, K, random_scale_range=pmasker.TRAIN_SCALE_RANGE))


def eval_draws(k_mask, b):
    _, k_apply = jax.random.split(k_mask)
    return pmasker.MaskerDraws(eot=jax_draws(k_apply, b, K))


@pytest.fixture(scope="module")
def images(rand_images):
    return np.asarray(rand_images)


def person_variables(tiny_detector, logit):
    """The victim with its class head biased so that every anchor's class is
    person, at about sigmoid(logit) (tests/test_defense.py:65-70)."""
    cfg, _, _, variables = tiny_detector
    v = jax.tree_util.tree_map(np.array, host(variables))  # writable copies
    leaf = v["params"]["class_net"]["predict"]
    leaf = leaf["pw"] if "pw" in leaf else leaf
    bias = np.full(leaf["bias"].shape, -10.0, np.float32)
    bias[0::cfg.num_classes] = logit
    leaf["bias"] = bias
    return v


@pytest.fixture(scope="module")
def person_victim(tiny_detector):
    return person_variables(tiny_detector, 0.0)


@pytest.fixture(scope="module")
def pair(tiny_detector, person_victim):
    return make_pair(tiny_detector, variables=person_victim)


# ---------------------------------------------------------------------------
# masker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("backend", ["gather", "matmul"])
def test_masker_matches_jax(images, training, backend):
    boxes = np.zeros((2, K, 4), np.float32)
    valid = np.zeros((2, K), bool)
    boxes[0, :2] = [(4, 4, 60, 60), (10, 20, 50, 44)]
    boxes[1, 0] = (8, 6, 56, 40)
    valid[0, :2] = valid[1, 0] = True
    key = jax.random.PRNGKey(3)
    patch = np.random.default_rng(1).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    kw = dict(PINNED, backend=backend)
    if not training:
        kw.update(adv_patch=patch, adv_scale=0.4)
    ref = jmasker.apply_masker(key, jnp.asarray(images), jnp.asarray(boxes),
                               jnp.asarray(valid), training=training,
                               return_region=True, **{
                                   k: jnp.asarray(v) if k == "adv_patch" else v
                                   for k, v in kw.items()})
    draws = train_draws(key, 2) if training else eval_draws(key, 2)
    out = pmasker.apply_masker(t(images), t(boxes), torch.from_numpy(valid),
                               training=training, return_region=True,
                               draws=draws, device="cpu", **kw)
    assert np.array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert out[2].any()
    tol = TOL if backend == "gather" else 0.02
    close(out[0], ref[0], tol, "patched")
    close(out[1], ref[1], tol, "targets")


def test_train_patches_match_jax(images):
    key = jax.random.PRNGKey(4)
    imgs = np.concatenate([images, images[::-1] * 0.5])
    ref = jmasker.make_train_patches(key, jnp.asarray(imgs), crop=40)
    k_shuf, k_lr, k_ud = jax.random.split(key, 3)
    out = pmasker.make_train_patches(
        t(imgs), 40, perm=torch.from_numpy(np.array(
            jax.random.permutation(k_shuf, 4))).long(),
        flip_lr=torch.from_numpy(np.array(jax.random.bernoulli(k_lr, 0.5, (4,)))),
        flip_ud=torch.from_numpy(np.array(jax.random.bernoulli(k_ud, 0.5, (4,)))))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    drawn = pmasker.make_train_patches(t(imgs), 40,
                                       generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (4, 40, 40, 3)


# ---------------------------------------------------------------------------
# defender steps
# ---------------------------------------------------------------------------

def assert_params_after_adam(pst, jparams0, jparams):
    """One Adam step from the same parameters: every parameter within 2 lr of
    JAX's; those whose JAX update is at least .999 lr (a gradient at least
    999 times Adam's eps, well above rounding noise) within 1e-5, and they
    are at least 98% of the U-Net's parameters."""
    from mladversarialobjectdetection_torch.ckpt import bridge
    mine = dict(jax.tree_util.tree_leaves_with_path(
        bridge.torch_to_flax(pst.unet)["params"]))
    before = dict(jax.tree_util.tree_leaves_with_path(host(jparams0)))
    n_sure = n_all = 0
    for path, ref in jax.tree_util.tree_leaves_with_path(host(jparams)):
        name = jax.tree_util.keystr(path)
        diff = np.abs(mine[path] - ref)
        assert float(diff.max()) <= 2 * LR, name
        sure = np.abs(ref - before[path]) >= 0.999 * LR
        assert float(diff[sure].max(initial=0.0)) <= 1e-5, name
        n_sure += int(sure.sum())
        n_all += ref.size
    assert n_sure >= 0.98 * n_all, (n_sure, n_all)


def assert_stats_match(pst, jstats):
    from mladversarialobjectdetection_torch.ckpt import bridge
    mine = dict(jax.tree_util.tree_leaves_with_path(
        bridge.torch_to_flax(pst.unet)["batch_stats"]))
    for path, ref in jax.tree_util.tree_leaves_with_path(host(jstats)):
        close(mine[path], ref, what=jax.tree_util.keystr(path))


def test_train_step_matches_jax(pair, gather_maskers, images):
    """One step with the logged adversarial scores (an extra victim pass),
    against JAX; the same step without them makes the same update."""
    jdef, pdef = pair
    jst, pst = states(jdef, pdef)
    k_mask, _, _ = jax.random.split(jst.key, 3)
    before = sum(warp_cuda.LAUNCHES.values()), cmconv_cuda.LAUNCHES
    jst2, jm = jax.jit(functools.partial(jdef.train_step, with_adv_scores=True))(
        jst, jnp.asarray(images))
    pst, pm = pdef.train_step(pst, t(images), with_adv_scores=True,
                              masker_draws=train_draws(k_mask, 2))
    assert (sum(warp_cuda.LAUNCHES.values()), cmconv_cuda.LAUNCHES) == before
    assert pst.step == int(jst2.step) == 1
    for f in ("loss", "mean_clean_score", "mean_adv_score"):
        close(getattr(pm, f), getattr(jm, f), what=f)
    assert float(pm.mean_clean_score) > 0 and float(pm.mean_adv_score) > 0
    assert np.isnan(float(pm.recovery_psnr)) and np.isnan(float(pm.adr))
    assert_params_after_adam(pst, jst.params, jst2.params)
    assert_stats_match(pst, jst2.batch_stats)
    _, plain = states(jdef, pdef)
    plain, pm0 = pdef.train_step(plain, t(images),
                                 masker_draws=train_draws(k_mask, 2))
    assert float(pm0.mean_adv_score) == 0.0 and torch.equal(pm0.loss, pm.loss)
    for a, b in zip(plain.unet.state_dict().values(), pst.unet.state_dict().values()):
        assert torch.equal(a, b)


def test_grad_accum_step_matches_jax(tiny_detector, person_victim,
                                    gather_maskers, images):
    jdef, pdef = make_pair(tiny_detector, variables=person_victim, grad_accum=2)
    jst, pst = states(jdef, pdef)
    k_mask, _, _ = jax.random.split(jst.key, 3)
    draws = [train_draws(jax.random.fold_in(k_mask, i), 1) for i in range(2)]
    jst2, jm = jax.jit(jdef.train_step)(jst, jnp.asarray(images))
    pst, pm = pdef.train_step(pst, t(images), masker_draws=draws)
    close(pm.loss, jm.loss, what="loss")
    close(pm.mean_clean_score, jm.mean_clean_score, what="clean")
    assert_params_after_adam(pst, jst.params, jst2.params)
    # the statistics moved twice, once per microbatch
    assert_stats_match(pst, jst2.batch_stats)
    with pytest.raises(ValueError, match="divisible"):
        pdef.train_step(pst, t(np.concatenate([images, images[:1]])))


@pytest.fixture(scope="module")
def jax_eval(pair):
    """JAX's eval_step, compiled once: the victim's variables are an
    argument, so each victim below reuses it."""
    return jax.jit(pair[0].eval_step)


def test_eval_step_and_recover_match_jax(pair, person_victim, jax_eval,
                                         gather_maskers, images):
    jdef, pdef = pair
    jst, pst = states(jdef, pdef)
    jm = jax_eval(jst, jnp.asarray(images), 1,
                  det_variables=jax.tree_util.tree_map(jnp.asarray, person_victim))
    pm = pdef.eval_step(pst, t(images), 1,
                        masker_draws=eval_draws(jax.random.fold_in(jst.key, 1), 2))
    for f in ("loss", "mean_clean_score", "mean_adv_score", "recovery_psnr"):
        close(getattr(pm, f), getattr(jm, f), what=f)
    assert np.isfinite(float(pm.recovery_psnr))
    # the victim's scores sit near .5, never above .55: no image is eligible
    assert np.isnan(float(pm.adr)) and np.isnan(float(jm.adr))
    rec = pdef.recover(pst, t(images))
    close(rec, jax.jit(jdef.recover)(jst, jnp.asarray(images)), what="recover")
    assert float(rec.abs().max()) <= 1.0


@pytest.mark.parametrize("logit", [3.0, -10.0], ids=["confident", "nobody"])
def test_eval_psnr_and_adr_match_jax(tiny_detector, pair, jax_eval,
                                     gather_maskers, images, logit):
    """A confident victim: PSNR and ADR are finite where patches were
    planted. A victim that finds nobody plants nothing: both are NaN."""
    jdef, _ = pair
    variables = person_variables(tiny_detector, logit)
    _, pdef = make_pair(tiny_detector, variables=variables)
    jst, pst = states(jdef, pdef)
    jm = jax_eval(jst, jnp.asarray(images), 0,
                  det_variables=jax.tree_util.tree_map(jnp.asarray, variables))
    pm = pdef.eval_step(pst, t(images),
                        masker_draws=eval_draws(jax.random.fold_in(jst.key, 0), 2))
    close(pm.loss, jm.loss, what="loss")
    for f in ("recovery_psnr", "adr"):
        if logit > 0:
            assert np.isfinite(float(getattr(pm, f))), f
            close(getattr(pm, f), getattr(jm, f), what=f)
        else:
            assert np.isnan(float(getattr(pm, f))) and np.isnan(float(getattr(jm, f)))


# ---------------------------------------------------------------------------
# driver, entry points, refusals
# ---------------------------------------------------------------------------

TINY_OVERRIDE = {"fpn_num_filters": 16, "fpn_cell_repeats": 1,
                 "box_class_repeats": 1, "max_boxes_per_image": K,
                 "nms_configs": {"score_thresh": LOW_THRESH}}


def test_train_driver_on_cpu_writes_jax_readable_weights(tmp_path, tiny_detector):
    warps, orig = [], peot.warp_windows

    def spy(canvases, table, w):
        warps.append(table.shape[0])
        return orig(canvases, table, w)

    before = nms_cuda.LAUNCHES, cmconv_cuda.LAUNCHES
    peot.warp_windows = spy
    try:
        state = dtrain.train("efficientdet-lite0", synthetic=True, image_size=64,
                             batch_size=2, epochs=1, steps_per_epoch=2,
                             config_override=TINY_OVERRIDE,
                             victim_variables=host(tiny_detector[3]),
                             save_dir=str(tmp_path), device="cpu")
    finally:
        peot.warp_windows = orig
    assert (nms_cuda.LAUNCHES, cmconv_cuda.LAUNCHES) == before
    assert state.step == 2 and len(warps) >= 2 and min(warps) > 0
    recs = [json_line for json_line in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert any('"val/loss"' in r and '"val/recovery_psnr"' in r for r in recs)
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("patch_00_")]
    # the reference-format mirror beside the pytree file, where h5py is installed
    # (JAX train.py:205-216; tests/test_torch_convert.py reads it back)
    assert len(dirs) == 1 and sorted(os.listdir(tmp_path / dirs[0])) == [
        "antipatch.h5", "antipatch.pkl"]
    restored = jio.load_pytree(str(tmp_path / dirs[0] / "antipatch"))
    from mladversarialobjectdetection_torch.ckpt import bridge
    mine = bridge.torch_to_flax(state.unet)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(mine)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(mine)):
        assert np.array_equal(a, b)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda v, a: junet.PatchNeutralizer(n_filters=8).apply(
        v, a, False))(restored, jnp.asarray(x))
    # tanh is 1-Lipschitz: the output may differ by the rule's share of the
    # pre-tanh logits (the head's output), which reach several units here
    logits = []
    hook = state.unet.output.register_forward_hook(
        lambda mod, args, out: logits.append(out))
    with torch.no_grad():
        out = state.unet(t(x))
    hook.remove()
    close(out, ref, TOL * max(1.0, float(logits[0].abs().max())), "restored U-Net")


def test_score_violin_matches_jax():
    clean, adv = [0.2, 0.6, 0.61], [0.1, 0.05, 0.3]
    out = pvisualize.plot_score_violin(clean, adv)
    assert out.dtype == np.uint8 and out.ndim == 3
    assert np.array_equal(out, jvisualize.plot_score_violin(clean, adv))


def test_defense_entry_points_refuse_cpu_fallback(monkeypatch, tiny_cfg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pconfig.Config(tiny_cfg.as_dict())
    net = pdet.EfficientDetNet(pdet.spec_from_config(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdefender.PatchAttackDefender(cfg, net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtrain.train("efficientdet-lite0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmasker.apply_masker(torch.zeros((1, 16, 16, 3)), torch.zeros((1, 1, 4)),
                             torch.zeros((1, 1), dtype=torch.bool), training=True)


@pytest.mark.parametrize("option", [
    dict(img_dir="x", spatial=2), dict(victim_ckpt=os.path.dirname(__file__)),
    dict(initial_weights="antipatch.h5"), dict(spatial=2)])
def test_train_driver_refuses_unported_options(tmp_path, option):
    """Each raises before any work: `spatial > 1` in one process is JAX's
    error (the axis must divide the devices; at 2 ranks it runs,
    tests/test_torch_spatial_defense.py); the orbax and .h5 intakes are
    ported (tests/test_torch_convert.py), and refuse a directory without
    orbax's metadata and a missing .h5 file."""
    error, match = {"victim_ckpt": (FileNotFoundError, "_METADATA"),
                    "initial_weights": (OSError, "antipatch.h5")}.get(
                        next(iter(option)),
                        (ValueError, "--spatial 2 must divide the 1 devices"))
    with pytest.raises(error, match=match):
        dtrain.train("efficientdet-lite0", device="cpu", save_dir=str(tmp_path),
                     **option)
    assert not os.listdir(tmp_path)


def test_defender_refuses_unported_options(pair):
    _, pdef = pair
    # packed_entry is ported: the defender's victim is a packed view
    packed = pdefender.PatchAttackDefender(pdef.config, pdef.net, device="cpu",
                                           packed_entry=1)
    assert packed.net.backbone.packed_blocks == 1
    assert packed.net.backbone.stem_conv is pdef.net.backbone.stem_conv
    with pytest.raises(ValueError, match="grad_accum"):
        pdefender.PatchAttackDefender(pdef.config, pdef.net, device="cpu",
                                      grad_accum=0)


def test_port_pickle_format_is_jax_readable(tmp_path):
    from mladversarialobjectdetection_torch.ckpt import io as pio
    tree = {"params": {"a": {"kernel": np.arange(6, dtype=np.float32)}}}
    path = pio.save_pytree(str(tmp_path / "w" / "antipatch"), tree)
    assert path.endswith("antipatch.pkl")
    back = jio.load_pytree(str(tmp_path / "w" / "antipatch"))
    assert np.array_equal(back["params"]["a"]["kernel"], tree["params"]["a"]["kernel"])
    with open(path, "rb") as f:
        assert pickle.load(f).keys() == {"params"}
