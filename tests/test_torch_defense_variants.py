"""The port's bf16 and packed defenders against the JAX package's, on the CPU.

`test_torch_defense.py`'s set-up (the tiny lite0@64 victim carried over by
the bridge, a U-Net of n_filters 4 at dropout 0 on the same weights in both
packages, JAX's
masker draws fed in, sensor noise and print transform pinned, the fp32
gather EOT backend) with the JAX defender's options:

- `packed`: `PatchAttackDefender(packed=3)` against JAX's at the same
  depth, fp32, on `test_torch_defense.py`'s person-biased victim. The
  tolerances are that file's.
- bf16 (`config.mixed_precision`): the victim and the U-Net compute in
  bf16 in both packages. A bf16 victim's scores and boxes round at other
  points in the two packages, and a box that moves moves the patch the
  masker plants: the victim here has its class and box predictors' kernels
  zeroed (`flat_victim`), so that its outputs are its biases, every anchor
  a person at score .5 and every box its anchor, the same in both. The
  limits lie between the port's measured distance from JAX's bf16 defender
  and that of a float32 U-Net (JAX's own bf16-vs-float32 distance), so that
  a port that computed the U-Net in float32 would fail, readings on this
  file's seeded weights:
  - the step's loss, eval's loss and PSNR within BF16_LOSS_TOL of JAX's,
    relative (measured 4.9e-5, 1.6e-5, 4.6e-5; a float32 U-Net 1.8e-4,
    7.3e-4, 4.1e-4); the grad_accum=2 step's loss within
    BF16_ACCUM_LOSS_TOL (measured 1.2e-4; each microbatch's BatchNorm
    normalises one image, and a float32 U-Net reads 6.2e-5 there: this one
    bounds, it does not tell the dtypes apart);
  - the step's gradient, read from Adam's first moment (0.1 g after one
    step in both packages), at cosine >= BF16_GRAD_LEAF_COS leaf by leaf,
    but the biases of convs that feed a BatchNorm, whose true gradient is 0,
    and the leaves under bf16's resolution of the largest gradient (worst
    leaf measured 0.952, and 0.934 at grad_accum=2; a float32 U-Net 0.833);
  - after the Adam step, the parameters whose JAX step is at least .999 lr
    within 1e-5 of it for at least BF16_SURE_SHARE of them (measured 0.939;
    a bf16 gradient near 0 may take the other sign); the BatchNorm
    statistics within BF16_STATS_TOL of scale;
  - `recover` from JAX's bf16 `recover` at most BF16_RECOVER_SHARE times
    as far, in the max and on average, as JAX's float32 `recover` is
    (measured 0.51 and 0.63; a float32 U-Net 1.0).

The JAX defenders and their initial states are made once per variant and
grad_accum (`pairs`), on the port's seeded U-Net weights; each test starts
the port from a fresh state with those weights.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.ckpt import io as jio
from mladversarialobjectdetection_tpu.defense import defender as jdefender
from mladversarialobjectdetection_tpu.models import unet as junet
from mladversarialobjectdetection_tpu.models import unet_packed as jpk
from mladversarialobjectdetection_torch.attack import train as atrain
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.defense import defender as pdefender
from mladversarialobjectdetection_torch.defense import train as dtrain
from mladversarialobjectdetection_torch.models import unet as punet
from mladversarialobjectdetection_torch.models import unet_packed as ppk
from mladversarialobjectdetection_torch.ops import cmconv_cuda
from test_torch_defense import gather_maskers  # noqa: F401  the fixture
from test_torch_defense import (LR, TINY_OVERRIDE, assert_params_after_adam,
                                assert_stats_match, close, configs,
                                eval_draws, host, person_variables, t,
                                train_draws)

BF16_LOSS_TOL = 1e-4
BF16_ACCUM_LOSS_TOL = 5e-4
BF16_GRAD_LEAF_COS = 0.88
BF16_STATS_TOL = 1e-3
BF16_SURE_SHARE = 0.9
BF16_RECOVER_SHARE = 0.8
PACKED = 3
# the convs whose bias feeds a BatchNorm: its true gradient is 0
BN_FED = ("cnv1", "cnv2", "conv3")
# bf16's resolution, 2^-8: a gradient leaf below this share of the largest
# one is rounding noise (a 1-channel attention bn3 scale, at 2.8e-4 of the
# largest gradient on JAX's initial weights at grad_accum=2, took the other
# sign in bf16 and in float32 alike)
BF16_RES = 2.0 ** -8

def flat_victim(tiny_detector):
    """The person-biased victim with its class and box predictors' kernels
    zeroed: every anchor a person at score .5, every box its anchor."""
    v = person_variables(tiny_detector, 0.0)
    for head in ("class_net", "box_net"):
        leaf = v["params"][head]["predict"]["pw"]
        leaf["kernel"] = np.zeros_like(leaf["kernel"])
    v["params"]["box_net"]["predict"]["pw"]["bias"] = np.zeros_like(
        v["params"]["box_net"]["predict"]["pw"]["bias"])
    return v


VARIANTS = {"bf16": dict(bf16=True, packed=False),
            "packed": dict(bf16=False, packed=PACKED)}


def make_pair(tiny_detector, variant, *, grad_accum=1):
    """(JAX defender, port defender, victim variables) of a variant, the
    U-Net of n_filters 4 at dropout 0 on the JAX side (`states` sets the
    port's)."""
    opts = VARIANTS[variant]
    cfg = tiny_detector[0]
    variables = (flat_victim(tiny_detector) if opts["bf16"]
                 else person_variables(tiny_detector, 0.0))
    jcfg, pcfg = configs(cfg)
    jcfg.mixed_precision = pcfg.mixed_precision = opts["bf16"]
    patch = np.random.default_rng(0).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    jdef = jdefender.PatchAttackDefender(
        jcfg, jax.tree_util.tree_map(jnp.asarray, variables), eval_patch=patch,
        eval_scale=0.4, n_filters=4, grad_accum=grad_accum, packed=opts["packed"])
    dtype = jnp.bfloat16 if opts["bf16"] else None
    jdef.unet = (jpk.PackedPatchNeutralizer(n_filters=4, dropout=0.0, dtype=dtype,
                                            packed_levels=opts["packed"])
                 if opts["packed"] else
                 junet.PatchNeutralizer(n_filters=4, dropout=0.0, dtype=dtype))
    victim = atrain.get_victim(pcfg, variables=variables, device="cpu")
    pdef = pdefender.PatchAttackDefender(
        pcfg, victim, eval_patch=patch, eval_scale=0.4, n_filters=4,
        grad_accum=grad_accum, packed=opts["packed"], device="cpu")
    return jdef, pdef, variables


@pytest.fixture(scope="module")
def pairs(tiny_detector):
    """pairs(variant, grad_accum) -> (JAX defender, port defender, victim
    variables, JAX initial state), made once for the module."""
    cache = {}

    def get(variant, grad_accum=1):
        if (variant, grad_accum) not in cache:
            jdef, pdef, variables = make_pair(tiny_detector, variant,
                                              grad_accum=grad_accum)
            cache[variant, grad_accum] = (jdef, pdef, variables, jax_state(jdef, pdef))
        return cache[variant, grad_accum]
    return get


def jax_state(jdef, pdef, seed=0):
    """What JAX's `init_state(PRNGKey(seed))` returns, on the port's U-Net
    drawn from `seed` (Flax's initializer families) and carried over by the
    bridge: tracing and compiling JAX's U-Net init costs about 10 s a
    variant on the CPU, and the init is not what these tests hold."""
    v = jax.tree_util.tree_map(jnp.asarray, bridge.torch_to_flax(
        pdef.init_state(seed).unet))
    _, k_state = jax.random.split(jax.random.PRNGKey(seed))
    return jdefender.DefenderState(v["params"], v["batch_stats"],
                                   jdef.tx.init(v["params"]),
                                   jnp.asarray(0, jnp.int32), k_state)


def port_state(pdef, jst, seed=0):
    """The port's state from JAX's initial parameters and statistics, dropout
    0."""
    pst = pdef.init_state(seed, variables={"params": host(jst.params),
                                           "batch_stats": host(jst.batch_stats)})
    for m in pst.unet.modules():
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.0
    return pst


def relative(port, ref):
    return abs(float(port) - float(ref)) / max(1.0, abs(float(ref)))


def cosine(a, b):
    a = np.ravel(a).astype(np.float64)
    b = np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def assert_bf16_grads(pst, jst2):
    """Adam's first moment after one step (0.1 g in both packages) against
    JAX's, leaf by leaf, at cosine >= BF16_GRAD_LEAF_COS; but the biases
    that feed a BatchNorm and the leaves whose gradient lies under bf16's
    resolution of the largest gradient (BF16_RES), whose direction is
    rounding noise in both packages."""
    moments = copy.deepcopy(pst.unet)
    with torch.no_grad():
        for q, p in zip(moments.parameters(), pst.unet.parameters()):
            q.copy_(pst.optimizer.state[p]["exp_avg"])
    mine = dict(jax.tree_util.tree_leaves_with_path(
        bridge.torch_to_flax(moments)["params"]))
    refs = jax.tree_util.tree_leaves_with_path(host(jst2.opt_state.inner_state[0].mu))
    largest = max(float(np.abs(ref).max()) for _, ref in refs)
    worst = (1.0, "")
    for path, ref in refs:
        if (path[-1].key == "bias" and path[-2].key in BN_FED
                or float(np.abs(ref).max()) < BF16_RES * largest):
            continue
        worst = min(worst, (cosine(mine[path], ref), jax.tree_util.keystr(path)))
    assert worst[0] >= BF16_GRAD_LEAF_COS, worst


def assert_bf16_params_after_adam(pst, jparams0, jparams):
    mine = dict(jax.tree_util.tree_leaves_with_path(
        bridge.torch_to_flax(pst.unet)["params"]))
    before = dict(jax.tree_util.tree_leaves_with_path(host(jparams0)))
    n_sure = n_agree = 0
    for path, ref in jax.tree_util.tree_leaves_with_path(host(jparams)):
        sure = np.abs(ref - before[path]) >= 0.999 * LR
        n_sure += int(sure.sum())
        n_agree += int((np.abs(mine[path] - ref)[sure] <= 1e-5).sum())
    assert n_agree >= BF16_SURE_SHARE * n_sure, (n_agree, n_sure)


def assert_bf16_stats(pst, jstats):
    mine = dict(jax.tree_util.tree_leaves_with_path(
        bridge.torch_to_flax(pst.unet)["batch_stats"]))
    for path, ref in jax.tree_util.tree_leaves_with_path(host(jstats)):
        close(mine[path], ref, BF16_STATS_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["step", "accum2"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax(pairs, gather_maskers, rand_images, variant,
                                grad_accum):
    images = np.asarray(rand_images)
    jdef, pdef, _, jst = pairs(variant, grad_accum)
    pst = port_state(pdef, jst)
    assert isinstance(pst.unet, ppk.PackedPatchNeutralizer) == (variant == "packed")
    k_mask, _, _ = jax.random.split(jst.key, 3)
    draws = (train_draws(k_mask, 2) if grad_accum == 1 else
             [train_draws(jax.random.fold_in(k_mask, i), 1) for i in range(2)])
    before = cmconv_cuda.LAUNCHES
    jst2, jm = jax.jit(jdef.train_step)(jst, jnp.asarray(images))
    pst, pm = pdef.train_step(pst, t(images), masker_draws=draws)
    assert cmconv_cuda.LAUNCHES == before and pst.step == int(jst2.step) == 1
    assert float(pm.mean_clean_score) > 0
    close(pm.mean_clean_score, jm.mean_clean_score, what="clean")
    if variant == "packed":
        close(pm.loss, jm.loss, what="loss")
        assert_params_after_adam(pst, jst.params, jst2.params)
        assert_stats_match(pst, jst2.batch_stats)
    else:
        tol = BF16_LOSS_TOL if grad_accum == 1 else BF16_ACCUM_LOSS_TOL
        assert relative(pm.loss, jm.loss) <= tol, (float(pm.loss), float(jm.loss))
        assert_bf16_grads(pst, jst2)
        assert_bf16_params_after_adam(pst, jst.params, jst2.params)
        assert_bf16_stats(pst, jst2.batch_stats)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eval_step_and_recover_match_jax(pairs, gather_maskers, rand_images, variant):
    images = np.asarray(rand_images)
    jdef, pdef, variables, jst = pairs(variant)
    pst = port_state(pdef, jst)
    jm = jax.jit(jdef.eval_step)(jst, jnp.asarray(images), 1, det_variables=
                                 jax.tree_util.tree_map(jnp.asarray, variables))
    pm = pdef.eval_step(pst, t(images), 1,
                        masker_draws=eval_draws(jax.random.fold_in(jst.key, 1), 2))
    rec = pdef.recover(pst, t(images))
    ref = jax.jit(jdef.recover)(jst, jnp.asarray(images))
    assert rec.dtype == torch.float32 and float(rec.abs().max()) <= 1.0
    assert np.isfinite(float(pm.recovery_psnr))
    if variant == "packed":
        for f in ("loss", "mean_clean_score", "mean_adv_score", "recovery_psnr"):
            close(getattr(pm, f), getattr(jm, f), what=f)
        close(rec, ref, what="recover")
    else:
        for f in ("loss", "recovery_psnr"):
            assert relative(getattr(pm, f), getattr(jm, f)) <= BF16_LOSS_TOL, f
        for f in ("mean_clean_score", "mean_adv_score"):
            close(getattr(pm, f), getattr(jm, f), what=f)
        # JAX's recover with a float32 U-Net (defender.py: clip(x + 2 u))
        unet32 = junet.PatchNeutralizer(n_filters=4, dropout=0.0)
        ref32 = jax.jit(lambda v, x: jnp.clip(x + 2.0 * unet32.apply(v, x, False),
                                              -1.0, 1.0))(
            {"params": jst.params, "batch_stats": jst.batch_stats}, jnp.asarray(images))
        err = np.abs(rec.numpy() - np.asarray(ref))
        own = np.abs(np.asarray(ref) - np.asarray(ref32))
        assert (err.max() <= BF16_RECOVER_SHARE * own.max()
                and err.mean() <= BF16_RECOVER_SHARE * own.mean()), (
            err.max(), own.max(), err.mean(), own.mean())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_driver_writes_weights_both_jax_unets_apply(tmp_path, tiny_detector,
                                                          variant):
    """`train(bf16=True)` and `train(packed=3)` on the CPU write an
    `antipatch.pkl` that JAX's `load_pytree` reads and that JAX's unpacked
    and packed U-Nets both apply, in float32 as the port's float32 U-Net
    computes it from the same file (within the fp32 rule's share of the
    pre-tanh logits, which reach several units after two steps: tanh is
    1-Lipschitz), and in bf16 to a finite update in [-1, 1]. Two steps leave
    the running statistics near their initial values, so an eval forward
    does not normalise its activations and the bf16 outputs of the two
    packages are not comparable at a tolerance."""
    state = dtrain.train("efficientdet-lite0", synthetic=True, image_size=64,
                         batch_size=2, epochs=1, steps_per_epoch=2,
                         config_override=TINY_OVERRIDE,
                         victim_variables=host(tiny_detector[3]),
                         save_dir=str(tmp_path), device="cpu", **VARIANTS[variant])
    assert state.step == 2
    assert isinstance(state.unet, ppk.PackedPatchNeutralizer) == (variant == "packed")
    assert (state.unet.dtype == torch.bfloat16) == (variant == "bf16")
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("patch_00_")]
    assert len(dirs) == 1
    restored = jio.load_pytree(str(tmp_path / dirs[0] / "antipatch"))
    mine = bridge.torch_to_flax(state.unet)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(mine)):
        assert np.array_equal(a, b)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    fp32 = punet.PatchNeutralizer(8)
    bridge.load_flax_variables(fp32, restored)
    logits = []
    hook = fp32.output.register_forward_hook(lambda mod, args, o: logits.append(o))
    with torch.no_grad():
        out = fp32(t(x))
    hook.remove()
    tol = 2e-4 * max(1.0, float(logits[0].abs().max()))
    for jnet in (junet.PatchNeutralizer(n_filters=8),
                 jpk.PackedPatchNeutralizer(n_filters=8, packed_levels=PACKED)):
        ref = jax.jit(lambda v, a: jnet.apply(v, a, False))(restored, jnp.asarray(x))
        close(out, ref, tol, type(jnet).__name__)
    if variant == "bf16":
        for jnet in (junet.PatchNeutralizer(n_filters=8, dtype=jnp.bfloat16),
                     jpk.PackedPatchNeutralizer(n_filters=8, dtype=jnp.bfloat16,
                                                packed_levels=PACKED)):
            ref = np.asarray(jax.jit(lambda v, a: jnet.apply(v, a, False))(
                restored, jnp.asarray(x)))
            assert ref.shape == x.shape and np.isfinite(ref).all()
            assert np.abs(ref).max() <= 1.0


def test_defender_refuses_a_victim_of_another_dtype(tiny_detector):
    cfg = tiny_detector[0]
    _, pcfg = configs(cfg)
    victim = atrain.get_victim(pcfg, variables=host(tiny_detector[3]), device="cpu")
    pcfg.mixed_precision = True
    with pytest.raises(ValueError, match="victim computes in torch.float32"):
        pdefender.PatchAttackDefender(pcfg, victim, device="cpu")
    with pytest.raises(ValueError, match="packed"):
        pdefender.PatchAttackDefender(configs(cfg)[1], victim, device="cpu", packed=4)
