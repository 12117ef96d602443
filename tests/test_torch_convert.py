"""The port's converters and orbax intake against the JAX package's, on the CPU.

The port reads a reference TF1 checkpoint (a tensor bundle) with its own
reader (`ckpt/tf_bundle.py`), keras `.h5` defender weights with h5py, and an
orbax directory with tensorstore: none of them with TensorFlow, orbax or
JAX. This file writes its own TF checkpoints with `tf.raw_ops.SaveV2` (the
format of the reference's release tarballs; every raw name holds its value
+ U(1, 2) and its `/ExponentialMovingAverage` shadow the value, as
tests/test_ckpt_file_restore.py:69-90 writes them), its own `.h5` files and
its own orbax directories with the JAX package, in `tmp_path`, and holds:

- `read_bundle` equal to `tf.train.load_checkpoint`, exactly;
- `convert_tf_weights` equal to JAX's leaf for leaf, bit-equal, on a tiny
  lite0 (image 64, fpn_cell_repeats 2, box_class_repeats 2, as JAX's test);
- `Detector(ckpt_path=<tgz>).serve` against JAX's `Detector` on the same
  tarball: valid, valid_len and classes exactly, boxes and scores within
  2e-4 of scale; `restore_pretrained`'s TF1 branch equal to JAX's;
- `.h5` both ways and orbax directories, with equal values.

TensorFlow's import is slow: the TF cases live here, in one module fixture.
"""
import os
import subprocess
import sys
import tarfile

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_config
from mladversarialobjectdetection_tpu.attack import train as jattack_train
from mladversarialobjectdetection_tpu.ckpt import convert_defense as jconvert_defense
from mladversarialobjectdetection_tpu.ckpt import convert_tf as jconvert_tf
from mladversarialobjectdetection_tpu.ckpt import finetune as jfinetune
from mladversarialobjectdetection_tpu.ckpt import io as jio
from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
from mladversarialobjectdetection_tpu.models import efficientdet as jdet
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack import train as pattack_train
from mladversarialobjectdetection_torch.ckpt import bridge, convert_defense, convert_tf
from mladversarialobjectdetection_torch.ckpt import finetune, tf_bundle
from mladversarialobjectdetection_torch.ckpt import io as pio
from mladversarialobjectdetection_torch.defense import train as dtrain
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.models import efficientdet as pdet
from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tf():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    return pytest.importorskip("tensorflow")


def save_v2(tf, prefix, tensors):
    names = sorted(tensors)
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(tensors[n]) for n in names])


def assert_same_tensors(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert np.asarray(got[name]).dtype == np.asarray(value).dtype, name
        assert np.array_equal(np.asarray(got[name]), np.asarray(value)), name


def tf_reader_dict(tf, prefix):
    reader = tf.train.load_checkpoint(prefix)
    return {n: reader.get_tensor(n) for n in reader.get_variable_to_shape_map()}


# ---------------------------------------------------------------------------
# the tensor bundle reader
# ---------------------------------------------------------------------------

BUNDLES = {
    "float32": {"conv/kernel": np.random.default_rng(0).normal(
        size=(3, 3, 4, 8)).astype(np.float32)},
    "float64": {"w": np.random.default_rng(1).normal(size=(5, 7))},
    "int64 scalar": {"global_step": np.int64(123456789012)},
    "multi-entry": {
        **{f"blocks_{i}/conv2d/kernel": np.random.default_rng(i).normal(
            size=(1, 1, i + 1, 3)).astype(np.float32) for i in range(40)},
        "a/bool": np.array([True, False, True]), "a/half": np.arange(
            6, dtype=np.float16).reshape(2, 3),
        "a/int32": np.arange(-3, 3, dtype=np.int32), "empty": np.zeros((0, 4), np.float32),
        "global_step": np.int64(7)},
}


@pytest.mark.parametrize("case", sorted(BUNDLES))
def test_read_bundle_equals_tf_load_checkpoint(tf, tmp_path, case):
    prefix = str(tmp_path / "model.ckpt-7")
    save_v2(tf, prefix, BUNDLES[case])
    got = tf_bundle.read_bundle(prefix)
    assert_same_tensors(got, tf_reader_dict(tf, prefix))
    assert_same_tensors(got, BUNDLES[case])
    assert convert_tf.load_tf_checkpoint(prefix).keys() == got.keys()


def test_read_bundle_raises_on_a_corrupted_tensor_and_other_dtypes(tf, tmp_path):
    prefix = str(tmp_path / "model")
    save_v2(tf, prefix, {"a": np.arange(64, dtype=np.float32)})
    data = tmp_path / "model.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[17] ^= 0x01
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC mismatch in tensor 'a'"):
        tf_bundle.read_bundle(prefix)
    index = tmp_path / "model.index"
    raw = bytearray(index.read_bytes())
    raw[-1] ^= 0xFF
    index.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bad magic"):
        tf_bundle.read_bundle(prefix)
    save_v2(tf, str(tmp_path / "s" / "model"), {"name": np.array(b"lite4")})
    with pytest.raises(ValueError, match="DT_STRING"):
        tf_bundle.read_bundle(str(tmp_path / "s" / "model"))


def test_chip_smoke_bundle_writer_is_read_by_tensorflow(tf, tmp_path):
    """`chip_smoke.write_tf_bundle` (phase 23d's writer, not the package's)
    writes what TensorFlow reads, and the port's reader reads it too."""
    sys.path.insert(0, REPO)
    import chip_smoke
    tensors = dict(BUNDLES["multi-entry"])
    tensors.update(BUNDLES["float64"])
    prefix = str(tmp_path / "model")
    chip_smoke.write_tf_bundle(prefix, tensors)
    assert_same_tensors(tf_reader_dict(tf, prefix), tensors)
    assert_same_tensors(tf_bundle.read_bundle(prefix), tensors)


# ---------------------------------------------------------------------------
# the detector converter
# ---------------------------------------------------------------------------

def lite0_config():
    cfg = tiny_config(64)
    cfg.fpn_cell_repeats = 2
    cfg.box_class_repeats = 2
    return cfg


def reference_tf_weights(jcfg, jspec, variables, seed=1):
    """The detector's variables under the reference's TF names, through JAX's
    `_NameMapper` (its transforms undone, WSM split into scalars): raw names
    off by U(1, 2), EMA shadows true."""
    mapper = jconvert_tf._NameMapper(jcfg, jspec)
    rng = np.random.RandomState(seed)
    out = {}
    for collection, tree in variables.items():
        for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            path = tuple(k.key for k in keys)
            name, transform = mapper(collection, path)
            leaf = np.asarray(leaf, np.float32)
            if path[-1] == "WSM":
                vals = {name if i == 0 else f"{name}_{i}": leaf[i]
                        for i in range(leaf.shape[0])}
            elif transform is jconvert_tf._dw_to_flax:
                vals = {name: leaf.transpose(0, 1, 3, 2)}
            else:
                vals = {name: leaf}
            for n, v in vals.items():
                v = np.asarray(v, np.float32)
                out[f"{n}/ExponentialMovingAverage"] = v
                out[n] = (v + rng.uniform(1.0, 2.0, v.shape)).astype(np.float32)
    return out


def redraw(variables, seed):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name in ("var", "scale", "WSM"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.uniform(-0.3, 0.3, shape).astype(np.float32)
        return np.asarray(leaf, np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def release(tf, tmp_path_factory):
    """(JAX config, spec, true variables, fresh variables, TF weights, the
    release tarball): a tiny lite0 written as the reference's GCS tarball
    (`efficientdet-lite0/` holding `checkpoint` and `model.ckpt-7.*`)."""
    jcfg = lite0_config()
    jspec = jdet.spec_from_config(jcfg)
    net = jdet.EfficientDetNet(jspec)
    x = np.zeros((1, 64, 64, 3), np.float32)
    init = jax.jit(net.init, static_argnames=("training",))
    fresh = jax.tree_util.tree_map(np.asarray, init({"params": jax.random.PRNGKey(0)},
                                                    x, training=False))
    true = redraw(init({"params": jax.random.PRNGKey(3)}, x, training=False), seed=4)
    weights = reference_tf_weights(jcfg, jspec, true)
    root = tmp_path_factory.mktemp("release")
    ckdir = root / "efficientdet-lite0"
    save_v2(tf, str(ckdir / "model.ckpt-7"), weights)
    (ckdir / "checkpoint").write_text('model_checkpoint_path: "model.ckpt-7"\n')
    tgz = str(root / "efficientdet-lite0.tgz")
    with tarfile.open(tgz, "w:gz") as tar:
        tar.add(str(ckdir), arcname="efficientdet-lite0")
    return jcfg, jspec, true, fresh, weights, tgz


def assert_trees_equal(got, want):
    flat_g = dict(convert_tf._leaves(got))
    flat_w = {tuple(k.key for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat_g.keys() == flat_w.keys()
    for k, v in flat_w.items():
        assert flat_g[k].dtype == v.dtype and np.array_equal(flat_g[k], v), k


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_convert_tf_weights_equals_jax(release, prefer_ema):
    jcfg, jspec, true, fresh, weights, tgz = release
    pcfg = pconfig.Config(jcfg.as_dict())
    prefix = convert_tf.find_tf_checkpoint(tgz)
    assert prefix == jconvert_tf.find_tf_checkpoint(tgz)
    read = convert_tf.load_tf_checkpoint(prefix)
    assert_same_tensors(read, weights)
    ours = convert_tf.convert_tf_weights(read, pcfg, pdet.spec_from_config(pcfg), fresh,
                                         prefer_ema=prefer_ema)
    ref = jconvert_tf.convert_tf_weights(weights, jcfg, jspec, fresh, prefer_ema=prefer_ema)
    assert_trees_equal(ours, ref)
    if prefer_ema:  # the shadows are the true values
        assert_trees_equal(ours, true)


def test_convert_tf_weights_non_strict_skips_equal_jax(release):
    jcfg, jspec, _, fresh, weights, _ = release
    pcfg = pconfig.Config(jcfg.as_dict())
    partial = {k: v for k, v in weights.items()
               if "box_net" not in k and "resample_p6" not in k}
    partial["class_net/class-predict/bias"] = np.zeros(3, np.float32)  # wrong shape
    partial.pop("class_net/class-predict/bias/ExponentialMovingAverage")
    skip = lambda coll, path: "stem_conv" in path
    ours = convert_tf.convert_tf_weights(partial, pcfg, pdet.spec_from_config(pcfg), fresh,
                                         skip=skip, strict=False)
    ref = jconvert_tf.convert_tf_weights(partial, jcfg, jspec, fresh, skip=skip,
                                         strict=False)
    assert_trees_equal(ours, ref)
    with pytest.raises(KeyError):
        convert_tf.convert_tf_weights(partial, pcfg, pdet.spec_from_config(pcfg), fresh)


def test_detector_serves_the_release_tarball_as_jax(release):
    jcfg, _, _, _, _, tgz = release
    params = {"fpn_cell_repeats": 2, "box_class_repeats": 2, "image_size": 64,
              "fpn_num_filters": 16, "nms_configs": {"score_thresh": 0.0099}}
    frames = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8)
              for i in range(2)]
    ref = JDetector(model_name="efficientdet-lite0", params=params, ckpt_path=tgz).serve(
        frames)
    det = Detector("efficientdet-lite0", params=params, device="cpu", ckpt_path=tgz)
    got = det.serve(frames)
    for field in ("valid", "valid_len", "classes"):
        assert np.array_equal(getattr(got, field), np.asarray(getattr(ref, field))), field
    assert int(np.asarray(ref.valid_len).sum()) > 0
    for field in ("boxes", "scores"):
        want = np.asarray(getattr(ref, field))
        tol = SERVE_TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(getattr(got, field), want, rtol=0, atol=tol)


def test_victim_variables_from_the_tarball_equal_jax(release):
    jcfg, _, true, _, _, tgz = release
    pcfg = pconfig.Config(jcfg.as_dict())
    ours = pattack_train.get_victim_variables(pcfg, tgz)
    ref = jattack_train.get_victim_variables(jcfg, tgz)
    assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, ref))
    assert_trees_equal(ours, true)


def test_convert_cli_writes_the_pytree_file(tf, tmp_path):
    """`python -m ...ckpt.convert_tf` on a release tarball of lite0 at its
    own widths (image 64) writes `<out>.pkl` holding the EMA values."""
    jcfg = tiny_config(64)
    jcfg.fpn_num_filters, jcfg.fpn_cell_repeats, jcfg.box_class_repeats = 64, 3, 3
    pcfg = pconfig.Config(jcfg.as_dict())
    net = pdet.EfficientDetNet(pdet.spec_from_config(pcfg))
    true = redraw(bridge.torch_to_flax(net), seed=6)
    weights = reference_tf_weights(jcfg, jdet.spec_from_config(jcfg), true, seed=7)
    save_v2(tf, str(tmp_path / "efficientdet-lite0" / "model"), weights)
    (tmp_path / "efficientdet-lite0" / "checkpoint").write_text(
        'model_checkpoint_path: "model"\n')
    tgz = str(tmp_path / "lite0.tar.gz")
    with tarfile.open(tgz, "w:gz") as tar:
        tar.add(str(tmp_path / "efficientdet-lite0"), arcname="efficientdet-lite0")
    out = str(tmp_path / "converted" / "lite0")
    proc = subprocess.run(
        [sys.executable, "-m", "mladversarialobjectdetection_torch.ckpt.convert_tf",
         "--ckpt", tgz, "--model", "efficientdet-lite0", "--out", out,
         "--image-size", "64"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("lite0.pkl")
    assert_trees_equal(pio.load_pytree(out), true)
    assert_trees_equal(jio.load_pytree(out), true)


@pytest.mark.parametrize("mode", ["backbone", "trunk"])
def test_restore_pretrained_tf1_branch_equals_jax(release, mode):
    jcfg, jspec, _, fresh, _, tgz = release
    pcfg = pconfig.Config(jcfg.as_dict())
    ours = finetune.restore_pretrained(fresh, tgz, pcfg, pdet.spec_from_config(pcfg),
                                       mode=mode)
    ref = jfinetune.restore_pretrained(fresh, tgz, jcfg, jspec, mode=mode)
    assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, ref))


# ---------------------------------------------------------------------------
# keras .h5 defender weights and orbax directories
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_vars():
    """The port's U-Net's variables (n_filters 8), statistics redrawn."""
    return redraw(bridge.torch_to_flax(PatchNeutralizer()), seed=5)


def test_h5_both_ways(tmp_path, unet_vars):
    import h5py
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    convert_defense.save_antipatch_h5(unet_vars, mine)
    jconvert_defense.save_antipatch_h5(unet_vars, theirs)
    with h5py.File(mine, "r") as a, h5py.File(theirs, "r") as b:
        assert dict(a.attrs).keys() == dict(b.attrs).keys()
        for k in a.attrs:
            assert np.array_equal(a.attrs[k], b.attrs[k]), k
        assert list(a) == list(b)
        for layer in (n.decode() for n in a.attrs["layer_names"]):
            assert np.array_equal(a[layer].attrs["weight_names"],
                                  b[layer].attrs["weight_names"]), layer
        datasets = []
        a.visititems(lambda name, obj: datasets.append(name)
                     if isinstance(obj, h5py.Dataset) else None)
        assert len(datasets) == len(list(convert_tf._leaves(unet_vars)))
        for name in datasets:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name][()],
                                                                     b[name][()]), name
    assert convert_defense.load_antipatch_h5(mine).keys() == \
        jconvert_defense.load_antipatch_h5(theirs).keys()
    # each package reads the other's file onto its own template
    template = jax.tree_util.tree_map(np.zeros_like, unet_vars)
    assert_trees_equal(convert_defense.load_antipatch(theirs), unet_vars)
    assert_trees_equal(convert_defense.load_antipatch(mine, template), unet_vars)
    ref = jconvert_defense.load_antipatch(mine, template)
    assert_trees_equal(convert_defense.load_antipatch(theirs),
                       jax.tree_util.tree_map(np.asarray, ref))
    bridge.load_flax_variables(PatchNeutralizer(), convert_defense.load_antipatch(theirs))
    with pytest.raises(KeyError, match="missing"):
        convert_defense.convert_unet_weights({}, unet_vars)


def test_defense_driver_takes_h5_weights_and_writes_the_mirror(tmp_path, unet_vars,
                                                               tiny_detector):
    h5 = str(tmp_path / "init" / "antipatch.h5")
    os.makedirs(os.path.dirname(h5))
    jconvert_defense.save_antipatch_h5(unet_vars, h5)
    override = {"fpn_num_filters": 16, "fpn_cell_repeats": 1, "box_class_repeats": 1,
                "nms_configs": {"score_thresh": 0.0099}}
    state = dtrain.train("efficientdet-lite0", synthetic=True, image_size=64,
                         batch_size=2, epochs=1, steps_per_epoch=1,
                         config_override=override, initial_weights=h5,
                         victim_variables=jax.tree_util.tree_map(
                             np.asarray, tiny_detector[3]),
                         save_dir=str(tmp_path / "run"), device="cpu")
    assert state.step == 1
    (art,) = [d for d in os.listdir(tmp_path / "run") if d.startswith("patch_00_")]
    files = sorted(os.listdir(tmp_path / "run" / art))
    assert files == ["antipatch.h5", "antipatch.pkl"]
    pkl = pio.load_pytree(str(tmp_path / "run" / art / "antipatch"))
    mirror = jconvert_defense.load_antipatch(str(tmp_path / "run" / art / "antipatch.h5"),
                                             unet_vars)
    assert_trees_equal(pkl, jax.tree_util.tree_map(np.asarray, mirror))


def test_load_pytree_reads_jax_orbax_directories(tmp_path):
    tree = {"params": {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
                       "b": {"bias": np.ones(3, np.float64)}},
            "batch_stats": {"a": {"mean": np.zeros(2, np.float32)}},
            "step": np.asarray(5, np.int64), "flag": np.asarray(True),
            "i16": np.arange(3, dtype=np.int16)}
    path = str(tmp_path / "w")
    jio.save_pytree(path, tree)
    assert os.path.isfile(os.path.join(path, "_METADATA"))
    got, want = pio.load_pytree(path), jio.load_pytree(path)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert type(a) is type(b) and a.dtype == b.dtype and np.array_equal(a, b)
    # and without JAX, orbax or TensorFlow in the process
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'tensorflow'):\n"
            "    sys.modules[m] = None\n"
            "from mladversarialobjectdetection_torch.ckpt import io\n"
            f"t = io.load_pytree({path!r})\n"
            "print(sorted(t), int(t['step']), t['params']['a']['kernel'].sum())\n"
            "print([m for m in ('jax', 'orbax', 'tensorflow') if sys.modules.get(m)])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == [
        "['batch_stats', 'flag', 'i16', 'params', 'step'] 5 15.0", "[]"]


def test_orbax_victim_and_python_scalars(tmp_path, tiny_detector):
    """A JAX-written orbax victim serves through the attack driver's
    `get_victim_variables`; orbax's own scalar leaves come back as Python
    scalars, lists as lists, as orbax restores them."""
    import orbax.checkpoint as ocp
    cfg, _, _, variables = tiny_detector
    host = jax.tree_util.tree_map(np.asarray, variables)
    path = str(tmp_path / "victim")
    jio.save_pytree(path, host)
    got = pattack_train.get_victim_variables(pconfig.Config(cfg.as_dict()), path)
    assert_trees_equal(got, host)
    tree = {"a": 3, "b": 2.5, "l": [np.ones(2, np.float32), np.zeros(1)], "e": {}}
    ocp.PyTreeCheckpointer().save(str(tmp_path / "s"), tree, force=True)
    back = pio.load_pytree(str(tmp_path / "s"))
    want = ocp.PyTreeCheckpointer().restore(str(tmp_path / "s"))
    assert back["a"] == want["a"] == 3 and type(back["a"]) is type(want["a"])
    assert back["b"] == want["b"] == 2.5 and back["e"] == want["e"] == {}
    assert isinstance(back["l"], list) and len(back["l"]) == 2
    assert all(np.array_equal(x, y) for x, y in zip(back["l"], want["l"]))
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        pio.load_pytree(str(tmp_path))
