"""The port's checkpoint files and full-state resume, on the CPU.

- Both pytree formats both ways: the JAX package's `load_pytree` reads the
  port's `<path>.pkl`, the port reads JAX's (its pickle fallback); an orbax
  directory, a TF checkpoint and a keras `.h5` each raise, naming ROADMAP.
- The port's msgpack codec is byte-equal to `flax.serialization` on nested
  dicts of float32, int64 and uint8 arrays, 0-d arrays and numpy scalars,
  and equal to the file JAX's `save_state_bytes` writes; it decodes flax's
  bytes, and restores into a template as JAX's `load_state_bytes` does.
- `find_tf_checkpoint` answers as JAX's on a prefix, a directory with a
  `checkpoint` file, one with `*.index` files, a tarball and a missing path.
- Kill and resume: each driver at lite0@64, killed after its first epoch
  and resumed, is bit-equal to the uninterrupted run (patch / U-Net, Adam's
  moments and LR, step, generators), as JAX's `tests/test_resume.py:52-112`
  checks for JAX; the resumed run reads its victim from `victim_ckpt` (and
  the defender its U-Net from `initial_weights`), the uninterrupted one gets
  the same weights as `victim_variables`, so their first steps agree too.
"""
import os
import pickle
import sys
import tarfile

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from mladversarialobjectdetection_tpu.ckpt import convert_tf as jconvert_tf
from mladversarialobjectdetection_tpu.ckpt import io as jio
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack import train as atrain
from mladversarialobjectdetection_torch.ckpt import bridge, convert_tf
from mladversarialobjectdetection_torch.ckpt import io as pio
from mladversarialobjectdetection_torch.ckpt.convert_defense import load_antipatch
from mladversarialobjectdetection_torch.defense import train as dtrain
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer
from mladversarialobjectdetection_torch.utils import train_loop

TINY = {"fpn_num_filters": 16, "fpn_cell_repeats": 1, "box_class_repeats": 1,
        "max_boxes_per_image": 4,
        "nms_configs": {"score_thresh": 0.0099, "pre_nms_topk": 64,
                        "max_output_size": 16}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this file's tests: the tier-1 run
    shares the CPU among six workers, where torch's default of a thread per
    core oversubscribes it and these CPU-heavy steps slow down many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees():
    rng = np.random.default_rng(0)
    return [
        {"params": {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                             "bias": np.zeros(8, np.float32)}},
         "step": np.asarray(7, np.int64), "best": np.asarray(0.25, np.float64),
         "gen": rng.integers(0, 256, 5056).astype(np.uint8)},
        {str(i): {"m": np.full((i,), i, np.float32), "s": np.float32(i / 3)}
         for i in range(20)},
        {"big": rng.normal(size=(70000,)).astype(np.float32),
         "ints": np.arange(-40, 300, dtype=np.int64), "scalar": np.int64(-5)},
    ]


@pytest.mark.parametrize("idx", range(3))
def test_msgpack_codec_is_flax_byte_for_byte(tmp_path, idx):
    tree = _trees()[idx]
    ours = pio.msgpack_serialize(tree)
    assert ours == serialization.msgpack_serialize(tree)
    jio.save_state_bytes(str(tmp_path / "j.msgpack"), tree)
    pio.save_state_bytes(str(tmp_path / "p.msgpack"), tree)
    assert (tmp_path / "j.msgpack").read_bytes() == (tmp_path / "p.msgpack").read_bytes()
    back = pio.msgpack_restore(serialization.msgpack_serialize(tree))
    flat = jax.tree_util.tree_flatten_with_path
    for (pa, a), (pb, b) in zip(flat(tree)[0], flat(back)[0]):
        assert pa == pb and np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


def test_state_bytes_restore_into_a_template_as_jax(tmp_path):
    tree = _trees()[0]
    path = str(tmp_path / "s.msgpack")
    pio.save_state_bytes(path, tree)
    template = {"params": {"conv": {"kernel": 0, "bias": 0}}, "step": 0}
    ours = pio.load_state_bytes(path, template)
    ref = jio.load_state_bytes(path, template)
    assert ours.keys() == ref.keys() == template.keys()  # extra keys ignored
    assert np.array_equal(ours["params"]["conv"]["kernel"],
                          ref["params"]["conv"]["kernel"])
    assert int(ours["step"]) == 7
    with pytest.raises(ValueError, match="lacks keys"):
        pio.load_state_bytes(path, {"missing": 0})


def test_pytree_files_both_ways(tmp_path, monkeypatch):
    tree = {"params": {"a": {"kernel": np.arange(6, dtype=np.float32)}},
            "batch_stats": {"a": {"mean": np.ones(2, np.float32)}}}
    pio.save_pytree(str(tmp_path / "port" / "w"), tree)
    back = jio.load_pytree(str(tmp_path / "port" / "w"))
    assert np.array_equal(back["params"]["a"]["kernel"], tree["params"]["a"]["kernel"])
    # JAX writes its pickle fallback when orbax does not import
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jio.save_pytree(str(tmp_path / "jax" / "w"), tree)
    assert os.path.exists(tmp_path / "jax" / "w.pkl")
    mine = pio.load_pytree(str(tmp_path / "jax" / "w"))
    assert np.array_equal(mine["batch_stats"]["a"]["mean"], np.ones(2))
    with pytest.raises(FileNotFoundError):
        pio.load_pytree(str(tmp_path / "nothing"))


def test_orbax_tf_and_h5_inputs_raise(tmp_path):
    """The orbax, TF and .h5 intakes are ported (tests/test_torch_convert.py):
    an orbax directory (what JAX's save_pytree writes here) reads back, and
    a broken input of each kind raises before any work: a directory without
    orbax's metadata, a TF prefix whose index is empty, a missing .h5."""
    orbax_dir = str(tmp_path / "orbax")
    jio.save_pytree(orbax_dir, {"params": {"k": np.ones(3, np.float32)}})
    assert os.path.isdir(orbax_dir)
    assert np.array_equal(pio.load_pytree(orbax_dir)["params"]["k"], np.ones(3))
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        pio.load_pytree(str(tmp_path))
    prefix = tmp_path / "tf" / "model.ckpt-10"
    prefix.parent.mkdir()
    (tmp_path / "tf" / "model.ckpt-10.index").write_bytes(b"")
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    with pytest.raises(ValueError, match="table footer"):
        atrain.get_victim_variables(cfg, str(tmp_path / "tf"))
    with pytest.raises(ValueError, match="table footer"):
        Detector("efficientdet-lite0", device="cpu", ckpt_path=str(prefix))
    with pytest.raises(OSError):
        load_antipatch(str(tmp_path / "antipatch.h5"))


def _tf_layouts(root):
    """(name, path) of each TF-checkpoint layout and of a missing path."""
    d1 = root / "state"
    d1.mkdir()
    (d1 / "model.ckpt-3.index").write_bytes(b"")
    (d1 / "checkpoint").write_text('model_checkpoint_path: "model.ckpt-3"\n')
    d2 = root / "indexed"
    d2.mkdir()
    for step in (9, 10):
        (d2 / f"model.ckpt-{step}.index").write_bytes(b"")
    tarball = root / "ckpt.tgz"
    with tarfile.open(tarball, "w:gz") as tar:
        tar.add(d2, arcname="efficientdet-lite0")
    return [("prefix", str(d2 / "model.ckpt-9")), ("state file", str(d1)),
            ("index files", str(d2)), ("tarball", str(tarball)),
            ("missing", str(root / "none"))]


def test_find_tf_checkpoint_matches_jax(tmp_path):
    for name, path in _tf_layouts(tmp_path):
        ours = convert_tf.find_tf_checkpoint(path)
        assert ours == jconvert_tf.find_tf_checkpoint(path), name
        assert (ours is None) == (name == "missing"), name


def test_loop_state_file_keeps_the_jax_payload(tmp_path):
    gen = torch.Generator().manual_seed(3)
    plateau = train_loop.ReduceLROnPlateau()
    plateau.best, plateau.wait = 0.5, 7
    path = str(tmp_path / "state-latest.msgpack")
    train_loop.save_loop_state(path, {"w": np.ones(3, np.float32)}, epoch=2,
                               step=11, best=0.25, plateau=plateau, aug_gen=gen)
    raw = pio.msgpack_restore(open(path, "rb").read())
    assert raw.keys() == {"state", "aug_key", "loop", "best", "plateau"}
    gen2, plateau2 = torch.Generator(), train_loop.ReduceLROnPlateau()
    state, epoch, step, best = train_loop.load_loop_state(
        path, {"w": 0}, gen2, plateau2)
    assert (epoch, step, best) == (2, 11, 0.25)
    assert (plateau2.best, plateau2.wait) == (0.5, 7)
    assert torch.equal(gen2.get_state(), gen.get_state())


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

def _victim_file(tmp_path):
    """A tiny victim's Flax variables, and the pytree file holding them."""
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.image_size = 64
    cfg.update(TINY)
    variables = atrain.get_victim_variables(cfg, seed=5)
    path = str(tmp_path / "victim")
    pio.save_pytree(path, variables)
    return variables, path


def _assert_adam_equal(a, b):
    sa, sb = train_loop.adam_state(a), train_loop.adam_state(b)
    flat = jax.tree_util.tree_leaves
    assert all(np.array_equal(x, y) for x, y in zip(flat(sa), flat(sb)))


def test_attack_driver_kill_and_resume(tmp_path):
    variables, vpath = _victim_file(tmp_path)
    # visualize_freq 3 at 2 steps an epoch: every epoch takes one more val
    # batch for the ASR curve, which the resume fast-forward must skip
    kw = dict(synthetic=True, image_size=64, batch_size=2, steps_per_epoch=2,
              patch_size=32, visualize_freq=3, mixed_precision=False,
              config_override=TINY, device="cpu")
    ref = atrain.train("efficientdet-lite0", epochs=2, victim_variables=variables,
                       save_dir=str(tmp_path / "ref"), **kw)
    rdir = str(tmp_path / "resumed")
    atrain.train("efficientdet-lite0", epochs=1, victim_ckpt=vpath,
                 save_dir=rdir, **kw)
    assert os.path.exists(os.path.join(rdir, "state-latest.msgpack"))
    res = atrain.train("efficientdet-lite0", epochs=2, victim_ckpt=vpath,
                       save_dir=rdir, resume=True, **kw)
    assert torch.equal(ref.patch, res.patch) and torch.equal(ref.scale, res.scale)
    assert ref.step == res.step == 4
    assert torch.equal(ref.generator.get_state(), res.generator.get_state())
    _assert_adam_equal(ref.optimizer, res.optimizer)


def test_defense_driver_kill_and_resume(tmp_path):
    variables, vpath = _victim_file(tmp_path)
    unet = PatchNeutralizer(8)
    init_weights(unet, torch.Generator().manual_seed(9))
    weights = str(tmp_path / "antipatch")
    pio.save_pytree(weights, bridge.torch_to_flax(unet))
    kw = dict(synthetic=True, image_size=64, batch_size=2, steps_per_epoch=2,
              config_override=TINY, initial_weights=weights, device="cpu")
    ref = dtrain.train("efficientdet-lite0", epochs=2, victim_variables=variables,
                       save_dir=str(tmp_path / "ref"), **kw)
    rdir = str(tmp_path / "resumed")
    first = dtrain.train("efficientdet-lite0", epochs=1, victim_ckpt=vpath,
                         save_dir=rdir, **kw)
    assert first.step == 2
    res = dtrain.train("efficientdet-lite0", epochs=2, victim_ckpt=vpath,
                       save_dir=rdir, resume=True, **kw)
    for (ka, va), (kb, vb) in zip(ref.unet.state_dict().items(),
                                  res.unet.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert ref.step == res.step == 4
    assert torch.equal(ref.generator.get_state(), res.generator.get_state())
    _assert_adam_equal(ref.optimizer, res.optimizer)
    # initial_weights set the U-Net: a fresh driver call's weights before
    # any step are the file's
    start = bridge.torch_to_flax(dtrain.train(
        "efficientdet-lite0", epochs=0, save_dir=str(tmp_path / "w"), **kw).unet)
    flat = jax.tree_util.tree_leaves
    assert all(np.array_equal(a, b) for a, b in
               zip(flat(start), flat(bridge.torch_to_flax(unet))))


def test_pickle_of_a_victim_is_what_detector_serves(tmp_path):
    """Detector(ckpt_path=) serves the weights of the file."""
    variables, vpath = _victim_file(tmp_path)
    det = Detector("efficientdet-lite0", params=dict(TINY, image_size=64),
                   device="cpu", ckpt_path=vpath)
    net = atrain.get_victim(det.config, variables=variables, device="cpu")
    for (ka, va), (kb, vb) in zip(det.net.state_dict().items(),
                                  net.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with open(vpath + ".pkl", "rb") as f:
        assert pickle.load(f).keys() == {"params", "batch_stats"}
