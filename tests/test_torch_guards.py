"""Guards of the PyTorch port: no JAX inside, no silent CPU fallback, a strict bridge."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.demo import make_demo_detector
from mladversarialobjectdetection_torch.inference import detector as pdetector
from mladversarialobjectdetection_torch.models import efficientdet as pdet
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack import attacker as pattacker
from mladversarialobjectdetection_torch.attack import train as ptrain
from mladversarialobjectdetection_torch.ops import eot as peot
from mladversarialobjectdetection_torch.ops import nms as pnms
from mladversarialobjectdetection_torch.ops import nms_cuda, warp_cuda

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
# any import of these now raises ImportError; cv2, PIL and matplotlib are
# imported only where a frame is read, drawn on or written, or a plot drawn,
# tensorflow only where inference/drivers builds a SavedModel or TFLite driver,
# h5py where a keras .h5 file is read or written, tensorstore where an orbax
# directory is read
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
             "matplotlib", "tensorflow", "h5py", "tensorstore"):
    sys.modules[name] = None
import mladversarialobjectdetection_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
leaked = sorted(m for m in sys.modules if m.startswith("mladversarialobjectdetection_tpu"))
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the port: attack/, data/, defense/, ops/mbconv*.py and
    # inference/streaming.py included, the serving surface around the demos
    # (host NMS and WBF, label maps, the patch compositor, demo/), and the
    # rest of the supervised trainer (TFRecord input, COCO mAP, the drivers,
    # segmentation, pruning, fine-tuning), and export and quantize (the int8
    # conv, the custom ops, the drivers, the inspector, the debug harness), and
    # the converters and the packed backbone entry
    assert int(proc.stdout.split()[-1]) >= 90
    names = set(proc.stdout.split()[:-1])
    for mod in ("ops.nms_np", "ops.wbf", "utils.label_util", "demo", "demo.draw",
                "inference.adv_patch", "demo.synthetic_clip", "demo.video",
                "demo.demo_v2", "demo.demo", "utils.visualize",
                "examples.precision_frontier", "utils.coco_metric",
                "utils.sparsity", "ckpt.finetune", "data.tfrecord",
                "data.create_coco_tfrecord", "data.create_pascal_tfrecord",
                "data.inspect_tfrecords", "data.autoaugment", "data.augment",
                "train.train", "train.eval", "train.segmentation", "utils.debug",
                "ops.conv_int8", "ops.library", "inference.quantize",
                "inference.export", "inference.drivers", "inference.inspector",
                "ckpt.tf_bundle", "ckpt.convert_tf", "ckpt.convert_defense",
                "models.efficientnet_packed"):
        assert f"mladversarialobjectdetection_torch.{mod}" in names, mod


def test_detector_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdetector.Detector("efficientdet-lite0", device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_demo_detector("efficientdet-lite0", device=device)


def test_export_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """The artifact driver and the inspector's detector run on the card
    unless asked for the CPU; the int8 conv takes CUDA tensors or the plain
    route, never a quiet CPU copy."""
    from mladversarialobjectdetection_torch.inference import drivers, inspector
    from mladversarialobjectdetection_torch.ops import conv_int8

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            drivers.ExportedProgramDriver(str(tmp_path / "x.pt2"), "efficientdet-lite0",
                                          device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inspector.build_detector("efficientdet-lite0", device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_int8.conv_int8_cuda(torch.zeros((1, 4, 3, 3)), 0.1,
                                 torch.zeros((4, 4, 1, 1), dtype=torch.int8), torch.ones(4))


def test_attack_entry_points_refuse_cpu_fallback(monkeypatch, tiny_cfg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pconfig.Config(tiny_cfg.as_dict())
    net = pdet.EfficientDetNet(pdet.spec_from_config(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pattacker.PatchAttacker(cfg, net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.get_victim(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.train("efficientdet-lite0", mixed_precision=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peot.apply_patches(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 1, 4)),
                           torch.zeros((1, 1), dtype=torch.bool),
                           torch.zeros((4, 4, 3)), 0.5)


def test_warp_kernels_refuse_before_any_build():
    """dtype, device and the host window table are checked first."""
    before = dict(warp_cuda.LAUNCHES)
    table = torch.tensor([[0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0]])
    with pytest.raises(TypeError, match="float32 only"):
        warp_cuda.pass1_fwd(torch.zeros((1, 4, 4, 3), dtype=torch.float64), table, 8)
    for fn, x, arg in ((warp_cuda.pass1_fwd, torch.zeros((1, 4, 4, 3)), 8),
                       (warp_cuda.pass2_fwd, torch.zeros((1, 4, 8, 3)), None),
                       (warp_cuda.pass2_bwd, torch.zeros((1, 8, 8, 3)), 4),
                       (warp_cuda.pass1_bwd, torch.zeros((1, 4, 8, 3)), 1)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x, table) if arg is None else fn(x, table, arg)
    with pytest.raises(ValueError, match="image index"):
        warp_cuda.check_table(table, 0)
    with pytest.raises(ValueError, match="radius"):
        warp_cuda.check_table(table * torch.tensor([1.0] * 6 + [0.0, 1.0]))
    warp_cuda.check_table(table, 1)
    assert warp_cuda.LAUNCHES == before


def test_nms_refuses_other_devices():
    boxes = torch.zeros((1, 8, 4), device="meta")
    scores = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError):
        pnms.batched_nms_auto(boxes, scores)
    with pytest.raises(ValueError):
        nms_cuda.batched_nms_cuda(boxes, scores)


def test_nms_kernel_takes_float32_only():
    """Checked first, before the device and before any build step."""
    before = nms_cuda.LAUNCHES
    with pytest.raises(TypeError, match="float32 only"):
        nms_cuda.batched_nms_cuda(torch.zeros((1, 8, 4), dtype=torch.float64),
                                  torch.zeros((1, 8), dtype=torch.float64))
    assert nms_cuda.LAUNCHES == before


@pytest.fixture(scope="module")
def tiny_pair(tiny_detector):
    cfg, _, _, variables = tiny_detector
    net = pdet.EfficientDetNet(pdet.spec_from_config(
        pconfig.Config(cfg.as_dict())))
    flat = jax.tree_util.tree_map(np.asarray, variables)
    return net, flat


def test_bridge_loads_tiny_detector(tiny_pair):
    net, variables = tiny_pair
    bridge.load_flax_variables(net, variables)
    assert torch.equal(net.fpn_cells.cell_0.fnode0.bn.running_var, torch.tensor(
        variables["batch_stats"]["fpn_cells"]["cell_0"]["fnode0"]["bn"]["bn"]["var"]))


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def test_bridge_round_trip_of_the_detector_is_exact(tiny_pair):
    """torch_to_flax puts the detector's BatchNorm back under its inner
    `bn` and every kernel back in HWIO."""
    net, variables = tiny_pair
    bridge.load_flax_variables(net, variables)
    back = bridge.torch_to_flax(net)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert np.array_equal(a, np.asarray(b))


def test_bridge_raises_on_missing_key(tiny_pair):
    net, variables = tiny_pair
    broken = _copy(variables)
    del broken["params"]["class_net"]["predict"]["pw"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        bridge.load_flax_variables(net, broken)


def test_bridge_raises_on_extra_key(tiny_pair):
    net, variables = tiny_pair
    broken = _copy(variables)
    broken["params"]["box_net"]["conv_9"] = {"dw": {"kernel": np.zeros((3, 3, 1, 16))}}
    with pytest.raises(KeyError, match="unused"):
        bridge.load_flax_variables(net, broken)


def test_bridge_raises_on_unknown_leaf_and_shape(tiny_pair):
    net, variables = tiny_pair
    broken = _copy(variables)
    broken["params"]["box_net"]["predict"]["pw"]["gamma"] = np.zeros(4)
    with pytest.raises(KeyError, match="unknown Flax variable"):
        bridge.load_flax_variables(net, broken)
    broken = _copy(variables)
    broken["params"]["box_net"]["predict"]["pw"]["bias"] = np.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        bridge.load_flax_variables(net, broken)
