"""The port's supervised train and eval drivers against the JAX package's, on the CPU.

`train/train.py` and `train/eval.py` on fake TFRecords of 64 px person
scenes (written by the port's `create_coco_tfrecord`), the tiny lite0 with
its class head biased toward persons (so that the random net detects, as
the defender tests do); the val records' ground truth is the seed-0
detector's own top box per image, so AP is neither 0 nor -1:

- Both drivers resume from one `state-latest.msgpack` (JAX's initial
  `TrainState` on the same weights) and run 2 epochs of 1 step, with the
  COCO evaluation after the second. As ROADMAP Queue 3 item 22 holds the
  train step at this badly conditioned size, the float32 runs are held to
  each other within F32_SHARE times JAX's own float32 error (its distance
  from the port's float64 run of the same driver, whose first loss is held
  to JAX's within 1e-5 relative), or METRIC_REL for a metric and
  2e-4 * max(1, max|ref|) for a checkpoint leaf: each epoch's train
  metrics, each `ckpt-{epoch}`, and the port's `state-latest.msgpack` read
  by JAX's `load_state_bytes` into JAX's template; the eval/ metrics within
  EVAL_ABS.
- The port's driver killed after an epoch and resumed is bit-equal to an
  uninterrupted run; pruning reaches its sparsity with the EMA masked;
  fine-tuning in trunk mode keeps the fresh predict layers; spatial raises.
- `eval.evaluate` (per-class AP names) and `eval.follow` (the archive, a
  checkpoint deleted mid-eval, the idle timeout) against JAX's on the same
  records and checkpoint variables, within EVAL_ABS.
"""
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from mladversarialobjectdetection_tpu import config as jconfig
from mladversarialobjectdetection_tpu.ckpt import io as jio
from mladversarialobjectdetection_tpu.train import eval as jeval
from mladversarialobjectdetection_tpu.train import train as jtrain
from mladversarialobjectdetection_tpu.train import trainer as jtrainer
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.ckpt import io as pio
from mladversarialobjectdetection_torch.data import create_coco_tfrecord as pcoco
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.train import eval as peval
from mladversarialobjectdetection_torch.train import train as ptrain
from mladversarialobjectdetection_torch.train import trainer as ptrainer

TINY = {"fpn_num_filters": 16, "fpn_cell_repeats": 1, "box_class_repeats": 1,
        "nms_configs": {"pre_nms_topk": 64, "max_output_size": 16},
        "max_instances_per_image": 4, "moving_average_decay": 0.9}
EVAL_ABS = 1e-6  # COCO metrics: the same detections, in the same order
F32_SHARE = 2.0  # float32: the port's distance / JAX's own float32 error
METRIC_REL = 1e-4  # or a train metric's relative distance (the box loss, a
                   # sum of small huber terms, is 1.7e-5 apart at the first step)
KW = dict(batch_size=2, steps_per_epoch=1, image_size=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = jconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.image_size = 64
    cfg.update(TINY)
    return cfg


def _scene(rng):
    """A 64 px scene with 1-2 bright rectangles; their normalized boxes."""
    img = rng.integers(0, 90, (64, 64, 3), dtype=np.uint8)
    boxes = []
    for _ in range(int(rng.integers(1, 3))):
        y0, x0 = rng.uniform(0, 0.4, 2)
        h, w = rng.uniform(0.3, 0.55, 2)
        img[int(y0 * 64):int((y0 + h) * 64), int(x0 * 64):int((x0 + w) * 64)] = \
            rng.integers(150, 255, 3)
        boxes.append([y0, x0, y0 + h, x0 + w])
    return img, np.asarray(boxes)


def _example(img, boxes, crowd, i):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return pcoco.make_example(buf.getvalue(), 64, 64, boxes, [1] * len(boxes),
                              crowd, str(i))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Train records (1-2 persons, a crowd) and val records whose ground
    truth is the seed-0 detector's top person box and a crowd."""
    root = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(0)
    train = []
    for i in range(4):
        img, boxes = _scene(rng)
        train.append(_example(img, boxes, [int(i == 3)] * len(boxes), i))
    pcoco.write_records(train, str(root / "train.tfrecord"))
    scenes = [_scene(rng)[0] for _ in range(4)]
    det = Detector("efficientdet-lite0", params=dict(TINY, image_size=64),
                   device="cpu", post_mode="per_class")
    det.load_flax_variables(_variables())
    top = det.serve(scenes)
    val = []
    for i, img in enumerate(scenes):
        best = top.boxes[i][:1] / 64.0
        boxes = np.concatenate([best, [[0.0, 0.0, 0.3, 0.3]]])
        val.append(_example(img, boxes, [0, 1], 10 + i))
    pcoco.write_records(val, str(root / "val.tfrecord"))
    return str(root / "train.tfrecord"), str(root / "val.tfrecord")


def _variables(seed=0):
    """The port's seeded tiny weights as Flax variables, the class head's
    person logits raised by 2 (scores about .6-.95 instead of .01)."""
    cfg = pconfig.Config(_cfg().as_dict())
    tr = ptrainer.DetectorTrainer(cfg, device="cpu")
    variables = bridge.torch_to_flax(tr.init_state(seed=seed).net)
    bias = variables["params"]["class_net"]["predict"]["pw"]["bias"]
    bias[::cfg.num_classes] += 2.0
    return variables


@pytest.fixture(scope="module")
def start_file(tmp_path_factory):
    """JAX's initial TrainState on `_variables()`, as state bytes."""
    path = str(tmp_path_factory.mktemp("start") / "state-latest.msgpack")
    variables = jax.tree_util.tree_map(jnp.asarray, _variables())
    jt = jtrainer.DetectorTrainer(_cfg(), steps_per_epoch=1)
    params = variables["params"]
    jio.save_state_bytes(path, jtrainer.TrainState(
        params, variables["batch_stats"], jax.tree_util.tree_map(jnp.copy, params),
        jt.tx.init(params), jnp.asarray(0, jnp.int32)))
    return path


def _double_init_state(monkeypatch):
    """The port's trainer at 64 bits (as tests/test_torch_train.py's)."""
    real = ptrainer.DetectorTrainer.init_state

    def init64(self, *args, **kwargs):
        st = real(self, *args, **kwargs)
        st.net.double()
        st.net.compute_dtype = torch.float64
        st.ema = {n: e.double() for n, e in st.ema.items()}
        return st

    monkeypatch.setattr(ptrainer.DetectorTrainer, "init_state", init64)


def _log(model_dir):
    with open(os.path.join(model_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tree_dist(got, ref):
    """Per leaf max|got - ref| / max(1, max|ref|), the worst leaf."""
    got, ref = _leaves(got), _leaves(ref)
    assert got.keys() == ref.keys()
    return max((np.abs(got[k] - v).max() / max(1.0, np.abs(v).max()), k)
               for k, v in ref.items())


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _run_driver(pkg, model_dir, start_file, **kw):
    os.makedirs(model_dir)
    shutil.copy(start_file, model_dir)
    train = jtrain.train if pkg == "jax" else ptrain.train
    if pkg != "jax":
        kw["device"] = "cpu"
    state = train("efficientdet-lite0", model_dir=model_dir, num_epochs=2,
                  resume=True, config_override=TINY, **KW, **kw)
    ckpts = [(jio if pkg == "jax" else pio).load_pytree(
        os.path.join(model_dir, f"ckpt-{e}")) for e in range(2)]
    return state, _log(model_dir), ckpts


def test_both_drivers_from_one_state_file(records, start_file, tmp_path,
                                          monkeypatch):
    train_pat, val_pat = records
    kw = dict(train_pattern=train_pat, val_pattern=val_pat, eval_batches=2,
              map_freq=2)
    _, jlog, jckpts = _run_driver("jax", str(tmp_path / "jax"), start_file, **kw)
    pstate, plog, pckpts = _run_driver("port", str(tmp_path / "port"), start_file, **kw)
    with monkeypatch.context() as m:  # the float64 reference of the same run
        _double_init_state(m)
        _, log64, ckpts64 = _run_driver("port", str(tmp_path / "p64"), start_file,
                                        train_pattern=train_pat)
    assert pstate.step == 2
    assert [r["step"] for r in plog] == [r["step"] for r in jlog] == [1, 2, 2]
    assert _rel(log64[0]["train/loss"], jlog[0]["train/loss"]) <= 1e-5
    for got, ref, r64 in zip(plog, jlog, log64 + [None]):
        assert got.keys() == ref.keys()
        for key in ref:
            if key.startswith("train/"):
                own = _rel(ref[key], r64[key])
                assert _rel(got[key], ref[key]) <= max(METRIC_REL, F32_SHARE * own), key
            elif key.startswith("eval/"):
                assert abs(got[key] - ref[key]) <= EVAL_ABS, (key, got[key], ref[key])
    assert 0 < jlog[-1]["eval/AP"] < 1 and 0 < jlog[-1]["eval/AP50"]
    for got, ref, c64 in zip(pckpts, jckpts, ckpts64):
        own = _tree_dist(ref, c64)[0]
        dist = _tree_dist(got, ref)
        assert dist[0] <= max(2e-4, F32_SHARE * own), (dist, own)
    # JAX reads the port's state file into its own template, leaf for leaf
    jt = jtrainer.DetectorTrainer(_cfg(), steps_per_epoch=1)
    read = jio.load_state_bytes(str(tmp_path / "port" / "state-latest.msgpack"),
                                jt.init_state(jax.random.PRNGKey(0)))
    ours = ptrainer.DetectorTrainer(pconfig.Config(_cfg().as_dict()),
                                    device="cpu").state_dict(pstate)
    assert _tree_dist(serialization.to_state_dict(read), ours)[0] == 0.0


def test_port_driver_resume_prune_finetune(tmp_path):
    kw = dict(config_override=TINY, device="cpu", **KW)
    rdir = str(tmp_path / "resumed")
    first = ptrain.train("efficientdet-lite0", model_dir=rdir, num_epochs=2, **kw)
    trainer = ptrainer.DetectorTrainer(pconfig.Config(_cfg().as_dict()), device="cpu")
    saved = trainer.state_dict(first)
    # resume reads the state file back bit for bit: nothing left to train
    same = ptrain.train("efficientdet-lite0", model_dir=rdir, num_epochs=2,
                        resume=True, **kw)
    assert same.step == 2 and _tree_dist(trainer.state_dict(same), saved)[0] == 0.0
    # and continues at epoch 2 (the input stream restarts, as JAX's does)
    res = ptrain.train("efficientdet-lite0", model_dir=rdir, num_epochs=4,
                       resume=True, **kw)
    assert res.step == 4
    assert [r["step"] for r in _log(rdir)] == [1, 2, 3, 4]
    assert sorted(os.listdir(rdir)) == ["ckpt-0.pkl", "ckpt-1.pkl", "ckpt-2.pkl",
                                        "ckpt-3.pkl", "logs", "state-latest.msgpack"]
    # pruning: every kernel at .5 within one weight, the EMA zero with it
    pruned = ptrain.train("efficientdet-lite0", model_dir=str(tmp_path / "p"),
                          num_epochs=2, prune_sparsity=0.5, prune_end=2, **kw)
    for path, p in bridge.named_kernel_parameters(pruned.net):
        zeros = int((p == 0).sum())
        assert abs(zeros - 0.5 * p.numel()) <= 1, path
    named = dict(pruned.net.named_parameters())
    for path, p in bridge.named_kernel_parameters(pruned.net):
        name = next(n for n, q in named.items() if q is p)
        assert bool((pruned.ema[name][p == 0] == 0).all()), path
    assert _log(str(tmp_path / "p"))[-1]["train/sparsity"] == pytest.approx(0.5, abs=1e-3)
    # fine-tune (trunk): the predict layers keep the fresh init, the rest
    # is the checkpoint's
    ft = ptrain.train("efficientdet-lite0", model_dir=str(tmp_path / "ft"),
                      num_epochs=0, pretrained_ckpt=os.path.join(rdir, "ckpt-3"),
                      finetune_mode="trunk", **kw)
    got = bridge.torch_to_flax(ft.net)["params"]
    pre = pio.load_pytree(os.path.join(rdir, "ckpt-3"))["params"]
    fresh = bridge.torch_to_flax(ptrainer.DetectorTrainer(
        pconfig.Config(_cfg().as_dict()), device="cpu").init_state(seed=0).net)["params"]
    assert np.array_equal(got["class_net"]["predict"]["pw"]["kernel"],
                          fresh["class_net"]["predict"]["pw"]["kernel"])
    assert np.array_equal(got["class_net"]["conv_0"]["pw"]["kernel"],
                          pre["class_net"]["conv_0"]["pw"]["kernel"])
    # spatial > 1 runs at 2 ranks (tests/test_torch_spatial.py); in one
    # process it is JAX's error
    with pytest.raises(ValueError, match="--spatial 2 must divide the 1 devices"):
        ptrain.train("efficientdet-lite0", model_dir=str(tmp_path / "s"),
                     num_epochs=1, spatial=2, **kw)


def test_eval_and_follow_match_jax(records, tmp_path, monkeypatch):
    _, val_pat = records
    ckpts = [_variables(seed) for seed in (1, 2)]
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    for e, variables in enumerate(ckpts):
        pio.save_pytree(str(pdir / f"ckpt-{e}"), variables)
        jio.save_pytree(str(jdir / f"ckpt-{e}"), variables)
    kw = dict(batch_size=2, hparams=TINY, image_size=64, per_class=True,
              min_interval=0.0, idle_timeout=0.0)
    ref = jeval.follow("efficientdet-lite0", val_pat, str(jdir), **kw)
    got = peval.follow("efficientdet-lite0", val_pat, str(pdir), device="cpu", **kw)
    assert sorted(got) == sorted(ref) == [0, 1]
    for e in ref:
        assert got[e].keys() == ref[e].keys() and "AP_/person" in got[e]
        assert all(abs(got[e][k] - ref[e][k]) <= EVAL_ABS for k in ref[e])
    assert ref[0]["AP"] != ref[1]["AP"]
    best = (pdir / "best_eval.txt").read_text()
    assert best == (jdir / "archive" / "best_eval.txt").read_text()
    archived = _leaves(pio.load_pytree(str(pdir / "archive")))
    want = _leaves(ckpts[int(best.split()[0])])
    assert archived.keys() == want.keys()
    assert all(np.array_equal(archived[k], want[k]) for k in want)
    del kw["min_interval"], kw["idle_timeout"]
    single = peval.evaluate("efficientdet-lite0", val_pat, ckpt=str(pdir / "ckpt-1"),
                            device="cpu", **kw)
    assert single == got[1]
    assert peval.count_examples(val_pat) == jeval.count_examples(val_pat) == 4
    # an artifact path that is no file reaches the exported-program driver
    with pytest.raises(FileNotFoundError):
        peval.evaluate("efficientdet-lite0", val_pat,
                       artifact=str(tmp_path / "missing.pt2"), device="cpu", **kw)
    kw.update(min_interval=0.0, idle_timeout=0.0)
    # a checkpoint deleted while it is read is skipped, as JAX's
    pio.save_pytree(str(pdir / "ckpt-2"), ckpts[0])
    real = peval.evaluate

    def vanish(model_name, pattern, *, ckpt, **k):
        os.remove(ckpt + ".pkl")
        return real(model_name, pattern, ckpt=ckpt, **k)

    monkeypatch.setattr(peval, "evaluate", vanish)
    assert peval.follow("efficientdet-lite0", val_pat, str(pdir), device="cpu",
                        archive=False, **kw) == {}
