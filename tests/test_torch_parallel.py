"""The port's data parallelism (`parallel/`) across processes, on the CPU.

Ranks are spawned processes (`parallel.launch.spawn`: gloo, a file store
under the test's directory, one torch thread a rank, a join timeout that
fails the test); each rank writes its results to a file the test reads.
The global batch is 4 images of the tiny lite0@64 config, 2 a rank.
What is held:

- the mesh module: each rank's `shard_batch` rows equal JAX's
  `addressable_shards` for `make_mesh(2)` and for the 2x2 ('dcn', 'data')
  mesh of 4 ranks; `local_batch_size`, `make_mesh_for_batch` and
  `make_train_mesh` raise where JAX raises, with its messages; with
  `spatial > 1` it and `make_serve_mesh` return the ('data', 'spatial')
  mesh (its use: tests/test_torch_spatial.py);
- the attack step at 2 ranks against the port's one-process step on the
  global batch (EOT unpinned: every draw is the global batch's): loss
  within 1e-4 relative, the patch gradient at cosine >= 0.9999 and its norm
  within 1e-4 relative (an average over the ranks would halve it), the patch
  after one Adam step within lr (Adam's first step moves a pixel by +-lr
  whatever its gradient's size); and, with JAX's draws fed in and EOT
  pinned, against JAX's step jitted on a 2-device mesh, with the same
  limits;
- the defender step at 2 ranks with the victim's boxes stubbed and SGD in
  place of Adam (tests/test_parallel.py:299-355 says why): the masker's
  crops bit-equal to the one-process step's, the U-Net's parameters and
  statistics within 1e-5, the loss within 1e-4 relative;
- the supervised step at 2 ranks in float64 (global BatchNorm statistics,
  the global positives' normaliser), also with `grad_checkpoint`:
  parameters, statistics and loss within 1e-8 of scale of the one-process
  float64 step (max(1, max|ref|)); in
  float32 against JAX's step on a 2-device mesh within twice JAX's own
  float32 error (against the port's float64 step), or 2e-4 of scale
  (ROADMAP Queue 3 item 22);
- the segmentation step at 2 ranks against one process, in float64, 1e-8
  of scale;
- `Detector(mesh=)` at 2 ranks on 5 frames (the padding path), host and
  device preprocessing, against JAX's `Detector` on `make_mesh()`: scores
  within 1e-5, boxes within 1e-3, classes equal
  (tests/test_parallel.py:95-119);
- the attack and defender drivers at 2 ranks, 2 synthetic steps: each
  rank's stream is JAX's `synthetic_batches(local_bs, seed + 1000 * r)`,
  only rank 0 writes files beside `metrics.p1.jsonl`, and the two ranks'
  final patches and U-Net parameters are bit-equal; the folder shards'
  union is JAX's;
- a group of one rank (the card script's phase 24a on the CPU): the attack
  step through the mesh path bit-equal to the plain step;
- `packed_entry > 0` with `bn_axis_name` raises, as JAX asserts.

Spawned ranks import this module, so it imports no JAX at its top: the
JAX references are computed in the tests' own process.
"""
import os

import numpy as np
import pytest
import torch

from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch import parallel
from mladversarialobjectdetection_torch.attack import train as attack_train
from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.data import pipeline
from mladversarialobjectdetection_torch.defense import masker as pmasker
from mladversarialobjectdetection_torch.defense import train as defense_train
from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.models.efficientdet import (
    EfficientDetNet, spec_from_config)
from mladversarialobjectdetection_torch.parallel import launch
from mladversarialobjectdetection_torch.train import segmentation as pseg
from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer

B, HW, K = 4, 64, 4          # global batch, image side, box slots
LR = 1e-2
PINNED = dict(noise_mag=0.0, brightness_mag=0.0, print_jitter=False)
TINY = {"image_size": HW, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
        "box_class_repeats": 1}
SERVE_PARAMS = {**TINY, "nms_configs": {"score_thresh": 0.0, "pre_nms_topk": 64,
                                        "max_output_size": 16}}
SPAWN_TIMEOUT_S = 240.0


def tiny_cfg(**extra):
    """The conftest's `tiny_config()` as a port config."""
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.update(TINY)
    cfg.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5,
                            "pre_nms_topk": 64, "max_output_size": 16})
    cfg.max_boxes_per_image = K
    cfg.update(extra)
    return cfg


def run_ranks(fn, world, tmp, *args):
    """`fn(rank, tmp, *args)` on `world` spawned ranks; their results."""
    tmp = str(tmp)
    launch.spawn(fn, world, (tmp, *args), init_method=f"file://{tmp}/store",
                 threads=1, timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"r{r}.pt"), weights_only=False)
            for r in range(world)]


def make_inputs():
    """The global batch and the fixed draws of the steps (seeded numpy)."""
    rng = np.random.default_rng(11)
    images = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    boxes = np.zeros((B, K, 4), np.float32)
    valid = np.zeros((B, K), bool)
    for i in range(B):
        for k in range(1 + i % 3):
            y0, x0 = rng.uniform(2, 24, 2)
            h, w = rng.uniform(20, 38, 2)
            boxes[i, k] = (y0, x0, y0 + h, x0 + w)
            valid[i, k] = True
    gt_classes = rng.integers(0, 90, (B, K)).astype(np.int32)
    seg = next(pseg.synthetic_seg_batches(B, HW, pseg.output_size(HW, 3), seed=0))
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(5)]
    return dict(images=images, boxes=boxes, valid=valid, gt_classes=gt_classes,
                seg=seg, frames=frames)


def _state_arrays(module):
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# the steps, run alike by one process (all rows) and by each rank (its rows)
# ---------------------------------------------------------------------------

def attack_step(inp, rows, jax_case=False):
    cfg = tiny_cfg()
    victim = attack_train.get_victim(cfg, seed=0, device="cpu")
    atk = PatchAttacker(cfg, victim, patch_size=32, learning_rate=LR,
                        eot_overrides=PINNED if jax_case else None, device="cpu")
    state = atk.init_state(0, initial_patch=inp["jax_patch"] if jax_case else None)
    draws = None
    if jax_case:
        draws = type(inp["jax_draws"])(*(None if f is None else f[rows]
                                         for f in inp["jax_draws"]))
    state, m = atk.train_step(
        state, torch.from_numpy(inp["images"][rows]), with_asr=True,
        boxes_override=(torch.from_numpy(inp["boxes"][rows]),
                        torch.from_numpy(inp["valid"][rows])), eot_draws=draws)
    return {"loss": float(m.loss), "grad": state.patch.grad.numpy().copy(),
            "patch": state.patch.detach().numpy().copy(),
            "scale": float(state.scale.detach()), "metrics": {k: float(v) for k, v in
                                                     m._asdict().items()}}


def defender_step(inp, rows):
    cfg = tiny_cfg()
    victim = attack_train.get_victim(cfg, seed=0, device="cpu")
    dfd = PatchAttackDefender(cfg, victim, device="cpu")
    boxes = torch.from_numpy(inp["boxes"][rows])
    valid = torch.from_numpy(inp["valid"][rows])
    dfd.odet_boxes = lambda images, score_thresh=None: (
        boxes, torch.full(valid.shape, 0.9), valid)
    state = dfd.init_state(0)
    state.optimizer = torch.optim.SGD(state.unet.parameters(), lr=0.01)
    crops, orig = [], pmasker.make_train_patches

    def spy(*a, **kw):
        crops.append(orig(*a, **kw))
        return crops[-1]

    pmasker.make_train_patches = spy
    try:
        state, m = dfd.train_step(state, torch.from_numpy(inp["images"][rows]))
    finally:
        pmasker.make_train_patches = orig
    return {"loss": float(m.loss), "crops": crops[0].numpy(),
            "unet": _state_arrays(state.unet)}


def supervised_step(inp, rows, x64, grad_checkpoint=False):
    tr = DetectorTrainer(tiny_cfg(moving_average_decay=0.9,
                                  grad_checkpoint=grad_checkpoint),
                         steps_per_epoch=10, device="cpu")
    st = tr.init_state(seed=0)
    images = inp["images"][rows]
    if x64:
        st.net.double()
        st.net.compute_dtype = torch.float64
        st.ema = {n: e.double() for n, e in st.ema.items()}
        images = images.astype(np.float64)
    st, m = tr.train_step(st, images, inp["boxes"][rows],
                          inp["gt_classes"][rows], inp["valid"][rows])
    return {"loss": float(m["loss"]), "net": _state_arrays(st.net),
            "flax": bridge.torch_to_flax(st.net)}


def segmentation_step(inp, rows):
    tr = pseg.SegmentationTrainer(tiny_cfg(), device="cpu")
    st = tr.init_state(seed=0)
    st.net.double()
    st.net.compute_dtype = torch.float64
    st, m = tr.train_step(st, inp["seg"]["images"][rows].astype(np.float64),
                          inp["seg"]["masks"][rows])
    return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
            "net": _state_arrays(st.net)}


def serve(frames, mesh):
    det = Detector("efficientdet-lite0", params=SERVE_PARAMS, seed=0,
                   device="cpu", mesh=mesh)
    return det.serve(frames), det.serve(frames, device_preprocess=True)


def _errors(calls):
    """(type name, message) of each call's exception (None: no error)."""
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the test compares them
            out[name] = (type(e).__name__, str(e))
    return out


def _steps_worker(rank, tmp):
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = parallel.make_mesh(2, device="cpu")
    rows = slice(2 * rank, 2 * rank + 2)
    out = {"rows": parallel.shard_batch(mesh, np.arange(16 * 3).reshape(16, 3)).numpy(),
           "errors": _errors({
               "local_batch_size": lambda: parallel.local_batch_size(3),
               "mesh_for_batch": lambda: parallel.make_mesh_for_batch(3, device="cpu"),
               "train_mesh_batch": lambda: parallel.make_train_mesh(3, device="cpu"),
               "train_mesh_divide": lambda: parallel.make_train_mesh(4, 3, device="cpu"),
               "train_mesh_height": lambda: parallel.make_train_mesh(
                   4, 2, image_h=63, device="cpu")}),
           "spatial_meshes": {name: (m.axis_names, m.shape) for name, m in (
               ("train_mesh_spatial", parallel.make_train_mesh(
                   4, 2, image_h=64, device="cpu")),
               ("serve_mesh_spatial", parallel.make_serve_mesh(1, 2, device="cpu")))}}
    with parallel.use_mesh(mesh):
        out["attack"] = attack_step(inp, rows)
        out["attack_jax"] = attack_step(inp, rows, jax_case=True)
        out["defender"] = defender_step(inp, rows)
        out["sup64"] = supervised_step(inp, rows, x64=True)
        out["sup32"] = supervised_step(inp, rows, x64=False)
        out["sup64_ckpt"] = supervised_step(inp, rows, x64=True, grad_checkpoint=True)
        out["seg64"] = segmentation_step(inp, rows)
    out["serve"] = serve(inp["frames"], mesh)
    # the one-process steps on the global batch (no mesh: no collective),
    # shared out between the ranks
    every = slice(None)
    refs = ({"attack": lambda: attack_step(inp, every),
             "attack_jax": lambda: attack_step(inp, every, jax_case=True),
             "defender": lambda: defender_step(inp, every)},
            {"sup64": lambda: supervised_step(inp, every, x64=True),
             "sup64_ckpt": lambda: supervised_step(inp, every, x64=True,
                                                   grad_checkpoint=True),
             "seg64": lambda: segmentation_step(inp, every)})[rank]
    out["ref"] = {name: step() for name, step in refs.items()}
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))


def _hybrid_worker(rank, tmp):
    mesh = parallel.make_hybrid_mesh(dcn_size=2, device="cpu")
    x = np.arange(16 * 3).reshape(16, 3)
    with parallel.use_mesh(mesh):
        data_sum = parallel.reduce_sum(torch.ones(()), axes="data")
    torch.save({"rows": parallel.shard_batch(mesh, x).numpy(),
                "data_rows": parallel.shard_batch(mesh, x, "data").numpy(),
                "shape": mesh.shape, "data_sum": float(data_sum)},
               os.path.join(tmp, f"r{rank}.pt"))


def _driver_worker(rank, tmp):
    seeds, orig = [], pipeline.synthetic_batches

    def spy(batch_size, image_size, *, seed=0, **kw):
        seeds.append((batch_size, seed, next(orig(batch_size, image_size, seed=seed))))
        return orig(batch_size, image_size, seed=seed, **kw)

    pipeline.synthetic_batches = spy
    try:
        kw = dict(synthetic=True, image_size=HW, batch_size=B, epochs=1,
                  steps_per_epoch=2, config_override=TINY, device="cpu")
        atk = attack_train.train("efficientdet-lite0", patch_size=32,
                                 mixed_precision=False, visualize_freq=0,
                                 save_dir=os.path.join(tmp, f"attack{rank}"), **kw)
        low = {**TINY, "nms_configs": {"score_thresh": 0.0099}}
        kw["config_override"] = low
        dfd = defense_train.train("efficientdet-lite0",
                                  save_dir=os.path.join(tmp, f"defense{rank}"), **kw)
    finally:
        pipeline.synthetic_batches = orig
    torch.save({"seeds": seeds, "patch": atk.patch.detach().numpy(),
                "scale": float(atk.scale), "unet": _state_arrays(dfd.unet)},
               os.path.join(tmp, f"r{rank}.pt"))


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (the tier-1 run shares the CPU among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_inputs(inp):
    """JAX's initial patch and the EOT draws of its first step."""
    import jax
    from test_torch_attack import step_draws

    from mladversarialobjectdetection_tpu.attack.attacker import PatchAttacker as JAttacker
    jcfg, variables = jax_victim()
    jatk = JAttacker(jcfg, variables, patch_size=32, eot_overrides=PINNED)
    jst = jatk.init_state(jax.random.PRNGKey(0))
    draws, _ = step_draws(jst.key, B, K)
    return jatk, jst, draws


def jax_victim():
    """The JAX tiny config and the port's seeded victim as Flax variables."""
    from conftest import tiny_config
    jcfg = tiny_config()
    return jcfg, bridge.torch_to_flax(
        attack_train.get_victim(tiny_cfg(), seed=0, device="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the file (the steps and the drivers at 2 ranks, the
    hybrid mesh at 4), run beside the JAX references in this process."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = {k: tmp_path_factory.mktemp(k) for k in ("steps", "drivers", "hybrid")}
    inp = make_inputs()
    jatk, jst, draws = jax_inputs(inp)
    inp["jax_patch"] = np.asarray(jst.patch)
    inp["jax_draws"] = draws
    torch.save(inp, tmp["steps"] / "inputs.pt")
    with ThreadPoolExecutor(3) as pool:
        spawned = {"steps": pool.submit(run_ranks, _steps_worker, 2, tmp["steps"]),
                   "drivers": pool.submit(run_ranks, _driver_worker, 2, tmp["drivers"]),
                   "hybrid": pool.submit(run_ranks, _hybrid_worker, 4, tmp["hybrid"])}
        jax_ref = {"attack": jax_attack_on_mesh(inp, jatk, jst),
                   "sup32": jax_supervised_f32_on_mesh(inp),
                   "serve": jax_serve_on_mesh(inp["frames"])}
        out = {k: f.result() for k, f in spawned.items()}
    ranks = out["steps"]
    ref = {**ranks[0]["ref"], **ranks[1]["ref"]}
    return dict(inp=inp, ranks=ranks, ref=ref, jax=jax_ref,
                drivers=(tmp["drivers"], out["drivers"]), hybrid=out["hybrid"])


def jax_attack_on_mesh(inp, jatk, jst):
    """JAX's attack step jitted on a 2-device mesh (its draws, EOT pinned)."""
    import jax
    import jax.numpy as jnp
    from mladversarialobjectdetection_tpu.parallel import make_mesh, replicate, shard_batch
    mesh = make_mesh(2)
    override = (shard_batch(mesh, jnp.asarray(inp["boxes"])),
                shard_batch(mesh, jnp.asarray(inp["valid"])))
    step = jax.jit(jatk.train_step, static_argnames=("with_asr",))
    jout, jm = step(replicate(mesh, jst), shard_batch(mesh, jnp.asarray(inp["images"])),
                    boxes_override=override)
    return {"loss": float(jm.loss), "patch": np.asarray(jout.patch),
            "scale": float(jout.scale)}


def jax_supervised_f32_on_mesh(inp):
    """JAX's float32 supervised step jitted on a 2-device mesh, from the
    port's seeded weights: (params, batch_stats) after it."""
    import jax
    import jax.numpy as jnp
    from conftest import tiny_config
    from mladversarialobjectdetection_tpu.parallel import make_mesh, replicate, shard_batch
    from mladversarialobjectdetection_tpu.train import trainer as jtrainer
    jcfg = tiny_config()
    jcfg.moving_average_decay = 0.9
    jt = jtrainer.DetectorTrainer(jcfg, steps_per_epoch=10)
    init = bridge.torch_to_flax(DetectorTrainer(
        tiny_cfg(moving_average_decay=0.9), device="cpu").init_state(seed=0).net)
    params = jax.tree_util.tree_map(jnp.asarray, init["params"])
    state = jtrainer.TrainState(params, jax.tree_util.tree_map(jnp.asarray,
                                                               init["batch_stats"]),
                                jax.tree_util.tree_map(jnp.copy, params),
                                jt.tx.init(params), jnp.asarray(0, jnp.int32))
    mesh = make_mesh(2)
    batch = [shard_batch(mesh, jnp.asarray(inp[k])) for k in
             ("images", "boxes", "gt_classes", "valid")]
    jst, _ = jax.jit(jt.train_step)(replicate(mesh, state), *batch)
    return jax.tree_util.tree_map(np.asarray, (jst.params, jst.batch_stats))


def jax_serve_on_mesh(frames):
    """JAX's `Detector` on `make_mesh()` (8 devices) with the port's seeded
    weights: host and device preprocessing."""
    from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
    from mladversarialobjectdetection_tpu.parallel import make_mesh
    jdet = JDetector(model_name="efficientdet-lite0", params=SERVE_PARAMS, mesh=make_mesh())
    jdet.variables = bridge.torch_to_flax(
        Detector("efficientdet-lite0", params=SERVE_PARAMS, seed=0, device="cpu").net)
    return jdet.serve(frames), jdet.serve(frames, device_preprocess=True)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def scale_err(out, ref):
    """max over leaves of max|out - ref| / max(1, max|ref|)."""
    return max(float(np.abs(np.asarray(out[k], np.float64) - ref[k]).max()
                     / max(1.0, float(np.abs(ref[k]).max()))) for k in ref)


# ---------------------------------------------------------------------------
# the mesh module
# ---------------------------------------------------------------------------

def test_shard_batch_rows_match_jax_addressable_shards(runs):
    import jax
    from mladversarialobjectdetection_tpu.parallel import make_mesh, shard_batch
    x = np.arange(16 * 3).reshape(16, 3)
    shards = shard_batch(make_mesh(2), x).addressable_shards
    for r, out in enumerate(runs["ranks"]):
        assert np.array_equal(out["rows"], np.asarray(shards[r].data))
    assert len(jax.devices()) == 8


def test_hybrid_mesh_rows_match_jax(runs):
    from mladversarialobjectdetection_tpu.parallel import make_hybrid_mesh, shard_batch
    ranks = runs["hybrid"]
    x = np.arange(16 * 3).reshape(16, 3)
    jmesh = make_hybrid_mesh(dcn_size=2, devices=__import__("jax").devices()[:4])
    jrows = shard_batch(jmesh, x)
    by_device = {s.device: np.asarray(s.data) for s in jrows.addressable_shards}
    data_rows = shard_batch(jmesh, x, "data")
    by_device_data = {s.device: np.asarray(s.data) for s in data_rows.addressable_shards}
    for r, out in enumerate(ranks):
        device = jmesh.devices.ravel()[r]
        assert out["shape"] == {"dcn": 2, "data": 2}
        assert np.array_equal(out["rows"], by_device[device])
        assert np.array_equal(out["data_rows"], by_device_data[device])
        assert out["data_sum"] == 2.0  # the 'data' axis alone: a pair of ranks


def test_divisibility_errors_are_jax_messages(runs):
    errors = runs["ranks"][0]["errors"]
    assert errors["local_batch_size"] == (
        "ValueError", "global batch 3 not divisible by 2 processes")
    want = ("ValueError", "multi-host training needs batch_size divisible by "
            "the 2 global devices, got 3")
    assert errors["mesh_for_batch"] == errors["train_mesh_batch"] == want
    assert errors["train_mesh_divide"] == (
        "ValueError", "--spatial 3 must divide the 2 devices")
    assert errors["train_mesh_height"] == (
        "ValueError", "image height 63 must be divisible by --spatial 2")
    # spatial > 1 is ported: the ('data', 'spatial') mesh, data-major
    for name in ("train_mesh_spatial", "serve_mesh_spatial"):
        axes, shape = runs["ranks"][0]["spatial_meshes"][name]
        assert axes == ("data", "spatial") and shape == {"data": 1, "spatial": 2}


def test_in_process_mesh_rules():
    """One process, no group: every collective is the identity; a BatchNorm
    axis must name a data axis of the active mesh."""
    x = torch.arange(6.0).reshape(3, 2)
    mesh = parallel.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and parallel.world_size() == 1
    with parallel.use_mesh(mesh):
        assert parallel.reduce_sum(x) is x and parallel.all_gather_rows(x) is x
        assert parallel.global_rows(3) == (3, 0) and parallel.is_first_rank()
    serve_mesh = parallel.make_serve_mesh(1, 1, device="cpu")
    with parallel.use_mesh(serve_mesh), pytest.raises(ValueError, match="data axis"):
        parallel.data_group("spatial")
    with pytest.raises(ValueError, match="no mesh is active"):
        parallel.data_group("data")
    assert parallel.is_main_process() and parallel.local_batch_size(4) == 4
    assert parallel.make_mesh_for_batch(3, device="cpu").shape == {"data": 1}


def test_initialize_without_a_group_and_refusing_to_run_alone(monkeypatch):
    """No WORLD_SIZE: no group, world size 1. WORLD_SIZE=2 whose group
    cannot form (no rank 0 listens): it raises rather than carry on alone."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize("cpu") == 1
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    with pytest.raises(RuntimeError, match="could not join"):
        parallel.initialize("cpu", timeout_s=1.0)
    assert parallel.world_size() == 1


def test_packed_entry_with_bn_axis_name_raises():
    spec = spec_from_config(tiny_cfg())
    with pytest.raises(ValueError, match="cross-replica BN"):
        EfficientDetNet(spec, packed_entry=2, bn_axis_name="data")
    with pytest.raises(ValueError, match="cross-replica BN"):
        EfficientDetNet(spec, bn_axis_name="data").with_packed_entry(2)
    tr = DetectorTrainer(tiny_cfg(), bn_axis_name="data", device="cpu")
    net = tr.init_state(seed=0).net
    assert {m.axis_name for m in net.modules() if hasattr(m, "axis_name")} == {"data"}


# ---------------------------------------------------------------------------
# the steps at 2 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["attack", "attack_jax"])
def test_attack_step_at_two_ranks_matches_one_process(runs, case):
    ref = runs["ref"][case]
    r0, r1 = (r[case] for r in runs["ranks"])
    assert rel(r0["loss"], ref["loss"]) <= 1e-4
    assert r0["loss"] == r1["loss"]
    assert cosine(r0["grad"], ref["grad"]) >= 0.9999
    # the ranks sum their gradients (an average would halve it; Adam's first
    # step and the cosine would not see that)
    assert rel(np.linalg.norm(r0["grad"]), np.linalg.norm(ref["grad"])) <= 1e-4
    assert np.array_equal(r0["patch"], r1["patch"])
    assert float(np.abs(r0["patch"] - ref["patch"]).max()) <= LR
    assert abs(r0["scale"] - ref["scale"]) <= 1e-6
    for f in ("scale_loss", "mean_max_score", "asr", "tv_loss"):
        assert r0["metrics"][f] == pytest.approx(ref["metrics"][f], rel=1e-4,
                                                 abs=1e-6), f
    # the global std is sqrt(max(E[x^2] - E[x]^2, 0)) in float32 (ROADMAP Queue
    # 3 item 5): the difference cancels to within a few float32 ulps of E[x^2]
    # (the scores nearly tie at random weights), so its error is up to
    # sqrt(4 eps E[x^2])
    m, sd = ref["metrics"]["mean_max_score"], ref["metrics"]["std_max_score"]
    bound = float(np.sqrt(4 * np.finfo(np.float32).eps * (m * m + sd * sd)))
    assert abs(r0["metrics"]["std_max_score"] - sd) <= bound


def test_attack_step_at_two_ranks_matches_jax_on_a_two_device_mesh(runs):
    ref, got = runs["jax"]["attack"], runs["ranks"][0]["attack_jax"]
    assert rel(got["loss"], ref["loss"]) <= 1e-4
    assert float(np.abs(got["patch"] - ref["patch"]).max()) <= LR
    assert abs(got["scale"] - ref["scale"]) <= 1e-6


def test_defender_step_at_two_ranks_matches_one_process(runs):
    ref = runs["ref"]["defender"]
    r0, r1 = (r["defender"] for r in runs["ranks"])
    assert np.array_equal(np.concatenate([r0["crops"], r1["crops"]]), ref["crops"])
    assert rel(r0["loss"], ref["loss"]) <= 1e-4
    for k, v in ref["unet"].items():
        assert np.array_equal(r0["unet"][k], r1["unet"][k]), k
        np.testing.assert_allclose(r0["unet"][k], v, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["sup64", "sup64_ckpt"])
def test_supervised_step_float64_at_two_ranks_matches_one_process(runs, case):
    """sup64_ckpt: with `grad_checkpoint`, whose recompute runs the FPN
    cells' BatchNorms (and their all-reduces) again in the backward on
    every rank without moving their statistics twice (ROADMAP Queue 3 item
    21)."""
    ref = runs["ref"][case]
    r0, r1 = (r[case] for r in runs["ranks"])
    assert rel(r0["loss"], ref["loss"]) <= 1e-8
    assert scale_err(r0["net"], ref["net"]) <= 1e-8
    assert all(np.array_equal(r0["net"][k], r1["net"][k]) for k in ref["net"])


def test_supervised_step_float32_at_two_ranks_matches_jax(runs):
    """Within twice JAX's own float32 error (ROADMAP Queue 3 item 22), on
    JAX's step jitted on a 2-device mesh."""
    from test_torch_train import _leaf_dists
    got = runs["ranks"][0]["sup32"]["flax"]  # rank 0's net after the step
    ref64 = runs["ref"]["sup64"]["flax"]
    for out, j, r in zip((got["params"], got["batch_stats"]), runs["jax"]["sup32"],
                         (ref64["params"], ref64["batch_stats"])):
        own = max(d for _, d in _leaf_dists(j, r))
        worst = max(_leaf_dists(out, j), key=lambda x: x[1])
        assert worst[1] <= max(2e-4, 2.0 * own), (worst, own)


def test_segmentation_step_float64_at_two_ranks_matches_one_process(runs):
    ref = runs["ref"]["seg64"]
    r0, r1 = (r["seg64"] for r in runs["ranks"])
    assert rel(r0["loss"], ref["loss"]) <= 1e-8
    assert rel(r0["accuracy"], ref["accuracy"]) <= 1e-8
    assert scale_err(r0["net"], ref["net"]) <= 1e-8
    assert all(np.array_equal(r0["net"][k], r1["net"][k]) for k in ref["net"])


def test_detector_mesh_at_two_ranks_matches_jax_detector_on_a_mesh(runs):
    for r in runs["ranks"]:
        for got, ref in zip(r["serve"], runs["jax"]["serve"]):
            assert got.boxes.shape == ref.boxes.shape  # the padding stripped
            np.testing.assert_allclose(got.scores, ref.scores, atol=1e-5)
            np.testing.assert_allclose(got.boxes, ref.boxes, atol=1e-3)
            np.testing.assert_array_equal(got.classes, ref.classes)


def test_one_rank_group_mesh_path_is_the_plain_step(tmp_path):
    """The card script's phase 24a on the CPU: in a group of one rank the
    mesh path issues every collective, and its attack step is the plain
    one, bit for bit."""
    import torch.distributed as dist
    inp = make_inputs()
    plain = attack_step(inp, slice(None))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(device="cpu")
        with parallel.use_mesh(mesh):
            assert parallel.data_group() is not None
            meshed = attack_step(inp, slice(None))
    finally:
        dist.destroy_process_group()
    assert np.array_equal(meshed["patch"], plain["patch"])
    assert np.array_equal(meshed["grad"], plain["grad"])
    assert meshed["loss"] == plain["loss"]


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drivers(runs):
    return runs["drivers"]


def test_drivers_at_two_ranks_stream_their_shards(drivers):
    from mladversarialobjectdetection_tpu.data import pipeline as jpipeline
    _, ranks = drivers
    for r, out in enumerate(ranks):
        # attack train / val, then defense train / val (seeds 42 and 43)
        assert [s[:2] for s in out["seeds"]] == [
            (2, 42 + 1000 * r), (2, 43 + 1000 * r), (2, 43 + 1000 * r),
            (2, 44 + 1000 * r)]
        for bs, seed, first in out["seeds"]:
            assert np.array_equal(first, next(jpipeline.synthetic_batches(
                bs, HW, seed=seed)))


def test_drivers_at_two_ranks_write_from_rank_0_only(drivers):
    tmp, _ = drivers
    files = lambda d: sorted(os.path.relpath(os.path.join(p, f), d)
                             for p, _, fs in os.walk(d) for f in fs)
    for kind in ("attack", "defense"):
        assert files(tmp / f"{kind}1") == ["logs/metrics.p1.jsonl"]
        main = files(tmp / f"{kind}0")
        assert "logs/metrics.jsonl" in main and "state-latest.msgpack" in main
        assert any(f.startswith("patch_00_") for f in main)


def test_drivers_at_two_ranks_end_bit_equal(drivers):
    _, (r0, r1) = drivers
    assert np.array_equal(r0["patch"], r1["patch"]) and r0["scale"] == r1["scale"]
    for k, v in r0["unet"].items():
        assert np.array_equal(v, r1["unet"][k]), k


def test_folder_shards_union_is_jax(tmp_path):
    from PIL import Image
    from conftest import tiny_config
    from mladversarialobjectdetection_tpu.data import pipeline as jpipeline
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    for i in range(12):
        Image.fromarray(np.full((8, 8, 3), i, np.uint8)).save(img_dir / f"{i:02d}.png")
    port, jax_ = [], []
    for r in range(2):
        parts = pipeline.partition(tiny_cfg(), str(img_dir), None, batch_size=2, seed=42 + r)
        jparts = jpipeline.partition(tiny_config(), str(img_dir), None, batch_size=2,
                                     seed=42 + r)
        for split in ("train", "val"):
            port.append(parts[split]["source"].shard(r, 2).files)
            jax_.append(jparts[split]["source"].shard(r, 2).files)
    assert port == jax_
