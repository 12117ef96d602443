"""Spatial partitioning of the rest, across processes, on the CPU: the
packed backbone entry on packed row shards, the int8 serve on
halo-extended shards, the segmentation head and its trainer, and the EOT
gather backend under a ('data', 'spatial') mesh.

Ranks are spawned processes (`parallel.launch.spawn`: gloo, one torch
thread a rank) at meshes ('data', 'spatial') = (1, 2) and (1, 4), both
spawned once, side by side, in one module fixture; the (1, 4) ranks then
compute the one-process references (a share each), while JAX's one-device
packed attack gradient and segmentation step compile in the test's
process. The config is the tiny lite0@64 of `tests/test_torch_parallel.py`
(global batch 2): its packed stem output is 32 image rows, 16 packed rows,
8 a rank at spatial 2 and 4 at spatial 4. What is held:

- (a) `EfficientDetNet` with `packed_entry` 2 and 6 at (1, 2), 2 and 4 at
  (1, 4) (6 and 4 pack a later stage again and exit through a k5 stride-2
  block), eval forward and input gradient in float64 (every block
  unfused) within 1e-10 of max(1, max|ref|) of one process, and in float32
  (the fused blocks' plain version) within 2e-4; hooks on rank 0: the stem
  and every packed depthwise conv run on the rank's packed rows and their
  halo, every fused op on the shard plus at most k // 2 rows a side;
  the tiny efficientdet-d0's packed blocks with squeeze-excite (its mean over
  the spatial group) in float64 likewise; `packed_entry` 6 at (1, 4), whose
  8-row level packs into 4 packed rows (1 a rank), raises `ValueError`. `Detector(mesh=, packed_entry=2)` serves as
  one process within 1e-5 (scores) and 1e-3 px (boxes) at both meshes;
- (b) the packed attack step (`packed_entry` 2): at both meshes in float64
  with EOT stubbed by a row-local composite (the real EOT's float32 colour
  sums run in another order on a shard, which no float64 bound survives),
  the loss and the patch gradient within 1e-8 of max(1, max|ref|) of one
  process; at (1, 2) in float32 with JAX's draws and EOT pinned, against JAX's
  one-device packed loss and patch gradient: loss within 1e-4 relative,
  cosine >= 0.9999, and >= 0.99 without the TV term (ROADMAP Queue 3
  item 4); at both meshes the defender's packed victim (a packed view of a
  victim that detects every anchor alike) detects as one process, and its
  float32 step's loss is within 2e-4 relative;
- (c) `Detector.quantize_int8` at both meshes: the activation scales equal to
  one process's, the int8 head outputs at no more than 1% off by more than
  1e-4 (Queue 3 item 28's rule), the serve's detections as one process's
  (`sums_plain` with explicit pads: `tests/test_torch_quantize.py`);
- (d) `SegmentationTrainer.train_step` in float64 at (1, 2) and (1, 4), at
  80 px (at spatial 2 the head's transposed conv from a replicated level
  writes shards split at an odd row): loss, parameters and statistics
  within 1e-8 of max(1, max|ref|) of one process; at (1, 2) in float32 against JAX's one-device step within twice
  JAX's own float32 error (against the port's float64 step) or 2e-4 of
  scale (Queue 3 item 22's rule), and `eval_step` and `predict_mask` of
  the seed-0 net as one process's;
- (e) `eot.apply_patches(backend="gather")` at both meshes: a rank's rows within
  1e-6 of one process's, the region masks equal;
- (f) `attack.train.train(spatial=2, packed_entry=2)`, 2 synthetic steps:
  the ranks' patches bit-equal, rank 0 alone writing files.

Spawned ranks import this module, so it imports no JAX at its top.
"""
import contextlib
import os
import time

import numpy as np
import pytest
import torch

from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch import parallel
from mladversarialobjectdetection_torch.attack import train as attack_train
from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.models import efficientnet
from mladversarialobjectdetection_torch.models import efficientnet_packed as ppk
from mladversarialobjectdetection_torch.models.efficientdet import (EfficientDetNet,
                                                                    spec_from_config)
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.ops import eot as peot
from mladversarialobjectdetection_torch.ops import mbconv as mbconv_ops
from mladversarialobjectdetection_torch.parallel import launch, spatial
from mladversarialobjectdetection_torch.train import segmentation as pseg
from test_torch_parallel import (PINNED, SERVE_PARAMS, TINY, _state_arrays,
                                 cosine, rel, scale_err, tiny_cfg)
from test_torch_spatial import victim

B, HW, K, LR = 2, 64, 4, 1e-2   # global batch, image side, box slots, Adam lr
# the float64 segmentation steps' side: levels 3-7 of 10, 5, 3, 2 and 1 rows,
# so at spatial 2 the head's transposed conv from the replicated level 4
# writes level 3's shards, split at an odd row
SEG_HW = 80
MESHES = {"s12": (1, 2), "s14": (1, 4)}
JOBS = {"s12": ("packed", "serve", "int8", "seg", "seg32", "gather", "defender", "attack",
                "driver"),
        "s14": ("packed", "raise", "serve", "attack64", "int8", "seg", "gather", "defender",
                "refs")}
PACKED = {"s12": (2, 6), "s14": (2, 4)}
SPAWN_TIMEOUT_S = 240.0
F64_TOL = 1e-10     # (a): float64 sums in another order only
STEP64_TOL = 1e-8   # (b), (d)
TOL = 2e-4          # float32, the ROADMAP rule
INT8_SHARE, INT8_ATOL = 0.01, 1e-4  # Queue 3 item 28
GATHER_TOL = 1e-6   # (e)
DRIVER = dict(synthetic=True, image_size=HW, batch_size=2, epochs=1, steps_per_epoch=2,
              config_override=TINY, patch_size=32, visualize_freq=0,
              mixed_precision=False, spatial=2, packed_entry=2, device="cpu")


def make_inputs():
    """The global batch, seeded cotangents on every head output, box slots,
    class-id masks and frames (seeded numpy)."""
    rng = np.random.default_rng(23)
    boxes = np.zeros((B, K, 4), np.float32)
    valid = np.zeros((B, K), bool)
    for i in range(B):
        for k in range(2 + i):
            y0, x0 = rng.uniform(2, 24, 2)
            h, w = rng.uniform(20, 38, 2)
            boxes[i, k] = (y0, x0, y0 + h, x0 + w)
            valid[i, k] = True
    spec = pseg.spec_from_config(tiny_cfg())
    levels = [spec.level_hw[lv] for lv in range(spec.min_level, spec.max_level + 1)]
    cot = [rng.normal(size=(B, h, w, c)) for c in (90 * 9, 4 * 9) for h, w in levels]
    mask_hw = pseg.output_size(HW, spec.min_level)
    seg_hw = pseg.output_size(SEG_HW, spec.min_level)
    return dict(images=rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
                boxes=boxes, valid=valid, cot=cot,
                masks=rng.integers(0, 3, (B, mask_hw, mask_hw)).astype(np.int64),
                seg_images=rng.uniform(-1, 1, (B, SEG_HW, SEG_HW, 3)).astype(np.float32),
                seg_masks=rng.integers(0, 3, (B, seg_hw, seg_hw)).astype(np.int64),
                patch=rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32),
                frames=[rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
                        for _ in range(3)])


# ---------------------------------------------------------------------------
# the computations, run alike by one process (no mesh) and by each rank
# ---------------------------------------------------------------------------

class _SpySpatial:
    """`efficientnet_packed.spatial` with `same_window` recording, for each
    packed conv, (kernel, stride, global height, the rows its op got)."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(spatial, name)

    def same_window(self, x, height, kernel, stride, top, op, **kw):
        def rec(xe):
            self.seen.append((kernel, stride, height, xe.shape[2]))
            return op(xe)
        return spatial.same_window(x, height, kernel, stride, top, rec, **kw)


def se_victim():
    """The seed-0 tiny efficientdet-d0 (an EfficientNet with squeeze-excite)
    in float64, frozen."""
    cfg = pconfig.get_efficientdet_config("efficientdet-d0")
    cfg.update(TINY)
    net = EfficientDetNet(spec_from_config(cfg))
    init_weights(net.eval(), torch.Generator().manual_seed(0))
    for p in net.parameters():
        p.requires_grad_(False)
    net.double()
    net.compute_dtype = torch.float64
    return net


def packed_forward(images, cot, packed, dtype, spy=False, net=None):
    """The packed net's eval forward (raw head outputs, every row) and the
    input gradient of sum(outputs * cot); with `spy`, the rows of every
    packed conv and fused op call. `net`: the tiny lite0 victim by default."""
    net = (net or victim(dtype)).with_packed_entry(packed)
    x = torch.as_tensor(images, dtype=dtype).requires_grad_(True)
    convs, fused = [], []
    orig = mbconv_ops.mbconv
    if spy:
        ppk.spatial = _SpySpatial(convs)
        mbconv_ops.mbconv = lambda xe, *a, **kw: fused.append(xe.shape[1]) or orig(xe, *a, **kw)
    try:
        with (efficientnet.unfused_blocks() if dtype == torch.float64
              else contextlib.nullcontext()):
            cls, box = net(x)
            loss = sum((o * torch.as_tensor(c, dtype=dtype)).sum()
                       for o, c in zip(cls + box, cot))
            spatial.count_once(loss).backward()
    finally:
        ppk.spatial, mbconv_ops.mbconv = spatial, orig
    flat = torch.cat([o.detach().reshape(o.shape[0], -1) for o in cls + box], 1).numpy()
    return {"out": flat, "grad": x.grad.numpy(), "convs": convs, "fused": fused}


def packed_runs(inp, images, packs, spy):
    out = {(p, dt): packed_forward(images, inp["cot"], p, getattr(torch, dt),
                                   spy=spy and dt == "float32")
           for p in packs for dt in ("float64", "float32")}
    out["se"] = packed_forward(images, inp["cot"], 2, torch.float64, net=se_victim())
    return out


def packed_refuses(images):
    """What `packed_entry` 6 raises at (1, 4)."""
    try:
        victim().with_packed_entry(6)(torch.from_numpy(images))
    except ValueError as e:
        return str(e)
    return None


def packed_serve(frames, mesh=None):
    det = Detector("efficientdet-lite0", params=SERVE_PARAMS, seed=0, device="cpu",
                   mesh=mesh, packed_entry=2)
    return det.serve(frames)


def stub_patches(images, boxes, valid, patch, scale, *, height=None, **_):
    """A row-local composite in place of the EOT: the patch tiled over the
    image, its rows this rank's under a spatial mesh."""
    tiled = patch.repeat(2, 2, 1)[None]
    if spatial.sharded(height):
        tiled = spatial.local_rows(tiled, dim=1)
    return images * 0.5 + (0.5 * scale) * tiled, None


def attack64(inp, images):
    """The packed float64 attack step, EOT stubbed (every block unfused)."""
    atk = PatchAttacker(tiny_cfg(), victim(torch.float64), patch_size=32,
                        learning_rate=LR, packed_entry=2, device="cpu")
    state = atk.init_state(0)
    orig, peot.apply_patches = peot.apply_patches, stub_patches
    try:
        with efficientnet.unfused_blocks():
            state, m = atk.train_step(state, torch.from_numpy(images), with_asr=False,
                                      boxes_override=(torch.from_numpy(inp["boxes"]),
                                                      torch.from_numpy(inp["valid"])))
    finally:
        peot.apply_patches = orig
    return {"loss": float(m.loss), "grad": state.patch.grad.numpy().copy(),
            "scale_grad": float(state.scale.grad)}


def jax_inputs(tmp):
    """JAX's initial patch and first draws, which the test's process writes
    while the ranks run their other jobs."""
    path = os.path.join(tmp, "jax.pt")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def attack32(inp, images):
    """The packed float32 attack step on JAX's draws, EOT pinned: its loss
    and the patch gradient summed over the ranks."""
    atk = PatchAttacker(tiny_cfg(), victim(), patch_size=32, learning_rate=LR,
                        eot_overrides=PINNED, packed_entry=2, device="cpu")
    state = atk.init_state(0, initial_patch=inp["jax_patch"])
    state, m = atk.train_step(state, torch.from_numpy(images), with_asr=False,
                              boxes_override=(torch.from_numpy(inp["boxes"]),
                                              torch.from_numpy(inp["valid"])),
                              eot_draws=inp["jax_draws"])
    return {"loss": float(m.loss), "grad": state.patch.grad.numpy().copy()}


def int8(inp, mesh=None):
    """`quantize_int8` on 3 frames, then the int8 head outputs of 2 and the
    int8 serve of 3."""
    det = Detector("efficientdet-lite0", params=SERVE_PARAMS, seed=0, device="cpu",
                   mesh=mesh)
    det.quantize_int8(inp["frames"])
    images = torch.from_numpy(det.preprocess(inp["frames"][:2])[0])
    with torch.no_grad(), det._in_mesh():
        cls, box = det._int8(det._own_rows(images))
    flat = torch.cat([o.reshape(o.shape[0], -1) for o in cls + box], 1).numpy()
    return {"scales": dict(det._int8.act_scales), "out": flat,
            "det": det.serve(inp["frames"])}


def seg_step(inp, images, dtype, evaluate=False):
    """One segmentation train step from the seed-0 net (float64: at SEG_HW);
    with `evaluate`, `eval_step` and `predict_mask` of that net first (after
    the step, a float32 net carries the step's ill-conditioning, Queue 3
    item 22)."""
    masks = inp["seg_masks" if dtype == torch.float64 else "masks"]
    side = SEG_HW if dtype == torch.float64 else HW
    tr = pseg.SegmentationTrainer(tiny_cfg(image_size=side), device="cpu")
    st = tr.init_state(seed=0)
    out = {}
    if evaluate:
        out["eval"] = {k: float(v) for k, v in tr.eval_step(st, images, masks).items()}
        out["mask"] = tr.predict_mask(st, images).numpy()
    if dtype == torch.float64:
        st.net.double()
        st.net.compute_dtype = torch.float64
        images = images.astype(np.float64)
    st, m = tr.train_step(st, images, masks)
    out.update(loss=float(m["loss"]), net=_state_arrays(st.net),
               flax=bridge.torch_to_flax(st.net))
    return out


def gather(inp, images):
    out, region = peot.apply_patches(
        images, inp["boxes"], inp["valid"], inp["patch"], 0.4, backend="gather",
        generator=torch.Generator().manual_seed(3), device="cpu", height=HW)
    return out.numpy(), region.numpy()


def defender_step(images):
    """A float32 defender step (dropout 0) whose victim is a packed view
    (`packed_entry=2`) of the flat victim of
    `tests/test_torch_spatial_defense.py`, which detects every anchor alike
    on any split of the rows: its loss and its victim's detections."""
    from test_torch_spatial_defense import NF, flat_victim, no_dropout, victim_cfg
    from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
    dfd = PatchAttackDefender(victim_cfg(), flat_victim(False, 3.0), eval_patch=None,
                              n_filters=NF, packed_entry=2, device="cpu")
    assert dfd.net.backbone.packed_blocks == 2
    st = dfd.init_state(0)
    no_dropout(st.unet)
    x = torch.from_numpy(images)
    boxes, scores, valid = dfd.odet_boxes(x)
    st, m = dfd.train_step(st, x)
    return {"loss": float(m.loss), "boxes": boxes.numpy(), "scores": scores.numpy(),
            "valid": valid.numpy()}


def driver(tmp, rank):
    st = attack_train.train("efficientdet-lite0", save_dir=os.path.join(tmp, f"driver{rank}"),
                            **DRIVER)
    return {"patch": st.patch.detach().numpy().copy(), "scale": float(st.scale.detach())}


def one_process(inp, share):
    """Share `share` (0-3) of the references: every computation on the
    whole batch, no mesh."""
    images = inp["images"]
    shares = (
        {"packed": lambda: packed_runs(inp, images, (2, 4, 6), spy=True)},
        {"attack": lambda: attack64(inp, images), "gather": lambda: gather(inp, images),
         "serve": lambda: packed_serve(inp["frames"]),
         "defender": lambda: defender_step(images)},
        {"seg": lambda: seg_step(inp, inp["seg_images"], torch.float64),
         "int8": lambda: int8(inp)},
        {"seg32": lambda: seg_step(inp, images, torch.float32, evaluate=True)})
    return {name: fn() for name, fn in shares[share].items()}


def _rank_worker(rank, tmp, n_sp, jobs, packs):
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = parallel.make_train_mesh(B, n_sp, image_h=HW, device="cpu")
    images = parallel.shard_batch(mesh, inp["images"]).numpy()  # this rank's rows
    seg_images = parallel.shard_batch(mesh, inp["seg_images"]).numpy()
    run = {"packed": lambda: packed_runs(inp, images, packs, spy=rank == 0),
           "raise": lambda: packed_refuses(images),
           "attack": lambda: {"f64": attack64(inp, images),
                              "f32": attack32({**inp, **jax_inputs(tmp)}, images)},
           "attack64": lambda: {"f64": attack64(inp, images)},
           "defender": lambda: defender_step(images),
           "int8": lambda: int8(inp, mesh),
           "seg": lambda: seg_step(inp, seg_images, torch.float64),
           "seg32": lambda: seg_step(inp, images, torch.float32, evaluate=True),
           "gather": lambda: gather(inp, images)}
    out = {}
    with parallel.use_mesh(mesh):
        for job in jobs:
            if job in run:
                out[job.replace("64", "")] = run[job]()
    # the serve and the driver build their own meshes; the references none
    if "serve" in jobs:
        out["serve"] = packed_serve(inp["frames"], mesh)
    if "driver" in jobs:
        out["driver"] = driver(tmp, rank)
    if "refs" in jobs:
        out["ref"] = one_process(inp, rank)
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))


def run_ranks(tmp, mesh):
    tmp, n_sp = str(tmp), MESHES[mesh][1]
    launch.spawn(_rank_worker, n_sp, (tmp, n_sp, JOBS[mesh], PACKED[mesh]),
                 init_method=f"file://{tmp}/store", threads=1, timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"r{r}.pt"), weights_only=False)
            for r in range(n_sp)]


# ---------------------------------------------------------------------------
# the JAX references (one device)
# ---------------------------------------------------------------------------

def jax_attack_inputs():
    """JAX's packed attacker (EOT pinned), its initial state, the EOT key
    of its first step and that key's draws."""
    import jax
    from test_torch_eot import jax_draws
    from test_torch_parallel import jax_victim
    from mladversarialobjectdetection_tpu.attack.attacker import PatchAttacker as JAttacker
    jcfg, variables = jax_victim()
    jatk = JAttacker(jcfg, variables, patch_size=32, eot_overrides=PINNED, packed_entry=2)
    jst = jatk.init_state(jax.random.PRNGKey(0))
    k_eot = jax.random.split(jst.key, 3)[1]
    return jatk, jst, k_eot, jax_draws(k_eot, B, K)


def jax_attack_grad(inp, jatk, jst, k_eot):
    """JAX's one-device packed loss and patch gradient on the same draws."""
    import jax
    import jax.numpy as jnp

    def jloss(trainables):
        scale, patch = trainables
        return jatk._loss_from_images(patch, scale, jnp.asarray(inp["images"]),
                                      jnp.asarray(inp["boxes"]),
                                      jnp.asarray(inp["valid"]), k_eot)[0]

    loss, (_, g) = jax.jit(jax.value_and_grad(jloss))((jst.scale, jst.patch))
    return {"loss": float(loss), "grad": np.asarray(g)}


def jax_seg_step(inp):
    """JAX's one-device float32 segmentation step from the port's seed-0
    net."""
    import jax
    import jax.numpy as jnp
    from mladversarialobjectdetection_tpu import config as jconfig
    from mladversarialobjectdetection_tpu.train import segmentation as jseg
    cfg = jconfig.Config(tiny_cfg().as_dict())
    cfg.heads = ["segmentation"]
    v = bridge.torch_to_flax(pseg.SegmentationTrainer(tiny_cfg(), device="cpu")
                             .init_state(seed=0).net)
    v = jax.tree_util.tree_map(jnp.asarray, v)
    jt = jseg.SegmentationTrainer(cfg)
    state = jseg.SegTrainState(v["params"], v["batch_stats"], jt.tx.init(v["params"]),
                               jnp.asarray(0, jnp.int32))
    jst, m = jax.jit(jt.train_step)(state, jnp.asarray(inp["images"]),
                                    jnp.asarray(inp["masks"], jnp.int32))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"loss": float(m["loss"]), "params": host(jst.params),
            "batch_stats": host(jst.batch_stats)}


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns side by side (the (1, 4) ranks compute the one-process
    references too), JAX's references in this process meanwhile."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = {k: tmp_path_factory.mktemp(k) for k in MESHES}
    inp = make_inputs()
    for k in MESHES:
        torch.save(inp, tmp[k] / "inputs.pt")
    with ThreadPoolExecutor(len(MESHES) + 1) as pool:
        spawned = {k: pool.submit(run_ranks, tmp[k], k) for k in MESHES}
        seg = pool.submit(jax_seg_step, inp)  # JAX compiles meanwhile
        jatk, jst, k_eot, draws = jax_attack_inputs()
        inp.update(jax_draws=draws, jax_patch=np.asarray(jst.patch))
        # the (1, 2) ranks wait for these before their float32 attack step
        torch.save({"jax_draws": draws, "jax_patch": inp["jax_patch"]}, tmp["s12"] / "jax.tmp")
        os.replace(tmp["s12"] / "jax.tmp", tmp["s12"] / "jax.pt")
        jax_ref = {"attack": jax_attack_grad(inp, jatk, jst, k_eot)}
        out = {k: f.result() for k, f in spawned.items()}
        jax_ref["seg"] = seg.result()
    ref = {k: v for r in out["s14"] for k, v in r["ref"].items()}
    return dict(inp=inp, ref=ref, jax=jax_ref, tmp=tmp, **out)


def _rows_of(x, rank, n_sp):
    """The global batch's rows that `rank` of a (1, n_sp) mesh holds."""
    h = x.shape[1] // n_sp
    return x[:, rank * h:(rank + 1) * h]


def _err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(1.0, float(np.abs(ref).max())))


# ---------------------------------------------------------------------------
# (a) the packed entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh, packed", [(m, p) for m in sorted(MESHES) for p in PACKED[m]])
def test_packed_forward_and_input_gradient_match_one_process(runs, mesh, packed):
    n = MESHES[mesh][1]
    for dtype, tol in (("float64", F64_TOL), ("float32", TOL)):
        ref = runs["ref"]["packed"][packed, dtype]
        for rank, r in enumerate(runs[mesh]):
            got = r["packed"][packed, dtype]
            assert _err(got["out"], ref["out"]) <= tol, (dtype, rank)
            assert _err(got["grad"], _rows_of(ref["grad"], rank, n)) <= tol, (dtype, rank)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_packed_squeeze_excite_forward_matches_one_process(runs, mesh):
    """efficientdet-d0's packed blocks pool squeeze-excite over the spatial
    group (`packed_se`); float64, every block unfused."""
    ref, n = runs["ref"]["packed"]["se"], MESHES[mesh][1]
    for rank, r in enumerate(runs[mesh]):
        got = r["packed"]["se"]
        assert _err(got["out"], ref["out"]) <= F64_TOL
        assert _err(got["grad"], _rows_of(ref["grad"], rank, n)) <= F64_TOL


@pytest.mark.parametrize("mesh, packed", [(m, p) for m in sorted(MESHES) for p in PACKED[m]])
def test_packed_convs_see_their_packed_rows_and_halo(runs, mesh, packed):
    n = MESHES[mesh][1]
    got = runs[mesh][0]["packed"][packed, "float32"]
    ref = runs["ref"]["packed"][packed, "float32"]
    # one process runs every packed conv whole: no row window
    assert ref["convs"] == [] and got["convs"]
    # the stem (5x5 at stride 4) and one depthwise conv per packed block
    assert [c[:2] for c in got["convs"]][0] == (5, 4) and len(got["convs"]) == 1 + packed
    for kernel, stride, height, rows in got["convs"]:
        assert spatial.is_sharded(height // stride, n), (kernel, stride, height)
        # the rank's output rows and the rows they read beyond them
        assert rows == (height // stride // n - 1) * stride + kernel, (kernel, height, rows)
    # the fused blocks past the packed range run on the shard plus their halo
    assert len(got["fused"]) == len(ref["fused"]) > 0
    for rows, whole in zip(got["fused"], ref["fused"]):
        if spatial.is_sharded(whole, n):
            assert whole // n < rows <= whole // n + 2, (rows, whole)
        else:
            assert rows == whole


def test_packed_entry_refuses_a_level_whose_shards_do_not_pack(runs):
    for r in runs["s14"]:
        assert r["raise"] is not None and "cannot be packed" in r["raise"]
        assert "--spatial 4" in r["raise"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_packed_serve_matches_one_process(runs, mesh):
    ref = runs["ref"]["serve"]
    for r in runs[mesh]:
        got = r["serve"]
        for field in ("classes", "valid", "valid_len"):
            assert np.array_equal(getattr(got, field), getattr(ref, field)), field
        assert float(np.abs(got.scores - ref.scores).max()) <= 1e-5
        assert float(np.abs(got.boxes - ref.boxes).max()) <= 1e-3


# ---------------------------------------------------------------------------
# (b) the packed attack step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_packed_attack_step_float64_matches_one_process(runs, mesh):
    ref = runs["ref"]["attack"]
    ranks = [r["attack"]["f64"] for r in runs[mesh]]
    assert np.abs(ref["grad"]).max() > 0
    for r in ranks:
        assert rel(r["loss"], ref["loss"]) <= STEP64_TOL
        assert _err(r["grad"], ref["grad"]) <= STEP64_TOL
        assert abs(r["scale_grad"] - ref["scale_grad"]) <= STEP64_TOL * max(
            1.0, abs(ref["scale_grad"]))
    assert all(np.array_equal(r["grad"], ranks[0]["grad"]) for r in ranks)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_defender_with_a_packed_victim_matches_one_process(runs, mesh):
    """The defender's packed victim view and its float32 step under the
    mesh: the victim's detections equal, the loss within 2e-4 relative (the
    masker's float32 colour sums run in another order on a shard)."""
    ref = runs["ref"]["defender"]
    assert ref["valid"].any()
    for r in runs[mesh]:
        got = r["defender"]
        for k in ("boxes", "scores", "valid"):
            assert np.array_equal(got[k], ref[k]), k
        assert rel(got["loss"], ref["loss"]) <= TOL


def test_packed_attack_step_float32_matches_jax_one_device(runs):
    jref = runs["jax"]["attack"]
    patch = torch.tensor(runs["inp"]["jax_patch"])
    tv = torch.autograd.functional.jacobian(
        lambda p: 1e-5 * peot.total_variation(p), patch).numpy().ravel()
    for r in runs["s12"]:
        got = r["attack"]["f32"]
        assert rel(got["loss"], jref["loss"]) <= 1e-4
        a, b = got["grad"].ravel(), jref["grad"].ravel()
        assert cosine(a, b) >= 0.9999
        assert cosine(a - tv, b - tv) >= 0.99  # through the warp and the net


# ---------------------------------------------------------------------------
# (c) the int8 serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_int8_serve_matches_one_process(runs, mesh):
    ref = runs["ref"]["int8"]
    for r in runs[mesh]:
        got = r["int8"]
        assert got["scales"] == ref["scales"]  # calibrated whole on every rank
        off = np.abs(got["out"] - ref["out"]) > INT8_ATOL
        assert off.mean() <= INT8_SHARE, off.mean()
        for field in ("classes", "valid", "valid_len"):
            assert np.array_equal(getattr(got["det"], field), getattr(ref["det"], field))
        assert float(np.abs(got["det"].scores - ref["det"].scores).max()) <= 1e-4


# ---------------------------------------------------------------------------
# (d) the segmentation trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_segmentation_step_float64_matches_one_process(runs, mesh):
    ref = runs["ref"]["seg"]
    ranks = [r["seg"] for r in runs[mesh]]
    assert rel(ranks[0]["loss"], ref["loss"]) <= STEP64_TOL
    assert scale_err(ranks[0]["net"], ref["net"]) <= STEP64_TOL
    for r in ranks[1:]:  # every rank takes the same step
        assert r["loss"] == ranks[0]["loss"]
        assert all(np.array_equal(r["net"][k], v) for k, v in ranks[0]["net"].items())


def test_segmentation_step_float32_matches_jax_one_device_step(runs):
    """Within twice JAX's own float32 error (against the port's float64
    one-process step), or 2e-4 of max(1, max|ref|), leaf by leaf; and
    `eval_step` and `predict_mask` of the seed-0 net as one process's."""
    from test_torch_train import _leaf_dists
    jref, ref64, ref32 = runs["jax"]["seg"], runs["ref"]["seg"], runs["ref"]["seg32"]
    errs = lambda a, b: max(d for _, d in _leaf_dists(a, b))
    own_loss = rel(jref["loss"], ref64["loss"])
    for r in runs["s12"]:
        got = r["seg32"]
        assert rel(got["loss"], jref["loss"]) <= max(TOL, 2 * own_loss)
        for key in ("params", "batch_stats"):
            own = errs(jref[key], ref64["flax"][key])
            assert errs(got["flax"][key], jref[key]) <= max(TOL, 2 * own), (key, own)
        for k, v in ref32["eval"].items():
            assert abs(got["eval"][k] - v) <= TOL * max(1.0, abs(v)), k
        assert (got["mask"] == ref32["mask"]).mean() >= 0.999


# ---------------------------------------------------------------------------
# (e) the gather backend; (f) the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gather_backend_rows_match_one_process(runs, mesh):
    out, region = runs["ref"]["gather"]
    assert region.any()
    n = MESHES[mesh][1]
    for rank, r in enumerate(runs[mesh]):
        got_out, got_region = r["gather"]
        assert np.array_equal(got_region, _rows_of(region, rank, n))
        assert float(np.abs(got_out - _rows_of(out, rank, n)).max()) <= GATHER_TOL


def test_packed_attack_driver_with_spatial_2(runs):
    tmp = runs["tmp"]["s12"]
    files = lambda d: sorted(os.path.relpath(os.path.join(p, f), d)
                             for p, _, fs in os.walk(d) for f in fs)
    assert files(tmp / "driver1") == ["logs/metrics.p1.jsonl"]
    main = files(tmp / "driver0")
    assert "logs/metrics.jsonl" in main and "state-latest.msgpack" in main
    assert any(f.startswith("patch_00_") for f in main)
    r0, r1 = (r["driver"] for r in runs["s12"])
    assert np.array_equal(r0["patch"], r1["patch"]) and r0["scale"] == r1["scale"]
    assert r0["patch"].shape == (32, 32, 3)
