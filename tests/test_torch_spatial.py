"""Spatial partitioning of the victim (`parallel/spatial.py`) across
processes, on the CPU.

Ranks are spawned processes (`parallel.launch.spawn`: gloo, one torch
thread a rank), at meshes ('data', 'spatial') = (1, 2) and (2, 2): each
image's 64 rows split over 2 ranks. The config is the tiny lite0@64, whose
levels 3-4 are row-sharded and 5-7 replicated at spatial 2, so both layouts
and both transitions (a stride-2 block and a max pool from a sharded level
to a replicated one, an upsample back) run. What is held:

- (a) the layout rule, a pure function, for lite4@640 at spatial 2 and 4
  and for lite0@64;
- (b) `rows`, `gather_rows` and `local_rows` at 2 ranks in float64: the
  forward exact, each gradient summed over the ranks equal to the
  one-process gradient; EOT's brightness and histogram matches of a shard
  equal to the whole image's;
- (c) the victim's eval forward at (1, 2), (2, 2) and (1, 4) against the
  one-process net: raw head outputs within 1e-10 of max(1, max|ref|) in
  float64 (the unfused blocks: the fused op has no float64 instance) and
  2e-4 in float32 (the fused blocks' plain version), and the input
  gradient of a seeded cotangent on every output alike;
- (d) forward hooks on rank 0: every conv, BatchNorm and block on a
  row-sharded level sees its H / n rows, and every fused op H / n plus at
  most 2 halos; the fused op runs on every fuseable block;
- (e) `Detector(mesh=make_serve_mesh(1, 2))` and `(2, 2)` on 3 frames (the
  padding path), host and device preprocessing, against JAX's one-device
  `Detector`: scores within 1e-5, boxes within 1e-3, classes equal
  (tests/test_parallel.py:179-187);
- (f) the supervised step at (1, 2) and (2, 2) in float64 within 1e-8 of
  scale of the one-process step (parameters, statistics, loss); at (1, 2)
  in float32 against JAX's one-device step within twice JAX's own float32
  error, or 2e-4 of scale (ROADMAP Queue 3 item 22);
- (g) the attack step at (1, 2), with and without `grad_accum`, against the
  one-process step: loss within 1e-4 relative, patch-gradient cosine >=
  0.9999 and its norm within 1e-4, the patch after Adam within lr; with
  JAX's draws and EOT pinned, against JAX's one-device step;
- (h) the drivers at 2 ranks: `attack.train.train(spatial=2,
  grad_accum=2)` (tests/test_train_drivers.py:31-45) and
  `train.train.train(spatial=2)`, 2 synthetic steps each, rank 0 alone
  writing files, the ranks bit-equal and near the one-process driver (the
  defender's driver under a spatial mesh: tests/test_torch_spatial_defense.py);
- (i) under the spatial mesh both U-Nets, the packed backbone entry and
  the segmentation head run (their results: tests/test_torch_spatial_defense.py
  and tests/test_torch_spatial_rest.py).

Spawned ranks import this module, so it imports no JAX at its top.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from mladversarialobjectdetection_torch import parallel
from mladversarialobjectdetection_torch.attack import train as attack_train
from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.inference.detector import Detector
from mladversarialobjectdetection_torch.models import efficientnet
from mladversarialobjectdetection_torch.models.efficientdet import (
    EfficientDetNet, spec_from_config)
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.ops import color
from mladversarialobjectdetection_torch.ops import mbconv as mbconv_ops
from mladversarialobjectdetection_torch.parallel import launch, spatial
from mladversarialobjectdetection_torch.train import train as sup_train
from mladversarialobjectdetection_torch.train.trainer import DetectorTrainer
from test_torch_parallel import (PINNED, SERVE_PARAMS, TINY, _state_arrays,
                                 cosine, jax_victim, rel, scale_err, tiny_cfg)

B, HW, K, LR = 2, 64, 4, 1e-2   # global batch, image side, box slots, Adam lr
N_SP = 2                        # ranks of a spatial group
SPAWN_TIMEOUT_S = 240.0
DRIVER = dict(synthetic=True, image_size=HW, epochs=1, steps_per_epoch=2,
              config_override=TINY, patch_size=32, visualize_freq=0,
              mixed_precision=False, device="cpu")
SUP_DRIVER = dict(batch_size=2, num_epochs=1, steps_per_epoch=2, image_size=HW,
                  config_override=TINY, device="cpu")


def make_inputs():
    """The global batch, the seeded cotangents and 3 frames (seeded numpy)."""
    rng = np.random.default_rng(17)
    images = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    boxes = np.zeros((B, K, 4), np.float32)
    valid = np.zeros((B, K), bool)
    for i in range(B):
        for k in range(2 + i):
            y0, x0 = rng.uniform(2, 24, 2)
            h, w = rng.uniform(20, 38, 2)
            boxes[i, k] = (y0, x0, y0 + h, x0 + w)
            valid[i, k] = True
    spec = spec_from_config(tiny_cfg())
    levels = [spec.level_hw[lv] for lv in range(spec.min_level, spec.max_level + 1)]
    cot = [rng.normal(size=(B, h, w, c)) for c in (90 * 9, 4 * 9) for h, w in levels]
    return dict(images=images, boxes=boxes, valid=valid, cot=cot,
                gt_classes=rng.integers(0, 90, (B, K)).astype(np.int32),
                prim=rng.normal(size=(2, 3, 8, 5)), prim_g=rng.normal(size=(2, 2, 3, 12, 5)),
                frames=[rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
                        for _ in range(3)],
                psrc=rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32))


# ---------------------------------------------------------------------------
# the computations, run alike by one process (no mesh) and by each rank
# ---------------------------------------------------------------------------

def victim(dtype=torch.float32):
    net = EfficientDetNet(spec_from_config(tiny_cfg())).eval()
    init_weights(net, torch.Generator().manual_seed(0))
    for p in net.parameters():
        p.requires_grad_(False)
    if dtype == torch.float64:
        net.double()
        net.compute_dtype = torch.float64
    return net


def forward(images, cot, dtype, rows=slice(None), spy=False):
    """The eval forward's raw head outputs (every row) and the input
    gradient of sum(outputs * cot) (this rank's rows); with `spy`, the rows
    every hooked module and fused op saw, beside the global height."""
    net = victim(dtype)
    x = torch.as_tensor(images, dtype=dtype).requires_grad_(True)
    seen, hooks = [], []
    if spy:
        at = {}

        def hook(kind, pos):
            def fn(module, args, kwargs):
                height = kwargs.get("height", args[pos] if len(args) > pos else None)
                at["height"] = height
                seen.append((kind, height, args[0].shape[2]))
            return fn

        for m in net.modules():
            kind, pos = {efficientnet.Conv2d: ("conv", 1), efficientnet.BatchNorm: ("bn", 2),
                         efficientnet.MBConvBlock: ("block", 4)}.get(type(m), (None, 0))
            if kind:
                hooks.append(m.register_forward_pre_hook(hook(kind, pos), with_kwargs=True))
        fused, orig = mbconv_ops.mbconv, mbconv_ops.mbconv

        def op(xe, *a, **kw):
            seen.append(("op", at["height"], xe.shape[1]))
            return orig(xe, *a, **kw)
        mbconv_ops.mbconv = op
    try:
        with (efficientnet.unfused_blocks() if dtype == torch.float64
              else contextlib.nullcontext()):
            cls, box = net(x)
            loss = sum((o * torch.as_tensor(c[rows], dtype=dtype)).sum()
                       for o, c in zip(cls + box, cot))
            spatial.count_once(loss).backward()
    finally:
        for h in hooks:
            h.remove()
        if spy:
            mbconv_ops.mbconv = fused
    flat = torch.cat([o.detach().reshape(o.shape[0], -1) for o in cls + box], 1).numpy()
    return {"out": flat, "grad": x.grad.numpy(), "seen": seen,
            "fuseable": sum(b.fuseable for b in net.modules()
                            if isinstance(b, efficientnet.MBConvBlock))}


def supervised_step(inp, images, rows=slice(None), x64=True):
    tr = DetectorTrainer(tiny_cfg(moving_average_decay=0.9), steps_per_epoch=10,
                         device="cpu")
    st = tr.init_state(seed=0)
    if x64:
        st.net.double()
        st.net.compute_dtype = torch.float64
        st.ema = {n: e.double() for n, e in st.ema.items()}
        images = images.astype(np.float64)
    st, m = tr.train_step(st, images, inp["boxes"][rows], inp["gt_classes"][rows],
                          inp["valid"][rows])
    return {"loss": float(m["loss"]), "net": _state_arrays(st.net),
            "flax": bridge.torch_to_flax(st.net)}


def attack_step(inp, images, rows=slice(None), jax_case=False, grad_accum=1):
    cfg = tiny_cfg()
    atk = PatchAttacker(cfg, victim(), patch_size=32, learning_rate=LR,
                        eot_overrides=PINNED if jax_case else None,
                        grad_accum=grad_accum, device="cpu")
    state = atk.init_state(0, initial_patch=inp["jax_patch"] if jax_case else None)
    draws = None
    if jax_case:
        draws = type(inp["jax_draws"])(*(None if f is None else f[rows]
                                         for f in inp["jax_draws"]))
    state, m = atk.train_step(
        state, torch.from_numpy(images), with_asr=True,
        boxes_override=(torch.from_numpy(inp["boxes"][rows]),
                        torch.from_numpy(inp["valid"][rows])), eot_draws=draws)
    return {"loss": float(m.loss), "grad": state.patch.grad.numpy().copy(),
            "patch": state.patch.detach().numpy().copy(),
            "scale": float(state.scale.detach()),
            "metrics": {k: float(v) for k, v in m._asdict().items()}}


def primitives(inp):
    """`rows` (a halo with fill beyond the edges; uneven spans), `gather_rows`
    (equal and uneven counts) and `local_rows` on this rank's shard of
    `inp["prim"]` [2, 3, 8, 5] (rows on dim 2), each with the seeded
    cotangent of this rank; outputs and input gradients."""
    sp = spatial.active()
    i, x_all = sp.index, torch.from_numpy(inp["prim"])
    g = torch.from_numpy(inp["prim_g"][i])  # [2, 3, 12, 5]
    out = {}
    cases = {
        "halo": lambda x: spatial.rows(x, i * 4 - 2, (i + 1) * 4 + 2, fill=-3.0),
        "spans": lambda x: spatial.rows(x, [1, 2], [7, 8]),
        "gather": lambda x: spatial.gather_rows(x),
        "gather_uneven": lambda x: spatial.gather_rows(x[:, :, :3 - i], counts=[3, 2]),
    }
    for name, fn in cases.items():
        x = x_all[:, :, 4 * i:4 * i + 4].clone().requires_grad_(True)
        y = fn(x)
        (y * g[:, :, :y.shape[2]]).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    x = x_all.clone().requires_grad_(True)  # replicated
    y = spatial.local_rows(x)
    (y * g[:, :, :4]).sum().backward()
    out["local"] = (y.detach().numpy(), x.grad.numpy())
    # EOT's colour matches read the whole image's Y channel through sums
    group_sum = lambda t: parallel.reduce_sum(t, parallel.SPATIAL_AXIS)
    src = torch.from_numpy(inp["psrc"])
    shard = torch.from_numpy(inp["images"][:, HW // 2 * i:HW // 2 * (i + 1)])
    out["bright"] = color.brightness_match(src, shard, group_sum).numpy()
    out["hist"] = color.histogram_match(src, shard, group_sum).numpy()
    return out


def refusals(images):
    """What each path raises under the active spatial mesh (None: it ran):
    the U-Nets, the packed backbone entry and the segmentation head."""
    from mladversarialobjectdetection_torch.models.unet import PatchNeutralizer
    from mladversarialobjectdetection_torch.models.unet_packed import (
        PackedPatchNeutralizer)
    x = torch.from_numpy(images)
    calls = {"unet": lambda: PatchNeutralizer(n_filters=4)(x),
             "unet_packed": lambda: PackedPatchNeutralizer(n_filters=4)(x),
             "packed_entry": lambda: victim().with_packed_entry(2)(x),
             "segmentation": lambda: EfficientDetNet(spec_from_config(tiny_cfg(
                 heads=["object_detection", "segmentation"])))(x)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001  what raised, for the assertion
            out[name] = f"{type(e).__name__}: {e}"
    return out


def serve(frames, mesh):
    det = Detector("efficientdet-lite0", params=SERVE_PARAMS, seed=0,
                   device="cpu", mesh=mesh)
    return det.serve(frames), det.serve(frames, device_preprocess=True)


def drivers(tmp, tag):
    """The attack driver (spatial 2, grad_accum 2, batch 4) and, at 2 ranks,
    the supervised driver (batch 2) for 2 synthetic steps."""
    sp = {"spatial": N_SP} if tag != "ref" else {}
    atk = attack_train.train("efficientdet-lite0", batch_size=4, grad_accum=2,
                             save_dir=os.path.join(tmp, f"attack{tag}"), **sp, **DRIVER)
    out = {"patch": atk.patch.detach().numpy().copy(),
           "scale": float(atk.scale.detach())}
    if sp:
        sup = sup_train.train("efficientdet-lite0", model_dir=os.path.join(
            tmp, f"sup{tag}"), **sp, **SUP_DRIVER)
        out["sup"] = _state_arrays(sup.net)
    return out


def _rank_worker(rank, tmp, n_data, n_sp=N_SP):
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    if n_data == 1:
        mesh = parallel.make_train_mesh(B, n_sp, image_h=HW, device="cpu")
    else:
        mesh = parallel.make_serve_mesh(n_data, n_sp, device="cpu")
    d = rank // n_sp
    rows = slice(d * B // n_data, (d + 1) * B // n_data)
    mine = lambda x: parallel.shard_batch(mesh, x).numpy()  # batch, then rows
    images = mine(inp["images"])
    out = {"shape": mesh.shape, "images": images}
    with parallel.use_mesh(mesh):
        out["fwd64"] = forward(images, inp["cot"], torch.float64, rows)
        out["fwd32"] = forward(images, inp["cot"], torch.float32, rows, spy=rank == 0)
    if n_sp != N_SP:  # the forward alone: ranks with a neighbour on each side
        torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
        return
    with parallel.use_mesh(mesh):
        out["sup64"] = supervised_step(inp, images, rows)
        if n_data == 1:
            out["prims"] = primitives(inp)
            out["sup32"] = supervised_step(inp, images, rows, x64=False)
            out["attack"] = attack_step(inp, images, rows)
            out["attack_accum"] = attack_step(inp, images, rows, grad_accum=2)
            out["attack_jax"] = attack_step(inp, images, rows, jax_case=True)
            out["refusals"] = refusals(images)
    out["serve"] = serve(inp["frames"], mesh)
    if n_data == 1:
        out["drivers"] = drivers(tmp, str(rank))
    else:  # the one-process steps on the global batch (no mesh: no collective)
        every = slice(None)
        refs = ({"fwd64": lambda: forward(inp["images"], inp["cot"], torch.float64),
                 "fwd32": lambda: forward(inp["images"], inp["cot"], torch.float32)},
                {"sup64": lambda: supervised_step(inp, inp["images"])},
                {"attack": lambda: attack_step(inp, inp["images"], every)},
                {"attack_accum": lambda: attack_step(inp, inp["images"], every,
                                                     grad_accum=2)})[rank]
        out["ref"] = {name: step() for name, step in refs.items()}
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))


def run_ranks(tmp, n_data, n_sp=N_SP):
    tmp = str(tmp)
    launch.spawn(_rank_worker, n_data * n_sp, (tmp, n_data, n_sp),
                 init_method=f"file://{tmp}/store", threads=1,
                 timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"r{r}.pt"), weights_only=False)
            for r in range(n_data * n_sp)]


# ---------------------------------------------------------------------------
# the JAX references (one device: GSPMD's result is the one-device result)
# ---------------------------------------------------------------------------

def jax_serve(frames):
    from mladversarialobjectdetection_tpu.inference.detector import Detector as JDetector
    jdet = JDetector(model_name="efficientdet-lite0", params=SERVE_PARAMS)
    jdet.variables = bridge.torch_to_flax(
        Detector("efficientdet-lite0", params=SERVE_PARAMS, seed=0, device="cpu").net)
    return jdet.serve(frames), jdet.serve(frames, device_preprocess=True)


def jax_supervised_f32(inp):
    import jax
    import jax.numpy as jnp
    from conftest import tiny_config
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
    jst, _ = jax.jit(jt.train_step)(state, *(jnp.asarray(inp[k]) for k in
                                             ("images", "boxes", "gt_classes", "valid")))
    return jax.tree_util.tree_map(np.asarray, (jst.params, jst.batch_stats))


def jax_attack_inputs():
    """JAX's attacker (EOT pinned), its initial state and the draws of its
    first step."""
    import jax
    from test_torch_attack import step_draws
    from mladversarialobjectdetection_tpu.attack.attacker import PatchAttacker as JAttacker
    jcfg, variables = jax_victim()
    jatk = JAttacker(jcfg, variables, patch_size=32, eot_overrides=PINNED)
    jst = jatk.init_state(jax.random.PRNGKey(0))
    return jatk, jst, step_draws(jst.key, B, K)[0]


def jax_attack(inp, jatk, jst):
    """JAX's one-device attack step."""
    import jax
    import jax.numpy as jnp
    step = jax.jit(jatk.train_step, static_argnames=("with_asr",))
    jout, jm = step(jst, jnp.asarray(inp["images"]), boxes_override=(
        jnp.asarray(inp["boxes"]), jnp.asarray(inp["valid"])))
    return {"loss": float(jm.loss), "patch": np.asarray(jout.patch),
            "scale": float(jout.scale)}


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
    """Both spawns (2 ranks at (1, 2), 4 at (2, 2)), beside the one-process
    and JAX references in this process."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = {k: tmp_path_factory.mktemp(k) for k in ("s12", "s22", "s14", "ref")}
    inp = make_inputs()
    jatk, jst, inp["jax_draws"] = jax_attack_inputs()
    inp["jax_patch"] = np.asarray(jst.patch)
    for k in ("s12", "s22", "s14"):
        torch.save(inp, tmp[k] / "inputs.pt")
    with ThreadPoolExecutor(5) as pool:  # JAX compiles beside the ranks
        spawned = {"s12": pool.submit(run_ranks, tmp["s12"], 1),
                   "s22": pool.submit(run_ranks, tmp["s22"], 2),
                   "s14": pool.submit(run_ranks, tmp["s14"], 1, 4)}
        jax_ref = {"serve": pool.submit(jax_serve, inp["frames"]),
                   "sup32": pool.submit(jax_supervised_f32, inp)}
        jax_ref["attack"] = jax_attack(inp, jatk, jst)
        ref_drivers = drivers(str(tmp["ref"]), "ref")
        out = {k: f.result() for k, f in spawned.items()}
        jax_ref = {k: v if isinstance(v, dict) else v.result() for k, v in jax_ref.items()}
    ref = {k: v for r in out["s22"] for k, v in r["ref"].items()}
    ref["drivers"] = ref_drivers
    return dict(inp=inp, ref=ref, jax=jax_ref, tmp=tmp, **out)


def _rows_of(x, rank, n_data, n_sp=N_SP):
    """The global batch's rows that `rank` of an (n_data, n_sp) mesh holds."""
    d, s = divmod(rank, n_sp)
    b, h = x.shape[0] // n_data, x.shape[1] // n_sp
    return x[d * b:(d + 1) * b, s * h:(s + 1) * h]


# ---------------------------------------------------------------------------
# (a) the layout rule; (b) the primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model, n, want", [
    ("efficientdet-lite4", 2, {1: True, 3: True, 5: True, 6: True, 7: False}),
    ("efficientdet-lite4", 4, {1: True, 3: True, 5: True, 6: False, 7: False}),
    ("efficientdet-lite0", 2, {1: True, 3: True, 4: True, 5: False, 6: False})])
def test_layout_rule(model, n, want):
    from mladversarialobjectdetection_torch import config as pconfig
    cfg = pconfig.get_efficientdet_config(model)
    if model.endswith("lite0"):
        cfg.update(TINY)
    heights = [h for h, _ in spec_from_config(cfg).level_hw]
    assert {lv: spatial.is_sharded(heights[lv], n) for lv in want} == want
    # n divides the height and every shard holds at least MAX_HALO rows
    assert spatial.MAX_HALO == 2
    assert not spatial.is_sharded(10, 4) and spatial.is_sharded(20, 4)
    assert not spatial.is_sharded(2, 2) and spatial.is_sharded(4, 2)
    assert not spatial.is_sharded(640, 1)


def test_primitives_forward_exact_and_gradients_sum_to_one_process(runs):
    x = runs["inp"]["prim"]
    g = runs["inp"]["prim_g"]
    ranks = runs["s12"]
    pad = np.full((2, 3, 2, 5), -3.0)
    windows = {"halo": [np.concatenate([pad, x[:, :, :6]], 2),
                        np.concatenate([x[:, :, 2:], pad], 2)],
               "spans": [x[:, :, 1:7], x[:, :, 2:8]],
               "gather": [x, x], "gather_uneven": [x[:, :, [0, 1, 2, 4, 5]]] * 2,
               "local": [x[:, :, :4], x[:, :, 4:]]}
    for name, want in windows.items():
        for i, r in enumerate(ranks):
            np.testing.assert_array_equal(r["prims"][name][0], want[i], err_msg=name)
    # the one-process gradient of sum_i sum(window_i * g_i)
    ref = {k: np.zeros_like(x) for k in windows}
    ref["halo"][:, :, 0:6] += g[0][:, :, 2:8]  # window rows -2..5, 2..9
    ref["halo"][:, :, 2:8] += g[1][:, :, 0:6]
    for i in range(2):
        ref["spans"][:, :, 1 + i:7 + i] += g[i][:, :, :6]
        ref["gather"] += g[i][:, :, :8]
        ref["gather_uneven"][:, :, [0, 1, 2, 4, 5]] += g[i][:, :, :5]
        ref["local"][:, :, 4 * i:4 * i + 4] += g[i][:, :, :4]
    for name in windows:
        if name == "local":  # replicated input: the partial gradients sum
            got = ranks[0]["prims"][name][1] + ranks[1]["prims"][name][1]
        else:
            got = np.concatenate([r["prims"][name][1] for r in ranks], 2)
        np.testing.assert_allclose(got, ref[name], rtol=0, atol=1e-14, err_msg=name)
    # the colour matches of a shard: the whole image's Y mean and histogram
    src, images = (torch.from_numpy(runs["inp"][k]) for k in ("psrc", "images"))
    for r in ranks:
        np.testing.assert_allclose(r["prims"]["bright"],
                                   color.brightness_match(src, images).numpy(), atol=1e-6)
        np.testing.assert_array_equal(r["prims"]["hist"],
                                      color.histogram_match(src, images).numpy())


# ---------------------------------------------------------------------------
# (c) the victim; (d) no hidden full-image path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["s12", "s22", "s14"])
@pytest.mark.parametrize("dtype, tol", [("fwd64", 1e-10), ("fwd32", 2e-4)])
def test_victim_forward_matches_one_process(runs, mesh, dtype, tol):
    """s14: 4 ranks an image, the middle two with a neighbour on each side;
    levels 1-3 row-sharded, level 3 at 2 rows a rank (its k5 blocks' halo
    a whole neighbour shard), 4 and up replicated."""
    ref = runs["ref"][dtype]
    n_data, n_sp = {"s12": (1, 2), "s22": (2, 2), "s14": (1, 4)}[mesh]
    scale = max(1.0, float(np.abs(ref["out"]).max()))
    b = B // n_data
    for rank, r in enumerate(runs[mesh]):
        d = rank // n_sp
        got = r[dtype]["out"]
        assert float(np.abs(got - ref["out"][d * b:(d + 1) * b]).max()) <= tol * scale
        want = _rows_of(ref["grad"], rank, n_data, n_sp)
        g_scale = max(1.0, float(np.abs(ref["grad"]).max()))
        assert float(np.abs(r[dtype]["grad"] - want).max()) <= tol * g_scale


def test_sharded_levels_see_their_rows_only(runs):
    r0 = runs["s12"][0]["fwd32"]
    seen = r0["seen"]
    sharded = [(k, h, rows) for k, h, rows in seen
               if h is not None and spatial.is_sharded(h, N_SP)]
    replicated = [(k, h, rows) for k, h, rows in seen
                  if h is not None and not spatial.is_sharded(h, N_SP)]
    assert sharded and replicated
    for kind, h, rows in sharded:
        limit = h // N_SP + (2 * spatial.MAX_HALO if kind == "op" else 0)
        assert rows <= limit, (kind, h, rows)
    for kind, h, rows in replicated:  # small levels only, whole
        assert rows == h and h < HW // 8, (kind, h, rows)
    # the image's 64 rows reach the stem as 32 a rank; the fused op ran on
    # every fuseable block, each on a halo-extended shard
    assert ("conv", HW, HW // N_SP) in seen
    assert sum(kind == "op" for kind, _, _ in seen) == r0["fuseable"]
    ops = [rows - h // N_SP for kind, h, rows in sharded if kind == "op"]
    assert ops and all(0 < e <= 2 * spatial.MAX_HALO for e in ops)


# ---------------------------------------------------------------------------
# (e) serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["s12", "s22"])
def test_detector_spatial_mesh_matches_jax_one_device_detector(runs, mesh):
    for r in runs[mesh]:
        for got, ref in zip(r["serve"], runs["jax"]["serve"]):
            assert got.boxes.shape == ref.boxes.shape  # the padding stripped
            np.testing.assert_allclose(got.scores, ref.scores, atol=1e-5)
            np.testing.assert_allclose(got.boxes, ref.boxes, atol=1e-3)
            np.testing.assert_array_equal(got.classes, ref.classes)


def test_spatial_meshes_and_image_rows(runs):
    for mesh, n_data in (("s12", 1), ("s22", 2)):
        for rank, r in enumerate(runs[mesh]):
            assert r["shape"] == {"data": n_data, "spatial": N_SP}
            np.testing.assert_array_equal(
                r["images"], _rows_of(runs["inp"]["images"], rank, n_data))
    with pytest.raises(ValueError, match="divisible by the 'spatial' mesh axis size 2"):
        Detector("efficientdet-lite0", params={**SERVE_PARAMS, "image_size": 63},
                 device="cpu", mesh=parallel.Mesh(np.arange(2).reshape(1, 2),
                                                  ("data", "spatial"), device="cpu"))


# ---------------------------------------------------------------------------
# (f) the supervised step; (g) the attack step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["s12", "s22"])
def test_supervised_step_float64_matches_one_process(runs, mesh):
    ref = runs["ref"]["sup64"]
    ranks = [r["sup64"] for r in runs[mesh]]
    assert rel(ranks[0]["loss"], ref["loss"]) <= 1e-8
    assert scale_err(ranks[0]["net"], ref["net"]) <= 1e-8
    for r in ranks[1:]:
        assert all(np.array_equal(r["net"][k], ranks[0]["net"][k]) for k in ref["net"])


def test_supervised_step_float32_matches_jax_one_device_step(runs):
    """Within twice JAX's own float32 error (against the port's float64
    step), or 2e-4 of scale (ROADMAP Queue 3 item 22)."""
    from test_torch_train import _leaf_dists
    got = runs["s12"][0]["sup32"]["flax"]
    ref64 = runs["ref"]["sup64"]["flax"]
    for out, j, r in zip((got["params"], got["batch_stats"]), runs["jax"]["sup32"],
                         (ref64["params"], ref64["batch_stats"])):
        own = max(d for _, d in _leaf_dists(j, r))
        worst = max(_leaf_dists(out, j), key=lambda x: x[1])
        assert worst[1] <= max(2e-4, 2.0 * own), (worst, own)


@pytest.mark.parametrize("case", ["attack", "attack_accum"])
def test_attack_step_matches_one_process(runs, case):
    ref = runs["ref"][case]
    r0, r1 = (r[case] for r in runs["s12"])
    assert rel(r0["loss"], ref["loss"]) <= 1e-4 and r0["loss"] == r1["loss"]
    assert cosine(r0["grad"], ref["grad"]) >= 0.9999
    # each rank's patch gradient is a partial one: their sum is the gradient
    assert rel(np.linalg.norm(r0["grad"]), np.linalg.norm(ref["grad"])) <= 1e-4
    assert np.array_equal(r0["patch"], r1["patch"])
    assert float(np.abs(r0["patch"] - ref["patch"]).max()) <= LR
    assert abs(r0["scale"] - ref["scale"]) <= 1e-6
    for f in ("scale_loss", "mean_max_score", "asr", "tv_loss"):
        assert r0["metrics"][f] == pytest.approx(ref["metrics"][f], rel=1e-4,
                                                 abs=1e-6), f


def test_attack_step_matches_jax_one_device_step(runs):
    ref, got = runs["jax"]["attack"], runs["s12"][0]["attack_jax"]
    assert rel(got["loss"], ref["loss"]) <= 1e-4
    assert float(np.abs(got["patch"] - ref["patch"]).max()) <= LR
    assert abs(got["scale"] - ref["scale"]) <= 1e-6


def test_item10_paths_raise_under_a_spatial_mesh(runs):
    """Every path of ROADMAP Queue 1 item 10 runs under the mesh, none
    raises: the U-Nets (their results: tests/test_torch_spatial_defense.py),
    the packed entry and the segmentation head (tests/test_torch_spatial_rest.py)."""
    for r in runs["s12"]:
        assert set(r["refusals"]) == {"unet", "unet_packed", "packed_entry", "segmentation"}
        for name, msg in r["refusals"].items():
            assert msg is None, (name, msg)


# ---------------------------------------------------------------------------
# (h) the drivers
# ---------------------------------------------------------------------------

def test_drivers_with_spatial_2(runs):
    tmp = runs["tmp"]["s12"]
    r0, r1 = (r["drivers"] for r in runs["s12"])
    ref = runs["ref"]["drivers"]
    files = lambda d: sorted(os.path.relpath(os.path.join(p, f), d)
                             for p, _, fs in os.walk(d) for f in fs)
    assert files(tmp / "attack1") == ["logs/metrics.p1.jsonl"]
    main = files(tmp / "attack0")
    assert "logs/metrics.jsonl" in main and "state-latest.msgpack" in main
    assert any(f.startswith("patch_00_") for f in main)
    assert any(f.startswith("ckpt-0") for f in files(tmp / "sup0"))
    # the ranks end bit-equal; two Adam steps from the one-process driver
    # (the same streams and draws) move no pixel by more than 2 lr
    assert np.array_equal(r0["patch"], r1["patch"]) and r0["scale"] == r1["scale"]
    assert r0["patch"].shape == (32, 32, 3)
    assert float(np.abs(r0["patch"] - ref["patch"]).max()) <= 2 * LR
    assert abs(r0["scale"] - ref["scale"]) <= 1e-5
    # the supervised driver: the ranks end bit-equal, its loss finite (the
    # step itself is held in float64 above: a float32 train-mode step at
    # batch 2 amplifies rounding, ROADMAP Queue 3 item 22)
    for k, v in r0["sup"].items():
        assert np.array_equal(v, r1["sup"][k]), k
    log = (tmp / "sup0" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert np.isfinite(json.loads(log[-1])["train/loss"])
