"""Spatial partitioning of the defender across processes, on the CPU: both
U-Nets, the cmconv on halo-extended shards, the masker, the defender's
steps and `defense.train.train(spatial=2)`.

Ranks are spawned processes (`parallel.launch.spawn`: gloo, one torch
thread a rank) at meshes ('data', 'spatial') = (1, 2) (two groups of 2
ranks that share its jobs), (2, 2) and (1, 4), all side by side in one
module fixture, beside the one-process and JAX references in this process. The victim is the tiny lite0@64 of
`tests/test_torch_parallel.py`; the U-Net has n_filters 4, so its levels
are 64, 32, 16, 8 and 4 rows high and its 3x3 convs of at most 16 filters
(levels 0-2) run `ops/cmconv.cmconv`. At spatial 4 the 4-row bottleneck is
replicated (1 row a rank, under `MAX_HALO`), so a sharded-to-replicated
max pool and the transposed conv back both run. The global batch is 4
images. What is held:

- (a) each U-Net's train-mode forward (BatchNorm statistics over data x
  spatial, dropout on) and input gradient, plain and packed at levels 1-3,
  on 2 images in float64 against one process within 1e-10 of
  max(1, max|ref|) (packed at (1, 2)); forward hooks on rank 0: every cmconv call sees its
  shard plus one halo row at each side (H / n + 2 rows, H the one-process call's rows) and every
  BatchNorm its level's H / n rows where the layout shards the level, H
  where it replicates it;
- (b) the float64 defender `train_step` with dropout on, `grad_accum` 1
  and 2, at each mesh (and with `remat` at (1, 2)): loss, U-Net parameters
  and statistics within 1e-8 of max(1, max|ref|) of the one-process step
  on the same generator. The victim and masker are stubbed by a pointwise
  function of the images (the masker's float32 colour-match sums run in
  another order on a shard, which no float64 bound survives; the masker is
  held in (e) and its rows in the step of (c)). At (2, 2) with
  `grad_accum` 2 each data shard splits its own images, so the reference
  takes the batch in the order those microbatches make;
- (c) the float32 step at (1, 2), the real flat victim and masker on the
  ranks, dropout 0, against JAX's one-device `PatchAttackDefender.
  train_step` on the masker output and boxes of the port's one-process
  step (JAX's matmul masker rounds its canvas to bf16, and the gather
  backend refuses a spatial mesh): the loss, Adam's first moment (0.1 g)
  and the statistics within twice JAX's own float32 error (against the
  port's float64 one-process step) or 2e-4 of max(1, max|ref|), ROADMAP
  Queue 3 item 22's rule, and the parameters after Adam so too and within
  2 lr (at this batch JAX's float32 step takes a few weights whose gradient
  is near 1e-5 the other way from the float64 step, so the 1e-5 rule of
  `tests/test_torch_defense.py` holds neither JAX nor the port here);
- (d) the bf16 step at (1, 2) against the one-process bf16 step within the
  limits `tests/test_torch_defense_variants.py` holds the bf16 defender to
  (loss, first-moment cosine leaf by leaf, statistics, the sure share after
  Adam) and the whole first moment at cosine >= 0.999 (the limit
  `chip_smoke.py` phase 25e holds the card to); `remat` bit-equal to no
  remat at (1, 2) in bf16;
- (e) the train-mode masker (crops of rows other ranks hold) at each mesh
  against one process: patched images and targets within 1e-6, the region
  equal; `eval_step` (loss, PSNR, ADR on a flat victim that detects every
  anchor at .95) and `recover`'s rows at (1, 4) within 2e-4 of
  max(1, max|ref|);
- (f) `defense.train.train(spatial=2)` plain and `packed=2`, each at a
  group of 2 ranks, 2 synthetic steps each: the ranks' U-Nets bit-equal,
  rank 0 alone writing
  files beside rank 1's `logs/metrics.p1.jsonl`, and rank 0's
  `antipatch.pkl` loaded into JAX's U-Net giving the port's output within
  2e-4 of max(1, max|pre-tanh logits|).

Spawned ranks import this module, so it imports no JAX at its top.
"""
import copy
import functools
import os

import numpy as np
import pytest
import torch

from mladversarialobjectdetection_torch import parallel
from mladversarialobjectdetection_torch.attack.train import get_victim
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.defense import masker as pmasker
from mladversarialobjectdetection_torch.defense import train as defense_train
from mladversarialobjectdetection_torch.defense.defender import PatchAttackDefender
from mladversarialobjectdetection_torch.models import efficientnet
from mladversarialobjectdetection_torch.models import unet as punet
from mladversarialobjectdetection_torch.models import unet_packed as ppk
from mladversarialobjectdetection_torch.models.init import init_weights
from mladversarialobjectdetection_torch.parallel import launch, spatial
from test_torch_parallel import TINY, _state_arrays, rel, scale_err, tiny_cfg

B, HW, K, LR, NF = 4, 64, 4, 1e-2, 4  # global batch, side, box slots, Adam lr, filters
LOW_THRESH = 0.0099
MESHES = {"s12": (1, 2), "s22": (2, 2), "s14": (1, 4)}
# the spawned groups: mesh and jobs. Two groups of 2 ranks at (1, 2) share
# its jobs, and the (2, 2) ranks then compute the one-process references
# (`one_process`, a share each), so that the four groups end about
# together while JAX compiles in the test's process
GROUPS = {"s12": ("s12", ("unet", "unet_packed", "step", "masker", "f32", "driver0")),
          "s12b": ("s12", ("remat", "bf16", "bf16_remat", "driver2")),
          "s22": ("s22", ("unet", "step", "masker", "refs")),
          "s14": ("s14", ("unet", "step", "masker", "eval"))}
SPAWN_TIMEOUT_S = 240.0
F64_TOL = 1e-10     # (a): float64 sums in another order only
STEP64_TOL = 1e-8   # (b)
TOL = 2e-4          # float32, the ROADMAP rule
MASKER_TOL = 1e-6   # (e): float32 colour-match sums in another order
# (d): the bf16 step's whole gradient at (1, 2) against one process's; this
# file read 0.99999399, chip_smoke.py phase 25e 0.99997441 at lite4@640 b8
# on an H100 80GB HBM3 at 700 W
BF16_WHOLE_GRAD_COS = 0.999
DRIVER = dict(synthetic=True, image_size=HW, batch_size=2, epochs=1, steps_per_epoch=2,
              config_override={**TINY, "max_boxes_per_image": K,
                               "nms_configs": {"score_thresh": LOW_THRESH}},
              spatial=2, device="cpu")


def make_inputs():
    """The global batch, a seeded cotangent and box slots (seeded numpy)."""
    rng = np.random.default_rng(22)
    boxes = np.zeros((B, K, 4), np.float32)
    valid = np.zeros((B, K), bool)
    for i in range(B):
        for k in range(1 + i % 3):
            y0, x0 = rng.uniform(2, 24, 2)
            h, w = rng.uniform(20, 38, 2)
            boxes[i, k] = (y0, x0, y0 + h, x0 + w)
            valid[i, k] = True
    return dict(images=rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
                cot=rng.normal(size=(B, HW, HW, 3)), boxes=boxes, valid=valid)


# ---------------------------------------------------------------------------
# the computations, run alike by one process (no mesh) and by each rank
# ---------------------------------------------------------------------------

def victim_cfg(bf16=False):
    cfg = tiny_cfg()
    cfg.nms_configs["score_thresh"] = LOW_THRESH
    cfg.mixed_precision = bf16
    return cfg


@functools.lru_cache(maxsize=None)
def flat_victim(bf16, logit):
    """The seed-0 victim with its class and box predictors' kernels zeroed:
    every anchor a person at sigmoid(logit), every box its anchor, on
    every rows' split alike (no score ties broken by rounding). Frozen, so
    the defenders of a process share it."""
    cfg = victim_cfg(bf16)
    net = get_victim(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for head in (net.class_net, net.box_net):
            head.predict.pw.weight.zero_()
        net.box_net.predict.pw.bias.zero_()
        bias = net.class_net.predict.pw.bias
        bias.fill_(-10.0)
        bias[0::cfg.num_classes] = logit
    return net


def defender(bf16=False, logit=0.0, grad_accum=1, packed=False):
    cfg = victim_cfg(bf16)
    patch = np.random.default_rng(0).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    return PatchAttackDefender(cfg, flat_victim(bf16, logit), eval_patch=patch,
                               eval_scale=0.4, n_filters=NF, grad_accum=grad_accum,
                               packed=packed, device="cpu")


def stubbed(dfd, dtype):
    """The victim and the masker replaced by a pointwise function of the
    images (row-local, so every split computes the same values)."""
    def boxes(images, score_thresh=None):
        b = images.shape[0]
        return (torch.zeros((b, K, 4)), torch.zeros((b, K)),
                torch.zeros((b, K), dtype=torch.bool))
    dfd.odet_boxes = boxes
    dfd._mask = lambda state, images, *_: (images.to(dtype),
                                           (0.5 * torch.sin(3.0 * images)).to(dtype))
    return dfd


def no_dropout(unet):
    for m in unet.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0


def first_moment(state):
    """Adam's first moment after one step (0.1 g) in the Flax layout."""
    moments = copy.deepcopy(state.unet)
    with torch.no_grad():
        for q, p in zip(moments.parameters(), state.unet.parameters()):
            q.copy_(state.optimizer.state[p]["exp_avg"])
    return bridge.torch_to_flax(moments)["params"]


def unet_pass(images, cot, packed, spy=False):
    """A float64 train-mode pass of a U-Net drawn from seed 0 and the input
    gradient of sum(update * cot); with `spy`, the rows each cmconv call and
    each BatchNorm saw."""
    unet = (ppk.PackedPatchNeutralizer(NF, packed_levels=packed) if packed
            else punet.PatchNeutralizer(NF))
    init_weights(unet, torch.Generator().manual_seed(0))
    unet.double()
    x = torch.as_tensor(images, dtype=torch.float64).requires_grad_(True)
    cm, bn, hooks = [], [], []
    originals = (punet.cmconv, ppk.cmconv)

    def op(xe, *a):
        cm.append(xe.shape[2])
        return originals[0](xe, *a)

    if spy:
        punet.cmconv = ppk.cmconv = op
        hook = lambda m, args, kw: bn.append((args[2] if len(args) > 2 else None,
                                              args[0].shape[-2]))
        hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
                 for m in unet.modules() if isinstance(m, efficientnet.BatchNorm)]
    try:
        y = unet(x, training=True, generator=torch.Generator().manual_seed(1))
        (y * torch.as_tensor(cot)).sum().backward()
    finally:
        punet.cmconv, ppk.cmconv = originals
        for h in hooks:
            h.remove()
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(), "cm": cm, "bn": bn}


def step(images, *, dtype=torch.float64, grad_accum=1, remat=False):
    """One stubbed defender step (dropout on) from the seed-0 state."""
    dfd = stubbed(defender(bf16=dtype == torch.bfloat16, grad_accum=grad_accum),
                  torch.float32 if dtype == torch.bfloat16 else dtype)
    st = dfd.init_state(0)
    if dtype == torch.float64:
        st.unet.double()
    st.unet.remat = remat
    st, m = dfd.train_step(st, images)
    return {"loss": float(m.loss), "unet": _state_arrays(st.unet),
            "mu": first_moment(st)}


def step_f32(images, constants=None):
    """The float32 step at dropout 0 from the seed-0 state on the flat
    victim (c): the real masker, or with `constants` ((boxes, scores,
    valid), (patched, targets) of the whole batch) the one-process float64
    step on them."""
    dfd = defender()
    st = dfd.init_state(0)
    no_dropout(st.unet)
    if constants is not None:
        det, mask = constants
        dfd.odet_boxes = lambda images, score_thresh=None: det
        dfd._mask = lambda *_: tuple(torch.from_numpy(a).double() for a in mask)
        st.unet.double()
    st, m = dfd.train_step(st, images)
    return {"loss": float(m.loss), "unet": _state_arrays(st.unet),
            "flax": bridge.torch_to_flax(st.unet), "mu": first_moment(st)}


def masker(images, boxes, valid):
    out = pmasker.apply_masker(images, torch.as_tensor(boxes), torch.as_tensor(valid),
                               training=True, return_region=True, device="cpu",
                               generator=torch.Generator().manual_seed(3), height=HW)
    return [o.numpy() for o in out]


def evaluate(images):
    """eval_step and recover on the confident flat victim (scores .95)."""
    dfd = defender(logit=3.0)
    st = dfd.init_state(0)
    m = dfd.eval_step(st, images, 1)
    return {"metrics": {k: float(v) for k, v in m._asdict().items()},
            "recover": dfd.recover(st, images).numpy()}


def driver(tmp, rank, packed):
    """The driver on this rank, the score violin stubbed out (a plot
    failure is logged and training goes on; tests/test_torch_defense.py
    holds the plot)."""
    from mladversarialobjectdetection_torch.utils import visualize

    def no_plot(*_):
        raise RuntimeError("not plotted here")

    visualize.plot_score_violin = no_plot
    st = defense_train.train("efficientdet-lite0", packed=packed,
                             save_dir=os.path.join(tmp, f"driver{rank}"), **DRIVER)
    return _state_arrays(st.unet)


def _rank_worker(rank, tmp, n_data, n_sp, jobs):
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    if n_data == 1:
        mesh = parallel.make_train_mesh(B, n_sp, image_h=HW, device="cpu")
    else:
        mesh = parallel.make_serve_mesh(n_data, n_sp, device="cpu")
    mine = lambda x: parallel.shard_batch(mesh, x)  # batch, then rows
    images = mine(inp["images"])
    pair, cot = mine(inp["images"][:2]), mine(inp["cot"][:2])
    bf16 = torch.bfloat16
    run = {"unet": lambda: {0: unet_pass(pair, cot, 0, spy=rank == 0)},
           "unet_packed": lambda: {p: unet_pass(pair, cot, p, spy=rank == 0)
                                   for p in (1, 2, 3)},
           "step": lambda: {k: step(images, grad_accum=k) for k in (1, 2)},
           "masker": lambda: masker(images, mine(inp["boxes"]), mine(inp["valid"])),
           "eval": lambda: evaluate(images),
           "f32": lambda: step_f32(images),
           "remat": lambda: step(images, remat=True),
           "bf16": lambda: step(images, dtype=bf16),
           "bf16_remat": lambda: step(images, dtype=bf16, remat=True)}
    out = {"unet": {}}
    with parallel.use_mesh(mesh):
        for job in jobs:
            if job.startswith("unet"):
                out["unet"].update(run[job]())
            elif job in run:
                out[job] = run[job]()
    for job in jobs:  # the driver builds its own mesh; the references none
        if job.startswith("driver"):
            out["driver"] = driver(tmp, rank, int(job[len("driver"):]))
        elif job == "refs":
            out["ref"] = one_process(inp, inp["const"], share=rank)
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))


def run_ranks(tmp, n_data, n_sp, jobs):
    tmp = str(tmp)
    launch.spawn(_rank_worker, n_data * n_sp, (tmp, n_data, n_sp, jobs),
                 init_method=f"file://{tmp}/store", threads=1,
                 timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"r{r}.pt"), weights_only=False)
            for r in range(n_data * n_sp)]


def constants(inp):
    """The boxes and the masker output of the port's one-process float32
    step (c) on the whole batch."""
    images = torch.from_numpy(inp["images"])
    dfd = defender()
    det = dfd.odet_boxes(images)
    mask = dfd._mask(dfd.init_state(0), images, det[0], det[2], None)
    return [t.clone() for t in det], [t.numpy() for t in mask]


def one_process(inp, const, share):
    """Share `share` (0-3) of the references: every computation on the
    whole batch, no mesh."""
    images = torch.from_numpy(inp["images"])
    # (2, 2) at grad_accum 2: microbatch i is each data shard's image i
    order = [0, 2, 1, 3]
    shares = (
        {"unet": lambda: {p: unet_pass(inp["images"][:2], inp["cot"][:2], p, spy=True)
                          for p in range(4)}},
        {"step": lambda: {k: step(images, grad_accum=k) for k in (1, 2)},
         "step_s22_accum": lambda: step(images[order], grad_accum=2)},
        {"remat": lambda: step(images, remat=True),
         "bf16": lambda: step(images, dtype=torch.bfloat16),
         "masker": lambda: masker(images, inp["boxes"], inp["valid"])},
        {"eval": lambda: evaluate(images), "f64": lambda: step_f32(images, const)})
    return {name: fn() for name, fn in shares[share].items()}


# ---------------------------------------------------------------------------
# the JAX references (one device)
# ---------------------------------------------------------------------------

def jax_step(constants):
    """JAX's one-device float32 step (dropout 0) from the port's seed-0
    U-Net, its victim pass and masker replaced by the port's one-process
    boxes and masker output."""
    import jax
    import jax.numpy as jnp
    from mladversarialobjectdetection_tpu import config as jconfig
    from mladversarialobjectdetection_tpu.defense import defender as jdefender
    from mladversarialobjectdetection_tpu.defense import masker as jmasker
    from mladversarialobjectdetection_tpu.models import unet as junet
    det, (patched, targets) = constants
    jcfg = jconfig.Config(victim_cfg().as_dict())
    victim = bridge.torch_to_flax(get_victim(victim_cfg(), seed=0, device="cpu"))
    jdef = jdefender.PatchAttackDefender(
        jcfg, jax.tree_util.tree_map(jnp.asarray, victim), n_filters=NF)
    jdef.unet = junet.PatchNeutralizer(n_filters=NF, dropout=0.0)
    jdef.odet_boxes = lambda images, **_: tuple(jnp.asarray(t.numpy()) for t in det)
    v = jax.tree_util.tree_map(jnp.asarray, bridge.torch_to_flax(defender().init_state(0).unet))
    state = jdefender.DefenderState(v["params"], v["batch_stats"], jdef.tx.init(v["params"]),
                                    jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0))
    orig = jmasker.apply_masker
    jmasker.apply_masker = lambda *a, **kw: (jnp.asarray(patched), jnp.asarray(targets))
    try:
        jst, jm = jax.jit(jdef.train_step)(state, jnp.zeros((B, HW, HW, 3)))
    finally:
        jmasker.apply_masker = orig
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"loss": float(jm.loss), "params0": host(state.params),
            "params": host(jst.params), "batch_stats": host(jst.batch_stats),
            "mu": host(jst.opt_state.inner_state[0].mu)}


def jax_unet_outputs(variables, x):
    """JAX's U-Net (n_filters 8, the driver's) applied to x in eval mode on
    each variable tree."""
    import jax
    import jax.numpy as jnp
    from mladversarialobjectdetection_tpu.models import unet as junet
    apply = jax.jit(lambda v, a: junet.PatchNeutralizer(n_filters=8).apply(v, a, False))
    return [np.asarray(apply(v, jnp.asarray(x))) for v in variables]


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
    """The four spawns side by side (the (2, 2) ranks compute the
    one-process references too), JAX's step in this process meanwhile."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = {k: tmp_path_factory.mktemp(k) for k in GROUPS}
    inp = make_inputs()
    inp["const"] = constants(inp)
    for k in GROUPS:
        torch.save(inp, tmp[k] / "inputs.pt")
    with ThreadPoolExecutor(len(GROUPS)) as pool:
        spawned = {k: pool.submit(run_ranks, tmp[k], *MESHES[mesh], jobs)
                   for k, (mesh, jobs) in GROUPS.items()}
        jax_ref = jax_step(inp["const"])  # JAX compiles meanwhile
        out = {k: f.result() for k, f in spawned.items()}
    ref = {k: v for r in out["s22"] for k, v in r["ref"].items()}
    return dict(inp=inp, ref=ref, jax=jax_ref, tmp=tmp, **out)


def _rows_of(x, rank, n_data, n_sp):
    """The global batch's rows that `rank` of an (n_data, n_sp) mesh holds."""
    d, s = divmod(rank, n_sp)
    b, h = x.shape[0] // n_data, x.shape[1] // n_sp
    return x[d * b:(d + 1) * b, s * h:(s + 1) * h]


def _err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(1.0, float(np.abs(ref).max())))


def _leaf_errs(out, ref):
    from test_torch_train import _leaf_dists
    return max(d for _, d in _leaf_dists(out, ref))


# ---------------------------------------------------------------------------
# (a) the U-Nets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh, packed", [("s12", p) for p in range(4)]
                         + [("s22", 0), ("s14", 0)])
def test_unet_forward_and_input_gradient_match_one_process(runs, mesh, packed):
    ref = runs["ref"]["unet"][packed]
    n_data, n_sp = MESHES[mesh]
    for rank, r in enumerate(runs[mesh]):
        got = r["unet"][packed]
        assert _err(got["y"], _rows_of(ref["y"], rank, n_data, n_sp)) <= F64_TOL
        assert _err(got["grad"], _rows_of(ref["grad"], rank, n_data, n_sp)) <= F64_TOL


@pytest.mark.parametrize("mesh, packed", [("s12", p) for p in range(4)] + [("s14", 0)])
def test_shards_see_their_rows_and_one_halo_row(runs, mesh, packed):
    ref, got = runs["ref"]["unet"][packed], runs[mesh][0]["unet"][packed]
    n = MESHES[mesh][1]
    # every cmconv call on a halo-extended shard, none on a whole level
    assert ref["cm"] and got["cm"] == [h // n + 2 for h in ref["cm"]]
    assert len(got["bn"]) == len(ref["bn"])
    replicated = 0
    for (height, rows), (_, whole) in zip(got["bn"], ref["bn"]):
        assert height == whole  # each BatchNorm knows its level's global height
        if spatial.is_sharded(height, n):
            assert rows == height // n, (height, rows)
        else:
            assert rows == height, (height, rows)
            replicated += 1
    # at spatial 4 the bottleneck's 4 rows are replicated (1 row a rank)
    assert replicated == (0 if n == 2 else 2)


# ---------------------------------------------------------------------------
# (b) the float64 step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh, grad_accum", [(m, k) for m in sorted(MESHES) for k in (1, 2)]
                         + [("s12_remat", 1)])
def test_train_step_float64_matches_one_process(runs, mesh, grad_accum):
    if mesh == "s12_remat":
        ref, ranks = runs["ref"]["remat"], [r["remat"] for r in runs["s12b"]]
    else:
        ref = (runs["ref"]["step_s22_accum"] if (mesh, grad_accum) == ("s22", 2)
               else runs["ref"]["step"][grad_accum])
        ranks = [r["step"][grad_accum] for r in runs[mesh]]
    assert rel(ranks[0]["loss"], ref["loss"]) <= STEP64_TOL
    assert scale_err(ranks[0]["unet"], ref["unet"]) <= STEP64_TOL
    for r in ranks[1:]:  # every rank takes the same step
        assert r["loss"] == ranks[0]["loss"]
        assert all(np.array_equal(r["unet"][k], ranks[0]["unet"][k]) for k in ref["unet"])


# ---------------------------------------------------------------------------
# (c) the float32 step against JAX; (d) bf16 and remat
# ---------------------------------------------------------------------------

def test_train_step_float32_matches_jax_one_device_step(runs):
    """Within twice JAX's own float32 error (against the port's float64
    one-process step), or 2e-4 of max(1, max|ref|), leaf by leaf."""
    jax_ref, ref64 = runs["jax"], runs["ref"]["f64"]
    ranks = [r["f32"] for r in runs["s12"]]
    got = ranks[0]
    own_loss = rel(jax_ref["loss"], ref64["loss"])
    assert rel(got["loss"], jax_ref["loss"]) <= max(TOL, 2 * own_loss)
    for key, mine, j, r64 in (
            ("mu", got["mu"], jax_ref["mu"], ref64["mu"]),
            ("params", got["flax"]["params"], jax_ref["params"], ref64["flax"]["params"]),
            ("batch_stats", got["flax"]["batch_stats"], jax_ref["batch_stats"],
             ref64["flax"]["batch_stats"])):
        own = _leaf_errs(j, r64)
        assert _leaf_errs(mine, j) <= max(TOL, 2 * own), (key, own)
    # Adam's first step moves each parameter by at most lr
    assert _leaf_errs(got["flax"]["params"], jax_ref["params"]) <= 2 * LR
    assert got["loss"] == ranks[1]["loss"]
    assert all(np.array_equal(ranks[1]["unet"][k], v) for k, v in got["unet"].items())


def test_bf16_step_and_remat_match_one_process(runs):
    import jax
    from test_torch_defense_variants import (BF16_GRAD_LEAF_COS, BF16_LOSS_TOL,
                                             BF16_RES, BF16_STATS_TOL, BF16_SURE_SHARE,
                                             BN_FED, cosine)
    ref = runs["ref"]["bf16"]
    r0, r1 = (r["bf16"] for r in runs["s12b"])
    assert rel(r0["loss"], ref["loss"]) <= BF16_LOSS_TOL and r0["loss"] == r1["loss"]
    refs = jax.tree_util.tree_leaves_with_path(ref["mu"])
    mine = dict(jax.tree_util.tree_leaves_with_path(r0["mu"]))
    flat = lambda leaves: np.concatenate([np.ravel(a) for a in leaves])
    whole = cosine(flat([mine[p] for p, _ in refs]), flat([a for _, a in refs]))
    assert whole >= BF16_WHOLE_GRAD_COS, whole
    largest = max(float(np.abs(a).max()) for _, a in refs)
    for path, a in refs:
        if not (path[-1].key == "bias" and path[-2].key in BN_FED
                or float(np.abs(a).max()) < BF16_RES * largest):
            assert cosine(mine[path], a) >= BF16_GRAD_LEAF_COS, jax.tree_util.keystr(path)
    stats = [k for k in ref["unet"] if "running" in k]
    assert stats and all(_err(r0["unet"][k], ref["unet"][k]) <= BF16_STATS_TOL for k in stats)
    # the parameters Adam moves by at least .999 lr in one process
    before = _state_arrays(stubbed(defender(bf16=True), torch.float32).init_state(0).unet)
    n_sure = n_agree = 0
    for k, v in ref["unet"].items():
        if k not in stats:
            sure = np.abs(v - before[k]) >= 0.999 * LR
            n_sure += int(sure.sum())
            n_agree += int((np.abs(r0["unet"][k] - v)[sure] <= 1e-5).sum())
    assert n_agree >= BF16_SURE_SHARE * n_sure, (n_agree, n_sure)
    for r in runs["s12b"]:  # the recompute replays the same masks and exchanges
        assert r["bf16_remat"]["loss"] == r["bf16"]["loss"]
        for k, v in r["bf16"]["unet"].items():
            assert np.array_equal(r["bf16_remat"]["unet"][k], v), k


# ---------------------------------------------------------------------------
# (e) the masker, eval_step and recover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_masker_rows_match_one_process(runs, mesh):
    patched, targets, region = runs["ref"]["masker"]
    assert region.any()
    n_data, n_sp = MESHES[mesh]
    for rank, r in enumerate(runs[mesh]):
        rows = lambda x: _rows_of(x, rank, n_data, n_sp)
        assert np.array_equal(r["masker"][2], rows(region))
        assert float(np.abs(r["masker"][0] - rows(patched)).max()) <= MASKER_TOL
        assert float(np.abs(r["masker"][1] - rows(targets)).max()) <= MASKER_TOL


def test_eval_step_and_recover_match_one_process(runs):
    ref = runs["ref"]["eval"]
    assert all(np.isfinite(ref["metrics"][k]) for k in ("loss", "recovery_psnr", "adr"))
    n_data, n_sp = MESHES["s14"]
    for rank, r in enumerate(runs["s14"]):
        for k, v in ref["metrics"].items():
            assert abs(r["eval"]["metrics"][k] - v) <= TOL * max(1.0, abs(v)), k
        # recover returns this rank's rows
        assert _err(r["eval"]["recover"],
                    _rows_of(ref["recover"], rank, n_data, n_sp)) <= TOL


# ---------------------------------------------------------------------------
# (f) the driver
# ---------------------------------------------------------------------------

def test_defense_driver_with_spatial_2(runs):
    from mladversarialobjectdetection_tpu.ckpt import io as jio
    files = lambda d: sorted(os.path.relpath(os.path.join(p, f), d)
                             for p, _, fs in os.walk(d) for f in fs)
    restored, ports = [], []
    for group in ("s12", "s12b"):  # plain, packed=2
        tmp = runs["tmp"][group]
        r0, r1 = (r["driver"] for r in runs[group])
        for k, v in r0.items():  # the ranks end bit-equal
            assert np.array_equal(v, r1[k]), (group, k)
        assert files(tmp / "driver1") == ["logs/metrics.p1.jsonl"]
        main = files(tmp / "driver0")
        assert "logs/metrics.jsonl" in main and "state-latest.msgpack" in main
        art = [f for f in main if f.startswith("patch_00_") and f.endswith("antipatch.pkl")]
        assert len(art) == 1
        restored.append(jio.load_pytree(str(tmp / "driver0" / art[0][:-4])))
        unet = punet.PatchNeutralizer(8)  # the packed U-Net's parameters are these
        unet.load_state_dict({k: torch.from_numpy(v) for k, v in r0.items()})
        ports.append(unet)
    x = np.random.default_rng(2).uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
    for unet, ref in zip(ports, jax_unet_outputs(restored, x)):
        logits = []
        hook = unet.output.register_forward_hook(lambda m, a, out: logits.append(out))
        with torch.no_grad():
            out = unet(torch.from_numpy(x)).numpy()
        hook.remove()
        # tanh is 1-Lipschitz: the rule's share of the pre-tanh logits
        scale = max(1.0, float(logits[0].abs().max()))
        assert float(np.abs(out - ref).max()) <= TOL * scale
