"""Attack training driver (PyTorch entry point).

Port of `mladversarialobjectdetection_tpu/attack/train.py` (reference
attacker_train.py:20-76): victim efficientdet-lite4, attack-time NMS iou .5 /
score .5 with 256 candidates, Adam lr 1e-2, batch 12, per-epoch artifacts
in `patch_{epoch}_{val_asr_to_scale:.4f}` directories,
ReduceLROnPlateau(.5, min 1e-4, patience 50) on the validation loss.

`train` keeps the JAX driver's signature and defaults, and adds `device`
(CUDA unless "cpu" is asked for) and `victim_variables` (Flax variables of
the victim, loaded through `ckpt/bridge.py`). The victim's weights come
from `victim_ckpt` (a pytree file, `get_victim_variables`), from
`victim_variables`, or else are drawn from a seed by `models/init.py`.
`mixed_precision` defaults to True, as in the JAX driver: the victim runs
bf16 activations with float32 parameters and predictions, and the patch,
the EOT composite and the loss stay float32 (`--fp32` opts out). `resume`
continues from `<save_dir>/state-latest.msgpack`, which every epoch writes:
the patch, the scale, Adam's moments and LR, the step, the train steps' and
the augmentation's generators, the loop counters and the plateau
controller, with both input streams fast-forwarded (JAX
train.py:128-195), so a killed and resumed run repeats the uninterrupted
one. The data are synthetic (`synthetic`, or no `img_dir`), or an image
folder (`img_dir`; `data/pipeline.partition`, unfiltered, and the folder
streams of `ImageFolderSource`, which need PIL). `victim_ckpt` may also be
an orbax directory or a reference TF1 checkpoint (the release tarball
too); `packed_entry` runs the victim's entry blocks in the space-to-depth
layout (`--packed-entry`).

Across processes (`torchrun --nproc_per_node N -m
mladversarialobjectdetection_torch.attack.train ...`; `main` calls
`parallel.initialize`), the driver runs JAX's data-parallel program (JAX
train.py:95-195, 264-270) on `make_train_mesh`: each rank loads
`batch_size / N` images (`local_batch_size`), synthetic streams seeded
`seed + 1000 * rank`, an image folder split with `seed + rank` and then
`ImageFolderSource.shard(rank, N)`; the state and the victim come from rank
0 (`replicate`); the steps reduce over the ranks (`attack/attacker.py`); only
the main process writes `state-latest.msgpack`, the patch directories and
the plots, and every rank reads `resume`'s file. `spatial > 1` (JAX
train.py:95-100) lays the ranks out as a ('data', 'spatial') mesh whose
'spatial' axis row-shards each image (`parallel/spatial.py`): the ranks of
one spatial group load the same examples (their data shard's, its stream
seeded `seed + 1000 * data index`) and each keeps its rows; with
`packed_entry` the victim's packed entry runs on packed row shards.

Usage:
    python -m mladversarialobjectdetection_torch.attack.train --synthetic \\
        --epochs 1 --steps-per-epoch 3
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import config as config_lib
from .. import parallel
from ..ckpt import bridge, convert_tf
from ..ckpt import io as ckpt_io
from ..data import pipeline
from ..models.efficientdet import EfficientDetNet, spec_from_config
from ..models.init import init_weights
from ..utils.device import resolve_device
from ..utils.image import parse_image_size
from ..utils.log import get_logger
from ..utils import train_loop as train_loop_lib
from ..utils.train_loop import MetricLogger, ReduceLROnPlateau, Throughput
from . import artifacts
from .attacker import AttackState, PatchAttacker

logger = get_logger(__name__)


def get_victim(config, *, seed: int = 0, variables=None,
               device=None) -> EfficientDetNet:
    """The frozen victim detector of `config` on `device`.

    Weights: the JAX package's Flax `{'params', 'batch_stats'}` variables
    through `ckpt/bridge.py` when given, else drawn from `seed`."""
    net = EfficientDetNet(spec_from_config(config)).eval()
    if variables is not None:
        bridge.load_flax_variables(net, variables)
    else:
        init_weights(net, torch.Generator().manual_seed(seed))
    for p in net.parameters():
        p.requires_grad_(False)
    return net.to(resolve_device(device))


def get_victim_variables(config, ckpt_path=None, *, seed: int = 0):
    """The victim detector's Flax `{'params', 'batch_stats'}` variables
    (JAX attack/train.py:40-67): restored from the pytree file or orbax
    directory at `ckpt_path`, converted from a reference TF1 checkpoint
    there (a prefix, a directory or the release tarball; EMA shadows
    preferred, `ckpt/convert_tf.py`, no TensorFlow), or drawn from `seed` as
    `get_victim` draws them."""
    if ckpt_path:
        tf_prefix = convert_tf.find_tf_checkpoint(ckpt_path)
        if tf_prefix:
            template = bridge.torch_to_flax(get_victim(config, seed=seed, device="cpu"))
            variables = convert_tf.convert_tf_weights(
                convert_tf.load_tf_checkpoint(tf_prefix), config,
                spec_from_config(config), template)
            logger.info(f"converted TF victim checkpoint {tf_prefix}")
            return variables
        restored = ckpt_io.load_pytree(ckpt_path)
        logger.info(f"restored victim detector from {ckpt_path}")
        return {"params": restored["params"],
                "batch_stats": restored.get("batch_stats", {})}
    return bridge.torch_to_flax(get_victim(config, seed=seed, device="cpu"))


def victim_source(config, victim_ckpt, victim_variables):
    """The variables a driver's victim is built from (None: drawn from a
    seed); `victim_ckpt` and `victim_variables` exclude each other."""
    if victim_ckpt is None:
        return victim_variables
    if victim_variables is not None:
        raise ValueError("pass victim_ckpt or victim_variables, not both")
    return get_victim_variables(config, victim_ckpt)


def attack_state_arrays(state: AttackState):
    """An `AttackState` as the nested dicts of arrays `save_loop_state`
    writes: patch, scale, step, Adam's state, the generator's state."""
    return {"patch": state.patch.detach().cpu().numpy(),
            "scale": state.scale.detach().cpu().numpy(),
            "step": np.asarray(state.step, np.int64),
            "generator": train_loop_lib.generator_state(state.generator),
            "opt": train_loop_lib.adam_state(state.optimizer)}


def load_attack_state(state: AttackState, arrays) -> AttackState:
    """Restore `attack_state_arrays` into `state` (in place)."""
    with torch.no_grad():
        for t, name in ((state.patch, "patch"), (state.scale, "scale")):
            t.copy_(torch.from_numpy(np.array(arrays[name], np.float32)))
    train_loop_lib.load_adam_state(state.optimizer, arrays["opt"])
    train_loop_lib.load_generator_state(state.generator, arrays["generator"])
    state.step = int(arrays["step"])
    return state


def train(model_name: str = "efficientdet-lite4", *,
          img_dir: str | None = None, label_dir: str | None = None,
          victim_ckpt: str | None = None, save_dir: str = "save_dir",
          batch_size: int = 12, epochs: int = 500, lr: float = 1e-2,
          steps_per_epoch: int | None = None, initial_patch: str | None = None,
          synthetic: bool = False, image_size=None, seed: int = 42,
          visualize_freq: int = 200, config_override=None,
          patch_size: int = 640, mixed_precision: bool = True,
          pre_nms_topk: int = 256, window: int | None = 320,
          grad_accum: int = 1, spatial: int = 1, resume: bool = False,
          packed_entry: int = 0, victim_variables=None, device=None):
    """Train an adversarial patch; returns the final `AttackState`."""
    device = resolve_device(device)

    config = config_lib.get_efficientdet_config(model_name)
    # attack-time NMS override (attacker_train.py:31); with score_thresh .5
    # there are never 256 above-threshold person anchors in an image, so the
    # smaller static candidate set is lossless
    config.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5,
                               "pre_nms_topk": pre_nms_topk})
    # bf16 activations by default (the patch and the predictions stay float32)
    config.mixed_precision = mixed_precision
    if image_size is not None:
        config.image_size = image_size
    if config_override:
        config.update(config_override)

    image_h = parse_image_size(config.image_size)[0]
    mesh = parallel.make_train_mesh(batch_size, spatial, image_h, device=device)
    logger.info(f"mesh over {mesh.size} rank(s); global batch {batch_size}")
    victim_variables = victim_source(config, victim_ckpt, victim_variables)
    victim = get_victim(config, variables=victim_variables, device=device)
    attacker = PatchAttacker(config, victim, learning_rate=lr,
                             patch_size=patch_size, window=window or None,
                             grad_accum=grad_accum, packed_entry=packed_entry,
                             device=device)
    if initial_patch:
        patch_np, scale0 = artifacts.load_patch_dir(
            initial_patch, config.mean_rgb, config.stddev_rgb)
        state = attacker.init_state(seed, initial_patch=patch_np,
                                    initial_scale=scale0)
    else:
        state = attacker.init_state(seed)

    plateau = ReduceLROnPlateau(factor=0.5, patience=50, min_lr=1e-4)
    best_val_loss = float("inf")
    aug_gen = torch.Generator(device=device).manual_seed(seed + 2)
    start_epoch = step = 0
    latest = os.path.join(save_dir, "state-latest.msgpack")
    if resume and os.path.exists(latest):
        # full-state resume (JAX train.py:128-136): the trajectory of the
        # uninterrupted run, where --initial-patch restores patch and scale
        # only (the reference's semantics, attacker.py:328-341)
        arrays, start_epoch, step, best_val_loss = \
            train_loop_lib.load_loop_state(latest, attack_state_arrays(state),
                                           aug_gen, plateau)
        load_attack_state(state, arrays)
        logger.info(f"resumed full state from {latest} "
                    f"(epoch {start_epoch}, step {step})")
    parallel.replicate(mesh, [state.patch, state.scale, attacker.net])

    def _viz_events(n_epochs: int, spe_: int) -> int:
        """Visualisation epochs among the first n, each of which takes one
        more val batch (JAX train.py:161-165)."""
        if not visualize_freq or n_epochs <= 0:
            return 0
        period = max(1, visualize_freq // spe_)
        return (n_epochs + period - 1) // period

    # resume fast-forward (JAX train.py:167-195): both streams advanced to
    # where the uninterrupted run would be. Each data shard loads its share
    # of the global batch from a stream of its own
    local_bs, shard = parallel.data_shard(mesh, batch_size)
    n_shards = batch_size // local_bs
    if synthetic or img_dir is None:
        logger.info("using synthetic data")
        pseed = seed + 1000 * shard
        train_src = pipeline.synthetic_batches(local_bs, config.image_size,
                                               seed=pseed)
        val_src = pipeline.synthetic_batches(local_bs, config.image_size,
                                             seed=pseed + 1)
        spe = steps_per_epoch or 50
        val_steps = 5
        if start_epoch:
            pipeline.skip_batches(train_src, start_epoch * spe)
            pipeline.skip_batches(val_src, start_epoch * val_steps
                                  + _viz_events(start_epoch, spe))
    else:
        parts = pipeline.partition(config, img_dir, label_dir,
                                   batch_size=batch_size, filter_data=False,
                                   seed=seed + shard)
        if n_shards > 1:
            parts["train"]["source"].shard(shard, n_shards)
            parts["val"]["source"].shard(shard, n_shards)
        spe = steps_per_epoch or parts["train"]["length"]
        val_steps = parts["val"]["length"]
        train_src = parts["train"]["source"].repeat_batches(
            local_bs, skip_batches=start_epoch * spe)
        val_src = parts["val"]["source"].repeat_batches(
            local_bs, skip_batches=start_epoch * val_steps
            + _viz_events(start_epoch, spe))
    put = lambda b: parallel.shard_batch_auto(mesh, b)
    train_iter = pipeline.prefetch(train_src, device_put_fn=put)
    val_iter = pipeline.prefetch(val_src, device_put_fn=put)

    os.makedirs(save_dir, exist_ok=True)
    mlog = MetricLogger(os.path.join(save_dir, "logs"))
    thr = Throughput()
    with parallel.use_mesh(mesh):  # the steps reduce over its ranks
        for epoch in range(start_epoch, epochs):
            thr.start()
            for _ in range(spe):
                batch = pipeline.augment_batch(next(train_iter), aug_gen,
                                               height=image_h)
                # the ASR pass (a second NMS) runs only on logged steps
                logged = (step + 1) % 50 == 0
                state, metrics = attacker.train_step(state, batch, with_asr=logged)
                thr.count(batch_size)
                step += 1
                if logged:
                    mlog.log(step, metrics._asdict(), prefix="train/")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ips = thr.rate()

            val_metrics = [attacker.eval_step(state, next(val_iter), vi)
                           for vi in range(val_steps)]
            val = {k: float(np.mean([float(getattr(m, k)) for m in val_metrics]))
                   for k in val_metrics[0]._fields}
            mlog.log(step, val, prefix="val/")
            mlog.log(step, {"images_per_sec": ips, "epoch": epoch})
            logger.info(
                f"epoch {epoch}: val_loss={val['loss']:.4f} "
                f"asr={val['asr']:.3f} scale={val['scale']:.3f} "
                f"asr_to_scale={val['asr_to_scale']:.4f} {ips:.1f} img/s")
            if val.get("eot_clamp_frac", 0.0) > 0.01:
                logger.warning(
                    f"epoch {epoch}: {val['eot_clamp_frac']:.1%} of patch slots "
                    f"hit the EOT window clamp (window={window}); raise --window")

            # ASR-vs-threshold curve every visualize_freq steps; the `try`
            # guards only the plot, never the device path
            if visualize_freq and epoch % max(1, visualize_freq // spe) == 0:
                thresholds = np.arange(
                    float(config.nms_configs.score_thresh or 0.5), 0.805, 0.01,
                    dtype=np.float32)
                curve = attacker.asr_curve(state, next(val_iter), thresholds)
                curve = curve.cpu().numpy()
                try:
                    if parallel.is_main_process():
                        from ..utils import visualize
                        from PIL import Image
                        img = visualize.plot_asr_curve(thresholds, curve)
                        Image.fromarray(img).save(
                            os.path.join(save_dir, "logs", f"asr_{epoch:03d}.png"))
                except Exception as e:  # a plot must never stop training
                    logger.warning(f"asr-curve plot failed: {e}")

            dirname = os.path.join(save_dir,
                                   f"patch_{epoch:02d}_{val['asr_to_scale']:.4f}")
            if val["loss"] < best_val_loss:
                best_val_loss = val["loss"]
                if parallel.is_main_process():  # one writer in a shared directory
                    artifacts.save_patch_dir(
                        dirname, state.patch.detach().cpu().numpy(),
                        float(state.scale.detach()), config.mean_rgb,
                        config.stddev_rgb)
            plateau.update(val["loss"], state.optimizer)
            if parallel.is_main_process():
                # the full-state kill-and-resume checkpoint (see resume)
                train_loop_lib.save_loop_state(
                    latest, attack_state_arrays(state), epoch=epoch + 1, step=step,
                    best=best_val_loss, plateau=plateau, aug_gen=aug_gen)
    mlog.close()
    return state


def main():
    p = argparse.ArgumentParser(description="adversarial patch attack training")
    p.add_argument("--model", default="efficientdet-lite4")
    p.add_argument("--img-dir", default=None)
    p.add_argument("--label-dir", default=None)
    p.add_argument("--victim-ckpt", default=None)
    p.add_argument("--save-dir", default="save_dir")
    p.add_argument("--batch-size", type=int, default=12)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--initial-patch", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--fp32", action="store_true",
                   help="disable bf16 mixed precision")
    p.add_argument("--pre-nms-topk", type=int, default=256,
                   help="static NMS candidate cap (256 is lossless at "
                        "score_thresh .5 and faster)")
    p.add_argument("--hparams", default=None,
                   help="config override string 'a.b=1,c=2' or YAML path")
    p.add_argument("--window", type=int, default=320,
                   help="static EOT composite window (0 -> model default)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each step's batch into this many sequential "
                        "microbatches with one summed-gradient update")
    p.add_argument("--spatial", type=int, default=1,
                   help="shard each image's rows over this many ranks (a "
                        "('data', 'spatial') mesh; not with --packed-entry)")
    p.add_argument("--packed-entry", type=int, default=0,
                   help="victim entry blocks in the space-to-depth packed layout "
                        "(models/efficientnet_packed.py), the same weights; a "
                        "TPU layout, measured slower on an H100 (PERF.md)")
    p.add_argument("--resume", action="store_true",
                   help="resume the full state (patch, Adam moments, "
                        "generators, plateau LR, data position) from "
                        "save_dir/state-latest.msgpack")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args()
    parallel.initialize(args.device)
    train(args.model, img_dir=args.img_dir, label_dir=args.label_dir,
          victim_ckpt=args.victim_ckpt, save_dir=args.save_dir,
          batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
          steps_per_epoch=args.steps_per_epoch,
          initial_patch=args.initial_patch, synthetic=args.synthetic,
          image_size=args.image_size, mixed_precision=not args.fp32,
          pre_nms_topk=args.pre_nms_topk, window=args.window,
          config_override=args.hparams, grad_accum=args.grad_accum,
          spatial=args.spatial, resume=args.resume,
          packed_entry=args.packed_entry, device=args.device)


if __name__ == "__main__":
    main()
