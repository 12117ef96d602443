"""Defender training driver (PyTorch entry point).

Port of `mladversarialobjectdetection_tpu/defense/train.py` (reference
defender_train.py:20-74): victim efficientdet-lite4 with NMS iou .5 / score
.5, eval patch from an attack artifact directory (or a random one), Adam
1e-2, 200 epochs, batch 24, ReduceLROnPlateau(.5, patience 50, min 1e-4) on
the validation loss, a metric log every 50 steps with the adversarial
scores, validation with recovery PSNR and ADR, a score violin every 10
epochs, and the best-validation weights in
`patch_{epoch:02d}_{val_loss:.4f}/antipatch.pkl`: the Flax-layout
`{'params', 'batch_stats'}` dict of numpy arrays in the JAX package's pickle
format (`ckpt/io.py`), which its `ckpt/io.load_pytree` reads.

`train` keeps the JAX driver's signature and defaults, and adds `device`
(CUDA unless "cpu" is asked for) and `victim_variables` (Flax variables of
the victim). The victim's weights come from `victim_ckpt` (a pytree file,
`attack.train.get_victim_variables`), from `victim_variables`, or else are
drawn from a seed. `initial_weights` starts the U-Net from an
`antipatch.pkl` or a reference `antipatch.h5`
(`ckpt/convert_defense.load_antipatch`: its weights only, the reference's
semantics); `resume` continues from
`<save_dir>/state-latest.msgpack`, which every epoch writes: the U-Net's
parameters and BatchNorm statistics, Adam's moments and LR, the step, the
train steps' and the augmentation's generators, the loop counters and the
plateau controller, with both input streams fast-forwarded (JAX
train.py:89-140), so a killed and resumed run repeats the uninterrupted
one. The data are synthetic (`synthetic`, or no `img_dir`), or an image
folder (`img_dir`, `label_dir`: `data/pipeline.partition` filtered by the
labels, as the JAX driver's; reading needs PIL). `bf16` sets
`config.mixed_precision` before the victim is built (bf16 victim and
U-Net, float32 parameters and loss), as the JAX driver does; `packed`
picks the space-to-depth U-Net (`models/unet_packed.py`, the same
parameters and `antipatch.pkl`), `--packed` with no value packing 3
levels as the JAX driver's. `victim_ckpt` may be a pytree file, an orbax
directory or a reference TF1 checkpoint (the release tarball too);
`initial_weights` an `antipatch` pytree path or a reference `antipatch.h5`;
beside each `antipatch.pkl` the driver writes the reference-format
`antipatch.h5` mirror where h5py is installed, and otherwise logs JAX's
warning and goes on (JAX train.py:205-216), as on the card's machine.

Across processes (`torchrun --nproc_per_node N -m
mladversarialobjectdetection_torch.defense.train ...`; `main` calls
`parallel.initialize`), the driver runs JAX's data-parallel program (JAX
train.py:53-142, 201-220) on `make_train_mesh`, as the attack driver does:
`batch_size / N` images a data shard, synthetic streams seeded `seed + 1000
* shard`, the folder split seeded `seed + shard` and sharded by shard, the
U-Net and the victim from rank 0, the steps reduced over the ranks
(`defense/defender.py`), and only the main process writing files (beside
each other rank's `logs/metrics.p{rank}.jsonl`). `spatial > 1` (JAX
train.py:53-58) lays the ranks out as a ('data', 'spatial') mesh whose
'spatial' axis row-shards each image (`parallel/spatial.py`): the ranks of
one spatial group load the same examples (their data shard's stream) and
keep their rows; the U-Net, the masker and the victim run on those rows. In
one process it raises the mesh's `ValueError` before any work.

An untrained victim at score threshold .5 finds nobody, so the masker
plants nothing: pass `config_override={"nms_configs": {"score_thresh":
0.0099}}` to train on its detections.

Usage:
    python -m mladversarialobjectdetection_torch.defense.train --synthetic \\
        --epochs 1 --steps-per-epoch 3
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import config as config_lib
from .. import parallel
from ..attack import artifacts
from ..attack.train import get_victim, victim_source
from ..ckpt import bridge
from ..ckpt import io as ckpt_io
from ..ckpt.convert_defense import load_antipatch, save_antipatch_h5
from ..data import pipeline
from ..utils.device import resolve_device
from ..utils.image import parse_image_size
from ..utils.log import get_logger
from ..utils import train_loop as train_loop_lib
from ..utils.train_loop import MetricLogger, ReduceLROnPlateau, Throughput
from .defender import DefenderState, PatchAttackDefender

logger = get_logger(__name__)


def defender_state_arrays(state: DefenderState):
    """A `DefenderState` as the nested dicts of arrays `save_loop_state`
    writes: the U-Net's parameters and BatchNorm statistics, the step,
    Adam's state and the generator's state."""
    return {"unet": {k: v.detach().cpu().numpy()
                     for k, v in state.unet.state_dict().items()},
            "step": np.asarray(state.step, np.int64),
            "generator": train_loop_lib.generator_state(state.generator),
            "opt": train_loop_lib.adam_state(state.optimizer)}


def load_defender_state(state: DefenderState, arrays) -> DefenderState:
    """Restore `defender_state_arrays` into `state` (in place)."""
    state.unet.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in arrays["unet"].items()})
    train_loop_lib.load_adam_state(state.optimizer, arrays["opt"])
    train_loop_lib.load_generator_state(state.generator, arrays["generator"])
    state.step = int(arrays["step"])
    return state


def _nanmean(xs):
    xs = [x for x in xs if not np.isnan(x)]
    return float(np.mean(xs)) if xs else float("nan")


def train(model_name: str = "efficientdet-lite4", *,
          img_dir: str | None = None, label_dir: str | None = None,
          victim_ckpt: str | None = None, eval_patch: str | None = None,
          save_dir: str = "save_dir_def", batch_size: int = 24,
          epochs: int = 200, lr: float = 1e-2,
          steps_per_epoch: int | None = None,
          initial_weights: str | None = None, synthetic: bool = False,
          image_size=None, seed: int = 43, config_override=None,
          bf16: bool = False, grad_accum: int = 1, spatial: int = 1,
          resume: bool = False, packed: int = 0, victim_variables=None,
          device=None):
    """Train the defender U-Net; returns the final `DefenderState`."""
    # weights only (the reference's initial_weights, attack_detection.py:54-55)
    unet_vars = load_antipatch(initial_weights) if initial_weights else None
    device = resolve_device(device)

    config = config_lib.get_efficientdet_config(model_name)
    config.nms_configs.update({"iou_thresh": 0.5, "score_thresh": 0.5})
    if image_size is not None:
        config.image_size = image_size
    if bf16:  # the victim and the U-Net compute in bf16; parameters float32
        config.mixed_precision = True
    if config_override:
        config.update(config_override)
    image_h = parse_image_size(config.image_size)[0]
    mesh = parallel.make_train_mesh(batch_size, spatial, image_h, device=device)

    if eval_patch:
        patch_np, scale = artifacts.load_patch_dir(
            eval_patch, config.mean_rgb, config.stddev_rgb)
    else:
        logger.warning("no eval_patch given; using a random patch for eval")
        patch_np = np.random.default_rng(0).uniform(
            -1, 1, size=(640, 640, 3)).astype(np.float32)
        scale = 0.4

    victim_variables = victim_source(config, victim_ckpt, victim_variables)
    victim = get_victim(config, variables=victim_variables, device=device)
    defender = PatchAttackDefender(config, victim, eval_patch=patch_np,
                                   eval_scale=scale, learning_rate=lr,
                                   grad_accum=grad_accum, packed=packed,
                                   device=device)
    state = defender.init_state(seed, variables=unet_vars)

    plateau = ReduceLROnPlateau(factor=0.5, patience=50, min_lr=1e-4)
    best_val = float("inf")
    aug_gen = torch.Generator(device=device).manual_seed(seed + 2)
    start_epoch = step = 0
    latest = os.path.join(save_dir, "state-latest.msgpack")
    if resume and os.path.exists(latest):
        # full-state resume (JAX train.py:89-96); initial_weights restores
        # the weights only
        arrays, start_epoch, step, best_val = train_loop_lib.load_loop_state(
            latest, defender_state_arrays(state), aug_gen, plateau)
        load_defender_state(state, arrays)
        logger.info(f"resumed full state from {latest} "
                    f"(epoch {start_epoch}, step {step})")
    parallel.replicate(mesh, [state.unet, defender.net])
    # resume fast-forward (JAX train.py:114-140): both streams advanced to
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
            pipeline.skip_batches(val_src, start_epoch * val_steps)
    else:
        parts = pipeline.partition(config, img_dir, label_dir,
                                   batch_size=batch_size, filter_data=True,
                                   seed=seed + shard)
        if n_shards > 1:
            parts["train"]["source"].shard(shard, n_shards)
            parts["val"]["source"].shard(shard, n_shards)
        spe = steps_per_epoch or parts["train"]["length"]
        val_steps = parts["val"]["length"]
        train_src = parts["train"]["source"].repeat_batches(
            local_bs, skip_batches=start_epoch * spe)
        val_src = parts["val"]["source"].repeat_batches(
            local_bs, skip_batches=start_epoch * val_steps)
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
                # real adversarial scores on logged steps only (an extra
                # detector pass), as the reference logs them
                logged = (step + 1) % 50 == 0
                state, metrics = defender.train_step(state, batch,
                                                     with_adv_scores=logged)
                thr.count(batch_size)
                step += 1
                if logged:
                    mlog.log(step, metrics._asdict(), prefix="train/")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ips = thr.rate()

            vals = [defender.eval_step(state, next(val_iter), vi)
                    for vi in range(val_steps)]
            val_loss = float(np.mean([float(v.loss) for v in vals]))
            # NaN-mean skips val batches where the victim found nobody to patch
            val_psnr = _nanmean([float(v.recovery_psnr) for v in vals])
            val_adr = _nanmean([float(v.adr) for v in vals])
            mlog.log(step, {"loss": val_loss, "recovery_psnr": val_psnr,
                            "adr": val_adr, "images_per_sec": ips,
                            "epoch": epoch}, prefix="val/")
            logger.info(f"epoch {epoch}: val_loss={val_loss:.4f} "
                        f"psnr={val_psnr:.1f}dB adr={val_adr:.2f} "
                        f"{ips:.1f} img/s")

            if epoch % 10 == 0 and parallel.is_main_process():
                clean = [float(v.mean_clean_score) for v in vals]
                adv = [float(v.mean_adv_score) for v in vals]
                try:
                    from ..utils import visualize
                    from PIL import Image
                    Image.fromarray(visualize.plot_score_violin(clean, adv)).save(
                        os.path.join(save_dir, "logs", f"scores_{epoch:03d}.png"))
                except Exception as e:  # a plot must never stop training
                    logger.warning(f"violin plot failed: {e}")

            improved = val_loss < best_val
            if improved:
                best_val = val_loss
            if improved and parallel.is_main_process():
                art_dir = os.path.join(save_dir, f"patch_{epoch:02d}_{val_loss:.4f}")
                weights = bridge.torch_to_flax(state.unet)
                ckpt_io.save_pytree(os.path.join(art_dir, "antipatch"), weights)
                try:
                    # the reference-consumable mirror (attack_detection.py:311-318)
                    save_antipatch_h5(weights, os.path.join(art_dir, "antipatch.h5"))
                except Exception as e:  # h5py absent
                    logger.warning(f"antipatch.h5 mirror not written: {e}")
            plateau.update(val_loss, state.optimizer)
            if parallel.is_main_process():
                # the full-state kill-and-resume checkpoint (see resume)
                train_loop_lib.save_loop_state(
                    latest, defender_state_arrays(state), epoch=epoch + 1,
                    step=step, best=best_val, plateau=plateau, aug_gen=aug_gen)
    mlog.close()
    return state


def main():
    p = argparse.ArgumentParser(description="patch-attack defender training")
    p.add_argument("--model", default="efficientdet-lite4")
    p.add_argument("--img-dir", default=None)
    p.add_argument("--label-dir", default=None)
    p.add_argument("--victim-ckpt", default=None)
    p.add_argument("--eval-patch", default=None,
                   help="attack artifact dir with patch.npy + scale.txt")
    p.add_argument("--save-dir", default="save_dir_def")
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--initial-weights", default=None,
                   help="start the U-Net from an antipatch pytree path or a "
                        "reference antipatch.h5 (weights only)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--hparams", default=None,
                   help="config override string 'a.b=1,c=2' or YAML path")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 activations for the victim and the U-Net "
                        "(float32 parameters and loss)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each step's batch into this many sequential "
                        "microbatches with one summed-gradient update")
    p.add_argument("--spatial", type=int, default=1,
                   help="shard each image's rows over this many ranks of a "
                        "('data', 'spatial') mesh: the U-Net, the masker and "
                        "the victim run on each rank's rows (must divide the "
                        "ranks and the image height)")
    p.add_argument("--packed", type=int, nargs="?", const=3, default=0,
                   help="space-to-depth packed U-Net layout "
                        "(models/unet_packed.py), the same model and "
                        "weights: N packs the first N resolution levels "
                        "(1-3); bare --packed = 3. A TPU layout: slower "
                        "than the unpacked U-Net on an H100 (PERF.md)")
    p.add_argument("--resume", action="store_true",
                   help="resume the full state (U-Net, Adam moments, "
                        "generators, plateau LR, data position) from "
                        "save_dir/state-latest.msgpack")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args()
    parallel.initialize(args.device)
    train(args.model, img_dir=args.img_dir, label_dir=args.label_dir,
          victim_ckpt=args.victim_ckpt, eval_patch=args.eval_patch,
          save_dir=args.save_dir, batch_size=args.batch_size,
          epochs=args.epochs, lr=args.lr,
          steps_per_epoch=args.steps_per_epoch,
          initial_weights=args.initial_weights, synthetic=args.synthetic,
          image_size=args.image_size, bf16=args.bf16,
          config_override=args.hparams, grad_accum=args.grad_accum,
          spatial=args.spatial, resume=args.resume, packed=args.packed,
          device=args.device)


if __name__ == "__main__":
    main()
