"""Self-supervised patch-attack defender training core (PyTorch).

Port of `mladversarialobjectdetection_tpu/defense/defender.py` (reference
attack_detection.py:30-318, `PatchAttackDefender`):

- a clean pass through the frozen victim detector finds person boxes;
- the masker plants patches on them and emits recovery targets;
- updates = 2 * unet(patched); loss = sum over images of the per-image mean
  of (targets - updates)^2;
- eval plants the learned adversarial patch, runs the victim on the patched
  and on the recovered images (score threshold 0), and reports the recovery
  PSNR over the patched region and the attack-detection rate.

The U-Net (`models/unet.PatchNeutralizer`, or with `packed` the
space-to-depth `models/unet_packed.PackedPatchNeutralizer` on the same
parameters) is the only trainable: its parameters take a torch Adam step
(optax's adam: b1 .9, b2 .999, eps 1e-8), and its BatchNorm statistics move
in place in train mode. Under `config.mixed_precision` the U-Net computes in
bf16 (its parameters, statistics, output and the loss stay float32), as the
victim does. On the card the
victim's NMS runs the CUDA NMS kernel, the masker's warp the CUDA warp
kernels, and the U-Net's small-channel 3x3 convs the CUDA cmconv kernel
(its bf16 instance under mixed precision).
Where the JAX package threads PRNG keys, the port draws from the state's
`torch.Generator`; the parity tests pass JAX's draws in (`masker_draws`).

Data parallelism (`parallel.use_mesh`, JAX's step on a batch-sharded
array): each rank steps on its rows of the global batch with the same
state. The masker crops a permutation of the whole batch (the crops
gathered, the draws the global batch's; `defense/masker.py`), the EOT and
dropout draws are the global batch's, sliced; the U-Net's train-mode
BatchNorm normalises by the global batch's statistics
(`efficientnet.batch_stats`); each rank's loss is its images' sum and the
gradients are summed over the ranks, so every rank takes the same Adam
step; the metrics and the eval sums are the global batch's.

Spatial partitioning (a ('data', 'spatial') mesh, `parallel/spatial.py`):
the images are this rank's rows. The victim gathers its outputs, so the
boxes, scores and NMS are the data shard's, alike on each rank of a spatial
group; the masker plants into this rank's rows (`defense/masker.py`); the
U-Net runs row-sharded (`models/unet.py`). Each rank's loss is its rows'
part of each image's mean (its sum over the image's global element count),
so the parts sum to the loss over data x spatial, and the U-Net's gradients
are summed over data x spatial. The eval's PSNR sums each image's squared
error and pixel count over the spatial group before the image's mean;
`recover` returns this rank's rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
from ..attack.attacker import NEG_INF, filter_valid_boxes
from ..ckpt import bridge
from ..models.efficientdet import DetSpec, spec_from_config
from ..models.init import init_weights
from ..models.unet import PatchNeutralizer
from ..models.unet_packed import PackedPatchNeutralizer
from ..ops import nms as nms_ops
from ..ops import postprocess
from ..parallel import spatial
from ..utils.device import resolve_device
from . import masker as masker_lib


@dataclasses.dataclass
class DefenderState:
    """The U-Net and its optimizer; `train_step` updates it in place and
    returns it."""
    unet: PatchNeutralizer | PackedPatchNeutralizer  # parameters, BN statistics
    optimizer: torch.optim.Optimizer  # Adam over unet.parameters()
    step: int
    generator: torch.Generator        # masker and dropout draws of the train steps
    seed: int


class DefenderMetrics(NamedTuple):
    loss: torch.Tensor
    mean_clean_score: torch.Tensor
    mean_adv_score: torch.Tensor
    # eval only (NaN on train steps): PSNR (dB) of the recovered image
    # against the clean one over the patched region, and the
    # attack-detection rate (reference demo_v2.py:115-148)
    recovery_psnr: torch.Tensor
    adr: torch.Tensor


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of x where mask holds, over the global batch under an
    active mesh."""
    m = mask.to(x.dtype)
    num, den = parallel.reduce_sum(torch.stack([torch.sum(x * m),
                                                torch.sum(m)])).unbind()
    return num / (den + 1e-7)


class PatchAttackDefender:
    """Defender train / eval steps against a frozen victim detector."""

    def __init__(self, config, victim: torch.nn.Module, *, eval_patch=None,
                 eval_scale: float = 0.4, learning_rate: float = 1e-2,
                 n_filters: int = 8, grad_accum: int = 1, packed=False,
                 packed_entry: int = 0, device=None):
        """
        Args:
          config: detector config (`config.get_efficientdet_config`).
          victim: the detector, an `EfficientDetNet` of `config`
            (`attack.train.get_victim`); frozen and moved to `device`.
          eval_patch, eval_scale, learning_rate, n_filters, grad_accum: as
            in the JAX package.
          packed: the space-to-depth U-Net (`models/unet_packed.py`), the
            same parameters; True packs level 1 (the full-resolution
            stages), an int 1..3 that many levels. A TPU layout, kept for
            parity: slower than the unpacked U-Net on an H100 (PERF.md).
          `config.mixed_precision`: the U-Net in bf16; the victim must
            compute in the same dtype (it does when built from `config`).
          packed_entry: > 0 runs the frozen victim's stem and first
            `packed_entry` backbone blocks in the space-to-depth layout
            (`models/efficientnet_packed.py`) on the same weights, through a
            packed view of `victim` (JAX defender.py:63-68).
          device: "cuda" (the default) or "cpu".
        """
        self.unet_dtype = (torch.bfloat16 if config.get("mixed_precision")
                           else torch.float32)
        victim_dtype = getattr(victim, "compute_dtype", torch.float32)
        if victim_dtype != self.unet_dtype:
            raise ValueError(
                f"the victim computes in {victim_dtype}, but the config asks "
                f"for {self.unet_dtype} (mixed_precision "
                f"{bool(config.get('mixed_precision'))}): build the victim "
                "from the same config")
        self.packed_levels = 0 if not packed else (
            1 if packed is True else int(packed))
        if not 0 <= self.packed_levels <= 3:
            raise ValueError(f"packed must be True or 1..3, got {packed}")
        self.device = resolve_device(device)
        self.config = config
        self.spec: DetSpec = spec_from_config(config)
        self.net = victim.to(self.device).eval()
        if packed_entry:
            self.net = self.net.with_packed_entry(packed_entry)
        for p in self.net.parameters():
            p.requires_grad_(False)
        self.n_filters = n_filters
        self.learning_rate = learning_rate
        self.max_boxes = int(config.get("max_boxes_per_image", 16) or 16)
        self.image_hw = self.spec.image_size
        nms_cfg = config.nms_configs
        self.nms_kwargs = postprocess.nms_kwargs_from_config(nms_cfg)
        self.pre_nms_topk = int(nms_cfg.get("pre_nms_topk") or 1024)
        self.score_thresh = float(nms_cfg.get("score_thresh") or 0.0)
        self._params_dict = config.as_dict()
        self.eval_patch = (None if eval_patch is None else torch.tensor(
            np.asarray(eval_patch, np.float32), device=self.device))
        self.eval_scale = eval_scale
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    # -- state -------------------------------------------------------------
    def init_state(self, seed: int = 0, variables=None) -> DefenderState:
        """A U-Net drawn from `seed` (Flax's initializer families, not its
        draws) or loaded from Flax `variables` through `ckpt/bridge.py`;
        Adam at the learning rate; the train steps' generator seeded with
        `seed`."""
        unet = self.make_unet()
        if variables is None:
            init_weights(unet, torch.Generator().manual_seed(seed))
        else:
            bridge.load_flax_variables(unet, variables)
        unet.to(self.device)
        opt = torch.optim.Adam(unet.parameters(), lr=self.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return DefenderState(unet, opt, 0, gen, int(seed))

    def make_unet(self) -> PatchNeutralizer | PackedPatchNeutralizer:
        """The defender's U-Net, undrawn: packed or not, in its dtype."""
        if self.packed_levels:
            return PackedPatchNeutralizer(self.n_filters,
                                          packed_levels=self.packed_levels,
                                          dtype=self.unet_dtype)
        return PatchNeutralizer(self.n_filters, dtype=self.unet_dtype)

    # -- detector pass (attack_detection.py:94-127) -------------------------
    @torch.no_grad()
    def odet_boxes(self, images: torch.Tensor, score_thresh=None):
        """Person boxes after NMS: (boxes [B, M, 4], scores [B, M], valid)."""
        cls_out, box_out = self.net(images)
        boxes, scores, classes = postprocess.pre_nms(self._params_dict,
                                                     cls_out, box_out)
        masked = torch.where(classes == 0, scores, NEG_INF)
        k = min(self.pre_nms_topk, masked.shape[1])
        top_scores, top_idx = postprocess.top_k_stable(masked, k)
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        kw = dict(self.nms_kwargs)
        if score_thresh is not None:
            kw["score_thresh"] = score_thresh
        res = nms_ops.batched_nms_auto(top_boxes.contiguous(),
                                       top_scores.contiguous(), **kw)
        nms_boxes = postprocess.clip_boxes(res.boxes, self.image_hw)
        # post-NMS validity filter (attack_detection.py:123-127)
        cond = filter_valid_boxes(
            res.scores, nms_boxes, torch.zeros_like(res.scores, dtype=torch.int32),
            self.image_hw,
            self.score_thresh if score_thresh is None else score_thresh)
        return nms_boxes, res.scores, res.valid & cond

    # -- loss ----------------------------------------------------------------
    def _loss(self, unet: torch.nn.Module, patched, targets, training: bool,
              generator=None):
        """sum over images of mean((targets - 2 * unet(patched))^2); returns
        (loss, updates). Under a spatial mesh, this rank's rows' part of it:
        each image's sum over its rows here, over the image's global count."""
        height = self.image_hw[0]
        updates = unet(patched, training=training, generator=generator,
                       height=height)
        b = patched.shape[0]
        diff = targets.reshape(b, -1) - (2.0 * updates).reshape(b, -1)
        if spatial.sharded(height):
            per_image = torch.sum(diff ** 2, dim=1) / (
                diff.shape[1] * spatial.active().size)
        else:
            per_image = torch.mean(diff ** 2, dim=1)
        return torch.sum(per_image), updates

    def _mask(self, state, images, boxes, valid, draws):
        return masker_lib.apply_masker(
            images, boxes[:, :self.max_boxes], valid[:, :self.max_boxes],
            training=True, generator=state.generator, draws=draws,
            device=self.device, height=self.image_hw[0])

    @staticmethod
    def _update(state: DefenderState) -> None:
        """The gradients summed over the ranks, then one Adam step; a
        parameter without a gradient sees a zero one, as in optax."""
        parallel.all_reduce_grads(state.unet.parameters())
        with torch.no_grad():
            for p in state.unet.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state.optimizer.step()

    def _nan(self) -> torch.Tensor:
        return torch.full((), float("nan"), device=self.device)

    # -- steps -----------------------------------------------------------------
    def train_step(self, state: DefenderState, images: torch.Tensor,
                   with_adv_scores: bool = False,
                   masker_draws: masker_lib.MaskerDraws
                   | Sequence[masker_lib.MaskerDraws] | None = None
                   ) -> Tuple[DefenderState, DefenderMetrics]:
        """One train step (defender.py:159-204); updates `state` in place.

        with_adv_scores also runs the victim over the patched images at
        score threshold 0 for the logged mean adversarial score (a full
        extra detector pass). masker_draws feeds in the masker's draws (with
        grad_accum > 1, one `MaskerDraws` per microbatch)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        if self.grad_accum > 1:
            return self._train_step_accum(state, images, with_adv_scores,
                                          masker_draws)
        boxes, clean_scores, clean_valid = self.odet_boxes(images)
        patched, targets = self._mask(state, images, boxes, clean_valid,
                                      masker_draws)
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = self._loss(state.unet, patched, targets, True, state.generator)
        loss.backward()
        self._update(state)
        if with_adv_scores:
            _, adv_scores, adv_valid = self.odet_boxes(patched, score_thresh=0.0)
            mean_adv = _masked_mean(adv_scores, adv_valid)
        else:
            mean_adv = torch.zeros((), device=self.device)
        state.step += 1
        loss = parallel.reduce_sum(spatial.reduce_sum(loss.detach()))
        return state, DefenderMetrics(loss, _masked_mean(clean_scores, clean_valid),
                                      mean_adv, self._nan(), self._nan())

    def _train_step_accum(self, state: DefenderState, images, with_adv_scores,
                          masker_draws) -> Tuple[DefenderState, DefenderMetrics]:
        """Gradient accumulation (defender.py:206-272): `grad_accum`
        sequential microbatches, each with its own detector pass, masker and
        dropout draws, the BatchNorm statistics moving through them in turn;
        gradients summed (the loss is a sum over images), one Adam update.
        Score means accumulate as numerator / denominator pairs. The batch
        splits, not the rows: under a spatial mesh each microbatch is this
        rank's rows of its images."""
        k = self.grad_accum
        b = images.shape[0]
        if b % k != 0:
            raise ValueError(f"batch {b} not divisible by grad_accum={k}")
        mb = b // k
        state.optimizer.zero_grad(set_to_none=True)
        zero = lambda: torch.zeros((), dtype=torch.float32, device=self.device)
        lsum, num_c, den_c, num_a, den_a = (zero() for _ in range(5))
        for i in range(k):
            imgs = images[i * mb:(i + 1) * mb]
            boxes, clean_scores, clean_valid = self.odet_boxes(imgs)
            patched, targets = self._mask(
                state, imgs, boxes, clean_valid,
                None if masker_draws is None else masker_draws[i])
            loss, _ = self._loss(state.unet, patched, targets, True,
                                 state.generator)
            loss.backward()
            lsum = lsum + loss.detach()
            cm = clean_valid.to(clean_scores.dtype)
            num_c = num_c + torch.sum(clean_scores * cm)
            den_c = den_c + torch.sum(cm)
            if with_adv_scores:
                _, adv_scores, adv_valid = self.odet_boxes(patched,
                                                           score_thresh=0.0)
                am = adv_valid.to(adv_scores.dtype)
                num_a = num_a + torch.sum(adv_scores * am)
                den_a = den_a + torch.sum(am)
        self._update(state)
        state.step += 1
        lsum = spatial.reduce_sum(lsum)
        lsum, num_c, den_c, num_a, den_a = parallel.reduce_sum(
            torch.stack([lsum, num_c, den_c, num_a, den_a])).unbind()
        mean_adv = num_a / (den_a + 1e-7) if with_adv_scores else zero()
        return state, DefenderMetrics(lsum, num_c / (den_c + 1e-7), mean_adv,
                                      self._nan(), self._nan())

    def _eval_generator(self, state: DefenderState, batch_idx: int):
        """Masker draws of an eval batch: seeded from the state's seed, its
        step and the batch index, so evaluation never advances the train
        steps' generator and the val batches of an epoch are decorrelated."""
        seed = (state.seed * 1_000_003 + state.step * 7_919 + int(batch_idx))
        return torch.Generator(device=self.device).manual_seed(seed % 2 ** 63)

    @torch.no_grad()
    def eval_step(self, state: DefenderState, images: torch.Tensor,
                  batch_idx: int = 0,
                  masker_draws: masker_lib.MaskerDraws | None = None
                  ) -> DefenderMetrics:
        """One validation batch (defender.py:274-349): plant the learned
        adversarial patch, measure the recovery loss, PSNR and ADR."""
        if self.eval_patch is None:
            raise ValueError("eval_step needs the defender's eval_patch")
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        boxes, clean_scores, valid = self.odet_boxes(images)
        patched, targets, region = masker_lib.apply_masker(
            images, boxes[:, :self.max_boxes], valid[:, :self.max_boxes],
            training=False, adv_patch=self.eval_patch,
            adv_scale=self.eval_scale, return_region=True,
            generator=self._eval_generator(state, batch_idx),
            draws=masker_draws, device=self.device, height=self.image_hw[0])
        # second detector pass at score_thresh 0 (attack_detection.py:186-187)
        _, adv_scores, adv_valid = self.odet_boxes(patched, score_thresh=0.0)
        loss, updates = self._loss(state.unet, patched, targets, False)

        # recover() = clip(patched + 2 * updates) (demo_v2.py:151-169)
        recovered = torch.clamp(patched + 2.0 * updates, -1.0, 1.0)
        _, rec_scores, rec_valid = self.odet_boxes(recovered, score_thresh=0.0)

        # PSNR over the patched region; images span [-1, 1] (range 2)
        reg = region.to(torch.float32)[..., None]
        se = torch.sum(((recovered - images) ** 2) * reg, dim=(1, 2, 3))
        n_px = torch.sum(reg, dim=(1, 2, 3)) * 3.0
        # each image's sums over its rows on the spatial group's ranks, and
        # the loss's parts (one reduction under a spatial mesh)
        b = se.shape[0]
        sums = spatial.reduce_sum(torch.cat([se, n_px, loss[None]]))
        se, n_px, loss = sums[:b], sums[b:2 * b], sums[2 * b]
        has_region = n_px > 0
        mse = se / torch.clamp_min(n_px, 1.0)
        psnr_i = 10.0 * torch.log10(4.0 / torch.clamp_min(mse, 1e-12))

        # attack-detection rate, the demo's rule (demo_v2.py:28, 48-55,
        # 136-141): per image the max score above .55 (0 if none); detected
        # when the clean image was confidently detected and the defender
        # lifts the score by more than 10 points
        def max_above(scores, ok, thresh=0.55):
            return torch.amax(torch.where(ok & (scores >= thresh), scores, 0.0),
                              dim=1)

        clean_i = max_above(clean_scores, valid)
        adv_i = max_above(adv_scores, adv_valid)
        rec_i = max_above(rec_scores, rec_valid)
        eligible = (clean_i > 0.55) & has_region
        detected = (rec_i - adv_i) > 0.10
        # the global batch's sums (one reduction under an active mesh)
        loss, psnr_sum, n_reg, det_sum, n_elig = parallel.reduce_sum(
            torch.stack([loss, torch.sum(torch.where(has_region, psnr_i, 0.0)),
                         torch.sum(has_region).to(torch.float32),
                         torch.sum(torch.where(eligible,
                                               detected.to(torch.float32), 0.0)),
                         torch.sum(eligible).to(torch.float32)])).unbind()
        recovery_psnr = torch.where(
            n_reg > 0, psnr_sum / torch.clamp_min(n_reg, 1.0), self._nan())
        adr = torch.where(
            n_elig > 0, det_sum / torch.clamp_min(n_elig, 1.0), self._nan())
        return DefenderMetrics(loss, _masked_mean(clean_scores, valid),
                               _masked_mean(adv_scores, adv_valid),
                               recovery_psnr, adr)

    @torch.no_grad()
    def recover(self, state: DefenderState, images: torch.Tensor) -> torch.Tensor:
        """Neutralize patches: clip(image + 2 * unet(image)) (demo_v2.py:151-169).
        Under a spatial mesh, images and the result are this rank's rows
        (`spatial.gather_rows` makes them whole)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        updates = state.unet(images, training=False, height=self.image_hw[0])
        return torch.clamp(images + 2.0 * updates, -1.0, 1.0)
