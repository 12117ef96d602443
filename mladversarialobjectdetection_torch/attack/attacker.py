"""Adversarial-patch attack training core (PyTorch).

Port of `mladversarialobjectdetection_tpu/attack/attacker.py`, with the
reference's semantics (attacker.py:24-341):
  - two passes: a clean detector pass finds person boxes without gradient,
    the patched pass runs under the gradient;
  - two trainable tensors: a PxPx3 patch clipped to [-1, 1] and a scale
    clipped to [0, 1] after each Adam update;
  - loss = sum(max_score^2 + (max_score - scale)^2) + 1e-5 * TV(patch);
  - box validity: inside the image, area > 100 px, and on the first pass
    score >= the NMS score threshold;
  - ASR from the NMS'd clean and patched detections.

The victim is a frozen `EfficientDetNet` (eval BatchNorm, no parameter
gradients). On the card, both NMS passes run the CUDA NMS kernel
(`ops/nms_cuda.py`) and the EOT warp runs the CUDA warp kernels
(`ops/warp_cuda.py`). Where the JAX package threads PRNG keys, the port
draws from the state's `torch.Generator`; the parity tests pass JAX's draws
in through `eot_draws`.

Data parallelism (`parallel.use_mesh`, JAX's step on a batch-sharded
array): each rank steps on its rows of the global batch with the same
state. The EOT draws are the global batch's, sliced (`ops/eot.py`); the
loss is a sum over images, so each rank's loss is its images' sum, and the
TV term of the replicated patch enters on the first rank only; the patch
and scale gradients are summed over the ranks (an average would divide the
data term by their number), so every rank takes the same Adam step; the
metrics are the global batch's (the score std as sqrt(max(E[x^2] - E[x]^2,
0)) in float32, the ASR from the summed counts).

Spatial partitioning (a ('data', 'spatial') mesh, `parallel/spatial.py`):
the images are this rank's rows; the victim gathers its outputs, so the
boxes, scores, NMS and loss are the data shard's, alike on each rank of a
spatial group. Each rank warps every window of its data shard and
composites into its own rows (`eot.apply_patches(height=)`), so its patch
gradient is a partial one: the loss enters the backward once in the group
(`spatial.count_once`) and the gradients are summed over data x spatial.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from .. import parallel
from ..models.efficientdet import DetSpec, spec_from_config
from ..parallel import spatial
from ..ops import eot
from ..ops import nms as nms_ops
from ..ops import postprocess
from ..utils.device import resolve_device

NEG_INF = nms_ops.NEG_INF
ASR_THRESH = 0.5  # calc_asr's default (attacker.py:238-263)


@dataclasses.dataclass
class AttackState:
    """The attack's trainables and their optimizer; `train_step` updates it
    in place and returns it."""
    patch: torch.Tensor               # [P, P, 3] in [-1, 1], a leaf
    scale: torch.Tensor               # [] in [0, 1], a leaf
    optimizer: torch.optim.Optimizer  # Adam over (scale, patch)
    step: int
    generator: torch.Generator        # EOT draws of the train steps
    seed: int


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    scale: torch.Tensor
    scale_loss: torch.Tensor
    tv_loss: torch.Tensor
    mean_max_score: torch.Tensor
    std_max_score: torch.Tensor
    asr: torch.Tensor
    asr_to_scale: torch.Tensor
    # fraction of live slots whose rotation region the static EOT window
    # clamps tighter than the reference's image-width clamp would
    eot_clamp_frac: torch.Tensor


def filter_valid_boxes(scores: torch.Tensor, boxes: torch.Tensor,
                       classes: torch.Tensor, image_hw: Tuple[int, int],
                       score_thresh: float | None) -> torch.Tensor:
    """Person + validity mask over anchors (attacker.py:70-89, 106-113)."""
    h, w = float(image_hw[0]), float(image_hw[1])
    bh = boxes[..., 2] - boxes[..., 0]
    bw = boxes[..., 3] - boxes[..., 1]
    cond = classes == 0  # person, before CLASS_OFFSET
    cond = cond & (bw / w <= 1.0) & (bh / h <= 1.0) & (bh * bw > 100.0)
    if score_thresh is not None:
        cond = cond & (scores >= score_thresh)
    return cond


class PatchAttacker:
    """Attack train / eval steps against a frozen victim detector."""

    def __init__(self, config, victim: torch.nn.Module, *,
                 patch_size: int = 640, learning_rate: float = 1e-2,
                 tolerance: float = 0.2, bn_axis_name: str | None = None,
                 use_histogram_match: bool = False, window: int | None = None,
                 eot_overrides: Dict[str, Any] | None = None,
                 grad_accum: int = 1, freeze_scale: bool = False,
                 packed_entry: int = 0, device=None):
        """
        Args:
          config: detector config (`config.get_efficientdet_config`).
          victim: the detector, an `EfficientDetNet` of `config`
            (`attack.train.get_victim`); frozen and moved to `device`.
          patch_size, learning_rate, tolerance, use_histogram_match, window,
            eot_overrides, grad_accum, freeze_scale: as in the JAX package.
          packed_entry: > 0 runs the victim's stem and first `packed_entry`
            backbone blocks in the space-to-depth layout
            (`models/efficientnet_packed.py`) on the same weights: the
            attacker's net is a packed view of `victim`, which is left as it
            is (JAX attacker.py:96-104).
          bn_axis_name: JAX's sync-BN axis; the victim is frozen (eval-mode
            BatchNorm), so it issues no collective. Not with packed_entry.
          device: "cuda" (the default) or "cpu".
        """
        if packed_entry and bn_axis_name is not None:
            raise ValueError("packed_entry does not support cross-replica BN")
        self.bn_axis_name = bn_axis_name
        self.device = resolve_device(device)
        self.config = config
        self.spec: DetSpec = spec_from_config(config)
        self.net = victim.to(self.device).eval()
        if packed_entry:
            self.net = self.net.with_packed_entry(packed_entry)
        for p in self.net.parameters():
            p.requires_grad_(False)
        self.patch_size = patch_size
        self.learning_rate = learning_rate
        self.image_hw = self.spec.image_size
        self.max_boxes = int(config.get("max_boxes_per_image", 16) or 16)
        nms_cfg = config.nms_configs
        self.nms_kwargs = postprocess.nms_kwargs_from_config(nms_cfg)
        self.pre_nms_topk = int(nms_cfg.get("pre_nms_topk") or 1024)
        self.score_thresh = float(nms_cfg.get("score_thresh") or 0.0)
        self.tolerance = tolerance
        self.use_histogram_match = use_histogram_match
        self.window = window
        self.eot_overrides = dict(eot_overrides or {})
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.freeze_scale = bool(freeze_scale)
        self._params_dict = config.as_dict()

    # -- state -------------------------------------------------------------
    def init_state(self, seed: int = 0, initial_patch=None,
                   initial_scale: float = 0.4) -> AttackState:
        """Patch ~ U(-1, 1) from `seed` (or `initial_patch`), Adam at the
        learning rate, and the train steps' generator seeded with `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if initial_patch is None:
            patch = torch.rand((self.patch_size, self.patch_size, 3),
                               generator=gen, device=self.device) * 2.0 - 1.0
        else:
            patch = torch.tensor(np.asarray(initial_patch, np.float32),
                                 device=self.device)
        patch.requires_grad_(True)
        scale = torch.tensor(float(initial_scale), dtype=torch.float32,
                             device=self.device, requires_grad=True)
        # optax.adam's defaults: b1 .9, b2 .999, eps 1e-8, bias-corrected
        opt = torch.optim.Adam([scale, patch], lr=self.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        return AttackState(patch, scale, opt, 0, gen, int(seed))

    # -- model passes --------------------------------------------------------
    def _forward(self, images: torch.Tensor):
        """Decoded boxes (no gradient), sigmoid scores and classes of every
        anchor; only the scores carry the gradient."""
        cls_out, box_out = self.net(images)
        return postprocess.pre_nms(self._params_dict, cls_out,
                                   [b.detach() for b in box_out])

    def _nms(self, boxes: torch.Tensor, masked_scores: torch.Tensor):
        """Top-k candidate select + padded NMS (attacker.py:143-170)."""
        k = min(self.pre_nms_topk, masked_scores.shape[1])
        top_scores, top_idx = postprocess.top_k_stable(masked_scores.detach(), k)
        top_boxes = torch.gather(boxes.detach(), 1,
                                 top_idx[..., None].expand(-1, -1, 4))
        res = nms_ops.batched_nms_auto(top_boxes.contiguous(),
                                       top_scores.contiguous(),
                                       **self.nms_kwargs)
        clipped = postprocess.clip_boxes(res.boxes, self.image_hw)
        return clipped, res.scores, res.valid

    @torch.no_grad()
    def first_pass(self, images: torch.Tensor):
        """Clean pass -> NMS'd person boxes, padded (attacker.py:91-116).

        No gradient and no stored activations, as in the JAX package."""
        boxes, scores, classes = self._forward(images)
        cond = filter_valid_boxes(scores, boxes, classes, self.image_hw,
                                  self.score_thresh)
        return self._nms(boxes, torch.where(cond, scores, NEG_INF))

    def second_pass_scores(self, images: torch.Tensor):
        """Patched pass -> (boxes, masked person anchor scores [B, A])."""
        boxes, scores, classes = self._forward(images)
        cond = filter_valid_boxes(scores, boxes, classes, self.image_hw,
                                  score_thresh=None)
        return boxes, torch.where(cond, scores, NEG_INF)

    # -- ASR (attacker.py:238-263) ------------------------------------------
    @staticmethod
    def calc_asr(clean_scores, clean_valid, adv_scores, adv_valid,
                 score_thresh: float = ASR_THRESH) -> torch.Tensor:
        n_clean = torch.sum((clean_scores >= score_thresh) & clean_valid)
        n_adv = torch.sum((adv_scores >= score_thresh) & adv_valid)
        return 1.0 - n_adv.to(torch.float32) / (n_clean.to(torch.float32)
                                                + 1e-7)

    def _clamp_frac(self, boxes, boxes_valid, scale):
        """(n_clamped, n_valid): live slots whose region the window clamps
        tighter than the reference's image-width clamp (attacker.py:472)."""
        img_w = float(self.image_hw[1])
        win = float(min(self.window or eot.default_window(self.image_hw), img_w))
        longer = torch.maximum(boxes[..., 2] - boxes[..., 0],
                               boxes[..., 3] - boxes[..., 1])
        size = torch.floor(longer * scale.detach())
        diag_ref = torch.clamp_max(eot.SQRT2 * size, img_w)
        clamped = (diag_ref > win) & boxes_valid
        return (clamped.sum().to(torch.float32),
                boxes_valid.sum().to(torch.float32))

    # -- loss ------------------------------------------------------------
    def _loss_from_images(self, patch, scale, images, boxes, boxes_valid,
                          generator, eot_draws=None, tv_weight: float = 1e-5):
        patched, _ = eot.apply_patches(
            images, boxes, boxes_valid, patch, scale, generator=generator,
            draws=eot_draws, device=self.device, tolerance=self.tolerance,
            window=self.window, use_histogram_match=self.use_histogram_match,
            height=self.image_hw[0], **self.eot_overrides)
        adv_boxes, adv_masked = self.second_pass_scores(patched)
        # amax shares the gradient evenly among tied maxima, as JAX's
        # reduce-max does (random-init scores tie near 0.01)
        max_scores = torch.clamp_min(torch.amax(adv_masked, dim=1), 0.0)
        scale_losses = (max_scores - scale) ** 2
        tv = eot.total_variation(patch)
        # the replicated patch's TV term counts once in the ranks' sum
        tv_weight = tv_weight if parallel.is_first_rank() else 0.0
        if self.freeze_scale:
            # frontier-probe objective: the scale gets no gradient, so Adam
            # leaves it exactly at its initial value
            loss = torch.sum(max_scores ** 2) + tv_weight * tv
        else:
            loss = torch.sum(max_scores ** 2 + scale_losses) + tv_weight * tv
        aux = dict(max_scores=max_scores.detach(),
                   scale_losses=scale_losses.detach(), tv=tv.detach(),
                   adv_boxes=adv_boxes, adv_masked=adv_masked.detach())
        return loss, aux

    def _boxes(self, boxes, clean_valid, boxes_override, rows=slice(None)):
        """The EOT placement targets: the first pass's, or the override's."""
        k = self.max_boxes
        if boxes_override is None:
            return boxes[:, :k], clean_valid[:, :k]
        ob, ov = boxes_override
        return (torch.as_tensor(ob)[rows, :k].to(self.device, torch.float32),
                torch.as_tensor(ov)[rows, :k].to(self.device, torch.bool))

    @staticmethod
    def _update(state: AttackState) -> None:
        """The gradients summed over the ranks, one Adam step on (scale,
        patch), then the variable constraints (attacker.py:51-54, 301-306)."""
        parallel.all_reduce_grads([state.scale, state.patch])
        with torch.no_grad():
            for p in (state.scale, state.patch):
                if p.grad is None:  # no live slot: optax sees a zero gradient
                    p.grad = torch.zeros_like(p)
            state.optimizer.step()
            state.patch.clamp_(-1.0, 1.0)
            state.scale.clamp_(0.0, 1.0)

    # -- steps -------------------------------------------------------------
    def train_step(self, state: AttackState, images: torch.Tensor,
                   with_asr: bool = True,
                   boxes_override: Tuple[torch.Tensor, torch.Tensor] | None = None,
                   eot_draws: eot.EOTDraws | None = None
                   ) -> Tuple[AttackState, StepMetrics]:
        """One attack step (attacker.py:252-314); updates `state` in place.

        with_asr=False skips the metrics-only NMS pass over the patched
        detections and reports asr/asr_to_scale as NaN. boxes_override
        ([B, K, 4] boxes, [B, K] valid) replaces the first pass's detections
        as the EOT placement targets (the clean pass still runs). eot_draws
        feeds in the EOT draws instead of drawing them from the state."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        if self.grad_accum > 1:
            return self._train_step_accum(state, images, with_asr,
                                          boxes_override, eot_draws)
        boxes, clean_scores, clean_valid = self.first_pass(images)
        boxes, boxes_valid = self._boxes(boxes, clean_valid, boxes_override)
        scale_before = state.scale.detach().clone()
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = self._loss_from_images(state.patch, state.scale, images,
                                           boxes, boxes_valid, state.generator,
                                           eot_draws)
        spatial.count_once(loss).backward()
        self._update(state)
        metrics = self._metrics(loss.detach(), state.scale.detach().clone(),
                                aux, clean_scores, clean_valid,
                                with_asr=with_asr,
                                clamp=self._clamp_frac(boxes, boxes_valid,
                                                       scale_before))
        state.step += 1
        return state, metrics

    def _train_step_accum(self, state: AttackState, images, with_asr: bool,
                          boxes_override, eot_draws
                          ) -> Tuple[AttackState, StepMetrics]:
        """Gradient accumulation (attacker.py:316-411): `grad_accum`
        sequential microbatches, each with its own first pass and EOT draws,
        gradients summed (the TV term weighted 1/k per microbatch so the sum
        is the full batch's), then one Adam update. Score statistics and ASR
        accumulate as sums so the metrics are the full batch's."""
        k = self.grad_accum
        b = images.shape[0]
        if b % k != 0:
            raise ValueError(f"batch {b} not divisible by grad_accum={k}")
        mb = b // k
        scale_before = state.scale.detach().clone()
        tv_before = eot.total_variation(state.patch.detach())
        state.optimizer.zero_grad(set_to_none=True)
        zero = lambda: torch.zeros((), dtype=torch.float32, device=self.device)
        lsum, sl_sum, s_sum, s_sq = zero(), zero(), zero(), zero()
        n_clean, n_adv, c_sum, v_sum = zero(), zero(), zero(), zero()
        for i in range(k):
            rows = slice(i * mb, (i + 1) * mb)
            imgs = images[rows]
            boxes, clean_scores, clean_valid = self.first_pass(imgs)
            bx, bv = self._boxes(boxes, clean_valid, boxes_override, rows)
            draws = None if eot_draws is None else eot.EOTDraws(
                *(None if f is None else f[rows] for f in eot_draws))
            loss, aux = self._loss_from_images(
                state.patch, state.scale, imgs, bx, bv, state.generator,
                draws, tv_weight=1e-5 / k)
            spatial.count_once(loss).backward()
            lsum = lsum + loss.detach()
            sl_sum = sl_sum + aux["scale_losses"].sum()
            s_sum = s_sum + aux["max_scores"].sum()
            s_sq = s_sq + (aux["max_scores"] ** 2).sum()
            nc, nv = self._clamp_frac(bx, bv, scale_before)
            c_sum, v_sum = c_sum + nc, v_sum + nv
            if with_asr:
                _, adv_s, adv_v = self._nms(aux["adv_boxes"], aux["adv_masked"])
                n_clean = n_clean + ((clean_scores >= ASR_THRESH)
                                     & clean_valid).sum()
                n_adv = n_adv + ((adv_s >= ASR_THRESH) & adv_v).sum()
        self._update(state)
        scale = state.scale.detach().clone()
        lsum, sl_sum, s_sum, s_sq, n_clean, n_adv, c_sum, v_sum = \
            parallel.reduce_sum(torch.stack([
                lsum, sl_sum, s_sum, s_sq, n_clean.to(torch.float32),
                n_adv.to(torch.float32), c_sum, v_sum])).unbind()
        b = parallel.global_rows(b)[0]
        mean = s_sum / b
        std = torch.sqrt(torch.clamp_min(s_sq / b - mean ** 2, 0.0))
        asr = (1.0 - n_adv / (n_clean + 1e-7) if with_asr
               else torch.full((), float("nan"), device=self.device))
        state.step += 1
        return state, StepMetrics(
            loss=lsum, scale=scale, scale_loss=sl_sum, tv_loss=tv_before,
            mean_max_score=mean, std_max_score=std, asr=asr,
            asr_to_scale=asr / (scale + 1e-7),
            eot_clamp_frac=c_sum / torch.clamp_min(v_sum, 1.0))

    def _eval_generator(self, state: AttackState, batch_idx: int):
        """EOT draws of an eval batch: seeded from the state's seed, its step
        and the batch index, so evaluation never advances the train steps'
        generator and the val batches of an epoch are decorrelated."""
        seed = (state.seed * 1_000_003 + state.step * 7_919 + int(batch_idx))
        return torch.Generator(device=self.device).manual_seed(seed % 2 ** 63)

    @torch.no_grad()
    def eval_step(self, state: AttackState, images: torch.Tensor,
                  batch_idx: int = 0, eot_draws: eot.EOTDraws | None = None
                  ) -> StepMetrics:
        """One validation batch (attacker.py:413-430)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        boxes, clean_scores, clean_valid = self.first_pass(images)
        boxes, boxes_valid = self._boxes(boxes, clean_valid, None)
        loss, aux = self._loss_from_images(
            state.patch, state.scale, images, boxes, boxes_valid,
            self._eval_generator(state, batch_idx), eot_draws)
        return self._metrics(loss, state.scale.detach().clone(), aux,
                             clean_scores, clean_valid,
                             clamp=self._clamp_frac(boxes, boxes_valid,
                                                    state.scale))

    def _metrics(self, loss, scale, aux, clean_scores, clean_valid,
                 with_asr: bool = True, clamp=None) -> StepMetrics:
        """The step's metrics over the global batch, from sums reduced over
        the ranks under an active mesh (one reduction): the loss, the scale
        loss, the score mean, the ASR counts and the clamp counts. The score
        std is the two-pass std in one process (JAX's `jnp.std`) and
        sqrt(max(E[x^2] - E[x]^2, 0)) in float32 from the ranks' sums across
        processes (ROADMAP Queue 3 item 5)."""
        ms = aux["max_scores"]
        zero = torch.zeros((), device=self.device)
        nan = torch.full((), float("nan"), device=self.device)
        n_clean = n_adv = zero
        if with_asr:
            _, adv_scores, adv_valid = self._nms(aux["adv_boxes"],
                                                 aux["adv_masked"])
            n_clean = ((clean_scores >= ASR_THRESH) & clean_valid).sum()
            n_adv = ((adv_scores >= ASR_THRESH) & adv_valid).sum()
        c_n, c_d = (zero, zero) if clamp is None else clamp
        (loss, scale_loss, s_sum, s_sq, n_clean, n_adv, c_n, c_d
         ) = parallel.reduce_sum(torch.stack([
             loss.detach(), aux["scale_losses"].sum(), ms.sum(),
             (ms * ms).sum(), n_clean.to(torch.float32),
             n_adv.to(torch.float32), c_n, c_d])).unbind()
        b = parallel.global_rows(ms.shape[0])[0]
        mean = s_sum / b
        std = (torch.std(ms, correction=0) if parallel.data_group() is None
               else torch.sqrt(torch.clamp_min(s_sq / b - mean ** 2, 0.0)))
        asr = 1.0 - n_adv / (n_clean + 1e-7) if with_asr else nan
        return StepMetrics(
            loss=loss, scale=scale, scale_loss=scale_loss, tv_loss=aux["tv"],
            mean_max_score=mean, std_max_score=std, asr=asr,
            asr_to_scale=asr / (scale + 1e-7),
            eot_clamp_frac=nan if clamp is None else c_n / torch.clamp_min(c_d, 1.0))

    @torch.no_grad()
    def asr_curve(self, state: AttackState, images: torch.Tensor, thresholds,
                  batch_idx: int = 0, eot_draws: eot.EOTDraws | None = None
                  ) -> torch.Tensor:
        """ASR at each score threshold (attacker.py:457-477)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        boxes, clean_scores, clean_valid = self.first_pass(images)
        boxes, boxes_valid = self._boxes(boxes, clean_valid, None)
        patched, _ = eot.apply_patches(
            images, boxes, boxes_valid, state.patch, state.scale,
            generator=self._eval_generator(state, batch_idx), draws=eot_draws,
            device=self.device, tolerance=self.tolerance, window=self.window,
            use_histogram_match=self.use_histogram_match,
            height=self.image_hw[0], **self.eot_overrides)
        adv_boxes, adv_masked = self.second_pass_scores(patched)
        _, adv_scores, adv_valid = self._nms(adv_boxes, adv_masked)
        # calc_asr's counts at each threshold, over the global batch
        counts = parallel.reduce_sum(torch.stack([torch.stack([
            ((clean_scores >= float(t)) & clean_valid).sum(),
            ((adv_scores >= float(t)) & adv_valid).sum()]) for t in thresholds
        ]).to(torch.float32))
        return 1.0 - counts[:, 1] / (counts[:, 0] + 1e-7)
