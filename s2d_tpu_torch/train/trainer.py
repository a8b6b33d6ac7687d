"""The KD train step: a student and its EMA teacher, as
`s2d_tpu/train/trainer.py` (`make_train_step`, `create_train_state`).

One step:
  1. teacher forward without gradients (eval mode);
  2. distillation targets from the teacher's own predictions: score >=
     SCORE_THRESHOLD_DISTILLATION, masks upsampled x4 and binarized;
  3. student forward in train mode (encoder dropout from the step's
     generator; with SOLVER.GRAD_CHECKPOINT each encoder layer is recomputed
     in the backward pass);
  4. the supervised and distillation criteria on the student's outputs,
     with one batched auction for both (`set_criterion_pair`);
  5. the weighted total, its gradients, and the optimizer (`optim.py`);
  6. the EMA teacher update, on accumulation boundaries only;
  7. the NaN skip: on a non-finite total the parameters, Adam's moments and
     the teacher all stay as they were (the step count still advances).

With `kernels=True` the MSDA core runs the K1 forward and K2 backward CUDA
kernels and the auction the K5 kernel on a CUDA device; `kernels=False`
runs their plain PyTorch versions. Random draws come from the generator
given to the step, or are given (`draws`: "pool", "bern", as
`losses/criterion.py`), which the parity tests use to feed JAX's draws.
Not ported yet: DISTILLATION_NMS, the disentangled distillation view
(`ops/warp.py`), bit-packed targets; they raise NotImplementedError.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from ..checkpoint.torch_import import load_weights, needs_init
from ..config import Config, from_s2d_config
from ..demo_video import set_full_f32
from ..losses.criterion import CriterionConfig, set_criterion, set_criterion_pair
from ..models.meta_arch import VideoMaskFormer, build_model
from ..ops.resize import interpolate_bilinear
from .optim import KDOptimizer
from .schedules import ema_momentum_schedule, loss_weight_factors


@dataclasses.dataclass
class TrainState:
    step: int
    student: VideoMaskFormer
    teacher: VideoMaskFormer
    optimizer: KDOptimizer


@dataclasses.dataclass(frozen=True)
class LossWeights:
    class_weight: float = 0.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    kd_class_weight: float = 0.0
    kd_mask_weight: float = 5.0
    kd_dice_weight: float = 5.0


def prepare_distillation_targets(
    teacher_out: Dict[str, torch.Tensor], score_threshold: float, pad_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher predictions -> (masks (B, Q, T, H, W) bool, valid (B, Q)):
    every query whose best foreground score reaches the threshold (the
    reference's top-k with k = Q), its mask logits upsampled to the padded
    input and thresholded at 0."""
    scores = torch.softmax(teacher_out["pred_logits"].float(), dim=-1)[..., :-1].amax(-1)
    valid = scores >= score_threshold
    up = interpolate_bilinear(teacher_out["pred_masks"].float(), tuple(pad_hw))
    return up > 0.0, valid


def weighted_total(losses: Dict[str, torch.Tensor], weights: LossWeights, kd: bool,
                   factor) -> torch.Tensor:
    """Apply the weight dict (aux copies share their base weight) and sum."""
    if kd:
        table = {"loss_ce": weights.kd_class_weight, "loss_mask": weights.kd_mask_weight,
                 "loss_dice": weights.kd_dice_weight}
    else:
        table = {"loss_ce": weights.class_weight, "loss_mask": weights.mask_weight,
                 "loss_dice": weights.dice_weight}
    device = next(iter(losses.values())).device
    factor = torch.tensor(factor, dtype=torch.float32, device=device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for key, value in losses.items():
        base = key.rsplit("_", 1)[0] if key.split("_")[-1].isdigit() else key
        total = total + table[base] * value.float() * factor
    return total


def create_train_state(cfg: Config, seed: int = 0, device="cuda", params=None,
                       kernels: bool = True, teacher_params=None) -> TrainState:
    """Student (train mode) from `seed`, or from `params`; the teacher (eval
    mode, no gradients) from `teacher_params`, or a copy of the student;
    the optimizer. `params` and `teacher_params` take what
    `checkpoint.torch_import.load_weights` takes (flattened flax params, the
    port's state_dict, a checkpoint path): of a student/teacher checkpoint
    the student goes to the student and the teacher to the teacher. On a
    CUDA device TF32 is turned off (full f32, as the JAX reference)."""
    device = torch.device(device)
    if device.type == "cuda":
        set_full_f32()
    mf = cfg.model.mask_former

    def network(weights, which):
        model = build_model(
            from_s2d_config(cfg), msda_impl="cuda" if kernels else "plain",
            seed=seed if needs_init(weights) else None, train=True, enc_dropout=mf.dropout,
            grad_checkpoint=cfg.solver.grad_checkpoint,
        )
        if weights is not None:
            load_weights(model, weights, which)
        return model.to(device)

    student = network(params, "student")
    teacher = (copy.deepcopy(student) if teacher_params is None
               else network(teacher_params, "teacher"))
    teacher.eval().requires_grad_(False)
    return TrainState(0, student, teacher, KDOptimizer(list(student.named_parameters()), cfg))


class KDTrainStep:
    """The train step of `make_train_step`: `loss_and_grads` computes the
    losses and the gradients, `__call__` also applies them."""

    def __init__(self, cfg: Config, kernels: bool = True):
        mf = cfg.model.mask_former
        self.mf = mf
        self.kd_enabled = cfg.model.meta_architecture == "KDVideoMaskFormer"
        if self.kd_enabled and mf.num_predictions_distillation < mf.num_object_queries:
            raise NotImplementedError(
                "NUM_PREDICTIONS_DISTILLATION < NUM_OBJECT_QUERIES: the k >= Q identity "
                "prepare_distillation_targets relies on does not hold")
        if mf.distillation_nms:
            raise NotImplementedError("DISTILLATION_NMS is not ported yet")
        if cfg.input.disentangle_distillation_loader:
            raise NotImplementedError("the disentangled distillation view is not ported yet")
        if mf.point_sampling != "iid":
            raise NotImplementedError(f"point_sampling={mf.point_sampling!r} is not ported yet")
        amp = cfg.solver.amp.enabled
        self.crit_cfg = CriterionConfig(
            num_classes=cfg.model.sem_seg_head.num_classes, eos_coef=mf.no_object_weight,
            cost_class=mf.class_weight, cost_mask=mf.mask_weight, cost_dice=mf.dice_weight,
            num_points=mf.train_num_points, matcher_num_points=mf.matcher_num_points,
            oversample_ratio=mf.oversample_ratio,
            importance_sample_ratio=mf.importance_sample_ratio,
            masks_only=mf.loss_strategy == "masks-only",
            gather_dtype=torch.bfloat16 if amp else torch.float32,
            point_sampling=mf.point_sampling, assign_impl="cuda" if kernels else "plain",
        )
        self.kd_crit_cfg = dataclasses.replace(
            self.crit_cfg, masks_only=mf.distillation_loss_strategy == "masks-only")
        self.weights = LossWeights(mf.class_weight, mf.mask_weight, mf.dice_weight,
                                   mf.kd_class_weight, mf.kd_mask_weight, mf.kd_dice_weight)
        self.factors_fn = loss_weight_factors(cfg, cfg.solver.max_iter)
        self.ema_fn = ema_momentum_schedule(cfg)
        self.accum_iter = max(cfg.solver.accum_iter, 1)

    def loss_and_grads(self, state: TrainState, images: torch.Tensor, tgt_masks: torch.Tensor,
                       tgt_valid: torch.Tensor, generator: torch.Generator | None = None,
                       draws: Dict | None = None):
        """(total loss, metrics, one gradient per optimizer parameter)."""
        if tgt_masks.dtype != torch.bool:
            raise NotImplementedError("targets are bool masks (bit-packed ones are not ported)")
        pad_hw = tuple(images.shape[2:4])
        sup_factor, kd_factor = self.factors_fn(state.step)
        if self.kd_enabled:
            with record_function("teacher"), torch.no_grad():
                teacher_out = state.teacher(images)
                kd_masks, kd_valid = prepare_distillation_targets(
                    teacher_out, self.mf.score_threshold_distillation, pad_hw)
        with record_function("student"):
            out = state.student(images, generator=generator)
        with record_function("criterion"):
            if self.kd_enabled:
                sup_losses, kd_losses = set_criterion_pair(
                    out, tgt_masks, tgt_valid, self.crit_cfg, kd_masks, kd_valid,
                    self.kd_crit_cfg, generator=generator, draws=draws)
            else:
                sup_losses = set_criterion(out, tgt_masks, tgt_valid, self.crit_cfg,
                                           generator=generator, draws=draws)
            total = weighted_total(sup_losses, self.weights, kd=False, factor=sup_factor)
            metrics = {k: v.detach() for k, v in sup_losses.items() if "_" not in k[5:]}
            if self.kd_enabled:
                total = total + weighted_total(kd_losses, self.weights, kd=True,
                                               factor=kd_factor)
                metrics.update({f"kd_{k}": v.detach() for k, v in kd_losses.items()
                                if "_" not in k[5:]})
            metrics["total_loss"] = total.detach()
        with record_function("backward"):
            params = state.optimizer.params
            grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return total.detach(), metrics, grads

    def __call__(self, state: TrainState, images: torch.Tensor, tgt_masks: torch.Tensor,
                 tgt_valid: torch.Tensor, generator: torch.Generator | None = None,
                 draws: Dict | None = None):
        total, metrics, grads = self.loss_and_grads(
            state, images, tgt_masks, tgt_valid, generator, draws)
        finite = bool(torch.isfinite(total))
        with record_function("optimizer"):
            if finite:
                state.optimizer.step(grads)
                if self.kd_enabled and (state.step + 1) % self.accum_iter == 0:
                    m = float(self.ema_fn(state.step))
                    with torch.no_grad():
                        for t, s in zip(state.teacher.parameters(), state.student.parameters()):
                            t.copy_(m * t + (1.0 - m) * s)
        state.step += 1
        metrics["grad_finite"] = torch.tensor(float(finite))
        return state, metrics


def make_train_step(cfg: Config, kernels: bool = True) -> KDTrainStep:
    """step(state, images, tgt_masks, tgt_valid, generator=None, draws=None)
    -> (state, metrics); the state is updated in place.

    images (B, T, H, W, 3) normalized and padded; tgt_masks (B, N, T, H, W)
    bool; tgt_valid (B, N) bool."""
    return KDTrainStep(cfg, kernels)
