"""The KD train step: a student and its EMA teacher, as
`s2d_tpu/train/trainer.py` (`make_train_step`, `create_train_state`).

One step:
  1. teacher forward without gradients (eval mode);
  2. distillation targets from the teacher's own predictions: score >=
     SCORE_THRESHOLD_DISTILLATION, masks upsampled x4 and binarized; with
     the disentangled view (INPUT.DISENTANGLE_DISTILLATION_LOADER) warped
     into the distillation view (`ops/warp.py`); with DISTILLATION_NMS,
     greedy mask-IoU NMS over them at TEST.NMS_THRESH (`distillation_nms`,
     K4 on the card, one launch a clip);
  3. student forward in train mode (encoder dropout from the step's
     generator; with SOLVER.GRAD_CHECKPOINT each encoder layer is recomputed
     in the backward pass); with the disentangled view a second forward on
     the distillation images, with the same dropout draw;
  4. the supervised and distillation criteria on the student's outputs
     (the distillation one on the second forward's, with its own draws),
     with one batched auction for both (`set_criterion_pair`); the point
     pools iid or random-phase lattices (MODEL.MASK_FORMER.POINT_SAMPLING);
  5. the weighted total, its gradients, and the optimizer (`optim.py`);
  6. the EMA teacher update, on accumulation boundaries only;
  7. the NaN skip: on a non-finite total the parameters, Adam's moments and
     the teacher all stay as they were (the step count still advances).

In a process group (`parallel/dist.py`, `group=`) each rank runs the step
on its part of the global batch, as JAX's train step runs over the global
batch: the criteria's normalizers are the global batch's (all-reduced), so
each rank's loss is its share of the global loss; the gradients are summed
over the ranks (one flat bucket) before the optimizer, which then sees the
global batch's gradient (its global-norm clip included); the logged losses
and the finite check are the global ones, so every rank applies or skips
the same update. The EMA update stays local: the students are identical.

With `kernels=True` the MSDA core runs the K1 forward and K2 backward CUDA
kernels and the auction the K5 kernel on a CUDA device; `kernels=False`
runs their plain PyTorch versions. Random draws come from the generator
given to the step, or are given (`draws`: "pool" or "phases", "bern", as
`losses/criterion.py`, and under "kd" the distillation criterion's own
with the disentangled view), which the parity tests use to feed JAX's
draws. Targets come as bool masks or bit-packed along W (uint8, numpy's
`packbits`, as the loader ships them), unpacked on the device.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..checkpoint.torch_import import load_weights, needs_init
from ..config import Config, from_s2d_config
from ..demo_video import set_full_f32
from ..losses.criterion import CriterionConfig, set_criterion, set_criterion_pair
from ..models.meta_arch import VideoMaskFormer, build_model
from ..ops.nms import greedy_mask_nms, greedy_mask_nms_plain, mask_iou_matrix
from ..ops.resize import interpolate_bilinear
from ..ops.warp import warp_masks_affine
from .optim import KDOptimizer
from .schedules import ema_momentum_schedule, loss_weight_factors


@dataclasses.dataclass
class TrainState:
    step: int
    student: VideoMaskFormer
    teacher: VideoMaskFormer
    optimizer: KDOptimizer

    def state_dict(self) -> dict:
        """What a checkpoint holds (`checkpoint/io.py`); tensors by reference."""
        return {"step": self.step, "student": self.student.state_dict(),
                "teacher": self.teacher.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` in, in place, onto this state's device."""
        self.student.load_state_dict(state["student"])
        self.teacher.load_state_dict(state["teacher"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def state_tensors(state: TrainState):
    """Every tensor of `state` (the networks' parameters and buffers, the
    optimizer's moments), by reference: what a broadcast makes equal."""
    opt = state.optimizer.state_dict()
    return (list(state.student.state_dict().values()) + list(state.teacher.state_dict().values())
            + opt["mu"] + opt["nu"] + (opt["acc"] or []))


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The generator of train step `step`'s random draws (dropout, point
    sampling) on rank `rank`, a function of (seed, step, rank) only, as
    JAX's `fold_in(PRNGKey(seed), step)`: a resumed run draws at each step
    what an uninterrupted one draws there."""
    key = [seed, step] if rank == 0 else [seed, step, rank]
    entropy = np.random.SeedSequence(key).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(entropy[0]) | (int(entropy[1] & 0x7FFFFFFF) << 32))


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


def distillation_nms(masks: torch.Tensor, teacher_out: Dict[str, torch.Tensor],
                     valid: torch.Tensor, nms_thresh: float, impl: str = "kernel") -> torch.Tensor:
    """Greedy same-class mask-IoU NMS over the (possibly warped) distillation
    targets, the reference's `nms=True`: per clip, the candidates in
    descending score order (stable: ties keep query order), invalid ones
    neither suppressing nor surviving. masks (B, Q, T, H, W) bool, valid
    (B, Q). Returns the new (B, Q) validity. impl "kernel": K4 (on a CUDA
    tensor, one launch a clip), "plain": the torch loop."""
    nms = greedy_mask_nms if impl == "kernel" else greedy_mask_nms_plain
    probs = torch.softmax(teacher_out["pred_logits"].float(), dim=-1)[..., :-1]
    scores, labels = probs.amax(-1), probs.argmax(-1)
    out = torch.zeros_like(valid)
    for b in range(masks.shape[0]):
        order = torch.argsort(-scores[b], stable=True)
        v_sorted = valid[b][order]
        iou = mask_iou_matrix(masks[b])[order][:, order]
        iou = (iou * (v_sorted[:, None] & v_sorted[None, :])).contiguous()
        out[b, order] = nms(iou, labels[b][order], nms_thresh) & v_sorted
    return out


def unpack_targets(tgt_masks: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-packed targets (..., W / 8) uint8 (MSB first) -> (..., W) bool on
    their device. A uint8 array whose last axis is not W / 8 raises: 0/1
    masks go in as bool."""
    if tgt_masks.shape[-1] * 8 != width:
        raise ValueError(
            f"uint8 tgt_masks are interpreted as bit-packed along W but last dim "
            f"{tgt_masks.shape[-1]} * 8 != padded W {width}; pass bool masks for an unpacked feed")
    shifts = torch.arange(7, -1, -1, device=tgt_masks.device, dtype=torch.uint8)
    bits = (tgt_masks[..., None] >> shifts) & 1
    return bits.reshape(*tgt_masks.shape[:-1], width).bool()


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

    def __init__(self, cfg: Config, kernels: bool = True, group=None):
        mf = cfg.model.mask_former
        self.mf = mf
        self.group = group
        self.kd_enabled = cfg.model.meta_architecture == "KDVideoMaskFormer"
        if self.kd_enabled and mf.num_predictions_distillation < mf.num_object_queries:
            raise NotImplementedError(
                "NUM_PREDICTIONS_DISTILLATION < NUM_OBJECT_QUERIES: the k >= Q identity "
                "prepare_distillation_targets relies on does not hold")
        self.nms_impl = "kernel" if kernels else "plain"
        self.nms_thresh = mf.test.nms_thresh
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
                       draws: Dict | None = None, distill_images: torch.Tensor | None = None,
                       distill_affine: torch.Tensor | None = None):
        """(total loss, metrics, one gradient per optimizer parameter).
        distill_images (B, T, H, W, 3) and distill_affine (B, T, 3, 3): the
        disentangled distillation view of the batch, on the same canvas."""
        pad_hw = tuple(images.shape[2:4])
        if tgt_masks.dtype == torch.uint8:
            tgt_masks = unpack_targets(tgt_masks, pad_hw[1])
        disentangled = self.kd_enabled and distill_images is not None
        if disentangled and generator is None:  # the two forwards replay one draw
            generator = torch.Generator(device=images.device)
            generator.manual_seed(int(torch.randint(0, 2**62, (1,))))
        sup_factor, kd_factor = self.factors_fn(state.step)
        if self.kd_enabled:
            with record_function("teacher"), torch.no_grad():
                teacher_out = state.teacher(images)
                kd_masks, kd_valid = prepare_distillation_targets(
                    teacher_out, self.mf.score_threshold_distillation, pad_hw)
                if disentangled:
                    kd_masks = warp_masks_affine(kd_masks, distill_affine)
                if self.mf.distillation_nms:
                    kd_valid = distillation_nms(kd_masks, teacher_out, kd_valid,
                                                self.nms_thresh, self.nms_impl)
        with record_function("student"):
            drop_state = generator.get_state() if disentangled else None
            out = state.student(images, generator=generator)
            kd_out = None
            if disentangled:
                after = generator.get_state()
                generator.set_state(drop_state)  # JAX reuses the dropout key
                kd_out = state.student(distill_images, generator=generator)
                generator.set_state(after)
        with record_function("criterion"):
            reduce = None if self.group is None else self._sum
            if self.kd_enabled:
                sup_losses, kd_losses = set_criterion_pair(
                    out, tgt_masks, tgt_valid, self.crit_cfg, kd_masks, kd_valid,
                    self.kd_crit_cfg, generator=generator, draws=draws, outputs_b=kd_out,
                    draws_b=(draws or {}).get("kd"), reduce=reduce)
            else:
                sup_losses = set_criterion(out, tgt_masks, tgt_valid, self.crit_cfg,
                                           generator=generator, draws=draws, reduce=reduce)
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

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.all_reduce_sum([t])[0]

    def reduce(self, metrics: Dict[str, torch.Tensor], grads):
        """In a process group, (the global metrics, the global batch's
        gradients): each rank's shares summed over the ranks."""
        if self.group is None:
            return metrics, grads
        keys = list(metrics)
        with record_function("all_reduce"):
            summed = self.group.all_reduce_sum([metrics[k].float().reshape(1) for k in keys]
                                               + list(grads))
        return {k: v[0] for k, v in zip(keys, summed)}, summed[len(keys):]

    def __call__(self, state: TrainState, images: torch.Tensor, tgt_masks: torch.Tensor,
                 tgt_valid: torch.Tensor, generator: torch.Generator | None = None,
                 draws: Dict | None = None, distill_images: torch.Tensor | None = None,
                 distill_affine: torch.Tensor | None = None):
        _, metrics, grads = self.loss_and_grads(
            state, images, tgt_masks, tgt_valid, generator, draws, distill_images, distill_affine)
        metrics, grads = self.reduce(metrics, grads)
        finite = bool(torch.isfinite(metrics["total_loss"]))
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


def make_train_step(cfg: Config, kernels: bool = True, group=None) -> KDTrainStep:
    """step(state, images, tgt_masks, tgt_valid, generator=None, draws=None,
    distill_images=None, distill_affine=None) -> (state, metrics); the state
    is updated in place. `group`: the process group (`parallel/dist.py`)
    whose ranks hold the other parts of the global batch.

    images (B, T, H, W, 3) normalized and padded; tgt_masks (B, N, T, H, W)
    bool, or (B, N, T, H, W / 8) uint8 bit-packed along W; tgt_valid (B, N)
    bool; the distillation view (B, T, H, W, 3) and its affines (B, T, 3, 3)
    with INPUT.DISENTANGLE_DISTILLATION_LOADER."""
    return KDTrainStep(cfg, kernels, group)
