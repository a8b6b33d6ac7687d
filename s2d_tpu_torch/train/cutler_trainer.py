"""The CutLER detector's trainer, as `s2d_tpu/train/cutler_trainer.py`: the
config and its d2-style yaml, the SGD optimizer, the train step, cascade
inference, the mask paste and the image mapper.

  * `CutlerOptimizer` is JAX's optax chain, step for step: clip (d2
    CLIP_TYPE "norm": each tensor on its own, max_norm / (norm + 1e-6);
    "value"; "full_model": the global norm) -> + WEIGHT_DECAY * param ->
    momentum trace (g + m * t) -> x BASE_LR_MULTIPLIER on every tensor whose
    flax path contains one of BASE_LR_MULTIPLIER_NAMES -> x -lr(count), the
    warmup multi-step schedule of the update count. SOLVER.IMS_PER_BATCH is
    `optax.MultiSteps`: the chain runs on the running mean of
    `accum_steps` micro-step gradients, and the schedule counts optimizer
    steps. Every parameter is trained, the backbone's FrozenBN affines too:
    they are flax params there (detectron2 keeps them as buffers).
  * `make_cutler_train_step`: one micro-step on one image, uint8 in and
    normalized on the device (JAX's mapper normalizes on the host).
  * `cascade_detections`: stage-mean class probabilities, the last stage's
    boxes, box NMS (K4 on the card), the top `topk` by a stable sort.
  * `paste_masks` and `map_image_record` take `data/transforms.py`'s
    resizes where JAX calls cv2.resize: the uint8 image resize is cv2's bit
    for bit, the f32 mask resize within 1e-3 of it.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.from_jax import flax_path
from ..config import _load_yaml_with_base
from ..models.cutler import CutlerConfig, mask_loss, roi_losses, rpn_losses
from ..ops.boxes import box_nms, top_k_stable
from .schedules import warmup_multistep_lr


@dataclasses.dataclass(frozen=True)
class CutlerTrainerConfig:
    # model
    rcnn: CutlerConfig = CutlerConfig()
    pixel_mean: Tuple[float, ...] = (123.675, 116.280, 103.530)
    pixel_std: Tuple[float, ...] = (58.395, 57.120, 57.375)
    # data
    image_size: int = 512  # square canvas
    min_size_train: int = 480
    max_instances: int = 32
    flip: bool = True
    # image copy-paste (DATALOADER.COPY_PASTE*)
    copy_paste: bool = False
    copy_paste_rate: float = 1.0
    copy_paste_min_ratio: float = 0.5
    copy_paste_max_ratio: float = 1.0
    copy_paste_random_num: bool = True
    # solver (SGD, momentum 0.9)
    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-5
    base_lr_multiplier: float = 1.0
    base_lr_multiplier_names: Tuple[str, ...] = ()
    steps: Tuple[int, ...] = (60000,)
    gamma: float = 0.1
    warmup_iters: int = 1000
    warmup_factor: float = 0.001
    max_iter: int = 80000
    clip_value: float = 0.0  # 0 = no clipping
    clip_type: str = "norm"  # "norm" (per tensor), "value" or "full_model"
    # SOLVER.IMS_PER_BATCH as accumulation over single-image micro-steps
    accum_steps: int = 1
    # test
    score_thresh: float = 0.005
    nms_thresh: float = 0.5
    detections_per_image: int = 100
    no_segm: bool = False
    # TEST.AUG: multi-scale + hflip TTA
    test_aug_enabled: bool = False
    test_aug_min_sizes: Tuple[int, ...] = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
    test_aug_max_size: int = 4000
    test_aug_flip: bool = True


def _literal(value):
    return ast.literal_eval(value) if isinstance(value, str) else value


def load_cutler_yaml(path: str) -> Tuple[dict, dict, dict]:
    """d2-style CutLER yaml (with `_BASE_`) -> (trainer fields, rcnn fields,
    datasets), the keys `s2d_tpu`'s loader maps and nothing else; a list of
    MIN_SIZE_TRAIN scales becomes its median (one static train size)."""
    y = _load_yaml_with_base(path)
    model = y.get("MODEL", {})
    solver = y.get("SOLVER", {})
    dl = y.get("DATALOADER", {})
    inp = y.get("INPUT", {})
    test = y.get("TEST", {})
    roi = model.get("ROI_HEADS", {})
    rpn = model.get("RPN", {})

    fields: dict = {}
    rcnn: dict = {}

    def put(d, key, val):
        if val is not None:
            d[key] = val

    put(fields, "pixel_mean", tuple(model["PIXEL_MEAN"]) if "PIXEL_MEAN" in model else None)
    put(fields, "pixel_std", tuple(model["PIXEL_STD"]) if "PIXEL_STD" in model else None)
    put(fields, "copy_paste", dl.get("COPY_PASTE"))
    put(fields, "copy_paste_rate", dl.get("COPY_PASTE_RATE"))
    put(fields, "copy_paste_min_ratio", dl.get("COPY_PASTE_MIN_RATIO"))
    put(fields, "copy_paste_max_ratio", dl.get("COPY_PASTE_MAX_RATIO"))
    put(fields, "copy_paste_random_num", dl.get("COPY_PASTE_RANDOM_NUM"))
    put(fields, "base_lr", solver.get("BASE_LR"))
    put(fields, "momentum", solver.get("MOMENTUM"))
    put(fields, "weight_decay", solver.get("WEIGHT_DECAY"))
    put(fields, "base_lr_multiplier", solver.get("BASE_LR_MULTIPLIER"))
    if solver.get("BASE_LR_MULTIPLIER_NAMES") is not None:
        fields["base_lr_multiplier_names"] = tuple(solver["BASE_LR_MULTIPLIER_NAMES"])
    if solver.get("STEPS") is not None:
        fields["steps"] = tuple(_literal(solver["STEPS"]))
    put(fields, "gamma", solver.get("GAMMA"))
    put(fields, "warmup_iters", solver.get("WARMUP_ITERS"))
    put(fields, "warmup_factor", solver.get("WARMUP_FACTOR"))
    put(fields, "max_iter", solver.get("MAX_ITER"))
    put(fields, "accum_steps", solver.get("IMS_PER_BATCH"))
    clip = solver.get("CLIP_GRADIENTS", {})
    if clip.get("ENABLED"):
        # d2 defaults: CLIP_VALUE 1.0, CLIP_TYPE "value" when unset
        fields["clip_value"] = float(clip.get("CLIP_VALUE", 1.0))
        fields["clip_type"] = str(clip.get("CLIP_TYPE", "value"))
    if inp.get("MIN_SIZE_TRAIN") is not None:
        sizes = _literal(inp["MIN_SIZE_TRAIN"])
        if isinstance(sizes, (list, tuple)):
            fields["min_size_train"] = int(statistics.median(sizes))
        else:
            fields["min_size_train"] = int(sizes)
    put(fields, "score_thresh", roi.get("SCORE_THRESH_TEST"))
    put(fields, "nms_thresh", roi.get("NMS_THRESH_TEST"))
    put(fields, "detections_per_image", test.get("DETECTIONS_PER_IMAGE"))
    put(fields, "no_segm", test.get("NO_SEGM"))
    aug = test.get("AUG", {})
    put(fields, "test_aug_enabled", aug.get("ENABLED"))
    if aug.get("MIN_SIZES") is not None:
        fields["test_aug_min_sizes"] = tuple(int(x) for x in _literal(aug["MIN_SIZES"]))
    put(fields, "test_aug_max_size", aug.get("MAX_SIZE"))
    put(fields, "test_aug_flip", aug.get("FLIP"))

    put(rcnn, "num_classes", roi.get("NUM_CLASSES"))
    # DropLoss is off unless USE_DROPLOSS (then its threshold defaults to 0);
    # -1 keeps every proposal's loss (best_iou > -1 always)
    if roi.get("USE_DROPLOSS"):
        rcnn["droploss_iou_thresh"] = float(roi.get("DROPLOSS_IOU_THRESH", 0.0))
    else:
        rcnn["droploss_iou_thresh"] = -1.0
    # the standard (non-cascade) ROI heads: one box stage matched at IoU 0.5
    if roi.get("NAME") in ("CustomStandardROIHeads", "StandardROIHeads"):
        rcnn["cascade_ious"] = (0.5,)
    put(rcnn, "rpn_nms_thresh", rpn.get("NMS_THRESH"))
    put(rcnn, "pre_nms_topk", rpn.get("PRE_NMS_TOPK_TEST"))
    put(rcnn, "mask_on", model.get("MASK_ON"))

    datasets = {}
    ds = y.get("DATASETS", {})
    for k in ("TRAIN", "TEST"):
        v = _literal(ds.get(k))
        if v:
            datasets[k.lower()] = v[0] if isinstance(v, (list, tuple)) else v
    return fields, rcnn, datasets


@torch.no_grad()
def clip_by_per_param_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """d2 CLIP_TYPE "norm": each tensor scaled by min(1, max_norm / (its
    norm + 1e-6)), not by the global norm."""
    norms = torch._foreach_norm(list(grads))
    return [g * torch.clamp(max_norm / (n + 1e-6), max=1.0) for g, n in zip(grads, norms)]


class CutlerOptimizer:
    """SGD with momentum and per-name LR multipliers over `named_params`
    (held in this order); see the module doc for the chain."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                 cfg: CutlerTrainerConfig):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        names = cfg.base_lr_multiplier_names
        full = ["params." + flax_path(n, p.ndim).replace("/", ".") for n, p in named_params]
        self.multipliers = [cfg.base_lr_multiplier if any(m in f for m in names) else 1.0
                            for f in full]
        self.cfg = cfg
        self.schedule = warmup_multistep_lr(cfg.base_lr, cfg.steps, cfg.gamma, cfg.warmup_iters,
                                            cfg.warmup_factor)
        self.accum_steps = max(cfg.accum_steps, 1)
        with torch.no_grad():
            self.trace = [torch.zeros_like(p) for p in self.params]
            self.acc = ([torch.zeros_like(p) for p in self.params]
                        if self.accum_steps > 1 else None)
        self.count = 0  # optimizer steps (the schedule's count)
        self.mini_step = 0

    def state_dict(self) -> dict:
        """The momentum trace, the accumulator, the count and the micro-step;
        the tensors in parameter order, by reference."""
        return {"names": list(self.names), "trace": list(self.trace),
                "acc": None if self.acc is None else list(self.acc),
                "count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if list(state["names"]) != self.names:
            raise ValueError("the optimizer state names other parameters than this optimizer's")
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("the optimizer state and this optimizer differ in IMS_PER_BATCH")
        for mine, theirs in ((self.trace, state["trace"]), (self.acc or [], state["acc"] or [])):
            for dst, src in zip(mine, theirs, strict=True):
                dst.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        cfg = self.cfg
        if cfg.clip_value <= 0:
            return grads
        if cfg.clip_type == "norm":
            return clip_by_per_param_norm(grads, cfg.clip_value)
        if cfg.clip_type == "value":
            return [g.clamp(-cfg.clip_value, cfg.clip_value) for g in grads]
        # full_model: optax.clip_by_global_norm
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        scaled = torch._foreach_mul(torch._foreach_div(grads, norm), cfg.clip_value)
        return [torch.where(norm < cfg.clip_value, g, s) for g, s in zip(grads, scaled)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """One micro-step's gradients (one per parameter). Returns True where
        the parameters were updated."""
        grads = [g.float() for g in grads]
        if self.acc is not None:
            # running mean over the micro-steps (MultiSteps' use_grad_mean)
            n_acc = float(self.mini_step + 1)
            self.acc = [a + (g - a) / n_acc for g, a in zip(grads, self.acc)]
            self.mini_step = (self.mini_step + 1) % self.accum_steps
            if self.mini_step:
                return False
            grads, self.acc = self.acc, [torch.zeros_like(a) for a in self.acc]
        grads = self._clip(grads)
        neg_lr = float(-self.schedule(self.count))
        self.count += 1
        decayed = torch._foreach_add(grads, self.params, alpha=self.cfg.weight_decay)
        self.trace = torch._foreach_add(decayed, self.trace, alpha=self.cfg.momentum)
        for p, t, m in zip(self.params, self.trace, self.multipliers):
            u = t * m if m != 1.0 else t
            p.add_(u * neg_lr)
        return True


def build_cutler_optimizer(model: torch.nn.Module, cfg: CutlerTrainerConfig) -> CutlerOptimizer:
    return CutlerOptimizer(list(model.named_parameters()), cfg)


class CutlerTrainState:
    """The model, its optimizer and the micro-step count: what a checkpoint
    holds (`checkpoint/io.py` calls state_dict / load_state_dict)."""

    def __init__(self, model: torch.nn.Module, optimizer: CutlerOptimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


@functools.lru_cache(maxsize=8)
def _mean_std(mean: Tuple[float, ...], std: Tuple[float, ...], device: torch.device):
    """The normalization constants on `device`, uploaded once: an upload
    from pageable memory waits for the device's queue, which would keep the
    train loop's host work from overlapping the steps."""
    return (torch.tensor(mean, dtype=torch.float32).to(device),
            torch.tensor(std, dtype=torch.float32).to(device))


def normalize_image(image_u8: torch.Tensor, cfg: CutlerTrainerConfig) -> torch.Tensor:
    """(..., 3) uint8 -> float32 (x - mean) / std on the tensor's device."""
    mean, std = _mean_std(tuple(cfg.pixel_mean), tuple(cfg.pixel_std), image_u8.device)
    return (image_u8.float() - mean) / std


def cutler_losses(out: dict, gt_boxes, gt_labels, gt_valid, gt_masks,
                  cfg: CutlerTrainerConfig) -> Dict[str, torch.Tensor]:
    losses = {}
    losses.update(rpn_losses(out, gt_boxes, gt_valid, cfg.rcnn.rpn_pos_iou, cfg.rcnn.rpn_neg_iou))
    losses.update(roi_losses(out, gt_boxes, gt_labels, gt_valid, cfg.rcnn))
    if cfg.rcnn.mask_on and not cfg.no_segm:
        losses.update(mask_loss(out, gt_masks, gt_boxes, gt_valid, cfg.rcnn))
    return losses


def make_cutler_train_step(model: torch.nn.Module, cfg: CutlerTrainerConfig,
                           optimizer: CutlerOptimizer):
    """step(image (1, H, W, 3) uint8, gt_boxes, gt_labels, gt_valid,
    gt_masks) -> metrics (device scalars: each loss and total_loss). A
    parameter the loss does not reach (the mask head under --no-segm) gets
    a zero gradient, as in JAX: decay and momentum still move it."""

    def step(image_u8, gt_boxes, gt_labels, gt_valid, gt_masks):
        out = model(normalize_image(image_u8, cfg))
        losses = cutler_losses(out, gt_boxes, gt_labels, gt_valid, gt_masks, cfg)
        total = sum(losses.values())
        grads = torch.autograd.grad(total, optimizer.params, allow_unused=True)
        optimizer.step([torch.zeros_like(p) if g is None else g
                        for g, p in zip(grads, optimizer.params)])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return step


def cascade_detections(out: dict, num_classes: int, score_thresh: float, nms_thresh: float,
                       topk: int, with_masks: bool = False):
    """Cascade R-CNN inference: class probability = the mean over the stages
    of the softmaxed scores, boxes = the final ones. Returns (boxes (K, 4),
    scores (K,), classes (K,), valid (K,)) with K = topk, and with
    `with_masks` the selected detections' mask probabilities (K, 2s, 2s)."""
    probs = torch.stack([torch.softmax(s["scores"].float(), -1) for s in out["stages"]]).mean(0)
    probs = probs[:, :num_classes]  # drop the background column
    scores = probs.max(dim=-1).values
    classes = probs.argmax(dim=-1)
    boxes = out["final_boxes"]

    keep = box_nms(boxes, scores, nms_thresh) & (scores > score_thresh)
    scores = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_scores, idx = top_k_stable(scores, min(topk, scores.shape[0]))
    valid = torch.isfinite(top_scores)
    result = (boxes[idx], torch.where(valid, top_scores, torch.zeros_like(top_scores)),
              classes[idx], valid)
    if with_masks:
        if out.get("mask_logits") is None:
            raise ValueError("with_masks=True requires a mask head (mask_on)")
        result = result + (torch.sigmoid(out["mask_logits"][idx]),)
    return result


def paste_masks(masks: np.ndarray, boxes: np.ndarray, out_hw: Tuple[int, int],
                thresh: float = 0.5) -> np.ndarray:
    """Resize each box-frame mask (K, m, m) to its box (K, 4) and threshold
    it into the image canvas: (K, H, W) bool."""
    from ..data.transforms import resize_linear

    h, w = out_hw
    out = np.zeros((masks.shape[0], h, w), bool)
    for i, (m, b) in enumerate(zip(masks, boxes)):
        x0, y0, x1, y1 = b
        x0i, y0i = int(np.floor(x0)), int(np.floor(y0))
        x1i, y1i = int(np.ceil(x1)), int(np.ceil(y1))
        bw, bh = max(x1i - x0i, 1), max(y1i - y0i, 1)
        resized = resize_linear(m.astype(np.float32), (bh, bw)) >= thresh
        sx0, sy0 = max(0, -x0i), max(0, -y0i)
        dx0, dy0 = max(0, x0i), max(0, y0i)
        dx1, dy1 = min(w, x1i), min(h, y1i)
        if dx1 > dx0 and dy1 > dy0:
            out[i, dy0:dy1, dx0:dx1] = resized[sy0:sy0 + (dy1 - dy0), sx0:sx0 + (dx1 - dx0)]
    return out


def map_image_record(record: dict, cfg: CutlerTrainerConfig,
                     rng: Optional[np.random.RandomState] = None, is_train: bool = True,
                     normalize: bool = True) -> Optional[dict]:
    """Read, resize (shortest edge, the long side capped at image_size), flip
    (train), pad to (image_size, image_size); targets padded to
    max_instances. None for an unreadable image. normalize=False keeps the
    canvas uint8 (the CLI normalizes on the device)."""
    from ..data import rle as rle_codec
    from ..data.mapper import load_image_robust
    from ..data.transforms import resize_linear, resize_nearest

    rng = rng or np.random.RandomState(0)
    try:
        img = load_image_robust(record["file_name"])
    except (OSError, ValueError):
        return None
    h, w = img.shape[:2]
    size = cfg.min_size_train if is_train else cfg.image_size
    scale = min(size / min(h, w), cfg.image_size / max(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = resize_linear(img, (nh, nw))
    flip = is_train and cfg.flip and rng.rand() < 0.5
    if flip:
        img = img[:, ::-1]

    s = cfg.image_size
    if normalize:
        canvas = np.zeros((s, s, 3), np.float32)
        canvas[:nh, :nw] = img
        canvas = (canvas - np.asarray(cfg.pixel_mean)) / np.asarray(cfg.pixel_std)
    else:
        canvas = np.zeros((s, s, 3), np.uint8)
        canvas[:nh, :nw] = img

    n = cfg.max_instances
    boxes = np.zeros((n, 4), np.float32)
    labels = np.zeros((n,), np.int32)
    valid = np.zeros((n,), bool)
    masks = np.zeros((n, s, s), bool)
    for i, ann in enumerate(record.get("annotations", [])[:n]):
        x0, y0, x1, y1 = [c * scale for c in ann["bbox"]]
        if flip:
            x0, x1 = nw - x1, nw - x0
        boxes[i] = [x0, y0, x1, y1]
        labels[i] = ann["category_id"]
        valid[i] = True
        seg = ann.get("segmentation")
        if seg is not None:
            if isinstance(seg, dict):
                m = rle_codec.decode(seg).astype(np.uint8)
            else:
                m = rle_codec.polygons_to_mask(seg, record["height"], record["width"]).astype(np.uint8)
            m = resize_nearest(m, (nh, nw))
            if flip:
                m = m[:, ::-1]
            masks[i, :nh, :nw] = m.astype(bool)
    return {
        "image": canvas,
        "boxes": boxes,
        "labels": labels,
        "valid": valid,
        "masks": masks,
        "image_id": record.get("image_id", 0),
        "scale": scale,
        "orig_hw": (h, w),
    }
