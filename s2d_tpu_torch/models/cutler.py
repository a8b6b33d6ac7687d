"""The CutLER/CutS3D image detector, as `s2d_tpu/models/cutler.py`: R50-FPN,
RPN, a cascade of box heads with DropLoss and a class-agnostic mask head.

The detector of stage 1 of the S2D pipeline (single-frame masks). Module
for module:

  * `FPN` over the port's ResNet (`models/resnet.py`, FrozenBN affines as
    parameters, as in JAX): lateral 1x1 and output 3x3 convs, p2..p5, the
    top-down path a nearest upsample with half-pixel centres
    (`jax.image.resize(..., "nearest")` is PyTorch's "nearest-exact", not
    "nearest": the two differ wherever a level is not twice the next), p6
    a 1x1 max pool of stride 2 (every other row and column of p5);
  * `RPNHead`: a shared 3x3 conv, 3 anchors a position (aspects 0.5, 1, 2;
    sizes 32..512 on p2..p6), outputs in (level, y, x, anchor) order;
  * `select_proposals`: a global top-k of the objectness, decode, clip,
    box NMS (K4 on the card), the top `num_proposals` of the survivors.
    Suppressed proposals carry -inf and, where fewer than `num_proposals`
    survive, still become proposals, as in JAX; ties come out lowest index
    first (`ops/boxes.top_k_stable`);
  * the cascade: per stage ROIAlign (7x7 on the assigned FPN level), a
    2-FC `BoxHead`, the refined boxes detached before the next stage;
  * `MaskHead`: 4 convs, a 2x2 stride-2 transposed conv, a 1x1 predictor,
    on 14x14 ROIAlign of the final boxes (or of given boxes: `mask_boxes`,
    and `mask_logits_at`, the TTA's mask pass, which runs the backbone,
    the FPN and the mask head alone).

Parameter names follow the flax tree (`backbone`, `fpn.lateral{i}`,
`fpn.output{i}`, `rpn.{conv,objectness,deltas}`, `box_stage{i}.{fc1,fc2,
cls,box}`, `mask_head.{conv0..3,deconv,predictor}`), so
`checkpoint/from_jax.py` maps each flax leaf to one tensor. The model takes
a normalized (1, H, W, 3) image, the JAX layout, and works in NCHW inside;
ROI features are channels-last, so the box head's flatten is JAX's.
The losses are plain functions of the output dict, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import box_nms, clip_boxes, decode_deltas, encode_deltas, pairwise_iou, top_k_stable
from ..ops.roi_align import multilevel_roi_align, roi_align
from .resnet import RESNET_FEATURE_CHANNELS, ResNet

ANCHOR_SIZES = (32, 64, 128, 256, 512)  # p2..p6
ANCHOR_ASPECTS = (0.5, 1.0, 2.0)
FPN_LEVELS = ("p2", "p3", "p4", "p5", "p6")
FPN_INPUTS = ("res2", "res3", "res4", "res5")


class FPN(nn.Module):
    def __init__(self, out_channels: int = 256):
        super().__init__()
        for i, name in enumerate(FPN_INPUTS):
            self.add_module(f"lateral{i}", nn.Conv2d(RESNET_FEATURE_CHANNELS[name], out_channels, 1))
            self.add_module(f"output{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [getattr(self, f"lateral{i}")(feats[n]) for i, n in enumerate(FPN_INPUTS)]
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(laterals[i + 1], size=laterals[i].shape[-2:], mode="nearest-exact")
            laterals[i] = laterals[i] + up
        outs = {f"p{i + 2}": getattr(self, f"output{i}")(laterals[i]) for i in range(4)}
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs


def generate_anchors(shapes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """Per level: (H*W*A, 4) xyxy anchors in image coordinates."""
    all_anchors = []
    for li, (h, w) in enumerate(shapes):
        stride = 2 ** (li + 2)
        size = ANCHOR_SIZES[li]
        cell = []
        for aspect in ANCHOR_ASPECTS:
            aw = size * np.sqrt(1.0 / aspect)
            ah = size * np.sqrt(aspect)
            cell.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
        cell = np.asarray(cell)  # (A, 4)
        ys = (np.arange(h) + 0.5) * stride
        xs = (np.arange(w) + 0.5) * stride
        cx, cy = np.meshgrid(xs, ys)
        centers = np.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
        anchors = (centers + cell[None]).reshape(-1, 4)
        all_anchors.append(anchors.astype(np.float32))
    return all_anchors


class RPNHead(nn.Module):
    def __init__(self, channels: int = 256, num_anchors: int = len(ANCHOR_ASPECTS)):
        super().__init__()
        self.conv = nn.Conv2d(channels, 256, 3, padding=1)
        self.objectness = nn.Conv2d(256, num_anchors, 1)
        self.deltas = nn.Conv2d(256, num_anchors * 4, 1)

    def forward(self, feats: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        obj, deltas = [], []
        for name in FPN_LEVELS:
            x = F.relu(self.conv(feats[name]))
            obj.append(self.objectness(x).permute(0, 2, 3, 1).reshape(-1))
            deltas.append(self.deltas(x).permute(0, 2, 3, 1).reshape(-1, 4))
        return torch.cat(obj), torch.cat(deltas)


class BoxHead(nn.Module):
    def __init__(self, num_classes: int = 1, in_features: int = 7 * 7 * 256):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.cls = nn.Linear(1024, num_classes + 1)
        self.box = nn.Linear(1024, 4)  # class-agnostic regression

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls(x), self.box(x)


class MaskHead(nn.Module):
    def __init__(self, channels: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(channels if i == 0 else 256, 256, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(256, 256, 2, stride=2)
        self.predictor = nn.Conv2d(256, 1, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(R, s, s, C) channels-last -> (R, 2s, 2s) mask logits."""
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x)[:, 0]


@dataclasses.dataclass(frozen=True)
class CutlerConfig:
    num_classes: int = 1
    num_proposals: int = 256
    pre_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    cascade_ious: Tuple[float, ...] = (0.5, 0.6, 0.7)
    droploss_iou_thresh: float = 0.01
    mask_on: bool = True


class CutlerRCNN(nn.Module):
    """Returns the raw per-stage outputs; losses and inference are the plain
    functions below."""

    def __init__(self, cfg: CutlerConfig = CutlerConfig()):
        super().__init__()
        self.cfg = cfg
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}
        self.backbone = ResNet(depth=50)
        self.fpn = FPN()
        self.rpn = RPNHead()
        for si in range(len(cfg.cascade_ious)):
            self.add_module(f"box_stage{si}", BoxHead(cfg.num_classes))
        if cfg.mask_on:
            self.mask_head = MaskHead()

    def features(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(1, H, W, 3) normalized image -> FPN levels p2..p6 (1, C, h, w)."""
        return self.fpn(self.backbone(image.permute(0, 3, 1, 2).contiguous()))

    def _anchors_on(self, shapes, device) -> torch.Tensor:
        """The anchors of these level shapes on `device`, made and uploaded
        once (an upload from pageable memory waits for the device's queue,
        which would stall the train loop)."""
        key = (shapes, str(device))
        if key not in self._anchor_cache:
            anchors = np.concatenate(generate_anchors(shapes))
            self._anchor_cache[key] = torch.from_numpy(anchors).to(device)
        return self._anchor_cache[key]

    @staticmethod
    def _pool_levels(fpn: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: fpn[k][0].permute(1, 2, 0).contiguous() for k in ("p2", "p3", "p4", "p5")}

    def _mask_logits(self, level_feats, boxes: torch.Tensor) -> torch.Tensor:
        return self.mask_head(multilevel_roi_align(level_feats, boxes, output_size=14))

    def mask_logits_at(self, image: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """The mask head at given boxes (K, 4): forward(image, mask_boxes=
        boxes)["mask_logits"] without the RPN, the proposal NMS and the
        cascade, whose results that output does not depend on (JAX's jitted
        mask pass leaves them to XLA to prune)."""
        return self._mask_logits(self._pool_levels(self.features(image)), boxes)

    def forward(
        self,
        image: torch.Tensor,
        proposals: Optional[torch.Tensor] = None,
        mask_boxes: Optional[torch.Tensor] = None,
    ) -> dict:
        """image (1, H, W, 3) normalized; proposals (R, 4), or None to select
        them from the RPN here; mask_boxes (K, 4) runs the mask head on those
        boxes instead of the cascade's final ones."""
        fpn = self.features(image)
        shapes = [tuple(fpn[n].shape[2:4]) for n in FPN_LEVELS]
        anchors = self._anchors_on(tuple(shapes), image.device)
        obj_logits, rpn_deltas = self.rpn(fpn)
        h, w = image.shape[1:3]
        if proposals is None:
            proposals, _ = select_proposals(
                anchors, obj_logits, rpn_deltas, (h, w), self.cfg.pre_nms_topk,
                self.cfg.rpn_nms_thresh, self.cfg.num_proposals)
        level_feats = self._pool_levels(fpn)

        stage_outputs = []
        boxes = proposals
        for si in range(len(self.cfg.cascade_ious)):
            roi = multilevel_roi_align(level_feats, boxes, output_size=7)
            scores, deltas = getattr(self, f"box_stage{si}")(roi)
            refined = clip_boxes(decode_deltas(boxes, deltas), (h, w))
            stage_outputs.append({"scores": scores, "deltas": deltas, "boxes": boxes})
            boxes = refined.detach()

        mask_logits = None
        if self.cfg.mask_on:
            mb = boxes if mask_boxes is None else mask_boxes
            mask_logits = self._mask_logits(level_feats, mb)
        return {
            "anchors": anchors,
            "objectness": obj_logits,
            "rpn_deltas": rpn_deltas,
            "proposals": proposals,
            "stages": stage_outputs,
            "final_boxes": boxes,
            "mask_logits": mask_logits,
        }


# the normal CDF at -2: a truncated normal's uniform draw lies in
# [2 LOW - 1, 1 - 2 LOW] before erfinv
_TRUNC_LOW = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with flax's defaults: lecun-normal (truncated at
    2 std) conv, transposed-conv and dense kernels, zero biases, unit
    FrozenBN scales (fan-in of a transposed conv: in x kh x kw, as flax).
    The truncated normal is drawn by inverting the CDF of a uniform draw
    (`nn.init.trunc_normal_`'s method in three in-place ops: 8x faster on
    the CPU than that call, which takes ~5 s for this model's 73 M weights)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[:, 0].numel() if isinstance(mod, nn.ConvTranspose2d) else w[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w.uniform_(2 * _TRUNC_LOW - 1, 1 - 2 * _TRUNC_LOW, generator=generator)
                w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
                if mod.bias is not None:
                    mod.bias.zero_()


def select_proposals(anchors, obj_logits, deltas, hw, pre_topk, nms_thresh, post_topk):
    """Global top-k of the objectness, decode, clip, NMS, top post_topk.
    Returns (boxes (post_topk, 4), scores (post_topk,)); suppressed entries
    score -inf."""
    k = min(pre_topk, obj_logits.shape[0])
    scores, idx = top_k_stable(obj_logits.detach(), k)
    boxes = clip_boxes(decode_deltas(anchors[idx], deltas[idx]), hw)
    keep = box_nms(boxes, scores, nms_thresh)
    scores = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = top_k_stable(scores, post_topk)
    return boxes[top_idx], top_scores


@torch.no_grad()
def _match(boxes, gt_boxes, gt_valid):
    """Each box's best IoU with a valid ground truth and that ground truth's
    index (the first on ties, as jnp.argmax)."""
    iou = pairwise_iou(boxes, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, torch.zeros_like(iou))
    return iou.max(dim=1).values, iou.argmax(dim=1)


def _bce_with_logits(logits, targets):
    return logits.clamp_min(0) - logits * targets + F.softplus(-logits.abs())


def _smooth_l1(diff):
    return torch.where(diff.abs() < 1.0, 0.5 * diff ** 2, diff.abs() - 0.5)


def rpn_losses(out, gt_boxes, gt_valid, pos_iou=0.7, neg_iou=0.3):
    """Objectness BCE and smooth-L1 deltas, weighted over all anchors."""
    anchors = out["anchors"]
    best_iou, best_gt = _match(anchors, gt_boxes, gt_valid)
    pos = best_iou >= pos_iou
    neg = best_iou < neg_iou
    labels = pos.float()
    weight = (pos | neg).float()

    obj = out["objectness"]
    loss_obj = (_bce_with_logits(obj, labels) * weight).sum() / weight.sum().clamp_min(1.0)

    tgt_deltas = encode_deltas(anchors, gt_boxes[best_gt])
    l1 = _smooth_l1(out["rpn_deltas"] - tgt_deltas)
    posf = pos.float()
    loss_box = (l1.sum(-1) * posf).sum() / posf.sum().clamp_min(1.0)
    return {"loss_rpn_cls": loss_obj, "loss_rpn_loc": loss_box}


def mask_loss(out, gt_masks, gt_boxes, gt_valid, cfg: CutlerConfig):
    """Per-proposal BCE between the mask logits and the matched ground-truth
    mask cropped to the proposal box at the mask resolution (d2 mask head
    loss, class-agnostic). gt_masks (G, H, W) bool at image resolution."""
    boxes = out["final_boxes"]
    best_iou, best_gt = _match(boxes, gt_boxes, gt_valid)
    fg = (best_iou >= cfg.cascade_ious[-1]).float()

    logits = out["mask_logits"]  # (R, 2s, 2s)
    side = logits.shape[-1]
    gt_rows = gt_masks.float()[..., None]  # (G, H, W, 1)
    crops = torch.stack([roi_align(gt_rows[gi], boxes, output_size=side, sampling_ratio=1)
                         for gi in range(gt_masks.shape[0])])
    targets = crops[best_gt, torch.arange(boxes.shape[0], device=boxes.device)][..., 0] > 0.5
    per_roi = _bce_with_logits(logits, targets.float()).mean(dim=(1, 2))
    return {"loss_mask": (per_roi * fg).sum() / fg.sum().clamp_min(1.0)}


def roi_losses(out, gt_boxes, gt_labels, gt_valid, cfg: CutlerConfig):
    """Cascade box losses with DropLoss: a proposal whose best IoU with any
    ground truth is <= droploss_iou_thresh gets no classification loss
    (reference roi_heads.py:823-850)."""
    losses = {}
    for si, (stage, match_iou) in enumerate(zip(out["stages"], cfg.cascade_ious)):
        boxes = stage["boxes"]
        best_iou, best_gt = _match(boxes, gt_boxes, gt_valid)
        fg = best_iou >= match_iou
        cls_target = torch.where(fg, gt_labels[best_gt].long(),
                                 torch.full_like(best_gt, cfg.num_classes))

        logp = F.log_softmax(stage["scores"].float(), dim=-1)
        nll = -logp.gather(-1, cls_target[:, None])[:, 0]
        cls_weight = (best_iou > cfg.droploss_iou_thresh).float()
        losses[f"loss_cls_stage{si}"] = (nll * cls_weight).sum() / cls_weight.sum().clamp_min(1.0)

        tgt_deltas = encode_deltas(boxes, gt_boxes[best_gt])
        l1 = _smooth_l1(stage["deltas"] - tgt_deltas)
        fgw = fg.float()
        losses[f"loss_box_stage{si}"] = (l1.sum(-1) * fgw).sum() / fgw.sum().clamp_min(1.0)
    return losses
