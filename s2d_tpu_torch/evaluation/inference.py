"""Video instance post-processing: top-k, resize, binarize, mask-IoU NMS.

Counterpart of `s2d_tpu/evaluation/inference.py:postprocess_video` (with
pack_bits=False) and `finalize_predictions`:

  1. softmax class scores (drop no-object), flatten (Q, K) and take the
     `num_predictions` top (query, class) pairs, sorted;
  2. bilinear-upsample the selected stride-4 mask logits to the padded input
     size, crop the padding off, resize to the output size in chunks of
     predictions, binarize at logit 0 -- in f32, in this two-stage order, on
     every device;
  3. exact mask IoU and greedy same-label NMS (the K4 CUDA kernel on the
     card, `nms_impl="plain"` for the torch loop).

The TPU transport workarounds (the composed bf16 resize, the bit-pack, the
bbox-crop readback) are not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.nms import greedy_mask_nms, greedy_mask_nms_plain, mask_iou_matrix
from ..ops.resize import interpolate_bilinear


def _chunk_size(n: int) -> int:
    for c in (10, 5, 2, 1):
        if n % c == 0:
            return n // c
    return n


def postprocess_video(
    pred_logits: torch.Tensor,  # (Q, K+1) or (1, Q, K+1)
    pred_masks: torch.Tensor,  # (Q, T, H/4, W/4) mask logits, or (1, ...)
    *,
    num_predictions: int,
    num_classes: int,
    image_size: Tuple[int, int],  # unpadded network input size
    output_size: Tuple[int, int],  # original video resolution
    num_frames: int | None = None,
    use_nms: bool = True,
    nms_thresh: float = 0.75,
    nms_impl: str = "kernel",
) -> Dict[str, torch.Tensor]:
    """Returns scores (P,), labels (P,), masks (P, T, *output_size) bool and
    keep (P,) bool, on the input's device, in score order."""
    if pred_logits.dim() == 3:
        pred_logits = pred_logits[0]
    if pred_masks.dim() == 5:
        pred_masks = pred_masks[0]
    if num_frames is not None:
        pred_masks = pred_masks[:, :num_frames]
    scores = torch.softmax(pred_logits.float(), dim=-1)[:, :-1]
    flat_scores = scores.reshape(-1)
    num_predictions = min(num_predictions, flat_scores.shape[0])
    top_scores, top_idx = torch.topk(flat_scores, num_predictions, sorted=True)
    labels = top_idx % num_classes
    query_idx = torch.div(top_idx, num_classes, rounding_mode="floor")

    sel = pred_masks[query_idx].float()  # (P, T, H/4, W/4)
    pad_h, pad_w = sel.shape[2] * 4, sel.shape[3] * 4
    up = interpolate_bilinear(sel, (pad_h, pad_w))[:, :, : image_size[0], : image_size[1]]
    step = _chunk_size(num_predictions)
    masks = torch.cat([
        interpolate_bilinear(up[i : i + step], output_size) > 0.0
        for i in range(0, num_predictions, step)
    ])

    if use_nms:
        iou = mask_iou_matrix(masks)
        if nms_impl == "kernel":
            keep = greedy_mask_nms(iou, labels, nms_thresh)
        elif nms_impl == "plain":
            keep = greedy_mask_nms_plain(iou, labels, nms_thresh)
        else:
            raise ValueError(f"unknown NMS impl {nms_impl!r}")
    else:
        keep = torch.ones((num_predictions,), dtype=torch.bool, device=masks.device)
    return {"scores": top_scores, "labels": labels, "masks": masks, "keep": keep}


def finalize_predictions(device_out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Apply the NMS keep mask and read the survivors back: scores (n,),
    labels (n,), masks (n, T, H, W) bool, as numpy."""
    keep = device_out["keep"]
    return {
        "scores": device_out["scores"][keep].cpu().numpy(),
        "labels": device_out["labels"][keep].cpu().numpy(),
        "masks": device_out["masks"][keep].cpu().numpy(),
    }
