"""Video instance post-processing: top-k, resize, binarize, mask-IoU NMS,
and the survivors' readback as bbox crops.

Counterpart of `s2d_tpu/evaluation/inference.py` (`postprocess_video`,
`start_kept_masks_read` / `finish_kept_masks_read`, `WindowMasks`,
`read_small_bundle`, `finalize_predictions`):

  1. softmax class scores (drop no-object), flatten (Q, K) and take the
     `num_predictions` top (query, class) pairs, sorted;
  2. bilinear-upsample the selected stride-4 mask logits to the padded input
     size, crop the padding off, resize to the output size in chunks of
     predictions, binarize at logit 0 -- in f32, in this two-stage order, on
     every device;
  3. exact mask IoU and greedy same-label NMS (the K4 CUDA kernel on the
     card, `nms_impl="plain"` for the torch loop);
  4. each prediction's box, the union over frames of its mask's extent, in
     pixels; the masks and boxes stored kept-first (a stable order, so the
     survivors keep their score order), and every per-prediction scalar in
     one small f32 bundle, read back in one device-to-host copy.

The host reads the bundle, then each survivor's track as one window of a
bucketed (ch, cw) size around its box, gathered on the device: instance
masks are mostly empty, so the copy and the RLE encoder (which encodes
straight from the window, `rle.encode_window`) do O(crop) work instead of
O(canvas). Where the window would not cut at least 30% of the canvas, the
survivors' whole masks come back instead. On a CUDA device both reads start
without blocking (into pinned memory, an event marking their end), so the
evaluator's two finalize threads overlap them. The JAX package's bit-pack
of the masks along H and its composed bf16 resize are TPU-only and not
ported: boxes here are in pixel rows, not packed byte rows.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.nms import greedy_mask_nms, greedy_mask_nms_plain, mask_iou_matrix
from ..ops.resize import interpolate_bilinear

CROP_FRACTION = 0.7  # crop only where the window is under 70% of the canvas
ROW_BUCKET, COL_BUCKET = 8, 32  # window sizes are multiples of these
# survivors read back as crops and as whole masks, and their bytes, since
# the last reset (the evaluator's transport, read by chip_smoke.py)
TRANSPORT = {"crop_tracks": 0, "row_tracks": 0, "read_bytes": 0, "canvas_bytes": 0}


def _chunk_size(n: int) -> int:
    for c in (10, 5, 2, 1):
        if n % c == 0:
            return n // c
    return n


def _extent(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, N) bool -> (first, last + 1) of each row's true entries; an
    empty row gives (0, 1)."""
    n = a.shape[1]
    nonempty = a.any(dim=1)
    a8 = a.to(torch.uint8)
    first = torch.where(nonempty, a8.argmax(dim=1), 0)
    last = torch.where(nonempty, n - a8.flip(1).argmax(dim=1), 1)
    return first, last


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
    """On the input's device: scores (P,), labels (P,) and keep (P,) bool in
    score order; masks (P, T, *output_size) bool and boxes (P, 4) int32
    [y0, x0, h, w] kept-first, `order` the kept-first permutation; `small`
    (8P,) f32: scores, labels, keep, order, then the boxes' four fields
    (kept-first), each a group of P."""
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

    pres = masks.any(dim=1)  # (P, H, W)
    y0, y1 = _extent(pres.any(dim=2))
    x0, x1 = _extent(pres.any(dim=1))
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    boxes = torch.stack([y0, x0, y1 - y0, x1 - x0], dim=-1).to(torch.int32)[order]
    return {
        "scores": top_scores,
        "labels": labels,
        "keep": keep,
        "masks": masks[order],
        "order": order,
        "boxes": boxes,
        "small": torch.cat([top_scores.float(), labels.float(), keep.float(), order.float(),
                            boxes.T.reshape(-1).float()]),
    }


def _start_copy(tensor: torch.Tensor, stream=None):
    """(host tensor, CUDA event or None): a CUDA tensor's copy into pinned
    memory, started on `stream` (default: the current one) without
    blocking; the event marks its end. A CPU tensor is its own copy."""
    if not tensor.is_cuda:
        return tensor, None
    stream = stream or torch.cuda.current_stream(tensor.device)
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(tensor, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return host, done


def _wait(copy) -> np.ndarray:
    host, done = copy
    if done is not None:
        done.synchronize()
    return host.numpy()


def start_small_read(device_out: Dict[str, torch.Tensor]) -> None:
    """Start the copy of the small bundle now (the evaluator calls this on
    its main thread right after the postprocess, so the copy is queued
    behind this video's work and not behind the next video's forward)."""
    device_out["small_read"] = _start_copy(device_out["small"])


def read_small_bundle(
    device_out: Dict[str, torch.Tensor]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(scores f32, labels int64, keep bool, boxes int32 (P, 4)) from the
    small bundle in one device-to-host copy, which also waits for the
    postprocess. Boxes are kept-first [y0, x0, h, w]; the rest in score
    order."""
    copy = device_out.get("small_read") or _start_copy(device_out["small"])
    small = _wait(copy)
    p = small.size // 8
    boxes = np.rint(small[4 * p:]).astype(np.int32).reshape(4, p).T
    return small[:p], small[p: 2 * p].astype(np.int64), small[2 * p: 3 * p] > 0.5, boxes


def crop_bucket(boxes: np.ndarray, h: int, w: int) -> Tuple[int, int]:
    """The window (ch, cw) for the kept boxes (n, 4): the largest box's
    height and width rounded up to ROW_BUCKET rows and COL_BUCKET columns,
    at most the canvas."""
    ch = max(min(-(-int(boxes[:, 2].max()) // ROW_BUCKET) * ROW_BUCKET, h), min(ROW_BUCKET, h))
    cw = max(min(-(-int(boxes[:, 3].max()) // COL_BUCKET) * COL_BUCKET, w), min(COL_BUCKET, w))
    return ch, cw


def crop_offsets(boxes, h: int, w: int, ch: int, cw: int):
    """Each window's top-left corner: the box's, clamped so that the window
    fits the canvas (numpy on the host, torch on the device: the same
    clamp)."""
    if isinstance(boxes, torch.Tensor):
        return boxes[:, 0].clamp(0, h - ch), boxes[:, 1].clamp(0, w - cw)
    return np.clip(boxes[:, 0], 0, h - ch), np.clip(boxes[:, 1], 0, w - cw)


def crop_windows(masks: torch.Tensor, boxes: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    """masks (n, T, H, W), boxes (n, 4) on one device -> (n, T, ch, cw): each
    track's window at its clamped offsets, one gather."""
    n, t, h, w = masks.shape
    y0, x0 = crop_offsets(boxes.long(), h, w, ch, cw)
    dev = masks.device
    rows = y0[:, None] + torch.arange(ch, device=dev)
    cols = x0[:, None] + torch.arange(cw, device=dev)
    return masks[torch.arange(n, device=dev)[:, None, None, None],
                 torch.arange(t, device=dev)[None, :, None, None],
                 rows[:, None, :, None], cols[:, None, None, :]]


def start_kept_masks_read(
    device_out: Dict[str, torch.Tensor],
    keep: np.ndarray,
    boxes: np.ndarray | None = None,
    stream=None,
):
    """First half of the survivors' readback: start the copy of the n kept
    tracks (the first n of the kept-first masks), as windows around
    `boxes` (host, kept-first, from `read_small_bundle`) where the window
    cuts at least 30% of the canvas, else whole. `boxes=None` forces the
    whole masks. On a CUDA device the gather and the copy run on `stream`
    (default: the current one), after the postprocess. Returns a handle for
    `finish_kept_masks_read`."""
    masks = device_out["masks"]
    n = int(np.asarray(keep).sum())
    _, t, h, w = masks.shape
    TRANSPORT["canvas_bytes"] += n * t * h * w
    if masks.is_cuda and stream is not None:
        done = device_out.get("small_read", (None, None))[1]
        if done is not None:
            stream.wait_event(done)
        else:
            stream.wait_stream(torch.cuda.current_stream(masks.device))
        masks.record_stream(stream)
        device_out["boxes"].record_stream(stream)
    ctx = torch.cuda.stream(stream) if masks.is_cuda and stream is not None else contextlib.nullcontext()
    with ctx:
        if boxes is not None and n > 0:
            ch, cw = crop_bucket(np.asarray(boxes)[:n], h, w)
            if ch * cw < CROP_FRACTION * h * w:
                crops = crop_windows(masks[:n], device_out["boxes"][:n], ch, cw)
                y0, x0 = crop_offsets(np.asarray(boxes)[:n], h, w, ch, cw)
                TRANSPORT["crop_tracks"] += n
                TRANSPORT["read_bytes"] += crops.numel()
                return ("crops", _start_copy(crops, stream), (y0, x0, h, w))
        sliced = masks[:n]
        TRANSPORT["row_tracks"] += n
        TRANSPORT["read_bytes"] += sliced.numel()
        return ("rows", _start_copy(sliced, stream), None)


class WindowMasks(NamedTuple):
    """Survivor masks as windows and their placements, the paste-free form
    that the RLE encoder works from (`rle.encode_window`). Rows of
    `crops[i]` past `height - y0[i]` are not on the canvas and are cut
    before use."""

    crops: np.ndarray  # (n, T, ch, cw) bool
    y0: np.ndarray  # (n,) pixel row of each window's top edge
    x0: np.ndarray  # (n,)
    height: int
    width: int

    @property
    def shape(self):  # as the (n, T, H, W) masks it stands for
        return (self.crops.shape[0], self.crops.shape[1], self.height, self.width)

    def paste(self) -> np.ndarray:
        """The full (n, T, H, W) bool masks."""
        n_, t_, ch, cw = self.crops.shape
        out = np.zeros((n_, t_, self.height, self.width), np.bool_)
        for i in range(n_):
            yp = int(self.y0[i])
            h_i = min(ch, self.height - yp)
            out[i, :, yp: yp + h_i, self.x0[i]: self.x0[i] + cw] = self.crops[i, :, :h_i]
        return out


def finish_kept_masks_read(handle, timers: Dict[str, float] | None = None,
                           as_window: bool = False) -> np.ndarray | WindowMasks:
    """Second half: wait for the copy and return the survivors' masks (n,
    T, H, W) bool in score order, or with `as_window` and a crop read the
    `WindowMasks` itself. timers: accumulates "readback_masks" (the wait)
    and "unpack" (the paste; nothing to unpack here)."""
    kind, copy, extra = handle
    t0 = time.perf_counter()
    arr = _wait(copy)
    t1 = time.perf_counter()
    if kind == "crops":
        y0, x0, h, w = extra
        win = WindowMasks(crops=arr, y0=np.asarray(y0), x0=np.asarray(x0), height=h, width=w)
        out = win if as_window else win.paste()
    else:
        out = arr
    if timers is not None:
        timers["readback_masks"] += t1 - t0
        timers["unpack"] += time.perf_counter() - t1
    return out


def finalize_predictions(device_out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Apply the NMS keep mask and read the survivors back: scores (n,),
    labels (n,), masks (n, T, H, W) bool, as numpy, in score order (read
    as crops where that pays, and pasted)."""
    scores, labels, keep, boxes = read_small_bundle(device_out)
    handle = start_kept_masks_read(device_out, keep, boxes)
    return {"scores": scores[keep], "labels": labels[keep],
            "masks": finish_kept_masks_read(handle)}
