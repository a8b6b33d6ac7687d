"""Mask-IoU NMS: the exact IoU product and greedy suppression on CUDA.

Counterpart of `s2d_tpu/ops/nms.py`. `greedy_mask_nms` launches
`csrc/nms.cu`, which replaces the TPU kernel `_nms_kernel` (K4), for CUDA
tensors and takes the plain loop `greedy_mask_nms_plain` for CPU tensors.

`mask_iou_matrix` stays a matrix product, as in JAX where XLA computes it
outside any kernel. It must be exact: the keep-set flips at the 0.75
threshold if the counts round. JAX multiplies bf16 0/1 operands with f32
accumulation; in PyTorch a bf16 matmul RETURNS bf16 and would round the
counts, so the port multiplies f32 0/1 operands with TF32 off, exact while
a count stays below 2^24. Past that (T*H*W >= 2^24, e.g. T=72 at 720x1280)
it accumulates per frame, each frame's product exact, in float64.
"""
from __future__ import annotations

import torch

from .. import _build

MAX_CANDIDATES = 1024  # the removed set: 32 lanes of one warp x 32 bits
EXACT_F32 = 1 << 24

LAUNCHES = 0  # kernel launches since the last reset


def _exact_gram(flat: torch.Tensor) -> torch.Tensor:
    """flat (N, X) f32 0/1 -> flat @ flat.T with full-f32 (not TF32) math."""
    if not flat.is_cuda:
        return flat @ flat.T
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return flat @ flat.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mask_iou_matrix(masks: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W) bool masks -> (N, N) f32 track IoU (0 where the union is
    empty)."""
    n, t = masks.shape[0], masks.shape[1]
    flat = masks.reshape(n, t, -1)
    if t * flat.shape[2] < EXACT_F32:
        whole = flat.reshape(n, -1).float()
        inter = _exact_gram(whole)
        area = whole.sum(dim=1)
        union = area[:, None] + area[None, :] - inter
        return torch.where(union > 0, inter / union.clamp_min(1.0), torch.zeros_like(union))
    inter = torch.zeros((n, n), dtype=torch.float64, device=masks.device)
    area = torch.zeros((n,), dtype=torch.float64, device=masks.device)
    for ti in range(t):
        frame = flat[:, ti].float()
        inter += _exact_gram(frame).double()
        area += frame.sum(dim=1).double()
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / union.clamp_min(1.0), torch.zeros_like(union))
    return iou.float()


def greedy_mask_nms_plain(
    iou: torch.Tensor, labels: torch.Tensor, threshold: float
) -> torch.Tensor:
    """The loop of `s2d_tpu/ops/nms.py:116-125` in torch, on any device."""
    n = iou.shape[0]
    idx = torch.arange(n, device=iou.device)
    keep = torch.ones((n,), dtype=torch.bool, device=iou.device)
    for i in range(n):
        suppress = (iou[i] > threshold) & (labels == labels[i]) & (idx > i) & keep[i]
        keep &= ~suppress
    return keep


def greedy_mask_nms(
    iou: torch.Tensor, labels: torch.Tensor, threshold: float
) -> torch.Tensor:
    """Sequential greedy NMS over score-sorted candidates: candidate j is
    dropped iff a still-kept earlier candidate of its label has IoU > the
    threshold with it. iou (N, N) f32, labels (N,) int (the kernel reads
    int64, the postprocess's type, without a conversion). Returns (N,) bool."""
    global LAUNCHES
    if not iou.is_cuda:
        return greedy_mask_nms_plain(iou, labels, threshold)
    n = iou.shape[0]
    if tuple(iou.shape) != (n, n) or tuple(labels.shape) != (n,):
        raise ValueError(f"iou {tuple(iou.shape)}, labels {tuple(labels.shape)}")
    if not 0 < n <= MAX_CANDIDATES:
        raise ValueError(f"{n} candidates; the kernel takes 1..{MAX_CANDIDATES}")
    if iou.dtype != torch.float32 or not iou.is_contiguous():
        raise TypeError(f"iou must be contiguous float32, got {iou.dtype}")
    if labels.device != iou.device or labels.is_floating_point():
        raise TypeError(f"labels must be integer on {iou.device}")
    labels = labels.to(torch.int64).contiguous()  # no copy for the postprocess's labels
    keep = torch.empty((n,), dtype=torch.bool, device=iou.device)
    rc = _build.library().s2d_greedy_nms(
        iou.data_ptr(), labels.data_ptr(), keep.data_ptr(), n, float(threshold),
        _build.stream_handle(iou),
    )
    _build.check(rc, "s2d_greedy_nms")
    LAUNCHES += 1
    return keep


def empty_launch(device) -> None:
    """Launch an empty kernel on `device`'s current stream: the device time
    of a launch, the floor K4's time is held against (it does no work a
    byte bound would see)."""
    _build.check(_build.library().s2d_empty_launch(
        torch.cuda.current_stream(device).cuda_stream), "s2d_empty_launch")
