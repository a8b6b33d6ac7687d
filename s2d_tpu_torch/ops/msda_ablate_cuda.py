"""The MSDA separable-sampling ablation (K6) on its hand-written CUDA kernel.

`csrc/msda_ablate.cu` replaces the TPU kernel
`tools/bench_pallas_ablate.py:make` -> `kernel`; its header says what
bounds it on the card and how it is laid out. `msda_ablate` launches it for
CUDA tensors (or raises) and takes the plain version
`ops/msda_ablate.msda_ablate_plain` for CPU tensors. `LAUNCHES` counts the
launches of each variant.
"""
from __future__ import annotations

import torch

from .. import _build
from .msda_ablate import VARIANTS, msda_ablate_plain

LAUNCHES = dict.fromkeys(VARIANTS, 0)  # kernel launches per variant since the last reset


def msda_ablate(variant: str, vt, ya, wy0, wy1, x0, wx0, wx1, w: int, d: int) -> torch.Tensor:
    """(ng, d, gqp) f32. vt (ng, W*d, k) bf16 with d and k multiples of 8 on
    a card; ya, x0 (ng, 1, gqp) int32; wy0, wy1, wx0, wx1 (ng, 1, gqp) f32;
    all contiguous on one device."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if not vt.is_cuda:
        return msda_ablate_plain(variant, vt, ya, wy0, wy1, x0, wx0, wx1, w, d)
    ng, wd, k = vt.shape
    if wd != w * d:
        raise ValueError(f"vt has {wd} rows, expected W*d = {w}*{d}")
    if vt.dtype != torch.bfloat16:
        raise TypeError(f"vt must be bfloat16, got {vt.dtype}")
    if d % 8 or k % 8:  # the kernel moves 8 channels (16 bytes) of vt at a time
        raise ValueError(f"d = {d} and k = {k} must be multiples of 8")
    points = {"ya": (ya, torch.int32), "x0": (x0, torch.int32), "wy0": (wy0, torch.float32),
              "wy1": (wy1, torch.float32), "wx0": (wx0, torch.float32),
              "wx1": (wx1, torch.float32)}
    gqp = ya.shape[-1]
    for name, (t, dtype) in points.items():
        if t.dtype != dtype or tuple(t.shape) != (ng, 1, gqp):
            raise TypeError(f"{name} must be {dtype} of shape {(ng, 1, gqp)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("vt", vt), *((n, t) for n, (t, _) in points.items())):
        if t.device != vt.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vt.device}")
    out = torch.empty((ng, d, gqp), dtype=torch.float32, device=vt.device)
    rc = _build.library().s2d_msda_ablate(
        VARIANTS.index(variant), vt.data_ptr(), ya.data_ptr(), wy0.data_ptr(), wy1.data_ptr(),
        x0.data_ptr(), wx0.data_ptr(), wx1.data_ptr(), out.data_ptr(),
        ng, wd, k, gqp, w, d, _build.stream_handle(vt),
    )
    _build.check(rc, "s2d_msda_ablate")
    LAUNCHES[variant] += 1
    return out
