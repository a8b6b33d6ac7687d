"""The MSDA separable-sampling ablation (K6), plain PyTorch version.

Counterpart of `tools/bench_pallas_ablate.py:make`: the four variants of
one level's bilinear sampling that the ablation tool times to bisect the
MSDA kernel's cost. `vt` (ng, W*d, k) bf16 holds the level's W columns
times d channels as rows and its k rows as columns; each point p has a row
index `ya` with weights `wy0`/`wy1` (rows ya, ya+1) and a column index `x0`
with weights `wx0`/`wx1` (columns x0, x0+1). Output (ng, d, gqp) f32:

  empty        0
  dotonly      bf16(wy0) vt[i, c, ya] + bf16(wy1) vt[i, c, ya+1]
  noconstruct  0.5 vt[i, c, 0]
  full         wx0 C[x0] + wx1 C[x0+1], C[x] = bf16(wy0) vt[i, x d + c, ya]
               + bf16(wy1) vt[i, x d + c, ya+1]

A row index outside [0, k) and a column outside [0, W) contribute 0, as
the Pallas kernel's one-hot matrices. Written with gathers; each product
and sum rounds on its own in f32, the order `csrc/msda_ablate.cu` keeps.
"""
from __future__ import annotations

import torch

VARIANTS = ("empty", "dotonly", "noconstruct", "full")


def _rows(vt: torch.Tensor, row: torch.Tensor, ya: torch.Tensor, a0: torch.Tensor,
          a1: torch.Tensor) -> torch.Tensor:
    """a0 vt[i, row, ya] + a1 vt[i, row, ya+1] for rows (ng, R, gqp), each
    term 0 where its row index lies outside [0, k)."""
    ng, wd, k = vt.shape
    flat = vt.reshape(ng, wd * k)

    def term(col, weight):
        inside = (col >= 0) & (col < k)
        vals = torch.gather(flat, 1, (row * k + col.clamp(0, k - 1)).flatten(1)).view(row.shape)
        return torch.where(inside, weight * vals.float(), torch.zeros((), device=vt.device))

    return term(ya, a0) + term(ya + 1, a1)


def msda_ablate_plain(variant: str, vt, ya, wy0, wy1, x0, wx0, wx1, w: int, d: int
                      ) -> torch.Tensor:
    """(ng, d, gqp) f32; shapes and types as the module docstring."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    ng, wd, k = vt.shape
    gqp = ya.shape[-1]
    if wd != w * d:
        raise ValueError(f"vt has {wd} rows, expected W*d = {w}*{d}")
    dev = vt.device
    if variant == "empty":
        return torch.zeros((ng, d, gqp), dtype=torch.float32, device=dev)
    if variant == "noconstruct":
        return (0.5 * vt[:, :d, :1].float()).expand(ng, d, gqp).contiguous()
    chan = torch.arange(d, device=dev)[None, :, None]
    a0 = wy0.to(torch.bfloat16).float()
    a1 = wy1.to(torch.bfloat16).float()
    ya = ya.long()
    if variant == "dotonly":
        return _rows(vt, chan.expand(ng, d, gqp), ya, a0, a1)
    x0 = x0.long()

    def column(x, weight):
        inside = (x >= 0) & (x < w)
        row = x.clamp(0, w - 1) * d + chan
        return torch.where(inside, weight * _rows(vt, row, ya, a0, a1),
                           torch.zeros((), device=dev))

    return column(x0, wx0) + column(x0 + 1, wx1)
