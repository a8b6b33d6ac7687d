"""Random-phase lattice point sampling, as `s2d_tpu/ops/lattice.py`.

The criterion's point losses and costs are Monte-Carlo estimates over a
point pool. In lattice mode (MODEL.MASK_FORMER.POINT_SAMPLING lattice) the
pool is an (Ly, Lx) lattice whose axes are integer multiples or divisors of
every map's axis, shifted by one random phase (u, v) ~ U[0, 1)^2 a step:
y_i = (i + u) / Ly, x_j = (j + v) / Lx. Sampling a map at every lattice
point is then separable bilinear interpolation with an integer scale per
axis: a blend of shifted slices (upsampling) or of strided ones
(downsampling), with zeros outside (`F.grid_sample`'s align_corners=False
convention). The blends are JAX's, op for op; `lattice_coords` gives the
points for a sampler that takes coordinates.
"""
from __future__ import annotations

import functools
import math
from typing import Iterable, Tuple

import torch
import torch.nn.functional as F


def valid_axis_counts(sizes: Iterable[int], max_mult: int = 16) -> list:
    """Axis lengths L compatible with every map axis length n in `sizes`:
    L % n == 0 (integer upsampling) or n % L == 0 (integer downsampling)."""
    sizes = sorted(set(int(s) for s in sizes))
    cands = set()
    for n in sizes:
        for m in range(1, max_mult + 1):
            cands.add(n * m)
        for d in range(1, n + 1):
            if n % d == 0:
                cands.add(n // d)
    return sorted(L for L in cands if L > 0 and all(L % n == 0 or n % L == 0 for n in sizes))


@functools.lru_cache(maxsize=None)
def choose_lattice(target_count: int, hs: Tuple[int, ...], ws: Tuple[int, ...]) -> Tuple[int, int]:
    """(Ly, Lx) valid for all (hs, ws): the count nearest `target_count` in
    log space plus a cost on the largest upsampling factor (an m-fold axis
    is m blends); ties prefer the maps' aspect, then the larger pool, then
    the larger Ly."""
    rows = valid_axis_counts(hs)
    cols = valid_axis_counts(ws)
    aspect = max(hs) / max(ws)

    def max_mult(L, sizes):
        return max((L // n if L % n == 0 else 1) for n in sizes)

    best, best_key = None, None
    for ly in rows:
        for lx in cols:
            s = ly * lx
            cost = abs(math.log(s / target_count)) + 0.05 * max(max_mult(ly, hs), max_mult(lx, ws))
            key = (round(cost, 6), abs(math.log((ly / lx) / aspect)), -s, -ly)
            if best_key is None or key < best_key:
                best, best_key = (ly, lx), key
    if best is None:
        raise ValueError(f"no valid lattice for hs={hs} ws={ws}")
    return best


def upsample_blend_weights(r: int, phase: torch.Tensor, m: int, dtype=torch.float32):
    """The weights of source taps -1, 0, +1 for output residue r of an m-fold
    upsampling at `phase`: output position q + (r + phase) / m - 0.5."""
    delta = (r + phase) / m - 0.5  # in [-0.5, 0.5)
    f = torch.floor(delta)  # -1 or 0
    frac = (delta - f).to(dtype)
    is_m1 = (f < -0.5).to(dtype)
    w_m1 = (1.0 - frac) * is_m1
    w_0 = frac * is_m1 + (1.0 - frac) * (1.0 - is_m1)
    w_p1 = frac * (1.0 - is_m1)
    return w_m1, w_0, w_p1


def _pad_axis(x: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    pad = [0, 0] * (x.dim() - 1 - axis) + [before, after]
    return F.pad(x, pad)


def _interp_axis(x: torch.Tensor, axis: int, L: int, phase: torch.Tensor) -> torch.Tensor:
    """Resample `axis` (length n) of x at L lattice positions: output i
    samples source coordinate (i + phase) / L in [0, 1], pixel position
    (i + phase) / L * n - 0.5, zeros outside. Needs L % n == 0 or n % L == 0."""
    axis = axis % x.dim()
    n = x.shape[axis]
    phase = phase.float()
    if L % n == 0:
        m = L // n
        xm1 = _pad_axis(x.narrow(axis, 0, n - 1), axis, 1, 0)
        xp1 = _pad_axis(x.narrow(axis, 1, n - 1), axis, 0, 1)
        outs = []
        for r in range(m):
            w_m1, w_0, w_p1 = upsample_blend_weights(r, phase, m, x.dtype)
            outs.append(w_m1 * xm1 + w_0 * x + w_p1 * xp1)
        shape = list(x.shape)
        shape[axis] = L
        return torch.stack(outs, dim=axis + 1).reshape(shape)
    if n % L == 0:
        d = n // L
        off = phase * d - 0.5  # a constant fractional offset j*d + off
        c = torch.floor(off)  # in [-1, d-1]
        frac = (off - c).to(x.dtype)
        xp = _pad_axis(x, axis, 1, d)
        idx = (c + 1).long() + d * torch.arange(L, device=x.device)
        v0 = xp.index_select(axis, idx)
        v1 = xp.index_select(axis, idx + 1)
        return (1.0 - frac) * v0 + frac * v1
    raise ValueError(f"axis length {n} incompatible with lattice {L}")


def lattice_sample(maps: torch.Tensor, ly: int, lx: int, phase: torch.Tensor) -> torch.Tensor:
    """(R, H, W) maps sampled bilinearly at every (ly, lx) lattice point at
    `phase` = (u_y, u_x) in [0, 1): (R, ly, lx). Equal to
    `grid_sample_rows` at `lattice_coords`, as slice blends."""
    return _interp_axis(_interp_axis(maps, 1, ly, phase[0]), 2, lx, phase[1])


def lattice_coords(ly: int, lx: int, phase: torch.Tensor) -> torch.Tensor:
    """The (ly * lx, 2) xy coordinates in [0, 1] of the lattice, row-major."""
    ys = (torch.arange(ly, device=phase.device) + phase[0]) / ly
    xs = (torch.arange(lx, device=phase.device) + phase[1]) / lx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
