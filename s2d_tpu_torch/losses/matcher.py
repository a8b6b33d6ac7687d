"""Hungarian matching between queries and padded video targets, as
`s2d_tpu/losses/matcher.py`.

Costs on one shared set of points per video (memory-efficient matching):

  cost = cost_mask * batch_sigmoid_ce + cost_class * (-prob[class 0])
       + cost_dice * batch_dice

in float32 (the reference matcher is an autocast-off island). The assignment
is solved on the device by the auction (`ops/auction.py`: the K5 kernel for
CUDA tensors); `hungarian_assign_scipy` is the host oracle, for tests.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.auction import auction_assign
from ..ops.sampling import grid_sample_rows


def batch_sigmoid_ce_cost(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(Q, P) logits x (N, P) targets -> (Q, N) mean BCE cost."""
    p = logits.shape[-1]
    pos = F.softplus(-logits)  # BCE(x, 1)
    neg = F.softplus(logits)  # BCE(x, 0)
    return (pos @ targets.T + neg @ (1.0 - targets).T) / p


def batch_dice_cost(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(Q, P) logits x (N, P) targets -> (Q, N) dice cost."""
    probs = torch.sigmoid(logits)
    numerator = 2.0 * (probs @ targets.T)
    denominator = probs.sum(-1)[:, None] + targets.sum(-1)[None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def hungarian_assign(cost: torch.Tensor, valid: torch.Tensor | None = None,
                     impl: str = "cuda") -> torch.Tensor:
    """cost (B, Q, N) -> (B, N) int32: the matched query of each target slot;
    `valid` (B, N) marks the real target columns."""
    return auction_assign(cost, valid, impl=impl)


def hungarian_assign_scipy(cost: torch.Tensor) -> torch.Tensor:
    """Batched scipy LSA on the host (tests only): (B, Q, N) -> (B, N)."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().cpu().double().numpy()
    out = np.zeros((c.shape[0], c.shape[2]), dtype=np.int32)
    for i in range(c.shape[0]):
        rows, cols = linear_sum_assignment(c[i])
        out[i, cols] = rows
    return torch.from_numpy(out)


def match_costs(
    pred_logits: torch.Tensor,  # (B, Q, K+1)
    tgt_masks_points: torch.Tensor,  # (B, N, P) point-sampled targets
    pred_masks_points: torch.Tensor,  # (B, Q, P) point-sampled predictions
    cost_class: float,
    cost_mask: float,
    cost_dice: float,
) -> torch.Tensor:
    """The (B, Q, N) cost matrices; invalid target columns are left to the
    assignment solver."""
    prob0 = torch.softmax(pred_logits.float(), dim=-1)[..., 0]
    pm, tm = pred_masks_points.float(), tgt_masks_points.float()
    cost = torch.stack([
        cost_mask * batch_sigmoid_ce_cost(pm[i], tm[i]) + cost_dice * batch_dice_cost(pm[i], tm[i])
        for i in range(pm.shape[0])
    ])
    return cost + cost_class * -prob0[:, :, None]


def sample_match_points(
    coords: torch.Tensor,  # (B, P, 2) uniform in [0, 1]
    pred_masks: torch.Tensor,  # (B, Q, T, H', W')
    tgt_masks: torch.Tensor,  # (B, N, T, H, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One point set per video for both predictions and targets (T folded
    into the channels): (pred (B, Q, T*P), tgt (B, N, T*P))."""

    def shared_sample(maps, pts):  # (C', H, W), (P, 2) -> (C', P)
        c, h, w = maps.shape
        rows = maps.reshape(c, h * w).T.contiguous()[None]
        return grid_sample_rows(rows, (2.0 * pts - 1.0)[None], h, w)[0].T

    preds, tgts = [], []
    for pm, tm, pts in zip(pred_masks, tgt_masks, coords):
        q, t = pm.shape[:2]
        n = tm.shape[0]
        preds.append(shared_sample(pm.reshape(q * t, *pm.shape[2:]), pts).reshape(q, -1))
        tgts.append(shared_sample(tm.to(pm.dtype).reshape(n * t, *tm.shape[2:]), pts).reshape(n, -1))
    return torch.stack(preds), torch.stack(tgts)
