"""DETR-style set criterion for video masks, as `s2d_tpu/losses/criterion.py`.

Per decoder layer (the final one and every aux one) the predictions are
matched to the targets (`matcher.py`, one batched auction for all layers
and, in `set_criterion_pair`, both criteria), then scored:

  * loss_ce (final layer only): cross-entropy over all queries, matched
    queries class 0, the rest no-object weighted by eos_coef;
  * loss_mask / loss_dice: PointRend-style point losses over ONE shared iid
    pool of num_points * oversample_ratio uniform points per step (common
    to layers and criteria): per (prediction, target, frame) row, weight 1
    on the importance_sample_ratio most uncertain pool points (a bisected
    threshold, `_uncertainty_threshold`) plus a shared Bernoulli thinning
    of the pool for the random points, normalized by the realized count;
  * temporal DropLoss ("masks-only"): rows whose target is empty in a frame
    contribute nothing; num_masks = max(valid targets / world size, 1).

Both normalizers (num_masks and loss_ce's weight sum) are over the batch.
In a process group each rank scores its part of the global batch: given
`reduce` (a sum over the ranks), the normalizers are the global batch's, so
that the ranks' losses sum to the loss of the global batch and their
gradients to its gradient, as JAX computes it over the global batch.

With `point_sampling="lattice"` (MODEL.MASK_FORMER.POINT_SAMPLING) the
pools are random-phase lattices instead (`ops/lattice.py`): the loss pool
and the matcher's pool each an (Ly, Lx) lattice of about their nominal
counts, valid for the prediction and target resolutions, at one phase
pair per step; the uncertainty threshold of a pool of 8192 points or more
counts on a strided subsample (a lattice's prefix is a spatial band).

The random draws (the pool or the lattice phases, the Bernoulli weights)
come from an explicit `torch.Generator`, or are given (`draws`), which the
parity tests use to feed JAX's own draws. Each layer's point loss runs under
`torch.utils.checkpoint`, so that one layer's (R, S) pool is alive at a time.

The TPU structure is not ported: the one-hot form of the pool gather's
backward (a scatter here, `_PoolSample`) and the `lax.scan` over layers.
Under AMP (`gather_dtype` bf16) the loss chain runs in bf16 with float32
reductions, as in JAX: the prediction samples are taken in bf16 with each
bilinear term rounded, and the target values at the pool are held in bf16.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.lattice import choose_lattice, lattice_sample
from ..ops.sampling import corner_terms, grid_sample_rows
from .matcher import hungarian_assign


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 1
    eos_coef: float = 0.1
    cost_class: float = 0.0
    cost_mask: float = 5.0
    cost_dice: float = 5.0
    num_points: int = 12544
    matcher_num_points: int = 0  # 0: num_points (the reference's count)
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    masks_only: bool = True  # temporal DropLoss
    world_size: int = 1
    gather_dtype: torch.dtype = torch.float32  # the loss chain's dtype (bf16 under AMP)
    point_sampling: str = "iid"  # "iid" | "lattice"
    assign_impl: str = "cuda"  # auction: "cuda" (K5 on a CUDA tensor) | "plain"


def pool_size(cfg: CriterionConfig) -> int:
    return int(cfg.num_points * cfg.oversample_ratio)


def num_random_points(cfg: CriterionConfig) -> int:
    return cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points)


def draw_pool(cfg: CriterionConfig, generator: torch.Generator, device) -> torch.Tensor:
    """(S, 2) iid uniform pool points in [0, 1]."""
    return torch.rand((pool_size(cfg), 2), generator=generator, device=device)


def draw_bernoulli(cfg: CriterionConfig, rows: int, generator: torch.Generator,
                   device, s: int | None = None) -> torch.Tensor:
    """(rows, S) bool: the shared random-point thinning of the pool of S
    points (default: the iid pool's size)."""
    s = s or pool_size(cfg)
    return torch.rand((rows, s), generator=generator, device=device) < (num_random_points(cfg) / s)


class _PoolSample(torch.autograd.Function):
    """(R, H, W) maps -> (R, S) samples at the shared pool, in `dtype`: the
    maps are cast to `dtype` and each weighted corner term is rounded to it,
    as JAX's `_pool_gather`. Its backward scatters the gradient times the
    `dtype` corner weights with float32 sums and rounds the result to
    `dtype` once, as JAX's one-hot contraction does; the pool gets none."""

    @staticmethod
    def forward(ctx, maps, pool, dtype):
        r, h, w = maps.shape
        ctx.save_for_backward(pool)
        ctx.meta = (r, h, w, dtype, maps.dtype)
        rows = maps.to(dtype).reshape(r, h * w).T.contiguous()[None]  # (1, HW, R)
        return grid_sample_rows(rows, (2.0 * pool - 1.0)[None], h, w)[0].T

    @staticmethod
    def backward(ctx, grad):
        (pool,) = ctx.saved_tensors
        r, h, w, dtype, maps_dtype = ctx.meta
        g = grad.T.contiguous().float()  # (S, R) rows for the scatter
        d_rows = torch.zeros((h * w, r), dtype=torch.float32, device=grad.device)
        for idx, weight in corner_terms(2.0 * pool - 1.0, h, w):
            d_rows.index_add_(0, idx, g * weight.to(dtype).float()[:, None])
        return d_rows.to(dtype).T.reshape(r, h, w).to(maps_dtype), None, None


def _lane_packed_sample(maps: torch.Tensor, pool: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(R, H, W) maps sampled at the shared (S, 2) pool -> (R, S) in
    `dtype`, differentiable in the maps."""
    return _PoolSample.apply(maps.float(), pool, dtype)


def _uncertainty_threshold(values: torch.Tensor, k: int, subsample: int = 32768,
                           iters: int = 20, sub: torch.Tensor | None = None) -> torch.Tensor:
    """(R, S) -> (R, 1) estimate of each row's k-th largest value: exact by
    top-k below 8192 columns, else bisected on `sub` (default: the pool
    prefix, an iid subsample of an iid pool) for the threshold whose
    exceedance count is k."""
    s = values.shape[-1]
    if s < 8192:
        return torch.topk(values, min(k, s), dim=-1).values[..., -1:]
    if sub is None:
        sub = values[..., : min(subsample, s)]
    k_sub = torch.tensor(k * (sub.shape[-1] / s), dtype=torch.float32, device=values.device)
    lo = sub.amin(dim=-1, keepdim=True).float()
    hi = sub.amax(dim=-1, keepdim=True).float()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = (sub >= mid).sum(dim=-1, keepdim=True).float() > k_sub
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    return lo


def _loss_masks(
    src_masks: torch.Tensor,  # (B, N, T, H', W') matched prediction logits
    pool: torch.Tensor,  # (S, 2), or the (2,) lattice phase
    pool_tgt: torch.Tensor,  # (R, S) target values at the pool
    bern_wts: torch.Tensor,  # (R, S) bool
    row_keep: torch.Tensor,  # (B, N, T) bool
    num_masks: torch.Tensor,  # scalar
    cfg: CriterionConfig,
    lattice: Tuple[int, int] | None = None,  # (Ly, Lx) when `pool` is a phase
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-sampled sigmoid BCE and dice over the shared pool."""
    b, n, t = src_masks.shape[:3]
    rows_src = src_masks.reshape(b * n * t, *src_masks.shape[3:])
    keep = row_keep.reshape(b * n * t).float()
    wd = cfg.gather_dtype
    if lattice is not None:
        pool_src = lattice_sample(rows_src.float().to(wd), *lattice, pool).reshape(b * n * t, -1)
    else:
        pool_src = _lane_packed_sample(rows_src, pool, wd)  # (R, S), grads flow
    num_uncertain = int(cfg.importance_sample_ratio * cfg.num_points)
    uncertainty = -pool_src.detach().abs()
    wts = bern_wts.to(wd)
    if num_uncertain > 0:
        sub = None
        s = uncertainty.shape[-1]
        if lattice is not None and s >= 8192:
            # a lattice's prefix is a spatial band: take a strided subsample,
            # its stride coprime with Lx (else it walks a periodic column set)
            stride = max(1, s // 32768)
            while stride > 1 and math.gcd(stride, lattice[1]) != 1:
                stride += 1
            sub = uncertainty[..., ::stride]
        thr = _uncertainty_threshold(uncertainty, num_uncertain, sub=sub)
        wts = wts + (uncertainty >= thr).to(wd)
    count = torch.clamp(wts.sum(dim=1, dtype=torch.float32), min=1.0)

    tgt = pool_tgt.to(wd)
    ce = (torch.maximum(pool_src, pool_src.new_zeros(())) - pool_src * tgt
          + F.softplus(-pool_src.abs()))
    loss_mask = (((ce * wts).sum(dim=1, dtype=torch.float32) / count) * keep).sum() / num_masks

    probs = torch.sigmoid(pool_src)
    numerator = 2.0 * (probs * tgt * wts).sum(dim=1, dtype=torch.float32)
    denominator = ((probs * wts).sum(dim=1, dtype=torch.float32)
                   + (tgt * wts).sum(dim=1, dtype=torch.float32))
    dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    loss_dice = (dice * keep).sum() / num_masks
    return loss_mask, loss_dice


def _label_targets(pred_logits: torch.Tensor, assign: torch.Tensor, tgt_valid: torch.Tensor,
                   cfg: CriterionConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(target class, weight) of each query: class 0 where matched to a
    valid target (weight 1), else no-object (weight eos_coef)."""
    b, q, _ = pred_logits.shape
    k = cfg.num_classes
    matched = torch.zeros((b, q), dtype=torch.float32, device=pred_logits.device)
    matched.scatter_add_(1, assign.long(), tgt_valid.float())
    target_cls = torch.where(matched > 0, 0, k)
    return target_cls, torch.where(target_cls == k, cfg.eos_coef, 1.0)


def _loss_labels(pred_logits: torch.Tensor, assign: torch.Tensor, tgt_valid: torch.Tensor,
                 cfg: CriterionConfig, weight_sum: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy over the queries, normalized by `weight_sum` (the
    global batch's) or this batch's sum of the weights."""
    target_cls, weight = _label_targets(pred_logits, assign, tgt_valid, cfg)
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    nll = -logp.gather(-1, target_cls[..., None])[..., 0]
    return (nll * weight).sum() / (weight.sum() if weight_sum is None else weight_sum)


def _layer_outputs(outputs) -> List[Tuple[Optional[int], torch.Tensor, torch.Tensor]]:
    return [(None, outputs["pred_logits"], outputs["pred_masks"])] + [
        (i, l, m) for i, (l, m) in enumerate(
            zip(outputs.get("aux_pred_logits", []), outputs.get("aux_pred_masks", [])))
    ]


def _criterion_costs_multi(
    outputs: Dict[str, torch.Tensor],
    target_sets: List[Tuple[torch.Tensor, torch.Tensor, CriterionConfig]],
    generator: torch.Generator | None = None,
    draws: Dict | None = None,
) -> List[Dict]:
    """Everything before the assignment solve, for one set of predictions
    scored against one or more target sets: the shared pool and Bernoulli
    draws, the per-set target values at the pool, the per-layer cost
    matrices (one prediction sampling per layer, shared by the sets) and
    the loss-side context. `draws` = {"pool": (S, 2) or, in lattice mode,
    "phases": (2, 2) (the loss pool's phase, then the matcher's), "bern":
    {rows: (rows, S) bool}} replaces the generator's draws."""
    cfg0 = target_sets[0][2]
    for _, _, c in target_sets:
        if c.point_sampling not in ("iid", "lattice"):
            raise ValueError(f"unknown point_sampling {c.point_sampling!r}")
        if (c.num_points, c.oversample_ratio, c.matcher_num_points, c.point_sampling) != (
                cfg0.num_points, cfg0.oversample_ratio, cfg0.matcher_num_points,
                cfg0.point_sampling):
            raise ValueError("target sets sharing one pool must agree on its size")
    layers = _layer_outputs(outputs)
    device = outputs["pred_masks"].device
    num_sampled = pool_size(cfg0)
    p = cfg0.matcher_num_points or cfg0.num_points
    if p > num_sampled:
        raise ValueError("matcher_num_points must fit inside the shared oversample pool")
    draws = draws or {}
    lat_loss = lat_match = None
    if cfg0.point_sampling == "lattice":
        tgt_hw = {tuple(tm.shape[-2:]) for tm, _, _ in target_sets}
        if len(tgt_hw) != 1:
            raise ValueError("lattice point sampling needs all target sets at one resolution")
        (h_t, w_t), (h_p, w_p) = next(iter(tgt_hw)), tuple(outputs["pred_masks"].shape[-2:])
        lat_loss = choose_lattice(num_sampled, (h_p, h_t), (w_p, w_t))
        lat_match = choose_lattice(p, (h_p, h_t), (w_p, w_t))
        num_sampled, p = lat_loss[0] * lat_loss[1], lat_match[0] * lat_match[1]
        phases = (draws["phases"] if "phases" in draws
                  else torch.rand((2, 2), generator=generator, device=device))
        pool, phase_match = phases[0], phases[1]  # the loss pool's handle is its phase

        def sample_match(rows):
            return lattice_sample(rows, *lat_match, phase_match)
    else:
        pool = draws["pool"] if "pool" in draws else draw_pool(cfg0, generator, device)
        pool_p = pool[:p]

        def sample_match(rows):
            return _lane_packed_sample(rows, pool_p)

    per_set = []
    with torch.no_grad():
        for tgt_masks, _, cfg in target_sets:
            bsz, nsl, t = tgt_masks.shape[:3]
            rows_tgt = tgt_masks.reshape(bsz * nsl * t, *tgt_masks.shape[3:])
            if lat_loss is not None:
                # the loss pool in gather_dtype, the matcher's values in f32
                pool_tgt = lattice_sample(rows_tgt.to(cfg.gather_dtype), *lat_loss, pool)
                pool_tgt = pool_tgt.reshape(bsz * nsl * t, num_sampled)
                tgt_pts = sample_match(rows_tgt.float()).reshape(bsz, nsl, t * p)
                per_set.append((pool_tgt, tgt_pts))
                continue
            pool_tgt = _lane_packed_sample(rows_tgt, pool)  # (R, S) f32
            tgt_pts = pool_tgt.reshape(bsz, nsl, t, num_sampled)[..., :p].reshape(bsz, nsl, t * p)
            # the matcher reads the f32 values, the losses their gather_dtype
            # cast (JAX casts in _loss_masks: the same values, held once)
            per_set.append((pool_tgt.to(cfg.gather_dtype), tgt_pts))
        bsz = target_sets[0][0].shape[0]
        set_n = [tgt_pts.shape[1] for _, tgt_pts in per_set]
        set_off = [sum(set_n[:i]) for i in range(len(set_n))]
        rhs = torch.cat([tgt_pts for _, tgt_pts in per_set], dim=1)  # (B, sum N, T*P)
        rhs_sum = rhs.sum(-1)

        costs: List[List[torch.Tensor]] = [[] for _ in target_sets]
        for _, logits, masks in layers:
            q, tm = masks.shape[1], masks.shape[2]
            rows = masks.float().reshape(bsz * q * tm, *masks.shape[3:])
            pmp = sample_match(rows).reshape(bsz, q, tm * p)
            # pos @ tgt + neg @ (1 - tgt) = (-x) @ tgt + rowsum(softplus(x))
            neg_rowsum = F.softplus(pmp).sum(-1)
            probs = torch.sigmoid(pmp)
            packed = torch.cat([-pmp, probs], dim=1) @ rhs.transpose(1, 2)  # (B, 2Q, sum N)
            probs_sum = probs.sum(-1)
            ptot = pmp.shape[-1]
            for i, ((_, _, cfg_i), off, n_i) in enumerate(zip(target_sets, set_off, set_n)):
                lin = packed[:, :q, off: off + n_i]
                dice_num = packed[:, q:, off: off + n_i]
                ce = (lin + neg_rowsum[:, :, None]) / ptot
                denom = probs_sum[:, :, None] + rhs_sum[:, None, off: off + n_i]
                dice = 1.0 - (2.0 * dice_num + 1.0) / (denom + 1.0)
                cost_i = cfg_i.cost_mask * ce + cfg_i.cost_dice * dice
                if cfg_i.cost_class:
                    prob0 = torch.softmax(logits.float(), dim=-1)[..., 0]
                    cost_i = cost_i + cfg_i.cost_class * -prob0[:, :, None]
                costs[i].append(cost_i)

    n_layers = len(layers)
    bern_cache = dict(draws.get("bern", {}))
    states = []
    for (tgt_masks, tgt_valid, cfg), (pool_tgt, _), cost_list in zip(target_sets, per_set, costs):
        bsz, nsl, t = tgt_masks.shape[:3]
        stacked_cost = torch.stack(cost_list).reshape(n_layers * bsz, *cost_list[0].shape[1:])
        stacked_valid = tgt_valid.repeat(n_layers, 1)
        if cfg.masks_only:
            empty = tgt_masks.reshape(bsz, nsl, t, -1).sum(-1) == 0
            row_keep = tgt_valid[:, :, None] & ~empty
        else:
            row_keep = tgt_valid[:, :, None].expand(bsz, nsl, t)
        rows = bsz * nsl * t
        if num_random_points(cfg) > 0:
            if rows not in bern_cache:
                bern_cache[rows] = draw_bernoulli(cfg, rows, generator, device, num_sampled)
            bern_wts = bern_cache[rows]
        else:
            bern_wts = torch.zeros((rows, num_sampled), dtype=torch.bool, device=device)
        states.append({
            "stacked_cost": stacked_cost,
            "stacked_valid": stacked_valid,
            "n_layers": n_layers,
            "b": bsz,
            "layers": layers,
            "tgt_valid": tgt_valid,
            "pool": pool,
            "lattice": lat_loss,
            "pool_tgt": pool_tgt,
            "bern_wts": bern_wts,
            "row_keep": row_keep,
        })
    return states


def _batch_sums(state: Dict, assigns: torch.Tensor, cfg: CriterionConfig) -> torch.Tensor:
    """(valid targets, the final layer's loss_ce weight sum) of this batch."""
    _, weight = _label_targets(state["layers"][0][1], assigns[0], state["tgt_valid"], cfg)
    return torch.stack([state["tgt_valid"].sum().float(), weight.sum()])


def _normalized(states_assigns, reduce) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(num_masks, loss_ce weight sum) of each (state, assigns, cfg), over
    the global batch: this batch's sums summed over the ranks by `reduce`
    (one call for all criteria), or this batch's alone."""
    sums = torch.cat([_batch_sums(st, a, cfg) for st, a, cfg in states_assigns])
    if reduce is not None:
        sums = reduce(sums)
    return [(torch.clamp(sums[2 * i] / cfg.world_size, min=1.0), sums[2 * i + 1])
            for i, (_, _, cfg) in enumerate(states_assigns)]


def _criterion_losses(state: Dict, assigns: torch.Tensor, cfg: CriterionConfig,
                      compute_labels_loss: bool,
                      norms: Tuple[torch.Tensor, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-layer losses from the (L, B, N) assignments, normalized by
    `norms` (num_masks, loss_ce's weight sum); each layer's point loss is
    recomputed in the backward pass."""
    num_masks, weight_sum = norms
    losses: Dict[str, torch.Tensor] = {}
    for idx, (aux_i, logits, masks) in enumerate(state["layers"]):
        assign = assigns[idx].long()  # (B, N)
        batch = torch.arange(assign.shape[0], device=assign.device)[:, None]
        src = masks[batch, assign]  # (B, N, T, H', W')
        args = (src, state["pool"], state["pool_tgt"], state["bern_wts"],
                state["row_keep"], num_masks, cfg, state["lattice"])
        if torch.is_grad_enabled():
            loss_mask, loss_dice = checkpoint(_loss_masks, *args, use_reentrant=False,
                                              preserve_rng_state=False)
        else:
            loss_mask, loss_dice = _loss_masks(*args)
        suffix = "" if aux_i is None else f"_{aux_i}"
        losses[f"loss_mask{suffix}"] = loss_mask
        losses[f"loss_dice{suffix}"] = loss_dice
        if aux_i is None and compute_labels_loss:
            losses["loss_ce"] = _loss_labels(logits, assigns[idx], state["tgt_valid"], cfg,
                                             weight_sum)
    return losses


def set_criterion(
    outputs: Dict[str, torch.Tensor],
    tgt_masks: torch.Tensor,  # (B, N, T, H, W) bool
    tgt_valid: torch.Tensor,  # (B, N) bool
    cfg: CriterionConfig,
    compute_labels_loss: bool = True,
    generator: torch.Generator | None = None,
    draws: Dict | None = None,
    reduce=None,
) -> Dict[str, torch.Tensor]:
    """The criterion over the final and aux outputs. Keys: loss_ce,
    loss_mask, loss_dice and loss_{mask,dice}_{i} for aux layer i.
    `reduce`: a sum over the ranks of a process group (see the module doc)."""
    (st,) = _criterion_costs_multi(outputs, [(tgt_masks, tgt_valid, cfg)], generator, draws)
    assigns = hungarian_assign(st["stacked_cost"], st["stacked_valid"], impl=cfg.assign_impl)
    assigns = assigns.reshape(st["n_layers"], st["b"], -1)
    (norms,) = _normalized([(st, assigns, cfg)], reduce)
    return _criterion_losses(st, assigns, cfg, compute_labels_loss, norms)


def set_criterion_pair(
    outputs: Dict[str, torch.Tensor],
    tgt_masks_a: torch.Tensor,
    tgt_valid_a: torch.Tensor,
    cfg_a: CriterionConfig,
    tgt_masks_b: torch.Tensor,
    tgt_valid_b: torch.Tensor,
    cfg_b: CriterionConfig,
    compute_labels_loss: bool = True,
    generator: torch.Generator | None = None,
    draws: Dict | None = None,
    outputs_b: Dict[str, torch.Tensor] | None = None,
    draws_b: Dict | None = None,
    reduce=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Two criteria (supervised + distillation) with ONE batched auction
    for all 2 x layers x batch problems (costs padded with invalid columns
    to a common target count). On the same outputs they share one pool and
    one prediction sampling per layer; with `outputs_b` (the student on the
    disentangled distillation view) the second criterion scores those with
    its own draws (`draws_b`, else the generator's next). `reduce`: a sum
    over the ranks of a process group (see the module doc)."""
    if outputs_b is None or outputs_b is outputs:
        st_a, st_b = _criterion_costs_multi(
            outputs, [(tgt_masks_a, tgt_valid_a, cfg_a), (tgt_masks_b, tgt_valid_b, cfg_b)],
            generator, draws)
    else:
        (st_a,) = _criterion_costs_multi(outputs, [(tgt_masks_a, tgt_valid_a, cfg_a)],
                                         generator, draws)
        (st_b,) = _criterion_costs_multi(outputs_b, [(tgt_masks_b, tgt_valid_b, cfg_b)],
                                         generator, draws_b)
    n_a = st_a["stacked_cost"].shape[-1]
    n_b = st_b["stacked_cost"].shape[-1]
    n = max(n_a, n_b)

    def padded(st, n_cur):
        cost, valid = st["stacked_cost"], st["stacked_valid"]
        if n_cur < n:
            cost = F.pad(cost, (0, n - n_cur))
            valid = F.pad(valid, (0, n - n_cur))
        return cost, valid

    cost_a, valid_a = padded(st_a, n_a)
    cost_b, valid_b = padded(st_b, n_b)
    assigns = hungarian_assign(torch.cat([cost_a, cost_b]), torch.cat([valid_a, valid_b]),
                               impl=cfg_a.assign_impl)
    rows_a = cost_a.shape[0]
    assigns_a = assigns[:rows_a, :n_a].reshape(st_a["n_layers"], st_a["b"], -1)
    assigns_b = assigns[rows_a:, :n_b].reshape(st_b["n_layers"], st_b["b"], -1)
    norms_a, norms_b = _normalized([(st_a, assigns_a, cfg_a), (st_b, assigns_b, cfg_b)], reduce)
    return (
        _criterion_losses(st_a, assigns_a, cfg_a, compute_labels_loss, norms_a),
        _criterion_losses(st_b, assigns_b, cfg_b, compute_labels_loss, norms_b),
    )
