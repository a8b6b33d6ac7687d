"""Linear sum assignment by the epsilon-scaled asymmetric auction, as
`s2d_tpu/ops/auction.py`.

`auction_assign` quantizes the costs into integer benefits (with the
sub-unit diversifier of invalid target columns) and solves every problem of
the batch. `auction_asym_plain` is a batched PyTorch copy of the JAX
`_auction_asym` that returns bit-identical assignments: same epsilon list,
partial reset, forward bids `(prices[i1] + (w1 - w2)) + eps`, reverse
seductions, lowest-index tie order and round guard. Problems run in lock
step; a round on a finished problem changes nothing, so each problem sees
the rounds it would see alone. It is the plain version of the K5 kernel
(`auction_cuda.py`) and what a CPU tensor runs.
"""
from __future__ import annotations

from typing import Sequence

import torch

QUANT = 4096.0  # cost quantization levels
THETA = 4.0  # epsilon scaling factor per phase
EPS_FINAL = 4.0  # early-stop epsilon (exact=False)
NEG = -1.0e18  # "no bid" sentinel
MAX_ITERS = 3000


def eps_schedule(n: int, exact: bool) -> tuple:
    """The static epsilon list of a problem with n persons."""
    eps_final = 1.0 / (n + 1) if exact else EPS_FINAL
    eps_list = []
    eps = QUANT / THETA
    while eps > eps_final:
        eps_list.append(eps)
        eps /= THETA
    eps_list.append(eps_final)
    return tuple(eps_list)


def build_benefits(cost: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """(B, Q, N) costs -> (B, N, Q) f32 quantized benefits, persons = target
    slots. An invalid column becomes a row-constant person one unit below
    the worst valid cost, plus a distinct sub-unit preference per person.
    Non-finite costs (a step that the train step's NaN skip discards) count
    as 0, so that the solver still ends."""
    cost = torch.nan_to_num(cost.float(), nan=0.0, posinf=0.0, neginf=0.0)
    b, q, n = cost.shape
    f32 = dict(dtype=torch.float32, device=cost.device)
    if valid is not None:
        valid = valid.to(cost.device, torch.bool)
        worst = torch.where(valid[:, None, :], cost, torch.tensor(float("-inf"), **f32))
        worst = worst.amax(dim=(1, 2))
        worst = torch.where(torch.isfinite(worst), worst, torch.zeros_like(worst))
        cost = torch.where(valid[:, None, :], cost, (worst + 1.0)[:, None, None])
    benefit = -cost.transpose(1, 2).contiguous()  # (B, N, Q), maximize
    bmin = benefit.amin(dim=(1, 2), keepdim=True)
    bmax = benefit.amax(dim=(1, 2), keepdim=True)
    # a true division: `scalar / tensor` would multiply by a reciprocal
    scale = torch.div(torch.tensor(QUANT, **f32), torch.clamp(bmax - bmin, min=1e-12))
    quantized = torch.round((benefit - bmin) * scale)
    if valid is not None:
        obj_ids = torch.arange(q, **f32)
        person_rows = torch.arange(n, **f32)
        diversifier = torch.tensor(-0.45 / q, **f32) * (
            (obj_ids[None, :] + person_rows[:, None]) % q)
        quantized = quantized + torch.where(
            valid[:, :, None], torch.zeros((), **f32), diversifier[None])
    return quantized.contiguous()


def _person_to_obj(owner: torch.Tensor, n: int) -> torch.Tensor:
    """(B, Q) person per object -> (B, N) object per person, -1 if none."""
    q = owner.shape[1]
    pid = torch.arange(n, device=owner.device)
    oid = torch.arange(q, device=owner.device)
    match = owner[:, :, None] == pid[None, None, :]  # (B, Q, N)
    first = torch.where(match, oid[None, :, None], q).amin(dim=1)
    return torch.where(first < q, first, -1)


def auction_asym_plain(benefit: torch.Tensor, eps_list: Sequence[float],
                       max_iters: int = MAX_ITERS, rounds: dict | None = None) -> torch.Tensor:
    """(B, N, Q) benefits -> (B, N) int32 object per person (-1 only when a
    round guard ran out). `rounds`, when given, receives the work the data
    needed, for a bound: the (problem, round) pairs in which a problem was
    still active ("forward", "reverse"), the bids of unassigned persons
    summed over the forward rounds ("bidders") and the unowned priced
    objects summed over the reverse rounds ("sellers"); and the problem with
    the most rounds, the first among equals, with its forward and reverse
    rounds over all phases ("slowest": problem, forward, reverse): a kernel
    that gives each problem its own block lasts as long as that problem."""
    b, n, q = benefit.shape
    dev = benefit.device
    fwd_rounds = torch.zeros(b, dtype=torch.int64, device=dev)
    rev_rounds = torch.zeros(b, dtype=torch.int64, device=dev)

    def count():
        if rounds is None:
            return
        slowest = dict(problem=0, forward=0, reverse=0)
        if b:
            k = int((fwd_rounds + rev_rounds).argmax())
            slowest = dict(problem=k, forward=int(fwd_rounds[k]), reverse=int(rev_rounds[k]))
        rounds.update(forward=int(fwd_rounds.sum()), reverse=int(rev_rounds.sum()),
                      bidders=bidders, sellers=sellers, slowest=slowest)

    bidders = sellers = 0
    if q == 1:
        count()
        return torch.zeros((b, n), dtype=torch.int32, device=dev)
    benefit = benefit.float()
    pid = torch.arange(n, device=dev)
    oid = torch.arange(q, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    prices = torch.zeros((b, q), dtype=torch.float32, device=dev)
    owner = torch.full((b, q), -1, dtype=torch.int64, device=dev)
    for eps_value in eps_list:
        eps = torch.tensor(eps_value, dtype=torch.float32, device=dev)
        # partial reset: keep the pairs that are eps-CS at this eps
        net = benefit - prices[:, None, :]
        best = net.amax(dim=2)
        pobj = _person_to_obj(owner, n)
        own = net.gather(2, pobj.clamp(min=0)[:, :, None])[:, :, 0]
        keep = (pobj >= 0) & (own >= best - eps)
        owner = torch.where(
            (owner >= 0) & keep.gather(1, owner.clamp(min=0)), owner, -1)

        # forward: unassigned persons bid until all are assigned
        for _ in range(max_iters):
            unassigned = _person_to_obj(owner, n) < 0
            if not bool(unassigned.any()):
                break
            if rounds is not None:
                fwd_rounds += unassigned.any(dim=1)
                bidders += int(unassigned.sum())
            net = benefit - prices[:, None, :]
            w1 = net.amax(dim=2)
            i1 = torch.where(net >= w1[:, :, None], oid, q).amin(dim=2)
            on_i1 = oid[None, None, :] == i1[:, :, None]  # (B, N, Q)
            w2 = torch.where(on_i1, neg, net).amax(dim=2)
            bid = (prices.gather(1, i1) + (w1 - w2)) + eps
            bids = on_i1 & unassigned[:, :, None]
            bid3 = torch.where(bids, bid[:, :, None], neg)
            best_bid = bid3.amax(dim=1)  # (B, Q)
            winner = torch.where(
                bids & (bid3 >= best_bid[:, None, :]), pid[None, :, None], n).amin(dim=1)
            contested = best_bid > neg
            owner = torch.where(contested, winner, owner)
            prices = torch.where(contested, best_bid, prices)

        # reverse: unowned objects with a price seduce their best person at
        # the competitive price or drop to the floor
        for _ in range(max_iters):
            bidder = (owner < 0) & (prices > 0.0)
            if not bool(bidder.any()):
                break
            if rounds is not None:
                rev_rounds += bidder.any(dim=1)
                sellers += int(bidder.sum())
            pobj = _person_to_obj(owner, n)
            net = benefit - prices[:, None, :]
            own = net.gather(2, pobj.clamp(min=0)[:, :, None])[:, :, 0]
            pi = torch.where(pobj >= 0, own, net.amax(dim=2) - eps)  # (B, N)
            r = benefit - pi[:, :, None]  # (B, N, Q)
            beta = r.amax(dim=1)  # (B, Q)
            i_star = torch.where(r >= beta[:, None, :], pid[None, :, None], n).amin(dim=1)
            is_star = pid[None, :, None] == i_star[:, None, :]  # (B, N, Q)
            gamma = torch.where(is_star, neg, r).amax(dim=1)
            give_up = bidder & (beta <= eps)
            prices = torch.where(give_up, zero, prices)
            seducing = bidder & ~give_up
            cand = seducing[:, None, :] & is_star  # (B, N, Q)
            win_beta = torch.where(cand, beta[:, None, :], neg).amax(dim=2)  # (B, N)
            seduced = win_beta > neg
            j_win = torch.where(
                cand & (beta[:, None, :] >= win_beta[:, :, None]), oid, q).amin(dim=2)
            # seduced persons leave their object ...
            left = (owner[:, :, None] == pid[None, None, :]) & (seduced & (pobj >= 0))[:, None, :]
            owner = torch.where(left.any(dim=2), -1, owner)
            # ... and take j_win at max(0, gamma - eps)
            won = seduced[:, :, None] & (oid[None, None, :] == j_win[:, :, None])  # (B, N, Q)
            won_any = won.any(dim=1)
            new_owner = torch.where(won, pid[None, :, None], n).amin(dim=1)
            owner = torch.where(won_any, new_owner, owner)
            prices = torch.where(won_any, torch.maximum(zero, gamma - eps), prices)
    count()
    return _person_to_obj(owner, n).to(torch.int32)


def auction_assign(cost: torch.Tensor, valid: torch.Tensor | None = None,
                   exact: bool = False, impl: str = "cuda") -> torch.Tensor:
    """Batched min-cost assignment: cost (B, Q, N), N <= Q, valid (B, N)
    marks real target columns. Returns (B, N) int32, the query of each
    target slot. impl: "cuda" (the K5 kernel for a CUDA tensor; a CPU
    tensor takes the plain auction) or "plain"."""
    b, q, n = cost.shape
    if n > q:
        raise ValueError(f"auction needs targets <= queries, got {n} > {q}")
    benefits = build_benefits(cost, valid)
    eps_list = eps_schedule(n, exact)
    if impl == "cuda":
        from .auction_cuda import auction_asym_cuda

        return auction_asym_cuda(benefits, eps_list)
    if impl != "plain":
        raise ValueError(f"unknown auction impl {impl!r}")
    return auction_asym_plain(benefits, eps_list)
