"""K5 (the batched auction) on the CPU: the plain auction's round count on
hand-checked problems, and a numpy mirror of the CUDA kernel's bid keys
(`csrc/auction.cu:order_key`) against the plain auction's tie rule.

The kernel resolves each object's bids with a shared-memory atomicMax on a
64-bit key, (ordered(bid) << 32) | ~person; the reverse pass resolves each
person's seducers the same way with (ordered(beta) << 32) | ~object. The
largest key must be the plain auction's choice: the highest value, the
lowest index among equal values.
"""
import numpy as np
import pytest
import torch

from s2d_tpu_torch.ops import auction

NEG = np.float32(auction.NEG)


def order_key(values: np.ndarray, index: np.ndarray) -> np.ndarray:
    """The kernel's key: the f32 value's bits under the monotone map (sign
    bit set for non-negatives, all bits flipped for negatives; -0 first
    added to +0), above ~index in the low word."""
    v = (values.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    ordered = np.where(v & np.uint32(0x80000000), ~v, v | np.uint32(0x80000000))
    return (ordered.astype(np.uint64) << np.uint64(32)) | (~index.astype(np.uint32)).astype(np.uint64)


def test_auction_rounds_hand_checked_forward():
    """eps = (1,). Problem 0: no conflict, each person takes its own object
    in one round. Problem 1: both persons bid 11 on object 0, person 0 wins
    the tie, person 1 then bids 2 on object 1: two rounds. No reverse round
    (N = Q)."""
    ben = torch.tensor([[[10.0, 0.0], [0.0, 10.0]], [[10.0, 0.0], [10.0, 0.0]]])
    rounds = {}
    got = auction.auction_asym_plain(ben, (1.0,), rounds=rounds)
    assert got.tolist() == [[0, 1], [0, 1]]
    assert rounds == dict(forward=3, reverse=0, bidders=5, sellers=0,
                          slowest=dict(problem=1, forward=2, reverse=0))


def test_auction_rounds_hand_checked_reverse():
    """One person, benefits (5, 5), eps = (2, 1). Phase 1: it bids 2 on
    object 0 (the lowest index of the tie). Phase 2: 5 - 2 = 3 is below
    5 - 1, so the reset frees it; it bids 3 on object 1. Reverse round 1:
    object 0 (price 2) seduces it (beta 5 - 2 = 3 > 1) at max(0, -1e18 - 1)
    = 0, and object 1 is left at price 3. Reverse round 2: object 1's beta,
    5 - 5 = 0 <= 1: it drops to 0. Two forward and two reverse rounds."""
    rounds = {}
    got = auction.auction_asym_plain(torch.tensor([[[5.0, 5.0]]]), (2.0, 1.0), rounds=rounds)
    assert got.tolist() == [[0]]
    assert rounds == dict(forward=2, reverse=2, bidders=2, sellers=2,
                          slowest=dict(problem=0, forward=2, reverse=2))


def test_auction_rounds_slowest_is_one_problem():
    """The slowest problem's rounds are its own, not the batch's sums."""
    rng = np.random.RandomState(3)
    cost = rng.rand(5, 30, 12).astype(np.float32) * 10
    ben = auction.build_benefits(torch.from_numpy(cost), None)
    eps = auction.eps_schedule(12, False)
    rounds = {}
    auction.auction_asym_plain(ben, eps, rounds=rounds)
    alone = []
    for k in range(5):
        one = {}
        auction.auction_asym_plain(ben[k:k + 1], eps, rounds=one)
        alone.append((one["forward"], one["reverse"]))
    slowest = rounds["slowest"]
    assert (slowest["forward"], slowest["reverse"]) == alone[slowest["problem"]]
    assert sum(alone[slowest["problem"]]) == max(f + r for f, r in alone)
    assert rounds["forward"] == sum(f for f, _ in alone)
    assert rounds["reverse"] == sum(r for _, r in alone)


@pytest.mark.parametrize("seed", range(4))
def test_auction_key_picks_the_plain_winner(seed):
    """Over many random bid vectors with heavy ties (values from a small
    set that holds -0.0, 0.0, negatives, 1e-45 and the -1e18 sentinel), the
    largest key names the index the plain rule names: the first index whose
    value reaches the maximum."""
    rng = np.random.RandomState(seed)
    pool = np.array([-0.0, 0.0, 1e-45, -1e-45, 1.0, 2.5, -3.0, 4096.0, -4096.0, NEG, 7.25],
                    np.float32)
    for trial in range(400):
        n = rng.randint(1, 160)
        vals = pool[rng.randint(0, len(pool) if trial % 2 else 4, n)]
        if trial % 3 == 0:
            vals = vals + rng.randint(0, 3, n).astype(np.float32)
        idx = np.arange(n)
        plain = np.where(vals >= vals.max(), idx, n).min()
        keys = order_key(vals, idx)
        winner = int(~np.uint32(keys.max() & np.uint64(0xFFFFFFFF)))
        assert winner == plain, (vals, winner, plain)


def test_auction_key_is_monotone():
    """The map orders floats as their values do (-0 and +0 as one)."""
    vals = np.array([NEG, -4096.0, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 4096.0, 3e38],
                    np.float32)
    keys = order_key(vals, np.zeros(len(vals), np.int64)) >> np.uint64(32)
    assert np.all(np.diff(keys[[0, 1, 2, 3, 5, 6, 7, 8, 9]].astype(np.int64)) > 0)
    assert keys[4] == keys[5]
