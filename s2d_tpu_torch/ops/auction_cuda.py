"""The batched auction on the hand-written CUDA kernel.

`csrc/auction.cu` replaces the TPU kernel
`s2d_tpu/ops/auction_pallas.py:_batched_auction_asym_kernel` (K5): one block
per problem, the problem in shared memory, bit-identical assignments to
`auction.auction_asym_plain` (its plain version, which a CPU tensor takes).
A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from .. import _build
from .auction import MAX_ITERS, auction_asym_plain

LAUNCHES = 0  # kernel launches since the last reset


@functools.lru_cache(maxsize=16)
def _eps_tensor(eps_list: tuple, device) -> torch.Tensor:
    return torch.tensor(eps_list, dtype=torch.float32, device=device)


def auction_asym_cuda(benefit: torch.Tensor, eps_list: Sequence[float],
                      max_iters: int = MAX_ITERS) -> torch.Tensor:
    """(B, N, Q) f32 benefits -> (B, N) int32 object per person."""
    global LAUNCHES
    if not benefit.is_cuda:
        return auction_asym_plain(benefit, eps_list, max_iters)
    b, n, q = benefit.shape
    if n > q:
        raise ValueError(f"auction needs persons <= objects, got {n} > {q}")
    if benefit.dtype != torch.float32 or not benefit.is_contiguous():
        raise ValueError("benefit must be contiguous float32")
    if q == 1:  # the trivial problem, as the reference returns it
        return torch.zeros((b, n), dtype=torch.int32, device=benefit.device)
    out = torch.empty((b, n), dtype=torch.int32, device=benefit.device)
    eps = _eps_tensor(tuple(float(e) for e in eps_list), benefit.device)
    rc = _build.library().s2d_auction(
        benefit.data_ptr(), eps.data_ptr(), out.data_ptr(), b, n, q, len(eps_list),
        max_iters, _build.stream_handle(benefit),
    )
    if rc == -1:
        raise ValueError(f"an auction problem of {n} x {q} does not fit in a block's shared memory")
    _build.check(rc, "s2d_auction")
    LAUNCHES += 1
    return out
