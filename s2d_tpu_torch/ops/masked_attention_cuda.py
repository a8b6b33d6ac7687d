"""Masked cross-attention (flash-style, forward only) on the CUDA kernel.

`csrc/masked_attention.cu` replaces the TPU kernel
`s2d_tpu/ops/masked_attention_pallas.py:_kernel` (K3); the source's header
says what bounds it on the card and how it is laid out. A CUDA tensor
launches the kernel or raises; a CPU tensor takes `masked_attention_plain`,
the same math in one einsum-softmax.

Semantics kept from the TPU kernel (they differ from the decoder's plain
attention, which fills blocked logits with finfo.min): a blocked logit is
-1e30, the softmax max is clamped at >= -1e4, and a row whose keys are all
blocked gives 0. The decoder unmasks fully blocked rows over real keys
before it calls this, so the two paths agree there; pad-frame keys stay
blocked.
"""
from __future__ import annotations

import functools

import torch

from .. import _build

NEG_INF = -1.0e30
M_CLAMP = -1.0e4
HEAD_DIMS = (16, 32)  # head widths the kernel is instantiated for
KEY_TILE = 64  # keys a tile of the kernel (kTileK in the source)
QUERY_ROWS = 128  # query rows a block holds at most (kMaxWarps x 16)
BLOCKS_PER_SM = 2  # blocks the chunking aims to keep on each SM

LAUNCHES = 0  # kernel launches since the last reset


def chunk_keys(bh: int, q_len: int, k_len: int, sms: int) -> int:
    """Keys a block takes: whole tiles, at least 2, few enough that the grid
    (query groups x BH x key chunks) keeps BLOCKS_PER_SM blocks on each of
    `sms` SMs. 2 tiles (128 keys) at the decoder's K = 1920, 15 at 30720."""
    tiles = max(1, -(-k_len // KEY_TILE))
    per_row = bh * -(-q_len // QUERY_ROWS)  # blocks for one chunk of every row
    return KEY_TILE * max(2, -(-tiles * per_row // (BLOCKS_PER_SM * sms)))


@functools.lru_cache(maxsize=64)
def _plan(bh: int, q_len: int, k_len: int, dh: int, device) -> tuple[int, tuple[int, ...]]:
    """(keys a chunk, workspace shape) of a call, kept per shape: per key chunk
    a partial (accumulators, max, sum) of each query row."""
    keys = chunk_keys(bh, q_len, k_len, _build.sm_count(device))
    return keys, (bh, max(1, -(-k_len // keys)), q_len, dh + 2)


def _as_4d(blocked: torch.Tensor, bh: int) -> torch.Tensor:
    """(BH, Q, K) -> (1, BH, Q, K); (B, H, Q, K) as given."""
    if blocked.dim() == 3:
        return blocked.unsqueeze(0)
    if blocked.dim() != 4 or blocked.shape[0] * blocked.shape[1] != bh:
        raise ValueError(f"blocked {tuple(blocked.shape)} vs BH={bh}")
    return blocked


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, blocked: torch.Tensor
) -> torch.Tensor:
    """softmax(q k^T * Dh^-1/2, blocked -> -1e30, max >= -1e4) v; 0 where a
    row is fully blocked. q (BH, Q, Dh); k, v (BH, K, Dh); blocked (BH, Q, K)
    or (B, H, Q, K) bool, True = may not attend."""
    bh, q_len, dh = q.shape
    blocked = _as_4d(blocked, bh).reshape(bh, q_len, k.shape[1])
    logits = torch.einsum("bqd,bkd->bqk", q, k) * (dh ** -0.5)
    logits = logits.masked_fill(blocked, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True).clamp_min(M_CLAMP)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v)
    return out / torch.where(l > 0, l, torch.ones_like(l))


def masked_cross_attention(
    q: torch.Tensor,  # (BH, Q, Dh) f32
    k: torch.Tensor,  # (BH, K, Dh) f32
    v: torch.Tensor,  # (BH, K, Dh) f32
    blocked: torch.Tensor,  # (BH, Q, K) or (B, H, Q, K) bool, any strides
) -> torch.Tensor:
    """(BH, Q, Dh) f32. The mask is read through its strides: pass a (B, 1,
    Q, K) mask `.expand(B, H, Q, K)` and no H-fold copy is made."""
    global LAUNCHES
    if not q.is_cuda:
        return masked_attention_plain(q, k, v, blocked)
    bh, q_len, dh = q.shape
    k_len = k.shape[1]
    if tuple(k.shape) != (bh, k_len, dh) or tuple(v.shape) != (bh, k_len, dh):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    mask4 = _as_4d(blocked, bh)
    if mask4.dtype != torch.bool or mask4.device != q.device:
        raise TypeError(f"blocked must be bool on {q.device}, got {mask4.dtype} on {mask4.device}")
    if tuple(mask4.shape[2:]) != (q_len, k_len):
        raise ValueError(f"blocked {tuple(blocked.shape)} vs Q={q_len}, K={k_len}")
    out = torch.empty_like(q)
    keys, parts = _plan(bh, q_len, k_len, dh, q.device)
    workspace = torch.empty(parts, dtype=torch.float32, device=q.device)
    sb, sh, sq, sk = mask4.stride()
    lib = _build.library()
    rc = lib.s2d_masked_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask4.data_ptr(), workspace.data_ptr(),
        out.data_ptr(),
        bh, q_len, k_len, dh, mask4.shape[1], sb, sh, sq, sk, dh ** -0.5, keys,
        _build.stream_handle(q),
    )
    _build.check(rc, "s2d_masked_attention_fwd")
    LAUNCHES += 1
    return out
