"""Multi-head attention with the packed `in_proj` layout, as
`s2d_tpu/models/attention.py`.

Batch first, (B, L, C). Boolean masks follow torch: True = blocked. The
plain path fills blocked logits with finfo.min (a fully blocked row then
averages uniformly); `use_flash` sends masked calls through the K3 CUDA
kernel (`ops/masked_attention_cuda.py`), whose blocked rows give 0. The
decoder unmasks fully blocked rows over real keys first, so both agree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masked_attention_cuda import masked_cross_attention


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, use_flash: bool = False):
        super().__init__()
        self.embed_dim, self.num_heads, self.use_flash = embed_dim, num_heads, use_flash
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj_weight = nn.Parameter(torch.zeros(embed_dim, embed_dim))
        self.out_proj_bias = nn.Parameter(torch.zeros(embed_dim))

    def forward(
        self,
        query: torch.Tensor,  # (B, Lq, C)
        key: torch.Tensor,  # (B, Lk, C)
        value: torch.Tensor,  # (B, Lk, C)
        attn_mask: Optional[torch.Tensor] = None,  # (B, 1 or H, Lq, Lk) bool
    ) -> torch.Tensor:
        c, h = self.embed_dim, self.num_heads
        d = c // h
        w, bias = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:c], bias[:c])
        k = F.linear(key, w[c : 2 * c], bias[c : 2 * c])
        v = F.linear(value, w[2 * c :], bias[2 * c :])
        b, lq, _ = q.shape
        lk = k.shape[1]
        q = q.reshape(b, lq, h, d).transpose(1, 2)
        k = k.reshape(b, lk, h, d).transpose(1, 2)
        v = v.reshape(b, lk, h, d).transpose(1, 2)

        if self.use_flash and attn_mask is not None:
            out = masked_cross_attention(
                q.reshape(b * h, lq, d).contiguous(),
                k.reshape(b * h, lk, d).contiguous(),
                v.reshape(b * h, lk, d).contiguous(),
                attn_mask.expand(b, h, lq, lk),  # head stride 0: no copy
            )
            out = out.reshape(b, h, lq, d).transpose(1, 2).reshape(b, lq, c)
            return F.linear(out, self.out_proj_weight, self.out_proj_bias)

        # torch scales q by d**-0.5 before the product
        logits = torch.einsum("bhqd,bhkd->bhqk", q * (d ** -0.5), k)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(1, 2).reshape(b, lq, c)
        return F.linear(out, self.out_proj_weight, self.out_proj_bias)
