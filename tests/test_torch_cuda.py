"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need a CUDA device and nvcc; they carry the `cuda` marker and
skip elsewhere. The file imports no JAX, so it runs on a machine that has
only PyTorch; from the repo root:

    python -m pytest --confcutdir=tests tests/test_torch_cuda.py

(`--confcutdir=tests` keeps pytest from loading the root conftest.py, which
sets up JAX.) The input makers are shared with tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

from s2d_tpu_torch.ops import ms_deform_attn_cuda, msda_ablate_cuda, nms
from s2d_tpu_torch.ops.masked_attention_cuda import (
    masked_attention_plain,
    masked_cross_attention,
)
from s2d_tpu_torch.ops.ms_deform_attn import ms_deform_attn_plain
from s2d_tpu_torch.ops.msda_ablate import VARIANTS, msda_ablate_plain

# K1 levels: wide, tall and square, with out-of-range locations
MSDA_SHAPES = [(4, 12), (10, 3), (6, 6)]


def _msda_inputs(seed, b=2, lq=20, m=4, d=16, p=4, shapes=MSDA_SHAPES):
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, m, d).astype(np.float32)
    # [-0.4, 1.4]: a share of the points falls outside the map
    locs = (rng.rand(b, lq, m, len(shapes), p, 2) * 1.8 - 0.4).astype(np.float32)
    locs[0, 0, 0, 0, 0] = (25.0, -40.0)  # far outside: the kernel's clamp
    locs[1, 3, 2, 1, 3] = (1.0, 0.0)  # exactly on the border
    logits = rng.randn(b, lq, m, len(shapes) * p).astype(np.float32)
    weights = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, locs, weights.reshape(b, lq, m, len(shapes), p)


def _flash_inputs(seed, bh=4, heads=2, q_len=12, k_len=300, dh=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, q_len, dh).astype(np.float32)
    k = rng.randn(bh, k_len, dh).astype(np.float32)
    v = rng.randn(bh, k_len, dh).astype(np.float32)
    # per-(batch, query, key) mask shared by the heads, as the decoder's
    blocked = rng.rand(bh // heads, 1, q_len, k_len) > 0.6
    blocked[..., k_len - 60:] = True  # pad-frame keys: blocked for every query
    blocked[:, :, 3] = True  # one fully blocked row
    return q, k, v, blocked


def _nms_case(seed, n, grid):
    rng = np.random.RandomState(seed)
    if grid:  # IoUs on a coarse grid: ties with the threshold itself
        iou = rng.randint(0, 5, (n, n)).astype(np.float32) / 4.0
    else:
        iou = rng.rand(n, n).astype(np.float32)
    iou = np.maximum(iou, iou.T)
    np.fill_diagonal(iou, 1.0)
    labels = rng.randint(0, 3, n).astype(np.int32)
    return iou, labels


# K6 at small shapes: ng=2, rows h*g = 6 of k = 8, W = 5 columns of d = 8
# channels, gqp = 256 points (2 tiles of 128)
ABLATE = dict(ng=2, hg=6, k=8, w=5, d=8, p_tile=128, gqp=256)


def _ablate_inputs(seed, ng=2, hg=6, k=8, w=5, d=8, gqp=256):
    """numpy K6 inputs (vt's values bf16) with the dropped corners hit: rows
    ya = k-1 (ya+1 = k has no row of vt) and ya = h*g (ya+1 reads a real row
    past h*g), columns x0 = W-1 (x0+1 = W has no column)."""
    rng = np.random.RandomState(seed)
    vt = torch.from_numpy(rng.randn(ng, w * d, k).astype(np.float32))
    vt = vt.to(torch.bfloat16).float().numpy()
    pts = (ng, 1, gqp)
    ya = rng.randint(0, hg, pts).astype(np.int32)
    ya[:, :, :16] = k - 1
    ya[:, :, 16:32] = hg
    x0 = rng.randint(0, w, pts).astype(np.int32)
    x0[:, :, 8:24] = w - 1
    return vt, ya, x0, [rng.rand(*pts).astype(np.float32) for _ in range(4)]


def _ablate_tensors(vt, ya, x0, weights, device="cpu"):
    """(vt bf16, ya, wy0, wy1, x0, wx0, wx1): the wrappers' argument order."""
    wy0, wy1, wx0, wx1 = (torch.from_numpy(w).to(device) for w in weights)
    return (torch.from_numpy(vt).to(device, torch.bfloat16), torch.from_numpy(ya).to(device),
            wy0, wy1, torch.from_numpy(x0).to(device), wx0, wx1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_msda_matches_twin(cuda):
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in _msda_inputs(4, d=32))
    before = ms_deform_attn_cuda.LAUNCHES
    got = ms_deform_attn_cuda.ms_deform_attn_cuda(value, MSDA_SHAPES, locs, weights)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.LAUNCHES == before + 1
    ref = ms_deform_attn_plain(value, MSDA_SHAPES, locs, weights)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32])
def test_cuda_flash_matches_twin(cuda, dh):
    q, k, v, blocked = (torch.from_numpy(a).to(cuda) for a in _flash_inputs(5, dh=dh))
    mask = blocked.expand(q.shape[0] // 2, 2, q.shape[1], k.shape[1])
    got = masked_cross_attention(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, masked_attention_plain(q, k, v, mask), rtol=1e-4, atol=1e-4)
    assert torch.all(got[:, 3] == 0)


@pytest.mark.cuda
def test_cuda_msda_backward_matches_twin(cuda):
    """K2 against autograd through the plain core (atomics: summation order)."""
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in _msda_inputs(6, d=32))
    grad_out = torch.randn(value.shape[0], locs.shape[1], value.shape[2] * 32,
                           device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = ms_deform_attn_cuda.BWD_LAUNCHES
    got = ms_deform_attn_cuda.ms_deform_attn_bwd_cuda(value, MSDA_SHAPES, locs, weights, grad_out)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.BWD_LAUNCHES == before + 1
    ref = ms_deform_attn_cuda.ms_deform_attn_bwd_plain(value, MSDA_SHAPES, locs, weights, grad_out)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    # the autograd route: forward K1, backward K2
    leaves = [t.clone().requires_grad_(True) for t in (value, locs, weights)]
    out = ms_deform_attn_cuda.ms_deform_attn_cuda(leaves[0], MSDA_SHAPES, leaves[1], leaves[2])
    out.backward(grad_out)
    assert ms_deform_attn_cuda.BWD_LAUNCHES == before + 2
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r, rtol=1e-4, atol=1e-4)


def auction_cases(seed):
    """(cost (B, Q, N), valid (B, N)) problems: random, quantized near-ties,
    invalid columns, N < Q and N == Q."""
    rng = np.random.RandomState(seed)
    cases = []
    for b, q, n in [(3, 100, 25), (2, 8, 3), (4, 37, 37), (2, 150, 40), (4, 100, 100)]:
        cost = rng.rand(b, q, n).astype(np.float32) * 10
        cases.append((cost, rng.rand(b, n) > 0.2))
        cases.append((np.round(cost * 3) / 3, np.ones((b, n), bool)))  # many ties
    return cases


@pytest.mark.cuda
def test_cuda_auction_matches_twin(cuda):
    from s2d_tpu_torch.ops import auction, auction_cuda

    for exact in (False, True):
        for cost, valid in auction_cases(1):
            ben = auction.build_benefits(torch.from_numpy(cost).to(cuda), torch.from_numpy(valid).to(cuda))
            eps_list = auction.eps_schedule(cost.shape[2], exact)
            before = auction_cuda.LAUNCHES
            got = auction_cuda.auction_asym_cuda(ben, eps_list)
            torch.cuda.synchronize()
            assert auction_cuda.LAUNCHES == before + 1
            ref = auction.auction_asym_plain(ben, eps_list)
            assert torch.equal(got, ref), (cost.shape, exact)


@pytest.mark.cuda
def test_cuda_nms_matches_twin(cuda):
    for seed in range(5):
        iou, labels = _nms_case(seed, 50, seed % 2 == 0)
        iou_t, lab_t = torch.from_numpy(iou).to(cuda), torch.from_numpy(labels).to(cuda)
        got = nms.greedy_mask_nms(iou_t, lab_t, 0.75)
        assert torch.equal(got, nms.greedy_mask_nms_plain(iou_t, lab_t, 0.75))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_msda_ablate_matches_twin(cuda, variant):
    """K6 against its plain version, the dropped corners included: exact for
    empty and noconstruct; dotonly and full round each product and sum on
    their own in both (no FMA contraction), held at rtol 1e-5 / atol 1e-6."""
    args = _ablate_tensors(*_ablate_inputs(7), device=cuda)
    w, d = ABLATE["w"], ABLATE["d"]
    before = msda_ablate_cuda.LAUNCHES[variant]
    got = msda_ablate_cuda.msda_ablate(variant, *args, w, d)
    torch.cuda.synchronize()
    assert msda_ablate_cuda.LAUNCHES[variant] == before + 1
    ref = msda_ablate_plain(variant, *args, w, d)
    if variant in ("empty", "noconstruct"):
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
