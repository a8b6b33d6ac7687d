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

from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, msda_ablate_cuda, nms
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


def _flash_case(seed, q_len, k_len, dh, bh=4, heads=2):
    """K3 inputs at a ragged shape: the mask at 50%, shared by the heads;
    the last fifth of the keys blocked for every query (pad-frame keys) and
    row 3, where there is one, fully blocked."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bh, n, dh).astype(np.float32) for n in (q_len, k_len, k_len))
    blocked = rng.rand(bh // heads, 1, q_len, k_len) > 0.5
    blocked[..., k_len - k_len // 5:] = True
    blocked[:, :, 3:4] = True
    return q, k, v, blocked


def _check_flash(cuda, q, k, v, mask):
    """K3 against its plain version at the smoke's tolerance (atol 1e-4, f32),
    one launch counted, and exact zeros on every fully blocked row."""
    before = masked_attention_cuda.LAUNCHES
    got = masked_cross_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert masked_attention_cuda.LAUNCHES == before + 1
    torch.testing.assert_close(got, masked_attention_plain(q, k, v, mask), rtol=0, atol=1e-4)
    full = mask.all(-1).reshape(q.shape[0], q.shape[1])
    assert torch.all(got[full] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32])
@pytest.mark.parametrize("k_len", [1, 127, 1920, 1921])
@pytest.mark.parametrize("q_len", [130, 100, 17, 1])
def test_cuda_flash_ragged_edges(cuda, q_len, k_len, dh):
    """Q not a multiple of 16 (the rows of a warp) and above the 128 rows of
    a block, K below one key tile, not a multiple of it, and a multiple of
    16 (16-byte mask copies); a mask of head stride 0."""
    q, k, v, blocked = (torch.from_numpy(a).to(cuda) for a in _flash_case(9, q_len, k_len, dh))
    mask = blocked.expand(q.shape[0] // 2, 2, q_len, k_len)
    assert mask.stride(1) == 0
    _check_flash(cuda, q, k, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("k_len", [1920, 7680, 30720])
def test_cuda_flash_decoder_shapes(cuda, k_len):
    """The decoder's calls: BH = 8 heads of one clip, Q = 100, Dh = 32, K =
    8 frames x h x w, the last 2 frames pad frames, the (B, 1, Q, K) mask
    expanded over the heads, query 5 fully blocked."""
    q, k, v, blocked = (torch.from_numpy(a).to(cuda)
                        for a in _flash_case(10, 100, k_len, 32, bh=8, heads=8))
    blocked[..., 6 * k_len // 8:] = True
    blocked[:, :, 5] = True
    _check_flash(cuda, q, k, v, blocked.expand(1, 8, 100, k_len))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["per_head", "key_stride_2", "unaligned_rows"])
def test_cuda_flash_mask_layouts(cuda, layout):
    """Masks the kernel reads through their strides: one per head (head
    stride != 0), every other key of a wider mask (key stride 2), and rows
    of 130 bytes (no 16-byte copies)."""
    k_len = 130 if layout == "unaligned_rows" else 640
    q, k, v, _ = (torch.from_numpy(a).to(cuda) for a in _flash_case(11, 100, k_len, 32))
    gen = torch.Generator(cuda).manual_seed(11)
    if layout == "key_stride_2":
        mask = (torch.rand(2, 2, 100, 2 * k_len, device=cuda, generator=gen) > 0.5)[..., ::2]
        assert mask.stride(-1) == 2
    else:
        mask = torch.rand(2, 2, 100, k_len, device=cuda, generator=gen) > 0.5
    mask[:, :, 7] = True
    _check_flash(cuda, q, k, v, mask)


# MSDA edge levels: a map of width 1 and one of a single position
MSDA_THIN = [(7, 1), (4, 12), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("shapes", [MSDA_SHAPES, MSDA_THIN], ids=["mixed", "thin"])
def test_cuda_msda_border_and_thin_levels(cuda, shapes, d):
    """K1 with points outside the map, exactly on its border (0 and 1) and
    just outside it, on levels of width 1; D = 16 leaves half the lanes of
    a (query, head) without channels."""
    value, locs, weights = _msda_inputs(12, d=d, shapes=shapes)
    locs[:, 5] = 0.0
    locs[:, 6] = 1.0
    locs[:, 7] = -0.01
    locs[:, 8] = 1.01
    locs[:, 9, :, :, :, 0] = 1.0  # the right border, y inside
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in (value, locs, weights))
    before = ms_deform_attn_cuda.LAUNCHES
    got = ms_deform_attn_cuda.ms_deform_attn_cuda(value, shapes, locs, weights)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.LAUNCHES == before + 1
    ref = ms_deform_attn_plain(value, shapes, locs, weights)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [8, 6], ids=["inference", "train"])
def test_cuda_msda_path_shapes(cuda, frames):
    """K1 at the encoder's shapes: value (frames, 5040, 8, 32) over the 12 x
    20, 24 x 40 and 48 x 80 levels of a 384 x 640 input (the two small maps
    staged in shared memory, the large one gathered from global memory),
    with offsets of 3 pixels' spread: a share of the points lies outside."""
    levels = [(12, 20), (24, 40), (48, 80)]
    rng = np.random.RandomState(13)
    s = sum(h * w for h, w in levels)
    norm = np.array([[w, h] for h, w in levels], np.float32)
    ref_pts = rng.rand(frames, s, 1, 3, 1, 2).astype(np.float32)
    offsets = 3.0 * rng.randn(frames, s, 8, 3, 4, 2).astype(np.float32)
    locs = ref_pts + offsets / norm[None, None, None, :, None, :]
    logits = rng.randn(frames, s, 8, 12).astype(np.float32)
    weights = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(frames, s, 8, 3, 4)
    value = rng.randn(frames, s, 8, 32).astype(np.float32)
    value, locs, weights = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                            for a in (value, locs, weights))
    got = ms_deform_attn_cuda.ms_deform_attn_cuda(value, levels, locs, weights)
    torch.cuda.synchronize()
    ref = ms_deform_attn_plain(value, levels, locs, weights)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


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
