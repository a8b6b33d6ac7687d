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


def _sparse_nms_case(seed, n):
    """IoUs below the threshold but for ~3 pairs a candidate above it and ~1
    at it: the kept candidates spread over the whole score order."""
    rng = np.random.RandomState(seed)
    iou = (rng.rand(n, n) * 0.7).astype(np.float32)
    for value, pairs in ((0.8, 3 * n), (0.75, n)):
        iou[rng.randint(0, n, pairs), rng.randint(0, n, pairs)] = value
    iou = np.maximum(iou, iou.T)
    np.fill_diagonal(iou, 1.0)
    return iou, rng.randint(0, 2, n).astype(np.int32)


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
    """K2 against autograd through the plain core (summation order: d value
    in fixed point, the others over the lanes of a (query, head))."""
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


def _msda_bwd_check(cuda, value, shapes, locs, weights, grad_out, scaled_atol=False):
    """K2 against the plain backward, one launch counted. At rtol/atol 1e-4;
    with `scaled_atol`, d locations and d weights at chip_smoke's gate, atol
    1e-4 + 2e-5 max|d| (rtol 0): at maps of 80 or 160 columns each version
    rounds the sampling coordinate in f32 in its own way, up to 1e-5 px
    apart, and that moves a location gradient of ~1e3 by ~1e-2."""
    before = ms_deform_attn_cuda.BWD_LAUNCHES
    got = ms_deform_attn_cuda.ms_deform_attn_bwd_cuda(value, shapes, locs, weights, grad_out)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.BWD_LAUNCHES == before + 1
    ref = ms_deform_attn_cuda.ms_deform_attn_bwd_plain(value, shapes, locs, weights, grad_out)
    for what, g, r in zip(("value", "locations", "weights"), got, ref):
        if scaled_atol:
            atol = 1e-4 if what == "value" else 1e-4 + 2e-5 * r.abs().max().item()
            torch.testing.assert_close(g, r, rtol=0, atol=atol, msg=f"d {what}")
        else:
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4, msg=f"d {what}")
    return got


def _grad_out(cuda, value, lq, seed=0):
    return torch.randn(value.shape[0], lq, value.shape[2] * value.shape[3], device=cuda,
                       generator=torch.Generator(cuda).manual_seed(seed))


def _off_kinks(locs, shapes):
    """Moves each sampling coordinate (loc * size - 0.5) within 1e-3 of an
    integer by 2e-3 px: bilinear sampling's location gradient is two-valued
    there, and K2 and `F.grid_sample` may take different sides."""
    scale = np.array([[w, h] for h, w in shapes], np.float32)[None, None, None, :, None, :]
    coord = locs * scale - 0.5
    near = np.abs(coord - np.round(coord)) < 1e-3
    return np.where(near, locs + np.float32(2e-3) / scale, locs).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("shapes", [MSDA_SHAPES, MSDA_THIN], ids=["mixed", "thin"])
def test_cuda_msda_backward_border_and_thin_levels(cuda, shapes, d):
    """K2 with points outside the map, exactly on its border (0 and 1) and
    just outside it, on levels of width 1 and of one position; D = 16
    leaves half the lanes of a (query, head) without channels. Every map is
    staged in shared memory here."""
    value, locs, weights = _msda_inputs(12, d=d, shapes=shapes)
    locs[:, 5] = 0.0
    locs[:, 6] = 1.0
    locs[:, 7] = -0.01
    locs[:, 8] = 1.01
    locs[:, 9, :, :, :, 0] = 1.0
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in (value, locs, weights))
    _msda_bwd_check(cuda, value, shapes, locs, weights, _grad_out(cuda, value, locs.shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [8, 6], ids=["inference", "train"])
def test_cuda_msda_backward_path_shapes(cuda, frames):
    """K2 at the encoder's shapes, value (frames, 5040, 8, 32) over the 12 x
    20, 24 x 40 and 48 x 80 levels (d value: a block per frame, head and 4
    channels, all 5040 positions in its shared memory; d loc, d aw: the two
    small maps staged); offsets of 3 pixels' spread, points off the bilinear
    kinks."""
    levels = [(12, 20), (24, 40), (48, 80)]
    rng = np.random.RandomState(14)
    s = sum(h * w for h, w in levels)
    norm = np.array([[w, h] for h, w in levels], np.float32)
    ref_pts = rng.rand(frames, s, 1, 3, 1, 2).astype(np.float32)
    offsets = 3.0 * rng.randn(frames, s, 8, 3, 4, 2).astype(np.float32)
    locs = _off_kinks(ref_pts + offsets / norm[None, None, None, :, None, :], levels)
    logits = rng.randn(frames, s, 8, 12).astype(np.float32)
    weights = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(frames, s, 8, 3, 4)
    value = rng.randn(frames, s, 8, 32).astype(np.float32)
    value, locs, weights = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                            for a in (value, locs, weights))
    _msda_bwd_check(cuda, value, levels, locs, weights, _grad_out(cuda, value, s, 1),
                    scaled_atol=True)


@pytest.mark.cuda
def test_cuda_msda_backward_level_too_large_to_stage(cuda):
    """A 96 x 160 level (1.9 MB a head at D = 32) beside a 12 x 20 one: no
    shared-memory copy holds its map, and d value's 15,600 positions take
    3 position ranges (blocks) a frame, head and 4 channels."""
    shapes = [(12, 20), (96, 160)]
    value, locs, weights = _msda_inputs(15, b=2, lq=300, m=4, d=32, shapes=shapes)
    locs = _off_kinks(locs, shapes)
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in (value, locs, weights))
    _msda_bwd_check(cuda, value, shapes, locs, weights, _grad_out(cuda, value, 300, 2),
                    scaled_atol=True)


@pytest.mark.cuda
def test_cuda_msda_backward_every_corner_outside(cuda):
    """Points whose four corners all lie outside their maps: zero d value,
    zero location and weight gradients, as the plain version."""
    value, locs, weights = _msda_inputs(16, d=32)
    locs[..., 0] = np.where(np.arange(locs.shape[1])[None, :, None, None, None] % 2, 3.0, -2.0)
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in (value, locs, weights))
    got = _msda_bwd_check(cuda, value, MSDA_SHAPES, locs, weights,
                          _grad_out(cuda, value, locs.shape[1], 3))
    for g in got:
        assert torch.all(g == 0)


@pytest.mark.cuda
def test_cuda_msda_autograd_launches(cuda):
    """The differentiable wrapper: a forward and a backward launch K1 once
    and K2 once, and the leaves' gradients are K2's."""
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in _msda_inputs(17, d=32))
    grad_out = _grad_out(cuda, value, locs.shape[1], 4)
    before = (ms_deform_attn_cuda.LAUNCHES, ms_deform_attn_cuda.BWD_LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (value, locs, weights)]
    out = ms_deform_attn_cuda.ms_deform_attn_cuda(leaves[0], MSDA_SHAPES, leaves[1], leaves[2])
    out.backward(grad_out)
    torch.cuda.synchronize()
    assert (ms_deform_attn_cuda.LAUNCHES, ms_deform_attn_cuda.BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref = ms_deform_attn_cuda.ms_deform_attn_bwd_plain(value, MSDA_SHAPES, locs, weights, grad_out)
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


def _k5_case(name, exact):
    """(benefit (B, N, Q) f32, eps list, max_iters) for a K5 edge case."""
    from s2d_tpu_torch.ops import auction

    rng = np.random.RandomState(21)
    max_iters = auction.MAX_ITERS
    if name.startswith("max_iters"):
        # rounds cut short: both versions stop at the same round with the
        # same partial assignment (-1 for the persons left unassigned)
        max_iters = int(name.split("_")[-1])
        cost, valid = rng.rand(4, 100, 100).astype(np.float32) * 10, rng.rand(4, 100) > 0.3
    elif name == "one_person":
        cost, valid = rng.rand(3, 100, 1).astype(np.float32), np.ones((3, 1), bool)
    elif name == "square_150":
        cost, valid = rng.rand(2, 150, 150).astype(np.float32) * 10, np.ones((2, 150), bool)
    elif name == "all_equal":
        cost, valid = np.full((2, 60, 40), 3.0, np.float32), np.ones((2, 40), bool)
    else:  # negative and zero benefits, given directly
        ben = -rng.randint(0, 40, (3, 30, 50)).astype(np.float32)
        ben[:, :, 7] = 0.0
        ben[1] = -0.0
        n = ben.shape[1]
        return torch.from_numpy(ben), auction.eps_schedule(n, exact), max_iters
    ben = auction.build_benefits(torch.from_numpy(cost), torch.from_numpy(valid))
    return ben, auction.eps_schedule(cost.shape[2], exact), max_iters


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["eps_final_4", "exact"])
@pytest.mark.parametrize("name", ["max_iters_1", "max_iters_3", "max_iters_12", "one_person",
                                  "square_150", "all_equal", "negative_and_zero"])
def test_cuda_auction_edge_cases(cuda, name, exact):
    """K5 bit-identical to the plain auction at the edges of its design:
    the round guard (max_iters) cutting the forward or reverse loop, one
    person, N = Q = 150, all-equal benefits (every bid a tie), negative and
    zero benefits (-0.0 among them), under both epsilon schedules
    (eps_final 4, and the exact 1 / (N + 1))."""
    from s2d_tpu_torch.ops import auction, auction_cuda

    ben, eps_list, max_iters = _k5_case(name, exact)
    ben = ben.to(cuda)
    before = auction_cuda.LAUNCHES
    got = auction_cuda.auction_asym_cuda(ben, eps_list, max_iters)
    torch.cuda.synchronize()
    assert auction_cuda.LAUNCHES == before + 1
    ref = auction.auction_asym_plain(ben, eps_list, max_iters)
    assert torch.equal(got, ref), (name, int((got != ref).sum()))
    if name == "max_iters_1":
        assert bool((ref < 0).any()), "the guard should leave persons unassigned"


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
    """K6 against its plain version, the dropped corners included: bit for
    bit in every variant (each product and sum rounds on its own in both,
    no FMA contraction, in the same order)."""
    args = _ablate_tensors(*_ablate_inputs(7), device=cuda)
    w, d = ABLATE["w"], ABLATE["d"]
    before = msda_ablate_cuda.LAUNCHES[variant]
    got = msda_ablate_cuda.msda_ablate(variant, *args, w, d)
    torch.cuda.synchronize()
    assert msda_ablate_cuda.LAUNCHES[variant] == before + 1
    ref = msda_ablate_plain(variant, *args, w, d)
    assert torch.equal(got, ref), float((got - ref).abs().max())


def _msda_train_case(cuda, seed):
    """K2's operands at the train step's encoder shapes: value (6, 5040, 8,
    32) over the 12 x 20, 24 x 40 and 48 x 80 levels, offsets of 3 pixels'
    spread off the bilinear kinks, softmax weights, a random grad_out."""
    levels = [(12, 20), (24, 40), (48, 80)]
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in levels)
    norm = np.array([[w, h] for h, w in levels], np.float32)
    ref_pts = rng.rand(6, s, 1, 3, 1, 2).astype(np.float32)
    offsets = 3.0 * rng.randn(6, s, 8, 3, 4, 2).astype(np.float32)
    locs = _off_kinks(ref_pts + offsets / norm[None, None, None, :, None, :], levels)
    logits = rng.randn(6, s, 8, 12).astype(np.float32)
    weights = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(6, s, 8, 3, 4)
    value = rng.randn(6, s, 8, 32).astype(np.float32)
    value, locs, weights = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                            for a in (value, locs, weights))
    return value, levels, locs, weights, _grad_out(cuda, value, s, seed)


@pytest.mark.cuda
def test_cuda_msda_backward_is_deterministic(cuda):
    """K2 three times on the same train-shape operands: d value, d locations
    and d weights bitwise the same every time, and each within chip_smoke's
    gates of the plain version (d value atol 1e-4)."""
    value, levels, locs, weights, grad_out = _msda_train_case(cuda, 18)
    first = _msda_bwd_check(cuda, value, levels, locs, weights, grad_out, scaled_atol=True)
    for _ in range(2):
        again = ms_deform_attn_cuda.ms_deform_attn_bwd_cuda(value, levels, locs, weights, grad_out)
        for what, a, b in zip(("value", "locations", "weights"), first, again):
            assert torch.equal(a, b), f"d {what} differs between two calls"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero_grad", "zero_weights", "nan_grad", "inf_weight",
                                  "tiny_grad"])
def test_cuda_msda_backward_fixed_point_edges(cuda, case):
    """The fixed-point scale's edges: an all-zero grad_out or all-zero
    weights (max 0) give zeros; a NaN in grad_out or an inf weight gives a
    non-finite d value wherever the float sum is non-finite (never a finite
    wrong one) and the float sum's values elsewhere; a grad_out of ~1e-30
    (a scale far above 2^62) keeps its relative accuracy."""
    value, locs, weights = (torch.from_numpy(a).to(cuda) for a in _msda_inputs(19, d=32))
    grad_out = _grad_out(cuda, value, locs.shape[1], 5)
    if case == "zero_grad":
        grad_out.zero_()
    elif case == "zero_weights":
        weights.zero_()
    elif case == "nan_grad":
        grad_out[1, 3, 7] = float("nan")
    elif case == "inf_weight":  # at a point inside its map: the float sum is non-finite
        locs[0, 2, 1, 0, 0] = torch.tensor([0.5, 0.5])
        weights[0, 2, 1, 0, 0] = float("inf")
    else:
        grad_out.mul_(1e-30)
    dv, _, _ = ms_deform_attn_cuda.ms_deform_attn_bwd_cuda(value, MSDA_SHAPES, locs, weights,
                                                          grad_out)
    torch.cuda.synchronize()
    ref = ms_deform_attn_cuda.ms_deform_attn_bwd_plain(value, MSDA_SHAPES, locs, weights,
                                                       grad_out)[0]
    if case.startswith("zero"):
        assert torch.all(dv == 0)
    elif case in ("nan_grad", "inf_weight"):
        bad = ~torch.isfinite(ref)
        assert bad.any() and not torch.isfinite(dv[bad]).any()
        fine = torch.isfinite(dv)
        torch.testing.assert_close(dv[fine], ref[fine], rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(dv, ref, rtol=1e-4, atol=1e-34)
        assert ref.abs().max() > 1e-32


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50, 64, 65, 127, 128, 180, 256, 1024, 1025, 1800, 4096])
def test_cuda_nms_sizes_and_label_ties(cuda, n):
    """K4 at one candidate, the main path's 50, one and two 32-bit words of
    the removed set past 32, the one-block kernel's last size before
    WALK_FROM (127) and the scratch path's first (128), the CutLER TTA
    merge's 180 and cascade's 256 (2 uint4 lanes a row), 1024 and 1025 (32
    words of the removed set and one more), the TTA merge's 1800 and the
    most, 4096; IoUs on a grid (ties with the threshold) and with random
    ones, one label and three, int64 labels as the postprocess hands them
    over and int32: keep masks exactly the plain loop's."""
    for seed, grid, one_label in ((0, True, False), (1, False, False), (2, True, True)):
        iou, labels = _nms_case(seed, n, grid)
        if one_label:
            labels[:] = 0
        for dtype in (torch.int64, torch.int32):
            iou_t = torch.from_numpy(iou).to(cuda)
            lab_t = torch.from_numpy(labels).to(cuda, dtype)
            before = nms.LAUNCHES
            got = nms.greedy_mask_nms(iou_t, lab_t, 0.75)
            torch.cuda.synchronize()
            assert nms.LAUNCHES == before + 1
            assert torch.equal(got, nms.greedy_mask_nms_plain(iou_t, lab_t, 0.75)), (n, seed, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1000, 1024])
def test_cuda_nms_one_block_kernel_to_its_most(cuda, monkeypatch, n):
    """The one-block kernel (rows in shared memory, 128 KB at N = 1024) at
    sizes the wrapper gives the scratch path: the same keep masks."""
    monkeypatch.setattr(nms, "WALK_FROM", nms.ONE_BLOCK_MAX + 1)
    for seed, grid in ((0, True), (1, False)):
        iou, labels = _nms_case(seed, n, grid)
        iou_t = torch.from_numpy(iou).to(cuda)
        lab_t = torch.from_numpy(labels).to(cuda, torch.int64)
        assert torch.equal(nms.greedy_mask_nms(iou_t, lab_t, 0.75),
                           nms.greedy_mask_nms_plain(iou_t, lab_t, 0.75)), (n, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 6000, 8192])
def test_cuda_nms_past_one_walk_block(cuda, n):
    """Past 4096 candidates (a walk block) K4 walks in blocks, each seeded
    from the kept candidates before it: at 4097 (one candidate in the second
    block), 6000 and 8192 (two whole blocks), seeded IoUs with ties with the
    threshold, at random, and sparse (kept candidates in every block), one
    label, two and three: keep masks exactly the plain loop's, one launch a
    call."""
    for seed, case in ((0, "grid"), (1, "random"), (2, "sparse")):
        if case == "sparse":
            iou, labels = _sparse_nms_case(seed, n)
        else:
            iou, labels = _nms_case(seed, n, case == "grid")
        if case == "random":
            labels[:] = 0
        iou_t = torch.from_numpy(iou).to(cuda)
        lab_t = torch.from_numpy(labels).to(cuda, torch.int64)
        before = nms.LAUNCHES
        got = nms.greedy_mask_nms(iou_t, lab_t, 0.75)
        assert nms.LAUNCHES == before + 1
        assert torch.equal(got, nms.greedy_mask_nms_plain(iou_t, lab_t, 0.75)), (n, seed)


@pytest.mark.cuda
def test_cuda_box_nms_matches_plain(cuda):
    """box_nms on the card (K4) against the same steps with the plain loop:
    seeded boxes with score ties and -inf scores, N = 1000 (the RPN's) and
    1800 (the TTA merge's)."""
    from s2d_tpu_torch.ops.boxes import box_nms, pairwise_iou

    rng = np.random.RandomState(0)
    for n in (1000, 1800):
        xy = rng.uniform(0, 448, (n, 2))
        boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(8, 160, (n, 2))], 1)
                                 .astype(np.float32)).to(cuda)
        scores = np.round(rng.rand(n) * 16) / 16
        scores[rng.rand(n) < 0.1] = -np.inf
        scores = torch.from_numpy(scores.astype(np.float32)).to(cuda)
        for thresh in (0.5, 0.7):
            got = box_nms(boxes, scores, thresh)
            order = torch.argsort(-scores, stable=True)
            iou = pairwise_iou(boxes[order], boxes[order]).contiguous()
            keep = torch.zeros_like(got)
            keep[order] = nms.greedy_mask_nms_plain(iou, torch.zeros_like(order), thresh)
            assert torch.equal(got, keep), (n, thresh)


@pytest.mark.cuda
@pytest.mark.parametrize("gqp", [255, 258])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_msda_ablate_ragged_points(cuda, variant, gqp):
    """K6 with a point count not a multiple of 4 (rows not 16-byte aligned,
    a ragged last group of 3 or 2 points): bit for bit the plain version."""
    args = _ablate_tensors(*_ablate_inputs(8, gqp=gqp), device=cuda)
    got = msda_ablate_cuda.msda_ablate(variant, *args, ABLATE["w"], ABLATE["d"])
    torch.cuda.synchronize()
    ref = msda_ablate_plain(variant, *args, ABLATE["w"], ABLATE["d"])
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_msda_ablate_tool_shapes(cuda, variant):
    """K6 at the ablation tool's defaults (vt (8, 640, 128): 160 KB an i,
    staged in shared memory for full) and at --w 48 (vt[i] 384 KB: too
    large to stage, read from L2): bit for bit the plain version."""
    from s2d_tpu_torch.tools import bench_pallas_ablate as tool

    for argv in ([], ["--w", "48", "--g", "2"]):
        args = tool.parse_args(argv)
        inputs = tool.make_inputs(args, cuda)
        got = tool.call(msda_ablate_cuda.msda_ablate, variant, inputs, args)
        torch.cuda.synchronize()
        ref = tool.call(msda_ablate_plain, variant, inputs, args)
        assert torch.equal(got, ref), (argv, float((got - ref).abs().max()))


@pytest.mark.cuda
def test_cuda_reference_checkpoint_eval_student(cuda, tmp_path):
    """A full-width reference-layout student/teacher .pth (the torch oracle
    of tests/torch_oracle.py, two seeds) through `VideoPredictor`'s loader
    on the card: EVAL_STUDENT on gives the student's outputs, off the
    teacher's. Each is held to the oracle's own forward of its network (f32,
    TF32 off) at the golden tolerance, rtol 1e-3 / atol 2e-3."""
    import dataclasses

    from s2d_tpu_torch.config import VideoConfig
    from s2d_tpu_torch.demo_video import VideoPredictor
    from s2d_tpu_torch.models.meta_arch import preprocess_clip
    from torch_oracle import TorchVideoMaskFormer

    cfg = VideoConfig(amp=False)
    nets = {}
    for which, seed in (("student", 11), ("teacher", 12)):
        torch.manual_seed(seed)
        nets[which] = TorchVideoMaskFormer().eval()
    kd = {f"{who}.{0 if k.startswith('backbone.') else 1}.{k.split('.', 1)[1]}": v
          for who, net in nets.items() for k, v in net.state_dict().items()}
    path = str(tmp_path / "kd.pth")
    torch.save({"model": kd}, path)
    clip = np.random.RandomState(3).randint(0, 256, (2, 128, 192, 3), dtype=np.uint8)
    images, _ = preprocess_clip(clip, cfg.pixel_mean, cfg.pixel_std, 32, cuda)
    for eval_student in (True, False):
        which = "student" if eval_student else "teacher"
        predictor = VideoPredictor(dataclasses.replace(cfg, eval_student=eval_student),
                                   weights=path, device=cuda)
        assert predictor.loaded == "reference"
        out, _ = predictor.forward(clip)
        with torch.no_grad(), cuda:  # the oracle makes some constants without a device
            ref = nets[which].to(cuda)(images[0].permute(0, 3, 1, 2).contiguous(), 2)
        nets[which].cpu()
        for key in ("pred_logits", "pred_masks"):
            torch.testing.assert_close(out[key], ref[key], rtol=1e-3, atol=2e-3, msg=key)
