"""CoTracker-style neural point tracker, the port of `s2d_tpu/keymask/cotracker.py`,
with the import of upstream-layout torch checkpoints.

  * `CoTrackerNet`: a stride-4 convolutional feature encoder (`encode`: the
    video -> a feature pyramid, once a video) and an iterative refinement
    (`refine`): the full correlation map of every track's template at
    every pyramid level, a (2r+1)^2 window of it around each current
    estimate, and an update transformer that alternates attention over
    time (per track) and over tracks (per frame) to predict coordinate and
    visibility-logit deltas. Many (queries, seed frame) sets refine in one
    call, each its own track-attention group.
  * `CoTrackerTracker`: the `PointTracker` over it; videos are resized to
    `INTERP_HW`, coordinates rescaled back, the pyramid cached a
    video, and sets refined in chunks sized to the device's free memory.
  * `torch_key_for`, `to_torch_state_dict`, `convert_cotracker_state_dict`,
    `load_cotracker_checkpoint`, `build_cotracker`: the bijective table
    between this net's parameters and an upstream-shaped state_dict (the
    public co-tracker module names: `fnet.*`, `updateformer.*` with fused
    attention `qkv`, `time_emb`); unmapped or missing keys raise with the
    full report, never dropped.

Parameter names follow the JAX package's flax tree (`checkpoint/from_jax.py`
carries JAX params across), and the arithmetic keeps flax's defaults:
LayerNorm eps 1e-6, tanh-approximated gelu, separate q/k/v/out projections
with masked logits filled with finfo.min, and `jax.image.resize`'s
bilinear resize, which antialiases when it downsamples (`F.interpolate`
with antialias=True computes the same triangle filter). Where the JAX
package contracts one-hot matrices to read windows (no fast gather on the
TPU), this gathers.
"""
from __future__ import annotations

import math
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sampling import grid_sample_rows
from .tracker import DeviceVideoCache

# (height, width) every video is resized to before it is encoded: the
# resolution the public CoTracker checkpoints were trained at
INTERP_HW = (384, 512)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size), as `jax.image.resize(..., "bilinear")`."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


class ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1)
        self.norm1 = nn.GroupNorm(8, features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)
        self.norm2 = nn.GroupNorm(8, features, eps=1e-5)
        self.downsample = (nn.Conv2d(cin, features, 1, stride)
                           if stride != 1 or cin != features else None)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class FeatureEncoder(nn.Module):
    """Stride-4 CNN: residual stages at strides 2, 4, 8, fused at stride 4."""

    def __init__(self, latent_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.norm1 = nn.GroupNorm(8, 64, eps=1e-5)
        self.layer1 = ResBlock(64, 64, 1)  # stride 2
        self.layer2 = ResBlock(64, 96, 2)  # stride 4
        self.layer3 = ResBlock(96, 128, 2)  # stride 8
        self.fuse = nn.Conv2d(64 + 96 + 128, latent_dim, 1)

    def forward(self, frames):  # (T, 3, H, W) -> (T, latent_dim, H/4, W/4)
        x = F.relu(self.norm1(self.conv1(frames)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        size = tuple(b.shape[-2:])
        return self.fuse(torch.cat([resize_bilinear(a, size), b, resize_bilinear(c, size)], 1))


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention (self-attention, no dropout)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, mask=None):  # x (B, S, D); mask (B, 1, 1, S) bool over keys
        b, s, d = x.shape
        hd = d // self.heads

        def split(y):
            return y.view(b, s, self.heads, hd).transpose(1, 2)  # (B, H, S, hd)

        q = split(self.query(x)) / math.sqrt(hd)
        logits = q @ split(self.key(x)).transpose(-1, -2)  # (B, H, S, S)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        y = torch.softmax(logits, dim=-1) @ split(self.value(x))
        return self.out(y.transpose(1, 2).reshape(b, s, d))


class AttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp1 = nn.Linear(dim, 4 * dim)
        self.mlp2 = nn.Linear(4 * dim, dim)

    def forward(self, x, mask=None):
        x = x + self.attn(self.norm1(x), mask)
        return x + self.mlp2(F.gelu(self.mlp1(self.norm2(x)), approximate="tanh"))


class UpdateFormer(nn.Module):
    """Alternating time/track attention over (B, T, P, D) token grids; `depth`
    pairs of blocks `time{i}`, `space{i}`."""

    def __init__(self, dim: int = 256, heads: int = 8, depth: int = 4):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"time{i}", AttnBlock(dim, heads))
            self.add_module(f"space{i}", AttnBlock(dim, heads))

    def forward(self, tokens, point_valid=None):  # (B, T, P, D), (B, P) bool
        b, t, p, d = tokens.shape
        # padded points stay out of the track attention: they would otherwise
        # move the real tracks of their set
        mask = None if point_valid is None else (
            point_valid[:, None, None, None, :].expand(b, t, 1, 1, p).reshape(b * t, 1, 1, p))
        x = tokens
        for i in range(self.depth):
            xt = x.transpose(1, 2).reshape(b * p, t, d)  # per track, over time
            xt = getattr(self, f"time{i}")(xt)
            x = xt.reshape(b, p, t, d).transpose(1, 2)
            x = getattr(self, f"space{i}")(x.reshape(b * t, p, d), mask).reshape(b, t, p, d)
        return x


def corr_maps(pyramid: Sequence[torch.Tensor], track_feat: torch.Tensor) -> List[torch.Tensor]:
    """Per level, the full correlation of every track's template (N, C)
    with every position of every frame of that level (T, h, w, C): (T, N,
    h*w) = fmap . track_feat / sqrt(C). Once a refine call: the templates do
    not change across the iterations."""
    maps = []
    for f in pyramid:
        t, h, w, c = f.shape
        scale = torch.sqrt(torch.tensor(float(c), dtype=f.dtype, device=f.device))
        maps.append((track_feat @ f.reshape(t, h * w, c).transpose(1, 2)) / scale)
    return maps


def corr_features(maps: Sequence[torch.Tensor], sizes: Sequence[Tuple[int, int]],
                  coords: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Bilinear (2r+1)^2 windows of each track's correlation map around its
    current estimate, per level: an integer-anchored (2r+2)^2 window gathered
    (zero outside the map), then the sub-pixel blend in the JAX package's
    order. maps: per level (T, N, h*w) from `corr_maps`, `sizes` their (h,
    w); coords (T, N, 2) in stride-4 units. Returns (T, N, L*(2r+1)^2),
    [ky, kx] the offset (ky - r, kx - r)."""
    t, n, _ = coords.shape
    size = 2 * radius + 2  # integer corners span [-r, r+1]
    offs = torch.arange(size, device=coords.device) - radius
    k1 = 2 * radius + 1
    feats = []
    for li, (cm, (h, w)) in enumerate(zip(maps, sizes)):
        pts = coords / (2.0 ** li)
        base = torch.floor(pts)
        frac = pts - base
        base = base.to(torch.int64)
        rows = base[..., 1, None] + offs  # (T, N, size)
        cols = base[..., 0, None] + offs
        inside = (((rows >= 0) & (rows < h))[..., :, None]
                  & ((cols >= 0) & (cols < w))[..., None, :])  # (T, N, size, size)
        idx = rows.clamp(0, h - 1)[..., :, None] * w + cols.clamp(0, w - 1)[..., None, :]
        win = cm.gather(2, idx.reshape(t, n, size * size)).reshape(t, n, size, size)
        win = torch.where(inside, win, torch.zeros((), dtype=win.dtype, device=win.device))
        fy = frac[..., 1, None, None]
        fx = frac[..., 0, None, None]
        blend = (
            win[..., :k1, :k1] * (1.0 - fy) * (1.0 - fx)
            + win[..., :k1, 1:] * (1.0 - fy) * fx
            + win[..., 1:, :k1] * fy * (1.0 - fx)
            + win[..., 1:, 1:] * fy * fx
        )
        feats.append(blend.reshape(t, n, k1 * k1))
    return torch.cat(feats, dim=-1)


class CoTrackerNet(nn.Module):
    """`encode` (video -> pyramid, per video) and `refine` (pyramid +
    query sets -> tracks). Attribute names fix the parameter names the
    checkpoint table and `from_jax` are built on."""

    def __init__(self, latent_dim: int = 128, dim: int = 256, heads: int = 8, depth: int = 4,
                 iters: int = 4, levels: int = 3, radius: int = 3):
        super().__init__()
        self.iters, self.levels, self.radius = iters, levels, radius
        self.fnet = FeatureEncoder(latent_dim)
        self.input_proj = nn.Linear(levels * (2 * radius + 1) ** 2 + 3, dim)
        self.delta_head = nn.Linear(dim, 3)  # (dx, dy, dvis)
        self.updateformer = UpdateFormer(dim, heads, depth)
        self.time_embed = nn.Parameter(torch.zeros(64, dim))

    def encode(self, frames: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """frames (T, 3, H, W) -> per level (T, h, w, C), channels last."""
        f = self.fnet(frames)
        pyramid = []
        for _ in range(self.levels):
            pyramid.append(f.permute(0, 2, 3, 1).contiguous())
            f = F.avg_pool2d(f, 2, 2)
        return tuple(pyramid)

    def refine(self, pyramid, queries, query_frames, point_valid=None):
        """pyramid from `encode`; queries (B, P, 2) xy pixels of the encoded
        resolution, query_frames (B,) their seed frames, point_valid (B, P)
        which points are real (padding is kept out of the track
        attention). Returns tracks (B, T, P, 2) pixels, visibility (B, T,
        P) in [0, 1]."""
        t, h4, w4, c = pyramid[0].shape
        b, p, _ = queries.shape
        q4 = queries / 4.0
        qnorm = torch.stack([(q4[..., 0] + 0.5) / w4, (q4[..., 1] + 0.5) / h4], -1) * 2.0 - 1.0
        track_feat = grid_sample_rows(pyramid[0][query_frames].reshape(b, h4 * w4, c),
                                      qnorm, h4, w4)  # (B, P, C)
        maps = corr_maps(pyramid, track_feat.reshape(b * p, c))
        sizes = [tuple(f.shape[1:3]) for f in pyramid]

        sets = torch.arange(b, device=queries.device)
        coords = q4[:, None].expand(b, t, p, 2).clone()
        vis_logit = queries.new_zeros((b, t, p))
        time_embed = self.time_embed[torch.clamp(torch.arange(t, device=queries.device),
                                                 max=self.time_embed.shape[0] - 1)]
        for _ in range(self.iters):
            corr = corr_features(maps, sizes, coords.transpose(0, 1).reshape(t, b * p, 2),
                                 self.radius).reshape(t, b, p, -1).transpose(0, 1)
            rel = coords - coords[sets, query_frames][:, None]
            tokens = self.input_proj(torch.cat([corr, rel / 16.0, vis_logit[..., None]], -1))
            tokens = tokens + time_embed[None, :, None, :]
            delta = self.delta_head(self.updateformer(tokens, point_valid))
            coords = coords + delta[..., :2]
            vis_logit = vis_logit + delta[..., 2]
            coords[sets, query_frames] = q4  # the seed frame stays at the queries
        return coords * 4.0, torch.sigmoid(vis_logit)

    def forward(self, frames, queries, query_frames, point_valid=None):
        return self.refine(self.encode(frames), queries, query_frames, point_valid)


def init_params(net: nn.Module, seed: int = 0) -> nn.Module:
    """Seeds `net` in place from its own generator with flax's initializers
    in kind (not JAX's numbers): convolution and linear weights lecun-normal
    (a normal truncated at 2 std, std sqrt(1/fan_in)), biases 0, norm scales
    1, `time_embed` N(0, 0.02^2)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                w = module.weight
                std = math.sqrt(1.0 / (w[0].numel())) / 0.87962566103423978
                w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std,
                                                    -2 * std, 2 * std, generator=gen))
                module.bias.zero_()
            elif isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
                module.weight.fill_(1.0)
                module.bias.zero_()
        if isinstance(net, CoTrackerNet):
            net.time_embed.copy_(torch.randn(net.time_embed.shape, generator=gen) * 0.02)
    return net


class CoTrackerTracker:
    """`PointTracker` over a `CoTrackerNet` on `device`. The encoded pyramid
    is cached per video (one `encode` a video); `track_batch` refines its
    sets in chunks, each set padded to the chunk's largest and its padding
    kept out of the track attention. A chunk holds as many sets as fit in
    half the device's free memory (`set_bytes`). `point_frames` and
    `seconds` add up what `track_batch` tracked and its wall time (results
    read back to the host); `peak_bytes` is the peak device memory of the
    last `track_batch` on a CUDA device."""

    def __init__(self, net: CoTrackerNet, device="cuda"):
        self.device = torch.device(device)
        self.net = net.to(self.device).eval()
        self._pyramid_cache = DeviceVideoCache(self._encode)
        self.point_frames, self.seconds, self.peak_bytes = 0, 0.0, 0

    def _encode(self, video: np.ndarray):
        if video.dtype == np.uint8:
            frames = torch.from_numpy(np.ascontiguousarray(video)).to(self.device).float() / 255.0
        else:
            frames = torch.from_numpy(np.asarray(video, np.float32) / 255.0).to(self.device)
        frames = resize_bilinear(frames.permute(0, 3, 1, 2), INTERP_HW)
        with torch.inference_mode():
            return self.net.encode(frames)

    def set_bytes(self, t: int, p: int) -> int:
        """Device bytes one set of `p` points holds while it refines: its
        correlation maps at every level (with their matmul's output), the
        gathered windows, and the track attention's logits and weights."""
        net, h4, w4 = self.net, INTERP_HW[0] // 4, INTERP_HW[1] // 4
        positions = sum((h4 >> li) * (w4 >> li) for li in range(net.levels))
        heads = net.updateformer.time0.attn.heads
        windows = net.levels * (2 * net.radius + 2) ** 2 * 3  # index, values, mask
        return 4 * t * p * (2 * positions + windows + 2 * heads * p)

    def _chunk(self, t: int, p: int) -> int:
        if self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]
        else:
            free = 4 << 30
        return max(1, (free // 2) // self.set_bytes(t, p))

    def track(self, video, queries, query_frame=0):
        return self.track_batch(video, [queries], [query_frame])[0]

    def track_batch(self, video, queries_list, query_frames):
        """Many (queries, seed frame) sets over the SAME video, each its own
        track-attention group. Returns [(tracks (T, P, 2), vis (T, P)), ...]."""
        video = np.asarray(video)
        t, h, w = video.shape[:3]
        if not len(queries_list):
            return []
        start = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        pyramid = self._pyramid_cache.get(video)
        scale = np.asarray([INTERP_HW[1] / w, INTERP_HW[0] / h], np.float32)
        scale_back = np.asarray([w / INTERP_HW[1], h / INTERP_HW[0]], np.float32)
        sizes = [len(q) for q in queries_list]
        chunk = self._chunk(t, max(max(sizes), 1))
        out = []
        for s in range(0, len(sizes), chunk):
            part = range(s, min(s + chunk, len(sizes)))
            p = max(max(sizes[i] for i in part), 1)
            q = np.zeros((len(part), p, 2), np.float32)
            valid = np.zeros((len(part), p), bool)
            for j, i in enumerate(part):
                q[j, :sizes[i]] = np.asarray(queries_list[i], np.float32).reshape(-1, 2) * scale
                valid[j, :sizes[i]] = True
            frames = torch.as_tensor([query_frames[i] for i in part], dtype=torch.int64)
            with torch.inference_mode():
                tracks, vis = self.net.refine(
                    pyramid, torch.from_numpy(q).to(self.device), frames.to(self.device),
                    torch.from_numpy(valid).to(self.device))
            tracks, vis = tracks.cpu().numpy(), vis.cpu().numpy()
            for j, i in enumerate(part):
                out.append((tracks[j, :, :sizes[i]] * scale_back, vis[j, :, :sizes[i]]))
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        self.point_frames += sum(sizes) * t
        self.seconds += time.perf_counter() - start
        return out


# ------------------------------------------------------- checkpoint import

# The upstream module path of each module of this net whose name differs
# (the co-tracker BasicEncoder / updateformer spelling); attention blocks
# `time{i}`/`space{i}` are `time_blocks.{i}`/`space_virtual_blocks.{i}`, and
# the residual stages `layer{n}` are Sequentials of one block, `layer{n}.0`.
_MODULE_RENAMES = {
    "input_proj": ("updateformer", "input_transform"),
    "delta_head": ("updateformer", "flow_head"),
    "mlp1": ("mlp", "fc1"),
    "mlp2": ("mlp", "fc2"),
    "fuse": ("conv2",),
}
_PROJECTIONS = ("query", "key", "value")


def _upstream_modules(mods: Sequence[str]) -> List[str]:
    out: List[str] = []
    for m in mods:
        blk = re.fullmatch(r"(time|space)(\d+)", m)
        if blk:
            out.extend(["time_blocks" if blk.group(1) == "time" else "space_virtual_blocks",
                        blk.group(2)])
        elif re.fullmatch(r"layer[123]", m):
            out.extend([m, "0"])
        elif m in _MODULE_RENAMES:
            out.extend(_MODULE_RENAMES[m])
        else:
            out.append(m)
    return out


def torch_key_for(name: str) -> str:
    """This net's parameter name -> its upstream torch key. The attention
    projections are fused (`attn.qkv`, `attn.proj`) by the converters,
    not here."""
    if name == "time_embed":
        return "time_emb"
    *mods, leaf = name.split(".")
    return ".".join(_upstream_modules(mods) + [leaf])


def _attn_prefixes(names) -> List[str]:
    """The distinct module paths that own an `attn` submodule, e.g.
    'updateformer.time0'."""
    return list(dict.fromkeys(n[: n.index(".attn.")] for n in names if ".attn." in n))


def to_torch_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """This net's state_dict -> an upstream-shaped one (fused (3D, D) qkv,
    OIHW convolutions, (out, in) linears), for tests and interop."""
    state = {k: v.detach().cpu().numpy() for k, v in state.items()}
    sd: Dict[str, np.ndarray] = {}
    for prefix in _attn_prefixes(state):
        base = ".".join(_upstream_modules(prefix.split("."))) + ".attn."
        for kind in ("weight", "bias"):
            sd[base + "qkv." + kind] = np.concatenate(
                [state[f"{prefix}.attn.{proj}.{kind}"] for proj in _PROJECTIONS])
            sd[base + "proj." + kind] = state[f"{prefix}.attn.out.{kind}"]
    for name, arr in state.items():
        if ".attn." not in name:
            sd[torch_key_for(name)] = arr
    return sd


def convert_cotracker_state_dict(sd: Dict[str, np.ndarray],
                                 reference: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Upstream-shaped state_dict -> this net's state_dict (float32 CPU
    tensors), for every name of `reference` (a `CoTrackerNet.state_dict()`).
    Missing or unmapped keys raise with the full report; a shape that
    disagrees raises."""
    out: Dict[str, torch.Tensor] = {}
    used, missing = set(), []

    def take(key: str, name: str, rows: Optional[slice] = None):
        if key not in sd:
            missing.append(key)
            return
        arr = np.asarray(sd[key], np.float32)
        arr = arr if rows is None else arr[rows]
        if arr.shape != tuple(reference[name].shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {arr.shape} vs model "
                             f"{tuple(reference[name].shape)} ({name})")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
        used.add(key)

    for prefix in _attn_prefixes(reference):
        base = ".".join(_upstream_modules(prefix.split("."))) + ".attn."
        dim = reference[f"{prefix}.attn.out.weight"].shape[0]
        for j, proj in enumerate(_PROJECTIONS):
            for kind in ("weight", "bias"):
                take(base + "qkv." + kind, f"{prefix}.attn.{proj}.{kind}",
                     slice(j * dim, (j + 1) * dim))
        for kind in ("weight", "bias"):
            take(base + "proj." + kind, f"{prefix}.attn.out.{kind}")
    for name in reference:
        if ".attn." not in name:
            take(torch_key_for(name), name)
    extra = sorted(set(sd) - used)
    if missing or extra:
        raise ValueError(
            "checkpoint/model key mismatch:\n"
            f"  missing in checkpoint: {sorted(set(missing))}\n"
            f"  unmapped in checkpoint: {extra}\n"
            "  (upstream-only modules, such as virtual tracks or extra encoder blocks, "
            "have no counterpart in this net: its architecture differs on purpose, "
            "see AB_KEYMASK.md)")
    return out


def load_cotracker_checkpoint(path: str, net: CoTrackerNet) -> CoTrackerNet:
    """Loads an upstream-shaped CoTracker .pth into `net`, strictly; the
    "model." / "module.model." prefix of its keys is stripped."""
    from ..checkpoint.torch_import import load_torch_checkpoint

    sd = {k.split("model.", 1)[-1] if k.startswith(("model.", "module.model.")) else k: v
          for k, v in load_torch_checkpoint(path).items()}
    net.load_state_dict(convert_cotracker_state_dict(sd, net.state_dict()), strict=True)
    return net


def build_cotracker(checkpoint: Optional[str] = None, device="cuda",
                    seed: int = 0) -> CoTrackerTracker:
    """The tracker at the full width; with `checkpoint`, its weights, else
    the seeded init (`init_params`)."""
    net = init_params(CoTrackerNet(), seed)
    if checkpoint:
        load_cotracker_checkpoint(checkpoint, net)
    return CoTrackerTracker(net, device)
