"""Point tracking for keymask discovery: the port of `s2d_tpu/keymask/tracker.py`.

Every pipeline stage depends only on the `PointTracker` protocol

    track(video, queries, query_frame) -> tracks (T, P, 2), visibility (T, P)

(numpy in, numpy out). `CorrelationTracker` is the template-matching
tracker of the JAX package: per point and frame transition, the NCC of a
patch template from the previous frame against every integer offset of a
search window in the next, the point carried by the best offset (the first
maximum), and visibility from the match's correlation and the image bounds.
Tracks are carried forward and backward from each point's own seed frame.

The JAX package reads its windows with one-hot contractions (the TPU has no
fast gather) and pads the point count to buckets (against jit retraces);
here a window is an index gather and points are chunked only to bound
memory (`BATCH_POINTS` a pass): the results do not depend on either.
"""
from __future__ import annotations

import hashlib
import time
from typing import Protocol, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LUMA = (0.299, 0.587, 0.114)
# the JAX tracker's defaults, which no caller changes: the template's side,
# the search radius in pixels, and the correlation at which visibility is 0
PATCH, SEARCH, MIN_CORR = 9, 12, 0.3
# points of one pass of `CorrelationTracker.track_batch`: each holds ~35 KB
# of indices, windows and correlation maps, ~0.6 GB a pass on any device
BATCH_POINTS = 16384


class PointTracker(Protocol):
    def track(
        self, video: np.ndarray, queries: np.ndarray, query_frame: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """video (T, H, W, 3) uint8/float; queries (P, 2) xy pixel coords at
        `query_frame`. Returns (tracks (T, P, 2), visibility (T, P) in
        [0, 1]) for ALL frames (tracked forward and backward)."""
        ...


class DeviceVideoCache:
    """One-entry cache of the preprocessed video on the device.

    Discovery tracks many (seed frame, mask) sets over the SAME video, so
    the video is converted and uploaded once. Keyed by (buffer address,
    shape, dtype, strided digest): the digest is an order-sensitive hash of
    every 64th pixel of every frame, so a recycled buffer with other frames
    misses; an in-place edit that leaves all of those pixels untouched is
    outside the contract."""

    def __init__(self, convert):
        self._convert = convert  # np.ndarray -> device value
        self._key = None
        self._value = None

    @staticmethod
    def _fingerprint(video: np.ndarray):
        sample = np.ascontiguousarray(video[:, ::64, ::64])
        return (
            video.__array_interface__["data"][0],
            video.shape,
            str(video.dtype),
            hashlib.blake2b(sample.tobytes(), digest_size=16).hexdigest(),
        )

    def get(self, video: np.ndarray):
        key = self._fingerprint(video)
        if key != self._key:
            self._value = self._convert(video)
            self._key = key
        return self._value


def grey_video(video: np.ndarray, device) -> torch.Tensor:
    """(T, H, W, 3) video -> (T, H, W) f32 luma on `device`. uint8 goes up
    as bytes and is converted there (elementwise multiply and sum); float
    RGB is converted on the host with a matmul; a (T, H, W[, 1]) video is
    already grey."""
    video = np.asarray(video)
    if video.ndim == 4 and video.shape[-1] == 3:
        if video.dtype == np.uint8:
            u8 = torch.from_numpy(np.ascontiguousarray(video)).to(device)
            return (u8.float() * torch.tensor(LUMA, device=device)).sum(-1)
        grey = video.astype(np.float32) @ np.asarray(LUMA, np.float32)
        return torch.from_numpy(np.ascontiguousarray(grey)).to(device)
    grey = np.asarray(video, np.float32).reshape(video.shape[:3])
    return torch.from_numpy(np.ascontiguousarray(grey)).to(device)


class CorrelationTracker:
    """Template-matching tracker (see the module doc); `device` holds the
    video and runs the matching. `point_frames` and `seconds` add up what
    `track_batch` tracked and the wall time it took (its results are read
    back to the host, so that time includes the device's). The JAX
    tracker's `levels` and `fb_threshold` change nothing there and are not
    kept; its `patch`, `search` and `min_corr` are the module's constants."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self._video_cache = DeviceVideoCache(lambda v: grey_video(v, self.device))
        self.point_frames, self.seconds = 0, 0.0

    def track(self, video, queries, query_frame=0):
        return self.track_batch(video, [queries], [query_frame])[0]

    def track_batch(self, video, queries_list, query_frames):
        """Many (queries, seed frame) sets over the SAME video. Points are
        independent, so all sets are concatenated along the point axis
        with a per-point seed frame. Returns [(tracks, vis), ...]."""
        sizes = [len(q) for q in queries_list]
        if not sizes:
            return []
        start = time.perf_counter()
        grey = self._video_cache.get(np.asarray(video))
        q_all = np.concatenate([np.asarray(q, np.float32).reshape(-1, 2) for q in queries_list])
        qf_all = np.concatenate([np.full((n,), f, np.int64) for n, f in zip(sizes, query_frames)])
        tracks_parts, vis_parts = [], []
        with torch.inference_mode():
            for s in range(0, len(q_all), BATCH_POINTS):
                tr, vi = track_bidirectional(
                    grey, torch.from_numpy(q_all[s:s + BATCH_POINTS]).to(self.device),
                    torch.from_numpy(qf_all[s:s + BATCH_POINTS]).to(self.device),
                    PATCH, SEARCH, MIN_CORR)
                tracks_parts.append(tr.cpu().numpy())
                vis_parts.append(vi.cpu().numpy())
        tracks = np.concatenate(tracks_parts, axis=1) if tracks_parts else np.zeros(
            (grey.shape[0], 0, 2), np.float32)
        vis = np.concatenate(vis_parts, axis=1) if vis_parts else np.zeros(
            (grey.shape[0], 0), np.float32)
        out, off = [], 0
        for n in sizes:
            out.append((tracks[:, off:off + n], vis[:, off:off + n]))
            off += n
        self.point_frames += len(q_all) * grey.shape[0]
        self.seconds += time.perf_counter() - start
        return out


def extract_windows(img: torch.Tensor, anchors: torch.Tensor, size: int, half: int) -> torch.Tensor:
    """(H, W) image + (P, 2) integer xy anchors -> (P, size, size) windows
    spanning anchor-half .. anchor+size-1-half; out-of-image pixels read 0."""
    h, w = img.shape
    offs = torch.arange(size, device=img.device) - half
    rows = anchors[:, 1, None] + offs  # (P, size)
    cols = anchors[:, 0, None] + offs
    inside = ((rows >= 0) & (rows < h))[:, :, None] & ((cols >= 0) & (cols < w))[:, None, :]
    win = img[rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside, win, torch.zeros((), dtype=img.dtype, device=img.device))


def _frac_shift(win: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Bilinear sub-pixel shift: (P, S, S) windows sampled at +frac (P, 2)
    -> (P, S-1, S-1), in the JAX package's order of operations."""
    fx = frac[:, 0, None, None]
    fy = frac[:, 1, None, None]
    return (
        win[:, :-1, :-1] * (1 - fx) * (1 - fy)
        + win[:, :-1, 1:] * fx * (1 - fy)
        + win[:, 1:, :-1] * (1 - fx) * fy
        + win[:, 1:, 1:] * fx * fy
    )


def ncc_maps(img_prev, img_next, pts, patch, search):
    """NCC of each point's template (a patch at its fractional location in
    `img_prev`) against every integer offset in [-search, search]^2 of
    `img_next`: (P, 2*search + 1, 2*search + 1), [dy, dx] = offset
    (dy - search, dx - search).

    Geometry: after the sub-pixel shift, window pixel i maps to image
    offset i - half + frac; a VALID patch-conv output k then has its patch
    centre at offset k + (patch-1)//2 - half + frac, so half = search +
    (patch-1)//2 makes k = 0..2*search span -search..+search."""
    p = pts.shape[0]
    anchor_f = torch.floor(pts)
    frac = pts - anchor_f
    anchor = anchor_f.to(torch.int64)
    half_t = (patch - 1) // 2
    win_sz = 2 * search + patch + 1  # +1 for the sub-pixel shift
    template = _frac_shift(extract_windows(img_prev, anchor, patch + 1, half_t), frac)
    win = _frac_shift(extract_windows(img_next, anchor, win_sz, search + half_t), frac)

    def slide(kernel, data):  # one group per point: (P, C, C)
        return F.conv2d(data[None], kernel[:, None], groups=p)[0]

    # sum(t0 * (w - mean_w)) = sum(t0 * w): t0 is zero-mean
    t0 = template - template.mean(dim=(1, 2), keepdim=True)
    npix = patch * patch
    ones = torch.ones_like(template)
    corr_raw = slide(t0, win)
    w_sum = slide(ones, win)
    w_sq = slide(ones, win * win)
    t_var = (t0 * t0).sum(dim=(1, 2))[:, None, None]
    w_var = w_sq - w_sum * w_sum / npix
    return corr_raw / (torch.sqrt(t_var * torch.clamp(w_var, min=0.0)) + 1e-6)


def match_step(img_prev, img_next, pts, patch, search):
    """One frame transition for all points: (new_pts, corr of the match).
    The best offset is the first maximum of the NCC map (torch.argmax and
    jnp.argmax both take the first)."""
    corrs = ncc_maps(img_prev, img_next, pts, patch, search)
    p, c = corrs.shape[0], corrs.shape[-1]
    flat = corrs.reshape(p, c * c)
    best = torch.argmax(flat, dim=1)
    best_corr = flat.gather(1, best[:, None])[:, 0]
    off_y = (best // c - search).to(pts.dtype)
    off_x = (best % c - search).to(pts.dtype)
    return pts + torch.stack([off_x, off_y], dim=-1), best_corr.clamp(-1.0, 1.0)


def track_bidirectional(grey, queries, query_frame, patch, search, min_corr):
    """(T, H, W) grey, (P, 2) queries, (P,) per-point seed frames ->
    tracks (T, P, 2), vis (T, P). Two sequential passes over the T - 1
    transitions, forward and backward; a point's carry stays at its query
    until the pass reaches its own seed frame."""
    t, h, w = grey.shape
    p = queries.shape[0]

    def direction(idxs, step, started_fn):
        pts, traj, corrs = queries, [], []
        for fi in idxs:
            new_pts, corr = match_step(grey[fi], grey[fi + step], pts, patch, search)
            started = started_fn(fi)
            pts = torch.where(started[:, None], new_pts, queries)
            traj.append(pts)
            corrs.append(torch.where(started, corr, torch.ones_like(corr)))
        if not traj:
            return queries.new_zeros((0, p, 2)), queries.new_zeros((0, p))
        return torch.stack(traj), torch.stack(corrs)

    # forward: transitions fi -> fi+1 for fi = 0..t-2, active once fi >= seed
    ftraj, fcorr = direction(range(t - 1), 1, lambda fi: fi >= query_frame)
    # backward: transitions fi -> fi-1 for fi = t-1..1, active once fi <= seed
    btraj, bcorr = direction(range(t - 1, 0, -1), -1, lambda fi: fi <= query_frame)

    ones = queries.new_ones((1, p))
    f_all = torch.cat([queries[None], ftraj])  # frame k: forward result
    fc_all = torch.cat([ones, fcorr])
    b_all = torch.cat([btraj.flip(0), queries[None]])  # frames 0..t-2 reversed back
    bc_all = torch.cat([bcorr.flip(0), ones])

    frames = torch.arange(t, device=grey.device)
    use_f = frames[:, None] > query_frame[None, :]  # (t, p)
    use_b = frames[:, None] < query_frame[None, :]
    tracks = torch.where(use_f[..., None], f_all,
                         torch.where(use_b[..., None], b_all, queries[None]))
    corrs = torch.where(use_f, fc_all, torch.where(use_b, bc_all, ones))
    inbounds = ((tracks[..., 0] >= 0) & (tracks[..., 0] <= w - 1)
                & (tracks[..., 1] >= 0) & (tracks[..., 1] <= h - 1))
    vis = torch.clamp((corrs - min_corr) / (1.0 - min_corr), 0.0, 1.0)
    return tracks, vis * inbounds.to(vis.dtype)


def grid_points_in_mask(mask: np.ndarray, grid_size: int) -> np.ndarray:
    """Up to grid_size^2 seed points inside a binary mask: a float64 grid
    over the frame, kept where the mask holds at the nearest pixel (round
    half to even), cast to f32. Returns (P, 2) xy pixel coords."""
    mask = np.asarray(mask).astype(bool)  # 0/255 uint8 must select, not index
    h, w = mask.shape
    ys = np.linspace(0, h - 1, grid_size)
    xs = np.linspace(0, w - 1, grid_size)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], -1)
    keep = mask[
        np.clip(pts[:, 1].round().astype(int), 0, h - 1),
        np.clip(pts[:, 0].round().astype(int), 0, w - 1),
    ]
    return pts[keep].astype(np.float32)
