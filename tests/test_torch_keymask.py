"""Keymask discovery of the port (`s2d_tpu_torch.keymask`) against the JAX
package's (`s2d_tpu.keymask`) on the CPU.

The correlation tracker's match is a hard argmax over an NCC map, and the
point is carried on from it: one flipped near-tie changes the rest of a
track. The parity videos are therefore integer translations of a random
texture (a global one, and a textured square over a static texture), and
the tests assert that on every transition the port's tracks take, the best
NCC beats the second best by MARGIN, far above the two frameworks'
difference; then the tracks must be identical.

The NCC values agree to NCC_ATOL and the visibility to VIS_ATOL (it is
(corr - 0.3) / 0.7 of it), not closer: both frameworks compute the NCC in
float32, and its window variance is the difference of two sums of ~1e6, so
each carries a rounding error of ~1e-5 of its own. Against the same formula
in float64 the port's best correlations are off by up to 1.4e-5 and JAX's by
6.3e-6 (XLA contracts the sub-pixel blend into fused multiply-adds and sums
its convolutions in another order), and JAX's own NCC of one offset, which
`_jax_ncc_map` reads, by 2.6e-5 (x86 CPU, these tests' inputs). MAP_ATOL holds the maps to
that reading.

The stages after the tracker (curves, windows, matching, clustering,
quality, annotations, candidate masks) get the same tracker outputs in both
packages and must give equal results. DBSCAN is held to scikit-learn's on
240 seeded random binary matrices, distances exactly at eps among them.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sklearn.cluster import DBSCAN

from s2d_tpu import keymask as jk
from s2d_tpu.keymask import export as jexport
from s2d_tpu.keymask import tracker as jtracker
from s2d_tpu_torch import keymask as pk
from s2d_tpu_torch.data.png import read_png
from s2d_tpu_torch.keymask import dbscan, export as pexport, tracker as ptracker

T, H, W = 6, 48, 64
NCC_ATOL = 3e-5
MAP_ATOL = 5e-5
VIS_ATOL = 5e-5
MARGIN = 1e-3  # best NCC minus the second best, on every transition taken


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the tests run beside others in parallel workers,
    where OpenMP threads of every worker would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _translated(rng, velocity, t=T, h=H, w=W):
    """A random RGB texture translated by `velocity` (dx, dy) pixels a frame."""
    pad = 4 + max(abs(v) for v in velocity) * t
    tex = rng.randint(0, 256, (h + 2 * pad, w + 2 * pad, 3), np.uint8)
    return np.stack([tex[pad - velocity[1] * i:pad - velocity[1] * i + h,
                         pad - velocity[0] * i:pad - velocity[0] * i + w] for i in range(t)])


def _square_video(rng, size=20, velocity=(3, 1)):
    """A textured square moving over a static texture; its masks."""
    bg = rng.randint(0, 256, (H, W, 3), np.uint8)
    patch = rng.randint(0, 256, (size, size, 3), np.uint8)
    video, masks = np.repeat(bg[None], T, axis=0), np.zeros((T, H, W), bool)
    for i in range(T):
        y, x = 10 + velocity[1] * i, 8 + velocity[0] * i
        video[i, y:y + size, x:x + size] = patch
        masks[i, y:y + size, x:x + size] = True
    return video, masks


@pytest.fixture(scope="module")
def videos():
    rng = np.random.RandomState(0)
    square, masks = _square_video(rng)
    interior = np.zeros_like(masks)
    for i in range(T):  # seeds at least a patch half from the square's edge
        ys, xs = np.nonzero(masks[i])
        interior[i, ys.min() + 5:ys.max() - 4, xs.min() + 5:xs.max() - 4] = True
    return {
        "global": (_translated(rng, (2, -1)), None),
        "square": (square, masks),
        "square_interior": (square, interior),
    }


def _sets(video_key, videos):
    """(queries, seed frame) sets of a parity video: grid points in its
    middle (global translation) or in the square's interior."""
    video, masks = videos[video_key]
    if masks is None:
        inner = np.zeros((H, W), bool)
        inner[14:34, 14:50] = True
        return video, [(ptracker.grid_points_in_mask(inner, 9), f) for f in (0, 2, T - 1)]
    return video, [(ptracker.grid_points_in_mask(masks[f], 12), f) for f in (0, 3, T - 1)]


@pytest.fixture(scope="module")
def tracked(videos):
    """One JAX run and one port run of track_batch per parity video; the
    port's passes hold 7 points, so pass boundaries cut through sets."""
    out = {}
    for key in ("global", "square_interior"):
        video, sets = _sets(key, videos)
        qs, fs = [q for q, _ in sets], [f for _, f in sets]
        assert sum(map(len, qs)) > 7 and 7 not in np.cumsum(list(map(len, qs)))
        jax_out = jtracker.CorrelationTracker(batch_points=64).track_batch(video, qs, fs)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ptracker, "BATCH_POINTS", 7)
            port_out = ptracker.CorrelationTracker(device="cpu").track_batch(video, qs, fs)
        out[key] = (video, sets, jax_out, port_out)
    return out


def _grey(video):
    return ptracker.grey_video(video, "cpu")


def _jax_ncc_map(img_prev, img_next, pts, patch=9, search=12):
    """JAX's NCC map, read from its own `_match_step`: with search 0 it
    returns the NCC of offset 0, so each offset is one call on `img_next`
    shifted by it (zero fill, as an out-of-image read)."""
    h, w = img_next.shape
    pad = jnp.pad(jnp.asarray(img_next), search)
    offs = [(dy, dx) for dy in range(-search, search + 1) for dx in range(-search, search + 1)]

    @jax.jit
    def one(off):
        shifted = jax.lax.dynamic_slice(pad, (search + off[0], search + off[1]), (h, w))
        return jtracker._match_step(jnp.asarray(img_prev), shifted, jnp.asarray(pts),
                                    patch, 0, 2)[1]

    corr = jax.vmap(one)(jnp.asarray(offs))  # (offsets, P)
    return np.asarray(corr).T.reshape(len(pts), 2 * search + 1, 2 * search + 1)


def test_match_step_ncc_maps(videos):
    video, _ = videos["square"]
    grey = _grey(video)
    rng = np.random.RandomState(3)
    # the maps where the template's window lies in the frame (there the
    # shifted frames of `_jax_ncc_map` read what the search window reads)
    inner = rng.uniform(4, [W - 7, H - 7], (24, 2)).astype(np.float32)
    got = ptracker.ncc_maps(grey[1], grey[2], torch.from_numpy(inner), 9, 12).numpy()
    want = _jax_ncc_map(grey[1].numpy(), grey[2].numpy(), inner)
    # JAX's offset-0 call clips to [-1, 1] as a match does
    np.testing.assert_allclose(np.clip(got, -1, 1), want, rtol=0, atol=MAP_ATOL)
    # the match anywhere, borders and outside too
    pts = np.concatenate([inner, rng.uniform(0, [W - 1, H - 1], (16, 2)),
                          rng.uniform(-3, 0, (2, 2))]).astype(np.float32)
    got = ptracker.ncc_maps(grey[1], grey[2], torch.from_numpy(pts), 9, 12).numpy()
    new_j, corr_j = jtracker._match_step(jnp.asarray(grey[1].numpy()), jnp.asarray(grey[2].numpy()),
                                         jnp.asarray(pts), 9, 12, 2)
    new_p, corr_p = ptracker.match_step(grey[1], grey[2], torch.from_numpy(pts), 9, 12)
    np.testing.assert_allclose(corr_p.numpy(), np.asarray(corr_j), rtol=0, atol=NCC_ATOL)
    flat = np.sort(got.reshape(len(pts), -1), axis=1)
    decided = flat[:, -1] - flat[:, -2] > MARGIN  # where no near-tie decides the match
    assert decided.sum() >= len(pts) // 2
    np.testing.assert_array_equal(new_p.numpy()[decided], np.asarray(new_j)[decided])


def _margins(video, tracks, seed):
    """The port's best-minus-second NCC on every transition its tracks
    take (forward from each point's seed frame, and backward)."""
    grey = _grey(video)
    margins = []
    for fi in range(T - 1):
        for a, b, active in ((fi, fi + 1, seed <= fi), (fi + 1, fi, seed >= fi + 1)):
            if active.any():
                maps = ptracker.ncc_maps(grey[a], grey[b], torch.from_numpy(tracks[a][active]), 9, 12)
                top = torch.topk(maps.reshape(int(active.sum()), -1), 2, dim=1).values
                margins.append((top[:, 0] - top[:, 1]).numpy())
    return np.concatenate(margins)


@pytest.mark.parametrize("key", ["global", "square_interior"])
def test_tracks_identical_with_margins(tracked, key):
    video, sets, jax_out, port_out = tracked[key]
    for (queries, frame), (tj, vj), (tp, vp) in zip(sets, jax_out, port_out):
        assert tp.shape == (T, len(queries), 2) and vp.shape == (T, len(queries))
        seed = np.full(len(queries), frame)
        assert _margins(video, tp, seed).min() > MARGIN
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_allclose(vp, vj, rtol=0, atol=VIS_ATOL)
        np.testing.assert_array_equal(tp[frame], queries)
    # the known motion: every point of the global translation moves (2, -1) a frame
    if key == "global":
        step = np.float32([2, -1])
        for (queries, frame), (tp, _) in zip(sets, port_out):
            want = np.repeat(queries[None], T, axis=0)
            for fi in range(frame + 1, T):
                want[fi] = want[fi - 1] + step
            for fi in range(frame - 1, -1, -1):
                want[fi] = want[fi + 1] + (-step)
            np.testing.assert_array_equal(tp, want)


def test_track_equals_track_batch_and_cache(videos, tracked):
    video, sets, _, port_out = tracked["square_interior"]
    tracker = ptracker.CorrelationTracker(device="cpu")
    for (queries, frame), (tb, vb) in zip(sets, port_out):
        ts, vs = tracker.track(video, queries, query_frame=frame)
        np.testing.assert_array_equal(ts, tb)
        np.testing.assert_array_equal(vs, vb)
    assert tracker.point_frames == T * sum(len(q) for q, _ in sets) and tracker.seconds > 0
    grey = tracker._video_cache._value
    tracker.track(video, sets[0][0], 0)
    assert tracker._video_cache._value is grey  # a hit
    other = video.copy()
    other[0, 0, 0] ^= 255  # a sampled pixel: a miss
    tracker.track(other, sets[0][0], 0)
    assert tracker._video_cache._value is not grey
    assert tracker.track_batch(video, [], []) == []


def test_grey_conversion():
    rng = np.random.RandomState(4)
    video = rng.randint(0, 256, (3, 17, 23, 3), np.uint8)
    grey = _grey(video).numpy()
    np.testing.assert_allclose(grey, np.asarray(jtracker._grey_video_to_device(video)),
                               rtol=0, atol=1e-4)
    as_float = video.astype(np.float64)  # the host route: a float32 matmul, as JAX's
    np.testing.assert_array_equal(_grey(as_float).numpy(),
                                  np.asarray(jtracker._grey_video_to_device(as_float)))
    np.testing.assert_array_equal(_grey(grey).numpy(), grey)


def test_grid_points_in_mask():
    rng = np.random.RandomState(5)
    for grid, (h, w) in [(50, (48, 64)), (7, (33, 20)), (25, (720, 1280)), (12, (5, 9))]:
        mask = rng.rand(h, w) > 0.6
        for m in (mask, mask.astype(np.uint8) * 255):
            got = pk.grid_points_in_mask(m, grid)
            want = jk.grid_points_in_mask(m, grid)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


class FakeTracker:
    """Deterministic tracks from the queries and seed frame, the same in
    both packages: drift by the seed frame, visibility that crosses every
    threshold the stages use. `track` only: the stages' per-set path."""

    def track(self, video, queries, query_frame=0):
        t = len(video)
        q = np.asarray(queries, np.float32)
        steps = np.arange(t, dtype=np.float32)[:, None, None] - query_frame
        tracks = q[None] + steps * np.float32([1.5, 0.5 - 0.25 * (query_frame % 3)])
        phase = (q[:, 0] * 0.37 + q[:, 1] * 0.11 + query_frame)[None]
        vis = (0.5 + 0.5 * np.sin(phase + np.arange(t)[:, None])).astype(np.float32)
        return tracks, vis


class FakeBatchTracker(FakeTracker):
    def track_batch(self, video, queries_list, query_frames):
        return [self.track(video, q, f) for q, f in zip(queries_list, query_frames)]


def _fake(batch=True):
    return FakeBatchTracker() if batch else FakeTracker()


def _scene():
    """Masks of a few drifting rectangles on a (T, 40, 56) video, keyed by
    overall id (0, 1, ... in frame order), with a missing and an extra one."""
    rng = np.random.RandomState(6)
    video = rng.randint(0, 256, (T, 40, 56, 3), np.uint8)
    boxes = [(5, 5, 14, 18), (20, 30, 12, 16), (2, 36, 10, 12)]
    frame_masks, nxt = [], 0
    for fi in range(T):
        masks = {}
        for k, (y, x, hh, ww) in enumerate(boxes):
            if (fi, k) == (2, 1):
                continue  # dropped
            m = np.zeros((40, 56), bool)
            m[y + fi // 2:y + fi // 2 + hh, x + fi:x + fi + ww] = True
            masks[nxt] = m
            nxt += 1
        if fi == 4:
            m = np.zeros((40, 56), bool)
            m[30:38, 2:9] = True
            masks[nxt] = m
            nxt += 1
        frame_masks.append(masks)
    return video, frame_masks


def test_visibility_curves_and_masks_from_png(tmp_path):
    video, frame_masks = _scene()
    for batch in (True, False):
        got = pk.extract_visibility_curves(video, frame_masks, _fake(batch), grid_size=12)
        want = jk.extract_visibility_curves(video, frame_masks, _fake(batch), grid_size=12)
        assert got == want and len(got) > 2 * T  # a mask with < 4 grid points seeds none
    pk.save_visibility_json(str(tmp_path / "v" / "curves.json"), got)
    assert json.loads((tmp_path / "v" / "curves.json").read_text()) == got
    png = np.zeros((20, 30, 3), np.uint8)
    png[2:6, 2:6] = (255, 0, 0)
    png[8:12, 8:20] = (0, 255, 0)
    png[14:18, 1:3] = (7, 7, 7)
    got, want = pk.load_masks_from_color_png(png), jk.load_masks_from_color_png(png)
    assert list(got) == list(want) == [1, 2, 3]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    rng = np.random.RandomState(12)
    for channels in (3, 4, 1):  # colours that share their first channels, and black
        palette = rng.choice([0, 7, 128, 255], (12, channels)).astype(np.uint8)
        png = palette[rng.randint(0, 12, (30, 41))]
        got, want = pk.load_masks_from_color_png(png), jk.load_masks_from_color_png(png)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="uint8"):
        pk.load_masks_from_color_png(png.astype(np.int64))


def test_visibility_windows():
    rng = np.random.RandomState(7)
    for case in range(30):
        n, t = rng.randint(0, 40), rng.randint(3, 30)
        protos = rng.rand(3, t)
        curves = np.clip(protos[rng.randint(0, 3, n)] + rng.normal(0, 0.15, (n, t)), 0, 1)
        kw = dict(threshold=0.3 + 0.1 * (case % 3), eps=[0.2, 0.1, 0.3][case % 3],
                  min_samples=1 + case % 5)
        assert pk.visibility_windows(curves, **kw) == jk.visibility_windows(curves, **kw)
    assert pk.visibility_windows(np.zeros((0, 5))) == []


def _binary_cases():
    """240 seeded binary matrices: rows drawn around a few prototypes, with
    the feature counts and eps of the two stages (ties at eps: 2/10 = 0.2,
    5/50 = 0.1, 6/24 = 0.25, 3/60 = 0.05) and every min_samples from 1 to 6."""
    rng = np.random.RandomState(8)
    families = [(10, 0.2), (24, 0.25), (50, 0.1), (60, 0.05), (7, 0.3), (5, 0.1)]
    for i in range(240):
        f, eps = families[i % len(families)]
        n = rng.randint(1, 80)
        protos = rng.rand(rng.randint(1, 5), f) > 0.5
        flips = rng.rand(n, f) < rng.choice([0.02, 0.05, 0.15])
        yield protos[rng.randint(0, len(protos), n)] ^ flips, eps, 1 + i % 6


def test_dbscan_equals_sklearn():
    at_eps = 0
    for x, eps, min_samples in _binary_cases():
        want = DBSCAN(eps=eps, min_samples=min_samples, metric="hamming").fit(
            x.astype(np.float64)).labels_
        got = dbscan.dbscan_hamming(x, eps, min_samples)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"eps {eps}, min_samples {min_samples}")
        d = (x[:, None, :] != x[None, :, :]).sum(-1)
        at_eps += int((d / np.float64(x.shape[1]) == eps).sum())
    assert at_eps > 1000  # many pairs sit exactly at eps, and count as neighbours
    assert dbscan.dbscan_hamming(np.zeros((0, 4), bool), 0.2, 5).shape == (0,)


def test_point_mask_iou():
    rng = np.random.RandomState(9)
    for _ in range(50):
        h, w = rng.randint(5, 40, 2)
        mask = rng.rand(h, w) > 0.5
        pts = rng.uniform(-3, max(h, w) + 3, (rng.randint(3, 30), 2)).astype(np.float32)
        pts[:3] = np.float32([[0.5, 1.5], [2.5, 2.5], [w - 0.5, h + 0.5]])  # half to even
        vis = rng.rand(len(pts)).astype(np.float32)
        vis[:2] = 0.5
        assert pk.point_mask_iou(pts, vis, mask) == jk.point_mask_iou(pts, vis, mask)
    assert pk.point_mask_iou(pts, np.zeros(len(pts)), mask) == 0.0


@pytest.fixture(scope="module")
def matched():
    video, frame_masks = _scene()
    rng = np.random.RandomState(10)
    candidates = [(fi, frame_masks[fi][k]) for fi in range(T) for k in frame_masks[fi]
                  if rng.rand() < 0.8]
    candidates.append((1, np.zeros((40, 56), bool)))  # too few points: no match
    return video, frame_masks, candidates


@pytest.mark.parametrize("threshold", [0.5, 0.3, -0.1])
def test_match_candidates(matched, threshold):
    video, frame_masks, candidates = matched
    for batch in (True, False):
        got = pk.match_candidates(video, _fake(batch), candidates, frame_masks, threshold)
        want = jk.match_candidates(video, _fake(batch), candidates, frame_masks, threshold)
        assert got == want
    assert any(got) and not got[-1]
    fi, mask = candidates[0]
    assert (pk.match_candidate(video, _fake(), mask, fi, frame_masks, threshold)
            == jk.match_candidate(video, _fake(), mask, fi, frame_masks, threshold))


def test_match_candidates_with_the_trackers(videos):
    """Both packages' own correlation trackers on the square video: the
    same matches (the tracks are identical, see above)."""
    video, masks = videos["square"]
    _, interior = videos["square_interior"]
    frame_masks = [{10 * fi + 1: masks[fi], 10 * fi + 2: ~masks[fi]} for fi in range(T)]
    candidates = [(0, interior[0]), (3, interior[3]), (5, interior[5])]
    tracker = ptracker.CorrelationTracker(device="cpu")
    for fi, mask in candidates:
        pts = pk.grid_points_in_mask(mask, pk.adaptive_grid_size(mask.sum()))
        tracks, _ = tracker.track(video, pts, fi)
        assert _margins(video, tracks, np.full(len(pts), fi)).min() > MARGIN
    got = pk.match_candidates(video, tracker, candidates, frame_masks, 0.5)
    want = jk.match_candidates(video, jtracker.CorrelationTracker(batch_points=64), candidates,
                               frame_masks, 0.5)  # the program `tracked` compiled
    assert got == want
    assert all(got[0].get(10 * fi + 1) for fi in range(T))  # the square follows itself


def test_clustering_every_branch_of_the_width_table():
    """Widths 5 and 9 (< 10: eps 0.1, min_samples 3), 10 and 50 (eps 0.1,
    min_samples 5), 51 and 60 (> 50: eps 0.05, min_samples 5), the
    overrides, and rows without a match forced to noise."""
    rng = np.random.RandomState(11)
    for width in (5, 9, 10, 50, 51, 60):
        for n in (2, 3, 5, 8, 30):
            protos = rng.rand(3, width) > 0.6
            mat = protos[rng.randint(0, 3, n)] ^ (rng.rand(n, width) < 0.03)
            mat[rng.rand(n) < 0.2] = False
            for kw in ({}, {"min_samples": 1}, {"eps": 0.3}, {"min_samples": 2, "eps": 0.01}):
                got = pk.temporal_correspondence_clustering(mat, **kw)
                want = jk.temporal_correspondence_clustering(mat, **kw)
                np.testing.assert_array_equal(got, want)
                assert (got[mat.sum(axis=1) == 0] == -1).all()
    assert pk.temporal_correspondence_clustering(np.zeros((0, 4), bool)).shape == (0,)


def test_match_matrix_and_group_quality(matched):
    video, frame_masks, candidates = matched
    matches = pk.match_candidates(video, _fake(), candidates, frame_masks, 0.3)
    ids = [k for masks in frame_masks for k in masks]
    frame_of_id = [fi for fi, masks in enumerate(frame_masks) for _ in masks]
    mat = pk.match_matrix(matches, ids[:-1])  # an id outside the list is ignored
    np.testing.assert_array_equal(mat, jk.match_matrix(matches, ids[:-1]))
    mat = pk.match_matrix(matches, ids)
    for min_samples in (1, 2, 3):
        labels = pk.temporal_correspondence_clustering(mat, min_samples=min_samples)
        got = pk.group_quality(mat, labels, frame_of_id)
        assert got == jk.group_quality(mat, labels, frame_of_id)
    assert got
    assert pk.group_quality(mat, np.full(len(mat), -1), frame_of_id) == []


def test_annotations_merge_and_convert(tmp_path):
    _, frame_masks = _scene()
    masks = [list(m.values())[0] for m in frame_masks]
    groups = [{"group": 0, "one2x": 0, "coverage": 1.0}, {"group": 1, "one2x": 3}]
    per_group = [[masks[0], None, masks[2], np.zeros_like(masks[0]), masks[4], masks[5]],
                 [None, masks[1], None, None, None, masks[5] | masks[4]]]
    names = [f"v/{i:05d}.png" for i in range(T)]
    paths = []
    for vid in (7, 3):
        kw = dict(video_id=vid, file_names=names, height=40, width=56, groups=groups,
                  group_masks=per_group, visibility_ranges=[(0, 4)] if vid == 7 else None)
        got, want = pk.write_annotation_for_video(**kw), jk.write_annotation_for_video(**kw)
        assert json.dumps(got) == json.dumps(want)
        paths.append(tmp_path / f"v{vid}.json")
        paths[-1].write_text(json.dumps(got))
    for threshold in (None, 2):
        got = pk.merge_video_jsons([str(p) for p in paths], one2x_threshold=threshold)
        assert got == jk.merge_video_jsons([str(p) for p in paths], one2x_threshold=threshold)
    assert len(got["annotations"]) == 2  # the one2x 3 tracks dropped
    merged = pk.merge_video_jsons([str(p) for p in paths])
    results = [dict(a, score=s) for a, s in zip(merged["annotations"], (0.9, 0.5, 0.75, 0.8))]
    for threshold in (0.75, 0.0):
        got = pk.convert_results_to_annotations(results, merged["videos"], threshold)
        assert got == jk.convert_results_to_annotations(results, merged["videos"], threshold)
    assert len(got["annotations"]) == 4


def test_candidate_mask_export(tmp_path):
    import cv2

    _, frame_masks = _scene()
    records = [{"frame": fi, "mask_id": k, "visibility": [1.0] * T}
               for fi in range(T) for k in frame_masks[fi]]
    records.append({"frame": 1, "mask_id": 2, "visibility": [1.0] * T})  # ordinal fallback
    records.append({"frame": 0, "mask_id": 99, "visibility": [1.0] * T})  # no such mask
    windows = [{"cluster": 0, "range": (0, 3), "winners": [0, 4, len(records) - 2]},
               {"cluster": 2, "range": (1, 5), "winners": [1, len(records) - 1]}]
    got = pexport.save_candidate_masks(str(tmp_path / "p"), windows, records, frame_masks)
    want = jexport.save_candidate_masks(str(tmp_path / "j"), windows, records, frame_masks)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] and len(got) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                      cv2.imread(b, cv2.IMREAD_UNCHANGED))
        np.testing.assert_array_equal(read_png(a), cv2.cvtColor(cv2.imread(b), cv2.COLOR_BGR2RGB))
