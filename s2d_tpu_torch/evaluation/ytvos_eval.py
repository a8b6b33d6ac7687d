"""Video instance segmentation AP (YTVIS protocol): the port's copy of
`s2d_tpu/evaluation/ytvos_eval.py`, host numpy code that gives the same
metrics bit for bit (tests/test_torch_eval.py).

It re-implements the evaluation semantics of the reference's vendored
YTVOSeval (`data_video/datasets/ytvis_api/ytvoseval.py`):

  * track IoU is SPATIO-TEMPORAL: sum of per-frame mask intersections over
    sum of per-frame unions across the whole video (iou_seq, lines 203-217);
    missing frames count as empty masks
  * COCO matching/accumulation: IoU thresholds 0.5:0.05:0.95, greedy
    score-ordered matching per threshold, 101-point interpolated precision
  * area ranges on the track's average per-frame area (present frames),
    maxDets [1, 10, 100]
  * class-agnostic mode (useCats=0) merges every category into one, as the
    reference evaluator sets for S2D (`ytvis_eval.py:385-387`)

Inputs are plain dicts; predictions use the results.json schema the
reference dumps (video_id, category_id, score, segmentations: per-frame
RLE or None).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native as _native
from ..data import rle as rle_codec

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 128.0 ** 2),
    "medium": (128.0 ** 2, 256.0 ** 2),
    "large": (256.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def iou_seq(d_segs: Sequence, g_segs: Sequence) -> float:
    """Spatio-temporal track IoU (sum-inter / sum-union over frames)."""
    inter, union = 0, 0
    for d, g in zip(d_segs, g_segs):
        if d is not None and g is not None:
            i, u = rle_codec.iou_intersection_union(d, g)
            inter += i
            union += u
        elif d is not None:
            union += rle_codec.area(d)
        elif g is not None:
            union += rle_codec.area(g)
    return inter / union if union > 0 else 0.0


def _track_ious(dts: List[dict], gts: List[dict]) -> np.ndarray:
    """Pairwise spatio-temporal IoU, via the native run-merge kernel when
    available (s2d_tpu_torch/native), else the per-pair python path."""
    t = max(len(x["segmentations"]) for x in list(dts) + list(gts))

    def counts_track(x):
        return [
            rle_codec.rle_counts(s) if s is not None else None
            for s in x["segmentations"]
        ]

    mat = _native.track_iou_matrix(
        [counts_track(d) for d in dts], [counts_track(g) for g in gts], t
    )
    if mat is not None:
        return mat
    ious = np.zeros((len(dts), len(gts)))
    for di, d in enumerate(dts):
        for gi, g in enumerate(gts):
            ious[di, gi] = iou_seq(d["segmentations"], g["segmentations"])
    return ious


def _avg_area(segs: Sequence) -> float:
    areas = [rle_codec.area(s) for s in segs if s is not None]
    return float(np.mean(areas)) if areas else 0.0


@dataclasses.dataclass
class _VidEval:
    dt_scores: np.ndarray  # (D,)
    dt_matches: np.ndarray  # (T, D) matched gt id or 0
    dt_ignore: np.ndarray  # (T, D)
    gt_ignore: np.ndarray  # (G,)
    num_gt: int


def _evaluate_group(
    gts: List[dict], dts: List[dict], area_rng, max_det: int, iou_fn=None
) -> Optional[_VidEval]:
    if not gts and not dts:
        return None
    crowd = np.array([g.get("iscrowd", 0) == 1 for g in gts], dtype=bool)
    gt_ignore = crowd | np.array(
        [not (area_rng[0] <= g["avg_area"] <= area_rng[1]) for g in gts],
        dtype=bool,
    )
    order_g = np.argsort(gt_ignore, kind="stable")  # non-ignored first
    gts = [gts[i] for i in order_g]
    gt_ignore = gt_ignore[order_g]
    crowd = crowd[order_g]

    dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
    t = len(IOU_THRS)
    d_n, g_n = len(dts), len(gts)
    dt_matches = np.zeros((t, d_n), dtype=np.int64)
    dt_ignore = np.zeros((t, d_n), dtype=bool)

    if d_n and g_n:
        if iou_fn is None:
            ious = _track_ious(dts, gts)
        else:
            ious = np.zeros((d_n, g_n))
            for di, d in enumerate(dts):
                for gi, g in enumerate(gts):
                    ious[di, gi] = iou_fn(d["segmentations"], g["segmentations"])
        for ti, thr in enumerate(IOU_THRS):
            gt_taken = np.zeros(g_n, dtype=bool)
            for di in range(d_n):
                best_iou = min(thr, 1 - 1e-10)
                best_gi = -1
                for gi in range(g_n):
                    # a taken gt can only be re-matched if it is a crowd
                    # region (COCOeval semantics)
                    if gt_taken[gi] and not crowd[gi]:
                        continue
                    if best_gi > -1 and not gt_ignore[best_gi] and gt_ignore[gi]:
                        break  # can't beat a real match with an ignored one
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_gi = gi
                if best_gi >= 0:
                    gt_taken[best_gi] = True
                    dt_matches[ti, di] = 1
                    dt_ignore[ti, di] = gt_ignore[best_gi]

    # unmatched dts outside the area range are ignored
    dt_out = np.array(
        [not (area_rng[0] <= d["avg_area"] <= area_rng[1]) for d in dts], dtype=bool
    )
    dt_ignore = dt_ignore | ((dt_matches == 0) & dt_out[None, :])

    return _VidEval(
        dt_scores=np.array([d["score"] for d in dts]),
        dt_matches=dt_matches,
        dt_ignore=dt_ignore,
        gt_ignore=gt_ignore,
        num_gt=int((~gt_ignore).sum()),
    )


def evaluate_detections_boxes(
    gt_annotations: List[dict],
    predictions: List[dict],
    use_cats: bool = True,
) -> Dict[str, float]:
    """COCO-style box AP for image detections (the CutLER eval protocol,
    reference `cutler/evaluation/coco_evaluation.py`): each image is a
    single-frame 'video' whose IoU is box IoU. Entries carry
    {image_id, category_id, bbox (xyxy), score?}."""
    import numpy as _np

    def to_track(e):
        x0, y0, x1, y1 = e["bbox"]
        area = max(x1 - x0, 0) * max(y1 - y0, 0)
        return {
            "video_id": e.get("image_id", e.get("video_id")),
            "category_id": e["category_id"],
            "segmentations": [tuple(e["bbox"])],  # opaque payload for iou
            "avg_area": float(area),
            "iscrowd": e.get("iscrowd", 0),
            **({"score": e["score"]} if "score" in e else {}),
        }

    gts = [to_track(g) for g in gt_annotations]
    dts = [to_track(d) for d in predictions]

    def box_iou(d_segs, g_segs):
        (dx0, dy0, dx1, dy1), (gx0, gy0, gx1, gy1) = d_segs[0], g_segs[0]
        ix = max(0.0, min(dx1, gx1) - max(dx0, gx0))
        iy = max(0.0, min(dy1, gy1) - max(dy0, gy0))
        inter = ix * iy
        union = (
            max(dx1 - dx0, 0) * max(dy1 - dy0, 0)
            + max(gx1 - gx0, 0) * max(gy1 - gy0, 0)
            - inter
        )
        return inter / union if union > 0 else 0.0

    return _evaluate_generic(gts, dts, use_cats, iou_fn=box_iou)


def detection_to_track(e: dict) -> dict:
    """Image detection/annotation -> single-frame track entry for the
    generic accumulator (shared by segm AP and boundary AP)."""
    seg = e["segmentation"]
    return {
        "video_id": e.get("image_id", e.get("video_id")),
        "category_id": e["category_id"],
        "segmentations": [seg],
        "avg_area": float(rle_codec.area(seg)),
        "iscrowd": e.get("iscrowd", 0),
        **({"score": e["score"]} if "score" in e else {}),
    }


def evaluate_detections_masks(
    gt_annotations: List[dict],
    predictions: List[dict],
    use_cats: bool = True,
) -> Dict[str, float]:
    """COCO-style segm (mask) AP for image detections — the reference's
    COCO evaluator scores masks when TEST.NO_SEGM=False
    (`cutler/evaluation/coco_evaluation.py`). Entries carry
    {image_id, category_id, segmentation (RLE dict), score?}; each image is
    a single-frame 'video' so the RLE track-IoU path applies unchanged."""
    gts = [detection_to_track(g) for g in gt_annotations]
    dts = [detection_to_track(d) for d in predictions]
    return _evaluate_generic(gts, dts, use_cats)


def evaluate_vis(
    gt_annotations: List[dict],
    predictions: List[dict],
    use_cats: bool = False,
) -> Dict[str, float]:
    """Compute the YTVIS metric dict (AP, AP50, AP75, APs/m/l, AR1/10/100).

    gt_annotations: {video_id, category_id, segmentations, iscrowd?}
    predictions:    {video_id, category_id, score, segmentations}
    """
    for a in gt_annotations:
        a.setdefault("avg_area", _avg_area(a["segmentations"]))
    for d in predictions:
        d.setdefault("avg_area", _avg_area(d["segmentations"]))
    return _evaluate_generic(gt_annotations, predictions, use_cats)


def _evaluate_generic(
    gt_annotations: List[dict],
    predictions: List[dict],
    use_cats: bool,
    iou_fn=None,
) -> Dict[str, float]:
    cat_of = (lambda x: x["category_id"]) if use_cats else (lambda x: 0)
    video_ids = sorted(
        {a["video_id"] for a in gt_annotations}
        | {d["video_id"] for d in predictions}
    )
    cats = sorted({cat_of(a) for a in gt_annotations} | {0})

    gt_by = defaultdict(list)
    dt_by = defaultdict(list)
    for a in gt_annotations:
        gt_by[(a["video_id"], cat_of(a))].append(a)
    for d in predictions:
        dt_by[(d["video_id"], cat_of(d))].append(d)

    # accumulate per (cat, area, maxDet)
    t = len(IOU_THRS)
    r = len(RECALL_THRS)
    precision = -np.ones((t, r, len(cats), len(AREA_RNGS), len(MAX_DETS)))
    recall = -np.ones((t, len(cats), len(AREA_RNGS), len(MAX_DETS)))

    for ci, cat in enumerate(cats):
        for ai, (aname, arng) in enumerate(AREA_RNGS.items()):
            for mi, max_det in enumerate(MAX_DETS):
                evals = [
                    _evaluate_group(
                        gt_by.get((v, cat), []), dt_by.get((v, cat), []),
                        arng, max_det, iou_fn,
                    )
                    for v in video_ids
                ]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                scores = np.concatenate([e.dt_scores for e in evals])
                order = np.argsort(-scores, kind="mergesort")
                matches = np.concatenate([e.dt_matches for e in evals], axis=1)[:, order]
                ignores = np.concatenate([e.dt_ignore for e in evals], axis=1)[:, order]
                num_gt = sum(e.num_gt for e in evals)
                if num_gt == 0:
                    continue
                tps = np.logical_and(matches, ~ignores)
                fps = np.logical_and(~matches.astype(bool), ~ignores)
                tp_sum = np.cumsum(tps, axis=1).astype(float)
                fp_sum = np.cumsum(fps, axis=1).astype(float)
                for ti in range(t):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    rc = tp / num_gt
                    pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                    recall[ti, ci, ai, mi] = rc[-1] if len(rc) else 0.0
                    # monotone precision envelope
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.zeros(r)
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, ci, ai, mi] = q

    def _ap(thr=None, area="all", max_det=100):
        ai = list(AREA_RNGS).index(area)
        mi = MAX_DETS.index(max_det)
        p = precision[:, :, :, ai, mi]
        if thr is not None:
            p = p[[int(np.argwhere(np.isclose(IOU_THRS, thr))[0][0])]]
        p = p[p > -1]
        return float(np.mean(p)) if p.size else float("nan")

    def _ar(area="all", max_det=100):
        ai = list(AREA_RNGS).index(area)
        mi = MAX_DETS.index(max_det)
        rr = recall[:, :, ai, mi]
        rr = rr[rr > -1]
        return float(np.mean(rr)) if rr.size else float("nan")

    return {
        "AP": _ap(),
        "AP50": _ap(thr=0.5),
        "AP75": _ap(thr=0.75),
        "APs": _ap(area="small"),
        "APm": _ap(area="medium"),
        "APl": _ap(area="large"),
        "AR1": _ar(max_det=1),
        "AR10": _ar(max_det=10),
        "AR100": _ar(max_det=100),
    }
