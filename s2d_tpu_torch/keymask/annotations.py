"""Keymask annotation writer, dataset merger and round-2 converter, the
port of `s2d_tpu/keymask/annotations.py`:

  * `write_annotation_for_video`: each temporal group becomes one YTVIS
    annotation (per-frame COCO RLE, bbox and area from the RLE, the one
    category {"id": 1, "name": "fg"}, its one2x, coverage and visibility
    ranges); one JSON per video;
  * `merge_video_jsons`: per-video JSONs -> one dataset, video and
    annotation ids renumbered, tracks with one2x above a threshold dropped;
  * `convert_results_to_annotations`: an eval results.json -> round-2
    training annotations (score threshold, bbox and area recomputed from
    the RLE, the gt videos' metadata).
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from ..data import rle as rle_codec

def write_annotation_for_video(
    video_id: int,
    file_names: List[str],
    height: int,
    width: int,
    groups: List[dict],  # from matching.group_quality
    group_masks: List[Sequence[Optional[np.ndarray]]],  # per group: per-frame mask|None
    visibility_ranges: Optional[List] = None,
) -> dict:
    """One video's YTVIS-format JSON (videos + annotations + category fg)."""
    annotations = []
    for ann_idx, (group, masks) in enumerate(zip(groups, group_masks), start=1):
        segs, bboxes, areas = [], [], []
        for mask in masks:
            if mask is None or mask.sum() == 0:
                segs.append(None)
                bboxes.append(None)
                areas.append(None)
            else:
                enc = rle_codec.encode(mask.astype(bool))
                segs.append(enc)
                bboxes.append(rle_codec.to_bbox(enc))
                areas.append(rle_codec.area(enc))
        annotations.append(
            {
                "id": ann_idx,
                "video_id": video_id,
                "category_id": 1,
                "segmentations": segs,
                "bboxes": bboxes,
                "areas": areas,
                "iscrowd": 0,
                "one2x": group.get("one2x", 0),
                "coverage": group.get("coverage", 1.0),
                "visibility_ranges": visibility_ranges or [],
                "height": height,
                "width": width,
                "length": len(file_names),
            }
        )
    return {
        "videos": [
            {
                "id": video_id,
                "file_names": file_names,
                "height": height,
                "width": width,
                "length": len(file_names),
            }
        ],
        "annotations": annotations,
        "categories": [{"id": 1, "name": "fg"}],
    }


def merge_video_jsons(json_paths: Sequence[str], one2x_threshold: Optional[int] = None) -> dict:
    """Merge per-video JSONs (in sorted path order): renumber ids, drop the
    noisy (one2x above `one2x_threshold`) tracks."""
    videos, annotations = [], []
    next_vid, next_ann = 1, 1
    for path in sorted(json_paths):
        with open(path) as f:
            data = json.load(f)
        for video in data["videos"]:
            old_id = video["id"]
            videos.append(dict(video, id=next_vid))
            for ann in data["annotations"]:
                if ann["video_id"] != old_id:
                    continue
                if one2x_threshold is not None and ann.get("one2x", 0) > one2x_threshold:
                    continue
                annotations.append(dict(ann, id=next_ann, video_id=next_vid))
                next_ann += 1
            next_vid += 1
    return {"videos": videos, "annotations": annotations, "categories": [{"id": 1, "name": "fg"}]}


def convert_results_to_annotations(
    results: List[dict],  # results.json entries
    gt_videos: List[dict],  # video metadata from the eval dataset json
    score_threshold: float = 0.75,
) -> dict:
    """Model predictions -> round-2 training annotations."""
    videos_by_id = {v["id"]: v for v in gt_videos}
    annotations = []
    for res in results:
        if res["score"] < score_threshold:
            continue
        segs = res["segmentations"]
        annotations.append(
            {
                "id": len(annotations) + 1,
                "video_id": res["video_id"],
                "category_id": 1,
                "segmentations": segs,
                "bboxes": [None if s is None else rle_codec.to_bbox(s) for s in segs],
                "areas": [None if s is None else rle_codec.area(s) for s in segs],
                "iscrowd": 0,
                "score": res["score"],
            }
        )
    return {
        "videos": [videos_by_id[vid] for vid in sorted(videos_by_id)],
        "annotations": annotations,
        "categories": [{"id": 1, "name": "fg"}],
    }
