"""COCO-instance pseudo-clips: the port of the first half of
`s2d_tpu/data/image_datasets.py` (lines 47-80).

`coco_to_clip_record` turns a COCO image record (`data/coco.py`) into a
YTVIS-style clip record whose frames are the same image `clip_len` times,
each annotation's segmentation and box replicated per frame (the
reference's `CocoClipDatasetMapper`), so that an image set trains the video
model through the ordinary `ClipMapper`, as `tools/train_net_video.py`
does. The box is turned from the record's xyxy into [x0, y0, x1 - x0,
y1 - y0], as JAX does it. `CocoClipMapper` is a `ClipMapper` over COCO
image records.

The semantic-segmentation half of the JAX file is not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .mapper import ClipMapper


def coco_to_clip_record(record: dict, clip_len: int) -> dict:
    """COCO image record -> clip record of `clip_len` copies of the image."""
    objs = []
    for i, ann in enumerate(record.get("annotations", [])):
        x0, y0, x1, y1 = ann["bbox"]
        objs.append({
            "id": i + 1,
            "category_id": ann["category_id"],
            "segmentations": [ann.get("segmentation")] * clip_len,
            "bboxes": [[x0, y0, x1 - x0, y1 - y0]] * clip_len,
            "areas": [None] * clip_len,
        })
    return {
        "video_id": record.get("image_id", 0),
        "file_names": [record["file_name"]] * clip_len,
        "height": record["height"],
        "width": record["width"],
        "length": clip_len,
        "annotations": objs,
    }


class CocoClipMapper(ClipMapper):
    """`ClipMapper` over COCO image records (a still image -> a pseudo-clip)."""

    def __call__(self, record: dict) -> Optional[dict]:
        return super().__call__(coco_to_clip_record(record, self.cfg.sampling_frame_num))
