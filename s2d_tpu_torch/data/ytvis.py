"""YTVIS dataset registry + JSON loading: the port's copy of
`s2d_tpu/data/ytvis.py` (the reference's `data_video/datasets/ytvis.py`
and `builtin.py`). YTVIS-format JSON (videos / annotations with per-frame
segmentations) is converted to a list of per-video dicts:

  {video_id, file_names, height, width, length,
   annotations: per-frame list of {id, category_id, segmentation, bbox}}

The d2 DatasetCatalog/MetadataCatalog registries become plain dicts. The
class-agnostic variants map every category to the single "fg" class
(reference ytvis.py:75-80). Dataset root comes from $DETECTRON2_DATASETS or
$S2D_DATASETS (reference builtin.py:151-160).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

DATASET_REGISTRY: Dict[str, dict] = {}

# name -> (image_root, json_file), mirroring builtin.py:17-76
_PREDEFINED_YTVIS = {
    "ytvis_2019_train": ("ytvis_2019/train/JPEGImages", "ytvis_2019/train.json"),
    "ytvis_2019_val": ("ytvis_2019/valid/JPEGImages", "ytvis_2019/valid.json"),
    "ytvis_2021_train": ("ytvis_2021/train/JPEGImages", "ytvis_2021/train/instances.json"),
    "ytvis_2021_val": ("ytvis_2021/valid/JPEGImages", "ytvis_2021/valid/instances.json"),
    "ytvis_2021_valid": ("ytvis_2021/valid/JPEGImages", "ytvis_2021/valid/instances.json"),
    "ytvis_2022_val": ("ytvis_2022/valid/JPEGImages", "ytvis_2022/instances.json"),
    # keymask pseudo-annotation sets (reference builtin.py:58 + the
    # dense6[/nms] names its round-2 configs train on; the jsons are
    # produced by tools/keymask_ident.py + convert_results_to_annotations)
    "ytvis_2021_train_dense": (
        "ytvis_2021/train/JPEGImages", "ytvis_2021/train/converted_annotations.json"),
    "ytvis_2021_train_dense6": (
        "ytvis_2021/train/JPEGImages", "ytvis_2021/train/dense6_annotations.json"),
    "ytvis_2021_train_dense6_nms": (
        "ytvis_2021/train/JPEGImages", "ytvis_2021/train/dense6_nms_annotations.json"),
    "ovis_val": ("ovis/valid", "ovis/annotations_valid.json"),
    "mose_train": ("mose/train/JPEGImages", "mose/train/annotations.json"),
    "sav_train": ("sa_v/train/JPEGImages", "sa_v/train/annotations.json"),
    "vipseg_train": ("vipseg/imgs", "vipseg/annotations.json"),
}


def datasets_root() -> str:
    return os.environ.get(
        "S2D_DATASETS", os.environ.get("DETECTRON2_DATASETS", "datasets")
    )


def register_ytvis(
    name: str,
    json_file: str,
    image_root: str,
    class_agnostic: bool = False,
    evaluator_type: str = "ytvis",
) -> None:
    DATASET_REGISTRY[name] = {
        "json_file": json_file,
        "image_root": image_root,
        "class_agnostic": class_agnostic,
        "evaluator_type": evaluator_type,
    }


def register_builtin(root: Optional[str] = None) -> None:
    root = root or datasets_root()
    for name, (image_root, json_file) in _PREDEFINED_YTVIS.items():
        register_ytvis(
            name,
            os.path.join(root, json_file),
            os.path.join(root, image_root),
            class_agnostic=False,
        )
        register_ytvis(
            name + "_cls_agnostic",
            os.path.join(root, json_file),
            os.path.join(root, image_root),
            class_agnostic=True,
        )


def load_ytvis_json(
    json_file: str,
    image_root: str,
    class_agnostic: bool = False,
) -> Tuple[List[dict], dict]:
    """Returns (dataset_dicts, metadata). Mirrors reference load_ytvis_json:
    per video, per-frame annotation lists with stable instance ids."""
    with open(json_file) as f:
        data = json.load(f)

    categories = data.get("categories", [{"id": 1, "name": "fg"}])
    if class_agnostic:
        thing_classes = ["fg"]
        cat_id_map = {c["id"]: 0 for c in categories}
    else:
        categories = sorted(categories, key=lambda c: c["id"])
        thing_classes = [c["name"] for c in categories]
        cat_id_map = {c["id"]: i for i, c in enumerate(categories)}
    metadata = {"thing_classes": thing_classes, "cat_id_map": cat_id_map}

    anns_by_video: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []):
        anns_by_video.setdefault(ann["video_id"], []).append(ann)

    dataset_dicts = []
    for video in data["videos"]:
        vid = video["id"]
        length = len(video["file_names"])
        record = {
            "video_id": vid,
            "file_names": [
                os.path.join(image_root, f) for f in video["file_names"]
            ],
            "height": video["height"],
            "width": video["width"],
            "length": length,
        }
        objs = []
        for ann in anns_by_video.get(vid, []):
            segs = ann.get("segmentations") or [None] * length
            bboxes = ann.get("bboxes") or [None] * length
            objs.append(
                {
                    "id": ann["id"],
                    "category_id": cat_id_map.get(ann["category_id"], 0),
                    "segmentations": segs,
                    "bboxes": bboxes,
                    "areas": ann.get("areas") or [None] * length,
                }
            )
        record["annotations"] = objs
        dataset_dicts.append(record)
    return dataset_dicts, metadata


def get_dataset(name: str) -> Tuple[List[dict], dict]:
    if name not in DATASET_REGISTRY:
        register_builtin()
    if name not in DATASET_REGISTRY:
        raise KeyError(f"Unknown dataset {name!r}; registered: {sorted(DATASET_REGISTRY)}")
    info = DATASET_REGISTRY[name]
    dicts, metadata = load_ytvis_json(
        info["json_file"], info["image_root"], info["class_agnostic"]
    )
    metadata["evaluator_type"] = info["evaluator_type"]
    return dicts, metadata
