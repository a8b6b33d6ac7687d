"""COCO-format image datasets of the CutLER detector, as
`s2d_tpu/data/coco.py`: the registry of the reference's image sets
(class-agnostic COCO-style jsons over ImageNet, COCO, VOC, UVO, ...) under
$S2D_DATASETS or $DETECTRON2_DATASETS, and the loader returning image-level
records:

  {file_name, image_id, height, width,
   annotations: [{bbox (xyxy abs), category_id (contiguous),
                  segmentation (RLE dict | polygon list | None),
                  iscrowd}]}
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from .ytvis import datasets_root

COCO_REGISTRY: Dict[str, dict] = {}

# image_root, json, relative to the datasets root
_PREDEFINED_COCO = {
    "imagenet_train_cls_agnostic": (
        "imagenet/train", "imagenet/annotations/imagenet_train_fixsize480_tau0.15_N3.json"),
    "cls_agnostic_coco": ("coco/val2017", "coco/annotations/coco_cls_agnostic_instances_val2017.json"),
    "coco_train_2017": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_val_2017": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    "cls_agnostic_voc": ("voc/JPEGImages", "voc/annotations/trainvaltest_2007_cls_agnostic.json"),
    "cls_agnostic_uvo": ("uvo/all_UVO_frames", "uvo/annotations/val_sparse_cleaned_cls_agnostic.json"),
    # remaining reference zero-shot eval tables (builtin.py:41-97)
    "cls_agnostic_coco20k": ("coco/train2014", "coco/annotations/coco20k_trainval_gt.json"),
    "cls_agnostic_lvis": ("coco", "coco/annotations/lvis1.0_cocofied_val_cls_agnostic.json"),
    "cls_agnostic_objects365": ("objects365/val", "objects365/annotations/zhiyuan_objv2_val_cls_agnostic.json"),
    "cls_agnostic_openimages": ("openImages/validation", "openImages/annotations/openimages_val_cls_agnostic.json"),
    "cls_agnostic_kitti": ("kitti", "kitti/annotations/trainval_cls_agnostic.json"),
    "cls_agnostic_clipart": ("clipart", "clipart/annotations/traintest_cls_agnostic.json"),
    "cls_agnostic_watercolor": ("watercolor", "watercolor/annotations/traintest_cls_agnostic.json"),
    "cls_agnostic_comic": ("comic", "comic/annotations/traintest_cls_agnostic.json"),
    # d2-core names used by the reference model_zoo configs (class-aware)
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    # maskcut/diffncut pseudo-GT + self-training rounds (builtin.py:48-59);
    # "imagenet_train" is the reference's name for the same json our
    # "imagenet_train_cls_agnostic" points at
    "imagenet_train": (
        "imagenet/train", "imagenet/annotations/imagenet_train_fixsize480_tau0.15_N3.json"),
    "imagenet_train_diffncut_v1": (
        "imagenet/train", "imagenet/annotations/train_imagenet_in1k_diffncut_mincut_sif_mask_confidence_merged.json"),
    "imagenet_train_r1": (
        "imagenet/train", "imagenet/annotations/cutler_imagenet1k_train_r1.json"),
    "imagenet_train_diffncut_select_and_blend_r1": (
        "imagenet/train", "imagenet/annotations/cutler_imagenet1k_train_r1_diffncut_mincut_sif_mask_confidence_select_and_blend.json"),
    "imagenet_train_r2": (
        "imagenet/train", "imagenet/annotations/cutler_imagenet1k_train_r2.json"),
    "imagenet_train_r3": (
        "imagenet/train", "imagenet/annotations/cutler_imagenet1k_train_r3.json"),
    "imagenet_train_diffncut_ablation_kbr_r3_seedsweep": (
        "imagenet/train", "imagenet/annotations/cutler_imagenet1k_train_r3_diffncut_ablation_kbr_seedsweep.json"),
    "imagenet_train_diffncut_select_and_blend_r3": (
        "imagenet/train", "imagenet/annotations/cutler_imagenet1k_train_r3_diffncut_mincut_sif_mask_confidence.json"),
}

# COCO semi-supervised finetuning splits (builtin.py:27-38): N% of
# train2017 with full labels, used by model_zoo/COCO-Semisupervised
for _p in (1, 2, 5, 10, 20, 30, 40, 50, 60, 80):
    _PREDEFINED_COCO[f"coco_semi_{_p}perc"] = (
        "coco/train2017", f"coco/annotations/{_p}perc_instances_train2017.json")


def register_coco(
    name: str,
    json_file: str,
    image_root: str,
    class_agnostic: bool = False,
) -> None:
    COCO_REGISTRY[name] = {
        "json_file": json_file,
        "image_root": image_root,
        "class_agnostic": class_agnostic,
    }


def register_builtin_coco(root: Optional[str] = None) -> None:
    root = root or datasets_root()
    for name, (image_root, json_file) in _PREDEFINED_COCO.items():
        register_coco(
            name,
            os.path.join(root, json_file),
            os.path.join(root, image_root),
            class_agnostic="cls_agnostic" in name or "imagenet" in name,
        )


def load_coco_json(
    json_file: str,
    image_root: str,
    class_agnostic: bool = False,
) -> Tuple[List[dict], dict]:
    """COCO json -> image-level dataset dicts (+ metadata)."""
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

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    dataset_dicts = []
    for img in data["images"]:
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            x, y, w, h = ann["bbox"]  # COCO xywh -> xyxy
            objs.append(
                {
                    "bbox": [float(x), float(y), float(x + w), float(y + h)],
                    "category_id": cat_id_map.get(ann["category_id"], 0),
                    "segmentation": ann.get("segmentation"),
                    "iscrowd": ann.get("iscrowd", 0),
                }
            )
        dataset_dicts.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "image_id": img["id"],
                "height": img["height"],
                "width": img["width"],
                "annotations": objs,
            }
        )
    return dataset_dicts, metadata


def get_coco_dataset(name: str) -> Tuple[List[dict], dict]:
    if name not in COCO_REGISTRY:
        register_builtin_coco()
    if name not in COCO_REGISTRY:
        raise KeyError(
            f"Unknown dataset {name!r}; registered: {sorted(COCO_REGISTRY)}"
        )
    info = COCO_REGISTRY[name]
    return load_coco_json(
        info["json_file"], info["image_root"], info["class_agnostic"]
    )
