"""Keymask discovery, the port of `s2d_tpu/keymask`: point tracking
(`tracker`, `cotracker`) -> per-mask visibility curves (`visibility`) ->
visibility windows by DBSCAN (`windows`, `dbscan`) -> temporal
correspondence matching (`matching`) -> YTVIS annotations (`annotations`)
and candidate-mask PNGs (`export`). `s2d_tpu_torch.keymask_ident` is the
CLI."""
from .tracker import CorrelationTracker, PointTracker, grid_points_in_mask
from .visibility import (
    extract_visibility_curves,
    load_masks_from_color_png,
    save_visibility_json,
)
from .windows import binarize_curves, cluster_curves, visibility_windows
from .matching import (
    adaptive_grid_size,
    group_quality,
    match_candidate,
    match_candidates,
    match_matrix,
    point_mask_iou,
    temporal_correspondence_clustering,
)
from .annotations import (
    convert_results_to_annotations,
    merge_video_jsons,
    write_annotation_for_video,
)

__all__ = [
    "CorrelationTracker",
    "PointTracker",
    "grid_points_in_mask",
    "extract_visibility_curves",
    "load_masks_from_color_png",
    "save_visibility_json",
    "binarize_curves",
    "cluster_curves",
    "visibility_windows",
    "adaptive_grid_size",
    "group_quality",
    "match_candidate",
    "match_candidates",
    "match_matrix",
    "point_mask_iou",
    "temporal_correspondence_clustering",
    "convert_results_to_annotations",
    "merge_video_jsons",
    "write_annotation_for_video",
]
