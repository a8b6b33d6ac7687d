"""The keymask discovery CLI of the port, as `tools/keymask_ident.py`:

    python -m s2d_tpu_torch.keymask_ident --frames-root DIR --masks-root DIR \
        --output-root DIR [--job-id J --videos-per-job K] [--merge] \
        [--tracker correlation|cotracker] [--tracker-checkpoint PTH] \
        [--device cuda] [thresholds ...]

Input: `<frames-root>/<video>/*.jpg|*.png` (frames, sorted by name) and
`<masks-root>/<video>/*.png` (per frame, in sorted order, one multi-colour
PNG of stage-1 masks: one instance per non-black colour). PNGs are read by
the port's own codec (`data/png.py`); a JPEG frame needs cv2 or PIL.

Per video: visibility curves -> visibility windows -> candidate-mask PNGs
(`<output-root>/candidates/<video>/`) -> temporal correspondence matching ->
a YTVIS JSON (`<output-root>/annotations/<video>.json`); with --merge, all
of them into `<output-root>/dataset.json`. As in the JAX tool: job-array
slicing, a video whose JSON exists is skipped, a video that fails is
reported with its traceback and counted (the run goes on), and the next
video's files are read on a thread while the current one is processed.
The tracker (and the card) runs on --device, CUDA unless `--device cpu`;
without a card that raises before any video. The tracker is built once a
run (the JAX tool builds it per video, with the same parameters).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import traceback

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="s2d_tpu_torch keymask discovery")
    parser.add_argument("--frames-root", required=True,
                        help="root of per-video frame folders (JPEG or PNG)")
    parser.add_argument("--masks-root", required=True,
                        help="root of per-video per-frame color-PNG masks")
    parser.add_argument("--output-root", required=True)
    parser.add_argument("--job-id", type=int, default=0)
    parser.add_argument("--videos-per-job", type=int, default=-1)
    parser.add_argument("--visibility-threshold", type=float, default=0.3)
    parser.add_argument("--dbscan-min-samples", type=int, default=5,
                        help="visibility-window DBSCAN min_samples (reference hardcodes 5)")
    parser.add_argument("--matching-threshold", type=float, default=0.5)
    parser.add_argument("--matching-min-samples", type=int, default=None,
                        help="override the temporal-clustering DBSCAN min_samples (default: "
                             "the reference's width-adaptive 3-5 table; tiny synthetic runs "
                             "may need 1)")
    parser.add_argument("--grid-size", type=int, default=50)
    parser.add_argument("--tracker", choices=("correlation", "cotracker"), default="correlation",
                        help="point tracker backend (PointTracker protocol)")
    parser.add_argument("--tracker-checkpoint", default="",
                        help="CoTracker .pth to import (--tracker cotracker)")
    parser.add_argument("--merge", action="store_true",
                        help="after the loop, merge per-video JSONs")
    parser.add_argument("--one2x-threshold", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    return parser.parse_args(argv)


def read_frame(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB: a PNG through the port's codec, else through
    cv2 or PIL."""
    from .data.mapper import load_image_robust
    from .data.png import read_png

    return read_png(path) if path.lower().endswith(".png") else load_image_robust(path)


def load_video_inputs(args, video_dir: str) -> dict:
    """Host IO of one video: its frames and its mask PNGs, every mask under
    an overall id (0, 1, ... over the video's frames in order)."""
    from .data.png import read_png
    from .keymask import load_masks_from_color_png

    name = os.path.basename(video_dir)
    frame_files = sorted(glob.glob(os.path.join(video_dir, "*.jpg"))
                         + glob.glob(os.path.join(video_dir, "*.png")))
    video = np.stack([read_frame(f) for f in frame_files])
    mask_files = sorted(glob.glob(os.path.join(args.masks_root, name, "*.png")))
    masks_per_frame = []
    overall_ids, frame_of_id, mask_of_id = [], [], {}
    for fi in range(len(video)):
        frame_masks = {}
        if fi < len(mask_files):
            for mask in load_masks_from_color_png(read_png(mask_files[fi])).values():
                oid = len(overall_ids)
                frame_masks[oid] = mask
                overall_ids.append(oid)
                frame_of_id.append(fi)
                mask_of_id[oid] = mask
        masks_per_frame.append(frame_masks)
    return {
        "name": name,
        "frame_files": frame_files,
        "video": video,
        "masks_per_frame": masks_per_frame,
        "overall_ids": overall_ids,
        "frame_of_id": frame_of_id,
        "mask_of_id": mask_of_id,
    }


def build_tracker(args, device):
    from .keymask import CorrelationTracker
    from .keymask.cotracker import build_cotracker

    if args.tracker == "cotracker":
        return build_cotracker(args.tracker_checkpoint or None, device=device)
    return CorrelationTracker(device=device)


def process_video(args, video_dir: str, out_json: str, inputs=None, tracker=None) -> dict:
    """One video through the four stages into `out_json`. `inputs` is
    `load_video_inputs`' result where the caller read it already, `tracker`
    the run's tracker (else one is built). Returns the seconds of each
    stage."""
    from .keymask import (
        extract_visibility_curves,
        group_quality,
        match_candidates,
        match_matrix,
        temporal_correspondence_clustering,
        visibility_windows,
        write_annotation_for_video,
    )
    from .keymask.export import save_candidate_masks, winner_mask

    if inputs is None:
        inputs = load_video_inputs(args, video_dir)
    if tracker is None:
        tracker = build_tracker(args, torch.device(args.device))
    name = inputs["name"]
    video = inputs["video"]
    masks_per_frame = inputs["masks_per_frame"]
    overall_ids = inputs["overall_ids"]
    frame_of_id = inputs["frame_of_id"]
    seconds = {}
    start = time.perf_counter()

    def lap(stage):
        nonlocal start
        now = time.perf_counter()
        seconds[stage] = now - start
        start = now

    # 1. visibility curves per seeded mask
    records = extract_visibility_curves(video, masks_per_frame, tracker, grid_size=args.grid_size)
    curves = np.asarray([r["visibility"] for r in records])
    lap("visibility")

    # 2. visibility windows, and their winner candidate masks as PNGs
    windows = visibility_windows(curves, threshold=args.visibility_threshold,
                                 min_samples=args.dbscan_min_samples) if len(curves) else []
    save_candidate_masks(os.path.join(args.output_root, "candidates", name),
                         windows, records, masks_per_frame)
    lap("windows")

    # 3. temporal correspondence matching of the winner candidates
    candidates = []  # (seed_frame, mask)
    for wrec in windows:
        for row in wrec["winners"]:
            rec = records[row]
            seed_mask = winner_mask(masks_per_frame, rec["frame"], rec["mask_id"])
            if seed_mask is not None:
                candidates.append((rec["frame"], seed_mask))
    all_matches = match_candidates(video, tracker, candidates, masks_per_frame,
                                   matching_threshold=args.matching_threshold)
    mat = match_matrix(all_matches, overall_ids)
    labels = temporal_correspondence_clustering(mat, min_samples=args.matching_min_samples)
    groups = group_quality(mat, labels, frame_of_id)
    lap("matching")

    # 4. per group, per frame the union of its matched masks -> YTVIS JSON
    group_masks = []
    for group in groups:
        per_frame = [None] * len(video)
        for mid in group["matched_ids"]:
            fi = frame_of_id[mid]
            mask = inputs["mask_of_id"][overall_ids[mid]]
            per_frame[fi] = mask if per_frame[fi] is None else (per_frame[fi] | mask)
        group_masks.append(per_frame)
    h, w = video.shape[1:3]
    data = write_annotation_for_video(
        # as the JAX tool: str hashes are salted per process, so the id is
        # stable within one run only (merge_video_jsons renumbers)
        video_id=abs(hash(name)) % 10**8,
        file_names=[os.path.join(name, os.path.basename(f)) for f in inputs["frame_files"]],
        height=h, width=w, groups=groups, group_masks=group_masks,
    )
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(data, f)
    lap("annotation")
    return seconds


def main(argv=None) -> int:
    from .data.loader import Prefetcher

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("keymask_ident: --device cuda, but torch.cuda.is_available() is "
                               "false; pass --device cpu to run on the CPU")
        from .demo_video import set_full_f32

        set_full_f32()
    videos = sorted(d for d in glob.glob(os.path.join(args.frames_root, "*")) if os.path.isdir(d))
    if args.videos_per_job > 0:
        lo = args.job_id * args.videos_per_job
        videos = videos[lo:lo + args.videos_per_job]

    pending, skipped = [], 0
    for video_dir in videos:
        out_json = os.path.join(args.output_root, "annotations",
                                f"{os.path.basename(video_dir)}.json")
        if os.path.exists(out_json):
            skipped += 1
        else:
            pending.append((video_dir, out_json))

    tracker = build_tracker(args, device) if pending else None

    def loaded():  # a video's read error travels as a value: the stream goes on
        for video_dir, out_json in pending:
            try:
                yield video_dir, out_json, load_video_inputs(args, video_dir), None
            except Exception as err:
                yield video_dir, out_json, None, err

    ok, failed = 0, 0
    stream = Prefetcher(loaded(), depth=1)
    try:
        for video_dir, out_json, inputs, load_err in stream:
            name = os.path.basename(video_dir)
            try:
                if load_err is not None:
                    raise load_err
                seconds = process_video(args, video_dir, out_json, inputs=inputs, tracker=tracker)
                ok += 1
                print(f"{name}: " + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()))
            except Exception:
                failed += 1
                print(f"FAILED {name}:\n{traceback.format_exc()}", file=sys.stderr)
    finally:
        stream.close()
    print(f"keymask_ident: {ok} ok, {failed} failed, {skipped} skipped")
    if tracker is not None and tracker.point_frames:
        print(f"tracker: {tracker.point_frames} point-frames in {tracker.seconds:.3f} s, "
              f"{tracker.point_frames / tracker.seconds:.0f} point-frames/s")

    if args.merge:
        from .keymask import merge_video_jsons

        paths = glob.glob(os.path.join(args.output_root, "annotations", "*.json"))
        merged = merge_video_jsons(paths, one2x_threshold=args.one2x_threshold)
        out = os.path.join(args.output_root, "dataset.json")
        with open(out, "w") as f:
            json.dump(merged, f)
        print(f"merged {len(paths)} videos -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
