"""End-to-end YTVIS evaluator: model -> results.json -> AP table.

Counterpart of `s2d_tpu/evaluation/evaluator.py`. Per video, the whole
clip goes through the forward and `postprocess_video`; the NMS survivors'
tracks become per-frame COCO RLEs (`predictions_to_results`), the list is
dumped to `results.json` and scored with the spatio-temporal AP of
`ytvos_eval.py` (class-agnostic, as S2D evaluates).

The pipeline is JAX's, in four threads:
  * a prefetch thread maps video i+1 (frame read + resize), pads it to a
    T-bucket and starts its host->device upload on a side stream;
  * the main thread runs the forward and `postprocess_video` (on a CUDA
    device both are queued asynchronously) and starts the copy of the
    small bundle of scores, labels, keep and boxes;
  * finalize thread A reads the small bundle (the first host read, so the
    wait for the device rides there) and starts the survivors' readback:
    each track as a bbox window gathered on the device (a stream of its
    own), or whole where a window would not cut 30% of the canvas
    (`inference.start_kept_masks_read`);
  * finalize thread B waits for that readback and RLE-encodes each track
    straight from its window (`rle.encode_window`: O(crop), not O(canvas),
    and the same RLE as pasting and encoding the whole mask).
The queues have depth 2. `stage_s/*` holds each stage's wall seconds,
keyed by the thread that pays them (the stages overlap, so their sum
exceeds the wall).

T-bucket padding as JAX: a clip is zero-padded to a multiple of 8 frames,
the decoder blocks the pad frames' keys (`frame_valid`) and postprocess
cuts them off (`num_frames`). One model with the K3 flash cross-attention
serves every bucket (JAX's short-bucket model was a TPU timing choice).
Left out: the JAX package's `time_mesh` (frame-parallel eval over a mesh,
with DDP) and the bit-pack of the masks along H before their readback
(TPU-only: it packs bits where the TPU's lanes are cheap).

Multi-host: each process evaluates its shard of videos into
`results_shard{i}.json`; `merge_shard_results` + `score_results` score the
merged list.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data import rle as rle_codec
from ..data.loader import FinalizeThread, Prefetcher
from ..data.mapper import EvalMapper
from ..data.ytvis import get_dataset
from .inference import (WindowMasks, finish_kept_masks_read, read_small_bundle,
                        start_kept_masks_read, start_small_read)
from .ytvos_eval import evaluate_vis

T_BUCKET = 8  # clips are zero-padded to a multiple of this many frames
QUEUE_DEPTH = 2


def predictions_to_results(
    video_id: int, preds: Dict[str, np.ndarray], category_offset: int = 1
) -> List[dict]:
    """Binarized track masks -> results.json entries (per-frame RLE).

    `preds["masks"]` is the (n, T, H, W) bool masks or the `WindowMasks`
    of a crop read, which is encoded straight from each window: the same
    RLEs, at O(crop) instead of O(canvas) a frame."""
    masks = preds["masks"]
    results = []
    for i, (score, label) in enumerate(zip(preds["scores"], preds["labels"])):
        if isinstance(masks, WindowMasks):
            y0, x0 = int(masks.y0[i]), int(masks.x0[i])
            h_i = min(masks.crops.shape[2], masks.height - y0)
            segs = [rle_codec.encode_window(frame[:h_i], y0, x0, masks.height, masks.width)
                    for frame in masks.crops[i]]
        else:
            segs = [rle_codec.encode(frame) for frame in masks[i]]
        results.append({
            "video_id": int(video_id),
            "score": float(score),
            "category_id": int(label) + category_offset,
            "segmentations": segs,
        })
    return results


def collect_gt(dicts: List[dict]) -> List[dict]:
    """Ground-truth track entries for ytvos_eval (category ids 1-based)."""
    return [
        {
            "video_id": record["video_id"],
            "category_id": o["category_id"] + 1,
            "segmentations": o["segmentations"],
        }
        for record in dicts
        for o in record["annotations"]
    ]


def merge_shard_results(output_dir: str, num_shards: int) -> List[dict]:
    """Concatenate the per-process shard result files."""
    results: List[dict] = []
    for i in range(num_shards):
        with open(os.path.join(output_dir, f"results_shard{i}.json")) as f:
            results.extend(json.load(f))
    return results


def score_results(
    dataset_name: str, results: List[dict], max_videos: Optional[int] = None
) -> Dict[str, float]:
    """Score an assembled results list (e.g. merged shards) against the
    registered dataset's ground truth."""
    dicts, _ = get_dataset(dataset_name)
    if max_videos:
        dicts = dicts[:max_videos]
    return evaluate_vis(collect_gt(dicts), results, use_cats=False)


def merge_and_score(group, dataset_name: str, output_dir: str,
                    max_videos: Optional[int] = None) -> Optional[Dict[str, float]]:
    """After every rank of `group` wrote its `results_shard<r>.json` into
    `output_dir`: rank 0 merges them into `results.json` and scores them,
    as `tools/train_net_video.py:158-182` (one barrier before, so that every
    shard is on disk; one after, so that no rank writes the next dataset's
    shards before rank 0 has read these). Returns the metrics on rank 0,
    None on the others."""
    group.barrier(f"eval:{dataset_name}")
    metrics = None
    if group.is_main:
        results = merge_shard_results(output_dir, group.size)
        with open(os.path.join(output_dir, "results.json"), "w") as f:
            json.dump(results, f)
        metrics = score_results(dataset_name, results, max_videos=max_videos)
    group.barrier(f"eval-merged:{dataset_name}")
    return metrics


def _upload(frames: np.ndarray, frame_valid: np.ndarray, device: torch.device, stream):
    """Start the copy of a clip to the device. On a CUDA device the copy
    runs from pinned memory on `stream` and an event marks its end, which
    the consumer waits for; elsewhere it is a plain tensor."""
    if stream is None:
        return torch.from_numpy(frames).to(device), torch.from_numpy(frame_valid).to(device), None
    with torch.cuda.stream(stream):
        frames_dev = torch.from_numpy(frames).pin_memory().to(device, non_blocking=True)
        valid_dev = torch.from_numpy(frame_valid).pin_memory().to(device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    return frames_dev, valid_dev, ready


def evaluate_dataset(
    predictor,
    dataset_name: str,
    output_dir: Optional[str] = None,
    max_videos: Optional[int] = None,
    num_shards: int = 1,
    shard_index: int = 0,
    mapper: Optional[Callable[[dict], dict]] = None,
    crop_masks: bool = True,
) -> Dict[str, float]:
    """--eval-only path: run `predictor` (a `demo_video.VideoPredictor`)
    over a registered dataset, write results.json and score it.

    mapper: record -> a dict with "image", the (T, H, W, 3) uint8 frames at
    the test size; by default `EvalMapper` reads and resizes the record's
    frame files. crop_masks=False reads every survivor's whole masks back
    (the results are the same). Returns the AP metrics, `eval_seconds`,
    `frames_per_second` and `stage_s/*`. With num_shards > 1 the metrics
    cover this shard only (merge with `merge_shard_results`)."""
    dicts, _ = get_dataset(dataset_name)
    if max_videos:
        dicts = dicts[:max_videos]
    if num_shards > 1:
        dicts = dicts[shard_index::num_shards]
    cfg = predictor.cfg
    mapper = mapper or EvalMapper(cfg.min_size_test, cfg.max_size_test)
    device = predictor.device
    upload_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    readback_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    results: List[dict] = []
    gt_annotations: List[dict] = []
    stage: Dict[str, float] = {
        "decode_map": 0.0,           # prefetch: frame read + resize + upload start
        "preprocess_dispatch": 0.0,  # main: forward + postprocess calls
        "dispatch_fwd": 0.0,         # main: the forward call (within the above)
        "dispatch_post": 0.0,        # main: the postprocess call (within the above)
        "put_wait": 0.0,             # main: backpressure from the finalize thread
        "readback_small": 0.0,       # finalize A: the small bundle, the first host
        #                              read, so the wait for the device rides here
        "readback_masks": 0.0,       # finalize B: the survivors' crops or masks
        "unpack": 0.0,               # finalize B: none here (no bit-pack transport)
        "rle_encode": 0.0,           # finalize B: counts + COCO string encode
        "score": 0.0,                # main, after the loop: evaluate_vis
    }

    def timed_map():
        for record in dicts:
            t0 = time.perf_counter()
            frames = np.asarray(mapper(record)["image"])
            t, h, w = frames.shape[:3]
            pad_t = -t % T_BUCKET
            if pad_t:
                frames = np.pad(frames, ((0, pad_t), (0, 0), (0, 0), (0, 0)))
            frame_valid = np.arange(t + pad_t) < t
            uploaded = _upload(frames, frame_valid, device, upload_stream)
            stage["decode_map"] += time.perf_counter() - t0
            yield record, uploaded, t, (h, w)

    def finalize_masks(video_id, scores, labels, keep, handle):
        masks = finish_kept_masks_read(handle, timers=stage, as_window=True)
        t0 = time.perf_counter()
        results.extend(predictions_to_results(
            video_id, {"scores": scores[keep], "labels": labels[keep], "masks": masks}))
        stage["rle_encode"] += time.perf_counter() - t0

    fin_masks = FinalizeThread(finalize_masks, depth=QUEUE_DEPTH)

    def finalize(video_id, post):
        t0 = time.perf_counter()
        scores, labels, keep, boxes = read_small_bundle(post)
        stage["readback_small"] += time.perf_counter() - t0
        handle = start_kept_masks_read(post, keep, boxes if crop_masks else None,
                                       stream=readback_stream)
        fin_masks.put(video_id, scores, labels, keep, handle)

    fin = FinalizeThread(finalize, depth=QUEUE_DEPTH)
    mapped = Prefetcher(timed_map(), QUEUE_DEPTH)
    start = time.perf_counter()
    try:
        for record, (frames, frame_valid, ready), t, image_hw in mapped:
            t_disp = time.perf_counter()
            if ready is not None:
                main = torch.cuda.current_stream(device)
                main.wait_event(ready)
                frames.record_stream(main)
                frame_valid.record_stream(main)
            out, image_size = predictor.forward(frames, frame_valid)
            t_fwd = time.perf_counter()
            post = predictor.postprocess(
                out, image_size, (record["height"], record["width"]), num_frames=t)
            start_small_read(post)
            t_put = time.perf_counter()
            stage["dispatch_fwd"] += t_fwd - t_disp
            stage["dispatch_post"] += t_put - t_fwd
            stage["preprocess_dispatch"] += t_put - t_disp
            fin.put(record["video_id"], post)
            stage["put_wait"] += time.perf_counter() - t_put
            gt_annotations.extend(collect_gt([record]))
    finally:
        mapped.close()
        t_close = time.perf_counter()
        try:
            fin.close()
        finally:
            # flush thread B even when A's flush raises
            fin_masks.close()
        stage["put_wait"] += time.perf_counter() - t_close
    elapsed = time.perf_counter() - start

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        name = "results.json" if num_shards == 1 else f"results_shard{shard_index}.json"
        with open(os.path.join(output_dir, name), "w") as f:
            json.dump(results, f)

    t_score = time.perf_counter()
    metrics = evaluate_vis(gt_annotations, results, use_cats=False)
    stage["score"] = time.perf_counter() - t_score

    metrics["eval_seconds"] = elapsed
    total_frames = sum(d["length"] for d in dicts)
    metrics["frames_per_second"] = total_frames / elapsed if elapsed else 0.0
    for k, v in stage.items():
        metrics[f"stage_s/{k}"] = round(v, 3)
    return metrics
