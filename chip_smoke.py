#!/usr/bin/env python3
"""Smoke run of the PyTorch port (s2d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --compare PARENT [--profile]

1. prints the card (nvidia-smi name, power limit) and turns TF32 off for
   cuDNN convolutions and matmuls (full f32, as the JAX reference);
2. builds the CUDA kernels from s2d_tpu_torch/csrc with nvcc (sm_90a);
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times both, beside the least time the card could
   take (bound; K3's products at the rate of 3xTF32 on the tensor cores, the
   others' at the f32 rate of the CUDA cores) and, where one PyTorch call
   computes the same function, that call's time: K1 MSDA forward at the inference encoder's shapes (B = 8
   frames) and the train step's (B = 6), K3 flash attention at each key
   length of the decoder (1920, 7680, 30720; its time a clip is 3 launches
   at each) (K1 and K3 at atol 1e-4 in f32: summation order, the 3xTF32
   products and exp differ), K4 NMS (exactly, at N = 1, 50, 64, 65, 127
   (the one-block kernel's last), 128, 1024, 1025 and 4096 (the scratch
   path: a grid writes the rows, one warp walks them; past 4096, phase 16)
   with label ties, and
   the one-block kernel forced at 1024, its most; timed at the main path's N
   = 50 beside the device time of an empty kernel launch, its floor), K2 MSDA backward at the
   train step's shapes (d value at atol 1e-4: K2 sums it in fixed point,
   the plain version in f32; d locations and d weights at atol 1e-4 + 2e-5
   max|d|: f32 rounding of the sampling coordinates; no sampling coordinate
   within 1e-3 pixels of a bilinear kink, where the location gradient is
   two-valued), called 3 times and required bitwise identical, with a hash
   of its gradients printed (two processes of one checkout print the same);
4. drives the inference path: a full-width VideoPredictor (R50, 256 hidden,
   100 queries, 6 encoder layers, 9 decoder rounds, seeded random weights)
   answers 4 requests, each a T=8 uint8 clip at 360x640 with 720x1280
   output, and checks that each clip launched K1 6 times, K3 9 times and K4
   once and that its outputs are finite;
5. runs the first clip again on the plain PyTorch path on the card, with the
   configured bf16 cast points and in f32, and holds it to the kernel run:
   the keep-set to equality, the logits and masks to rtol 1e-3 / atol 2e-3
   where nothing quantizes the difference between two correct f32 paths
   (the decoder's attention masks are a hard threshold on mask logits, and
   the bf16 cast of mask_features rounds: a 1e-6 difference flips either, so
   the bound is held with the kernel path's attention-mask decisions
   replayed in the plain path; the unforced errors are printed beside);
6. drives the train path: the KD config
   (configs/ytvis2021_kd_video_mask2former_R50_cls_agnostic.yaml) at full
   width, seeded random weights, 3 steps of B=2 clips of T=3 frames at
   368x640 (padded to 384x640) with 25 supervised target slots each (the
   class head scaled so that about 60% of the teacher's queries become
   distillation targets, and the encoder's sampling-offset weights drawn
   small instead of 0 so that no sampling point sits on a bilinear kink,
   see `new_train_state`), and
   checks per step the K1/K2/K5 launches derived from the config, finite
   losses, grad_finite = 1, a moved student, unchanged FrozenBN affines and
   the teacher equal to the EMA of the student; prints step times, peak
   device memory and the time of each stage;
7. holds K5 (the batched auction) against its plain version on the card:
   identical assignments on the train step's own 40 problems, on a fixed
   seeded stand-in for them (`fixed_auction_problems`: the step's problems
   follow its K1 rounding, the stand-in is the same in every checkout), on
   random problems with invalid columns (25 supervised slots padded to 100,
   and alone: fewer slots than queries, so the reverse rounds run) and on
   quantized near-ties; times both, and the host scipy solver beside, and
   on the step's problems and the stand-in the device time a round of the
   slowest problem (each problem has its own block);
8. runs one train step on the plain path (plain MSDA with autograd, plain
   auction) from the same seeded state and the same random draws, and holds
   its losses to the kernel step's at rtol 1e-3 / atol 2e-3 with the kernel
   step's hard decisions replayed (the decoders' attention masks, the
   distillation targets' thresholds, the assignments), with the configured
   bf16 cast points and in f32; the unforced differences are printed beside.
   In f32 with the decisions replayed it also holds the clipped gradients
   of every encoder leaf (what K1 and K2 feed, recomputed under
   checkpointing) to the plain step's at a relative 2-norm of 2e-3, and the
   kernel step's update of every parameter to its float64 recomputation
   from the step's gradients (clip, Adam, decay, multiplier, -lr).
9. holds K6 (the MSDA separable-sampling ablation, four variants) against
   its plain version, bit for bit (both round each product and sum on its
   own, in one order), at the ablation tool's default shapes and with 2
   points fewer (rows not 16-byte aligned), and times both, and `empty`
   against `torch.zeros` of its output in turns (INTERLEAVED_RUNS each);
   then drives K6's own path, the ablation tool
   (`s2d_tpu_torch.tools.bench_pallas_ablate`) at its defaults, and checks
   its launches per variant;
10. drives the --eval-only path: `evaluate_dataset` with the inference
   config (configs/s2d_inference_kd_video_mask2former_R50_cls_agnostic.yaml)
   at full width, seeded random weights, over a synthetic YTVIS set written
   under build/: 3 videos of T = 8, 5 and 12 frames (T-buckets 8, 8, 16)
   recorded at 720x1280 with ellipse ground truth, their 360x640 uint8
   frames drawn from the seed and passed through `mapper=` (no image
   files); the mask features are centred and the decoder's residual
   branches scaled so that NMS keeps about 25 tracks a video (see
   `spread_queries`). It checks the survivors, results.json (each entry's T segmentations decode at
   720x1280), the AP keys and 6/9/1 K1/K3/K4 launches per video, prints
   the frames/s, the stage seconds (with rle_encode's share of the wall)
   and how many survivors came back as bbox crops and how many whole (and
   the bytes read as a share of the survivors' canvases); runs the same
   videos again with the whole-mask read forced and requires results.json
   byte-identical; then runs them on the plain path and requires identical
   keep-sets and labels, printing the share of mask pixels that differ.
   The seeded masks may fill the frame and never take the crop path, so
   `crop_check` also feeds `postprocess_video` a synthetic 720x1280, T = 16
   video of 50 drifting ellipses of mask logits: the crop path must be
   taken, each box must equal its track's extent and lie inside its
   ellipse's, and the entries encoded from the crops must equal those of
   the whole masks, byte for byte;
11. writes a full-width reference-layout student/teacher .pth (the torch
   oracle of tests/torch_oracle.py, two seeds) under build/ and loads it
   through `VideoPredictor` on the card with EVAL_STUDENT on and off: each
   time the model must hold that network's converted weights bit for bit,
   and its logits and masks on a clip (f32) must lie far nearer the
   oracle's own forward of that network than of the other (errors
   printed);
12. drives the train CLI (`s2d_tpu_torch.train_net_video.main`, see
   `train_cli_path`): the KD config at full width with SOLVER.MAX_ITER 4,
   CHECKPOINT_PERIOD 2, TEST.EVAL_PERIOD 4, over a synthetic sparsely
   annotated train set of 6 videos of 10 frames at 720x1280 and a 2-video
   test set, the frames handed in through `mapper=` and `eval_mapper=` (the
   loader, the augmentation, copy-paste where configured, B=4 clips of 3
   frames); it starts from phase 6's seeded state saved as step 0 and
   enters through --resume, then resumes to MAX_ITER 6; checks metrics.json,
   the K1/K2/K5 launches of each step, the evals' K1/K3/K4 launches and
   results.json, the checkpoints and each resumed state bit for bit, and
   prints the step time, the data-time share and the peak device memory;
13. drives keymask discovery (`s2d_tpu_torch.keymask_ident.main`, see
   `keymask_path`) at full width: 2 synthetic videos of 24 frames at
   720x1280 (YTVIS 2021's common frame size), each 5 textured objects
   moving at integer velocities over a textured background (one leaves the
   frame), written as PNG frames and multi-colour stage-1 mask PNGs with 2
   of each object's masks dropped and a spurious blob a frame, through the
   CLI with --grid-size 50 --merge (the correlation tracker on the card);
   checks 2 videos ok and none failed, a probe of known motion tracked
   exactly, every object covered by a discovered group (mask IoU >= 0.5 on
   >= 80% of the frames it is in), dataset.json registered and one record
   through the train ClipMapper; then the full-width CoTracker (seeded
   random weights, its delta head scaled so that the visibilities do not
   saturate: `unsaturate`) over video 1's seeds, one set held to the same
   net's CPU run (tracks within 4e-3 px, visibility within 1e-5, >= 90% of
   the visibilities in (0.01, 0.99)); prints each stage's seconds a video
   and each tracker's point-frames/s, as the CLI and the tracker count
   them, the peak memory, the NCC match step's device time at the
   visibility stage's points, and the phase's seconds. The set is written
   under build/ and removed at the end of the phase;
14. drives the KD step's options through the train CLI (see
   `train_options_path`): the KD config at full width with
   MODEL.MASK_FORMER.DISTILLATION_NMS, INPUT.DISENTANGLE_DISTILLATION_LOADER,
   POINT_SAMPLING lattice and the loader's bit-packed targets, 3 steps of
   B=4 clips of 3 frames from a synthetic set at 720x1280, from phase 6's
   seeded state; checks each step's launches (the second student forward
   doubles the student's K1 and K2, K4 once a clip for the distillation
   NMS), finite losses, grad_finite 1, packed targets and the distillation
   view reaching the step, and prints the step time, the data-time share,
   the peak memory and the distillation targets before and after NMS; then
   (`compare_options_step`) one step of these options on the plain path
   from phase 8's seeded state and batch (with a flipped distillation view
   and packed targets) against the kernel step, the hard decisions
   replayed, losses at rtol 1e-3 / atol 2e-3 and the distillation NMS's
   validity identical. The parent side of --compare skips this phase.
15. drives stage 1, the CutLER detector's CLI (`s2d_tpu_torch.train_net
   .main`, see `cutler_path`), at full width on
   configs/cuts3d/original_cascade_mask_rcnn_R_50_FPN.yaml (R50-FPN, 256
   channels, a cascade at IoU 0.5/0.6/0.7, the mask head, pre-NMS top-k
   1000, 256 proposals), image size 512, IMS_PER_BATCH 16 as accumulation,
   copy-paste on, seeded weights, over a synthetic COCO set of 8 PNG images
   at 480x640 with 3-6 RLE ellipses each (under build/, removed at the
   end): --max-iter 2, --resume to 3, --eval-only, --tta over 2 images;
   checks K4 once a micro-step, twice an eval image and twice a TTA
   augmentation plus once a merge, finite losses, moved parameters, the
   resumed state bit for bit and the AP keys; then holds K4 to its plain
   loop at the box NMS's shapes (each run's first input of each size that
   it gave K4: the RPN's N = 1000, the cascade's 256, the TTA merge's 180;
   seeded boxes with score ties at N = 1025, 1800 and 4096: the kernel's
   large path) and times it at N = 180, 256, 1000 and 1800 (and its two
   paths at N = 50-1000); prints ms a micro-step, a
   train iteration, an eval image and a TTA image, the peak memory and the
   phase's seconds. The parent side of --compare skips this phase.
16. feeds the CLIs real inputs, JPEG files and polygon annotations, read by
   the port's own codec and fill (the card's machine has neither cv2 nor
   PIL), under build/chip_smoke_real (removed at the end; see
   `real_inputs_path`): (a) the committed JPEG fixtures (tests/data/jpeg)
   decoded here against the SHA-256 digests of cv2's decodes; (b) the demo
   CLI over 2 folders of 8 JPEG frames at 720x1280 (`write_jpeg`, 4:2:0,
   quality 90), full width, seeded weights: kept scores, labels and masks
   equal to VideoPredictor's on the same frames, its PNGs read back, K1/K3/K4
   6/9/1 a clip, the host's ms to decode a frame beside read_png's; (c) the
   video trainer (KD config) on a registered COCO set of 8 JPEG images at
   480x640 with 3-6 polygons each, as pseudo-clips: 2 steps of B=4 clips of
   T=3, K1/K2/K5 a step, finite losses, ms a step, peak memory; (d) stage 1
   on the same set: --max-iter 1 and --eval-only, K4 once a micro-step and
   twice an eval image, ms a micro-step and an eval image; (e) keymask
   discovery on one video of 24 JPEG frames at 720x1280, the CLI's seconds
   and point-frames/s; (f) K4 at N = 4097 and 8192 (past one walk block of
   4096) against its plain loop on seeded boxes and a sparse IoU, exactly,
   with its ms and byte bound. The parent side of --compare skips this
   phase.
17. trains and evaluates in several processes (`parallel/dist.py`; see
   `ddp_step_check`, `ddp_cli_path`): (a) phase 8's seeded state and batch,
   one KD step in one process (B = 2), then the same step in 2 ranks that
   share this card over gloo (CUDA tensors; NCCL takes one rank a card),
   one clip each, with the one-process step's hard decisions, dropout and
   criterion draws replayed: the summed, clipped gradients within
   DDP_GRAD_RTOL (1e-3) of the one-process step's in the 2-norm, the losses
   within rtol 1e-4, the ranks' parameters bit-identical after the step,
   K1/K2/K5 launches in each rank; then phase 10's eval set in the two
   ranks' shards, merged by rank 0 (K1/K3/K4 per video), whose results.json
   equals one process's video for video; (b) the CLI under `python -m
   torch.distributed.run --nproc-per-node N` (N = the cards here; NCCL for
   N >= 2) over a YTVIS set of JPEG files at 360x640: 2 steps with a
   checkpoint, --resume to 3, --eval-only; one metrics.json with each
   iteration once and one checkpoint set (rank 0's), the eval's
   results.json; with N >= 2 the merged results.json against one
   process's; (c) the gradient bucket's bytes and, with N >= 2, one NCCL
   all-reduce of it and the N-rank step against one process's at the same
   global batch. --ddp-only runs the build and this phase alone. The parent
   side of --compare skips this phase.
With --profile, one more inference clip and one more train step run under
torch.profiler: device time per stage, the top kernels and the device's idle
share. Run from the root of another checkout of the package (with
PYTHONPATH set to it), this file times and checks that checkout's kernels
and paths. --compare PARENT does that for two commits in one call: it
copies itself into the checkout PARENT (e.g. `git archive <commit>`
unpacked under build/), runs there and here in turns parent, change,
change, parent, each in its own process with its log under build/compare/,
and prints each run's key lines and the kernels' times side by side. In
the parent's runs (CHIP_SMOKE_SIDE=parent) the checks of properties the
parent does not have (K2's determinism, the checkpoint loader) print their
result without failing.

Any failure raises (exit code != 0). The second-to-last line is the kernels'
JSON record, the last line {"ok": true, "device": {...}}. Without a CUDA
device it stops before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T, IN_H, IN_W = 8, 360, 640
OUT_SIZE = (720, 1280)
REQUESTS = 4  # the first clip, then 3 timed ones
SEED = 0
LEVELS = [(12, 20), (24, 40), (48, 80)]  # MSDA levels of a 384x640 padded input
PER_CLIP = {"k1_msda": 6, "k3_flash": 9, "k4_nms": 1}
KD_CONFIG = "configs/ytvis2021_kd_video_mask2former_R50_cls_agnostic.yaml"
EVAL_CONFIG = "configs/s2d_inference_kd_video_mask2former_R50_cls_agnostic.yaml"
EVAL_LENGTHS = (8, 5, 12)  # T-buckets 8, 8, 16
EVAL_DATASET = "chip_smoke_ytvis"
METRIC_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100")
TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_W, TRAIN_SLOTS, TRAIN_STEPS = 2, 3, 368, 640, 25, 3
OFFSET_STD = 0.01  # the encoder's sampling-offset weights (see `new_train_state`)
INTERLEAVED_RUNS = 5  # K6 empty and torch.zeros, timed in turns
# K4: one, the main path's, 32-bit word edges, the last of the one-block
# kernel and the first of the scratch path (nms.WALK_FROM = 128), the
# CutLER TTA merge's and cascade's (2 uint4 lanes a row on the scratch
# path), 32 words of the removed set and one more, the most
NMS_SIZES = (1, 50, 64, 65, 127, 128, 180, 256, 1024, 1025, 4096)
K2_CALLS = 3  # K2 calls on one input that must agree bit for bit
# --compare runs the parent's checkout with this variable set: the checks of
# what the parent does not have yet print their result without failing
PARENT = os.environ.get("CHIP_SMOKE_SIDE") == "parent"
# phase 14: the KD step's options (bit-packed targets are the loader's default)
OPTION_OPTS = ("MODEL.MASK_FORMER.DISTILLATION_NMS", "True",
               "INPUT.DISENTANGLE_DISTILLATION_LOADER", "True",
               "MODEL.MASK_FORMER.POINT_SAMPLING", "lattice")
OPTION_STEPS = 3
# phase 10's synthetic crop check: tracks, frames, ellipses (stride-4 px)
CROP_TRACKS, CROP_T = 50, 16
TRACKS = 25  # NMS survivors `spread_queries` aims the eval weights at
# phase 12: the train CLI's synthetic train set (videos, frames a video,
# instances a video), its test set's video lengths, and MAX_ITER of the
# first run and of the resumed one
TRAIN_SET_VIDEOS, TRAIN_SET_LENGTH, TRAIN_SET_INSTANCES = 6, 10, (3, 8)
CLI_EVAL_LENGTHS = (8, 5)
CLI_ITERS = (4, 6)
MIN_TRACKS = 10  # NMS survivors the eval phase needs in each video
# phase 15: stage 1, the CutLER detector (config, synthetic COCO set, runs)
CUTLER_CONFIG = "configs/cuts3d/original_cascade_mask_rcnn_R_50_FPN.yaml"
CUTLER_IMAGES = 8
CUTLER_HW = (480, 640)
CUTLER_ITERS = (2, 3)  # --max-iter of the first run, then of the resumed one
CUTLER_TTA_IMAGES = 2
CUTLER_NMS_SIZES = (1025, 1800, 4096)  # K4's large path: seeded boxes
# phase 16: real inputs (JPEG files, polygon annotations) through the CLIs
JPEG_FIXTURES = Path("tests") / "data" / "jpeg"
REAL_VIDEOS, REAL_FRAMES, REAL_QUALITY = 2, 8, 90
REAL_COCO = "chip_smoke_coco_jpeg"
REAL_KEYMASK_FRAMES = 24
REAL_NMS_SIZES = (4097, 8192)  # K4 past one walk block of 4096
# phase 17: training and evaluating in several processes. (a) ranks sharing
# one card (gloo over CUDA tensors: NCCL takes one rank a device), each on
# its part of phase 8's batch; (b) the CLI under torchrun, a rank a card
DDP_WORLD = 2
# (a): |g_ranks - g_one|_2 / |g_one|_2 over every clipped gradient, the hard
# decisions and the draws replayed: two f32 paths that differ only in the
# batch size some kernels sum over (cuDNN's and cuBLAS's choices)
DDP_GRAD_RTOL = 1e-3
DDP_SEED = SEED + 17
DDP_FRAME_HW = (360, 640)  # (b): the JPEG frames of its YTVIS train and valid sets
DDP_TRAIN_VIDEOS, DDP_LENGTH, DDP_ITERS = 4, 6, (2, 3)
# phase 13: keymask discovery's synthetic set (videos, frames a video,
# objects a video), the CLI's grid, and a group's least share of an
# object's frames at mask IoU >= 0.5
KEYMASK_VIDEOS, KEYMASK_T, KEYMASK_OBJECTS, KEYMASK_GRID = 2, 24, 5, 50
KEYMASK_COVERAGE = 0.8
# the CoTracker's card run against its CPU run: the scale of the random
# net's delta head (see `unsaturate`), the least share of visibilities in
# (0.01, 0.99), and the largest differences allowed (absolute: a relative
# part would grow with the tracks)
COTRACKER_DELTA_SCALE = 0.01
COTRACKER_VIS_INNER = 0.9
COTRACKER_TRACK_ATOL = 4e-3  # px of the 720x1280 frame
COTRACKER_VIS_ATOL = 1e-5
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense): HBM3
# bytes/s, float32 operations/s outside the tensor cores, TF32 operations/s
# on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


SLEEP_CYCLES_PER_S = 2e9  # above the card's clock: a sleep lasts at least its seconds
MAX_SLEEP_S = 0.05


def host_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Host time to enqueue one call (no synchronize inside a loop): the
    median over `repeats` loops of each loop's mean over `iters` calls (the
    host is shared, and a loop now and then reads a preempted core)."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        means.append((time.perf_counter() - start) * 1e3 / iters)
        torch.cuda.synchronize()
    return float(np.median(means))


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls. The
    calls queue up behind a device-side sleep as long as the host needs to
    enqueue them (up to MAX_SLEEP_S), so a call shorter than its own launch
    overhead is timed on the device and not at the host's launch rate; a
    call that synchronizes is timed as it runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # ten times the enqueue time of the calls (the median of 3 loops of 5): a
    # wrapper whose host time is ~10x its kernel's (K4) must not drain the
    # queue when its enqueue runs slower than the estimate
    sleep_s = min(MAX_SLEEP_S, 1e-2 * iters * host_ms(fn, 5, 3))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> dict:
    """The least time of a call: its bytes (each input read once, each output
    written once) at the HBM rate, or its operations at `ops_per_s` (by
    default f32 on the CUDA cores), whichever is longer."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    if by_bytes >= by_ops:
        return dict(bound_ms=by_bytes, bound_by="bytes")
    return dict(bound_ms=by_ops, bound_by="operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name, got, ref, rtol, atol):
    """Prints and returns (max |got - ref|, max |got - ref| / (atol + rtol |ref|));
    raises on a shape mismatch or a non-finite value."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    ratio = (err / (atol + rtol * ref.abs())).max().item()
    max_err = err.max().item()
    print(f"  {name}: max_abs_err {max_err:.3e}, worst err/bound {ratio:.3f} "
          f"(rtol {rtol}, atol {atol})")
    return max_err, ratio


def require_close(name, got, ref, rtol, atol) -> float:
    """check_close that raises beyond the bound; returns the max error."""
    max_err, ratio = check_close(name, got, ref, rtol, atol)
    if ratio > 1.0:
        raise AssertionError(f"{name}: error {max_err:.3e} beyond rtol {rtol} / atol {atol}")
    return max_err


def _differ(mine, theirs) -> int:
    if isinstance(mine, (tuple, list)):
        return sum(_differ(a, b) for a, b in zip(mine, theirs))
    return int((mine != theirs).sum())


_MISSING = object()


class Tape:
    """Records what one function returns (a hard decision) in one run and
    replays it in another. The decoder's cross-attention masks
    (sigmoid(logit) < 0.5), the distillation targets (mask logit > 0, score >=
    threshold) and the auction's assignments (on costs quantized to 4096
    levels) are hard decisions: where a value lies within rounding of its
    threshold, two correct f32 paths decide differently, and the decisions
    then drive the rest apart. Replaying one path's decisions in the other
    compares their arithmetic; `differ` counts the decisions the replaying
    path would have made otherwise. `keep(args, out)` is what is recorded."""

    def __init__(self, name: str, keep=lambda args, out: out):
        self.name, self.keep = name, keep
        self.values, self.differ = [], 0

    def _patch(self, owner, hook):
        self._undo = (owner, owner.__dict__.get(self.name, _MISSING))
        setattr(owner, self.name, hook)

    def record(self, owner) -> "Tape":
        own = getattr(owner, self.name)

        def hook(*args, **kwargs):
            out = own(*args, **kwargs)
            self.values.append(self.keep(args, out))
            return out
        self._patch(owner, hook)
        return self

    def replay(self, owner, force: bool) -> "Tape":
        own, it = getattr(owner, self.name), iter(self.values)
        self.differ = 0

        def hook(*args, **kwargs):
            mine, theirs = own(*args, **kwargs), next(it)
            self.differ += _differ(mine, theirs)
            return theirs if force else mine
        self._patch(owner, hook)
        return self

    def stop(self) -> None:
        owner, old = self._undo
        if old is _MISSING:
            delattr(owner, self.name)
        else:
            setattr(owner, self.name, old)


def compare_paths(cfg, predictor, clip, out_k, mods):
    """Clip 0 on the plain path (plain MSDA, plain attention, plain NMS) on
    the card, against the kernel path: the configured run, then with the
    kernel path's attention-mask decisions replayed, in the configured dtype
    and with the cast points off (f32)."""
    import dataclasses

    from s2d_tpu_torch.demo_video import VideoPredictor

    failures = []
    for amp in (cfg.amp, False) if cfg.amp else (False,):
        run_cfg = dataclasses.replace(cfg, amp=amp)
        kern = predictor if amp == cfg.amp else VideoPredictor(run_cfg, seed=None, device=predictor.device)
        plain = VideoPredictor(run_cfg, seed=None, device=predictor.device, kernels=False)
        kern.model.load_state_dict(predictor.model.state_dict())
        plain.model.load_state_dict(predictor.model.state_dict())
        tape = Tape("attention_mask").record(kern.model.predictor)
        ok, pk = kern.predict(clip, OUT_SIZE)
        tape.stop()
        if kern is predictor and not all(torch.equal(ok[k], out_k[k]) for k in ("pred_logits", "pred_masks")):
            failures.append("the kernel path is not deterministic")
        for force in (False, True):
            tape.replay(plain.model.predictor, force)
            before = {k: m.LAUNCHES for k, m in mods.items()}
            op, pp = plain.predict(clip, OUT_SIZE)
            torch.cuda.synchronize()
            tape.stop()
            if {k: m.LAUNCHES for k, m in mods.items()} != before:
                failures.append("the plain path launched a kernel")
            tag = f"{'bf16 cast points' if amp else 'f32'}, {'replayed' if force else 'own'} masks"
            print(f"plain vs kernel path, clip 0, {tag}: {tape.differ} attention-mask "
                  f"decisions differ")
            ratios = {key: check_close(key, ok[key], op[key], 1e-3, 2e-3)[1]
                      for key in ("pred_logits", "pred_masks")}
            same_keep = torch.equal(pk["keep"], pp["keep"])
            flips = (pk["masks"] != pp["masks"]).float().mean().item()
            print(f"  keep-set {'identical' if same_keep else 'DIFFERS'} "
                  f"({int(pk['keep'].sum())} kept); binary-mask flips {flips:.2e}")
            if not same_keep:
                failures.append(f"{tag}: keep-set differs")
            # the golden bound holds where no quantizer sits between the
            # kernels and the output: replayed decisions, and for the masks
            # no bf16 rounding of mask_features (a 1e-6 difference there
            # flips a bf16 rounding, a 2^-8 relative step)
            bounded = ("pred_logits", "pred_masks") if not amp else ("pred_logits",)
            for key in bounded if force else ():
                if ratios[key] > 1.0:
                    failures.append(f"{tag}: {key} beyond rtol 1e-3 / atol 2e-3")
        del plain
    if failures:
        raise AssertionError("; ".join(failures))


def msda_inputs(frames, dev, gen, off_kinks=False):
    """MSDA operands at the encoder's shapes (S = Lq = 5040, M=8, D=32, L=3,
    P=4), with offsets that put a share of the points outside [0, 1].

    off_kinks: move each sampling coordinate (x = loc * W - 0.5, as the
    kernels compute it) that lies within 1e-3 of an integer by 2e-3 pixels.
    Bilinear sampling has a kink there: its gradient in the location is
    two-valued, and the kernel (floor of x) and `F.grid_sample` (floor of
    its own rounding of x) may take different sides."""
    s = sum(h * w for h, w in LEVELS)
    value = torch.randn(frames, s, 8, 32, device=dev, generator=gen)
    ref_pts = torch.rand(frames, s, 1, 3, 1, 2, device=dev, generator=gen)
    norm = torch.tensor([[w, h] for h, w in LEVELS], device=dev, dtype=torch.float32)
    offsets = 3.0 * torch.randn(frames, s, 8, 3, 4, 2, device=dev, generator=gen)
    locs = (ref_pts + offsets / norm[None, None, None, :, None, :]).contiguous()
    if off_kinks:
        scale = norm[None, None, None, :, None, :]
        coord = locs * scale - 0.5
        near = (coord - coord.round()).abs() < 1e-3
        locs = torch.where(near, locs + 2e-3 / scale, locs).contiguous()
        print(f"  {int(near.sum())} sampling coordinates within 1e-3 of a kink moved by 2e-3 px")
    weights = torch.softmax(torch.randn(frames, s, 8, 12, device=dev, generator=gen), -1)
    return value, locs, weights.reshape(frames, s, 8, 3, 4).contiguous()


def kernel_checks(dev, record):
    import torch.nn.functional as F

    from s2d_tpu_torch.ops import masked_attention_cuda as k3
    from s2d_tpu_torch.ops import ms_deform_attn_cuda as k1
    from s2d_tpu_torch.ops import nms as k4
    from s2d_tpu_torch.ops.ms_deform_attn import ms_deform_attn_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # K1 at the inference encoder's shapes (B = T frames, the main path's,
    # whose numbers head the record) and the train step's (B = 2 clips x 3)
    k1_by_shape = {}
    for path, frames in (("inference", T), ("train", TRAIN_B * TRAIN_T)):
        value, locs, weights = msda_inputs(frames, dev, gen)
        print(f"K1 msda ({path}): value {tuple(value.shape)}, "
              f"{((locs < 0) | (locs > 1)).any(-1).float().mean().item():.1%} of the points "
              "outside [0, 1]")
        got = k1.ms_deform_attn_cuda(value, LEVELS, locs, weights)
        torch.cuda.synchronize()
        err = require_close(f"K1 vs plain ({path})", got,
                            ms_deform_attn_plain(value, LEVELS, locs, weights), 0.0, 1e-4)
        # per point and channel: 4 products and 3 sums (bilinear), 1 product
        # and 1 sum (attention weight)
        k1_by_shape[path] = dict(
            value=list(value.shape), max_abs_err=err,
            ms=cuda_ms(lambda: k1.ms_deform_attn_cuda(value, LEVELS, locs, weights)),
            host_ms=host_ms(lambda: k1.ms_deform_attn_cuda(value, LEVELS, locs, weights)),
            plain_ms=cuda_ms(lambda: ms_deform_attn_plain(value, LEVELS, locs, weights)),
            **bound(nbytes(value, locs, weights, got), 9 * weights.numel() * value.shape[-1]))
        del value, locs, weights, got
    main = k1_by_shape["inference"]
    record["k1_msda"] = dict(
        name="ms_deform_attn_fwd", route="cuda", source="s2d_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        replaces="s2d_tpu/ops/ms_deform_attn_pallas.py:82",
        max_abs_err=max(e["max_abs_err"] for e in k1_by_shape.values()),
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None, by_shape=k1_by_shape,
    )
    for path, e in k1_by_shape.items():
        print(f"  K1 ({path}, value {tuple(e['value'])}): kernel {e['ms']:.4f} ms (host "
              f"{e['host_ms']:.4f} ms to enqueue), plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']})")

    # K3 at the decoder's shapes: BH=8, Q=100, Dh=32, K = T*h*w per level;
    # frames 6 and 7 are pad frames (keys blocked), query 5 fully blocked.
    # A clip launches it 3 times at each K.
    k3_by_len, work = [], []
    for h, w in LEVELS:
        k_len = T * h * w
        q = torch.randn(8, 100, 32, device=dev, generator=gen)
        kk = torch.randn(8, k_len, 32, device=dev, generator=gen)
        v = torch.randn(8, k_len, 32, device=dev, generator=gen)
        blocked = torch.rand(1, 1, 100, k_len, device=dev, generator=gen) > 0.5
        blocked[..., 6 * h * w:] = True
        blocked[:, :, 5] = True
        mask = blocked.expand(1, 8, 100, k_len)
        got = k3.masked_cross_attention(q, kk, v, mask)
        torch.cuda.synchronize()
        if not torch.all(got[:, 5] == 0):
            raise AssertionError(f"K3 (K={k_len}): a fully blocked row must give 0")
        err = require_close(f"K3 vs plain (K={k_len})", got,
                            k3.masked_attention_plain(q, kk, v, mask), 0.0, 1e-4)
        # the library call: scaled_dot_product_attention with a boolean mask
        # of the keys each query may see; it has no answer for a fully
        # blocked row, so row 5 sees what row 4 sees there
        allowed = ~blocked
        allowed[:, :, 5] = allowed[:, :, 4]
        allowed = allowed.expand(1, 8, 100, k_len)
        # QK^T and PV: 2 x (2 Q K Dh) per head, each f32-accurate product as
        # 3 TF32 products on the tensor cores (faster than f32 on the CUDA
        # cores); the mask read once (1, 1, Q, K)
        work.append((nbytes(q, kk, v, got, blocked), 3 * 4 * 8 * 100 * k_len * 32))
        k3_by_len.append(dict(
            key_length=k_len, max_abs_err=err,
            ms=cuda_ms(lambda: k3.masked_cross_attention(q, kk, v, mask)),
            host_ms=host_ms(lambda: k3.masked_cross_attention(q, kk, v, mask)),
            plain_ms=cuda_ms(lambda: k3.masked_attention_plain(q, kk, v, mask)),
            **bound(*work[-1], TF32_OPS_PER_S),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q[None], kk[None], v[None], attn_mask=allowed)),
        ))
        del q, kk, v, blocked, mask, allowed, got
    # the record's times are a launch's mean over a clip's mix (3 at each K);
    # per_clip_ms sums the 9 launches
    timed = ("ms", "plain_ms", "library_ms")
    per_clip = {key: 3 * sum(e[key] for e in k3_by_len) for key in timed}
    record["k3_flash"] = dict(
        name="masked_attention_fwd", route="cuda", source="s2d_tpu_torch/csrc/masked_attention.cu",
        replaces="s2d_tpu/ops/masked_attention_pallas.py:34",
        max_abs_err=max(e["max_abs_err"] for e in k3_by_len),
        **{key: per_clip[key] / 9 for key in timed},
        **bound(*(sum(col) / len(work) for col in zip(*work)), TF32_OPS_PER_S),
        by_key_length=k3_by_len,
        per_clip_ms=dict(per_clip, bound_ms=3 * sum(e["bound_ms"] for e in k3_by_len)),
    )
    for e in k3_by_len:
        print(f"  K3 (K={e['key_length']}): kernel {e['ms']:.4f} ms (host {e['host_ms']:.4f} ms to "
              f"enqueue), plain {e['plain_ms']:.4f} ms, "
              f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), library {e['library_ms']:.4f} ms")
    print("  K3 a clip (3 launches at each K): " + ", ".join(
        f"{key} {v:.4f}" for key, v in record["k3_flash"]["per_clip_ms"].items()))

    # K4 on random IoU / labels (int64, as the postprocess hands them over)
    # at each of NMS_SIZES: the keep mask must match exactly. Timed at the
    # main path's N = 50, beside the device time of an empty launch
    rng = np.random.RandomState(SEED)
    # a parent's K4 may take fewer (older checkouts capped it at 1024 or 4096)
    sizes = [n for n in NMS_SIZES if n <= getattr(k4, "MAX_CANDIDATES", n)]
    for n in sizes:
        for trial in range(8):
            iou = rng.rand(n, n).astype(np.float32)
            if trial % 2:
                iou = np.round(iou * 4) / 4  # ties with the threshold
            iou = np.maximum(iou, iou.T)
            np.fill_diagonal(iou, 1.0)
            labels = rng.randint(0, 3 if trial < 4 else 1, n)  # 1 label: every pair ties
            iou_t = torch.from_numpy(iou).to(dev)
            lab_t = torch.from_numpy(labels).to(dev)
            got = k4.greedy_mask_nms(iou_t, lab_t, 0.75)
            ref = k4.greedy_mask_nms_plain(iou_t, lab_t, 0.75)
            if not torch.equal(got, ref):
                raise AssertionError(f"K4 keep mask differs from plain (N={n}, trial {trial})")
        if n == 50:
            main_nms = (iou_t, lab_t, got)
    if hasattr(k4, "WALK_FROM"):  # the one-block kernel at its most, which the wrapper
        walk_from, k4.WALK_FROM = k4.WALK_FROM, 1025  # gives the scratch path
        try:
            iou_t, lab_t = iou_t[:1024, :1024].contiguous(), lab_t[:1024]
            if not torch.equal(k4.greedy_mask_nms(iou_t, lab_t, 0.75),
                               k4.greedy_mask_nms_plain(iou_t, lab_t, 0.75)):
                raise AssertionError("K4's one-block kernel differs from plain at N=1024")
        finally:
            k4.WALK_FROM = walk_from
    print(f"  K4 vs plain: 8 keep masks identical at each N of {sizes}"
          + (", the one-block kernel's at 1024 too" if hasattr(k4, "WALK_FROM") else ""))
    iou_t, lab_t, got = main_nms
    record["k4_nms"] = dict(
        name="greedy_nms", route="cuda", source="s2d_tpu_torch/csrc/nms.cu",
        replaces="s2d_tpu/ops/nms.py:62", max_abs_err=0.0,
        ms=cuda_ms(lambda: k4.greedy_mask_nms(iou_t, lab_t, 0.75)),
        plain_ms=cuda_ms(lambda: k4.greedy_mask_nms_plain(iou_t, lab_t, 0.75), iters=5),
        # one compare per (candidate, earlier candidate)
        **bound(nbytes(iou_t, lab_t, got), 50 * 50), library_ms=None,
    )
    if hasattr(k4, "empty_launch"):
        # K4's floor: a byte bound sees none of its latency
        record["k4_nms"]["launch_floor_ms"] = cuda_ms(lambda: k4.empty_launch(dev))
        print(f"  K4 at N=50: {record['k4_nms']['ms']:.4f} ms; an empty kernel launch "
              f"{record['k4_nms']['launch_floor_ms']:.4f} ms")

    # K2 at the train step's encoder shapes: B=2 clips x T=3 frames
    from s2d_tpu_torch.ops.ms_deform_attn_cuda import (
        ms_deform_attn_bwd_cuda,
        ms_deform_attn_bwd_plain,
    )

    value, locs, weights = msda_inputs(TRAIN_B * TRAIN_T, dev, gen, off_kinks=True)
    grad_out = torch.randn(value.shape[0], value.shape[1], 256, device=dev, generator=gen)
    print(f"K2 msda backward: value {tuple(value.shape)}, "
          f"{((locs < 0) | (locs > 1)).any(-1).float().mean().item():.1%} of the points outside [0, 1]")
    got = ms_deform_attn_bwd_cuda(value, LEVELS, locs, weights, grad_out)
    torch.cuda.synchronize()
    # determinism: K2_CALLS calls bit for bit, and a hash that another
    # process of this checkout must reproduce (--compare prints each run's)
    digest = hashlib.sha256()
    for g in got:
        digest.update(g.cpu().numpy().tobytes())
    differ = []
    for call in range(1, K2_CALLS):
        again = ms_deform_attn_bwd_cuda(value, LEVELS, locs, weights, grad_out)
        differ += [f"call {call} d {what}" for what, a, b in
                   zip(("value", "locations", "weights"), got, again) if not torch.equal(a, b)]
    del again
    print(f"K2 gradient hash {digest.hexdigest()[:16]}; {K2_CALLS} calls "
          f"{'bitwise identical' if not differ else 'DIFFER: ' + ', '.join(differ)}")
    if differ and not PARENT:
        raise AssertionError(f"K2 is not deterministic: {differ}")
    ref = ms_deform_attn_bwd_plain(value, LEVELS, locs, weights, grad_out)
    ref64 = ms_deform_attn_bwd_plain(value.double(), LEVELS, locs.double(),
                                     weights.double(), grad_out.double())
    errs = []
    for what, g, r, r64 in zip(("value", "locations", "weights"), got, ref, ref64):
        # d value: atol 1e-4, K2 sums in fixed point, the plain version in
        # f32 in its own order. d locations and
        # d weights sum over the channels with corner weights that each
        # version derives from a sampling coordinate rounded in f32 (up to
        # 80 px, 8e-6 apart): held at atol 1e-4 + 2e-5 max|d|, the scale of
        # the plain version's own distance to float64 printed beside
        atol = 1e-4 if what == "value" else 1e-4 + 2e-5 * r.abs().max().item()
        errs.append(require_close(f"K2 d {what} vs plain", g, r, 0.0, atol))
        print(f"    max |d {what}| {r.abs().max().item():.3e}; against the plain version in "
              f"float64: kernel {(g.double() - r64).abs().max().item():.3e}, plain f32 "
              f"{(r.double() - r64).abs().max().item():.3e}")
    del ref64

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_(True) for t in (value, locs, weights)]
        fn(leaves[0], LEVELS, leaves[1], leaves[2]).backward(grad_out)

    both = (cuda_ms(lambda: fwd_bwd(k1.ms_deform_attn_cuda)),
            cuda_ms(lambda: fwd_bwd(ms_deform_attn_plain)))
    print(f"  K1 + K2 (forward + backward through autograd): {both[0]:.4f} ms, "
          f"plain autograd {both[1]:.4f} ms")
    # per point and channel: the bilinear sample again (7), its weight
    # gradient (2), the x and y corner differences (2 x 5), and 4 weighted
    # corner updates (8)
    record["k2_msda_bwd"] = dict(
        name="ms_deform_attn_bwd", route="cuda", source="s2d_tpu_torch/csrc/ms_deform_attn_bwd.cu",
        replaces="s2d_tpu/ops/ms_deform_attn_pallas.py:113", max_abs_err=max(errs),
        ms=cuda_ms(lambda: ms_deform_attn_bwd_cuda(value, LEVELS, locs, weights, grad_out)),
        plain_ms=cuda_ms(lambda: ms_deform_attn_bwd_plain(value, LEVELS, locs, weights, grad_out)),
        **bound(nbytes(value, locs, weights, grad_out, *got), 27 * weights.numel() * value.shape[-1]),
        library_ms=None, deterministic=not differ, gradient_hash=digest.hexdigest()[:16],
    )
    for key, r in record.items():
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){lib}")


def fixed_auction_problems(dev):
    """A seeded stand-in for the train step's 40 auction problems (2 criteria
    x 10 decoder layers x B=2), the same in every checkout: the step's own
    problems follow its K1 rounding, so two checkouts would time K5 on
    different problems. 100 queries x 100 target slots; the costs are the
    matcher's (5 BCE + 5 dice, class weight 0) on 4096 sampled points, from
    mask logits that share one random field across the queries plus a
    per-query part, as a randomly initialized decoder's do:
      * 20 supervised problems: 25 slots of random blobs, about 80% valid,
        padded to 100 with invalid columns (the criterion's padding);
      * 20 distillation problems: 100 slots, about 60% valid, each slot the
        binarized mask of a query (at step 0 the teacher is the student)
        with a little noise (the student's dropout)."""
    from s2d_tpu_torch.losses.matcher import batch_dice_cost, batch_sigmoid_ce_cost

    rng = np.random.RandomState(SEED + 5)
    q, n, pts = 100, 100, 4096
    costs, valids = [], []
    for k in range(40):
        shared = 2.0 * rng.randn(1, pts)
        logits = (shared + 0.3 * rng.randn(q, pts)).astype(np.float32)
        if k < 20:
            blobs = rng.randn(TRAIN_SLOTS, pts) + rng.uniform(0.2, 1.0, (TRAIN_SLOTS, 1)) * shared > 1.0
            targets = np.concatenate([blobs, np.zeros((n - TRAIN_SLOTS, pts), bool)])
            valid = np.zeros(n, bool)
            valid[:TRAIN_SLOTS] = rng.rand(TRAIN_SLOTS) > 0.2
        else:
            targets = logits[rng.permutation(q)[:n]] + 0.1 * rng.randn(n, pts) > 0.0
            valid = rng.rand(n) > 0.4
        lt = torch.from_numpy(logits).to(dev)
        tt = torch.from_numpy(targets.astype(np.float32)).to(dev)
        costs.append(5.0 * batch_sigmoid_ce_cost(lt, tt) + 5.0 * batch_dice_cost(lt, tt))
        valids.append(valid)
    return torch.stack(costs).contiguous(), torch.from_numpy(np.stack(valids)).to(dev)


def cost_stats(cost, valid) -> str:
    """The spread of the valid costs: over the whole set, and across the
    queries of one target slot (what an assignment chooses between)."""
    c = cost.float()
    v = valid[:, None, :].expand_as(c)
    per_slot = c.std(dim=1)[valid]
    return (f"valid costs mean {c[v].mean().item():.4f}, std {c[v].std().item():.4f}, "
            f"std across the queries of a slot {per_slot.mean().item():.4f}")


def auction_check(dev, record, main_problem):
    """K5 against the plain auction: identical assignments. The main path's
    own 40 problems and the fixed seeded set are timed, each with the device
    time a round of its slowest problem (each problem has its own block, so
    the kernel lasts as long as that problem's rounds)."""
    from s2d_tpu_torch.losses.matcher import hungarian_assign_scipy
    from s2d_tpu_torch.ops import auction, auction_cuda

    rng = np.random.RandomState(SEED)
    half, q, n = 20, 100, 100
    sup_cost = np.zeros((half, q, n), np.float32)
    sup_cost[:, :, :TRAIN_SLOTS] = rng.rand(half, q, TRAIN_SLOTS) * 10
    sup_valid = np.zeros((half, n), bool)
    sup_valid[:, :TRAIN_SLOTS] = rng.rand(half, TRAIN_SLOTS) > 0.2
    kd_cost = (rng.rand(half, q, n) * 10).astype(np.float32)
    kd_valid = rng.rand(half, n) > 0.25
    ties = (rng.randint(0, 5, (2 * half, q, n)) / 5 + rng.rand(2 * half, q, n) * 1e-5).astype(np.float32)
    step_set, fixed_set = "the train step's own problems", "the fixed seeded set at the step's shapes"
    cases = {
        step_set: main_problem,
        fixed_set: fixed_auction_problems(dev),
        "25 supervised slots padded to 100 + 100 distillation slots, invalid columns": (
            torch.from_numpy(np.concatenate([sup_cost, kd_cost])).to(dev),
            torch.from_numpy(np.concatenate([sup_valid, kd_valid])).to(dev)),
        "quantized near-ties": (torch.from_numpy(ties).to(dev),
                                torch.ones(2 * half, n, dtype=torch.bool, device=dev)),
        # fewer slots than queries: the reverse rounds run
        "25 supervised slots alone": (
            torch.from_numpy(np.ascontiguousarray(sup_cost[:, :, :TRAIN_SLOTS])).to(dev),
            torch.from_numpy(np.ascontiguousarray(sup_valid[:, :TRAIN_SLOTS])).to(dev)),
    }
    timed = {}
    for name, (cost, valid) in cases.items():
        ben = auction.build_benefits(cost, valid)
        eps = auction.eps_schedule(cost.shape[2], False)
        got = auction_cuda.auction_asym_cuda(ben, eps)
        torch.cuda.synchronize()
        rounds = {}
        ref = auction.auction_asym_plain(ben, eps, rounds=rounds)
        if not torch.equal(got, ref):
            raise AssertionError(f"K5 assignments differ from plain ({name}): "
                                 f"{int((got != ref).sum())} of {got.numel()}")
        print(f"  K5 vs plain ({name}): {ben.shape[0]} problems of {ben.shape[1]} x "
              f"{ben.shape[2]}, assignments identical; active (problem, round) pairs {rounds}")
        if name in (step_set, fixed_set):
            print(f"    {cost_stats(cost, valid)}")
            timed[name] = (cost, ben, eps, got, rounds)

    def slowest(ms, rounds):
        """The slowest problem's rounds and the kernel's device us a round
        of it (None where this checkout's plain auction does not count
        them per problem)."""
        slow = rounds.get("slowest")
        per_round = None if slow is None else 1e3 * ms / (slow["forward"] + slow["reverse"])
        return dict(slowest=slow, us_per_round=per_round)

    cost, ben, eps, got, rounds = timed[step_set]
    _, fben, _, _, frounds = timed[fixed_set]
    hungarian_assign_scipy(cost[:1])  # imports scipy
    start = time.perf_counter()
    hungarian_assign_scipy(cost)
    scipy_ms = (time.perf_counter() - start) * 1e3
    b, n, q = ben.shape

    def ops(rounds):
        """The work the assignment needs, not the kernel's dense scans: a
        bid of an unassigned person reads its Q net values (a subtract, and
        compares for w1/i1 and w2) and is settled at its object (1); an
        unowned priced object in a reverse round reads the N person values
        (a subtract, and compares for beta/i* and gamma) and is settled (1),
        after a profit per person (1) in each active (problem, reverse
        round); a phase's partial reset takes each person's best net value
        (2 per benefit)."""
        return ((3 * q + 1) * rounds["bidders"] + (3 * n + 1) * rounds["sellers"]
                + n * rounds["reverse"] + 2 * b * len(eps) * n * q)

    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: auction_cuda.auction_asym_cuda(ben, eps))
    fixed_ms = cuda_ms(lambda: auction_cuda.auction_asym_cuda(fben, eps))
    record["k5_auction"] = dict(
        name="batched_auction", route="cuda", source="s2d_tpu_torch/csrc/auction.cu",
        replaces="s2d_tpu/ops/auction_pallas.py:48", max_abs_err=0.0, ms=ms,
        plain_ms=cuda_ms(lambda: auction.auction_asym_plain(ben, eps), iters=3),
        **bound(nbytes(ben, eps_t, got), ops(rounds)), library_ms=None,
        **slowest(ms, rounds),
        fixed_set=dict(ms=fixed_ms, rounds={k: v for k, v in frounds.items() if k != "slowest"},
                       **bound(nbytes(fben, eps_t, got), ops(frounds)), **slowest(fixed_ms, frounds)),
    )
    r = record["k5_auction"]
    print(f"  K5: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']}; {ops(rounds):.4g} operations, {nbytes(ben, eps_t, got)} bytes); host scipy LSA "
          f"of the same {b} problems {scipy_ms:.2f} ms (not asserted)")
    for what, e in (("the step's problems", r), ("the fixed set", r["fixed_set"])):
        per_round = "n/a" if e["us_per_round"] is None else f"{e['us_per_round']:.3f}"
        print(f"  K5 on {what}: {e['ms']:.4f} ms; slowest problem {e['slowest']}: {per_round} us "
              f"a round")


def train_batch(cfg, dev):
    """B=2 clips of T=3 uint8 frames at 368x640, normalized and zero-padded
    to 384x640, with 25 target slots per clip: an ellipse per slot drifting
    over the frames, about a fifth of the slots invalid, and one valid slot
    empty in one frame (temporal DropLoss)."""
    from s2d_tpu_torch.models.meta_arch import preprocess_clip

    rng = np.random.RandomState(SEED)
    frames = rng.randint(0, 256, (TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_W, 3), dtype=np.uint8)
    images = torch.cat([
        preprocess_clip(f, cfg.model.pixel_mean, cfg.model.pixel_std,
                        cfg.model.mask_former.size_divisibility, dev)[0]
        for f in frames])
    hp, wp = images.shape[2:4]
    per_slot = (TRAIN_B, TRAIN_SLOTS, 1, 1, 1)
    drift = rng.uniform(-12, 12, (TRAIN_B, TRAIN_SLOTS, TRAIN_T, 1, 1)).cumsum(2)
    cy = rng.uniform(0.15, 0.85, per_slot) * TRAIN_H + drift
    cx = rng.uniform(0.15, 0.85, per_slot) * TRAIN_W + drift[:, ::-1]
    ry = rng.uniform(0.04, 0.3, per_slot) * TRAIN_H
    rx = rng.uniform(0.04, 0.3, per_slot) * TRAIN_W
    dev_f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    yy = torch.arange(hp, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(wp, device=dev, dtype=torch.float32)[None, :]
    masks = ((yy - dev_f(cy)) / dev_f(ry)) ** 2 + ((xx - dev_f(cx)) / dev_f(rx)) ** 2 < 1.0
    masks[..., TRAIN_H:, :] = False
    valid = torch.from_numpy(rng.rand(TRAIN_B, TRAIN_SLOTS) > 0.2).to(dev)
    valid[0, 0] = True
    masks &= valid[:, :, None, None, None]
    masks[0, 0, 1] = False
    return images, masks, valid


class StageTimer:
    """Stands in for the trainer's `record_function`: the same span, with the
    card synchronized at both ends, so each stage's host time holds the
    device work of that stage."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - start) * 1e3


def new_train_state(cfg, dev, kernels=True, class_scale=None):
    """The seeded train state, with two changes to the student and the
    teacher alike:
      * the class head scaled by `class_scale`. Seeded random weights put
        every query's foreground score near 0.5, below
        SCORE_THRESHOLD_DISTILLATION (0.75), so the distillation criterion
        would see no target; the scale (chosen by `class_head_scale`) lets
        a share of the teacher's queries pass;
      * the encoder's sampling-offset weights drawn N(0, OFFSET_STD^2). The
        initialization (as JAX's) zeroes them and sets integer pixel
        offsets as biases, which puts every sampling point at its own level
        on an integer pixel coordinate: a kink of bilinear sampling, where
        the location gradient is two-valued and K2 and `F.grid_sample` pick
        a side by their own f32 rounding. The draw (about 0.16 px of
        offset) moves the points off the kinks, as training does."""
    from s2d_tpu_torch.models.pixel_decoder import MSDeformAttnModule
    from s2d_tpu_torch.train import trainer

    state = trainer.create_train_state(cfg, seed=SEED, device=dev, kernels=kernels)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for mod in state.student.modules():
            if isinstance(mod, MSDeformAttnModule):
                w = mod.sampling_offsets.weight
                w.copy_(OFFSET_STD * torch.randn(w.shape, generator=gen, device=w.device))
        if class_scale is not None:
            state.student.predictor.class_embed.weight.mul_(class_scale)
        state.teacher.load_state_dict(state.student.state_dict())
    return state


def class_head_scale(cfg, state, images) -> float:
    """The class-head scale at which the teacher's 40% quantile of
    foreground-minus-no-object logit margins on `images` meets the
    distillation threshold: about 60% of the queries become targets."""
    t = cfg.model.mask_former.score_threshold_distillation
    with torch.no_grad():
        logits = state.teacher(images)["pred_logits"].float()
    margin = (logits[..., 0] - logits[..., -1]).flatten()
    return float(np.log(t / (1.0 - t)) / margin.quantile(0.4).item())


def expected_launches(cfg, clips: int | None = None) -> dict:
    """Kernel launches of one KD step on the card: K1 in the teacher and the
    student forward (two with the disentangled view), and again when the
    backward recomputes the encoder layers; K2 in the student's backward;
    one K5 auction; with DISTILLATION_NMS, K4 once a clip (`clips`)."""
    enc = cfg.model.sem_seg_head.transformer_enc_layers
    student = 2 if cfg.input.disentangle_distillation_loader else 1
    out = {"k1_msda": enc * (1 + student * (2 if cfg.solver.grad_checkpoint else 1)),
           "k2_msda_bwd": enc * student, "k5_auction": 1}
    if cfg.model.mask_former.distillation_nms:
        out["k4_nms"] = clips
    return out


def train_counters():
    from s2d_tpu_torch.ops import auction_cuda, ms_deform_attn_cuda

    return {"k1_msda": (ms_deform_attn_cuda, "LAUNCHES"),
            "k2_msda_bwd": (ms_deform_attn_cuda, "BWD_LAUNCHES"),
            "k5_auction": (auction_cuda, "LAUNCHES")}


def read_counts(counters):
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def train_path(dev, cfg, batch):
    """3 full-width KD steps on the kernels, with the per-step checks.
    Returns (launches, state, step, the first step's auction problems, the
    class-head scale)."""
    from s2d_tpu_torch.losses import criterion
    from s2d_tpu_torch.train import trainer

    start = time.perf_counter()
    state = new_train_state(cfg, dev)
    class_scale = class_head_scale(cfg, state, batch[0])
    state = new_train_state(cfg, dev, class_scale=class_scale)
    step_fn = trainer.make_train_step(cfg)
    expected = expected_launches(cfg)
    print(f"train state: {time.perf_counter() - start:.1f} s; {len(state.optimizer.params)} parameter "
          f"tensors; class head scaled by {class_scale:.3f}; expected launches per step {expected}")
    opt = state.optimizer
    frozen = {i for i, lab in enumerate(opt.labels) if lab == "frozen"}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    problems = Tape("hungarian_assign", keep=lambda args, out: args[:2]).record(criterion)
    kd_valid = Tape("prepare_distillation_targets",
                    keep=lambda args, out: int(out[1].sum())).record(trainer)
    counters = train_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    times, timer = [], StageTimer()
    try:
        for i in range(TRAIN_STEPS):
            before = read_counts(counters)
            student0 = [p.detach().clone() for p in opt.params]
            teacher0 = [p.detach().clone() for p in state.teacher.parameters()]
            if i == TRAIN_STEPS - 1:
                trainer.record_function = timer
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, metrics = step_fn(state, *batch, generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            grew = {k: v - before[k] for k, v in read_counts(counters).items()}
            if grew != expected:
                raise AssertionError(f"train step {i}: launches {grew}, expected {expected}")
            bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
            if bad or float(metrics["grad_finite"]) != 1.0:
                raise AssertionError(f"train step {i}: non-finite {bad}, grad_finite "
                                     f"{float(metrics['grad_finite'])}")
            moved = sum(not torch.equal(a, p) for j, (a, p) in enumerate(zip(student0, opt.params))
                        if j not in frozen)
            if moved == 0:
                raise AssertionError(f"train step {i}: the student did not move")
            if any(not torch.equal(student0[j], opt.params[j]) for j in frozen):
                raise AssertionError(f"train step {i}: a FrozenBN affine moved")
            m = float(step_fn.ema_fn(state.step - 1))
            for t0, s, t in zip(teacher0, state.student.parameters(), state.teacher.parameters()):
                if not torch.equal(t, m * t0 + (1.0 - m) * s):
                    raise AssertionError(f"train step {i}: the teacher is not the EMA of the student")
            losses = ", ".join(f"{k} {float(v):.4f}" for k, v in metrics.items() if k != "grad_finite")
            print(f"train step {i}: {times[-1] * 1e3:.1f} ms, launches {grew}, moved {moved} of "
                  f"{len(opt.params) - len(frozen)} trainable tensors, FrozenBN held, teacher = "
                  f"EMA (m={m}), {kd_valid.values[-1]} distillation targets; {losses}")
            del student0, teacher0
    finally:
        trainer.record_function = torch.profiler.record_function
        problems.stop()
        kd_valid.stop()
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    steady = times[1:]
    print(f"train path: {1e3 * sum(steady) / len(steady):.1f} ms per step after the first "
          f"(steps {', '.join(f'{t * 1e3:.1f}' for t in steady)} ms; the last with a synchronize "
          f"at each stage), first step {times[0] * 1e3:.1f} ms, peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print("train step stages (last step, host clock, synchronized): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in timer.ms.items()))
    return launches, state, step_fn, problems.values[0], class_scale


ENCODER_PREFIX = "pixel_decoder.encoder_layer"
# per encoder leaf, |g_kernel - g_plain|_2 / |g_plain|_2, in f32 with the
# decisions replayed: 4x the worst reading on an H100 (5.1e-4; the biases
# sum over every query with cancellation, and a point within f32 rounding
# of a bilinear kink takes another side in K2 than in `F.grid_sample`).
# With every point on a kink (sampling-offset weights left at 0) the
# reading was 0.30.
GRAD_RTOL = 2e-3


def update_error(opt, p0, raw_grads) -> float:
    """The worst ratio, over every parameter element, of |p - ref| to its
    bound, where ref is the first update recomputed in float64 from the
    step's gradients: clip by global norm, Adam from zero moments (the
    bias-corrected moments give u = g / (|g| + eps)), decoupled decay, the
    group multiplier, -lr(0). Bound: 2 f32 ulps of |ref| + 1e-5 |update|."""
    from s2d_tpu_torch.train.optim import EPS

    g64 = [g.double() for g in raw_grads]
    norm = torch.stack([(g * g).sum() for g in g64]).sum().sqrt()
    scale = 1.0 if opt.clip is None or bool(norm < opt.clip) else opt.clip / norm
    lr = float(opt.schedule(0))
    worst = 0.0
    for i, (p, start, g) in enumerate(zip(opt.params, p0, g64)):
        g = g * scale
        u = g / (g.abs() + EPS)
        if opt.decay[i]:
            u = u + opt.weight_decay * start.double()
        ref = start.double() - lr * opt.multipliers[i] * u
        bound = 2.4e-7 * ref.abs() + 1e-5 * (ref - start.double()).abs()
        err = (p.detach().double() - ref).abs()
        if bool((err > bound).any()):
            worst = max(worst, (err / bound.clamp(min=1e-300)).max().item())
    return worst


def compare_train_step(dev, batch, class_scale):
    """One step from the seeded state on the plain path (plain MSDA with
    autograd, plain auction) against the kernel path, with the configured
    bf16 cast points and in f32. With the kernel step's hard decisions
    replayed, the losses are held at rtol 1e-3 / atol 2e-3, and in f32 the
    clipped gradients of every encoder leaf (K1 forward, K2 backward, the
    recompute under checkpointing) at GRAD_RTOL in the 2-norm. The kernel
    step's update of every parameter is held to its float64 recomputation
    (`update_error`)."""
    from s2d_tpu_torch.config import load_config_tree
    from s2d_tpu_torch.losses import criterion
    from s2d_tpu_torch.train import trainer

    counters = train_counters()
    failures = []
    for amp in (True, False):
        cfg = load_config_tree(KD_CONFIG, () if amp else ("SOLVER.AMP.ENABLED", "False"))
        tapes = [Tape("attention_mask"), Tape("attention_mask"),
                 Tape("prepare_distillation_targets"), Tape("hungarian_assign")]
        what = ["teacher attention-mask", "student attention-mask", "distillation-target",
                "assignment"]

        def owners(st):
            return [st.teacher.predictor, st.student.predictor, trainer, criterion]

        def run(kernels, tape_fn):
            state = new_train_state(cfg, dev, kernels, class_scale)
            opt = state.optimizer
            for tape, owner in zip(tapes, owners(state)):
                tape_fn(tape, owner)
            grads = Tape("step", keep=lambda args, out: list(args[0])).record(opt)
            p0 = [p.detach().clone() for p in opt.params] if kernels else None
            gen = torch.Generator(device=dev).manual_seed(SEED)
            try:
                _, metrics = trainer.make_train_step(cfg, kernels=kernels)(state, *batch, generator=gen)
                torch.cuda.synchronize()
            finally:
                for tape in tapes + [grads]:
                    tape.stop()
            (raw,) = grads.values
            clipped = opt.clip_gradients(raw)
            enc = {n: g for n, g in zip(opt.names, clipped) if n.startswith(ENCODER_PREFIX)}
            if kernels:
                ratio = update_error(opt, p0, raw)
                print(f"kernel train step ({'bf16 cast points' if amp else 'f32'}): update of "
                      f"{len(opt.params)} parameter tensors vs float64, worst err/bound {ratio:.3f}")
                if ratio > 1.0:
                    failures.append(f"the kernel step's update misses its float64 recomputation "
                                    f"({ratio:.3f})")
            return metrics, gen.get_state(), enc

        mk, gen_k, gk = run(True, lambda tape, owner: tape.record(owner))
        for force in (False, True):
            before = read_counts(counters)
            mp, gen_p, gp = run(False, lambda tape, owner: tape.replay(owner, force))
            if read_counts(counters) != before:
                failures.append("the plain train step launched a kernel")
            if not torch.equal(gen_k, gen_p):
                failures.append("the two train steps drew different random numbers")
            tag = f"{'bf16 cast points' if amp else 'f32'}, {'replayed' if force else 'own'} decisions"
            print(f"plain vs kernel train step, {tag}: decisions that differ: "
                  + ", ".join(f"{w} {t.differ}" for w, t in zip(what, tapes)))
            for key in mk:
                if key == "grad_finite":
                    continue
                _, ratio = check_close(key, mp[key], mk[key], 1e-3, 2e-3)
                if force and ratio > 1.0:
                    failures.append(f"{tag}: {key} beyond rtol 1e-3 / atol 2e-3")
            rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm().clamp(min=1e-30)).item() for n in gp}
            worst = max(rel, key=rel.get)
            abs_err = max((gk[n] - gp[n]).abs().max().item() for n in gp)
            g_max = max(gp[n].abs().max().item() for n in gp)
            print(f"  clipped gradients of {len(gp)} encoder leaves: worst |dg|/|g| {rel[worst]:.3e} "
                  f"({worst}), max abs err {abs_err:.3e} of max |g| {g_max:.3e} (bound {GRAD_RTOL} "
                  f"with replayed decisions in f32)")
            if force and not amp and rel[worst] > GRAD_RTOL:
                failures.append(f"{tag}: encoder gradient {worst} beyond {GRAD_RTOL}")
    if failures:
        raise AssertionError("; ".join(failures))


def profile_run(name: str, run) -> None:
    """`run()` once under torch.profiler: its wall, device time per span (the
    `record_function` stages), the top kernels, and the device's idle share;
    the trace goes to build/<name>_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    path = Path("build") / f"{name.replace(' ', '_')}_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        raise AssertionError("the profiler recorded no device work")
    busy, end = 0.0, device[0][0]
    for s, e in device:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    span = end - device[0][0]
    stages, host = {}, {}
    for e in events:
        if e.get("cat") in ("gpu_user_annotation", "user_annotation"):
            into = stages if e["cat"] == "gpu_user_annotation" else host
            into[e["name"]] = into.get(e["name"], 0.0) + e["dur"] / 1e3
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"][:80]] = kernels.get(e["name"][:80], 0.0) + e["dur"] / 1e3
    print(f"profiled {name}: wall {wall * 1e3:.2f} ms, device span {span / 1e3:.2f} ms, busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / span:.3f}")
    print("  device ms per span: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    print("  host ms per span: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    for kernel, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.2f} ms  {kernel}")


def ablate_checks(dev, record):
    """K6, each variant, against its plain version at the ablation tool's
    default shapes, timed beside its bound (tool.work: the bytes it must
    move, the operations it must do). One PyTorch call computes `empty`
    (`torch.zeros` of the output); the other three have none: `noconstruct`
    broadcasts one column, and `dotonly`/`full` gather with per-point rows
    and weights that no library sampler takes (WX is not a bilinear pair)."""
    from s2d_tpu_torch.ops.msda_ablate import VARIANTS, msda_ablate_plain
    from s2d_tpu_torch.ops.msda_ablate_cuda import msda_ablate
    from s2d_tpu_torch.tools import bench_pallas_ablate as tool

    args = tool.parse_args([])
    inputs = tool.make_inputs(args, dev)
    ng, gqp = inputs["vt"].shape[0], inputs["ya"].shape[-1]
    # 2 points fewer: rows not 16-byte aligned, a ragged last group
    ragged = {k: v if k == "vt" else v[..., :gqp - 2].contiguous() for k, v in inputs.items()}
    library = {"empty": lambda: torch.zeros((ng, args.d, gqp), dtype=torch.float32, device=dev)}
    print(f"K6 msda ablation: vt {tuple(inputs['vt'].shape)} bf16, points "
          f"{tuple(inputs['ya'].shape)}, and {gqp - 2} points")
    for variant in VARIANTS:
        for case in (inputs, ragged):
            got = tool.call(msda_ablate, variant, case, args)
            torch.cuda.synchronize()
            ref = tool.call(msda_ablate_plain, variant, case, args)
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"K6 {variant} ({case['ya'].shape[-1]} points): differs from its plain "
                    f"version by up to {(got - ref).abs().max().item():.3e}")
            del got, ref
        err = 0.0
        print(f"  K6 {variant} vs plain: identical at {gqp} and {gqp - 2} points")
        record[f"k6_{variant}"] = dict(
            name=f"msda_ablate_{variant}", route="cuda", source="s2d_tpu_torch/csrc/msda_ablate.cu",
            replaces="tools/bench_pallas_ablate.py:34", max_abs_err=err,
            ms=cuda_ms(lambda: tool.call(msda_ablate, variant, inputs, args)),
            plain_ms=cuda_ms(lambda: tool.call(msda_ablate_plain, variant, inputs, args)),
            **bound(*tool.work(variant, inputs, args.d)),
            library_ms=cuda_ms(library[variant]) if variant in library else None,
        )
        r = record[f"k6_{variant}"]
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        print(f"  K6 {variant}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    # `empty` against its library call in turns: does the gap hold past the
    # runs' spread?
    kernel_runs, zeros_runs = [], []
    for _ in range(INTERLEAVED_RUNS):
        kernel_runs.append(cuda_ms(lambda: tool.call(msda_ablate, "empty", inputs, args)))
        zeros_runs.append(cuda_ms(library["empty"]))
    record["k6_empty"]["interleaved"] = dict(ms=kernel_runs, library_ms=zeros_runs)
    held = min(kernel_runs) > max(zeros_runs)
    print(f"  K6 empty vs torch.zeros in turns: kernel {', '.join(f'{t:.4f}' for t in kernel_runs)} "
          f"ms; torch.zeros {', '.join(f'{t:.4f}' for t in zeros_runs)} ms: the gap "
          f"{'holds past' if held else 'does not hold past'} the runs' spread")


def ablate_path():
    """K6's path: the ablation tool at its defaults, with the counts set to
    0 just before it and read just after. Returns the launches per variant."""
    from s2d_tpu_torch.ops import msda_ablate_cuda
    from s2d_tpu_torch.tools import bench_pallas_ablate as tool

    args = tool.parse_args([])
    msda_ablate_cuda.LAUNCHES = {k: 0 for k in msda_ablate_cuda.LAUNCHES}
    tool.run(args)
    launches = dict(msda_ablate_cuda.LAUNCHES)
    expected = {k: 1 + args.iters for k in launches}  # the warm-up and the timed calls
    if launches != expected:
        raise AssertionError(f"ablation tool: K6 launches {launches}, expected {expected}")
    print(f"ablation tool: K6 launches {launches}")
    return launches


def write_eval_set(root: Path, rng, lengths=EVAL_LENGTHS, name=EVAL_DATASET,
                   class_agnostic=True) -> dict:
    """A YTVIS set of videos of `lengths` frames recorded at OUT_SIZE, each
    with 3 drifting ellipses as ground truth (per-frame RLE by the port's
    codec), registered as `name`. Returns the 360x640 uint8 frames per video
    id (no image file is written: the eval takes them through mapper=) and prints the host
    time of one ground-truth (ellipse) mask's RLE encoding."""
    from s2d_tpu_torch.data import rle, ytvis

    h, w = OUT_SIZE
    yy, xx = np.mgrid[:h, :w]
    videos, annotations, frames = [], [], {}
    rle.encode(np.zeros((8, 8), bool))  # builds the native RLE library, untimed
    encode_s = 0.0
    for vid, t in enumerate(lengths, start=1):
        videos.append({"id": vid, "height": h, "width": w, "length": t,
                       "file_names": [f"v{vid}/{i:05d}.jpg" for i in range(t)]})
        frames[vid] = rng.randint(0, 256, (t, IN_H, IN_W, 3), dtype=np.uint8)
        for j in range(3):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            ry, rx = rng.uniform(0.05, 0.25) * h, rng.uniform(0.05, 0.25) * w
            vy, vx = rng.uniform(-10, 10, 2)
            segs = []
            for i in range(t):
                mask = ((yy - cy - vy * i) / ry) ** 2 + ((xx - cx - vx * i) / rx) ** 2 < 1
                start = time.perf_counter()
                segs.append(rle.encode(mask))
                encode_s += time.perf_counter() - start
            annotations.append({"id": 3 * vid + j, "video_id": vid, "category_id": 1,
                                "segmentations": segs, "iscrowd": 0})
    n_masks = 3 * sum(lengths)
    print(f"eval set {name}: {n_masks} ground-truth masks, RLE encoding "
          f"{encode_s * 1e3 / n_masks:.2f} ms a mask (host)")
    root.mkdir(parents=True, exist_ok=True)
    path = root / "valid.json"
    path.write_text(json.dumps({"videos": videos, "annotations": annotations,
                                "categories": [{"id": 1, "name": "fg"}]}))
    ytvis.register_ytvis(name, str(path), str(root), class_agnostic=class_agnostic)
    return frames


def spread_queries(predictor, clip) -> tuple[float, int]:
    """Two changes to the seeded weights, so that NMS keeps tens of tracks a
    video, as with a trained model, and both the keep-set check and the
    finalize leg (the survivors' readback and RLE) carry them:
      * the mean mask feature of `clip` taken off the mask projection's
        bias, so that the masks are not all of one sign;
      * the decoder's residual branches (both attentions' output projections
        and the FFN's second linear, every round) scaled down: at the seeded
        init every query converges on one output over the 9 rounds, so the
        50 predictions share one mask and NMS keeps 1 or 2, while at scale 0
        the queries stay apart and NMS keeps all 50. The scale is bisected
        until NMS keeps about TRACKS of the 50 on `clip`.
    The masks stay speckled, not objects: random weights see no object in
    random frames. Returns (scale, tracks kept on `clip`)."""
    model = predictor.model
    feats = []
    hook = model.pixel_decoder.mask_features.register_forward_hook(
        lambda mod, args, out: feats.append(out.mean(dim=(0, 2, 3))))
    try:
        predictor.forward(clip)
    finally:
        hook.remove()
    branches = [w for mods in model.predictor.layers for w in (
        mods["cross_attn"].out_proj_weight, mods["self_attn"].out_proj_weight,
        mods["ffn"].linear2.weight)]
    seeded = [w.detach().clone() for w in branches]

    def kept(scale: float) -> int:
        with torch.no_grad():
            for w, w0 in zip(branches, seeded):
                w.copy_(w0 * scale)
        out, size = predictor.forward(clip)
        return int(predictor.postprocess(out, size, size)["keep"].sum())

    with torch.no_grad():
        model.pixel_decoder.mask_features.bias.sub_(feats[0])
    lo, hi = 0.0, 1.0
    for _ in range(10):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if kept(mid) > TRACKS else (lo, mid)
    return hi, kept(hi)


def run_eval(predictor, frames, out_dir: Path, counters=None, crop=True):
    """evaluate_dataset over EVAL_DATASET with the frames injected; records
    each video's keep-set and labels (device tensors, no sync) and, with
    `counters`, its kernel launches; crop=False forces the whole-mask
    readback. Returns (metrics, results, per video [(keep, labels)], per
    video launches)."""
    from s2d_tpu_torch.evaluation.evaluator import evaluate_dataset

    own = predictor.postprocess
    taped, per_video = [], []
    last = read_counts(counters) if counters else None

    def postprocess(*args, **kwargs):
        nonlocal last
        post = own(*args, **kwargs)
        taped.append((post["keep"], post["labels"]))
        if counters:
            now = read_counts(counters)
            per_video.append({k: now[k] - last[k] for k in now})
            last = now
        return post

    predictor.postprocess = postprocess
    try:
        metrics = evaluate_dataset(predictor, EVAL_DATASET, output_dir=str(out_dir),
                                   mapper=lambda record: {"image": frames[record["video_id"]]},
                                   **({} if crop else {"crop_masks": False}))
    finally:
        del predictor.postprocess
    results = json.loads((out_dir / "results.json").read_text())
    return metrics, results, taped, per_video


def eval_path(dev):
    """The --eval-only path at full width on the kernels, then the same
    videos on the plain path. Returns the kernels' launches."""
    from s2d_tpu_torch.config import from_s2d_config, load_config_tree
    from s2d_tpu_torch.data import rle
    from s2d_tpu_torch.demo_video import VideoPredictor
    from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, nms

    root = Path("build") / "chip_smoke_eval"
    frames = write_eval_set(root, np.random.RandomState(SEED + 2))
    cfg = from_s2d_config(load_config_tree(EVAL_CONFIG))
    predictor = VideoPredictor(cfg, seed=SEED, device=dev)
    scale, tracks = spread_queries(predictor, frames[1])
    print(f"eval weights: decoder residual branches x{scale:.4f}, mask features centred: "
          f"NMS keeps {tracks} of {cfg.num_predictions} on video 1 at 360x640")
    counters = {"k1_msda": (ms_deform_attn_cuda, "LAUNCHES"),
                "k3_flash": (masked_attention_cuda, "LAUNCHES"), "k4_nms": (nms, "LAUNCHES")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    transport = None if PARENT else reset_transport()
    metrics, results, taped, per_video = run_eval(predictor, frames, root / "kernel", counters)
    launches = read_counts(counters)
    for i, grew in enumerate(per_video):
        if grew != PER_CLIP:
            raise AssertionError(f"eval video {i + 1}: launches {grew}, expected {PER_CLIP}")
    missing = [k for k in METRIC_KEYS if k not in metrics]
    if missing:
        raise AssertionError(f"eval: metrics lack {missing}")
    kept = [int(k.sum()) for k, _ in taped]
    if len(results) != sum(kept):
        raise AssertionError(f"eval: {len(results)} results for {kept} kept tracks")
    for r in results:
        segs = r["segmentations"]
        if len(segs) != EVAL_LENGTHS[r["video_id"] - 1]:
            raise AssertionError(f"eval: video {r['video_id']} entry with {len(segs)} frames")
        if any(rle.decode(seg).shape != OUT_SIZE for seg in segs[:1] + segs[-1:]):
            raise AssertionError(f"eval: video {r['video_id']} segmentation not at {OUT_SIZE}")
    frames_total = sum(EVAL_LENGTHS)
    print(f"eval path: {len(EVAL_LENGTHS)} videos, {frames_total} frames (T = {EVAL_LENGTHS}), "
          f"{metrics['eval_seconds']:.3f} s, {metrics['frames_per_second']:.2f} frames/s; kept "
          f"{kept} of {cfg.num_predictions}; launches per video {per_video}; results.json "
          f"{len(results)} entries")
    print("  " + ", ".join(f"{k} {metrics[k]:.4f}" for k in METRIC_KEYS))
    print("  stage seconds: " + ", ".join(f"{k[len('stage_s/'):]} {v}" for k, v in metrics.items()
                                          if k.startswith("stage_s/"))
          + f"; rle_encode {metrics['stage_s/rle_encode'] / metrics['eval_seconds']:.3f} of the wall")
    if transport is not None:
        print(f"  readback: {transport_line(transport)}")
        rows_metrics, _, _, _ = run_eval(predictor, frames, root / "rows", crop=False)
        same = (root / "kernel" / "results.json").read_bytes() == (
            root / "rows" / "results.json").read_bytes()
        print(f"  whole-mask read forced: {rows_metrics['frames_per_second']:.2f} frames/s, "
              f"rle_encode {rows_metrics['stage_s/rle_encode']} s, readback_masks "
              f"{rows_metrics['stage_s/readback_masks']} s; results.json "
              f"{'byte-identical' if same else 'DIFFERS'} to the crop run's")
        if not same:
            raise AssertionError("eval: results.json of the whole-mask read differs")
    counts = [len(seg["counts"]) for r in results for seg in r["segmentations"]]
    print(f"  results.json: {len(counts)} frame masks, RLE string of {np.mean(counts):.0f} "
          f"characters a mask on average ({min(counts)} to {max(counts)})")
    if min(kept) < MIN_TRACKS:
        raise AssertionError(f"eval: kept {kept} tracks, fewer than {MIN_TRACKS} in a video")

    plain = VideoPredictor(cfg, seed=None, device=dev, kernels=False)
    plain.model.load_state_dict(predictor.model.state_dict())
    del predictor
    before = read_counts(counters)
    _, plain_results, plain_taped, _ = run_eval(plain, frames, root / "plain")
    if read_counts(counters) != before:
        raise AssertionError("the plain eval path launched a kernel")
    failures = []
    for vid, ((keep, labels), (pkeep, plabels)) in enumerate(zip(taped, plain_taped), start=1):
        if not (torch.equal(keep, pkeep) and torch.equal(labels, plabels)):
            failures.append(f"video {vid}: keep-set or labels differ ({int(keep.sum())} vs "
                            f"{int(pkeep.sum())} kept)")
    differ = pixels = 0
    for r, q in zip(results, plain_results):
        for a, b in zip(r["segmentations"], q["segmentations"]):
            differ += int((rle.decode(a) != rle.decode(b)).sum())
            pixels += OUT_SIZE[0] * OUT_SIZE[1]
    print(f"plain vs kernel eval path: keep-sets and labels "
          f"{'identical' if not failures else 'DIFFER'} on {len(taped)} videos; mask pixels "
          f"differing {differ / max(pixels, 1):.3e} ({differ} of {pixels})")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def reset_transport() -> dict:
    """Zero the evaluator's readback counts (`inference.TRANSPORT`) and
    return them."""
    from s2d_tpu_torch.evaluation import inference

    for k in inference.TRANSPORT:
        inference.TRANSPORT[k] = 0
    return inference.TRANSPORT


def transport_line(tr: dict) -> str:
    return (f"{tr['crop_tracks']} survivors as bbox crops, {tr['row_tracks']} whole; "
            f"{tr['read_bytes']} of {tr['canvas_bytes']} canvas bytes read "
            f"({tr['read_bytes'] / max(tr['canvas_bytes'], 1):.4f})")


def ellipse_video(dev, rng, q=CROP_TRACKS, t=CROP_T, hw=OUT_SIZE):
    """Mask logits (q, t, h/4, w/4) of q ellipses drifting over t frames,
    4 (1 - r^2) clipped to [-8, 8], made on `dev`, descending class logits
    (q, 2), and each ellipse's bounding box over the frames in output
    pixels (y0, x0, y1, x1). Every fifth ellipse repeats the one before it
    a pixel off (NMS drops it)."""
    h4, w4 = hw[0] // 4, hw[1] // 4
    cy, cx = rng.uniform(0.1, 0.9, q) * h4, rng.uniform(0.1, 0.9, q) * w4
    ry, rx = rng.uniform(0.02, 0.14, q) * h4, rng.uniform(0.0125, 0.125, q) * w4
    vy, vx = rng.uniform(-0.008, 0.008, q) * h4, rng.uniform(-0.005, 0.005, q) * w4
    for i in range(4, q, 5):
        cy[i], cx[i], ry[i], rx[i], vy[i], vx[i] = cy[i - 1] + 0.25, cx[i - 1], ry[i - 1], \
            rx[i - 1], vy[i - 1], vx[i - 1]
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)[:, None, None, None]  # noqa: E731
    ti = torch.arange(t, device=dev, dtype=torch.float32)[None, :, None, None]
    yy = torch.arange(h4, device=dev, dtype=torch.float32)[None, None, :, None]
    xx = torch.arange(w4, device=dev, dtype=torch.float32)[None, None, None, :]
    r2 = ((yy - f(cy) - f(vy) * ti) / f(ry)) ** 2 + ((xx - f(cx) - f(vx) * ti) / f(rx)) ** 2
    masks = (4 * (1 - r2)).clamp(-8, 8)
    logits = torch.stack([torch.linspace(4, 0.5, q, device=dev), torch.zeros(q, device=dev)], -1)
    ends = [cy + vy * (t - 1), cx + vx * (t - 1)]
    boxes = 4 * np.stack([np.minimum(cy, ends[0]) - ry, np.minimum(cx, ends[1]) - rx,
                          np.maximum(cy, ends[0]) + ry, np.maximum(cx, ends[1]) + rx], -1)
    return logits, masks, boxes


def crop_check(dev, hw=OUT_SIZE, t=CROP_T) -> None:
    """Phase 10's synthetic video (`ellipse_video`) through
    `postprocess_video` (K4) and both readbacks on the card: the crop path
    taken for every survivor, each box equal to its track's extent in the
    whole masks and inside its ellipse's bounding box (8 px of resize
    slack), and results.json entries encoded from the crops equal, byte
    for byte, to those of the whole masks."""
    from s2d_tpu_torch.evaluation import evaluator, inference

    logits, masks, ellipse_boxes = ellipse_video(dev, np.random.RandomState(SEED + 6), t=t, hw=hw)
    post = inference.postprocess_video(logits, masks, num_predictions=CROP_TRACKS, num_classes=1,
                                       image_size=hw, output_size=hw)
    scores, labels, keep, boxes = inference.read_small_bundle(post)
    n = int(keep.sum())
    tr = reset_transport()
    entries, ms = {}, {}
    for crop in (True, False):
        torch.cuda.synchronize()
        start = time.perf_counter()
        handle = inference.start_kept_masks_read(post, keep, boxes if crop else None)
        got = inference.finish_kept_masks_read(handle, as_window=True)
        read = time.perf_counter()
        entries[crop] = json.dumps(evaluator.predictions_to_results(
            1, {"scores": scores[keep], "labels": labels[keep], "masks": got}))
        ms[crop] = ((read - start) * 1e3, (time.perf_counter() - read) * 1e3)
        if crop:
            crops = (tr["crop_tracks"], tr["read_bytes"], tr["canvas_bytes"])
            if not isinstance(got, inference.WindowMasks) or tr["crop_tracks"] != n:
                raise AssertionError(f"crop check: the crop path was not taken ({transport_line(tr)})")
            window = got.crops.shape[2:]
        else:
            whole = got
    extent = whole.any(axis=1)
    for i, k in enumerate(np.flatnonzero(keep)):
        ys, xs = np.nonzero(extent[i])
        want = (ys.min(), xs.min(), np.ptp(ys) + 1, np.ptp(xs) + 1) if ys.size else (0, 0, 1, 1)
        y0, x0, y1, x1 = ellipse_boxes[k]  # prediction k is query k (scores fall with k)
        if tuple(boxes[i]) != want or not (
                y0 - 8 <= want[0] and x0 - 8 <= want[1] and want[0] + want[2] <= y1 + 8
                and want[1] + want[3] <= x1 + 8):
            raise AssertionError(f"crop check: track {k} box {tuple(boxes[i])}, extent {want}, "
                                 f"ellipse {(y0, x0, y1, x1)}")
    if entries[True] != entries[False]:
        raise AssertionError("crop check: the entries encoded from the crops differ")
    print(f"crop check: {n} of {CROP_TRACKS} ellipse tracks kept, T = {t} at {hw}; "
          f"crops {crops[0]} tracks in a {window[0]}x{window[1]} window, {crops[1]} of "
          f"{crops[2]} canvas bytes ({crops[1] / crops[2]:.4f}); boxes equal the extents; "
          f"entries identical to the whole masks'; readback + encode ms: crops {ms[True][0]:.1f} "
          f"+ {ms[True][1]:.1f}, whole {ms[False][0]:.1f} + {ms[False][1]:.1f}")


def checkpoint_path(dev):
    """A full-width reference-layout student/teacher .pth through
    `VideoPredictor`'s loader on the card, EVAL_STUDENT on and off. The
    networks are the torch oracle of tests/torch_oracle.py (torch only) at
    the inference config's widths, from two seeds; the reference for each
    is the oracle's own forward of that network on the same clip, in f32."""
    import dataclasses

    from s2d_tpu_torch.config import VideoConfig
    from s2d_tpu_torch.demo_video import VideoPredictor
    from s2d_tpu_torch.models.meta_arch import preprocess_clip

    try:
        from s2d_tpu_torch.checkpoint import torch_import
    except ImportError:
        if PARENT:
            print("checkpoint path: this checkout has no reference loader")
            return
        raise
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_oracle import TorchVideoMaskFormer

    cfg = VideoConfig(amp=False)
    nets = {}
    for which, seed in (("student", SEED + 11), ("teacher", SEED + 12)):
        torch.manual_seed(seed)
        nets[which] = TorchVideoMaskFormer(
            hidden_dim=cfg.hidden_dim, mask_dim=cfg.mask_dim, num_queries=cfg.num_queries,
            nheads=cfg.nheads, dim_ff=cfg.dim_feedforward, dec_layers=cfg.dec_layers - 1,
            enc_layers=cfg.enc_layers).eval()
    kd = {f"{who}.{0 if k.startswith('backbone.') else 1}.{k.split('.', 1)[1]}": v
          for who, net in nets.items() for k, v in net.state_dict().items()}
    path = Path("build") / "chip_smoke_ckpt" / "kd.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": kd, "iteration": 0}, path)
    clip = np.random.RandomState(SEED + 3).randint(0, 256, (T, IN_H, IN_W, 3), dtype=np.uint8)
    images, _ = preprocess_clip(clip, cfg.pixel_mean, cfg.pixel_std, cfg.size_divisibility, dev)
    oracle = {}
    for which, net in nets.items():
        # the device as the default one: the oracle makes some of its
        # constants with factory calls that name no device
        with torch.no_grad(), dev:
            out = net.to(dev)(images[0].permute(0, 3, 1, 2).contiguous(), T)
        oracle[which] = {k: out[k] for k in ("pred_logits", "pred_masks")}
        net.cpu()
    print(f"checkpoint: {path} ({path.stat().st_size / 2**20:.0f} MiB), student and teacher "
          "at full width")
    for eval_student in (True, False):
        which, other = ("student", "teacher") if eval_student else ("teacher", "student")
        start = time.perf_counter()
        predictor = VideoPredictor(dataclasses.replace(cfg, eval_student=eval_student),
                                   weights=str(path), device=dev)
        load_s = time.perf_counter() - start
        want = torch_import.convert_reference_network(
            {k: v.numpy() for k, v in nets[which].state_dict().items()})
        got = predictor.model.state_dict()
        if predictor.loaded != "reference" or set(got) != set(want) or not all(
                torch.equal(got[k].cpu(), want[k]) for k in want):
            raise AssertionError(f"EVAL_STUDENT={eval_student}: the model does not hold the "
                                 f"{which}'s weights")
        out, _ = predictor.forward(clip)
        torch.cuda.synchronize()
        errs = {}
        for key in ("pred_logits", "pred_masks"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"EVAL_STUDENT={eval_student}: {key} not finite")
            errs[key] = {n: (out[key] - oracle[n][key]).abs().max().item() for n in nets}
        print(f"  EVAL_STUDENT={eval_student}: loaded the {which} in {load_s:.2f} s; max |port - "
              "oracle| " + ", ".join(f"{key} {e[which]:.3e} (the {other}'s oracle {e[other]:.3e})"
                                     for key, e in errs.items()))
        for key, e in errs.items():
            if not e[which] < 0.25 * e[other]:
                raise AssertionError(f"EVAL_STUDENT={eval_student}: {key} not nearer the "
                                     f"{which}'s oracle than the {other}'s")
        del predictor, out


def write_train_set(root: Path, name: str, rng, frame_hw=OUT_SIZE) -> dict:
    """A YTVIS train set of TRAIN_SET_VIDEOS videos of TRAIN_SET_LENGTH
    frames at `frame_hw`, registered as `name`, each with 3-8 drifting
    ellipses annotated sparsely, keymask-style: an instance has a mask on a
    window of frames and None elsewhere. The last video's windows are 1-2
    frames long, so no 3 consecutive frames of it are annotated and its
    clips take the sparse frame selection; the others take the dense one.
    Returns the uint8 frames per video id (no image file is written)."""
    from s2d_tpu_torch.data import rle, ytvis

    h, w = frame_hw
    yy, xx = np.mgrid[:h, :w]
    videos, annotations, frames = [], [], {}
    n = TRAIN_SET_LENGTH
    for vid in range(1, TRAIN_SET_VIDEOS + 1):
        videos.append({"id": vid, "height": h, "width": w, "length": n,
                       "file_names": [f"v{vid}/{i:05d}.jpg" for i in range(n)]})
        frames[vid] = rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
        longest = 2 if vid == TRAIN_SET_VIDEOS else n
        for j in range(rng.randint(TRAIN_SET_INSTANCES[0], TRAIN_SET_INSTANCES[1] + 1)):
            span = rng.randint(1, longest + 1)
            first = rng.randint(0, n - span + 1)
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            ry, rx = rng.uniform(0.05, 0.25) * h, rng.uniform(0.05, 0.25) * w
            vy, vx = rng.uniform(-10, 10, 2)
            segs = [rle.encode(((yy - cy - vy * i) / ry) ** 2 + ((xx - cx - vx * i) / rx) ** 2 < 1)
                    if first <= i < first + span else None for i in range(n)]
            annotations.append({"id": 100 * vid + j, "video_id": vid, "category_id": 1,
                                "segmentations": segs, "iscrowd": 0})
    root.mkdir(parents=True, exist_ok=True)
    path = root / "train.json"
    path.write_text(json.dumps({"videos": videos, "annotations": annotations,
                                "categories": [{"id": 1, "name": "fg"}]}))
    ytvis.register_ytvis(name, str(path), str(root), class_agnostic=True)
    print(f"train set {name}: {len(videos)} videos of {n} frames at {h}x{w}, "
          f"{len(annotations)} sparsely annotated instances")
    return frames


def train_cli_path(dev, class_scale, opts=(), frame_hw=OUT_SIZE) -> dict:
    """The train CLI, `s2d_tpu_torch.train_net_video.main`, on the card: the
    KD config with SOLVER.MAX_ITER 4, CHECKPOINT_PERIOD 2, TEST.EVAL_PERIOD 4
    and OUTPUT_DIR under build/ (and `opts`, which only a rehearsal off the
    card passes), over a synthetic train set (`write_train_set`) and test
    set registered under the config's DATASETS names, with the frames handed
    in through `mapper=` (the config's ClipMapper with a frame reader) and
    `eval_mapper=`. It starts from `new_train_state` saved by the port's
    CheckpointWriter as step 0 and enters through --resume, then resumes to
    MAX_ITER 6. Checks: metrics.json's train lines for iterations 0-5 in
    order with finite losses, grad_finite 1, data_time and time; the
    K1/K2/K5 launches of every step (`expected_launches`); the evals at
    steps 4 and 6 (the end of a run evaluates too; K1, K3, K4 launches per
    video, inference_<step>/results.json, the AP keys); checkpoints at 2, 4
    and 6; each run's state as --resume restored it equal, bit for bit, to
    the checkpoint it resumed from. The loop runs as shipped: the launches
    are counted around each step without a synchronize, the restored state
    is copied out before the loop starts, and the step time and data-time
    share are the loop's own (`time`, `data_time` of metrics.json). Returns
    the launches of both runs."""
    from s2d_tpu_torch import train_net_video
    from s2d_tpu_torch.checkpoint import io as ckpt_io
    from s2d_tpu_torch.checkpoint.io import STATE_FILE, CheckpointWriter
    from s2d_tpu_torch.config import load_config_tree
    from s2d_tpu_torch.data.mapper import ClipMapper, MapperConfig
    from s2d_tpu_torch.evaluation import evaluator
    from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, nms
    from s2d_tpu_torch.train import trainer

    root = Path("build") / "chip_smoke_train_cli"
    shutil.rmtree(root, ignore_errors=True)
    out = root / "out"
    cfg = load_config_tree(KD_CONFIG, opts)
    rng = np.random.RandomState(SEED + 4)
    start = time.perf_counter()
    frames = write_train_set(root / "train", cfg.datasets.train[0], rng, frame_hw)
    eval_frames = write_eval_set(root / "test", rng, CLI_EVAL_LENGTHS, cfg.datasets.test[0],
                                 class_agnostic=False)
    print(f"train CLI data: {time.perf_counter() - start:.1f} s (host)")
    state = new_train_state(cfg, dev, class_scale=class_scale)
    start = time.perf_counter()
    with CheckpointWriter(str(out / "checkpoints")) as writer:
        writer.save(0, state)
    print(f"train CLI: the starting state saved as step 0 in {time.perf_counter() - start:.1f} s")
    del state
    torch.cuda.empty_cache()

    mapper = ClipMapper(MapperConfig.from_config(cfg), seed=max(cfg.seed, 0),
                        read_frames=lambda record, idx: [frames[record["video_id"]][i] for i in idx])
    counters = {**train_counters(), "k3_flash": (masked_attention_cuda, "LAUNCHES"),
                "k4_nms": (nms, "LAUNCHES")}
    steps, starts, evals = [], [], []
    own_make, own_eval = trainer.make_train_step, evaluator.evaluate_dataset
    own_restore = ckpt_io.restore_checkpoint

    def make_train_step(cfg_, kernels=True, group=None):
        step_fn = own_make(cfg_, kernels, group)

        def step(state, *args, **kwargs):
            before = read_counts(counters)
            result = step_fn(state, *args, **kwargs)
            grew = {k: v - before[k] for k, v in read_counts(counters).items()}
            steps.append((grew, tuple(args[0].shape)))
            return result
        return step

    def restore_checkpoint(ckpt_dir, state, step=None):
        restored = own_restore(ckpt_dir, state, step)
        starts.append({k: v.to("cpu", copy=True) if torch.is_tensor(v) else v
                       for k, v in flat_state(state.state_dict()).items()})
        return restored

    def evaluate_dataset(*args, **kwargs):
        before = read_counts(counters)
        metrics = own_eval(*args, **kwargs)
        evals.append({k: v - before[k] for k, v in read_counts(counters).items()})
        return metrics

    base = ["--device", dev.type, "--config-file", KD_CONFIG, *opts, "SOLVER.CHECKPOINT_PERIOD", "2",
            "TEST.EVAL_PERIOD", "4", "OUTPUT_DIR", str(out)]
    runs = [["--resume", *base, "SOLVER.MAX_ITER", str(n)] for n in CLI_ITERS]
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.make_train_step, evaluator.evaluate_dataset = make_train_step, evaluate_dataset
    ckpt_io.restore_checkpoint = restore_checkpoint
    walls = []
    try:
        for argv in runs:
            t0 = time.perf_counter()
            rc = train_net_video.main(argv, mapper=mapper,
                                      eval_mapper=lambda record: {"image": eval_frames[record["video_id"]]})
            walls.append(time.perf_counter() - t0)
            if rc != 0:
                raise AssertionError(f"train CLI {argv}: exit {rc}")
    finally:
        trainer.make_train_step, evaluator.evaluate_dataset = own_make, own_eval
        ckpt_io.restore_checkpoint = own_restore
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated(dev)

    lines = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    train = [line for line in lines if "total_loss" in line]
    if [line["iteration"] for line in train] != list(range(CLI_ITERS[-1])):
        raise AssertionError(f"train CLI: metrics.json iterations {[x['iteration'] for x in train]}")
    for line in train:
        bad = [k for k in ("total_loss", "loss_mask", "kd_loss_mask", "data_time", "time")
               if not np.isfinite(line[k])]
        if bad or line["grad_finite"] != 1.0:
            raise AssertionError(f"train CLI iteration {line['iteration']}: non-finite {bad}, "
                                 f"grad_finite {line['grad_finite']}")
    expected = expected_launches(cfg)
    for i, (grew, _) in enumerate(steps):
        train_part = {k: grew[k] for k in expected}
        if train_part != expected or grew["k3_flash"] or grew["k4_nms"]:
            raise AssertionError(f"train CLI step {i}: launches {grew}, expected {expected}")
    if len(steps) != CLI_ITERS[-1]:
        raise AssertionError(f"train CLI: {len(steps)} steps, expected {CLI_ITERS[-1]}")
    # an eval every EVAL_PERIOD steps and at the end: steps 4 and 6
    per_eval = {k: len(CLI_EVAL_LENGTHS) * PER_CLIP.get(k, 0) for k in counters}
    if evals != [per_eval] * 2:
        raise AssertionError(f"train CLI eval launches {evals}, expected two evals of {per_eval}")
    results = {n: json.loads((out / f"inference_{n}" / "results.json").read_text())
               for n in (CLI_ITERS[0], CLI_ITERS[-1])}
    eval_lines = [line for line in lines if "total_loss" not in line]
    ap_keys = [f"{cfg.datasets.test[0]}/{k}" for k in METRIC_KEYS]
    if [line["iteration"] for line in eval_lines] != [CLI_ITERS[0] - 1, CLI_ITERS[-1] - 1] or any(
            k not in line for line in eval_lines for k in ap_keys):
        raise AssertionError(f"train CLI: eval lines {eval_lines}")
    saved = sorted(int(p.name) for p in (out / "checkpoints").iterdir() if p.name.isdigit())
    if saved != [0, 2, 4, 6]:
        raise AssertionError(f"train CLI: checkpoints at {saved}")
    for resumed_from, got in zip((0, CLI_ITERS[0]), starts, strict=True):
        want = flat_state(torch.load(out / "checkpoints" / str(resumed_from) / STATE_FILE,
                                     map_location="cpu", weights_only=True))
        differ = [k for k in want if not (torch.equal(got[k], want[k]) if torch.is_tensor(want[k])
                                          else got[k] == want[k])]
        if set(got) != set(want) or differ:
            raise AssertionError(f"train CLI: the state restored from step {resumed_from} "
                                 f"differs from its checkpoint in {differ[:5]}")
    step_ms = [x["time"] * 1e3 for x in train]
    later = [i for i in range(len(train)) if i not in (0, CLI_ITERS[0])]  # not a run's first
    steady = [step_ms[i] for i in later]
    data_s, total_s = sum(x["data_time"] for x in train), sum(x["time"] for x in train)
    later_share = sum(train[i]["data_time"] for i in later) / sum(train[i]["time"] for i in later)
    data_times = ", ".join(f"{x['data_time']:.3f}" for x in train)
    print(f"train CLI path: {len(steps)} steps of B={steps[0][1][0]} clips of T={steps[0][1][1]} "
          f"(canvases {sorted({s[1][2:4] for s in steps})}), {np.mean(steady):.1f} ms a step after "
          f"each run's first (metrics.json time, the loop as shipped: steps "
          f"{', '.join(f'{ms:.1f}' for ms in step_ms)} ms), data-time share {later_share:.4f} "
          f"after each run's first step, {data_s / total_s:.4f} over all (data_time per step "
          f"{data_times} s), peak device memory "
          f"{peak / 2**30:.2f} GiB; runs {walls[0]:.1f} s and {walls[1]:.1f} s (wall)")
    print(f"  launches per step {steps[0][0]}; evals at steps {list(results)}: launches "
          f"{evals[0]} each, {[len(r) for r in results.values()]} results, "
          + ", ".join(f"{k} {eval_lines[0][f'{cfg.datasets.test[0]}/{k}']:.4f}" for k in METRIC_KEYS[:3]))
    print(f"  checkpoints {saved}; the state each run restored equals the checkpoint it "
          f"resumed from (steps 0 and {CLI_ITERS[0]}), bit for bit; metrics.json iterations "
          f"0-{CLI_ITERS[-1] - 1} finite, grad_finite 1")
    return launches


def train_options_path(dev, class_scale, opts=(), frame_hw=OUT_SIZE) -> dict:
    """Phase 14: the train CLI (`train_net_video.main`) with the KD step's
    options (OPTION_OPTS, and the loader's bit-packed targets) for
    OPTION_STEPS steps, over a synthetic train set (`write_train_set`), from
    `new_train_state` saved as step 0 and entered through --resume; no
    eval (TEST.EVAL_PERIOD 0). Checks each step's launches
    (`expected_launches`), that the targets arrive packed and the
    distillation view with them, metrics.json's finite losses and
    grad_finite; prints the step time and data-time share (metrics.json's,
    the loop as shipped), the peak memory and the distillation targets
    before and after NMS. Returns the launches."""
    from s2d_tpu_torch import train_net_video
    from s2d_tpu_torch.checkpoint.io import CheckpointWriter
    from s2d_tpu_torch.config import load_config_tree
    from s2d_tpu_torch.data.mapper import ClipMapper, MapperConfig
    from s2d_tpu_torch.ops import nms
    from s2d_tpu_torch.train import trainer

    started = time.perf_counter()
    root = Path("build") / "chip_smoke_train_options"
    shutil.rmtree(root, ignore_errors=True)
    out = root / "out"
    cfg = load_config_tree(KD_CONFIG, (*opts, *OPTION_OPTS))
    frames = write_train_set(root / "train", cfg.datasets.train[0], np.random.RandomState(SEED + 5),
                             frame_hw)
    state = new_train_state(cfg, dev, class_scale=class_scale)
    with CheckpointWriter(str(out / "checkpoints")) as writer:
        writer.save(0, state)
    del state
    torch.cuda.empty_cache()
    mapper = ClipMapper(MapperConfig.from_config(cfg), seed=max(cfg.seed, 0),
                        read_frames=lambda record, idx: [frames[record["video_id"]][i] for i in idx])
    if not mapper.cfg.disentangle:
        raise AssertionError("options: the mapper does not draw the distillation view")
    counters = {**train_counters(), "k4_nms": (nms, "LAUNCHES")}
    steps, validity = [], []
    own_make, own_nms = trainer.make_train_step, trainer.distillation_nms

    def make_train_step(cfg_, kernels=True, group=None):
        step_fn = own_make(cfg_, kernels, group)

        def step(state, images, masks, *args, **kwargs):
            before = read_counts(counters)
            result = step_fn(state, images, masks, *args, **kwargs)
            grew = {k: v - before[k] for k, v in read_counts(counters).items()}
            steps.append((grew, tuple(images.shape), masks.dtype,
                          sorted(k for k in kwargs if k.startswith("distill"))))
            return result
        return step

    def distillation_nms(masks, teacher_out, valid, *args, **kwargs):
        kept = own_nms(masks, teacher_out, valid, *args, **kwargs)
        validity.append((valid.sum(1).tolist(), kept.sum(1).tolist()))
        return kept

    argv = ["--resume", "--device", dev.type, "--config-file", KD_CONFIG, *opts, *OPTION_OPTS,
            "SOLVER.MAX_ITER", str(OPTION_STEPS), "SOLVER.CHECKPOINT_PERIOD", "1000",
            "TEST.EVAL_PERIOD", "0", "OUTPUT_DIR", str(out)]
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.make_train_step, trainer.distillation_nms = make_train_step, distillation_nms
    try:
        t0 = time.perf_counter()
        if train_net_video.main(argv, mapper=mapper) != 0:
            raise AssertionError("options: the train CLI failed")
        wall = time.perf_counter() - t0
    finally:
        trainer.make_train_step, trainer.distillation_nms = own_make, own_nms
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    lines = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    train = [line for line in lines if "total_loss" in line]
    if [line["iteration"] for line in train] != list(range(OPTION_STEPS)) or len(steps) != OPTION_STEPS:
        raise AssertionError(f"options: iterations {[x['iteration'] for x in train]}, "
                             f"{len(steps)} steps")
    for line in train:
        bad = [k for k in ("total_loss", "loss_mask", "kd_loss_mask", "kd_loss_dice", "time")
               if not np.isfinite(line[k])]
        if bad or line["grad_finite"] != 1.0:
            raise AssertionError(f"options iteration {line['iteration']}: non-finite {bad}, "
                                 f"grad_finite {line['grad_finite']}")
    clips = steps[0][1][0]
    expected = expected_launches(cfg, clips)
    for i, (grew, shape, dtype, kwargs) in enumerate(steps):
        if grew != expected:
            raise AssertionError(f"options step {i}: launches {grew}, expected {expected}")
        if dtype != torch.uint8 or kwargs != ["distill_affine", "distill_images"]:
            raise AssertionError(f"options step {i}: targets {dtype}, view {kwargs}")
    step_ms = [x["time"] * 1e3 for x in train]
    later = train[1:]
    share = sum(x["data_time"] for x in later) / sum(x["time"] for x in later)
    print(f"options path: {OPTION_STEPS} steps of B={clips} clips of T={steps[0][1][1]} "
          f"(canvases {sorted({x[1][2:4] for x in steps})}), {np.mean(step_ms[1:]):.1f} ms a step "
          f"after the first (metrics.json time: {', '.join(f'{ms:.1f}' for ms in step_ms)} ms), "
          f"data-time share {share:.4f} after the first, peak device memory "
          f"{peak / 2**30:.2f} GiB; the CLI {wall:.1f} s, the phase so far "
          f"{time.perf_counter() - started:.1f} s")
    print(f"  launches per step {steps[0][0]} (expected {expected}); targets packed (uint8), the "
          f"distillation view in each batch; distillation targets per clip before / after NMS "
          f"{validity}; kd_loss_mask " + ", ".join(f"{x['kd_loss_mask']:.4f}" for x in train))
    shutil.rmtree(root, ignore_errors=True)
    return launches


def compare_options_step(dev, class_scale) -> None:
    """One step with the options from phase 8's seeded state and batch (its
    distillation view the clips flipped left-right, an exact affine; its
    targets bit-packed) on the plain path against the kernel path, with
    the kernel step's hard decisions replayed (both students' attention
    masks, the distillation targets, their warp, the assignments): losses
    at rtol 1e-3 / atol 2e-3, the distillation NMS's validity (K4 against
    the plain loop, not replayed) identical."""
    from s2d_tpu_torch.config import load_config_tree
    from s2d_tpu_torch.losses import criterion
    from s2d_tpu_torch.ops import nms
    from s2d_tpu_torch.train import trainer

    cfg = load_config_tree(KD_CONFIG, OPTION_OPTS)
    images, masks, valid = train_batch(cfg, dev)
    b, t, h, w, _ = images.shape
    view = {"distill_images": images.flip(3).contiguous(),
            "distill_affine": torch.tensor([[-1.0, 0, w - 1], [0, 1, 0], [0, 0, 1]],
                                           device=dev).expand(b, t, 3, 3).contiguous()}
    packed = torch.from_numpy(np.packbits(masks.cpu().numpy(), axis=-1)).to(dev)
    counters = {**train_counters(), "k4_nms": (nms, "LAUNCHES")}
    tapes = [Tape("attention_mask"), Tape("attention_mask"), Tape("prepare_distillation_targets"),
             Tape("warp_masks_affine"), Tape("hungarian_assign")]
    what = ["teacher attention-mask", "student attention-mask", "distillation-target", "warp",
            "assignment"]

    def run(kernels, tape_fn):
        state = new_train_state(cfg, dev, kernels, class_scale)
        owners = [state.teacher.predictor, state.student.predictor, trainer, trainer, criterion]
        for tape, owner in zip(tapes, owners):
            tape_fn(tape, owner)
        kept = Tape("distillation_nms").record(trainer)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        try:
            start = time.perf_counter()
            _, metrics = trainer.make_train_step(cfg, kernels=kernels)(
                state, images, packed, valid, generator=gen, **view)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
        finally:
            for tape in tapes + [kept]:
                tape.stop()
        return metrics, kept.values, ms

    before = read_counts(counters)
    mk, kept_k, ms_k = run(True, lambda tape, owner: tape.record(owner))
    grew = {k: v - before[k] for k, v in read_counts(counters).items()}
    if grew != expected_launches(cfg, b):
        raise AssertionError(f"options compare: kernel step launches {grew}")
    before = read_counts(counters)
    mp, kept_p, ms_p = run(False, lambda tape, owner: tape.replay(owner, True))
    if read_counts(counters) != before:
        raise AssertionError("options compare: the plain step launched a kernel")
    failures = []
    print(f"plain vs kernel options step (B={b}; {ms_k:.0f} / {ms_p:.0f} ms kernel / plain), "
          "replayed decisions; decisions that differ: "
          + ", ".join(f"{w_} {tape.differ}" for w_, tape in zip(what, tapes)))
    for key in mk:
        if key != "grad_finite" and check_close(key, mp[key], mk[key], 1e-3, 2e-3)[1] > 1.0:
            failures.append(f"{key} beyond rtol 1e-3 / atol 2e-3")
    same = len(kept_k) == len(kept_p) == 1 and torch.equal(kept_k[0], kept_p[0])
    print(f"  distillation NMS validity {'identical' if same else 'DIFFERS'} (K4 against the plain "
          f"loop): kept {kept_k[0].sum(1).tolist()} of {kept_k[0].shape[1]} queries a clip")
    if not same:
        failures.append("the distillation NMS validity differs")
    if failures:
        raise AssertionError("options compare: " + "; ".join(failures))


def flat_state(sd: dict) -> dict:
    """A TrainState.state_dict(), flattened to one dict of tensors and ints."""
    flat = {"step": sd["step"], "count": sd["optimizer"]["count"],
            "mini_step": sd["optimizer"]["mini_step"]}
    for net in ("student", "teacher"):
        flat.update({f"{net}.{k}": v for k, v in sd[net].items()})
    for key in ("mu", "nu", "acc"):
        for name, v in zip(sd["optimizer"]["names"], sd["optimizer"][key] or []):
            flat[f"optimizer.{key}.{name}"] = v
    return flat


def keymask_scene(rng, frame_hw=OUT_SIZE, length=KEYMASK_T):
    """One synthetic video for keymask discovery: (frames (T, H, W, 3) uint8,
    stage-1 mask PNGs (T, H, W, 3) uint8, the objects' boxes (T, objects, 4)
    as y0, x0, y1, x1 in the frame or empty, velocities (objects, 2) as dx,
    dy). Each object is a textured rectangle in its own horizontal band (no
    occlusion) moving at an integer velocity over a static textured
    background; the last one reaches the frame's right edge at frame T/3
    and leaves through it. Each object's mask is dropped from the PNGs on 2 frames,
    and each frame's PNG has a spurious blob under the objects."""
    h, w = frame_hw
    scale = w / OUT_SIZE[1]
    frames = np.repeat(rng.randint(0, 256, (1, h, w, 3), dtype=np.uint8), length, axis=0)
    pngs = np.zeros((length, h, w, 3), np.uint8)
    band = h // KEYMASK_OBJECTS
    boxes = np.zeros((length, KEYMASK_OBJECTS, 4), np.int64)
    velocities = np.zeros((KEYMASK_OBJECTS, 2), np.int64)
    yy, xx = np.mgrid[:h, :w]
    for fi in range(length):  # the blobs first: the objects are drawn over them
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), max(3, int(0.04 * h))
        pngs[fi][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = (255, 255, 255)
    for k in range(KEYMASK_OBJECTS):
        oh, ow = int(band * rng.uniform(0.55, 0.75)), int(w * rng.uniform(0.09, 0.14))
        texture = rng.randint(0, 256, (oh, ow, 3), dtype=np.uint8)
        color = np.asarray([(60 * k + 40) % 256, (90 * k + 200) % 256, 255 - 40 * k], np.uint8)
        if k == KEYMASK_OBJECTS - 1:  # the leaver: at the right edge by frame T/3
            vx, vy = max(1, round(10 * scale)), 0
            x0 = w - ow - vx * (length // 3)
        else:
            vx = int(rng.choice([-1, 1])) * max(1, round(rng.randint(3, 7) * scale))
            vy = int(rng.choice([-1, 0, 1])) * (band > oh + length + 4)
            x0 = rng.randint(0, w - ow - abs(vx) * length) + (abs(vx) * length if vx < 0 else 0)
        y0 = k * band + (band - oh) // 2 - vy * length // 2
        velocities[k] = vx, vy
        dropped = {(3 + 5 * k) % length, (13 + 7 * k) % length}
        for fi in range(length):
            ty, tx = y0 + vy * fi, x0 + vx * fi
            a, b = max(tx, 0), min(tx + ow, w)
            if a >= b:
                continue  # out of the frame
            frames[fi, ty:ty + oh, a:b] = texture[:, a - tx:b - tx]
            boxes[fi, k] = ty, a, ty + oh, b
            if fi not in dropped:
                pngs[fi, ty:ty + oh, a:b] = color
    return frames, pngs, boxes, velocities


def probe_known_motion(dev, frames, boxes, velocities) -> int:
    """Points of object 0's interior, seeded at the first and at the last
    frame, must follow its velocity exactly (the float32 sums a match
    makes, step by step). Returns the points tracked."""
    from s2d_tpu_torch.keymask import CorrelationTracker, grid_points_in_mask

    t, h, w = frames.shape[:3]
    tracker = CorrelationTracker(device=dev)
    step = velocities[0].astype(np.float32)
    total = 0
    for seed in (0, t - 1):
        y0, x0, y1, x1 = boxes[seed, 0]
        inner = np.zeros((h, w), bool)
        inner[y0 + 6:y1 - 6, x0 + 6:x1 - 6] = True  # the template's window on the object
        pts = grid_points_in_mask(inner, KEYMASK_GRID)
        tracks, vis = tracker.track(frames, pts, seed)
        want = np.repeat(pts[None], t, axis=0)
        for fi in range(seed + 1, t):
            want[fi] = want[fi - 1] + step
        for fi in range(seed - 1, -1, -1):
            want[fi] = want[fi + 1] + (-step)
        if not np.array_equal(tracks, want) or not (vis > 0.5).all():
            bad = np.argwhere((tracks != want).any(-1))
            raise AssertionError(f"keymask probe (seed frame {seed}): {len(bad)} point-frames "
                                 f"off the known motion {step.tolist()}, first {bad[:3].tolist()}; "
                                 f"min visibility {vis.min():.3f}")
        total += len(pts)
    if not total:
        raise AssertionError("keymask probe: no point in object 0's interior")
    return total


def object_coverage(annotation: dict, boxes, hw) -> np.ndarray:
    """Per object, the best share over the video's groups of the frames the
    object is in where the group's mask has IoU >= 0.5 with it."""
    from s2d_tpu_torch.data import rle

    h, w = hw
    groups = [[None if s is None else rle.decode(s) for s in a["segmentations"]]
              for a in annotation["annotations"]]
    best = np.zeros(boxes.shape[1])
    for k in range(boxes.shape[1]):
        present = [fi for fi in range(len(boxes)) if boxes[fi, k, 2] > boxes[fi, k, 0]]
        for masks in groups:
            hits = 0
            for fi in present:
                if masks[fi] is None:
                    continue
                y0, x0, y1, x1 = boxes[fi, k]
                inter = int(masks[fi][y0:y1, x0:x1].sum())
                union = int(masks[fi].sum()) + (y1 - y0) * (x1 - x0) - inter
                hits += inter >= 0.5 * union
            best[k] = max(best[k], hits / len(present))
    return best


def keymask_path(dev, frame_hw=OUT_SIZE, length=KEYMASK_T, cotracker_check=True) -> None:
    """Keymask discovery through its CLI, `s2d_tpu_torch.keymask_ident.main`,
    on a synthetic set (`keymask_scene`) written under build/ with the port's
    PNG codec and removed at the end; then the CoTracker over video 1's
    seeds. See phase 13 of the module doc. A rehearsal off the card passes
    a CPU `dev`, a smaller `frame_hw` and, to skip the CoTracker,
    cotracker_check=False."""
    started = time.perf_counter()
    root = Path("build") / "chip_smoke_keymask"
    shutil.rmtree(root, ignore_errors=True)
    try:
        _keymask_run(dev, root, frame_hw, length, cotracker_check)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"keymask phase: {time.perf_counter() - started:.1f} s")


def unsaturate(net) -> None:
    """Scales a random CoTracker's delta head by COTRACKER_DELTA_SCALE. At
    the seeded init its visibility logits run from ~12 to over 100 (each
    iteration adds a large delta), so every visibility is exactly 1 in
    float32 and a comparison of two runs would compare constants; scaled,
    the logits stay near 1 and the tracks within tens of pixels of the
    queries."""
    with torch.no_grad():
        net.delta_head.weight.mul_(COTRACKER_DELTA_SCALE)
        net.delta_head.bias.mul_(COTRACKER_DELTA_SCALE)


def _keymask_run(dev, root: Path, frame_hw, length, cotracker_check) -> None:
    from types import SimpleNamespace

    from s2d_tpu_torch import keymask_ident
    from s2d_tpu_torch.config import load_config_tree
    from s2d_tpu_torch.data import ytvis
    from s2d_tpu_torch.data.mapper import ClipMapper, MapperConfig
    from s2d_tpu_torch.data.png import read_png, write_png
    from s2d_tpu_torch.keymask import grid_points_in_mask
    from s2d_tpu_torch.keymask.cotracker import build_cotracker

    start = time.perf_counter()
    rng = np.random.RandomState(SEED + 6)
    scenes = {}
    for v in range(KEYMASK_VIDEOS):
        name = f"video{v}"
        frames, pngs, boxes, velocities = keymask_scene(rng, frame_hw, length)
        for sub, images in (("frames", frames), ("masks", pngs)):
            (root / sub / name).mkdir(parents=True)
            for fi, image in enumerate(images):
                write_png(str(root / sub / name / f"{fi:05d}.png"), image)
        scenes[name] = (frames, boxes, velocities)
    print(f"keymask data: {KEYMASK_VIDEOS} videos of {length} frames at {frame_hw[0]}x"
          f"{frame_hw[1]}, {KEYMASK_OBJECTS} objects a video, written as PNG in "
          f"{time.perf_counter() - start:.1f} s (host)")

    name0 = "video0"
    start = time.perf_counter()
    probed = probe_known_motion(dev, *scenes[name0])
    print(f"keymask probe: {probed} points of {name0}'s object 0 (velocity "
          f"{scenes[name0][2][0].tolist()}) tracked exactly from the first and the last frame "
          f"in {time.perf_counter() - start:.2f} s")

    # the CLI as shipped: it prints each video's stage seconds and its
    # tracker's point-frames and seconds
    out = root / "out"
    argv = ["--frames-root", str(root / "frames"), "--masks-root", str(root / "masks"),
            "--output-root", str(out), "--grid-size", str(KEYMASK_GRID), "--merge",
            *(["--device", "cpu"] if dev.type == "cpu" else [])]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = keymask_ident.main(argv)
    cli_s = time.perf_counter() - start
    text = log.getvalue()
    print(text, end="")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = re.search(r"keymask_ident: (\d+) ok, (\d+) failed", text)
    if rc != 0 or summary is None or summary.groups() != (str(KEYMASK_VIDEOS), "0"):
        raise AssertionError(f"keymask CLI: exit {rc}, {summary and summary.group(0)}; "
                             f"{KEYMASK_VIDEOS} ok and none failed expected")
    stages = {m.group(1): {k: float(v) for k, v in re.findall(r"(\w+) ([\d.]+) s", m.group(2))}
              for m in re.finditer(r"^(video\d+): (.*)$", text, re.M)}
    point_frames, track_s, rate = (float(v) for v in re.search(
        r"^tracker: (\d+) point-frames in ([\d.]+) s, (\d+) point-frames/s", text, re.M).groups())
    print(f"keymask path: {cli_s:.2f} s for {KEYMASK_VIDEOS} videos through the CLI (reads "
          f"included); per video " + "; ".join(
              f"{n} " + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
              for n, st in stages.items()))
    print(f"  correlation tracker: {point_frames:.0f} point-frames in {track_s:.3f} s, "
          f"{rate:.0f} point-frames/s; peak device memory "
          f"{peak / 2**30:.2f} GiB")

    if dev.type == "cuda":  # the NCC step's device time at the visibility call's points
        from s2d_tpu_torch.keymask.tracker import PATCH, SEARCH, grey_video, match_step

        inputs = keymask_ident.load_video_inputs(
            SimpleNamespace(masks_root=str(root / "masks")), str(root / "frames" / name0))
        pts = np.concatenate([p for p in (grid_points_in_mask(m, KEYMASK_GRID)
                                          for masks in inputs["masks_per_frame"]
                                          for m in masks.values()) if len(p) >= 4])
        grey = grey_video(inputs["video"], dev)
        pts_d = torch.from_numpy(pts).to(dev)
        with torch.inference_mode():
            step_ms = cuda_ms(lambda: match_step(grey[0], grey[1], pts_d, PATCH, SEARCH))
        steps = 2 * (length - 1)
        print(f"  NCC match step at {len(pts)} points (the visibility stage of {name0}): "
              f"{step_ms:.3f} ms a transition (device), x {steps} transitions = "
              f"{steps * step_ms / 1e3:.3f} s of that stage's {stages[name0]['visibility']:.3f} s")

    # every planted object discovered
    covered = {}
    for name, (frames, boxes, _) in scenes.items():
        annotation = json.loads((out / "annotations" / f"{name}.json").read_text())
        covered[name] = object_coverage(annotation, boxes, frame_hw)
        print(f"  {name}: {len(annotation['annotations'])} groups; best coverage of each "
              f"object {', '.join(f'{c:.3f}' for c in covered[name])}")
    short = {n: c.tolist() for n, c in covered.items() if (c < KEYMASK_COVERAGE).any()}
    if short:
        raise AssertionError(f"keymask: objects covered on < {KEYMASK_COVERAGE:.0%} of their "
                             f"frames: {short}")

    # the discovered set, as the train CLI reads it
    dataset = out / "dataset.json"
    ytvis.register_ytvis("chip_smoke_keymasks", str(dataset), str(root / "frames"),
                         class_agnostic=True)
    records, _ = ytvis.get_dataset("chip_smoke_keymasks")
    record = max(records, key=lambda r: len(r["annotations"]))
    mapper = ClipMapper(MapperConfig.from_config(load_config_tree(KD_CONFIG)), seed=SEED,
                        read_frames=lambda r, idx: [read_png(r["file_names"][i]) for i in idx])
    sample = mapper(record)
    if not sample["valid"].any() or not np.isfinite(sample["image"]).all():
        raise AssertionError(f"keymask: the train mapper found no instance in {record['video_id']}")
    print(f"  dataset.json: {len(records)} videos, {sum(len(r['annotations']) for r in records)} "
          f"annotations; a train clip of frames {sample['selected_idx']}, image "
          f"{sample['image'].shape}, {int(sample['valid'].sum())} instances")

    if cotracker_check:
        name1 = f"video{KEYMASK_VIDEOS - 1}"
        inputs = keymask_ident.load_video_inputs(
            SimpleNamespace(masks_root=str(root / "masks")), str(root / "frames" / name1))
        seeds = [(fi, grid_points_in_mask(m, KEYMASK_GRID))
                 for fi, masks in enumerate(inputs["masks_per_frame"]) for m in masks.values()]
        seeds = [(fi, pts) for fi, pts in seeds if len(pts) >= 4]
        video = inputs["video"]
        tracker = build_cotracker(device=dev, seed=SEED)
        unsaturate(tracker.net)
        results = tracker.track_batch(video, [p for _, p in seeds], [f for f, _ in seeds])
        for (fi, pts), (tr, vi) in zip(seeds, results):
            if not (np.isfinite(tr).all() and ((vi >= 0) & (vi <= 1)).all()):
                raise AssertionError(f"cotracker: set of frame {fi}: non-finite tracks or "
                                     "visibility out of [0, 1]")
            np.testing.assert_allclose(tr[fi], pts, rtol=0, atol=1e-3)
        pick = len(seeds) // 2
        cpu_tracker = build_cotracker(device="cpu", seed=SEED)
        unsaturate(cpu_tracker.net)
        start = time.perf_counter()
        ref_tracks, ref_vis = cpu_tracker.track(video, seeds[pick][1], seeds[pick][0])
        cpu_s = time.perf_counter() - start
        got_tracks, got_vis = results[pick]
        track_err = float(np.abs(got_tracks - ref_tracks).max())
        vis_err = float(np.abs(got_vis - ref_vis).max())
        moved = float(np.abs(ref_tracks - seeds[pick][1][None]).max())
        inner = float(((ref_vis > 0.01) & (ref_vis < 0.99)).mean())
        print(f"  cotracker (full width, seeded random weights, delta head x "
              f"{COTRACKER_DELTA_SCALE}): {len(seeds)} sets of "
              f"{min(len(p) for _, p in seeds)}-{max(len(p) for _, p in seeds)} points over "
              f"{name1}, {tracker.point_frames} point-frames in {tracker.seconds:.3f} s (encode "
              f"included), {tracker.point_frames / tracker.seconds:.0f} point-frames/s, peak "
              f"device memory {tracker.peak_bytes / 2**30:.2f} GiB; set {pick} against the CPU "
              f"run ({cpu_s:.1f} s): tracks in x {ref_tracks[..., 0].min():.1f}.."
              f"{ref_tracks[..., 0].max():.1f}, y {ref_tracks[..., 1].min():.1f}.."
              f"{ref_tracks[..., 1].max():.1f} px, at most {moved:.1f} px from the queries, max "
              f"|diff| {track_err:.3e} px; visibility {inner:.1%} in (0.01, 0.99), range "
              f"{ref_vis.min():.3f}..{ref_vis.max():.3f}, max |diff| {vis_err:.3e}")
        if inner < COTRACKER_VIS_INNER:
            raise AssertionError(f"cotracker: {inner:.1%} of set {pick}'s visibilities in (0.01, "
                                 f"0.99), < {COTRACKER_VIS_INNER:.0%}: the comparison would "
                                 "compare saturated constants")
        np.testing.assert_allclose(got_tracks, ref_tracks, rtol=0, atol=COTRACKER_TRACK_ATOL)
        np.testing.assert_allclose(got_vis, ref_vis, rtol=0, atol=COTRACKER_VIS_ATOL)


def write_coco_set(root: Path, name: str, rng, n=CUTLER_IMAGES, hw=CUTLER_HW) -> None:
    """A COCO-format image set of `n` PNG images at `hw` (seeded noise under
    3-6 flat-coloured ellipses, each annotated as an RLE mask and its box),
    registered as `name`."""
    from s2d_tpu_torch.data import coco, rle
    from s2d_tpu_torch.data.png import write_png

    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    (root / "images").mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        img = rng.randint(0, 90, (h, w, 3), dtype=np.uint8)
        for _ in range(rng.randint(3, 7)):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            ry, rx = rng.uniform(0.06, 0.25) * h, rng.uniform(0.06, 0.25) * w
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
            img[m] = rng.randint(110, 256, 3)
            ys, xs = np.nonzero(m)
            seg = rle.encode(m)
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1, "category_id": 1, "iscrowd": 0,
                "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                         float(ys.max() - ys.min() + 1)],
                "area": int(m.sum()), "segmentation": {"size": [h, w], "counts": seg["counts"]}})
        write_png(str(root / "images" / f"{i:03d}.png"), img)
        images.append({"id": i + 1, "file_name": f"{i:03d}.png", "height": h, "width": w})
    path = root / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": annotations,
                                "categories": [{"id": 1, "name": "fg"}]}))
    coco.register_coco(name, str(path), str(root / "images"), class_agnostic=True)
    print(f"COCO set {name}: {n} PNG images at {h}x{w}, {len(annotations)} RLE instances")


def tta_launches(cfg, images: int) -> int:
    """K4 launches of the --tta pass over `images` images: per augmentation
    (each TEST.AUG.MIN_SIZES scale, and its flip) the boxes pass's RPN and
    cascade NMS (the mask pass, `mask_logits_at`, runs none), then one
    merge."""
    augs = len(cfg.test_aug_min_sizes) * (2 if cfg.test_aug_flip else 1)
    return images * (2 * augs + 1)


def box_nms_inputs(dev, n, rng):
    """Seeded boxes at N = n in a 512x512 canvas with score ties (scores
    rounded to 1/16): (score-sorted IoU (n, n), zero labels)."""
    from s2d_tpu_torch.ops.boxes import pairwise_iou

    xy = rng.uniform(0, 448, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 160, (n, 2))], 1).astype(np.float32)
    scores = np.round(rng.rand(n) * 16) / 16
    order = np.argsort(-scores, kind="stable")
    b = torch.from_numpy(boxes[order]).to(dev)
    return pairwise_iou(b, b).contiguous(), torch.zeros(n, dtype=torch.int64, device=dev)


def box_nms_check(dev, record, captured, rng) -> None:
    """K4 at the box NMS's shapes against its plain loop on the card, keep
    sets exactly: `captured`, the first input of each size that each CLI
    run gave K4 ({(run, N): (iou, labels, threshold)}: the RPN's N = 1000,
    the cascade's 256, the TTA merge's augmentations x DETECTIONS_PER_IMAGE),
    at its own threshold and at 0.5, and N = 1025, 1800 (the TTA merge at
    the CutLER defaults) and 4096 (the most) from seeded boxes with score
    ties, at 0.5 and 0.7; then K4's device time at each captured N and at
    1800 beside its plain loop's, its bound and the empty-launch floor, and
    its two paths' at N = 50, 128, 256 and 1000."""
    from s2d_tpu_torch.ops import nms

    cases = dict(captured)
    for n in CUTLER_NMS_SIZES:
        cases[("seeded", n)] = box_nms_inputs(dev, n, rng) + (0.7,)
    for (run, n), (iou, labels, thresh) in cases.items():
        for t in sorted({thresh, 0.5}):
            got = nms.greedy_mask_nms(iou, labels, t)
            ref = nms.greedy_mask_nms_plain(iou, labels, t)
            if not torch.equal(got, ref):
                raise AssertionError(f"K4 box NMS differs from plain at N={n} ({run}), threshold {t}")
    by_n = {}
    for run, n in cases:
        by_n.setdefault(n, []).append(run)
    print("  K4 box NMS vs plain: keep sets identical at N = " + "; ".join(
        f"{n} ({', '.join(runs)})" for n, runs in sorted(by_n.items())))
    timed = {}
    for (run, n), case in cases.items():  # the first run's input of each captured N, and 1800
        if n not in timed and (run != "seeded" or n == 1800):
            timed[n] = case
    times = {}
    for n, (iou, labels, thresh) in sorted(timed.items()):
        b = bound(nbytes(iou, labels) + n, n * (n - 1) / 2)
        times[n] = dict(ms=cuda_ms(lambda: nms.greedy_mask_nms(iou, labels, thresh)),
                        plain_ms=cuda_ms(lambda: nms.greedy_mask_nms_plain(iou, labels, thresh),
                                         iters=3),
                        kept=int(nms.greedy_mask_nms(iou, labels, thresh).sum()), **b)
    floor = record["k4_nms"].get("launch_floor_ms", float("nan"))
    record["k4_nms"]["box_nms"] = {str(n): t for n, t in times.items()}
    print("  K4 box NMS device ms: " + "; ".join(
        f"N={n} {t['ms']:.4f} (plain {t['plain_ms']:.2f}, kept {t['kept']}, bound "
        f"{t['bound_ms']:.2e} by {t['bound_by']})"
        for n, t in times.items())
          + f"; N=50 {record['k4_nms']['ms']:.4f}; empty launch {floor:.4f}")
    # the two paths at the sizes around nms.WALK_FROM and at the RPN's
    paths = {}
    walk_from = nms.WALK_FROM
    try:
        for n in (50, 128, 256, 1000):
            iou, labels = box_nms_inputs(dev, n, rng)
            for name, first_walked in (("one-block", n + 1), ("scratch", n)):
                nms.WALK_FROM = first_walked
                paths[(n, name)] = cuda_ms(lambda: nms.greedy_mask_nms(iou, labels, 0.7))
    finally:
        nms.WALK_FROM = walk_from
    print(f"  K4's paths (WALK_FROM = {walk_from}), device ms one-block / scratch: " + "; ".join(
        f"N={n} {paths[(n, 'one-block')]:.4f} / {paths[(n, 'scratch')]:.4f}" for n in (50, 128, 256, 1000)))


def cutler_path(dev, record, image_size=512, hw=CUTLER_HW, images=CUTLER_IMAGES,
                opts=()) -> int:
    """Phase 15: stage 1, the CutLER detector's CLI (`s2d_tpu_torch.train_net
    .main`) at full width on `configs/cuts3d/original_cascade_mask_rcnn_R_50
    _FPN.yaml` (R50-FPN, 256 channels, a cascade at 0.5/0.6/0.7, the mask
    head, pre-NMS top-k 1000, 256 proposals, IMS_PER_BATCH 16 as
    accumulation, copy-paste on; `opts` are extra flags a rehearsal off the
    card passes), seeded weights, image size 512, over a synthetic COCO set
    (`write_coco_set`) written under build/ and removed at the end:
    --max-iter 2, then --resume to 3 (evaluating 2 images after each), then
    --eval-only over the set, then --tta over 2 images. Checks: one K4
    launch a micro-step, two an eval image, `tta_launches` for the TTA
    pass; finite losses in metrics.json; moved parameters; the state the
    resumed run restored equal to its checkpoint bit for bit; the AP keys.
    Then `box_nms_check` on the inputs the runs gave K4. Prints ms a micro-step (synchronized), a train
    iteration, an eval image and a TTA image, the peak device memory and
    the phase's seconds. Returns the K4 launches of the four runs."""
    from s2d_tpu_torch import train_net
    from s2d_tpu_torch.checkpoint import io as ckpt_io
    from s2d_tpu_torch.checkpoint.io import STATE_FILE
    from s2d_tpu_torch.evaluation import tta_rcnn
    from s2d_tpu_torch.models.cutler import CutlerRCNN, init_parameters
    from s2d_tpu_torch.ops import boxes as box_ops
    from s2d_tpu_torch.ops import nms
    from s2d_tpu_torch.train import cutler_trainer

    started = time.perf_counter()
    root = Path("build") / "chip_smoke_cutler"
    shutil.rmtree(root, ignore_errors=True)
    name = "chip_smoke_coco"
    rng = np.random.RandomState(SEED + 15)
    write_coco_set(root / "set", name, rng, images, hw)
    out = root / "out"
    base = ["--config-file", CUTLER_CONFIG, "--train-dataset", name, "--test-dataset", name,
            "--output-dir", str(out), "--image-size", str(image_size), "--device", dev.type, *opts]
    runs = {"train": base + ["--max-iter", str(CUTLER_ITERS[0]), "--max-images", "2"],
            "resume": base + ["--max-iter", str(CUTLER_ITERS[1]), "--max-images", "2", "--resume"],
            "eval": base + ["--eval-only"],
            "tta": base + ["--eval-only", "--tta", "--max-images", str(CUTLER_TTA_IMAGES)]}
    cfg = train_net.build_config(train_net.parse_args(runs["train"]))[0]
    accum = cfg.accum_steps
    total = CUTLER_ITERS[1] * accum

    micro, evals, ttas, restored = [], [], [], []
    own_make, own_cascade = cutler_trainer.make_cutler_train_step, cutler_trainer.cascade_detections
    own_tta, own_restore = tta_rcnn.tta_inference, ckpt_io.restore_checkpoint
    own_nms, captured, run = box_ops.greedy_mask_nms, {}, [None]

    def box_nms_kernel(iou, labels, threshold):  # keeps each run's first input of each N
        key = (run[0], iou.shape[0])
        if key not in captured:
            captured[key] = (iou.clone(), labels.clone(), threshold)
        return own_nms(iou, labels, threshold)

    def make_step(model, cfg_, optimizer):
        step_fn = own_make(model, cfg_, optimizer)

        def step(*args):
            # the first run's micro-steps synchronized (each one's own time),
            # the resumed run's as shipped, but for a synchronize after its
            # last (the iteration's wall)
            before, t0 = nms.LAUNCHES, time.perf_counter()
            metrics = step_fn(*args)
            if len(micro) < CUTLER_ITERS[0] * accum or len(micro) == total - 1:
                torch.cuda.synchronize(dev)
            micro.append((t0, time.perf_counter(), nms.LAUNCHES - before))
            return metrics
        return step

    def cascade(*args, **kwargs):  # after each forward: an eval image, a TTA augmentation
        result = own_cascade(*args, **kwargs)
        torch.cuda.synchronize(dev)
        evals.append(time.perf_counter())
        return result

    def tta(*args, **kwargs):
        t0 = time.perf_counter()
        result = own_tta(*args, **kwargs)
        ttas.append(time.perf_counter() - t0)
        return result

    def restore(ckpt_dir, state, step=None):
        got = own_restore(ckpt_dir, state, step)
        sd = state.state_dict()
        restored.append((step, {**{f"model.{k}": v.to("cpu", copy=True) for k, v in sd["model"].items()},
                                **{f"trace.{n}": v.to("cpu", copy=True) for n, v in
                                   zip(sd["optimizer"]["names"], sd["optimizer"]["trace"])},
                                **{f"acc.{n}": v.to("cpu", copy=True) for n, v in
                                   zip(sd["optimizer"]["names"], sd["optimizer"]["acc"] or [])}},
                         (sd["step"], sd["optimizer"]["count"], sd["optimizer"]["mini_step"])))
        return got

    launches, walls, printed = {}, {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    cutler_trainer.make_cutler_train_step, cutler_trainer.cascade_detections = make_step, cascade
    tta_rcnn.tta_inference, ckpt_io.restore_checkpoint = tta, restore
    box_ops.greedy_mask_nms = box_nms_kernel
    try:
        for key, argv in runs.items():
            run[0] = key
            nms.LAUNCHES = 0
            n_micro, n_evals = len(micro), len(evals)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_net.main(argv)
            walls[key] = time.perf_counter() - t0
            printed[key] = buf.getvalue()
            if rc != 0:
                raise AssertionError(f"CutLER CLI {key}: exit {rc}")
            launches[key] = nms.LAUNCHES
            if key == "eval":
                eval_calls = evals[n_evals:]
            steps = len(micro) - n_micro
            eval_images = images if key == "eval" else 2
            tta_images = CUTLER_TTA_IMAGES if key == "tta" else 0
            want = steps + 2 * eval_images + tta_launches(cfg, tta_images)
            if launches[key] != want or any(m[2] != 1 for m in micro[n_micro:]):
                raise AssertionError(f"CutLER CLI {key}: {launches[key]} K4 launches, expected "
                                     f"{want} ({steps} micro-steps, {eval_images} eval images, "
                                     f"{tta_images} TTA images)")
    finally:
        cutler_trainer.make_cutler_train_step, cutler_trainer.cascade_detections = own_make, own_cascade
        tta_rcnn.tta_inference, ckpt_io.restore_checkpoint = own_tta, own_restore
        box_ops.greedy_mask_nms = own_nms
    peak = torch.cuda.max_memory_allocated(dev)

    if len(micro) != total:
        raise AssertionError(f"CutLER CLI: {len(micro)} micro-steps, expected {total}")
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    if [x["iteration"] for x in lines] != list(range(CUTLER_ITERS[1])) or not all(
            np.isfinite(v) for x in lines for v in x.values()):
        raise AssertionError(f"CutLER CLI: metrics.json {lines}")
    for key in ("train", "resume", "eval", "tta"):
        keys = ("bbox/AP:", "segm/AP:") + (("bbox_TTA/AP:", "segm_TTA/AP:") if key == "tta" else ())
        if not all(k in printed[key] for k in keys):
            raise AssertionError(f"CutLER CLI {key}: no {keys} in {printed[key][-2000:]}")
    saved = sorted(int(p.name) for p in (out / "checkpoints").iterdir() if p.name.isdigit())
    if saved != [CUTLER_ITERS[0] * accum, total] or len(restored) != 1:
        raise AssertionError(f"CutLER CLI: checkpoints {saved}, {len(restored)} restores")
    step, got, counts = restored[0]
    want = torch.load(out / "checkpoints" / str(saved[0]) / STATE_FILE, map_location="cpu",
                      weights_only=True)
    want_flat = {**{f"model.{k}": v for k, v in want["model"].items()},
                 **{f"trace.{n}": v for n, v in zip(want["optimizer"]["names"], want["optimizer"]["trace"])},
                 **{f"acc.{n}": v for n, v in zip(want["optimizer"]["names"], want["optimizer"]["acc"] or [])}}
    differ = [k for k in want_flat if not torch.equal(got[k], want_flat[k])]
    if set(got) != set(want_flat) or differ or counts != (
            want["step"], want["optimizer"]["count"], want["optimizer"]["mini_step"]):
        raise AssertionError(f"CutLER CLI: the restored state differs from its checkpoint in "
                             f"{differ[:5]}, counts {counts}")
    final = torch.load(out / "checkpoints" / str(total) / STATE_FILE, map_location="cpu",
                       weights_only=True)["model"]
    seeded = CutlerRCNN(cfg.rcnn)
    init_parameters(seeded, torch.Generator().manual_seed(0))
    moved = sum(not torch.equal(v, final[k]) for k, v in seeded.state_dict().items())
    if moved < len(final) // 2:
        raise AssertionError(f"CutLER CLI: only {moved} of {len(final)} tensors moved")

    augs = len(cfg.test_aug_min_sizes) * (2 if cfg.test_aug_flip else 1)
    per_image = min(cfg.detections_per_image, cfg.rcnn.num_proposals)
    shapes = {"rpn": cfg.rcnn.pre_nms_topk, "cascade": cfg.rcnn.num_proposals,
              "tta merge": augs * per_image}
    seen = {n for _, n in captured}
    if not set(shapes.values()) <= seen:
        raise AssertionError(f"CutLER CLI: K4 saw N = {sorted(seen)}, expected {shapes}")
    box_nms_check(dev, record, captured, rng)
    del seeded

    # the train loop's host work a micro-step, alone: map an image, paste the previous one
    from s2d_tpu_torch.data.coco import get_coco_dataset
    from s2d_tpu_torch.data.copy_paste import copy_paste_image

    map_ms, paste_ms, prev = [], [], None
    for rec in get_coco_dataset(name)[0]:
        t0 = time.perf_counter()
        sample = cutler_trainer.map_image_record(rec, cfg, rng, is_train=True, normalize=False)
        t1 = time.perf_counter()
        if prev is not None:
            copy_paste_image(rng, sample, prev, rate=cfg.copy_paste_rate,
                             min_ratio=cfg.copy_paste_min_ratio, max_ratio=cfg.copy_paste_max_ratio,
                             random_num=cfg.copy_paste_random_num)
            paste_ms.append(1e3 * (time.perf_counter() - t1))
        map_ms.append(1e3 * (t1 - t0))
        prev = sample

    first = CUTLER_ITERS[0] * accum
    later = [1e3 * (m[1] - m[0]) for m in micro[1:first]]
    resumed = micro[first:]
    iteration_ms = 1e3 * (resumed[-1][1] - resumed[0][0])
    eval_ms = 1e3 * np.diff(eval_calls)
    shutil.rmtree(root, ignore_errors=True)
    print(f"CutLER path: {len(micro)} micro-steps at {image_size}x{image_size}, "
          f"{np.median(later):.1f} ms a micro-step (median of the first run's after its first, "
          f"each synchronized; {min(later):.1f}-{max(later):.1f}), the resumed run's iteration "
          f"of {accum} micro-steps {iteration_ms:.1f} ms (the loop as shipped: mapping and "
          f"copy-paste on the host beside the steps on the card); "
          f"{np.median(eval_ms):.1f} ms an eval image (median of the --eval-only run's "
          f"{len(eval_ms)} intervals after its first; forward and detections, synchronized); "
          f"{1e3 * np.mean(ttas):.1f} ms a TTA image ({', '.join(f'{t * 1e3:.1f}' for t in ttas)}; "
          f"{len(cfg.test_aug_min_sizes)} scales x 2 flips on a "
          f"{tta_rcnn.tta_canvas_size(cfg.test_aug_min_sizes, cfg.test_aug_max_size)}^2 canvas, "
          f"masks included); peak device memory {peak / 2**30:.2f} GiB; host alone "
          f"{np.median(map_ms):.1f} ms to map a train image, {np.median(paste_ms):.1f} ms to "
          f"copy-paste (medians of {len(map_ms)}, {len(paste_ms)})")
    print(f"  K4 launches: train {launches['train']}, resume {launches['resume']}, eval "
          f"{launches['eval']}, tta {launches['tta']} (1 a micro-step, 2 an eval image, "
          f"{tta_launches(cfg, 1)} a TTA image); checkpoints {saved}, the restored state "
          f"equals its checkpoint bit for bit; {moved} of {len(final)} tensors moved; runs "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print(f"  {printed['eval'].strip().splitlines()[-1][:160]}")
    print(f"CutLER phase: {time.perf_counter() - started:.1f} s")
    return sum(launches.values())


def real_frames(rng, t, hw):
    """t frames (T, H, W, 3) uint8 that a JPEG codes at a realistic size: a
    colour gradient, a few flat ellipses that drift, mild noise."""
    h, w = hw
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    base = np.stack([xx * 200 / w + 20, yy * 180 / h + 40, (xx + yy) * 120 / (h + w) + 60], -1)
    blobs = [(rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w, rng.uniform(0.05, 0.2) * h,
              rng.uniform(0.05, 0.2) * w, rng.uniform(-6, 6, 2), rng.randint(0, 256, 3))
             for _ in range(4)]
    frames = np.empty((t, h, w, 3), np.uint8)
    for i in range(t):
        img = base.copy()
        for cy, cx, ry, rx, (vy, vx), color in blobs:
            img[((yy - cy - vy * i) / ry) ** 2 + ((xx - cx - vx * i) / rx) ** 2 < 1] = color
        frames[i] = np.clip(img + rng.normal(0, 4, img.shape), 0, 255)
    return frames


def write_jpeg_coco_set(root: Path, name: str, rng, n=CUTLER_IMAGES, hw=CUTLER_HW) -> None:
    """A COCO-format set of `n` JPEG images at `hw` (`write_jpeg`, 4:2:0,
    quality REAL_QUALITY) with 3-6 flat-coloured star polygons each,
    annotated as COCO polygons (the segmentation COCO's own annotations
    use) with their boxes, registered class-agnostic as `name`."""
    from s2d_tpu_torch.data import coco
    from s2d_tpu_torch.data.jpeg import write_jpeg
    from s2d_tpu_torch.data.rle import polygons_to_mask

    h, w = hw
    (root / "images").mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        img = real_frames(rng, 1, hw)[0]
        for _ in range(rng.randint(3, 7)):
            k = rng.randint(8, 17)
            angles = np.sort(rng.uniform(0, 2 * np.pi, k))
            radius = rng.uniform(0.3, 1.0, k) * rng.uniform(0.08, 0.25) * h
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            poly = np.stack([cx + radius * np.cos(angles), cy + radius * np.sin(angles)], 1)
            poly = np.round(poly, 1).reshape(-1).tolist()
            m = polygons_to_mask([poly], h, w)
            img[m] = rng.randint(110, 256, 3)
            xs, ys = poly[0::2], poly[1::2]
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1, "category_id": 1, "iscrowd": 0,
                "bbox": [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)],
                "area": float(m.sum()), "segmentation": [poly]})
        write_jpeg(str(root / "images" / f"{i:03d}.jpg"), img, REAL_QUALITY)
        images.append({"id": i + 1, "file_name": f"{i:03d}.jpg", "height": h, "width": w})
    path = root / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": annotations,
                                "categories": [{"id": 1, "name": "fg"}]}))
    coco.register_coco(name, str(path), str(root / "images"), class_agnostic=True)
    print(f"COCO set {name}: {n} JPEG images at {h}x{w}, {len(annotations)} polygon instances")


def jpeg_fixture_check() -> None:
    """16(a): the committed JPEG fixtures decoded on this host by the port's
    codec, each against the SHA-256 of cv2's decode of it (written where the
    fixtures were made); the refused kinds must raise."""
    from s2d_tpu_torch.data.jpeg import read_jpeg

    digests = json.loads((JPEG_FIXTURES / "digests.json").read_text())
    matched, refused = 0, 0
    for name, want in sorted(digests.items()):
        path = str(JPEG_FIXTURES / name)
        if "refused" in want:
            try:
                read_jpeg(path)
            except ValueError:
                refused += 1
                continue
            raise AssertionError(f"JPEG fixture {name}: decoded, but must be refused")
        got = read_jpeg(path)
        if list(got.shape) != want["shape"] or hashlib.sha256(got.tobytes()).hexdigest() != want["sha256"]:
            raise AssertionError(f"JPEG fixture {name}: the decode differs from cv2's digest")
        matched += 1
    print(f"JPEG fixtures: {matched} decoded to cv2's SHA-256 digests, {refused} refused as "
          f"they must be ({JPEG_FIXTURES})")


def demo_jpeg_path(dev, root: Path, hw=OUT_SIZE, frames=REAL_FRAMES, opts=()) -> dict:
    """16(b): the demo CLI, `python -m s2d_tpu_torch.demo_video` (`main`), over
    REAL_VIDEOS folders of `frames` JPEG frames (`write_jpeg`, 4:2:0, quality
    REAL_QUALITY) with the inference config on seeded weights, --save-masks.
    Its predictions (kept scores, labels, masks) must equal VideoPredictor's
    on the same frames read by `read_jpeg` and resized by `resize_linear`,
    and its PNGs read back by `read_png`. Prints the host's ms to decode a
    frame beside `read_png`'s for the same frame as PNG, the CLI's wall and
    frames/s, and its K1/K3/K4 launches. Returns them."""
    from s2d_tpu_torch import demo_video
    from s2d_tpu_torch.config import load_config
    from s2d_tpu_torch.data.augment import resize_shortest_edge
    from s2d_tpu_torch.data.jpeg import read_jpeg, write_jpeg
    from s2d_tpu_torch.data.png import read_png, write_png
    from s2d_tpu_torch.data.transforms import resize_linear
    from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, nms

    rng = np.random.RandomState(SEED + 16)
    names = [f"video{v}" for v in range(REAL_VIDEOS)]
    for name in names:
        (root / "demo_in" / name).mkdir(parents=True)
        for i, frame in enumerate(real_frames(rng, frames, hw)):
            write_jpeg(str(root / "demo_in" / name / f"{i:05d}.jpg"), frame, REAL_QUALITY)
    one = str(root / "demo_in" / "video0" / "00000.jpg")
    write_png(str(root / "frame.png"), read_jpeg(one))
    jpeg_ms = 1e3 * min(timeit(lambda: read_jpeg(one)) for _ in range(5))
    png_ms = 1e3 * min(timeit(lambda: read_png(str(root / "frame.png"))) for _ in range(5))

    cfg = load_config(EVAL_CONFIG, opts)
    predictor = demo_video.VideoPredictor(cfg, seed=0, device=dev)
    want = {}
    for name in names:
        raw = [read_jpeg(f) for f in sorted(glob.glob(str(root / "demo_in" / name / "*.jpg")))]
        nh, nw = resize_shortest_edge(*hw, cfg.min_size_test, cfg.max_size_test)
        want[name] = predictor(np.stack([resize_linear(f, (nh, nw)) for f in raw]), output_size=hw)
    del predictor

    got, own_write = {}, demo_video._write_outputs

    def write_outputs(out_dir, raw, preds, threshold, save_masks):
        got[os.path.basename(out_dir)] = preds
        return own_write(out_dir, raw, preds, threshold, save_masks)

    counters = {"k1_msda": (ms_deform_attn_cuda, "LAUNCHES"),
                "k3_flash": (masked_attention_cuda, "LAUNCHES"), "k4_nms": (nms, "LAUNCHES")}
    out = root / "demo_out"
    argv = ["--input", str(root / "demo_in" / "video*"), "--output", str(out), "--config-file",
            EVAL_CONFIG, "--device", dev.type, "--confidence-threshold", "0.0", "--save-masks",
            *opts]
    demo_video._write_outputs = write_outputs
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    try:
        t0 = time.perf_counter()
        rc = demo_video.main(argv)
        wall = time.perf_counter() - t0
    finally:
        demo_video._write_outputs = own_write
    launches = read_counts(counters)
    if rc != 0:
        raise AssertionError(f"demo CLI: exit {rc}")
    expected = {k: REAL_VIDEOS * PER_CLIP[k] for k in counters}
    if dev.type == "cuda" and launches != expected:
        raise AssertionError(f"demo CLI: launches {launches}, expected {expected}")
    kept = []
    for name, ref in want.items():
        mine = got[name]
        for key in ("scores", "labels", "masks"):
            if not np.array_equal(mine[key], ref[key]):
                raise AssertionError(f"demo CLI {name}: {key} differ from VideoPredictor's")
        kept.append(len(mine["scores"]))
        for i in range(frames):
            for kind in ("frame", "mask"):
                png = read_png(str(out / name / f"{kind}_{i:05d}.png"))
                if png.shape != (*hw, 3):
                    raise AssertionError(f"demo CLI {name}: {kind} {i} is {png.shape}")
        # the first overlay, recomputed from the decoded frame and the predictions
        overlay = read_jpeg(str(root / "demo_in" / name / "00000.jpg")).astype(np.float32)
        for ni, m in enumerate(mine["masks"][:, 0]):
            overlay[m] = 0.5 * overlay[m] + 0.5 * np.asarray(
                demo_video.PALETTE[ni % len(demo_video.PALETTE)], np.float32)
        if not np.array_equal(read_png(str(out / name / "frame_00000.png")), overlay.astype(np.uint8)):
            raise AssertionError(f"demo CLI {name}: the first overlay PNG differs from its pixels")
    n_frames = REAL_VIDEOS * frames
    print(f"demo CLI on JPEG: {REAL_VIDEOS} videos of {frames} frames at {hw[0]}x{hw[1]} "
          f"(4:2:0, quality {REAL_QUALITY}), {wall:.2f} s wall, {n_frames / wall:.2f} frames/s "
          f"(reads, resizes, clips, PNG writes; the predictor's build included); kept "
          f"{kept} predictions, scores, labels and masks equal to VideoPredictor's on the same "
          f"read_jpeg frames; {2 * n_frames} PNGs read back; launches {launches} (K1/K3/K4 "
          f"{PER_CLIP['k1_msda']}/{PER_CLIP['k3_flash']}/{PER_CLIP['k4_nms']} a clip)")
    print(f"  host decode of one {hw[0]}x{hw[1]} frame: read_jpeg {jpeg_ms:.2f} ms, read_png "
          f"{png_ms:.2f} ms (the same pixels as PNG; best of 5)")
    return launches


def timeit(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def once_ms(fn) -> float:
    """Device time of one call by CUDA events: for a call that takes long
    enough (a plain loop of thousands of steps) that `cuda_ms`'s warm-up
    and repeats would cost seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def pseudo_clip_train_path(dev, root: Path, name: str, opts=()) -> dict:
    """16(c): the video trainer, `train_net_video.main`, on the JPEG COCO set
    `name` as pseudo-clips (DATASETS.TRAIN; the loader reads the JPEGs and
    fills the polygons on its threads) with the KD config: MAX_ITER 2, B=4
    clips of T=3, no eval. Checks each step's K1/K2/K5 launches
    (`expected_launches`) and finite losses; prints ms a step (metrics.json
    `time`), the losses and the peak memory. Returns the launches."""
    from s2d_tpu_torch import train_net_video
    from s2d_tpu_torch.config import load_config_tree
    from s2d_tpu_torch.train import trainer

    out = root / "train_out"
    args = ["--device", dev.type, "--config-file", KD_CONFIG, *opts,
            "DATASETS.TRAIN", f'("{name}",)', "SOLVER.MAX_ITER", "2", "SOLVER.IMS_PER_BATCH", "4",
            "INPUT.SAMPLING_FRAME_NUM", "3", "TEST.EVAL_PERIOD", "0", "OUTPUT_DIR", str(out)]
    cfg = load_config_tree(KD_CONFIG, [*opts, "SOLVER.IMS_PER_BATCH", "4"])
    counters, steps, own_make = train_counters(), [], trainer.make_train_step

    def make_train_step(cfg_, kernels=True, group=None):
        step_fn = own_make(cfg_, kernels, group)

        def step(state, *a, **kw):
            before = read_counts(counters)
            result = step_fn(state, *a, **kw)
            steps.append(({k: v - before[k] for k, v in read_counts(counters).items()},
                          tuple(a[0].shape)))
            return result
        return step

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer.make_train_step = make_train_step
    try:
        t0 = time.perf_counter()
        rc = train_net_video.main(args)
        wall = time.perf_counter() - t0
    finally:
        trainer.make_train_step = own_make
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if rc != 0 or len(steps) != 2:
        raise AssertionError(f"pseudo-clip trainer: exit {rc}, {len(steps)} steps")
    expected = expected_launches(cfg)
    for i, (grew, shape) in enumerate(steps):
        if dev.type == "cuda" and {k: grew[k] for k in expected} != expected:
            raise AssertionError(f"pseudo-clip trainer step {i}: launches {grew}, expected {expected}")
        if shape[:2] != (4, 3):
            raise AssertionError(f"pseudo-clip trainer step {i}: batch {shape}, expected B=4, T=3")
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    losses = {k: v for k, v in lines[-1].items() if "loss" in k}
    if len(lines) != 2 or not all(np.isfinite(x[k]) for x in lines for k in x if "loss" in k):
        raise AssertionError(f"pseudo-clip trainer: metrics.json {lines}")
    print(f"pseudo-clip trainer: 2 steps of B=4 pseudo-clips of T=3 from {name} "
          f"(canvases {sorted({s[1][2:4] for s in steps})}), "
          + ", ".join(f"{x['time'] * 1e3:.1f}" for x in lines)
          + f" ms a step (metrics.json time; data_time "
          + ", ".join(f"{x['data_time']:.3f}" for x in lines)
          + f" s), peak device memory {peak / 2**30:.2f} GiB, {wall:.1f} s wall; "
          f"launches {launches} ({steps[0][0]} a step); last losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items())[:6]))
    return launches


def stage1_jpeg_path(dev, root: Path, name: str, image_size=512, opts=()) -> int:
    """16(d): stage 1, `train_net.main`, on the JPEG COCO set with polygon
    annotations: --max-iter 1 (IMS_PER_BATCH micro-steps), then --eval-only
    over the set (its ground truth filled from the polygons). Checks one K4
    launch a micro-step and two an eval image and the AP keys; prints ms a
    micro-step (each synchronized) and an eval image. Returns the K4
    launches."""
    from s2d_tpu_torch import train_net
    from s2d_tpu_torch.ops import nms
    from s2d_tpu_torch.train import cutler_trainer

    base = ["--config-file", CUTLER_CONFIG, "--train-dataset", name, "--test-dataset", name,
            "--output-dir", str(root / "stage1_out"), "--image-size", str(image_size),
            "--device", dev.type, *opts]
    micro, evals = [], []
    own_make, own_cascade = cutler_trainer.make_cutler_train_step, cutler_trainer.cascade_detections

    def make_step(model, cfg_, optimizer):
        step_fn = own_make(model, cfg_, optimizer)

        def step(*a):
            t0 = time.perf_counter()
            metrics = step_fn(*a)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            micro.append(time.perf_counter() - t0)
            return metrics
        return step

    def cascade(*a, **kw):
        result = own_cascade(*a, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        evals.append(time.perf_counter())
        return result

    launches, printed = {}, {}
    cutler_trainer.make_cutler_train_step, cutler_trainer.cascade_detections = make_step, cascade
    try:
        for key, argv in (("train", base + ["--max-iter", "1", "--max-images", "1"]),
                          ("eval", base + ["--eval-only"])):
            nms.LAUNCHES = 0
            n_evals = len(evals)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_net.main(argv)
            printed[key] = buf.getvalue()
            launches[key] = nms.LAUNCHES
            if rc != 0:
                raise AssertionError(f"stage 1 on JPEG {key}: exit {rc}")
            if key == "eval":
                images = len(evals) - n_evals
    finally:
        cutler_trainer.make_cutler_train_step, cutler_trainer.cascade_detections = own_make, own_cascade
    want = {"train": len(micro) + 2, "eval": 2 * images}  # --max-images 1: one eval image after
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"stage 1 on JPEG: K4 launches {launches}, expected {want}")
    if not all(k in printed["eval"] for k in ("bbox/AP:", "segm/AP:")):
        raise AssertionError(f"stage 1 on JPEG: no AP keys in {printed['eval'][-2000:]}")
    eval_ms = 1e3 * np.diff(evals[-images:])
    print(f"stage 1 on JPEG + polygons: {len(micro)} micro-steps at {image_size}x{image_size}, "
          f"{1e3 * np.median(micro[1:]):.1f} ms a micro-step (median after the first, each "
          f"synchronized; {1e3 * min(micro[1:]):.1f}-{1e3 * max(micro[1:]):.1f}), "
          f"{np.median(eval_ms):.1f} ms an eval image (median of {len(eval_ms)} intervals of "
          f"the --eval-only run over {images} images); K4 launches {launches} (1 a micro-step, 2 "
          f"an eval image)")
    print(f"  {printed['eval'].strip().splitlines()[-1][:160]}")
    return sum(launches.values())


def keymask_jpeg_path(dev, root: Path, hw=OUT_SIZE, length=REAL_KEYMASK_FRAMES) -> None:
    """16(e): keymask discovery, `keymask_ident.main`, on one video of
    `length` JPEG frames (`keymask_scene`, `write_jpeg` 4:2:0 quality
    REAL_QUALITY) with colour-PNG stage-1 masks. Prints the CLI's seconds
    and its tracker's point-frames/s."""
    from s2d_tpu_torch import keymask_ident
    from s2d_tpu_torch.data.jpeg import write_jpeg
    from s2d_tpu_torch.data.png import write_png

    rng = np.random.RandomState(SEED + 17)
    frames, pngs, _, _ = keymask_scene(rng, hw, length)
    for sub in ("km_frames", "km_masks"):
        (root / sub / "video0").mkdir(parents=True)
    for fi in range(length):
        write_jpeg(str(root / "km_frames" / "video0" / f"{fi:05d}.jpg"), frames[fi], REAL_QUALITY)
        write_png(str(root / "km_masks" / "video0" / f"{fi:05d}.png"), pngs[fi])
    argv = ["--frames-root", str(root / "km_frames"), "--masks-root", str(root / "km_masks"),
            "--output-root", str(root / "km_out"), "--grid-size", str(KEYMASK_GRID),
            *(["--device", "cpu"] if dev.type == "cpu" else [])]
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = keymask_ident.main(argv)
    cli_s = time.perf_counter() - t0
    text = log.getvalue()
    summary = re.search(r"keymask_ident: (\d+) ok, (\d+) failed", text)
    tracked = re.search(r"^tracker: (\d+) point-frames in ([\d.]+) s, (\d+) point-frames/s", text,
                        re.M)
    if rc != 0 or summary is None or summary.groups() != ("1", "0") or tracked is None:
        raise AssertionError(f"keymask CLI on JPEG: exit {rc}; {text[-1500:]}")
    groups = len(json.loads((root / "km_out" / "annotations" / "video0.json").read_text())
                 ["annotations"])
    print(f"keymask CLI on JPEG: 1 video of {length} frames at {hw[0]}x{hw[1]}, {cli_s:.2f} s "
          f"(reads included), {groups} groups; tracker {tracked.group(1)} point-frames in "
          f"{tracked.group(2)} s, {tracked.group(3)} point-frames/s")


def k4_past_one_block(dev, record, sizes=REAL_NMS_SIZES) -> None:
    """16(f): K4 past 4096 candidates (one walk block) against its plain loop, keep sets
    exactly: seeded boxes with score ties (`box_nms_inputs`) and a sparse
    IoU (kept candidates in every block of 4096) with two labels; the device
    ms of the box case beside its plain loop's and its byte bound."""
    from s2d_tpu_torch.ops import nms

    rng = np.random.RandomState(SEED + 18)
    times = {}
    for n in sizes:
        box_iou, box_labels = box_nms_inputs(dev, n, rng)
        dense = rng.rand(n, n).astype(np.float32) * 0.7
        for value, pairs in ((0.8, 3 * n), (0.75, n)):
            dense[rng.randint(0, n, pairs), rng.randint(0, n, pairs)] = value
        dense = np.maximum(dense, dense.T)
        np.fill_diagonal(dense, 1.0)
        sparse_iou = torch.from_numpy(dense).to(dev)
        sparse_labels = torch.from_numpy(rng.randint(0, 2, n)).to(dev)
        kept, plain_ms = {}, {}
        for case, iou, labels, thresh in (("boxes", box_iou, box_labels, 0.7),
                                          ("sparse", sparse_iou, sparse_labels, 0.75)):
            got, ref = nms.greedy_mask_nms(iou, labels, thresh), []
            plain_ms[case] = once_ms(lambda: ref.append(
                nms.greedy_mask_nms_plain(iou, labels, thresh)))
            if not torch.equal(got, ref[0]):
                raise AssertionError(f"K4 at N={n} ({case}) differs from its plain loop")
            kept[case] = int(got.sum())
        times[str(n)] = dict(
            ms=cuda_ms(lambda: nms.greedy_mask_nms(box_iou, box_labels, 0.7)),
            plain_ms=plain_ms["boxes"], kept=kept,
            **bound(nbytes(box_iou, box_labels) + n, n * (n - 1) / 2))
    record["k4_nms"]["past_one_block"] = times
    print("K4 past 4096 candidates: keep sets identical to the plain loop's (box and sparse "
          "IoUs); device ms " + "; ".join(
              f"N={n} {t['ms']:.4f} (plain {t['plain_ms']:.1f}, bound {t['bound_ms']:.4f} by "
              f"{t['bound_by']}, kept {t['kept']})" for n, t in times.items()))


def real_inputs_path(dev, record, demo_hw=OUT_SIZE, demo_frames=REAL_FRAMES,
                     coco_hw=CUTLER_HW, coco_images=CUTLER_IMAGES, keymask_hw=OUT_SIZE,
                     keymask_frames=REAL_KEYMASK_FRAMES, stage1_size=512, nms_sizes=REAL_NMS_SIZES,
                     demo_opts=(), train_opts=(), stage1_opts=()) -> dict:
    """Phase 16: real inputs (JPEG files, polygon annotations) through the
    CLIs, under build/chip_smoke_real (removed at the end): (a)
    `jpeg_fixture_check`, (b) `demo_jpeg_path`, (c) `pseudo_clip_train_path`
    and (d) `stage1_jpeg_path` on one JPEG COCO set with polygons
    (`write_jpeg_coco_set`), (e) `keymask_jpeg_path`, (f) `k4_past_one_block`.
    A rehearsal off the card passes a CPU `dev` and smaller sizes and opts.
    Returns the launches of each kernel on the phase's paths."""
    started = time.perf_counter()
    root = Path("build") / "chip_smoke_real"
    shutil.rmtree(root, ignore_errors=True)
    try:
        jpeg_fixture_check()
        demo = demo_jpeg_path(dev, root, demo_hw, demo_frames, demo_opts)
        write_jpeg_coco_set(root / "coco", REAL_COCO, np.random.RandomState(SEED + 19),
                            coco_images, coco_hw)
        train = pseudo_clip_train_path(dev, root, REAL_COCO, train_opts)
        stage1 = stage1_jpeg_path(dev, root, REAL_COCO, stage1_size, stage1_opts)
        keymask_jpeg_path(dev, root, keymask_hw, keymask_frames)
        k4_past_one_block(dev, record, nms_sizes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"real-inputs phase: {time.perf_counter() - started:.1f} s")
    return {"k1_msda": demo["k1_msda"] + train["k1_msda"], "k3_flash": demo["k3_flash"],
            "k4_nms": demo["k4_nms"] + stage1, "k2_msda_bwd": train["k2_msda_bwd"],
            "k5_auction": train["k5_auction"]}


COMPARE_ORDER = ("parent", "change", "change", "parent")
# the lines of a run's log that the comparison prints under the run's header
COMPARE_LINES = ("inference path:", "train path:", "profiled", "device ms per span",
                 "  K5 on", "  K5:", "  K6 empty vs", "  ms_deform_attn_bwd:", "  batched_auction:",
                 "  ms_deform_attn_fwd:", "eval path:", "K2 d", "K2 gradient hash", "build:",
                 "  K4 at N=50", "  greedy_nms:", "  K6 ", "checkpoint", "  EVAL_STUDENT",
                 "train CLI", "keymask", "  correlation tracker", "  cotracker", "  stage seconds",
                 "  readback:", "  whole-mask read", "crop check", "options path",
                 "plain vs kernel options", "  distillation NMS", "options phase",
                 "CutLER", "  K4 box NMS", "  K4 launches", "chip_smoke:")


def by_clip(value, rank: int, world: int):
    """Rank `rank`'s block of the clips of a batch-leading tensor (or tuple)."""
    if isinstance(value, (tuple, list)):
        return type(value)(by_clip(v, rank, world) for v in value)
    n = value.shape[0]
    return value[rank * n // world:(rank + 1) * n // world]


def by_problem(value, rank: int, world: int, clips: int):
    """Rank `rank`'s rows of the auction's assignments: (sets x layers x
    clips, N), the clips fastest."""
    rows = value.reshape(-1, clips, value.shape[-1])
    return by_clip(rows.transpose(0, 1), rank, world).transpose(0, 1).reshape(-1, value.shape[-1])


def ddp_tapes(state):
    """The hard decisions of a KD step and the encoder's dropout draws, each
    a (Tape, owner) pair, in a fixed order."""
    from s2d_tpu_torch.losses import criterion
    from s2d_tpu_torch.train import trainer

    layers = [m for m in state.student.modules() if hasattr(type(m), "draw_dropout")]
    return ([(Tape("attention_mask"), state.teacher.predictor),
             (Tape("attention_mask"), state.student.predictor),
             (Tape("prepare_distillation_targets"), trainer),
             (Tape("hungarian_assign"), criterion)]
            + [(Tape("draw_dropout"), layer) for layer in layers])


def to_device(value, dev):
    if isinstance(value, (tuple, list)):
        return type(value)(to_device(v, dev) for v in value)
    if isinstance(value, dict):
        return {k: to_device(v, dev) for k, v in value.items()}
    return value.to(dev) if torch.is_tensor(value) else value


def params_digest(params) -> str:
    digest = hashlib.sha256()
    for p in params:
        digest.update(p.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def ddp_rank(rank: int, job_path: str, port: int) -> None:
    """Phase 17 (a)'s rank `rank`: a process group over gloo with the other
    ranks on the same card; phase 8's seeded state (rank 0's broadcast),
    one KD step on this rank's clips with the one-process step's decisions
    and draws replayed, then this rank's shard of phase 10's eval set
    merged by rank 0. Writes what it found as JSON beside the job."""
    from s2d_tpu_torch.config import from_s2d_config, load_config_tree
    from s2d_tpu_torch.data import ytvis
    from s2d_tpu_torch.demo_video import VideoPredictor, set_full_f32
    from s2d_tpu_torch.ops import masked_attention_cuda, nms
    from s2d_tpu_torch.parallel import dist
    from s2d_tpu_torch.train import trainer
    from s2d_tpu_torch.train_net_video import evaluate_sharded

    job = torch.load(job_path, weights_only=False)
    world = job["world"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    group, dev = dist.init(job["device"], backend="gloo")
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    found = {"rank": rank}
    try:
        set_full_f32()
        cfg = load_config_tree(job["config"], job["opts"])
        state = new_train_state(cfg, dev, class_scale=job["class_scale"])
        found["seeded_state_same"] = params_digest(state.optimizer.params) == job["params_digest"]
        group.broadcast_(trainer.state_tensors(state))
        step_fn = trainer.make_train_step(cfg, group=group)
        tapes = ddp_tapes(state)
        for (tape, owner), values in zip(tapes, job["tapes"][rank]):
            tape.values = to_device(values, dev)
            tape.replay(owner, force=True)
        taken = Tape("step", keep=lambda args, out: list(args[0])).record(state.optimizer)
        counters = train_counters()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        batch = to_device(job["batch"][rank], dev)
        gen = torch.Generator(device=dev).manual_seed(DDP_SEED + rank)
        try:
            sync()
            start = time.perf_counter()
            _, metrics = step_fn(state, *batch, generator=gen, draws=to_device(job["draws"][rank], dev))
            sync()
            found["step_ms"] = (time.perf_counter() - start) * 1e3
        finally:
            for tape, _ in tapes + [(taken, None)]:
                tape.stop()
        found["launches"] = read_counts(counters)
        found["differ"] = [tape.differ for tape, _ in tapes[:4]]  # the draws are replayed too
        found["metrics"] = {k: float(v) for k, v in metrics.items()}
        clipped = state.optimizer.clip_gradients(taken.values[0])
        ref = job["ref_clipped"]
        num = sum(float(((g.double() - r.to(dev).double()) ** 2).sum()) for g, r in zip(clipped, ref))
        den = sum(float((r.double() ** 2).sum()) for r in ref)
        found["grad_rel_err"] = (num / den) ** 0.5
        found["bucket_bytes"] = sum(g.numel() * g.element_size() for g in clipped)
        found["after_digest"] = params_digest(state.optimizer.params)
        del state, step_fn, clipped, batch
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        ytvis.register_ytvis(EVAL_DATASET, job["eval_json"], str(Path(job["eval_json"]).parent),
                             class_agnostic=True)
        frames = job["eval_frames"]
        predictor = VideoPredictor(from_s2d_config(load_config_tree(EVAL_CONFIG, job["eval_opts"])),
                                   seed=SEED, device=dev)
        eval_counters = {"k1_msda": train_counters()["k1_msda"],
                         "k3_flash": (masked_attention_cuda, "LAUNCHES"), "k4_nms": (nms, "LAUNCHES")}
        for mod, attr in eval_counters.values():
            setattr(mod, attr, 0)
        merged = evaluate_sharded(predictor, EVAL_DATASET, job["eval_out"], group,
                                  mapper=lambda record: {"image": frames[record["video_id"]]})
        found["eval_launches"] = read_counts(eval_counters)
        found["eval_metrics"] = merged
    finally:
        dist.shutdown()
    Path(job_path).with_name(f"rank{rank}.json").write_text(json.dumps(found))


def ddp_step_check(dev, batch, class_scale, opts=(), eval_opts=()) -> dict:
    """Phase 17 (a): the KD step of phase 8's seeded state and batch in one
    process (B = 2), then in DDP_WORLD ranks on this card (gloo), each on
    its clips, with the one-process step's hard decisions, dropout draws and
    criterion draws replayed; the ranks' summed, clipped gradients against
    the one-process step's (DDP_GRAD_RTOL in the 2-norm), their losses
    (rtol 1e-4), their parameters after the step bit-identical; then phase
    10's eval set in shards, merged by rank 0, against one process's
    results.json. Returns the ranks' kernel launches and the gradient
    bucket's bytes. `opts` and `eval_opts` (config overrides of the KD and
    the eval config) are for a rehearsal off the card."""
    from s2d_tpu_torch.config import from_s2d_config, load_config_tree
    from s2d_tpu_torch.demo_video import VideoPredictor
    from s2d_tpu_torch.evaluation.evaluator import evaluate_dataset
    from s2d_tpu_torch.losses.criterion import draw_bernoulli, draw_pool
    from s2d_tpu_torch.train import trainer

    started = time.perf_counter()
    root = Path("build") / "chip_smoke_ddp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    world = DDP_WORLD
    cfg = load_config_tree(KD_CONFIG, opts)
    clips, slots, t = batch[0].shape[0], batch[2].shape[1], batch[0].shape[1]
    queries = cfg.model.mask_former.num_object_queries
    state = new_train_state(cfg, dev, class_scale=class_scale)
    digest = params_digest(state.optimizer.params)
    step_fn = trainer.make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(DDP_SEED)
    crit = step_fn.crit_cfg
    draws = {"pool": draw_pool(crit, gen, dev),
             "bern": {r: draw_bernoulli(crit, r, gen, dev) for r in (clips * slots * t,
                                                                     clips * queries * t)}}
    tapes = ddp_tapes(state)
    for tape, owner in tapes:
        tape.record(owner)
    taken = Tape("step", keep=lambda args, out: [g.detach().clone() for g in args[0]]).record(
        state.optimizer)
    try:
        _, metrics = step_fn(state, *batch, generator=gen, draws=draws)
    finally:
        for tape, _ in tapes + [(taken, None)]:
            tape.stop()
    ref_metrics = {k: float(v) for k, v in metrics.items()}
    ref_clipped = [g.cpu() for g in state.optimizer.clip_gradients(taken.values[0])]
    cpu = lambda v: to_device(v, torch.device("cpu"))  # noqa: E731
    ranks = range(world)

    def share(tape, rank):
        if tape.name == "hungarian_assign":
            return [by_problem(v, rank, world, clips) for v in tape.values]
        return [by_clip(v, rank, world) for v in tape.values]

    eval_frames = write_eval_set(root / "eval", np.random.RandomState(SEED + 2))
    job = {"config": KD_CONFIG, "opts": list(opts), "eval_opts": list(eval_opts),
           "device": dev.type, "class_scale": class_scale, "world": world,
           "params_digest": digest,
           "batch": [cpu(by_clip(list(batch), r, world)) for r in ranks],
           "draws": [cpu({"pool": draws["pool"],
                          "bern": {n // world: by_clip(b, r, world)
                                   for n, b in draws["bern"].items()}}) for r in ranks],
           "tapes": [[cpu(share(tape, r)) for tape, _ in tapes] for r in ranks],
           "ref_clipped": ref_clipped, "eval_json": str(root / "eval" / "valid.json"),
           "eval_frames": eval_frames, "eval_out": str(root / "eval_ranks")}
    job_path = root / "job.pt"
    torch.save(job, job_path)
    del state, step_fn, taken, tapes, job, draws
    torch.cuda.empty_cache()
    print(f"DDP (a): the one-process step (B = {clips}) and its decisions recorded, "
          f"{time.perf_counter() - started:.1f} s")

    import socket
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    start = time.perf_counter()
    mp.start_processes(ddp_rank, args=(str(job_path), port), nprocs=world, start_method="spawn")
    ranks_s = time.perf_counter() - start
    found = [json.loads((root / f"rank{r}.json").read_text()) for r in ranks]

    predictor = VideoPredictor(from_s2d_config(load_config_tree(EVAL_CONFIG, eval_opts)), seed=SEED,
                               device=dev)
    one = evaluate_dataset(predictor, EVAL_DATASET, output_dir=str(root / "eval_one"),
                           mapper=lambda record: {"image": eval_frames[record["video_id"]]})
    del predictor
    by_video = lambda path: sorted(json.loads(path.read_text()), key=lambda r: r["video_id"])  # noqa: E731
    merged_same = by_video(root / "eval_ranks" / "results.json") == by_video(
        root / "eval_one" / "results.json")

    failures = []
    expected = expected_launches(cfg)
    rank_launches = [{k: f["launches"][k] for k in expected} for f in found]
    for f, launched in zip(found, rank_launches):
        if launched != expected:
            failures.append(f"rank {f['rank']}: launches {launched}, expected {expected}")
        if not f["seeded_state_same"]:
            failures.append(f"rank {f['rank']}: its seeded state differs from the one process's")
        if any(f["differ"]):
            print(f"  rank {f['rank']}: replayed decisions it would have made otherwise (teacher "
                  f"and student attention masks, distillation targets, assignments) {f['differ']}")
        for key, value in f["metrics"].items():
            if not np.isclose(value, ref_metrics[key], rtol=1e-4, atol=0.0):
                failures.append(f"rank {f['rank']}: {key} {value} vs one process {ref_metrics[key]}")
    if len({f["after_digest"] for f in found}) != 1:
        failures.append("the ranks' parameters differ after the step")
    err = found[0]["grad_rel_err"]
    if not err <= DDP_GRAD_RTOL:
        failures.append(f"clipped gradients: |dg|/|g| {err:.3e} beyond {DDP_GRAD_RTOL}")
    eval_expected = {k: v * len(EVAL_LENGTHS) for k, v in PER_CLIP.items()}
    eval_launched = {k: sum(f["eval_launches"][k] for f in found) for k in PER_CLIP}
    if eval_launched != eval_expected:
        failures.append(f"sharded eval launches {eval_launched}, expected {eval_expected}")
    merged = found[0]["eval_metrics"]
    if not merged or any(not np.isclose(merged[k], one[k], equal_nan=True) for k in METRIC_KEYS):
        failures.append(f"merged eval metrics {merged} vs one process's")
    if not merged_same:
        failures.append("the merged results.json differs from one process's")
    print(f"DDP (a): {world} ranks on one card (gloo over CUDA tensors), B = {clips // world} "
          f"clip(s) each against one process's B = {clips}: clipped gradients |dg|/|g| {err:.3e} "
          f"(bound {DDP_GRAD_RTOL}), losses within rtol 1e-4 "
          f"({', '.join(f'{k} {v:.5f}' for k, v in found[0]['metrics'].items() if k != 'grad_finite')}), "
          f"parameters after the step {'bit-identical' if len({f['after_digest'] for f in found}) == 1 else 'DIFFERENT'}; "
          f"launches per rank {rank_launches}; rank step ms "
          f"{', '.join(f'{f['step_ms']:.1f}' for f in found)} (two ranks sharing the card); "
          f"gradient bucket {found[0]['bucket_bytes']} bytes; ranks {ranks_s:.1f} s (wall)")
    print(f"  sharded eval: launches per rank {[f['eval_launches'] for f in found]}, merged by rank 0: "
          f"results.json {'equal' if merged_same else 'DIFFERENT'} to one process's video for video, "
          + ", ".join(f"{k} {one[k]:.4f}" for k in METRIC_KEYS[:3]))
    if failures:
        raise AssertionError("DDP (a): " + "; ".join(failures))
    launches = {k: sum(f["launches"].get(k, 0) + f["eval_launches"].get(k, 0) for f in found)
                for k in ("k1_msda", "k2_msda_bwd", "k3_flash", "k4_nms", "k5_auction")}
    return {"launches": launches, "bucket_bytes": found[0]["bucket_bytes"]}


def write_jpeg_ytvis(root: Path, rng, videos: int, length: int, hw=DDP_FRAME_HW) -> None:
    """A YTVIS split in the builtin layout (`root/instances.json`,
    `root/JPEGImages/v<id>/*.jpg`): `videos` videos of `length` JPEG frames
    of noise, each with 3 drifting ellipses annotated on every frame."""
    from s2d_tpu_torch.data import rle
    from s2d_tpu_torch.data.jpeg import write_jpeg

    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    entries, annotations = [], []
    for vid in range(1, videos + 1):
        files = [f"v{vid}/{i:05d}.jpg" for i in range(length)]
        (root / "JPEGImages" / f"v{vid}").mkdir(parents=True, exist_ok=True)
        for name in files:
            write_jpeg(str(root / "JPEGImages" / name),
                       rng.randint(0, 256, (h, w, 3), dtype=np.uint8), quality=REAL_QUALITY)
        entries.append({"id": vid, "height": h, "width": w, "length": length, "file_names": files})
        for j in range(3):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            ry, rx = rng.uniform(0.05, 0.25) * h, rng.uniform(0.05, 0.25) * w
            vy, vx = rng.uniform(-10, 10, 2)
            segs = [rle.encode(((yy - cy - vy * i) / ry) ** 2 + ((xx - cx - vx * i) / rx) ** 2 < 1)
                    for i in range(length)]
            annotations.append({"id": 100 * vid + j, "video_id": vid, "category_id": 1,
                                "segmentations": segs, "iscrowd": 0})
    (root / "instances.json").write_text(json.dumps(
        {"videos": entries, "annotations": annotations, "categories": [{"id": 1, "name": "fg"}]}))


def launch(argv, log: Path, ranks: int, datasets: Path, timeout: int = 900) -> str:
    """`argv` (a module and its arguments) under torchrun with `ranks`
    processes on this node (or one plain process for ranks = 0); returns
    its standard output, also written to `log`."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    head = ([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(ranks),
             "--master-addr", "localhost", "--master-port", str(port)] if ranks
            else [sys.executable])
    # one host thread a process, as torchrun gives each rank: a plain
    # process then sums on the host in the ranks' order
    env = {**os.environ, "S2D_DATASETS": str(datasets.resolve()), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.getcwd(), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([*head, *argv], env=env, capture_output=True, text=True,
                          timeout=timeout)
    log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv[:3])}... exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def allreduce_timing(nbytes: int) -> None:
    """Under torchrun (`--allreduce-bytes`): one NCCL all-reduce of a float32
    bucket of `nbytes`, the median of 20 after 5 unrecorded, by CUDA events;
    rank 0 prints it as JSON."""
    from s2d_tpu_torch.parallel import dist

    group, dev = dist.init("cuda")
    try:
        bucket = torch.ones(nbytes // 4, device=dev)
        times = []
        for i in range(25):
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
            torch.distributed.all_reduce(bucket)
            end.record()
            torch.cuda.synchronize()
            if i >= 5:
                times.append(begin.elapsed_time(end))
        if group.is_main:
            print(json.dumps({"allreduce_ms": float(np.median(times)), "bytes": nbytes,
                              "ranks": group.size, "backend": group.backend}))
    finally:
        dist.shutdown()


def ddp_cli_path(bucket_bytes: int, cards=None, device="cuda", opts=()) -> None:
    """Phase 17 (b) and (c): the video CLI under `python -m
    torch.distributed.run --nproc-per-node N`, N = the cards here (NCCL when
    N >= 2), on the KD config at full width with seeded weights over a
    YTVIS set of JPEG files (DDP_TRAIN_VIDEOS videos of DDP_LENGTH frames at
    DDP_FRAME_HW, the valid split one video a rank or 4): DDP_ITERS[0] steps
    with a checkpoint, --resume to DDP_ITERS[1], then --eval-only. Checks
    one metrics.json with each iteration once (rank 0's), the checkpoints,
    the eval's results.json and metrics; with N >= 2, results.json against
    one process's video for video, one NCCL all-reduce of the gradient
    bucket and the N-rank step against one process's at the same global
    batch. `cards`, `device` ("cpu": gloo, no all-reduce timing) and `opts`
    (config overrides) are for a rehearsal off the card."""
    cards = torch.cuda.device_count() if cards is None else cards
    root = Path("build") / "chip_smoke_ddp" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    datasets = root / "datasets"
    rng = np.random.RandomState(SEED + 9)
    start = time.perf_counter()
    write_jpeg_ytvis(datasets / "ytvis_2021" / "train", rng, DDP_TRAIN_VIDEOS, DDP_LENGTH)
    write_jpeg_ytvis(datasets / "ytvis_2021" / "valid", rng, max(4, cards), DDP_LENGTH - 1)
    print(f"DDP (b): JPEG YTVIS sets written in {time.perf_counter() - start:.1f} s (host)")
    batch = 4 if 4 % cards == 0 else cards
    module = ["-m", "s2d_tpu_torch.train_net_video", "--config-file", KD_CONFIG, "--device", device]
    sets = ["DATASETS.TRAIN", '("ytvis_2021_train",)', "DATASETS.TEST", '("ytvis_2021_valid",)',
            "MODEL.WEIGHTS", '""', *opts]
    out = root / "out"
    train_opts = [*sets, "SOLVER.IMS_PER_BATCH", str(batch), "SOLVER.CHECKPOINT_PERIOD",
                  str(DDP_ITERS[0]), "TEST.EVAL_PERIOD", "0", "OUTPUT_DIR", str(out)]
    walls = []
    for i, iters in enumerate(DDP_ITERS):
        start = time.perf_counter()
        launch([*module, *(["--resume"] if i else []), *train_opts, "SOLVER.MAX_ITER", str(iters)],
               root / f"train{i}.log", cards, datasets)
        walls.append(time.perf_counter() - start)
    start = time.perf_counter()
    evaluated = launch([*module, "--eval-only", *sets, "OUTPUT_DIR", str(root / "eval_ranks")],
                       root / "eval.log", cards, datasets)
    walls.append(time.perf_counter() - start)

    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    iterations = [x["iteration"] for x in lines if "total_loss" in x]
    failures = []
    if iterations != list(range(DDP_ITERS[-1])):
        failures.append(f"metrics.json iterations {iterations}: each once, rank 0's alone")
    if any(x["grad_finite"] != 1.0 or not np.isfinite(x["total_loss"]) for x in lines):
        failures.append("a non-finite step")
    saved = sorted(p.name for p in (out / "checkpoints").iterdir())
    if saved != [str(n) for n in DDP_ITERS]:
        failures.append(f"checkpoints {saved}")
    if len([p for p in out.iterdir() if p.name.startswith("events.out")]) > len(DDP_ITERS):
        failures.append("more than one tensorboard file a run")
    results = json.loads((root / "eval_ranks" / "results.json").read_text())
    printed = [x for x in evaluated.splitlines() if x.startswith("[ytvis_2021_valid]")]
    if len(printed) != 1:
        failures.append(f"{len(printed)} metric lines from the eval's ranks, not rank 0's one")
    step_ms = [x["time"] * 1e3 for x in lines if "total_loss" in x]
    print(f"DDP (b): the CLI in {cards} process(es) under torchrun "
          f"({('NCCL' if device == 'cuda' else 'gloo') if cards > 1 else 'one process: no process group'}), "
          f"IMS_PER_BATCH {batch} "
          f"({batch // cards} a rank): metrics.json iterations {iterations} (rank 0's), checkpoints "
          f"{saved}, step ms {', '.join(f'{x:.1f}' for x in step_ms)} (metrics.json time); "
          f"eval: {len(results)} results, {printed[0] if printed else 'no metrics'}; "
          f"runs {', '.join(f'{w:.1f}' for w in walls)} s (wall)")
    print(f"DDP (c): gradient bucket {bucket_bytes} bytes ({bucket_bytes / 2**20:.1f} MiB), "
          f"one all-reduce of it a step")
    if cards < 2:
        print("DDP (b): one card here: the multi-card merge and NCCL were not exercised on "
              "this machine")
    else:
        launch([*module, "--eval-only", *sets, "OUTPUT_DIR", str(root / "eval_one")],
               root / "eval_one.log", 0, datasets)
        by_video = lambda rs: sorted(rs, key=lambda r: r["video_id"])  # noqa: E731
        one = json.loads((root / "eval_one" / "results.json").read_text())
        if by_video(one) != by_video(results):
            failures.append("the merged results.json differs from one process's")
        allreduce = {"allreduce_ms": float("nan")}
        if device == "cuda":
            timing = launch([os.path.abspath(__file__), "--allreduce-bytes", str(bucket_bytes)],
                            root / "allreduce.log", cards, datasets)
            allreduce = json.loads([x for x in timing.splitlines() if x.startswith("{")][-1])
        single = root / "one_process"
        launch([*module, *sets, "SOLVER.IMS_PER_BATCH", str(batch), "SOLVER.MAX_ITER", "2",
                "SOLVER.CHECKPOINT_PERIOD", "100", "TEST.EVAL_PERIOD", "0", "OUTPUT_DIR",
                str(single)], root / "one_process.log", 0, datasets)
        one_ms = [json.loads(x)["time"] * 1e3 for x in (single / "metrics.json").read_text().splitlines()
                  if "total_loss" in x]
        print(f"DDP (b): results.json of the {cards} ranks {'equal' if by_video(one) == by_video(results) else 'DIFFERENT'} "
              f"to one process's, video for video")
        print(f"DDP (c): one NCCL all-reduce of {bucket_bytes} bytes over {cards} cards: "
              f"{allreduce['allreduce_ms']:.3f} ms (median of 20, CUDA events); the step at "
              f"IMS_PER_BATCH {batch}: {step_ms[1]:.1f} ms in {cards} ranks against {one_ms[1]:.1f} ms "
              f"in one process (the second step of a run, metrics.json time); {card_line()}")
    if failures:
        raise AssertionError("DDP (b): " + "; ".join(failures))


def compare_checkouts(parent: Path, profile: bool) -> None:
    """Runs this script in the checkout `parent` (this file copied there
    first, so both sides run the same phases on the same inputs) and in
    this checkout, in turns parent, change, change, parent, each in its own
    process with its log under build/compare/; prints each run's key lines
    under its header, then the kernels' device times and the train step
    side by side."""
    here = Path(__file__).resolve().parent
    parent = parent.resolve()
    shutil.copyfile(Path(__file__).resolve(), parent / "chip_smoke.py")
    logs = here / "build" / "compare"
    logs.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, side in enumerate(COMPARE_ORDER):
        root = parent if side == "parent" else here
        log = logs / f"compare_{i}_{side}.log"
        cmd = [sys.executable, "chip_smoke.py", *(["--profile"] if profile else [])]
        with open(log, "w") as out:
            rc = subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=str(root),
                                                         CHIP_SMOKE_SIDE=side),
                                stdout=out, stderr=subprocess.STDOUT).returncode
        lines = log.read_text().splitlines()
        print(f"== run {i}: {side} ({root}), exit {rc}, log {log.relative_to(here)}")
        if rc != 0:
            print("\n".join(lines[-40:]))
            raise AssertionError(f"run {i} ({side}) exited {rc}")
        print("\n".join(line for line in lines if line.startswith(COMPARE_LINES)))
        step = re.search(r"train path: ([0-9.]+) ms per step", "\n".join(lines))
        runs.append((side, {k["name"]: k for k in json.loads(lines[-2])["kernels"]},
                     float(step.group(1))))
    print("== side by side (device ms a call; " + ", ".join(side for side, _, _ in runs) + ")")
    for name in runs[0][1]:
        print(f"  {name}: " + ", ".join(f"{k[name]['ms']:.4f}" for _, k, _ in runs))
    print("  train step ms: " + ", ".join(f"{ms:.1f}" for _, _, ms in runs))
    counted = [k["batched_auction"]["fixed_set"]["slowest"] for _, k, _ in runs]
    slow = next((c for c in counted if c), None)
    fixed = [k["batched_auction"]["fixed_set"]["ms"] for _, k, _ in runs]
    print(f"  K5 on the fixed set: {', '.join(f'{ms:.4f}' for ms in fixed)} ms")
    if slow:
        # the same problems and identical assignments: the same rounds on
        # both sides, as counted by the side whose plain auction counts them
        per_round = ", ".join(f"{1e3 * ms / (slow['forward'] + slow['reverse']):.3f}" for ms in fixed)
        print(f"  K5 us a round of the fixed set's slowest problem {slow}: {per_round}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one inference clip and one train step (device time "
                             "per stage, idle share)")
    parser.add_argument("--compare", type=Path, metavar="PARENT",
                        help="instead: run this script in the checkout PARENT and in this one, "
                             "in turns parent, change, change, parent, and compare them")
    parser.add_argument("--ddp-only", action="store_true",
                        help="instead: build the kernels and run phase 17 alone (training and "
                             "evaluating in several processes)")
    parser.add_argument("--allreduce-bytes", type=int, default=0,
                        help="(phase 17 runs this under torchrun) time one NCCL all-reduce")
    args = parser.parse_args(argv)
    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    if args.allreduce_bytes:
        allreduce_timing(args.allreduce_bytes)
        return 0
    if args.compare:
        print(card_line())
        compare_checkouts(args.compare, args.profile)
        return 0
    from s2d_tpu_torch import _build
    from s2d_tpu_torch.config import VideoConfig, load_config_tree
    from s2d_tpu_torch.demo_video import VideoPredictor, set_full_f32
    from s2d_tpu_torch.evaluation.inference import finalize_predictions
    from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, nms

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    set_full_f32()
    print(f"TF32 off: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    start = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - start
    print(f"build: {build_s:.2f} s ({_build._library_path().name})")

    if args.ddp_only:
        train_cfg = load_config_tree(KD_CONFIG)
        batch = train_batch(train_cfg, dev)
        class_scale = class_head_scale(train_cfg, new_train_state(train_cfg, dev), batch[0])
        torch.cuda.empty_cache()
        ddp = ddp_step_check(dev, batch, class_scale)
        ddp_cli_path(ddp["bucket_bytes"])
        print(f"chip_smoke --ddp-only: {time.perf_counter() - started:.1f} s; ddp launches "
              f"{ddp['launches']}")
        print(card)
        return 0

    # 3. kernels against their plain versions
    record = {}
    kernel_checks(dev, record)

    # 4. the inference path: REQUESTS clips through the full-width predictor
    cfg = VideoConfig()
    predictor = VideoPredictor(cfg, seed=SEED, device=dev)
    assert predictor.kernels, "the predictor must run the CUDA kernels on the card"
    rng = np.random.RandomState(SEED)
    clips = [rng.randint(0, 256, (T, IN_H, IN_W, 3), dtype=np.uint8) for _ in range(REQUESTS)]
    mods = {"k1_msda": ms_deform_attn_cuda, "k3_flash": masked_attention_cuda, "k4_nms": nms}
    for mod in mods.values():
        mod.LAUNCHES = 0
    latencies, first_out = [], None
    for i, clip in enumerate(clips):
        before = {k: m.LAUNCHES for k, m in mods.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, post = predictor.predict(clip, OUT_SIZE)
        preds = finalize_predictions(post)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        grew = {k: m.LAUNCHES - before[k] for k, m in mods.items()}
        if grew != PER_CLIP:
            raise AssertionError(f"clip {i}: launches {grew}, expected {PER_CLIP}")
        for key in ("pred_logits", "pred_masks"):
            if tuple(out[key].shape[:2]) != (1, cfg.num_queries) or not torch.isfinite(out[key]).all():
                raise AssertionError(f"clip {i}: {key} {tuple(out[key].shape)} not finite/shaped")
        if preds["masks"].shape[1:] != (T, *OUT_SIZE):
            raise AssertionError(f"clip {i}: masks {preds['masks'].shape}")
        print(f"clip {i}: {latencies[-1] * 1e3:.1f} ms, kept {len(preds['scores'])} of "
              f"{cfg.num_predictions}, launches {grew}")
        if i == 0:
            first_out = out
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    steady = latencies[1:]
    clip_ms = 1e3 * sum(steady) / len(steady)
    print(f"inference path: {clip_ms:.1f} ms per clip after the first "
          f"({', '.join(f'{t * 1e3:.1f}' for t in steady)}; {T * 1e3 / clip_ms:.2f} frames/s), "
          f"first clip {latencies[0] * 1e3:.1f} ms")
    if args.profile:
        profile_run("inference clip", lambda: predictor(clips[1], OUT_SIZE))

    # 5. the same clip on the plain path, on the card
    compare_paths(cfg, predictor, clips[0], first_out, mods)
    del predictor, first_out

    # 6. the train path: 3 full-width KD steps
    train_cfg = load_config_tree(KD_CONFIG)
    batch = train_batch(train_cfg, dev)
    print(f"train batch: images {tuple(batch[0].shape)}, targets {tuple(batch[1].shape)}, "
          f"{int(batch[2].sum())} valid slots")
    train_launches, state, step_fn, problems, class_scale = train_path(dev, train_cfg, batch)

    # 7. K5 against its plain version, on the train step's problems and more
    auction_check(dev, record, problems)
    if args.profile:
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        profile_run("train step", lambda: step_fn(state, *batch, generator=gen))
    del state, step_fn

    # 8. one train step on the plain path, from the same state
    compare_train_step(dev, batch, class_scale)
    del batch

    # 9. K6 against its plain version, then its path: the ablation tool
    ablate_checks(dev, record)
    ablate_launches = ablate_path()

    # 10. the --eval-only path: evaluate_dataset -> results.json -> AP
    eval_launches = eval_path(dev)
    if not PARENT:
        crop_check(dev)

    # 11. a reference student/teacher checkpoint through the loader
    checkpoint_path(dev)

    # 12. the train CLI: loader, steps, checkpoints, --resume, periodic eval
    cli_launches = train_cli_path(dev, class_scale)

    # 13. keymask discovery: the CLI, the trackers, the discovered set
    keymask_path(dev)

    # 14. the KD step's options through the train CLI, then kernel vs plain
    options = {}
    if not PARENT:
        start = time.perf_counter()
        options = train_options_path(dev, class_scale)
        compare_options_step(dev, class_scale)
        print(f"options phase: {time.perf_counter() - start:.1f} s")

    # 15. stage 1: the CutLER detector's CLI (train, resume, eval, TTA), K4's box NMS
    cutler = cutler_path(dev, record) if not PARENT else 0

    # 16. real inputs: JPEG files and polygon annotations through the CLIs, K4 past 4096
    real = real_inputs_path(dev, record) if not PARENT else {}

    # 17. training and evaluating in several processes: ranks on this card, the CLI under torchrun
    ddp = {}
    if not PARENT:
        start = time.perf_counter()
        ddp = ddp_step_check(dev, train_batch(train_cfg, dev), class_scale)
        ddp_cli_path(ddp["bucket_bytes"])
        print(f"DDP phase: {time.perf_counter() - start:.1f} s")

    on_options = lambda key: {"kd_options": options[key]} if options else {}  # noqa: E731
    on_real = lambda key: {"real_inputs": real[key]} if real else {}  # noqa: E731
    on_ddp = lambda key: {"ddp": ddp["launches"][key]} if ddp else {}  # noqa: E731
    by_path = {"k1_msda": {"inference": launches["k1_msda"], "train": train_launches["k1_msda"],
                           "eval": eval_launches["k1_msda"], "train_cli": cli_launches["k1_msda"],
                           **on_options("k1_msda"), **on_real("k1_msda"), **on_ddp("k1_msda")},
               "k3_flash": {"inference": launches["k3_flash"], "eval": eval_launches["k3_flash"],
                            "train_cli": cli_launches["k3_flash"], **on_real("k3_flash"),
                            **on_ddp("k3_flash")},
               "k4_nms": {"inference": launches["k4_nms"], "eval": eval_launches["k4_nms"],
                          "train_cli": cli_launches["k4_nms"], **on_options("k4_nms"),
                          **({"cutler": cutler} if not PARENT else {}), **on_real("k4_nms"),
                          **on_ddp("k4_nms")},
               "k2_msda_bwd": {"train": train_launches["k2_msda_bwd"],
                               "train_cli": cli_launches["k2_msda_bwd"], **on_options("k2_msda_bwd"),
                               **on_real("k2_msda_bwd"), **on_ddp("k2_msda_bwd")},
               "k5_auction": {"train": train_launches["k5_auction"],
                              "train_cli": cli_launches["k5_auction"], **on_options("k5_auction"),
                              **on_real("k5_auction"), **on_ddp("k5_auction")},
               **{f"k6_{v}": {"ablation": n} for v, n in ablate_launches.items()}}
    for key, paths in by_path.items():
        if not all(paths.values()):
            raise AssertionError(f"{key} was not launched on its path: {paths}")
    kernels = [dict(record[k], launches=sum(by_path[k].values()), launches_by_path=by_path[k])
               for k in ("k1_msda", "k2_msda_bwd", "k3_flash", "k4_nms", "k5_auction",
                         *(f"k6_{v}" for v in ablate_launches))]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from the start of main")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
