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
   products and exp differ), K4 NMS (exactly, at N = 1, 50, 64, 65 and
   1024 with label ties; timed at the main path's N = 50 beside the device
   time of an empty kernel launch, its floor), K2 MSDA backward at the
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
   the frames/s and the stage seconds, then runs the same videos on the
   plain path and requires identical keep-sets and labels, printing the
   share of mask pixels that differ;
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
   under build/ and removed at the end of the phase.
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
NMS_SIZES = (1, 50, 64, 65, 1024)  # K4: one, the main path's, 32-bit word edges, the most
K2_CALLS = 3  # K2 calls on one input that must agree bit for bit
# --compare runs the parent's checkout with this variable set: the checks of
# what the parent does not have yet print their result without failing
PARENT = os.environ.get("CHIP_SMOKE_SIDE") == "parent"
TRACKS = 25  # NMS survivors `spread_queries` aims the eval weights at
# phase 12: the train CLI's synthetic train set (videos, frames a video,
# instances a video), its test set's video lengths, and MAX_ITER of the
# first run and of the resumed one
TRAIN_SET_VIDEOS, TRAIN_SET_LENGTH, TRAIN_SET_INSTANCES = 6, 10, (3, 8)
CLI_EVAL_LENGTHS = (8, 5)
CLI_ITERS = (4, 6)
MIN_TRACKS = 10  # NMS survivors the eval phase needs in each video
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
    sleep_s = min(MAX_SLEEP_S, 2e-3 * iters * host_ms(fn, 2, 1))
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
    for n in NMS_SIZES:
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
    print(f"  K4 vs plain: 8 keep masks identical at each N of {NMS_SIZES}")
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


def expected_launches(cfg) -> dict:
    """Kernel launches of one KD step on the card: K1 in the teacher and the
    student forward, and again when the backward recomputes the encoder
    layers; K2 in the student's backward; one K5 auction."""
    enc = cfg.model.sem_seg_head.transformer_enc_layers
    return {"k1_msda": enc * (3 if cfg.solver.grad_checkpoint else 2),
            "k2_msda_bwd": enc, "k5_auction": 1}


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
    id (no image file is written: the card has no cv2) and prints the host
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


def run_eval(predictor, frames, out_dir: Path, counters=None):
    """evaluate_dataset over EVAL_DATASET with the frames injected; records
    each video's keep-set and labels (device tensors, no sync) and, with
    `counters`, its kernel launches. Returns (metrics, results, per video
    [(keep, labels)], per video launches)."""
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
                                   mapper=lambda record: {"image": frames[record["video_id"]]})
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
                                          if k.startswith("stage_s/")))
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

    def make_train_step(cfg_, kernels=True):
        step_fn = own_make(cfg_, kernels)

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


COMPARE_ORDER = ("parent", "change", "change", "parent")
# the lines of a run's log that the comparison prints under the run's header
COMPARE_LINES = ("inference path:", "train path:", "profiled", "device ms per span",
                 "  K5 on", "  K5:", "  K6 empty vs", "  ms_deform_attn_bwd:", "  batched_auction:",
                 "  ms_deform_attn_fwd:", "eval path:", "K2 d", "K2 gradient hash", "build:",
                 "  K4 at N=50", "  greedy_nms:", "  K6 ", "checkpoint", "  EVAL_STUDENT",
                 "train CLI", "keymask", "  correlation tracker", "  cotracker")


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
    args = parser.parse_args(argv)
    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
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

    # 11. a reference student/teacher checkpoint through the loader
    checkpoint_path(dev)

    # 12. the train CLI: loader, steps, checkpoints, --resume, periodic eval
    cli_launches = train_cli_path(dev, class_scale)

    # 13. keymask discovery: the CLI, the trackers, the discovered set
    keymask_path(dev)

    by_path = {"k1_msda": {"inference": launches["k1_msda"], "train": train_launches["k1_msda"],
                           "eval": eval_launches["k1_msda"], "train_cli": cli_launches["k1_msda"]},
               "k3_flash": {"inference": launches["k3_flash"], "eval": eval_launches["k3_flash"],
                            "train_cli": cli_launches["k3_flash"]},
               "k4_nms": {"inference": launches["k4_nms"], "eval": eval_launches["k4_nms"],
                          "train_cli": cli_launches["k4_nms"]},
               "k2_msda_bwd": {"train": train_launches["k2_msda_bwd"],
                               "train_cli": cli_launches["k2_msda_bwd"]},
               "k5_auction": {"train": train_launches["k5_auction"],
                              "train_cli": cli_launches["k5_auction"]},
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
