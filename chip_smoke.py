#!/usr/bin/env python3
"""Smoke run of the PyTorch port (s2d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name, power limit) and turns TF32 off for
   cuDNN convolutions and matmuls (full f32, as the JAX reference);
2. builds the CUDA kernels from s2d_tpu_torch/csrc with nvcc (sm_90a);
3. holds each kernel against its plain PyTorch twin on the card at the
   main path's shapes (K1 MSDA and K3 flash attention at atol 1e-4 in f32:
   summation order and expf differ; K4 NMS exactly) and times both;
4. drives the main path: a full-width VideoPredictor (R50, 256 hidden, 100
   queries, 6 encoder layers, 9 decoder rounds, seeded random weights)
   answers 3 requests, each a T=8 uint8 clip at 360x640 with 720x1280
   output, and checks that each clip launched K1 6 times, K3 9 times and
   K4 once and that its outputs are finite;
5. runs the first clip again on the plain PyTorch path (plain MSDA, plain
   attention, plain NMS) on the card, with the configured bf16 cast points
   and in f32, and holds it to the kernel run: the keep-set to equality, the
   logits and masks to rtol 1e-3 / atol 2e-3 where nothing quantizes the
   difference between two correct f32 paths. The decoder's attention masks
   are a hard threshold on mask logits, and the bf16 cast of mask_features
   rounds: a 1e-6 difference flips either. So the bound is held with the
   kernel path's attention-mask decisions replayed in the plain path, on
   the logits in both dtypes and on the masks in f32; the unforced errors
   and the number of decisions that differ are printed beside them.

Any failure raises (exit code != 0). The second-to-last line is the kernels'
JSON record, the last line {"ok": true, "device": {...}}. Without a CUDA
device it stops before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

T, IN_H, IN_W = 8, 360, 640
OUT_SIZE = (720, 1280)
REQUESTS = 3
SEED = 0
LEVELS = [(12, 20), (24, 40), (48, 80)]  # MSDA levels of a 384x640 padded input
PER_CLIP = {"k1_msda": 6, "k3_flash": 9, "k4_nms": 1}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


class MaskTape:
    """Records the decoder's cross-attention masks in one run and replays them
    in another. The masks are a hard threshold (sigmoid(logit) < 0.5): where
    a logit lies within rounding of 0, two correct f32 paths decide that key
    differently, and the decisions then drive the rest of the decoder apart.
    Replaying one path's decisions in the other compares their arithmetic;
    `differ` counts the decisions the replaying path would have made
    otherwise."""

    def __init__(self):
        self.masks, self.differ = [], 0

    def record(self, decoder):
        own = decoder.attention_mask

        def hook(*args, **kwargs):
            self.masks.append(own(*args, **kwargs))
            return self.masks[-1]
        decoder.attention_mask = hook

    def replay(self, decoder, force: bool):
        own, it = decoder.attention_mask, iter(self.masks)

        def hook(*args, **kwargs):
            mine, theirs = own(*args, **kwargs), next(it)
            self.differ += int((mine != theirs).sum())
            return theirs if force else mine
        decoder.attention_mask = hook

    @staticmethod
    def stop(decoder):
        del decoder.attention_mask


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
        tape = MaskTape()
        tape.record(kern.model.predictor)
        ok, pk = kern.predict(clip, OUT_SIZE)
        MaskTape.stop(kern.model.predictor)
        if kern is predictor and not all(torch.equal(ok[k], out_k[k]) for k in ("pred_logits", "pred_masks")):
            failures.append("the kernel path is not deterministic")
        for force in (False, True):
            tape.differ = 0
            tape.replay(plain.model.predictor, force)
            before = {k: m.LAUNCHES for k, m in mods.items()}
            op, pp = plain.predict(clip, OUT_SIZE)
            torch.cuda.synchronize()
            MaskTape.stop(plain.model.predictor)
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


def kernel_checks(dev, record):
    from s2d_tpu_torch.ops import masked_attention_cuda as k3
    from s2d_tpu_torch.ops import ms_deform_attn_cuda as k1
    from s2d_tpu_torch.ops import nms as k4
    from s2d_tpu_torch.ops.ms_deform_attn import ms_deform_attn_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # K1 at the encoder's shapes: B=T frames, S=Lq=5040, M=8, D=32, L=3, P=4
    s = sum(h * w for h, w in LEVELS)
    value = torch.randn(T, s, 8, 32, device=dev, generator=gen)
    ref_pts = torch.rand(T, s, 1, 3, 1, 2, device=dev, generator=gen)
    norm = torch.tensor([[w, h] for h, w in LEVELS], device=dev, dtype=torch.float32)
    offsets = 3.0 * torch.randn(T, s, 8, 3, 4, 2, device=dev, generator=gen)
    locs = (ref_pts + offsets / norm[None, None, None, :, None, :]).contiguous()
    weights = torch.softmax(torch.randn(T, s, 8, 12, device=dev, generator=gen), -1)
    weights = weights.reshape(T, s, 8, 3, 4).contiguous()
    print(f"K1 msda: value {tuple(value.shape)}, {((locs < 0) | (locs > 1)).any(-1).float().mean().item():.1%}"
          " of the points outside [0, 1]")
    got = k1.ms_deform_attn_cuda(value, LEVELS, locs, weights)
    torch.cuda.synchronize()
    err = require_close("K1 vs plain", got, ms_deform_attn_plain(value, LEVELS, locs, weights),
                      0.0, 1e-4)
    record["k1_msda"] = dict(
        name="ms_deform_attn_fwd", route="cuda", source="s2d_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        replaces="s2d_tpu/ops/ms_deform_attn_pallas.py:82", max_abs_err=err,
        ms=cuda_ms(lambda: k1.ms_deform_attn_cuda(value, LEVELS, locs, weights)),
        plain_ms=cuda_ms(lambda: ms_deform_attn_plain(value, LEVELS, locs, weights)),
    )

    # K3 at the decoder's shapes: BH=8, Q=100, Dh=32, K = T*h*w per level;
    # frames 6 and 7 are pad frames (keys blocked), query 5 fully blocked
    k3_errs = []
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
            raise AssertionError("K3: a fully blocked row must give 0")
        k3_errs.append(require_close(f"K3 vs plain (K={k_len})", got,
                                   k3.masked_attention_plain(q, kk, v, mask), 0.0, 1e-4))
    record["k3_flash"] = dict(
        name="masked_attention_fwd", route="cuda", source="s2d_tpu_torch/csrc/masked_attention.cu",
        replaces="s2d_tpu/ops/masked_attention_pallas.py:34", max_abs_err=max(k3_errs),
        ms=cuda_ms(lambda: k3.masked_cross_attention(q, kk, v, mask)),
        plain_ms=cuda_ms(lambda: k3.masked_attention_plain(q, kk, v, mask)),
    )

    # K4 at N=50 on random IoU / labels: the keep mask must match exactly
    rng = np.random.RandomState(SEED)
    for trial in range(8):
        iou = rng.rand(50, 50).astype(np.float32)
        if trial % 2:
            iou = np.round(iou * 4) / 4  # ties with the threshold
        iou = np.maximum(iou, iou.T)
        np.fill_diagonal(iou, 1.0)
        labels = rng.randint(0, 3 if trial < 4 else 1, 50)
        iou_t = torch.from_numpy(iou).to(dev)
        lab_t = torch.from_numpy(labels).to(dev)
        got = k4.greedy_mask_nms(iou_t, lab_t, 0.75)
        ref = k4.greedy_mask_nms_plain(iou_t, lab_t, 0.75)
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 keep mask differs from plain (trial {trial})")
    print("  K4 vs plain: 8 keep masks identical (N=50)")
    record["k4_nms"] = dict(
        name="greedy_nms", route="cuda", source="s2d_tpu_torch/csrc/nms.cu",
        replaces="s2d_tpu/ops/nms.py:62", max_abs_err=0.0,
        ms=cuda_ms(lambda: k4.greedy_mask_nms(iou_t, lab_t, 0.75)),
        plain_ms=cuda_ms(lambda: k4.greedy_mask_nms_plain(iou_t, lab_t, 0.75), iters=5),
    )
    for key, r in record.items():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    from s2d_tpu_torch import _build
    from s2d_tpu_torch.config import VideoConfig
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

    # 3. kernels against their twins
    record = {}
    kernel_checks(dev, record)

    # 4. the main path: 3 requests through the full-width predictor
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
    print(f"main path: {clip_ms:.1f} ms per clip after the first "
          f"({T * 1e3 / clip_ms:.2f} frames/s), first clip {latencies[0] * 1e3:.1f} ms")

    # 5. the same clip on the plain path, on the card
    compare_paths(cfg, predictor, clips[0], first_out, mods)

    kernels = [dict(record[k], launches=launches[k]) for k in ("k1_msda", "k3_flash", "k4_nms")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
