"""Video inference with the port: `VideoPredictor` and the demo CLI.

    python -m s2d_tpu_torch.demo_video --input 'frames/*.jpg' --output out/ \
        [--config-file cfg.yaml] [--weights model.pth] [--device cuda] \
        [--confidence-threshold 0.8] [--save-masks] [opts ...]

The flags are those of `tools/demo_video.py`. A clip goes through
preprocess -> forward -> postprocess -> finalize; on a CUDA device the model
runs the MSDA (K1) and flash cross-attention (K3) kernels and NMS runs K4,
as the TPU demo turns on its Pallas kernels. Weights are a reference
checkpoint (.pth or .pkl, see `checkpoint/torch_import.py`): of a
student/teacher checkpoint, MODEL.MASK_FORMER.TEST.EVAL_STUDENT picks the
network, as `tools/demo_video.py`; a backbone-only one is grafted into the
seeded init. The JAX package's flax params flattened to an .npz (see
`checkpoint/from_jax.py`) load too. Without weights the model is
initialised from a seed. Frames are read by `data/mapper.load_image_robust`
(JPEG and PNG on the port's own codecs), resized by
`data/transforms.resize_linear` (cv2's INTER_LINEAR, bit for bit) and the
overlays and palette masks written by `data/png.write_png`, so the demo
needs neither cv2 nor PIL; only --video-input (a video file) imports cv2,
lazily, and without it raises ImportError naming the flag. Each stage of a clip is a `torch.profiler.record_function` span
(preprocess, backbone, pixel_decoder, decoder, postprocess, finalize),
which costs nothing while no profiler runs.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .checkpoint.torch_import import load_weights, needs_init
from .config import VideoConfig, load_config
from .data.mapper import load_image_robust, resize_shortest_edge
from .data.png import write_png
from .data.transforms import resize_linear
from .evaluation.inference import finalize_predictions, postprocess_video
from .models.meta_arch import build_model, preprocess_clip

# stable instance palette (RGB), as tools/demo_video.py
PALETTE = [
    (220, 20, 60), (0, 82, 0), (119, 11, 32), (0, 0, 142), (0, 0, 230),
    (106, 0, 228), (0, 60, 100), (0, 80, 100), (0, 0, 70), (250, 170, 30),
    (100, 170, 30), (220, 220, 0), (175, 116, 175), (250, 0, 30),
    (165, 42, 42), (255, 77, 255), (0, 226, 252), (182, 182, 255),
]


def set_full_f32() -> None:
    """Full-f32 convolutions and matmuls on the card: cuDNN defaults to
    TF32 for f32 convolutions, which keeps ~3 decimal digits and moves the
    port off the JAX reference. Both flags are process-global."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class VideoPredictor:
    """frames (T, H, W, 3) uint8 RGB -> finalized predictions (numpy).

    kernels=None uses the CUDA kernels exactly when `device` is a CUDA
    device; kernels=False runs the plain PyTorch twins (on any device).
    weights: anything `checkpoint.torch_import.load_weights` takes; of a
    student/teacher checkpoint the student when cfg.eval_student, else the
    teacher."""

    def __init__(self, cfg: VideoConfig | None = None, weights=None, seed: int = 0,
                 device="cuda", kernels: bool | None = None):
        self.cfg = cfg or VideoConfig()
        self.device = torch.device(device)
        on_cuda = self.device.type == "cuda"
        if on_cuda:
            set_full_f32()
        self.kernels = on_cuda if kernels is None else kernels
        self.model = build_model(
            self.cfg,
            msda_impl="cuda" if self.kernels else "plain",
            flash_cross_attention=self.kernels,
            seed=seed if needs_init(weights) else None,
        )
        self.loaded = None  # what the weights were (load_weights), None without
        if weights is not None:
            self.loaded = load_weights(self.model, weights,
                                       "student" if self.cfg.eval_student else "teacher")
        self.model.to(self.device)

    @torch.no_grad()
    def forward(self, frames_u8, frame_valid=None):
        """(model outputs, unpadded input size) for one clip. frame_valid
        (T,) bool marks the real frames of a T-bucket-padded clip: the
        decoder blocks the pad frames' keys, as JAX's."""
        cfg = self.cfg
        with record_function("preprocess"):
            images, image_size = preprocess_clip(
                frames_u8, cfg.pixel_mean, cfg.pixel_std, cfg.size_divisibility, self.device
            )
            if frame_valid is not None:
                frame_valid = torch.as_tensor(frame_valid, device=self.device)
        return self.model(images, frame_valid=frame_valid), image_size

    @torch.no_grad()
    def postprocess(self, out, image_size, output_size, num_frames: int | None = None):
        """The postprocess dict on the device; num_frames cuts the pad
        frames of a T-bucket off."""
        cfg = self.cfg
        with record_function("postprocess"):
            return postprocess_video(
                out["pred_logits"], out["pred_masks"],
                num_predictions=cfg.num_predictions, num_classes=cfg.num_classes,
                image_size=image_size, output_size=tuple(output_size),
                num_frames=num_frames, use_nms=cfg.use_nms, nms_thresh=cfg.nms_thresh,
                nms_impl="kernel" if self.kernels else "plain",
            )

    def predict(self, frames_u8, output_size: Tuple[int, int] | None = None,
                frame_valid=None, num_frames: int | None = None):
        """(model outputs, postprocess dict on the device) for one clip.
        output_size defaults to the frames' own size."""
        out, image_size = self.forward(frames_u8, frame_valid)
        return out, self.postprocess(out, image_size, output_size or image_size, num_frames)

    def __call__(self, frames_u8, output_size: Tuple[int, int] | None = None
                 ) -> Dict[str, np.ndarray]:
        post = self.predict(frames_u8, output_size)[1]
        with record_function("finalize"):
            return finalize_predictions(post)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="s2d_tpu_torch video demo")
    parser.add_argument("--config-file", default="")
    parser.add_argument("--input", default="", help="glob of frame images (sorted) for one video")
    parser.add_argument("--video-input", default="", help="video file (instead of --input)")
    parser.add_argument("--output", required=True)
    parser.add_argument("--confidence-threshold", type=float, default=0.8)
    parser.add_argument("--weights", default="",
                        help="a reference .pth/.pkl (MODEL.MASK_FORMER.TEST.EVAL_STUDENT picks "
                             "the student or the teacher) or an .npz of flattened flax params")
    parser.add_argument("--save-frames", action="store_true",
                        help="accepted as in tools/demo_video.py; overlays are always written")
    parser.add_argument("--save-masks", action="store_true")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="cap the CUDA devices used for multi-video round-robin "
                             "(0 = all)")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--seed", type=int, default=0, help="init seed without --weights")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser.parse_args(argv)


def _video_file_frames(path: str, cv2):
    """The RGB frames of a video file, by cv2.VideoCapture."""
    cap, raw = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        raw.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not raw:
        raise SystemExit(f"no frames decoded from {path!r}")
    return raw


def _videos(args):
    """[(name or None, loader)]: one video per directory when --input's glob
    matches directories, else one video of the matched frames. Frames are
    read by `load_image_robust` (JPEG and PNG on the port's own codecs)."""
    def load_files(files):
        return [load_image_robust(f) for f in files]

    if args.video_input:  # the one input that still needs cv2
        try:
            import cv2
        except ImportError:
            raise ImportError(
                f"--video-input {args.video_input!r}: reading a video file needs cv2 "
                "(opencv-python), which is not installed; pass its frames as images with "
                "--input instead") from None
        return [(None, lambda path=args.video_input: _video_file_frames(path, cv2))]
    if not args.input:
        raise SystemExit("provide --input or --video-input")
    matches = sorted(glob.glob(args.input))
    if not matches:
        raise SystemExit(f"no frames match {args.input!r}")
    if all(os.path.isdir(m) for m in matches):
        videos = []
        for d in matches:
            files = sorted(glob.glob(os.path.join(d, "*.jpg"))) + sorted(
                glob.glob(os.path.join(d, "*.png")))
            if not files:
                raise SystemExit(f"no frames under {d!r}")
            videos.append((os.path.basename(d.rstrip("/")), lambda fs=files: load_files(fs)))
        return videos
    return [(None, lambda fs=matches: load_files(fs))]


def _write_outputs(out_dir, raw, preds, threshold, save_masks):
    """The overlays (and with save_masks the palette masks) of one video as
    PNG files, the pixels `tools/demo_video.py` writes with cv2."""
    os.makedirs(out_dir, exist_ok=True)
    keep = preds["scores"] >= threshold
    scores, masks = preds["scores"][keep], preds["masks"][keep]
    for ti, frame in enumerate(raw):
        overlay = frame.astype(np.float32)
        for ni in range(len(scores)):
            color = np.asarray(PALETTE[ni % len(PALETTE)], np.float32)
            m = masks[ni, ti]
            overlay[m] = 0.5 * overlay[m] + 0.5 * color
        write_png(os.path.join(out_dir, f"frame_{ti:05d}.png"), overlay.astype(np.uint8))
        if save_masks:
            idmap = np.zeros(frame.shape[:2], np.uint8)
            for ni in range(len(scores) - 1, -1, -1):
                idmap[masks[ni, ti]] = ni + 1
            palette_img = np.zeros((*frame.shape[:2], 3), np.uint8)
            for ni in range(len(scores)):
                palette_img[idmap == ni + 1] = PALETTE[ni % len(PALETTE)]
            write_png(os.path.join(out_dir, f"mask_{ti:05d}.png"), palette_img)
    return len(scores)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.config_file or None, args.opts)
    weights = args.weights or cfg.weights
    if weights and not os.path.exists(weights):
        print(f"WARNING: weights {weights!r} not found; random init (seed {args.seed})")
        weights = ""
    devices = [torch.device(args.device)]
    if devices[0].type == "cuda" and devices[0].index is None:
        count = torch.cuda.device_count()
        if args.num_devices > 0:
            count = min(count, args.num_devices)
        devices = [torch.device("cuda", i) for i in range(max(count, 1))]
    videos = _videos(args)
    predictors = [
        VideoPredictor(cfg, weights=weights or None, seed=args.seed, device=d)
        for d in devices[: len(videos)]
    ]
    os.makedirs(args.output, exist_ok=True)
    start = time.perf_counter()
    for i, (name, load) in enumerate(videos):
        raw = load()
        oh, ow = raw[0].shape[:2]
        nh, nw = resize_shortest_edge(oh, ow, cfg.min_size_test, cfg.max_size_test)
        frames = np.stack([resize_linear(f, (nh, nw)) for f in raw])
        predictor = predictors[i % len(predictors)]
        preds = predictor(frames, output_size=(oh, ow))
        out_dir = args.output if name is None else os.path.join(args.output, name)
        n_inst = _write_outputs(out_dir, raw, preds, args.confidence_threshold, args.save_masks)
        print(f"[{name or 'video'} @ {predictor.device}] {n_inst} instances per frame")
    print(f"processed {len(videos)} video(s) on {len(predictors)} device(s) "
          f"in {time.perf_counter() - start:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
