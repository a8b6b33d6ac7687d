"""The video evaluator CLI of the port: the `--eval-only` part of
`tools/train_net_video.py`.

    python -m s2d_tpu_torch.train_net_video --eval-only \
        [--config-file cfg.yaml] [--weights params.npz] [--max-videos N] \
        [--device cuda] [--seed 0] [KEY VALUE ...]

For every dataset of DATASETS.TEST (registered names resolve under
$S2D_DATASETS or $DETECTRON2_DATASETS, as in `s2d_tpu/data/ytvis.py`) it
runs `evaluation.evaluator.evaluate_dataset`, writes
`<OUTPUT_DIR>/results.json` and prints the AP metrics, the frames/s and the
per-stage seconds. On a CUDA device the model runs the K1 and K3 kernels
and NMS runs K4. Weights are the JAX package's flax params flattened to an
.npz (see `checkpoint/from_jax.py`), as `demo_video`; without them the
model is initialised from --seed.

Training is not ported to this CLI yet (ROADMAP queue 1, item 6), and
neither is the frame-parallel eval (`--time-parallel`, queue 1, item 8):
both raise.
"""
from __future__ import annotations

import argparse
import os
import sys

from .config import from_s2d_config, load_config_tree


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="s2d_tpu_torch video evaluator")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument(
        "--eval-only", action="store_true",
        help="evaluate DATASETS.TEST (required: the train loop is not ported to this CLI)")
    parser.add_argument("--max-videos", type=int, default=None, help="cap eval videos (debug)")
    parser.add_argument(
        "--weights", default="",
        help=".npz of flattened flax params. MODEL.MASK_FORMER.TEST.EVAL_STUDENT picks "
             "between a student and a teacher weight set, and an .npz holds one: it "
             "is evaluated whichever the flag says")
    parser.add_argument("--time-parallel", action="store_true",
                        help="not ported: frame-parallel eval over several devices")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--seed", type=int, default=0, help="init seed without --weights")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides: KEY VALUE pairs")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.eval_only:
        raise NotImplementedError(
            "training through this CLI is not ported yet (ROADMAP queue 1, item 6); "
            "run with --eval-only, or use train.trainer.make_train_step")
    if args.time_parallel:
        raise NotImplementedError(
            "--time-parallel (frame-parallel eval) is not ported yet (ROADMAP queue 1, item 8)")
    from .demo_video import VideoPredictor
    from .evaluation.evaluator import evaluate_dataset

    cfg = load_config_tree(args.config_file or None, args.opts)
    weights = args.weights or cfg.model.weights
    if weights and not os.path.exists(weights):
        print(f"WARNING: weights {weights!r} not found; random init (seed {args.seed})")
        weights = ""
    predictor = VideoPredictor(from_s2d_config(cfg), weights=weights or None, seed=args.seed,
                               device=args.device)
    for dataset_name in cfg.datasets.test:
        metrics = evaluate_dataset(predictor, dataset_name, output_dir=cfg.output_dir,
                                   max_videos=args.max_videos)
        print(f"[{dataset_name}] " + "  ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
