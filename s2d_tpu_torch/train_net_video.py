"""The video evaluator CLI of the port: the `--eval-only` part of
`tools/train_net_video.py`.

    python -m s2d_tpu_torch.train_net_video --eval-only \
        [--config-file cfg.yaml] [--weights model.pth] [--max-videos N] \
        [--device cuda] [--seed 0] [KEY VALUE ...]

For every dataset of DATASETS.TEST (registered names resolve under
$S2D_DATASETS or $DETECTRON2_DATASETS, as in `s2d_tpu/data/ytvis.py`) it
runs `evaluation.evaluator.evaluate_dataset`, writes
`<OUTPUT_DIR>/results.json` and prints the AP metrics, the frames/s and the
per-stage seconds. On a CUDA device the model runs the K1 and K3 kernels
and NMS runs K4. The weights are picked as `tools/train_net_video.py` picks
them: MODEL.WEIGHT_LIST, when all its files exist, merges a student (the
first file) and a teacher (the last); else --weights or MODEL.WEIGHTS, a
reference .pth/.pkl of a student and a teacher (or of one network), or a
backbone-only checkpoint grafted into the seeded init (see
`checkpoint/torch_import.py`). MODEL.MASK_FORMER.TEST.EVAL_STUDENT picks
the network evaluated. An .npz of the JAX package's flattened flax params
loads too (one network, whatever the flag says). Without weights, or when
the file is missing (a warning), the model is initialised from --seed.

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
        help="a reference .pth/.pkl (MODEL.MASK_FORMER.TEST.EVAL_STUDENT picks the student "
             "or the teacher) or an .npz of flattened flax params (one network)")
    parser.add_argument("--time-parallel", action="store_true",
                        help="not ported: frame-parallel eval over several devices")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--seed", type=int, default=0, help="init seed without --weights")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides: KEY VALUE pairs")
    return parser.parse_args(argv)


def eval_weights(cfg, weights: str, seed: int = 0):
    """The weights the evaluator loads, as `tools/train_net_video.py` picks
    them (for `VideoPredictor`): with MODEL.WEIGHT_LIST's files all present,
    the student of the first (EVAL_STUDENT) or the teacher of the last, as
    the port's state_dict; else `weights` when the file exists; else None
    (a seeded init), with a warning for a missing file."""
    from .checkpoint.torch_import import load_reference_model

    weight_list = cfg.model.weight_list
    if weight_list and all(os.path.exists(p) for p in weight_list):
        student = cfg.model.mask_former.test.eval_student
        path = weight_list[0] if student else weight_list[-1]
        which = "student" if student else "teacher"
        print(f"Merged checkpoints student={weight_list[0]} teacher={weight_list[-1]}; "
              f"evaluating the {which}")
        return load_reference_model(path, which)
    if weights and not os.path.exists(weights):
        print(f"WARNING: weights {weights!r} not found; random init (seed {seed})")
        return None
    return weights or None


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
    weights = eval_weights(cfg, args.weights or cfg.model.weights, args.seed)
    predictor = VideoPredictor(from_s2d_config(cfg), weights=weights, seed=args.seed,
                               device=args.device)
    if predictor.loaded:
        print(f"weights: {predictor.loaded}")
    for dataset_name in cfg.datasets.test:
        metrics = evaluate_dataset(predictor, dataset_name, output_dir=cfg.output_dir,
                                   max_videos=args.max_videos)
        print(f"[{dataset_name}] " + "  ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
