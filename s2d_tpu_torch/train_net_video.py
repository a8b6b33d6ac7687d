"""The video trainer and evaluator CLI of the port, as
`tools/train_net_video.py`:

    python -m s2d_tpu_torch.train_net_video --config-file cfg.yaml \
        [--resume] [--eval-only] [--weights model.pth] [--max-videos N] \
        [--profile-dir DIR] [--profile-steps N] [--device cuda] [--seed S] \
        [KEY VALUE ...]

in one process, or in W processes, one a card, under torchrun:

    python -m torch.distributed.run --nproc-per-node W \
        -m s2d_tpu_torch.train_net_video --config-file cfg.yaml ...

W processes compute what one process computes on the global batch of
SOLVER.IMS_PER_BATCH (`parallel/dist.py`, `train/trainer.py`): rank r
runs on cuda:LOCAL_RANK (NCCL; with --device cpu, gloo), takes
IMS_PER_BATCH / W clips of the shared permutation a step (a batch that does
not divide by W raises), and the gradients are summed over the ranks before
the optimizer. SOLVER.REFERENCE_WORLD_SIZE scales to W as in JAX. Every
rank builds the seeded or loaded state and rank 0's is broadcast; only rank
0 writes checkpoints, metrics.json and the tensorboard file, and --resume
reads the same checkpoint on every rank. An evaluation (--eval-only, or the
periodic one) runs each rank's shard of the videos into
results_shard<r>.json; rank 0 merges them into results.json, scores and
checks them, between two barriers.

Weights are picked as `tools/train_net_video.py` picks them:
MODEL.WEIGHT_LIST, when all its files exist, merges a student (the first
file) and a teacher (the last); else --weights or MODEL.WEIGHTS, a
reference .pth/.pkl of a student and a teacher (or of one network, for
both), or a backbone-only checkpoint grafted into the seeded init (see
`checkpoint/torch_import.py`). An .npz of the JAX package's flattened flax
params loads too (one network). Without weights, or when the file is
missing (a warning), the networks are initialised from the seed (--seed,
else SEED, else 0).

--eval-only: for every dataset of DATASETS.TEST (registered names resolve
under $S2D_DATASETS or $DETECTRON2_DATASETS) `evaluation.evaluator.
evaluate_dataset` writes `<OUTPUT_DIR>/results.json`, prints the AP
metrics, the frames/s and the per-stage seconds, and checks
TEST.EXPECTED_RESULTS (`evaluation/verify.py`). MODEL.MASK_FORMER.TEST.
EVAL_STUDENT picks the network evaluated. On a CUDA device the model runs
the K1 and K3 kernels and NMS runs K4.

Without --eval-only it trains (`train`): the KD train state, --resume from
the latest checkpoint of `<OUTPUT_DIR>/checkpoints`, the train loader over
DATASETS.TRAIN with the clip mapper and, with DATALOADER.COPY_PASTE, the
clip copy-paste (the targets bit-packed along W, and with
INPUT.DISENTANGLE_DISTILLATION_LOADER a second, distillation view of each
clip); SOLVER.MAX_ITER steps of `train.trainer.make_train_step`
(K1, K2 and K5 on a CUDA device), the metrics of each step read back after
the next is dispatched into `<OUTPUT_DIR>/metrics.json`, a checkpoint every
SOLVER.CHECKPOINT_PERIOD steps and at the end, an evaluation of DATASETS.TEST
every TEST.EVAL_PERIOD steps into `<OUTPUT_DIR>/inference_<step>`, and with
--profile-dir a `torch.profiler` trace of steps [10, 10 + --profile-steps)
of the run. A caller without an image library passes `train(...,
mapper=, eval_mapper=)` its own frames.

A DATASETS.TRAIN name that is a registered COCO set, not a YTVIS one,
trains as pseudo-clips (`data/image_datasets.py`), as in JAX.

Not ported (ROADMAP queue 1, item 1): --model-parallel > 1 and
--time-parallel: they raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

from .config import from_s2d_config, load_config_tree


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="s2d_tpu_torch video trainer and evaluator")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true", help="evaluate DATASETS.TEST only")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint under OUTPUT_DIR/checkpoints")
    parser.add_argument("--max-videos", type=int, default=None, help="cap eval videos (debug)")
    parser.add_argument(
        "--weights", default="",
        help="a reference .pth/.pkl (MODEL.MASK_FORMER.TEST.EVAL_STUDENT picks the student "
             "or the teacher to evaluate) or an .npz of flattened flax params (one network)")
    parser.add_argument("--profile-dir", default="",
                        help="write a torch.profiler trace of steps [10, 10 + --profile-steps) "
                             "into this directory")
    parser.add_argument("--profile-steps", type=int, default=3)
    parser.add_argument("--time-parallel", action="store_true",
                        help="not ported: frame-parallel eval over several devices")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="not ported beyond 1: tensor-parallel degree")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--seed", type=int, default=None,
                        help="the run's seed (init, loader, draws); default SEED, else 0")
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


def train_weights(cfg, weights: str, seed: int = 0):
    """(student, teacher) weights of the train state, as
    `tools/train_net_video.py:93-123` picks them: MODEL.WEIGHT_LIST's first
    and last file when all exist; else `weights` for both (each network of a
    student/teacher checkpoint, the one network of a plain one, or a
    backbone grafted into the seeded init); else (None, None), a seeded init
    with the teacher a copy of the student."""
    weight_list = cfg.model.weight_list
    if weight_list and all(os.path.exists(p) for p in weight_list):
        print(f"Merged checkpoints student={weight_list[0]} teacher={weight_list[-1]}")
        return weight_list[0], weight_list[-1]
    if weights and os.path.exists(weights):
        print(f"Loading weights {weights}")
        return weights, weights
    if weights:
        print(f"WARNING: weights {weights!r} not found; random init (seed {seed})")
    return None, None


def train_datasets(names, clip_len: int):
    """The records of DATASETS.TRAIN `names`, concatenated: a registered YTVIS
    set as it is; else a registered COCO set (`data/coco.get_coco_dataset`)
    as pseudo-clips of `clip_len` copies of each image
    (`data/image_datasets.coco_to_clip_record`), as
    `tools/train_net_video.py:245-260`. An unknown name raises KeyError."""
    from .data.coco import get_coco_dataset
    from .data.image_datasets import coco_to_clip_record
    from .data.ytvis import get_dataset

    dicts = []
    for name in names:
        try:
            records, _ = get_dataset(name)
        except KeyError:
            images, _ = get_coco_dataset(name)
            records = [coco_to_clip_record(r, clip_len) for r in images]
        dicts.extend(records)
    return dicts


def _check_unported(args) -> None:
    if args.time_parallel:
        raise NotImplementedError(
            "--time-parallel (frame-parallel eval) is not ported yet (ROADMAP queue 1, item 1: "
            "the frame-parallel eval)")
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 is not ported yet (ROADMAP queue 1, item 1: parallel/tp.py)")


def evaluate_sharded(predictor, dataset_name: str, output_dir: str, group, **kwargs):
    """`evaluate_dataset` on this rank's shard of the videos; in a process
    group rank 0 merges the shards and returns the merged metrics, the other
    ranks None."""
    from .evaluation.evaluator import evaluate_dataset, merge_and_score

    if group is None:
        return evaluate_dataset(predictor, dataset_name, output_dir=output_dir, **kwargs)
    evaluate_dataset(predictor, dataset_name, output_dir=output_dir, num_shards=group.size,
                     shard_index=group.rank, **kwargs)
    return merge_and_score(group, dataset_name, output_dir, kwargs.get("max_videos"))


def evaluate(cfg, args, seed: int, device, group=None) -> int:
    """--eval-only: every dataset of DATASETS.TEST, checked against
    TEST.EXPECTED_RESULTS (on rank 0 in a process group)."""
    from .demo_video import VideoPredictor
    from .evaluation.verify import verify_results

    weights = eval_weights(cfg, args.weights or cfg.model.weights, seed)
    predictor = VideoPredictor(from_s2d_config(cfg), weights=weights, seed=seed, device=device)
    if predictor.loaded:
        print(f"weights: {predictor.loaded}")
    for dataset_name in cfg.datasets.test:
        metrics = evaluate_sharded(predictor, dataset_name, cfg.output_dir, group,
                                   max_videos=args.max_videos)
        if metrics is None:
            continue
        print(f"[{dataset_name}] " + "  ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
        if cfg.test.expected_results:
            verify_results(cfg.test.expected_results, metrics)
    return 0


def _upload(batch, device):
    """A collated numpy batch -> (images, masks, valid) and the keyword
    arguments of the distillation view, if the batch has one, on `device`,
    from pinned memory and asynchronously on a CUDA device."""
    import torch

    def put(key):
        t = torch.from_numpy(batch[key])
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

    view = {}
    if "distill_images" in batch:
        view = {"distill_images": put("distill_images"), "distill_affine": put("distill_affine")}
    return [put(key) for key in ("images", "masks", "valid")], view


def train(cfg, args, seed: int, mapper=None, eval_mapper=None, device=None, group=None) -> int:
    """The train loop of `tools/train_net_video.py:223-523`, in this process
    or as a rank of `group` (see the module doc).

    mapper: record -> train sample (default: `data.mapper.ClipMapper` of
    the config, reading the record's frame files); eval_mapper: passed to
    `evaluate_dataset` for the periodic eval (default: its `EvalMapper`)."""
    import numpy as np
    import torch

    from .checkpoint.io import CheckpointWriter, latest_step, restore_checkpoint
    from .data.loader import train_loader
    from .data.mapper import ClipMapper, MapperConfig
    from .train import trainer
    from .utils.events import MetricLogger
    from .utils.profiling import StepTimer, trace

    device = torch.device(args.device) if device is None else device
    world, rank = (1, 0) if group is None else (group.size, group.rank)
    os.makedirs(cfg.output_dir, exist_ok=True)
    dicts = train_datasets(cfg.datasets.train, cfg.input.sampling_frame_num)
    if mapper is None:
        mapper = ClipMapper(MapperConfig.from_config(cfg), seed=seed)
    student_w, teacher_w = train_weights(cfg, args.weights or cfg.model.weights, seed)
    state = trainer.create_train_state(cfg, seed=seed, device=device, params=student_w,
                                       teacher_params=teacher_w)
    ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
    if args.resume:
        if group is not None:
            group.barrier("resume")  # every rank sees rank 0's last checkpoint
        step = latest_step(ckpt_dir)
        if step is not None:
            restore_checkpoint(ckpt_dir, state, step)
            print(f"Resumed from checkpoint step {step}")
    if group is not None:  # rank 0's weights and moments, bit for bit
        group.broadcast_(trainer.state_tensors(state))
    step_fn = trainer.make_train_step(cfg, group=group)

    batch_transform = None
    if cfg.dataloader.copy_paste:
        from .data.copy_paste import apply_clip_copy_paste

        cp_rng = np.random.RandomState(seed + 7)
        dl = cfg.dataloader
        batch_transform = lambda samples: apply_clip_copy_paste(  # noqa: E731
            samples, cp_rng, rate=dl.copy_paste_rate, random_num=dl.copy_paste_random_num,
            min_ratio=dl.copy_paste_min_ratio, max_ratio=dl.copy_paste_max_ratio,
            densify_sparse=dl.copy_paste_densify_sparse)

    def run_eval(step):
        """Every test dataset with the current student (EVAL_STUDENT) or
        teacher, into OUTPUT_DIR/inference_<step>; metrics as <dataset>/<key>."""
        from .demo_video import VideoPredictor

        vcfg = from_s2d_config(cfg)
        network = state.student if vcfg.eval_student else state.teacher
        predictor = VideoPredictor(vcfg, weights=network.state_dict(), device=device)
        out = {}
        for dataset_name in cfg.datasets.test:
            m = evaluate_sharded(predictor, dataset_name,
                                 os.path.join(cfg.output_dir, f"inference_{step}"), group,
                                 max_videos=args.max_videos, mapper=eval_mapper)
            if m is None:
                continue
            print(f"[eval @{step}] [{dataset_name}] "
                  + "  ".join(f"{k}: {v:.4f}" for k, v in m.items()))
            out.update({f"{dataset_name}/{k}": v for k, v in m.items()})
        return out

    logger = MetricLogger(cfg.output_dir if rank == 0 else None)
    start_iter = state.step
    ckpt_period = max(cfg.solver.checkpoint_period, 1)
    eval_period = cfg.test.eval_period
    timer = StepTimer()
    pending = None  # (iteration, device metrics, host times) awaiting readback

    def flush_pending():
        # the metrics of step N are read after step N + 1 is dispatched, so
        # the host's batch of N + 1 overlaps the device's step N
        nonlocal pending
        if pending is None:
            return
        p_it, p_metrics, times = pending
        pending = None
        logger.log(p_it, {**{k: float(v) for k, v in p_metrics.items()}, **times})

    loader = train_loader(dicts, mapper, cfg.solver.ims_per_batch // world, cfg.model.pixel_mean,
                          cfg.model.pixel_std, seed=seed, num_shards=world, shard_index=rank,
                          batch_transform=batch_transform)
    writer = CheckpointWriter(ckpt_dir) if rank == 0 else None
    profiled = contextlib.ExitStack()
    try:
        for it in range(start_iter, cfg.solver.max_iter):
            if args.profile_dir and args.profile_steps > 0:
                if it == start_iter + 10:
                    profiled.enter_context(trace(args.profile_dir))
                elif it == start_iter + 10 + args.profile_steps:
                    profiled.close()
                    print(f"profiler trace written to {args.profile_dir}")
            timer.start()
            batch = next(loader)
            timer.data_done()
            (images, masks, valid), view = _upload(batch, device)
            gen = trainer.step_generator(seed + 1, state.step, device, rank)
            state, metrics = step_fn(state, images, masks, valid, generator=gen, **view)
            timer.step_done()
            flush_pending()
            pending = (it, metrics, timer.metrics())
            done = it + 1 == cfg.solver.max_iter
            if writer is not None and ((it + 1) % ckpt_period == 0 or done):
                flush_pending()  # metrics.json stays in order before a save
                writer.save(it + 1, state)
            if eval_period > 0 and ((it + 1) % eval_period == 0 or done):
                flush_pending()
                metrics = run_eval(it + 1)
                if metrics:
                    logger.log(it, metrics)
        flush_pending()
    finally:
        profiled.close()
        loader.close()
        logger.close()
        if writer is not None:
            writer.close()
    if group is not None:
        group.barrier("checkpoints written")  # no rank ends before rank 0's last write
    return 0


def main(argv=None, mapper=None, eval_mapper=None) -> int:
    from .parallel import dist

    args = parse_args(argv)
    _check_unported(args)
    cfg = load_config_tree(args.config_file or None, args.opts)
    seed = args.seed if args.seed is not None else max(cfg.seed, 0)
    if not args.eval_only:
        from .train.scaling import apply_accum_lr_scale, auto_scale_workers

        world = int(os.environ.get("WORLD_SIZE", "1"))
        cfg = apply_accum_lr_scale(auto_scale_workers(cfg, world))
        if cfg.solver.ims_per_batch % world:  # as tools/train_net_video.py:215-218
            raise ValueError(f"SOLVER.IMS_PER_BATCH {cfg.solver.ims_per_batch} does not divide "
                             f"by the {world} processes")
    group, device = dist.init(args.device)
    try:
        if args.eval_only:
            return evaluate(cfg, args, seed, device, group)
        return train(cfg, args, seed, mapper=mapper, eval_mapper=eval_mapper, device=device,
                     group=group)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    sys.exit(main())
