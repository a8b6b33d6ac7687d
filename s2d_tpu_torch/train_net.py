"""The CutLER image-detector trainer and evaluator CLI of the port, as
`tools/train_net.py` (stage 1 of the S2D pipeline):

    python -m s2d_tpu_torch.train_net --config-file configs/cuts3d/... \
        [--train-dataset NAME] [--test-dataset NAME] [--eval-only] [--resume] \
        [--no-segm] [--tta] [--tta-min-sizes S ...] [--copy-paste] \
        [--copy-paste-rate R] [--output-dir DIR] [--max-iter N] [--max-images N] \
        [--image-size S] [--max-instances N] [--num-proposals N] [--base-lr LR] \
        [--lr-multiplier M] [--lr-multiplier-names NAME ...] [--device cuda]

Datasets are COCO-format image sets (`data/coco.py`: registered names
resolve under $S2D_DATASETS or $DETECTRON2_DATASETS). Without --eval-only
it trains from a seeded init (seed 0, flax's initialisers): SOLVER.MAX_ITER
optimizer steps, each the mean of IMS_PER_BATCH single-image micro-steps
(`train/cutler_trainer.py`), the images mapped on the main thread while
the card runs the previous micro-step, with --copy-paste the previous
mapped image pasted into the current one; the metrics of an optimizer step
are read back after the next one into `<output-dir>/metrics.json`; a
checkpoint (`checkpoint/io.py`, named by the micro-step) every 5000
optimizer steps and at the end; --resume continues from the latest one
(the data order restarts, as in JAX). Then, or with --eval-only from the
latest checkpoint (else the seeded init), it evaluates the test set: box AP
and, unless --no-segm, mask AP, the images mapped on a prefetch thread and
the detections read back, pasted and RLE-encoded on a finalize thread;
--tta adds the multi-scale + hflip pass (`evaluation/tta_rcnn.py`),
printed as bbox_TTA / segm_TTA.

On a CUDA device (the default) every box NMS runs K4: one a train
micro-step (the RPN's), two an eval image (the RPN's and the cascade's),
two a TTA augmentation (its boxes pass's; the mask pass runs the mask
head alone) and one for the merge. TF32 is off. A card's machine has no
cv2 or PIL, and needs neither: JPEG and PNG images are read by the port's
own codecs (`data/jpeg.py`, `data/png.py`) and polygon segmentations filled
by its native scanline fill (`data/rle.polygons_to_mask`), each equal to
cv2's.
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="s2d_tpu_torch CutLER trainer")
    p.add_argument("--config-file", default="", metavar="FILE",
                   help="d2-style CutLER yaml; explicit CLI flags override it")
    p.add_argument("--train-dataset", default=None)
    p.add_argument("--test-dataset", default=None)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-segm", action="store_true",
                   help="skip mask head training and eval (TEST.NO_SEGM)")
    p.add_argument("--tta", action="store_true",
                   help="multi-scale + hflip TTA eval pass (TEST.AUG.ENABLED)")
    p.add_argument("--tta-min-sizes", nargs="*", type=int, default=None,
                   help="override TEST.AUG.MIN_SIZES")
    p.add_argument("--copy-paste", action="store_true",
                   help="image copy-paste augmentation (DATALOADER.COPY_PASTE)")
    p.add_argument("--copy-paste-rate", type=float, default=None)
    p.add_argument("--output-dir", default="./output_cutler")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--max-images", type=int, default=None, help="cap eval images")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--max-instances", type=int, default=None)
    p.add_argument("--num-proposals", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--lr-multiplier", type=float, default=None,
                   help="SOLVER.BASE_LR_MULTIPLIER")
    p.add_argument("--lr-multiplier-names", nargs="*", default=None,
                   help="SOLVER.BASE_LR_MULTIPLIER_NAMES (substring match)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


def build_config(args):
    """(CutlerTrainerConfig, train dataset, test dataset) of the yaml and
    the flags, the flags winning."""
    from .models.cutler import CutlerConfig
    from .train.cutler_trainer import CutlerTrainerConfig, load_cutler_yaml

    yaml_fields, yaml_rcnn, yaml_datasets = {}, {}, {}
    if args.config_file:
        yaml_fields, yaml_rcnn, yaml_datasets = load_cutler_yaml(args.config_file)
    train_dataset = args.train_dataset or yaml_datasets.get("train", "imagenet_train_cls_agnostic")
    test_dataset = args.test_dataset or yaml_datasets.get("test", "cls_agnostic_coco")

    rcnn_over = dict(yaml_rcnn)
    if args.num_proposals:
        rcnn_over["num_proposals"] = args.num_proposals
    over = dict(yaml_fields)
    over["rcnn"] = CutlerConfig(**rcnn_over)
    if args.no_segm:
        over["no_segm"] = True
    if args.tta:
        over["test_aug_enabled"] = True
    if args.tta_min_sizes:
        over["test_aug_min_sizes"] = tuple(args.tta_min_sizes)
    if args.copy_paste:
        over["copy_paste"] = True
    if args.copy_paste_rate is not None:
        over["copy_paste_rate"] = args.copy_paste_rate
    if args.max_iter is not None:
        over["max_iter"] = args.max_iter
    if args.image_size is not None:
        over["image_size"] = args.image_size
        over["min_size_train"] = args.image_size
    if args.max_instances is not None:
        over["max_instances"] = args.max_instances
    if args.base_lr is not None:
        over["base_lr"] = args.base_lr
    if args.lr_multiplier is not None:
        over["base_lr_multiplier"] = args.lr_multiplier
    if args.lr_multiplier_names is not None:
        over["base_lr_multiplier_names"] = tuple(args.lr_multiplier_names)
    return CutlerTrainerConfig(**over), train_dataset, test_dataset


def _upload(array, device):
    import torch

    t = torch.from_numpy(array)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def train(model, cfg, args, train_dataset, device) -> None:
    """The train loop of `tools/train_net.py:128-202`."""
    import numpy as np

    from .checkpoint.io import CheckpointWriter, latest_step, restore_checkpoint
    from .data.coco import get_coco_dataset
    from .data.copy_paste import copy_paste_image
    from .train.cutler_trainer import (
        CutlerTrainState,
        build_cutler_optimizer,
        make_cutler_train_step,
        map_image_record,
    )
    from .utils.events import MetricLogger

    dicts, _ = get_coco_dataset(train_dataset)
    state = CutlerTrainState(model, build_cutler_optimizer(model, cfg))
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    if args.resume:
        step = latest_step(ckpt_dir)
        if step is not None:
            restore_checkpoint(ckpt_dir, state, step)
            print(f"Resumed from checkpoint step {step}")
    step_fn = make_cutler_train_step(model, cfg, state.optimizer)
    logger = MetricLogger(args.output_dir)
    writer = CheckpointWriter(ckpt_dir)
    rng = np.random.RandomState(0)
    prev_sample = None  # copy-paste source: the previous mapped image
    pending = None  # (iteration, device metrics) awaiting readback
    # `it` counts single-image micro-steps; an optimizer step (a reference
    # iteration) every `accum` of them, so MAX_ITER keeps its batch meaning
    accum = max(cfg.accum_steps, 1)
    total_micro = cfg.max_iter * accum

    def flush():
        nonlocal pending
        if pending is not None:
            p_it, p_metrics = pending
            pending = None
            logger.log(p_it, {k: float(v) for k, v in p_metrics.items()})

    try:
        while state.step < total_micro:
            record = dicts[rng.randint(len(dicts))]
            s = map_image_record(record, cfg, rng, is_train=True, normalize=False)
            if s is None:
                continue
            if cfg.copy_paste:
                # the previous unmodified image is the source
                src, prev_sample = prev_sample, s
                if src is not None:
                    s = copy_paste_image(
                        rng, s, src, rate=cfg.copy_paste_rate,
                        min_ratio=cfg.copy_paste_min_ratio,
                        max_ratio=cfg.copy_paste_max_ratio,
                        random_num=cfg.copy_paste_random_num)
            image, boxes, labels, valid, masks = (
                _upload(np.ascontiguousarray(s[k]), device)
                for k in ("image", "boxes", "labels", "valid", "masks"))
            metrics = step_fn(image[None], boxes, labels, valid, masks)
            state.step += 1
            if state.step % accum == 0:  # an optimizer step: log the previous one
                opt_it = state.step // accum
                flush()
                pending = (opt_it - 1, metrics)
                if opt_it % 5000 == 0 or opt_it == cfg.max_iter:
                    flush()  # metrics.json is never behind a resumable checkpoint
                    writer.save(state.step, state)
        flush()
    finally:
        logger.close()
        writer.close()


def load_latest(model, args) -> None:
    """--eval-only: the model of the latest checkpoint, if there is one."""
    import torch

    from .checkpoint.io import STATE_FILE, latest_step

    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    step = latest_step(ckpt_dir)
    if step is not None:
        path = os.path.join(ckpt_dir, str(step), STATE_FILE)
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["model"])
        print(f"Loaded checkpoint step {step}")


def _entries(record, boxes, scores, classes, valid, masks):
    """The detection entries of one image, and with masks their RLE entries."""
    from .data import rle as rle_codec

    preds, pred_masks = [], []
    for di, (b, sc, cl, v) in enumerate(zip(boxes, scores, classes, valid)):
        if not v:
            continue
        entry = {"image_id": record["image_id"], "category_id": int(cl),
                 "bbox": [float(x) for x in b], "score": float(sc)}
        preds.append(entry)
        if masks is not None:
            pred_masks.append({**{k: entry[k] for k in ("image_id", "category_id", "score")},
                               "segmentation": rle_codec.encode(masks[di])})
    return preds, pred_masks


def _scores(gts, preds, gt_masks, pred_masks, use_cats, suffix=""):
    from .evaluation import ytvos_eval

    metrics = {f"bbox{suffix}/{k}": v for k, v in
               ytvos_eval.evaluate_detections_boxes(gts, preds, use_cats=use_cats).items()}
    if gt_masks is not None:
        metrics.update({f"segm{suffix}/{k}": v for k, v in ytvos_eval.evaluate_detections_masks(
            gt_masks, pred_masks, use_cats=use_cats).items()})
    return metrics


def evaluate(model, cfg, args, test_dataset, device) -> dict:
    """Box AP and, unless --no-segm, mask AP over the test set; with --tta
    the TTA pass's too. Returns the metrics."""
    import torch

    from .data import rle as rle_codec
    from .data.coco import get_coco_dataset
    from .data.loader import FinalizeThread, Prefetcher
    from .train.cutler_trainer import (
        cascade_detections,
        map_image_record,
        normalize_image,
        paste_masks,
    )

    do_segm = cfg.rcnn.mask_on and not cfg.no_segm
    dicts, meta = get_coco_dataset(test_dataset)
    if args.max_images:
        dicts = dicts[: args.max_images]
    use_cats = max(len(meta["thing_classes"]), 1) > 1

    @torch.no_grad()
    def infer(image_u8):
        out = model(normalize_image(image_u8, cfg))
        return cascade_detections(out, cfg.rcnn.num_classes, cfg.score_thresh, cfg.nms_thresh,
                                  cfg.detections_per_image, with_masks=do_segm)

    gts, preds, gt_masks, pred_masks = [], [], [], []

    def finalize(record, s, det):
        boxes, scores, classes, valid = (x.cpu().numpy() for x in det[:4])
        boxes = boxes / s["scale"]
        masks = paste_masks(det[4].cpu().numpy(), boxes, s["orig_hw"]) if do_segm else None
        p, pm = _entries(record, boxes, scores, classes, valid, masks)
        preds.extend(p)
        pred_masks.extend(pm)

    fin = FinalizeThread(finalize, depth=2)
    mapped = Prefetcher(((r, map_image_record(r, cfg, is_train=False, normalize=False))
                         for r in dicts), depth=2)
    try:
        for record, s in mapped:
            if s is None:
                continue
            fin.put(record, s, infer(_upload(s["image"], device)[None]))
            for ann in record.get("annotations", []):
                gts.append({"image_id": record["image_id"], "category_id": ann["category_id"],
                            "bbox": ann["bbox"], "iscrowd": ann.get("iscrowd", 0)})
                if do_segm and ann.get("segmentation") is not None:
                    seg = ann["segmentation"]
                    if not isinstance(seg, dict):
                        seg = rle_codec.encode(rle_codec.polygons_to_mask(
                            seg, record["height"], record["width"]).astype(bool))
                    gt_masks.append({"image_id": record["image_id"],
                                     "category_id": ann["category_id"], "segmentation": seg,
                                     "iscrowd": ann.get("iscrowd", 0)})
    finally:
        mapped.close()
        fin.close()
    metrics = _scores(gts, preds, gt_masks if do_segm else None, pred_masks, use_cats)
    print(f"[{test_dataset}] " + "  ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))

    if cfg.test_aug_enabled:
        metrics.update(evaluate_tta(model, cfg, dicts, gts, gt_masks if do_segm else None,
                                    use_cats, test_dataset, device))
    return metrics


def evaluate_tta(model, cfg, dicts, gts, gt_masks, use_cats, test_dataset, device) -> dict:
    """The end-of-eval TTA pass over the same images and ground truth."""
    import numpy as np
    import torch

    from .data.mapper import load_image_robust
    from .evaluation.tta_rcnn import tta_inference
    from .train.cutler_trainer import cascade_detections, paste_masks

    @torch.no_grad()
    def infer_boxes(canvas):
        out = model(torch.from_numpy(canvas).to(device))
        return cascade_detections(out, cfg.rcnn.num_classes, cfg.score_thresh, cfg.nms_thresh,
                                  cfg.detections_per_image, with_masks=False)

    infer_masks = None
    if gt_masks is not None:
        @torch.no_grad()
        def infer_masks(canvas, boxes):
            logits = model.mask_logits_at(torch.from_numpy(canvas).to(device),
                                          torch.from_numpy(boxes).to(device))
            return torch.sigmoid(logits).cpu().numpy()

    preds, pred_masks = [], []
    for record in dicts:
        try:
            img = load_image_robust(record["file_name"]).astype(np.float32)
        except (OSError, ValueError):
            continue
        res = tta_inference(
            img, infer_boxes=infer_boxes, infer_masks=infer_masks,
            min_sizes=cfg.test_aug_min_sizes, max_size=cfg.test_aug_max_size,
            flip=cfg.test_aug_flip, pixel_mean=cfg.pixel_mean, pixel_std=cfg.pixel_std,
            nms_thresh=cfg.nms_thresh, topk=cfg.detections_per_image)
        boxes, scores, classes, valid = (x.cpu().numpy() for x in res[:4])
        masks = (paste_masks(res[4], boxes, (record["height"], record["width"]))
                 if infer_masks is not None else None)
        p, pm = _entries(record, boxes, scores, classes, valid, masks)
        preds.extend(p)
        pred_masks.extend(pm)
    metrics = _scores(gts, preds, gt_masks, pred_masks, use_cats, suffix="_TTA")
    print(f"[{test_dataset}] " + "  ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
    return metrics


def main(argv=None) -> int:
    import torch

    from .demo_video import set_full_f32
    from .models.cutler import CutlerRCNN, init_parameters

    args = parse_args(argv)
    cfg, train_dataset, test_dataset = build_config(args)
    device = torch.device(args.device)
    set_full_f32()
    os.makedirs(args.output_dir, exist_ok=True)
    model = CutlerRCNN(cfg.rcnn)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(device)
    if not args.eval_only:
        train(model, cfg, args, train_dataset, device)
    else:
        load_latest(model, args)
    evaluate(model, cfg, args, test_dataset, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
