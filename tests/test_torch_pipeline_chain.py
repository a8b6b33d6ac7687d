"""The whole S2D pipeline through the port's CLIs only, each stage consuming
the previous stage's file (the counterpart of tests/test_pipeline_chain_e2e.py):

  keymask discovery (frames + stage-1 mask PNGs -> per-video JSONs)
    -> merge_ytvis_jsons (-> dataset.json)
    -> one train step on the discovered keymasks
    -> --eval-only inference (results.json)
    -> convert_results_to_annotations (round-2 annotations)
    -> one KD self-distillation step on them

on the CPU at a tiny width (the train CLI's tiny model of
tests/test_torch_train_cli.py, torch on one thread). It pins the interfaces:
every artifact is loadable, not empty, and accepted as it is by the next
stage."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from s2d_tpu_torch import keymask_ident, train_net_video
from s2d_tpu_torch.data import ytvis
from s2d_tpu_torch.data.png import write_png
from s2d_tpu_torch.tools import convert_results_to_annotations, merge_ytvis_jsons

H, W, T, SIZE = 64, 96, 4, 24
TINY_OPTS = [
    "SOLVER.IMS_PER_BATCH", "1",
    "MODEL.MASK_FORMER.HIDDEN_DIM", "32",
    "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
    "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32",
    "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8",
    "MODEL.MASK_FORMER.NHEADS", "4",
    "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
    "MODEL.MASK_FORMER.DEC_LAYERS", "2",
    "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
    "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64",
    "MODEL.MASK_FORMER.TEST.NUM_PREDICTIONS", "4",
    "SOLVER.AMP.ENABLED", "False",
    "INPUT.SAMPLING_FRAME_NUM", "2",
    "INPUT.MIN_SIZE_TRAIN", "(64,)",
    "INPUT.MIN_SIZE_TEST", "64",
    "INPUT.CROP.ENABLED", "False",
    "MODEL.WEIGHTS", '""',
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_no_tensorboard():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """Two videos of a bright textured square moving over dark noise, PNG
    frames, and colour-PNG masks standing in for the stage-1 frame masks."""
    root = tmp_path_factory.mktemp("torch_chain")
    for vid in range(2):
        name = f"vid{vid}"
        (root / "frames" / name).mkdir(parents=True)
        (root / "masks" / name).mkdir(parents=True)
        rng = np.random.RandomState(vid)
        bg = rng.randint(0, 80, (H, W, 3), np.uint8)
        patch = rng.randint(120, 255, (SIZE, SIZE, 3), np.uint8)
        y0 = (H - SIZE) // 2
        for fi in range(T):
            x0 = 6 + fi * 3
            frame = bg.copy()
            frame[y0:y0 + SIZE, x0:x0 + SIZE] = patch
            write_png(str(root / "frames" / name / f"{fi:05d}.png"), frame)
            mask = np.zeros((H, W, 3), np.uint8)
            mask[y0:y0 + SIZE, x0:x0 + SIZE] = (255, 0, 0)
            write_png(str(root / "masks" / name / f"{fi:05d}.png"), mask)
    return root


def _train_lines(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(line) for line in f if "total_loss" in line]


def test_pipeline_chain(stage1, tmp_path):
    frames_root = str(stage1 / "frames")

    # stage 2: keymask discovery, then the merge tool
    disco = tmp_path / "disco"
    assert keymask_ident.main([
        "--frames-root", frames_root, "--masks-root", str(stage1 / "masks"),
        "--output-root", str(disco), "--device", "cpu", "--grid-size", "16",
        "--dbscan-min-samples", "2", "--matching-threshold", "0.3"]) == 0
    dataset_json = str(tmp_path / "dataset.json")
    assert merge_ytvis_jsons.main(["--input-dir", str(disco / "annotations"),
                                   "--output", dataset_json]) == 0
    with open(dataset_json) as f:
        merged = json.load(f)
    assert len(merged["videos"]) == 2 and merged["annotations"]
    ytvis.register_ytvis("torch_chain_keymasks", dataset_json, frames_root, class_agnostic=True)

    # stage 3: one train step on the discovered keymasks
    sparse = str(tmp_path / "sparse")
    assert train_net_video.main([
        "--device", "cpu", *TINY_OPTS, "DATASETS.TRAIN", '("torch_chain_keymasks",)',
        "SOLVER.MAX_ITER", "1", "OUTPUT_DIR", sparse]) == 0
    assert np.isfinite(_train_lines(sparse)[-1]["total_loss"])

    # stage 3b: --eval-only inference over the same videos
    evaluated = str(tmp_path / "eval")
    assert train_net_video.main([
        "--eval-only", "--device", "cpu", *TINY_OPTS,
        "DATASETS.TEST", '("torch_chain_keymasks",)', "OUTPUT_DIR", evaluated]) == 0
    results_json = os.path.join(evaluated, "results.json")
    with open(results_json) as f:
        assert json.load(f), "the eval made no predictions"

    # stage 4a: round-2 densification of the results
    dense_json = str(tmp_path / "dense.json")
    assert convert_results_to_annotations.main([
        "--results", results_json, "--gt-json", dataset_json, "--output", dense_json,
        "--score-threshold", "0.0"]) == 0
    with open(dense_json) as f:
        dense = json.load(f)
    assert dense["videos"] and dense["annotations"]
    ytvis.register_ytvis("torch_chain_dense", dense_json, frames_root, class_agnostic=True)

    # stage 4b: one KD self-distillation step on the converted set
    kd = str(tmp_path / "kd")
    assert train_net_video.main([
        "--device", "cpu", *TINY_OPTS, "DATASETS.TRAIN", '("torch_chain_dense",)',
        "SOLVER.MAX_ITER", "1", "OUTPUT_DIR", kd]) == 0
    last = _train_lines(kd)[-1]
    assert np.isfinite(last["total_loss"]) and "kd_loss_mask" in last
