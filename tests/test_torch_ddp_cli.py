"""The video CLI (`s2d_tpu_torch.train_net_video`) in 2 processes under
torchrun on the CPU (gloo), at a tiny width (hidden 32, 8 queries, 1
encoder layer, 2 decoder layers, 64 px) on a synthetic YTVIS set of JPEG
frames under $S2D_DATASETS: it trains 2 steps with a checkpoint and a
periodic eval at step 2, resumes to step 3, and evaluates with
--eval-only. Only rank 0 writes metrics.json and the checkpoints; every
eval is each rank's shard of the videos, merged into results.json by
rank 0, which equals a one-process --eval-only run's results.json video
for video, and its metrics. A global batch that does not divide by the
processes raises.

The ranks run torch on one thread and without the optional tensorboard
sink of the metric log (its import pulls in TensorFlow), as
tests/test_torch_train_cli.py does: torchrun starts them through
`--no-python` with a bootstrap that blocks that import."""
import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from s2d_tpu_torch import train_net_video
from s2d_tpu_torch.checkpoint import io as ckpt_io
from s2d_tpu_torch.data import rle, ytvis
from s2d_tpu_torch.data.jpeg import write_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T = 64, 80, 4
TINY_OPTS = [
    "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
    "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8",
    "MODEL.MASK_FORMER.NHEADS", "4", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
    "MODEL.MASK_FORMER.DEC_LAYERS", "2", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
    "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "MODEL.MASK_FORMER.TEST.NUM_PREDICTIONS", "4",
    "SOLVER.AMP.ENABLED", "False", "INPUT.SAMPLING_FRAME_NUM", "2",
    "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MIN_SIZE_TEST", "64", "INPUT.CROP.ENABLED", "False",
    "MODEL.WEIGHTS", '""', "DATASETS.TRAIN", '("ytvis_2021_train",)',
    "DATASETS.TEST", '("ytvis_2021_valid",)',
]
BOOTSTRAP = ("import sys; sys.modules['torch.utils.tensorboard'] = None; import torch; "
             "torch.set_num_threads(1); from s2d_tpu_torch.train_net_video import main; "
             "sys.exit(main(sys.argv[1:]))")


def _write_split(root, split, vids, seed):
    rng = np.random.RandomState(seed)
    videos, annotations = [], []
    for vid in vids:
        files = [f"v{vid}/{i:05d}.jpg" for i in range(T)]
        (root / "JPEGImages" / f"v{vid}").mkdir(parents=True)
        for f in files:
            write_jpeg(str(root / "JPEGImages" / f), rng.randint(0, 256, (H, W, 3), np.uint8),
                       quality=90)
        videos.append({"id": vid, "file_names": files, "height": H, "width": W, "length": T})
        for j in range(2):
            mask = np.zeros((H, W), bool)
            y, x = rng.randint(0, H // 2), rng.randint(0, W // 2)
            mask[y: y + 20, x: x + 24] = True
            annotations.append({"id": 10 * vid + j, "video_id": vid, "category_id": 1,
                                "segmentations": [rle.encode(mask) if i >= j else None
                                                  for i in range(T)], "iscrowd": 0})
    (root / "instances.json").write_text(json.dumps(
        {"videos": videos, "annotations": annotations, "categories": [{"id": 1, "name": "fg"}]}))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(root, *opts, flags=()):
    """The CLI in 2 processes under torchrun, started; `_wait` ends it."""
    env = {**os.environ, "S2D_DATASETS": str(root), "PYTHONPATH": REPO}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "localhost", "--master-port", str(_free_port()), "--no-python",
           sys.executable, "-c", BOOTSTRAP, "--device", "cpu", *flags, *TINY_OPTS, *opts]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc):
    """The standard output of a `_start`ed run, which must succeed."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


def _torchrun(root, *opts, flags=()):
    return _wait(_start(root, *opts, flags=flags))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread here as in the ranks: the one-process eval then sums in
    the ranks' order, and the results can be compared byte for byte."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(out):
    return [json.loads(line) for line in open(out / "metrics.json")]


def _metrics(stdout, name="ytvis_2021_valid"):
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith(f"[{name}]")]
    return dict(re.findall(r"(\S+): (-?[0-9.]+)", line))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_sets")
    _write_split(root / "ytvis_2021" / "train", "train", (1, 2, 3, 4), 0)
    _write_split(root / "ytvis_2021" / "valid", "valid", (1, 2, 3), 1)
    out = root / "out"
    _torchrun(root, "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
              "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2", "OUTPUT_DIR", str(out))
    first = _lines(out)
    _torchrun(root, "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "3",
              "SOLVER.CHECKPOINT_PERIOD", "2", "OUTPUT_DIR", str(out), flags=["--resume"])
    running = _start(root, "OUTPUT_DIR", str(root / "eval2"), flags=["--eval-only"])
    with pytest.MonkeyPatch.context() as mp:  # meanwhile, the same eval in one process
        mp.setenv("S2D_DATASETS", str(root))
        mp.setattr(ytvis, "DATASET_REGISTRY", {})
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert train_net_video.main(["--eval-only", "--device", "cpu", *TINY_OPTS,
                                         "OUTPUT_DIR", str(root / "eval1")]) == 0
    return root, out, first, _wait(running), buf.getvalue()


def test_ranks_train_resume_and_only_rank0_writes(runs):
    """One line an iteration in the one metrics.json (rank 1 writes none),
    the checkpoints of steps 2 and 3, the resumed run going on at step 2."""
    _, out, first, _, _ = runs
    assert [ln["iteration"] for ln in first if "total_loss" in ln] == [0, 1]
    assert all(ln["grad_finite"] == 1.0 for ln in first if "total_loss" in ln)
    assert [ln["iteration"] for ln in _lines(out) if "total_loss" in ln] == [0, 1, 2]
    assert sorted(os.listdir(out / "checkpoints")) == ["2", "3"]
    assert ckpt_io.latest_step(str(out / "checkpoints")) == 3
    assert not [f for f in os.listdir(out) if f.startswith("events.out")]


def test_periodic_eval_merges_the_shards(runs):
    """The eval at step 2: each rank's shard file, rank 0's merge of them in
    results.json, and one eval line in metrics.json."""
    _, out, first, _, _ = runs
    inference = out / "inference_2"
    shards = [json.loads((inference / f"results_shard{r}.json").read_text()) for r in range(2)]
    assert {r["video_id"] for r in shards[0]} <= {1, 3} and {r["video_id"] for r in shards[1]} <= {2}
    assert json.loads((inference / "results.json").read_text()) == shards[0] + shards[1]
    assert len([ln for ln in first if "ytvis_2021_valid/AP" in ln]) == 1


def test_eval_only_merge_equals_one_process(runs):
    """--eval-only in 2 ranks: the merged results.json, video for video, and
    the metrics equal one process's."""
    root, _, _, evaluated, single_out = runs
    one = _metrics(single_out)
    merged = json.loads((root / "eval2" / "results.json").read_text())
    single = json.loads((root / "eval1" / "results.json").read_text())
    by_video = lambda rs: sorted(rs, key=lambda r: r["video_id"])  # noqa: E731  (stable)
    assert by_video(merged) == by_video(single) and len(single) > 0
    two = _metrics(evaluated)
    assert {k: two[k] for k in ("AP", "AP50", "AR10")} == {k: one[k] for k in ("AP", "AP50", "AR10")}


def test_a_batch_that_does_not_divide_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="IMS_PER_BATCH 3 does not divide by the 2 processes"):
        train_net_video.main(["--device", "cpu", *TINY_OPTS, "SOLVER.IMS_PER_BATCH", "3",
                              "OUTPUT_DIR", str(tmp_path)])
