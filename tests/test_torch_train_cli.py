"""The port's train CLI (`s2d_tpu_torch.train_net_video` without
--eval-only) on the CPU at a tiny width (hidden 32, 8 queries, 1 encoder
layer, 2 decoder layers, 64 points, 64 px): metrics.json with the keys
JAX's CLI writes (tests/test_train_cli_e2e.py), checkpoints and --resume
(the restored state equal to the saved one tensor for tensor; the step
count, the LR schedule and the step's draws go on across a restart), the
periodic eval, copy-paste, the --profile-dir trace, TEST.EXPECTED_RESULTS
in --eval-only, and what raises.

A resume does not carry the data stream: the sampler's permutation, the
ClipMapper's RandomState and copy-paste's restart from their seeds, as in
JAX's CLI, so a resumed run sees the first batches of the run again. The
resume tests therefore feed one video through a mapper that returns the
same sample every time, where the data cannot differ.

The module runs torch on one thread and without the optional tensorboard
sink of the metric log (importing it pulls in TensorFlow, ~12 s): the
tests run beside others in parallel workers."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cv2

from s2d_tpu_torch import train_net_video
from s2d_tpu_torch.checkpoint import io as ckpt_io
from s2d_tpu_torch.config import load_config_tree
from s2d_tpu_torch.data import rle, ytvis
from s2d_tpu_torch.data.mapper import ClipMapper, MapperConfig
from s2d_tpu_torch.evaluation import evaluator
from s2d_tpu_torch.train import trainer

H, W, T = 64, 80, 4
TRAIN_SET, TEST_SET, ONE_VIDEO = "tiny_torch_cli_train", "tiny_torch_cli_test", "tiny_torch_cli_one"
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
# the train keys of tests/test_train_cli_e2e.py, with the step's others
TRAIN_KEYS = {"iteration", "total_loss", "loss_mask", "loss_dice", "kd_loss_mask",
              "kd_loss_dice", "grad_finite", "data_time", "time"}


def _write_set(root, name, vids, seed):
    rng = np.random.RandomState(seed)
    videos, annotations = [], []
    for vid in vids:
        files = [f"v{vid}/{i:05d}.jpg" for i in range(T)]
        (root / f"v{vid}").mkdir(parents=True)
        for f in files:
            cv2.imwrite(str(root / f), rng.randint(0, 256, (H, W, 3), np.uint8))
        videos.append({"id": vid, "file_names": files, "height": H, "width": W, "length": T})
        for j in range(2):
            mask = np.zeros((H, W), bool)
            y, x = rng.randint(0, H // 2), rng.randint(0, W // 2)
            mask[y: y + 20, x: x + 24] = True
            segs = [rle.encode(mask) if i >= j else None for i in range(T)]
            annotations.append({"id": 10 * vid + j, "video_id": vid, "category_id": 1,
                                "segmentations": segs, "iscrowd": 0})
    path = root / f"{name}.json"
    path.write_text(json.dumps({"videos": videos, "annotations": annotations,
                                "categories": [{"id": 1, "name": "fg"}]}))
    ytvis.register_ytvis(name, str(path), str(root), class_agnostic=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_no_tensorboard():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_sets")
    _write_set(root / "train", TRAIN_SET, (1, 2), 0)
    _write_set(root / "test", TEST_SET, (1, 2), 1)
    _write_set(root / "one", ONE_VIDEO, (1,), 2)
    return root


def _opts(out, max_iter, *extra, train=TRAIN_SET):
    return ["--device", "cpu", *TINY_OPTS, "DATASETS.TRAIN", f'("{train}",)',
            "DATASETS.TEST", f'("{TEST_SET}",)', "SOLVER.MAX_ITER", str(max_iter),
            "OUTPUT_DIR", str(out), *extra]


def _lines(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.json"))]


def _load(out, step):
    return torch.load(os.path.join(out, "checkpoints", str(step), ckpt_io.STATE_FILE),
                      weights_only=True)


def _fixed_mapper():
    """The tiny config's ClipMapper, its first sample of each record
    returned every time after."""
    cache = {}
    clip_mapper = ClipMapper(MapperConfig.from_config(load_config_tree(None, TINY_OPTS)), seed=0)

    def mapper(record):
        if record["video_id"] not in cache:
            cache[record["video_id"]] = clip_mapper(record)
        return cache[record["video_id"]]
    return mapper


@pytest.fixture(scope="module")
def runs(datasets, tmp_path_factory):
    """The same 3 steps twice, on one video with `_fixed_mapper`: "split"
    takes 2 steps (a checkpoint and an eval at step 2), then a resumed run
    takes the third; "whole" takes all 3 in one run. Returns (split, whole,
    split's metrics.json lines before the resume)."""
    mapper = _fixed_mapper()
    split = tmp_path_factory.mktemp("split")
    whole = tmp_path_factory.mktemp("whole")
    assert train_net_video.main(_opts(split, 2, "SOLVER.CHECKPOINT_PERIOD", "2",
                                      "TEST.EVAL_PERIOD", "2", train=ONE_VIDEO),
                                mapper=mapper) == 0
    first = _lines(split)
    assert train_net_video.main(["--resume", *_opts(split, 3, "SOLVER.CHECKPOINT_PERIOD", "2",
                                                    train=ONE_VIDEO)], mapper=mapper) == 0
    assert train_net_video.main(_opts(whole, 3, "SOLVER.CHECKPOINT_PERIOD", "3",
                                      train=ONE_VIDEO), mapper=mapper) == 0
    return split, whole, first


def test_metrics_json_has_jax_keys(runs):
    _, _, first = runs
    train = [line for line in first if "total_loss" in line]
    assert len(train) == 2 and [line["iteration"] for line in train] == [0, 1]
    for line in train:
        assert TRAIN_KEYS <= set(line)
        assert all(np.isfinite(line[k]) for k in TRAIN_KEYS) and line["grad_finite"] == 1.0
        assert 0 <= line["data_time"] <= line["time"]


def test_periodic_eval_writes_results(runs):
    split, _, first = runs
    results = json.loads((split / "inference_2" / "results.json").read_text())
    assert all(len(r["segmentations"]) == T for r in results)
    evals = [line for line in first if f"{TEST_SET}/AP" in line]
    assert len(evals) == 1 and evals[0]["iteration"] == 1


def test_checkpoints_and_resume(runs):
    """A checkpoint every CHECKPOINT_PERIOD steps and at the end of each
    run; the resumed run continued at iteration 2 and took one step, with
    Adam's count going on."""
    split, _, _ = runs
    ckpts = split / "checkpoints"
    assert ckpt_io.latest_step(str(ckpts)) == 3
    assert sorted(os.listdir(ckpts)) == ["2", "3"]
    assert [line["iteration"] for line in _lines(split) if "total_loss" in line] == [0, 1, 2]
    saved = {s: _load(split, s) for s in (2, 3)}
    assert [saved[s]["step"] for s in (2, 3)] == [2, 3]
    assert [saved[s]["optimizer"]["count"] for s in (2, 3)] == [2, 3]
    # the student moved in the resumed step
    assert any(not torch.equal(saved[2]["student"][k], saved[3]["student"][k])
               for k in saved[2]["student"])


def test_restore_is_exact(runs):
    """restore_checkpoint into a fresh state gives the saved tensors bit for
    bit: every parameter, Adam's moments and count, the teacher, the step."""
    split, _, _ = runs
    cfg = load_config_tree(None, [*TINY_OPTS, "SOLVER.MAX_ITER", "3"])
    state = trainer.create_train_state(cfg, seed=9, device="cpu", kernels=False)
    ckpt_io.restore_checkpoint(str(split / "checkpoints"), state, 2)
    saved = _load(split, 2)
    got = state.state_dict()
    assert got["step"] == 2
    for net in ("student", "teacher"):
        assert set(got[net]) == set(saved[net])
        assert all(torch.equal(got[net][k], saved[net][k]) for k in saved[net])
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(got["optimizer"][key],
                                                      saved["optimizer"][key], strict=True))
    assert (state.optimizer.count, state.optimizer.mini_step) == (2, 0)


def test_resume_carries_state_schedule_and_draws(runs):
    """On a data stream that cannot differ (`_fixed_mapper`), 2 steps + a
    resumed 1 end in the state 3 steps in one run reach, bit for bit: the
    state, the step count, the LR schedule and the step's draws go on
    across the restart (the eval between the steps changes nothing). The
    data order does not: it restarts, as JAX's does (module docstring)."""
    split, whole, _ = runs
    a, b = _load(whole, 3), _load(split, 3)
    assert a["step"] == b["step"] == 3 and a["optimizer"]["count"] == b["optimizer"]["count"] == 3
    for net in ("student", "teacher"):
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net]), net
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["optimizer"][key], b["optimizer"][key]))
    losses = [[line["total_loss"] for line in _lines(d) if "total_loss" in line]
              for d in (whole, split)]
    assert losses[0] == losses[1]


def test_profile_dir_writes_a_trace(datasets, tmp_path, capsys):
    """--profile-dir traces steps [10, 10 + --profile-steps) of the run
    into trace.json, closed when the window ends; the run goes on."""
    out, logdir = tmp_path / "out", tmp_path / "trace"
    argv = ["--profile-dir", str(logdir), "--profile-steps", "1",
            *_opts(out, 12, "SOLVER.CHECKPOINT_PERIOD", "12", train=ONE_VIDEO)]
    assert train_net_video.main(argv, mapper=_fixed_mapper()) == 0
    assert "profiler trace written" in capsys.readouterr().out
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert [line["iteration"] for line in _lines(out)] == list(range(12))


@pytest.mark.parametrize("expected,passes", [((-1.0, 2.0), True), ((5.0, 0.5), False)])
def test_eval_only_checks_expected_results(datasets, tmp_path, capsys, monkeypatch, expected,
                                           passes):
    """A real evaluation passes its wide bound; outside a bound it raises
    (there the evaluator is stubbed: the check reads only its metrics)."""
    value, tol = expected
    argv = ["--eval-only", "--device", "cpu", *TINY_OPTS, "DATASETS.TEST", f'("{TEST_SET}",)',
            "OUTPUT_DIR", str(tmp_path), "TEST.EXPECTED_RESULTS",
            f'[["segm", "AP", {value}, {tol}]]']
    if passes:
        assert train_net_video.main(argv) == 0
        assert "segm/AP: actual" in capsys.readouterr().out
    else:
        monkeypatch.setattr(evaluator, "evaluate_dataset", lambda *args, **kwargs: {"AP": 0.25})
        with pytest.raises(AssertionError, match="Result verification failed"):
            train_net_video.main(argv)


@pytest.mark.parametrize("flags,opts,match", [
    (["--model-parallel", "2"], [], "queue 1, item 1"),
    (["--time-parallel"], [], "queue 1, item 1"),
])
def test_what_is_not_ported_raises(datasets, tmp_path, flags, opts, match):
    with pytest.raises(NotImplementedError, match=match):
        train_net_video.main([*flags, "--device", "cpu", *TINY_OPTS, "OUTPUT_DIR", str(tmp_path),
                              *opts])


def test_an_unknown_train_set_raises(datasets, tmp_path):
    """A DATASETS.TRAIN name that is neither a YTVIS nor a COCO set raises
    KeyError, as in JAX (a COCO set trains as pseudo-clips:
    tests/test_torch_pseudo_clips.py)."""
    with pytest.raises(KeyError, match="no_such_set"):
        train_net_video.main(["--device", "cpu", *TINY_OPTS, "OUTPUT_DIR", str(tmp_path),
                              "DATASETS.TRAIN", '("no_such_set",)'])


def test_more_than_one_process_raises(monkeypatch, tmp_path):
    """In more than one process a global batch (IMS_PER_BATCH 1 here) that
    does not divide by the processes raises, before any process group is
    made (the processes themselves: tests/test_torch_ddp_cli.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="does not divide by the 2 processes"):
        train_net_video.main(["--device", "cpu", *TINY_OPTS, "OUTPUT_DIR", str(tmp_path)])


class _State:
    def __init__(self, value):
        self.value = value

    def state_dict(self):
        return {"step": 1, "x": self.value}


def test_checkpoint_writer_write_error_surfaces_at_close(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    writer = ckpt_io.CheckpointWriter(str(tmp_path))
    monkeypatch.setattr(ckpt_io.torch, "save", broken)
    writer.save(1, _State(torch.ones(3)))
    with pytest.raises(OSError, match="disk full"):
        writer.close()
    assert ckpt_io.latest_step(str(tmp_path)) is None  # no partial checkpoint counts


def test_checkpoint_writer_snapshots_and_keeps_order(tmp_path):
    """save() copies the state before returning: a later in-place change
    does not reach the file; a second save waits for the first."""
    value = torch.zeros(4)
    with ckpt_io.CheckpointWriter(str(tmp_path)) as writer:
        writer.save(1, _State(value))
        value.add_(1.0)
        writer.save(2, _State(value))
    one = torch.load(tmp_path / "1" / ckpt_io.STATE_FILE, weights_only=True)["x"]
    two = torch.load(tmp_path / "2" / ckpt_io.STATE_FILE, weights_only=True)["x"]
    assert torch.equal(one, torch.zeros(4)) and torch.equal(two, torch.ones(4))
    (tmp_path / "7.tmp").mkdir()  # an unfinished write is not a checkpoint
    assert ckpt_io.latest_step(str(tmp_path)) == 2
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore_checkpoint(str(tmp_path / "none"), None)


def test_train_path_with_copy_paste_runs_without_jax_cv2_or_pil(datasets, tmp_path):
    """With jax, s2d_tpu, yaml, cv2 and PIL blocked on import, the CLI trains
    a step with copy-paste on and evaluates, on frames handed in through
    `mapper=` (the train ClipMapper's reader) and `eval_mapper=`: no image
    file is read, and the copy-paste transform runs on the batches."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 's2d_tpu',\n"
        "                                  'cv2', 'PIL', 'tensorboard'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from s2d_tpu_torch import train_net_video\n"
        "from s2d_tpu_torch.config import load_config_tree\n"
        "from s2d_tpu_torch.data import copy_paste, ytvis\n"
        "from s2d_tpu_torch.data.mapper import ClipMapper, MapperConfig\n"
        f"for name, sub in (({TRAIN_SET!r}, 'train'), ({TEST_SET!r}, 'test')):\n"
        f"    ytvis.register_ytvis(name, {str(datasets)!r} + f'/{{sub}}/{{name}}.json', 'none', True)\n"
        f"opts = {TINY_OPTS!r} + ['DATASETS.TRAIN', '(\"{TRAIN_SET}\",)',\n"
        f"    'DATASETS.TEST', '(\"{TEST_SET}\",)', 'SOLVER.MAX_ITER', '1',\n"
        "    'SOLVER.IMS_PER_BATCH', '2', 'DATALOADER.COPY_PASTE', 'True',\n"
        f"    'TEST.EVAL_PERIOD', '1', 'OUTPUT_DIR', {str(tmp_path)!r}]\n"
        "pasted = []\n"
        "own = copy_paste.apply_clip_copy_paste\n"
        "def counted(samples, rng, **kw):\n"
        "    out = own(samples, rng, **kw)\n"
        "    pasted.append(sum(not np.array_equal(o['masks'], s['masks'])\n"
        "                      for o, s in zip(out, samples)))\n"
        "    return out\n"
        "copy_paste.apply_clip_copy_paste = counted\n"
        "frames = np.random.RandomState(0).randint(0, 256, (4, 64, 80, 3), np.uint8)\n"
        "cfg = load_config_tree(None, opts)\n"
        "train = ClipMapper(MapperConfig.from_config(cfg), seed=0,\n"
        "                   read_frames=lambda record, idx: [frames[i] for i in idx])\n"
        "assert train_net_video.main(['--device', 'cpu'] + opts, mapper=train,\n"
        "                            eval_mapper=lambda record: {'image': frames}) == 0\n"
        "assert pasted and sum(pasted) > 0, pasted\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "inference_1" / "results.json").exists()
    assert (tmp_path / "checkpoints" / "1" / ckpt_io.STATE_FILE).exists()
    assert len(_lines(tmp_path)) == 2  # the step and the eval
