"""The port's keymask discovery CLI (`python -m s2d_tpu_torch.keymask_ident`)
and its round-2 tools against the JAX package's (`tools/keymask_ident.py`,
`tools/merge_ytvis_jsons.py`, `tools/convert_results_to_annotations.py`),
in one process, on one tiny on-disk tree: a video of cv2-written JPEG frames
and one of PNG frames, each a textured square moving over a textured
background with a static second object, and cv2-written colour-mask PNGs
(one frame's masks missing). Both CLIs must write equal per-video JSONs,
equal dataset.json and candidate PNGs of equal pixels. Then what the JAX
tool also does: skip-if-exists, --job-id/--videos-per-job, a broken video
counted as failed; the CoTracker backend with an upstream-shaped
checkpoint; no silent CPU run without a card; and the import rule: with
jax, s2d_tpu, sklearn, yaml, cv2 and PIL blocked the port runs the whole
tree, its JPEG video on the port's own codec.

Video ids are `abs(hash(name)) % 10**8`, as in the JAX tool: equal within
this process, not across processes."""
import json
import os
import re
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from s2d_tpu_torch import keymask_ident
from s2d_tpu_torch.keymask import cotracker
from s2d_tpu_torch.tools import convert_results_to_annotations as port_convert
from s2d_tpu_torch.tools import merge_ytvis_jsons as port_merge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_results_to_annotations as jax_convert  # noqa: E402
import keymask_ident as jax_cli  # noqa: E402
import merge_ytvis_jsons as jax_merge  # noqa: E402

H, W, T, SIZE = 64, 96, 5, 22
ARGS = ["--grid-size", "16", "--dbscan-min-samples", "2", "--matching-threshold", "0.3",
        "--matching-min-samples", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the tests run beside others in parallel workers,
    where OpenMP threads of every worker would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_video(frames_root, masks_root, name, seed, ext):
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 90, (H, W, 3), np.uint8)
    patch = rng.randint(120, 255, (SIZE, SIZE, 3), np.uint8)
    (frames_root / name).mkdir(parents=True)
    (masks_root / name).mkdir(parents=True)
    for fi in range(T):
        y, x = 20 + (fi % 2), 6 + 3 * fi
        frame = bg.copy()
        frame[y:y + SIZE, x:x + SIZE] = patch
        frame[4:16, 70:90] = 200  # a static object
        cv2.imwrite(str(frames_root / name / f"{fi:05d}.{ext}"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 95])
        if fi == 3 and seed == 1:
            continue  # a frame without its mask PNG
        mask = np.zeros((H, W, 3), np.uint8)
        mask[y:y + SIZE, x:x + SIZE] = (255, 0, 0)
        mask[4:16, 70:90] = (0, 128, 255)
        cv2.imwrite(str(masks_root / name / f"{fi:05d}.png"), cv2.cvtColor(mask, cv2.COLOR_RGB2BGR))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("keymask_cli")
    _write_video(root / "frames", root / "masks", "vid0", 0, "jpg")
    _write_video(root / "frames", root / "masks", "vid1", 1, "png")
    return root


def _run_jax(tree, out, *extra):
    return jax_cli.main(["--frames-root", str(tree / "frames"), "--masks-root",
                         str(tree / "masks"), "--output-root", str(out), *ARGS, *extra])


def _run_port(tree, out, *extra):
    return keymask_ident.main(["--frames-root", str(tree / "frames"), "--masks-root",
                               str(tree / "masks"), "--output-root", str(out), "--device", "cpu",
                               *ARGS, *extra])


@pytest.fixture(scope="module")
def runs(tree):
    assert _run_jax(tree, tree / "jax", "--merge") == 0
    assert _run_port(tree, tree / "port", "--merge") == 0
    return tree / "jax", tree / "port"


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_outputs_equal_jax(runs):
    jax_out, port_out = runs
    for name in ("vid0", "vid1"):
        want = _json(jax_out / "annotations" / f"{name}.json")
        assert _json(port_out / "annotations" / f"{name}.json") == want
        assert want["annotations"], f"{name}: the moving square is discovered"
    merged = _json(port_out / "dataset.json")
    assert merged == _json(jax_out / "dataset.json")
    assert [v["file_names"][0] for v in merged["videos"]] == ["vid0/00000.jpg", "vid1/00000.png"]
    for name in ("vid0", "vid1"):
        files = sorted(os.listdir(jax_out / "candidates" / name))
        assert files and sorted(os.listdir(port_out / "candidates" / name)) == files
        for f in files:
            np.testing.assert_array_equal(
                cv2.imread(str(port_out / "candidates" / name / f), cv2.IMREAD_UNCHANGED),
                cv2.imread(str(jax_out / "candidates" / name / f), cv2.IMREAD_UNCHANGED))


def test_skip_if_exists_and_job_slicing(tree, runs, capsys, tmp_path):
    _, port_out = runs
    before = {p: os.path.getmtime(port_out / "annotations" / p)
              for p in os.listdir(port_out / "annotations")}
    capsys.readouterr()
    assert _run_port(tree, port_out) == 0
    assert "0 ok, 0 failed, 2 skipped" in capsys.readouterr().out
    assert before == {p: os.path.getmtime(port_out / "annotations" / p) for p in before}
    for run, out in ((_run_port, tmp_path / "p"), (_run_jax, tmp_path / "j")):
        assert run(tree, out, "--job-id", "1", "--videos-per-job", "1") == 0
        assert os.listdir(out / "annotations") == ["vid1.json"]
    assert _json(tmp_path / "p" / "annotations" / "vid1.json") == _json(
        tmp_path / "j" / "annotations" / "vid1.json")


def test_broken_video_counts_as_failed(tree, tmp_path, capsys):
    broken = tmp_path / "tree"
    shutil.copytree(tree / "frames", broken / "frames", ignore=shutil.ignore_patterns("vid0"))
    shutil.copytree(tree / "masks", broken / "masks")
    (broken / "frames" / "bad").mkdir()
    (broken / "frames" / "bad" / "00000.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    for run, out in ((_run_port, tmp_path / "p"), (_run_jax, tmp_path / "j")):
        capsys.readouterr()
        assert run(broken, out, "--merge") == 0
        captured = capsys.readouterr()
        assert "1 ok, 1 failed, 0 skipped" in captured.out
        assert "FAILED bad" in captured.err
        if run is _run_port:  # the tracker's totals over the run
            assert re.search(r"^tracker: [1-9]\d* point-frames in ", captured.out, re.M)
        assert len(_json(out / "dataset.json")["videos"]) == 1


def test_round_two_tools_equal_jax(runs, tmp_path):
    jax_out, port_out = runs
    ann_dir = str(port_out / "annotations")
    for one2x in ([], ["--one2x-threshold", "0"]):
        assert port_merge.main(["--input-dir", ann_dir, "--output", str(tmp_path / "p.json"),
                                *one2x]) == 0
        assert jax_merge.main(["--input-dir", ann_dir, "--output", str(tmp_path / "j.json"),
                               *one2x]) == 0
        assert _json(tmp_path / "p.json") == _json(tmp_path / "j.json")
    with pytest.raises(SystemExit, match="no JSONs"):
        port_merge.main(["--input-dir", str(tmp_path / "none"), "--output", str(tmp_path / "x")])
    merged = _json(port_out / "dataset.json")
    results = [{"video_id": a["video_id"], "score": s, "category_id": 1,
                "segmentations": a["segmentations"]}
               for a, s in zip(merged["annotations"] * 2, (0.9, 0.3, 0.75, 0.8))]
    (tmp_path / "results.json").write_text(json.dumps(results))
    for threshold in ([], ["--score-threshold", "0.5"]):
        common = ["--results", str(tmp_path / "results.json"), "--gt-json",
                  str(port_out / "dataset.json"), *threshold]
        assert port_convert.main([*common, "--output", str(tmp_path / "pc.json")]) == 0
        assert jax_convert.main([*common, "--output", str(tmp_path / "jc.json")]) == 0
        assert _json(tmp_path / "pc.json") == _json(tmp_path / "jc.json")
        assert _json(tmp_path / "pc.json")["annotations"]


def test_cotracker_backend_with_a_checkpoint(tree, tmp_path):
    """--tracker cotracker at the full width (384x512, random weights from
    seed 1 written as an upstream-shaped .pth): the run completes; a
    checkpoint of the wrong layout raises before any video."""
    sd = cotracker.to_torch_state_dict(cotracker.init_params(cotracker.CoTrackerNet(), 1)
                                       .state_dict())
    good = tmp_path / "ct.pth"
    torch.save({"model." + k: torch.from_numpy(v) for k, v in sd.items()}, str(good))
    assert _run_port(tree, tmp_path / "out", "--tracker", "cotracker", "--tracker-checkpoint",
                     str(good), "--videos-per-job", "1") == 0
    assert os.listdir(tmp_path / "out" / "annotations") == ["vid0.json"]
    sd.pop("time_emb")
    bad = tmp_path / "bad.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(bad))
    with pytest.raises(ValueError, match="missing in checkpoint: \\['time_emb'\\]"):
        _run_port(tree, tmp_path / "bad", "--tracker", "cotracker", "--tracker-checkpoint",
                  str(bad))


def test_cuda_without_a_card_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        keymask_ident.main(["--frames-root", str(tree / "frames"), "--masks-root",
                            str(tree / "masks"), "--output-root", str(tmp_path)])
    assert not os.path.exists(tmp_path / "annotations")


def test_runs_without_jax_sklearn_cv2_or_pil(tree, tmp_path):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 's2d_tpu',\n"
        "                                  'sklearn', 'scipy', 'cv2', 'PIL'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import s2d_tpu_torch.keymask, s2d_tpu_torch.keymask.cotracker\n"
        "import s2d_tpu_torch.tools.merge_ytvis_jsons, s2d_tpu_torch.tools.convert_results_to_annotations\n"
        "from s2d_tpu_torch import keymask_ident\n"
        f"argv = ['--frames-root', {str(tree / 'frames')!r}, '--masks-root',\n"
        f"        {str(tree / 'masks')!r}, '--output-root', {str(tmp_path / 'out')!r},\n"
        f"        '--device', 'cpu', '--merge', *{ARGS!r}]\n"
        "assert keymask_ident.main(argv) == 0\n"
        "assert not any(m.split('.')[0] in ('jax', 's2d_tpu', 'sklearn', 'cv2', 'PIL')\n"
        "               for m in sys.modules)\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "2 ok, 0 failed" in proc.stdout  # the JPEG video too, on the port's own codec
    assert [v["file_names"][0] for v in _json(tmp_path / "out" / "dataset.json")["videos"]] == [
        "vid0/00000.jpg", "vid1/00000.png"]
