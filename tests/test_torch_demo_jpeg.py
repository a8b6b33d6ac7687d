"""The port's demo CLI (`python -m s2d_tpu_torch.demo_video`) on JPEG frames
with cv2 and PIL blocked from import, against JAX's `tools/demo_video.py`
on the same files: a frame glob of one video and a folder of two videos, 2
frames each, overlays and palette masks (--save-masks).

Both sides run one stand-in network (the forward's parity with JAX is held
by tests/test_torch_slice.py): fixed class logits for 6 queries, and mask
logits of +-8 from thresholds on the normalized frames at stride 4, the same
function in jnp and in torch. Its values and both bilinear resizes in the
postprocess are dyadic, so every mask pixel is exact on both sides and what
this test holds is the demo around the network: the frames read (cv2 against
the port's JPEG codec), resized (cv2.resize against `resize_linear`), the
postprocess and NMS, and the PNGs written (cv2.imwrite against `write_png`).
Tolerance: exact, every pixel of every PNG.
"""
import glob
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import cv2

REPO = Path(__file__).resolve().parents[1]
OPTS = ["INPUT.MIN_SIZE_TEST", "32", "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "1"]
QUERIES = 6
CLASS_LOGITS = [[2.0 - 0.35 * q, 0.0] for q in range(QUERIES)]
THRESHOLDS = [-0.6, -0.2, 0.0, 0.3, -0.4, 0.5]  # of the normalized channel q % 3

# the stand-in network, in torch, as the port's demo builds it
TORCH_STAND_IN = f"""
import torch
class StandIn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.logits = torch.nn.Parameter(torch.tensor({CLASS_LOGITS!r}))
    def forward(self, images, frame_valid=None):
        x = images[0, :, ::4, ::4, :]  # (T, H/4, W/4, 3) of the padded input
        thr = torch.tensor({THRESHOLDS!r}, dtype=x.dtype)
        masks = torch.stack([x[..., q % 3] > thr[q] for q in range({QUERIES})])
        return {{"pred_logits": self.logits[None],
                "pred_masks": torch.where(masks, 8.0, -8.0)[None]}}
"""


class JaxStandIn:
    """The same network for `tools/demo_video.py`: init and apply."""

    def init(self, key, x):
        return {"params": {}}

    def apply(self, variables, images):
        import jax.numpy as jnp

        x = images[0, :, ::4, ::4, :]
        masks = jnp.stack([x[..., q % 3] > THRESHOLDS[q] for q in range(QUERIES)])
        return {"pred_logits": jnp.asarray(CLASS_LOGITS, jnp.float32)[None],
                "pred_masks": jnp.where(masks, 8.0, -8.0).astype(jnp.float32)[None]}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Two folders of 2 JPEG frames at 64x96 (cv2, quality 90): smooth
    colour fields, so that the masks have area and overlap."""
    root = tmp_path_factory.mktemp("demo_jpeg")
    y, x = np.mgrid[:64, :96].astype(np.float32)
    for v in range(2):
        (root / f"vid{v}").mkdir()
        for t in range(2):
            rgb = np.stack([x * 2.6 + 20 * t, y * 3.9 + 40 * v, (x + y) * 1.5], -1)
            cv2.imwrite(str(root / f"vid{v}" / f"{t:05d}.jpg"),
                        np.clip(rgb, 0, 255).astype(np.uint8)[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
    return root


def _pngs(out):
    return sorted(str(Path(p).relative_to(out)) for p in glob.glob(str(out / "**" / "*.png"),
                                                                   recursive=True))


def test_demo_on_jpeg_without_cv2_or_pil_equals_jax(videos, tmp_path, monkeypatch, capsys):
    import s2d_tpu.models
    from tools import demo_video as jax_demo

    runs = {"glob": str(videos / "vid0" / "*.jpg"), "folders": str(videos / "vid*")}
    monkeypatch.setattr(s2d_tpu.models, "build_model", lambda cfg, **kw: JaxStandIn())
    for name, pattern in runs.items():
        assert jax_demo.main(["--input", pattern, "--output", str(tmp_path / "jax" / name),
                              "--confidence-threshold", "0.3", "--save-masks", *OPTS]) in (0, None)
    jax_counts = re.findall(r"(\d+) instances per frame", capsys.readouterr().out)
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'yaml', 's2d_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        + TORCH_STAND_IN +
        "torch.set_num_threads(1)\n"
        "from s2d_tpu_torch import demo_video\n"
        "demo_video.build_model = lambda cfg, **kw: StandIn()\n"
        f"for name, pattern in {runs!r}.items():\n"
        "    assert demo_video.main(['--input', pattern, '--output',\n"
        f"                            {str(tmp_path / 'port')!r} + '/' + name, '--device', 'cpu',\n"
        f"                            '--confidence-threshold', '0.3', '--save-masks', *{OPTS!r}]) == 0\n"
        "assert not any(m.split('.')[0] in ('cv2', 'PIL', 'jax', 's2d_tpu') for m in sys.modules)\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.findall(r"(\d+) instances per frame", proc.stdout) == jax_counts
    assert len(jax_counts) == 3 and all(0 < int(n) < QUERIES for n in jax_counts), jax_counts
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    files = _pngs(port)
    assert files == _pngs(jax_out) and len(files) == 12, files  # (1 + 2 videos) x 2 frames x 2
    from s2d_tpu_torch.data.png import read_png

    for f in files:
        want = cv2.imread(str(jax_out / f), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(read_png(str(port / f)), want, err_msg=f)
    # the masks are not all empty: the palette PNGs carry instances
    assert any(read_png(str(port / f)).any() for f in files if "mask_" in f)


def test_video_input_without_cv2_raises_naming_the_flag(tmp_path, monkeypatch):
    from s2d_tpu_torch import demo_video

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="--video-input"):
        demo_video.main(["--video-input", str(tmp_path / "clip.mp4"), "--output",
                         str(tmp_path / "out"), "--device", "cpu"])
