"""The port's small pieces against the JAX package: configuration, position
encoding, bilinear resize, exact mask IoU, the full-size parameter mapping,
the import rule, and the demo CLI on the CPU."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2d_tpu.config import load_config as load_s2d_config
from s2d_tpu.models import VideoMaskFormer as JaxVideoMaskFormer
from s2d_tpu.models.position_encoding import (
    position_embedding_sine_2d as jax_pe_2d,
    position_embedding_sine_3d as jax_pe_3d,
)
from s2d_tpu.ops.nms import mask_iou_matrix as jax_mask_iou
from s2d_tpu.ops.resize import interpolate_bilinear as jax_resize

from s2d_tpu_torch import config as port_config
from s2d_tpu_torch.checkpoint.from_jax import params_from_jax
from s2d_tpu_torch.models.meta_arch import build_model
from s2d_tpu_torch.models.position_encoding import (
    position_embedding_sine_2d,
    position_embedding_sine_3d,
)
from s2d_tpu_torch.ops import nms
from s2d_tpu_torch.ops.resize import interpolate_bilinear


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFERENCE_YAML = os.path.join(REPO, "configs", "s2d_inference_kd_video_mask2former_R50_cls_agnostic.yaml")


def test_config_defaults_pin_the_inference_yaml():
    loaded = port_config.from_s2d_config(load_s2d_config(INFERENCE_YAML))
    assert loaded.weights == "s2d_zeroshot.pth"
    assert dataclasses.replace(loaded, weights="") == port_config.VideoConfig()
    assert port_config.load_config(INFERENCE_YAML) == loaded
    cfg = port_config.VideoConfig()
    assert (cfg.hidden_dim, cfg.num_queries, cfg.nheads, cfg.dim_feedforward) == (256, 100, 8, 2048)
    assert (cfg.dec_layers, cfg.enc_layers, cfg.enc_dim_feedforward, cfg.enc_n_points) == (10, 6, 1024, 4)
    assert (cfg.num_predictions, cfg.nms_thresh, cfg.size_divisibility) == (50, 0.75, 32)
    assert (cfg.min_size_test, cfg.max_size_test, cfg.amp) == (360, 1333, True)


def test_position_encoding_matches_jax():
    np.testing.assert_allclose(
        position_embedding_sine_2d(5, 7, 16).numpy(), np.asarray(jax_pe_2d(5, 7, 16)),
        rtol=0, atol=1e-6,
    )
    np.testing.assert_allclose(
        position_embedding_sine_3d(3, 4, 6, 16).numpy(), np.asarray(jax_pe_3d(3, 4, 6, 16)),
        rtol=0, atol=1e-6,
    )
    # pad frames (False) do not advance the time phase
    fv = np.array([True, True, False, False])
    got = position_embedding_sine_3d(4, 3, 5, 16, frame_valid=torch.from_numpy(fv)).numpy()
    ref = np.asarray(jax_pe_3d(4, 3, 5, 16, frame_valid=jnp.asarray(fv)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    unpadded = position_embedding_sine_3d(2, 3, 5, 16).numpy()
    np.testing.assert_allclose(got[:2], unpadded, rtol=0, atol=1e-5)
    bf16 = position_embedding_sine_3d(2, 3, 5, 16, dtype=torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(
        bf16, np.asarray(jax_pe_3d(2, 3, 5, 16, jnp.bfloat16), np.float32)
    )


@pytest.mark.parametrize("src,dst", [
    ((6, 10), (24, 40)),   # integer upsample (the postprocess x4)
    ((24, 40), (3, 5)),    # downsample (decoder attention masks)
    ((17, 23), (40, 31)),  # non-integer, mixed
    ((90, 160), (90, 160)),  # identity
])
def test_interpolate_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    got = interpolate_bilinear(torch.from_numpy(x), dst).numpy()
    ref = np.asarray(jax_resize(jnp.asarray(x), dst))
    assert got.shape == (2, 3, *dst)
    # f32 weights on both sides (JAX derives them in float64 and casts)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_frame", [False, True])
def test_mask_iou_is_exact(per_frame, monkeypatch):
    if per_frame:  # the accumulate-per-frame branch of T*H*W >= 2^24
        monkeypatch.setattr(nms, "EXACT_F32", 64)
    rng = np.random.RandomState(1)
    masks = rng.rand(12, 3, 24, 32) > 0.55
    masks[4] = False  # an empty mask: IoU 0 with everything
    got = nms.mask_iou_matrix(torch.from_numpy(masks)).numpy()
    ref = np.asarray(jax_mask_iou(jnp.asarray(masks)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)  # exact counts, same f32 division


def test_params_from_jax_full_size_maps_every_leaf():
    """Every flax leaf of the full-size model maps to exactly one port tensor
    of the right shape, and the reverse."""
    cfg = port_config.VideoConfig()
    jax_model = JaxVideoMaskFormer(
        num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim, num_queries=cfg.num_queries,
        nheads=cfg.nheads, dim_feedforward=cfg.dim_feedforward, dec_layers=cfg.dec_layers,
        transformer_enc_layers=cfg.enc_layers,
    )
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64, 3)))
    from flax.traverse_util import flatten_dict

    flat = {"/".join(k): np.broadcast_to(np.float32(0), v.shape)
            for k, v in flatten_dict(shapes).items()}
    reference = build_model(cfg, seed=None).state_dict()
    state = params_from_jax(flat, reference)
    assert len(state) == len(flat) == len(reference)


def test_main_path_imports_no_jax_and_nothing_of_s2d_tpu():
    """With jax, flax, yaml, s2d_tpu, cv2 and PIL blocked on import, every
    module of the port and chip_smoke import, and nothing is built."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'yaml', 's2d_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import s2d_tpu_torch, s2d_tpu_torch._build, s2d_tpu_torch.config\n"
        "import s2d_tpu_torch.demo_video, s2d_tpu_torch.checkpoint.from_jax\n"
        "import s2d_tpu_torch.evaluation.inference, s2d_tpu_torch.models.meta_arch\n"
        "import s2d_tpu_torch.ops.ms_deform_attn_cuda, s2d_tpu_torch.ops.masked_attention_cuda\n"
        "import s2d_tpu_torch.ops.nms, s2d_tpu_torch.ops.msda_ablate_cuda\n"
        "import s2d_tpu_torch.tools.bench_pallas_ablate, s2d_tpu_torch.train_net_video\n"
        "import s2d_tpu_torch.evaluation.evaluator, s2d_tpu_torch.evaluation.ytvos_eval\n"
        "import s2d_tpu_torch.data.rle, s2d_tpu_torch.data.ytvis, s2d_tpu_torch.data.mapper\n"
        "import s2d_tpu_torch.data.loader, s2d_tpu_torch.native, chip_smoke\n"
        "assert s2d_tpu_torch._build._LIB is None  # nothing built at import\n"
        "assert not s2d_tpu_torch.native._LOADED  # no native library built at import\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_demo_cli_writes_pngs_on_cpu(tmp_path):
    import cv2

    from s2d_tpu_torch import demo_video

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        cv2.imwrite(str(frames_dir / f"{i:05d}.jpg"), rng.randint(0, 256, (40, 72, 3), np.uint8))
    out = tmp_path / "out"
    rc = demo_video.main([
        "--input", str(frames_dir / "*.jpg"), "--output", str(out), "--device", "cpu",
        "--confidence-threshold", "0.0", "--save-masks",
    ])
    assert rc == 0
    for i in range(2):
        overlay = cv2.imread(str(out / f"frame_{i:05d}.png"))
        assert overlay is not None and overlay.shape == (40, 72, 3)
        assert cv2.imread(str(out / f"mask_{i:05d}.png")) is not None
