"""Reference checkpoints through the port's loader
(`s2d_tpu_torch.checkpoint.torch_import`) against the JAX package's
(`s2d_tpu.checkpoint.torch_import`), on the CPU.

A small reference-layout model (tests/torch_oracle.py: the full R50, 6
encoder and 9 decoder layers as JAX's `load_reference_model` converts them,
narrow widths) gives a student and a teacher from different seeds, saved as
a plain .pth, a student/teacher .pth and a d2 .pkl with a "model" dict.
Each goes through both loaders: the parameters must match leaf by leaf,
exactly (JAX's flax params mapped to the port's names by
`params_from_jax`), and one clip through both forwards within rtol 1e-3 /
atol 2e-3 (the golden tolerance of tests/test_golden_parity.py). Then the
entry points: EVAL_STUDENT picks the network, MODEL.WEIGHT_LIST merges a
student and a teacher file, `create_train_state` puts a checkpoint's
teacher in the teacher, a backbone-only R50 (the synthetic recipe of
tests/test_pretrained_backbone.py) is grafted as JAX's
`load_backbone_weights` grafts it, and unconsumed keys raise on both
sides.
"""
import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import jax.numpy as jnp

from s2d_tpu.checkpoint import torch_import as jax_import
from s2d_tpu.models import VideoMaskFormer as JaxVideoMaskFormer
from s2d_tpu.models import preprocess_clip as jax_preprocess_clip

from s2d_tpu_torch import train_net_video
from s2d_tpu_torch.checkpoint import torch_import
from s2d_tpu_torch.checkpoint.from_jax import params_from_jax
from s2d_tpu_torch.config import VideoConfig, load_config_tree
from s2d_tpu_torch.demo_video import VideoPredictor
from s2d_tpu_torch.models.meta_arch import build_model

from torch_oracle import TorchVideoMaskFormer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HID, QUERIES, HEADS, FF = 64, 10, 4, 128
DEC, ENC = 9, 6  # the layers JAX's load_reference_model converts
T, IN_H, IN_W = 2, 58, 90
RTOL, ATOL = 1e-3, 2e-3
CFG = VideoConfig(
    hidden_dim=HID, mask_dim=HID, num_queries=QUERIES, nheads=HEADS, dim_feedforward=FF,
    dec_layers=DEC + 1, enc_layers=ENC, amp=False, num_predictions=QUERIES,
)
# the same model as config opts, for the train CLI and create_train_state
OPTS = [
    "MODEL.MASK_FORMER.HIDDEN_DIM", str(HID), "MODEL.SEM_SEG_HEAD.MASK_DIM", str(HID),
    "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", str(QUERIES), "MODEL.MASK_FORMER.NHEADS", str(HEADS),
    "MODEL.MASK_FORMER.DIM_FEEDFORWARD", str(FF), "MODEL.MASK_FORMER.DEC_LAYERS", str(DEC + 1),
    "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", str(ENC), "SOLVER.AMP.ENABLED", "False",
]


def _oracle(seed):
    torch.manual_seed(seed)
    model = TorchVideoMaskFormer(num_classes=1, hidden_dim=HID, mask_dim=HID,
                                 num_queries=QUERIES, nheads=HEADS, dim_ff=FF,
                                 dec_layers=DEC, enc_layers=ENC)
    return model.state_dict()


def _student_teacher(student, teacher):
    """The KD layout: student.0 / teacher.0 the backbones, .1 the heads."""
    out = {}
    for who, state in (("student", student), ("teacher", teacher)):
        for k, v in state.items():
            part, rest = k.split(".", 1)
            out[f"{who}.{0 if part == 'backbone' else 1}.{rest}"] = v
    return out


@pytest.fixture(scope="module")
def nets():
    return {"student": _oracle(1), "teacher": _oracle(2)}


def _converted(state):
    """A torch state_dict of the reference layout through the port's converter."""
    return torch_import.convert_reference_network({k: v.numpy() for k, v in state.items()})


@pytest.fixture(scope="module")
def ckpts(nets, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    paths = {name: str(root / name) for name in
             ("plain.pth", "student.pth", "teacher.pth", "kd.pth", "kd.pkl")}
    torch.save(nets["student"], paths["plain.pth"])  # a bare state_dict
    torch.save({"model": nets["student"], "iteration": 7}, paths["student.pth"])
    torch.save({"model": nets["teacher"], "iteration": 7}, paths["teacher.pth"])
    kd = _student_teacher(nets["student"], nets["teacher"])
    torch.save({"model": kd, "iteration": 7}, paths["kd.pth"])
    with open(paths["kd.pkl"], "wb") as f:  # d2's .pkl: numpy arrays under "model"
        pickle.dump({"model": {k: v.numpy() for k, v in kd.items()}, "__author__": "test"}, f)
    return paths


def _port_reference():
    return build_model(CFG, seed=None).state_dict()


def _jax_as_port(variables):
    """JAX's converted flax params under the port's names."""
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    return params_from_jax(flat, _port_reference())


def _assert_same_state(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype == torch.float32, name
        assert torch.equal(got[name], ref[name]), name


CASES = [("plain.pth", "student"), ("kd.pth", "student"), ("kd.pth", "teacher"),
         ("kd.pkl", "student"), ("kd.pkl", "teacher")]


@pytest.mark.parametrize("name,which", CASES)
def test_params_match_jax_leaf_by_leaf(ckpts, name, which):
    """Every layout and network: the port's state_dict is JAX's converted
    flax params, bit for bit (the same float64 BN fold)."""
    got = torch_import.load_reference_model(ckpts[name], which)
    _assert_same_state(got, _jax_as_port(jax_import.load_reference_model(ckpts[name], which)))


def test_layouts_pick_the_network(ckpts, nets):
    state = torch_import.load_torch_checkpoint(ckpts["kd.pkl"])
    assert torch_import.detect_layout(state) == "student_teacher"
    assert torch_import.detect_layout(torch_import.load_torch_checkpoint(ckpts["plain.pth"])) == "plain"
    for which in ("student", "teacher"):
        net = torch_import.extract_network(state, which)
        assert set(net) == set(nets[which])
        assert all(np.array_equal(net[k], nets[which][k].numpy()) for k in net)
    with pytest.raises(ValueError, match="layout"):
        torch_import.detect_layout({"foo.weight": np.zeros(1)})


def test_forward_matches_jax(ckpts):
    """One clip through JAX's model with its loader's student and through
    `VideoPredictor` with EVAL_STUDENT on the same .pth."""
    frames = np.random.RandomState(7).randint(0, 256, (T, IN_H, IN_W, 3)).astype(np.uint8)
    variables = jax_import.load_reference_model(ckpts["kd.pth"], "student")
    model = JaxVideoMaskFormer(
        num_classes=1, hidden_dim=HID, mask_dim=HID, num_queries=QUERIES, nheads=HEADS,
        dim_feedforward=FF, dec_layers=DEC + 1, transformer_enc_layers=ENC,
        compute_dtype=jnp.float32,
    )
    images, _ = jax_preprocess_clip(frames, CFG.pixel_mean, CFG.pixel_std, 32)
    ref = model.apply(variables, images)
    predictor = VideoPredictor(dataclasses.replace(CFG, eval_student=True),
                               weights=ckpts["kd.pth"], device="cpu")
    assert predictor.loaded == "reference"
    out, _ = predictor.predict(frames)
    for key in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key], np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("eval_student", [True, False])
def test_eval_student_picks_the_network(ckpts, nets, eval_student):
    """EVAL_STUDENT as `tools/demo_video.py` reads it: the student or the
    teacher of a student/teacher checkpoint; a plain checkpoint's one
    network either way."""
    cfg = dataclasses.replace(CFG, eval_student=eval_student)
    which = "student" if eval_student else "teacher"
    other = "teacher" if eval_student else "student"
    got = VideoPredictor(cfg, weights=ckpts["kd.pth"], device="cpu").model.state_dict()
    _assert_same_state(got, _converted(nets[which]))
    assert not torch.equal(got["predictor.query_feat"],
                           _converted(nets[other])["predictor.query_feat"])
    plain = VideoPredictor(cfg, weights=ckpts["plain.pth"], device="cpu").model.state_dict()
    _assert_same_state(plain, _converted(nets["student"]))


@pytest.mark.parametrize("eval_student", [True, False])
def test_weight_list_merges(ckpts, nets, eval_student, monkeypatch, capsys):
    """MODEL.WEIGHT_LIST through the eval CLI: the student from the first
    file, the teacher from the last, as `tools/train_net_video.py:93-100`;
    the evaluated network is the one EVAL_STUDENT names."""
    seen = {}

    def evaluate_dataset(predictor, name, **kwargs):
        seen["state"] = predictor.model.state_dict()
        return {"AP": 0.0}

    from s2d_tpu_torch.evaluation import evaluator

    monkeypatch.setattr(evaluator, "evaluate_dataset", evaluate_dataset)
    argv = ["--eval-only", "--device", "cpu", *OPTS,
            "MODEL.WEIGHT_LIST", f'("{ckpts["student.pth"]}", "{ckpts["teacher.pth"]}")',
            "MODEL.MASK_FORMER.TEST.EVAL_STUDENT", str(eval_student),
            "MODEL.WEIGHTS", ckpts["kd.pth"], "DATASETS.TEST", '("unused",)']
    assert train_net_video.main(argv) == 0
    assert "Merged checkpoints" in capsys.readouterr().out
    which = "student" if eval_student else "teacher"
    path = ckpts["student.pth"] if eval_student else ckpts["teacher.pth"]
    _assert_same_state(seen["state"],
                       _jax_as_port(jax_import.load_reference_model(path, which)))
    _assert_same_state(seen["state"], _converted(nets[which]))


def test_missing_weights_warn_and_init_from_the_seed(tmp_path, capsys):
    cfg = load_config_tree(None, [*OPTS, "MODEL.WEIGHT_LIST", f'("{tmp_path}/a.pth",)'])
    assert train_net_video.eval_weights(cfg, str(tmp_path / "nope.pth")) is None
    assert "WARNING: weights" in capsys.readouterr().out
    assert train_net_video.eval_weights(cfg, "") is None


def test_train_state_takes_the_checkpoints_teacher(ckpts, nets):
    """`create_train_state` from a student/teacher .pth: the student in the
    student, the teacher in the teacher (no copy of the student)."""
    from s2d_tpu_torch.train.trainer import create_train_state

    cfg = load_config_tree(None, OPTS)
    state = create_train_state(cfg, device="cpu", params=ckpts["kd.pth"],
                               teacher_params=ckpts["kd.pth"], kernels=False)
    _assert_same_state(state.student.state_dict(),
                       _converted(nets["student"]))
    _assert_same_state(state.teacher.state_dict(),
                       _converted(nets["teacher"]))
    assert not state.teacher.training
    assert not any(p.requires_grad for p in state.teacher.parameters())
    copied = create_train_state(cfg, device="cpu", params=ckpts["kd.pth"], kernels=False)
    _assert_same_state(copied.teacher.state_dict(), copied.student.state_dict())


@pytest.fixture(scope="module")
def r50_pkl(tmp_path_factory):
    """A backbone-only d2 .pkl: a synthetic torchvision R50 state_dict
    through tools/convert_pretrained_weights.py (the recipe of
    tests/test_pretrained_backbone.py)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import convert_pretrained_weights as cpw
    from test_pretrained_backbone import _tv_resnet50_state

    root = tmp_path_factory.mktemp("r50")
    sd = _tv_resnet50_state(np.random.RandomState(0))
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(root / "r50.pth"))
    assert cpw.main(["--torchvision", str(root / "r50.pth"), "--output", str(root / "r50.pkl")]) == 0
    return str(root / "r50.pkl")


def test_backbone_graft_matches_jax(r50_pkl):
    """The graft: the backbone as JAX's `load_backbone_weights` converts it,
    bit for bit; everything else the seeded init; through the eval CLI's
    weights too."""
    state = torch_import.load_torch_checkpoint(r50_pkl)
    assert torch_import.is_backbone_only(state) and jax_import.is_backbone_only(state)
    grafted = jax_import.load_backbone_weights(r50_pkl, {"params": {"backbone": {}}})
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(grafted).items()}
    fresh = build_model(CFG, seed=0).state_dict()
    ref = params_from_jax(flat, {k: v for k, v in fresh.items() if k.startswith("backbone.")})
    cfg = load_config_tree(None, OPTS)
    weights = train_net_video.eval_weights(cfg, r50_pkl)
    predictor = VideoPredictor(CFG, weights=weights, seed=0, device="cpu")
    assert predictor.loaded == "backbone"
    got = predictor.model.state_dict()
    _assert_same_state({k: v for k, v in got.items() if k.startswith("backbone.")}, ref)
    for k, v in got.items():
        if not k.startswith("backbone."):
            assert torch.equal(v, fresh[k]), k


def test_unconsumed_keys_raise_on_both_sides(nets, r50_pkl):
    state = {k: v.numpy() for k, v in nets["student"].items()}
    state["sem_seg_head.predictor.extra_head.weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="extra_head"):
        jax_import.convert_reference_network(state)
    with pytest.raises(KeyError, match="extra_head"):
        torch_import.convert_reference_network(state)
    backbone = torch_import.load_torch_checkpoint(r50_pkl)
    backbone["res5.0.extra.weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="extra"):
        jax_import.load_backbone_weights(backbone, {"params": {"backbone": {}}})
    with pytest.raises(KeyError, match="extra"):
        torch_import.load_backbone_weights(backbone, build_model(CFG, seed=0))


def test_swin_checkpoint_raises_clearly():
    swin = {"backbone.patch_embed.proj.weight": np.zeros((96, 3, 4, 4), np.float32),
            "sem_seg_head.predictor.query_feat.weight": np.zeros((4, 8), np.float32)}
    with pytest.raises(NotImplementedError, match="no Swin backbone"):
        torch_import.convert_reference_network(swin)
    with pytest.raises(NotImplementedError, match="no Swin backbone"):
        torch_import.load_backbone_weights({"patch_embed.proj.weight": np.zeros((96, 3, 4, 4))},
                                           build_model(CFG, seed=0))


def test_npz_of_flax_params_still_loads(ckpts, tmp_path):
    """The .npz route the port had: JAX's converted params flattened to an
    .npz load to the same state_dict as the .pth."""
    variables = jax_import.load_reference_model(ckpts["kd.pth"], "teacher")
    path = str(tmp_path / "teacher.npz")
    np.savez(path, **{"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()})
    predictor = VideoPredictor(CFG, weights=path, device="cpu")
    assert predictor.loaded == "flax"
    _assert_same_state(predictor.model.state_dict(),
                       torch_import.load_reference_model(ckpts["kd.pth"], "teacher"))
