"""Load the reference's PyTorch checkpoints into the port.

The port's counterpart of `s2d_tpu/checkpoint/torch_import.py`, in numpy
and torch only. It reads the reference's three on-disk layouts:

  1. plain VideoMaskFormer: keys `backbone.*` / `sem_seg_head.*`
  2. KD student/teacher: `student.0.*` (backbone), `student.1.*`
     (sem_seg_head), `teacher.0.*`, `teacher.1.*`
  3. d2 .pkl checkpoints (a pickled dict with a "model" dict of numpy
     arrays, in layout 1 or 2)

and maps them straight onto the port's parameter names, which follow the
JAX package's flax tree (see `from_jax.py`). Against the JAX converter, a
torch Linear and Conv keep their layout here (JAX transposes them to flax,
and `params_from_jax` transposes them back); FrozenBatchNorm2d statistics
fold into the affine (weight, bias) in float64 at eps 1e-5, as JAX's
`_fold_bn`. Every checkpoint key of the network is consumed or the call
raises, as JAX's does (BN counters and the reference's `static_query` are
skipped, as there).

A backbone-only checkpoint (a d2-layout ImageNet R50 such as the output of
`tools/convert_pretrained_weights.py`) is grafted into an initialised
model's backbone (`load_backbone_weights`). The port has no Swin backbone
yet: a Swin checkpoint raises.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

BN_EPS = 1e-5
_STAGES = ("res2", "res3", "res4", "res5")


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    return v.detach().cpu().numpy()


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A .pth (torch.load) or .pkl (pickle) checkpoint as a flat {key: numpy}
    dict; a "model" sub-dict is taken out, and scalars are dropped."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, Mapping) and "model" in data:
        data = data["model"]
    return {k: _to_numpy(v) for k, v in data.items() if not isinstance(v, (int, float, str))}


def detect_layout(state: Mapping[str, np.ndarray]) -> str:
    """"student_teacher" or "plain"; raises on anything else."""
    if any(k.startswith("student.0.") for k in state):
        return "student_teacher"
    if any(k.startswith("backbone.") for k in state):
        return "plain"
    raise ValueError("Unrecognized checkpoint layout")


def extract_network(state: Mapping[str, np.ndarray], which: str = "teacher"
                    ) -> Dict[str, np.ndarray]:
    """One network's weights as plain backbone./sem_seg_head. keys (a plain
    checkpoint holds one network, whichever `which` asks for)."""
    if detect_layout(state) == "plain":
        return {k: v for k, v in state.items() if k.startswith(("backbone.", "sem_seg_head."))}
    if which not in ("student", "teacher"):
        raise ValueError(f"which must be 'student' or 'teacher', got {which!r}")
    out = {}
    for k, v in state.items():
        if k.startswith(f"{which}.0."):
            out["backbone." + k[len(which) + 3:]] = v
        elif k.startswith(f"{which}.1."):
            out["sem_seg_head." + k[len(which) + 3:]] = v
    return out


class _Taker:
    """Reads checkpoint keys and remembers which were read."""

    def __init__(self, state: Mapping[str, np.ndarray]):
        self.state = state
        self.consumed: set = set()

    def __call__(self, key: str) -> np.ndarray:
        self.consumed.add(key)
        return self.state[key]

    def bn(self, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
        """FrozenBatchNorm2d folded: (scale, bias) = (w / sqrt(var + eps),
        b - mean * scale), in float64, then float32."""
        w, b, mean, var = (self(f"{prefix}.{s}").astype(np.float64)
                           for s in ("weight", "bias", "running_mean", "running_var"))
        scale = w / np.sqrt(var + BN_EPS)
        return scale.astype(np.float32), (b - mean * scale).astype(np.float32)


def _resnet(take: _Taker) -> Iterator[Tuple[str, np.ndarray]]:
    """d2 R50 keys (backbone.stem.conv1 / backbone.resN.i.convM[.norm],
    shortcut) -> the port's backbone names, BN folded. Stage depths come
    from the checkpoint itself."""
    state = take.state
    if "backbone.patch_embed.proj.weight" in state:
        raise NotImplementedError(
            "a Swin backbone checkpoint: the port has no Swin backbone yet (ROADMAP queue 1, "
            "item 2(a))")
    if "backbone.res2.0.conv3.weight" not in state:
        raise ValueError("only bottleneck ResNets (50/101/152) are supported: the checkpoint "
                         "has no res2.0.conv3 (R18/34 basic blocks)")

    def conv_bn(port: str, conv: str, norm: str, port_norm: str):
        yield f"backbone.{port}.weight", take(f"{conv}.weight")
        scale, bias = take.bn(norm)
        yield f"backbone.{port_norm}.weight", scale
        yield f"backbone.{port_norm}.bias", bias

    yield from conv_bn("stem_conv1", "backbone.stem.conv1", "backbone.stem.conv1.norm",
                       "stem_norm1")
    for stage in _STAGES:
        blocks = 1 + max((int(m.group(1)) for k in state
                          for m in [re.match(rf"backbone\.{stage}\.(\d+)\.conv1\.weight$", k)]
                          if m), default=-1)
        for i in range(blocks):
            src, dst = f"backbone.{stage}.{i}", f"{stage}_block{i}"
            for c in (1, 2, 3):
                yield from conv_bn(f"{dst}.conv{c}", f"{src}.conv{c}", f"{src}.conv{c}.norm",
                                   f"{dst}.norm{c}")
            if f"{src}.shortcut.weight" in state:
                yield from conv_bn(f"{dst}.shortcut", f"{src}.shortcut", f"{src}.shortcut.norm",
                                   f"{dst}.shortcut_norm")


def _layer_count(state: Mapping[str, np.ndarray], pattern: str) -> int:
    return 1 + max((int(m.group(1)) for k in state for m in [re.match(pattern, k)] if m),
                   default=-1)


def _head(take: _Taker) -> Iterator[Tuple[str, np.ndarray]]:
    """sem_seg_head.* -> the port's pixel_decoder.* and predictor.* names.
    The encoder and decoder depths come from the checkpoint."""
    state = take.state
    pd, tr = "sem_seg_head.pixel_decoder", "sem_seg_head.pixel_decoder.transformer"

    def same(dst: str, src: str):  # weight and bias, layout unchanged
        yield f"{dst}.weight", take(f"{src}.weight")
        yield f"{dst}.bias", take(f"{src}.bias")

    for i in range(3):
        yield from same(f"pixel_decoder.input_proj{i}_conv", f"{pd}.input_proj.{i}.0")
        yield from same(f"pixel_decoder.input_proj{i}_gn", f"{pd}.input_proj.{i}.1")
    yield "pixel_decoder.level_embed", take(f"{tr}.level_embed")
    enc = _layer_count(state, rf"{re.escape(tr)}\.encoder\.layers\.(\d+)\.")
    for i in range(enc):
        src, dst = f"{tr}.encoder.layers.{i}", f"pixel_decoder.encoder_layer{i}"
        for lin in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            yield from same(f"{dst}.self_attn.{lin}", f"{src}.self_attn.{lin}")
        for mod in ("norm1", "norm2", "linear1", "linear2"):
            yield from same(f"{dst}.{mod}", f"{src}.{mod}")
    yield "pixel_decoder.adapter1_conv.weight", take(f"{pd}.adapter_1.weight")
    yield from same("pixel_decoder.adapter1_gn", f"{pd}.adapter_1.norm")
    yield "pixel_decoder.layer1_conv.weight", take(f"{pd}.layer_1.weight")
    yield from same("pixel_decoder.layer1_gn", f"{pd}.layer_1.norm")
    yield from same("pixel_decoder.mask_features", f"{pd}.mask_features")

    pr = "sem_seg_head.predictor"
    for name in ("query_feat", "query_embed", "level_embed"):
        yield f"predictor.{name}", take(f"{pr}.{name}.weight")
    dec = _layer_count(state, rf"{re.escape(pr)}\.transformer_cross_attention_layers\.(\d+)\.")
    for i in range(dec):
        for kind, src, attn in (("cross", f"{pr}.transformer_cross_attention_layers.{i}",
                                 "multihead_attn"),
                                ("self", f"{pr}.transformer_self_attention_layers.{i}",
                                 "self_attn")):
            dst = f"predictor.layer{i}_{kind}_attn"
            yield f"{dst}.in_proj_weight", take(f"{src}.{attn}.in_proj_weight")
            yield f"{dst}.in_proj_bias", take(f"{src}.{attn}.in_proj_bias")
            yield f"{dst}.out_proj_weight", take(f"{src}.{attn}.out_proj.weight")
            yield f"{dst}.out_proj_bias", take(f"{src}.{attn}.out_proj.bias")
            yield from same(f"predictor.layer{i}_{kind}_norm", f"{src}.norm")
        ff = f"{pr}.transformer_ffn_layers.{i}"
        for mod in ("linear1", "linear2", "norm"):
            yield from same(f"predictor.layer{i}_ffn.{mod}", f"{ff}.{mod}")
    yield from same("predictor.decoder_norm", f"{pr}.decoder_norm")
    yield from same("predictor.class_embed", f"{pr}.class_embed")
    for j in range(3):
        yield from same(f"predictor.mask_embed.layer{j}", f"{pr}.mask_embed.layers.{j}")


def _tensors(pairs: Iterator[Tuple[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    return {name: torch.from_numpy(np.array(value, dtype=np.float32)) for name, value in pairs}


def convert_reference_network(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Plain backbone./sem_seg_head. keys -> the port's state_dict (float32
    CPU tensors). Raises on any network key left unconsumed."""
    take = _Taker(state)
    out = _tensors(_resnet(take))
    out.update(_tensors(_head(take)))
    leftover = {
        k for k in state
        if k not in take.consumed and k.startswith(("backbone.", "sem_seg_head."))
        and "static_query" not in k and not k.endswith("num_batches_tracked")
    }
    if leftover:
        raise KeyError(f"Unconsumed checkpoint keys: {sorted(leftover)[:10]} ...")
    return out


def load_reference_model(path: str, which: str = "teacher") -> Dict[str, torch.Tensor]:
    """One call: a .pth/.pkl path -> the port's state_dict of `which`."""
    return convert_reference_network(extract_network(load_torch_checkpoint(path), which))


def is_backbone_only(state: Mapping[str, np.ndarray]) -> bool:
    """True for d2-layout backbone pretrain checkpoints (stem./resN. for R50,
    patch_embed./layers. for Swin) with no sem_seg_head."""
    has_head = any(k.startswith("sem_seg_head.") for k in state)
    backbone = any(k.startswith(("stem.", "res2.", "patch_embed.", "layers.", "backbone.stem.",
                                 "backbone.patch_embed.")) for k in state)
    return backbone and not has_head


def _pretrain_skip(key: str) -> bool:
    """Buffers and classifier heads a pretrain checkpoint carries that the
    detection backbone never consumes (d2's matching heuristics skip them)."""
    return (key.endswith(("num_batches_tracked", "attn_mask", "relative_position_index"))
            or key.startswith(("backbone.fc.", "backbone.head.", "backbone.stem.fc."))
            or key in ("backbone.norm.weight", "backbone.norm.bias"))


def load_backbone_weights(path_or_state, model: torch.nn.Module) -> torch.nn.Module:
    """Graft a backbone pretrain checkpoint (a path, or its loaded state)
    into `model` (already initialised): its backbone tensors are replaced,
    the rest keeps its init, as d2's matching-heuristics load of an ImageNet
    backbone. Raises on unconsumed backbone keys, and on a converted tensor
    the model lacks or holds in another shape."""
    state = (load_torch_checkpoint(path_or_state) if isinstance(path_or_state, str)
             else dict(path_or_state))
    if not any(k.startswith("backbone.") for k in state):
        state = {f"backbone.{k}": v for k, v in state.items()}
    take = _Taker(state)
    graft = _tensors(_resnet(take))
    leftover = {k for k in state if k not in take.consumed and not _pretrain_skip(k)}
    if leftover:
        raise KeyError(f"Unconsumed backbone checkpoint keys: {sorted(leftover)[:10]} ...")
    own = model.state_dict()
    missing = sorted(set(graft) - set(own))
    if missing:
        raise KeyError(f"backbone tensors with no place in the model: {missing[:10]} ...")
    for name, tensor in graft.items():
        if tuple(tensor.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: checkpoint {tuple(tensor.shape)} vs model "
                             f"{tuple(own[name].shape)}")
    with torch.no_grad():
        for name, tensor in graft.items():
            own[name].copy_(tensor)
    return model


def needs_init(weights) -> bool:
    """Whether a model must be initialised from a seed before `load_weights`:
    without weights, or for a checkpoint path (a backbone-only one is
    grafted into the init; a whole network overwrites it)."""
    return weights is None or (isinstance(weights, str) and not weights.endswith(".npz"))


def load_weights(model: torch.nn.Module, weights, which: str = "teacher") -> str:
    """Load `weights` into `model`, strictly, and say what they were:

      * a path to an .npz of flattened flax params ("flax", see
        `from_jax.py`);
      * a path to a reference .pth or .pkl: network `which` of a
        student/teacher checkpoint, the one network of a plain one
        ("reference"), or a backbone-only checkpoint grafted into the
        model's init ("backbone");
      * a mapping: flattened flax params, "/"-separated ("flax"), or the
        port's own state_dict ("state_dict")."""
    from .from_jax import load_npz, load_params_from_jax

    if isinstance(weights, str):
        if weights.endswith(".npz"):
            load_params_from_jax(model, load_npz(weights))
            return "flax"
        state = load_torch_checkpoint(weights)
        if is_backbone_only(state):
            load_backbone_weights(state, model)
            return "backbone"
        model.load_state_dict(convert_reference_network(extract_network(state, which)))
        return "reference"
    if any("/" in k for k in weights):
        load_params_from_jax(model, weights)
        return "flax"
    model.load_state_dict(weights)
    return "state_dict"
