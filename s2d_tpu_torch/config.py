"""The s2d configuration: the typed tree, its YAML loader, and the views the
port's entry points read.

`Config` is a copy of the JAX package's dataclass tree
(`s2d_tpu/config/defaults.py`): same fields, same defaults, so the configs
in `configs/` load unchanged. `load_config_tree` reproduces its loader
(`s2d_tpu/config/loader.py`): `_BASE_` chaining, case-insensitive keys,
yacs-style literal strings for tuples, and dot-path `opts` overrides parsed
with `ast.literal_eval`. The YAML is read by a small reader of the subset
the configs use (nested maps by indentation, `[..]` flow lists, quoted
strings, `#` comments), because PyYAML is not a dependency of the port.
A CPU test pins both to the JAX package's loader on every video config.

`VideoConfig` is the inference view: the fields the video-inference slice
reads, with the inference YAML's values as its defaults. The train step
reads the whole tree.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Any, List, Mapping, Sequence, Tuple


# --------------------------------------------------------------------------
# the configuration tree (field for field as s2d_tpu/config/defaults.py)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "build_resnet_backbone"
    freeze_at: int = 0


@dataclass(frozen=True)
class ResNetsConfig:
    depth: int = 50
    stem_out_channels: int = 64
    stride_in_1x1: bool = False
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    norm: str = "FrozenBN"
    res2_out_channels: int = 256


@dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")


@dataclass(frozen=True)
class SemSegHeadConfig:
    name: str = "MaskFormerHead"
    ignore_value: int = 255
    num_classes: int = 1
    loss_weight: float = 1.0
    convs_dim: int = 256
    mask_dim: int = 256
    norm: str = "GN"
    pixel_decoder_name: str = "MSDeformAttnPixelDecoder"
    in_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    deformable_transformer_encoder_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    common_stride: int = 4
    transformer_enc_layers: int = 6


@dataclass(frozen=True)
class MaskFormerTestConfig:
    semantic_on: bool = False
    instance_on: bool = True
    panoptic_on: bool = False
    overlap_threshold: float = 0.8
    object_mask_threshold: float = 0.8
    use_nms: bool = True
    nms_thresh: float = 0.75
    num_predictions: int = 50
    eval_student: bool = False


@dataclass(frozen=True)
class MaskFormerConfig:
    transformer_decoder_name: str = "VideoMultiScaleMaskedTransformerDecoder"
    transformer_in_feature: str = "multi_scale_pixel_decoder"
    deep_supervision: bool = True
    no_object_weight: float = 0.1
    class_weight: float = 0.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    hidden_dim: int = 256
    num_object_queries: int = 100
    nheads: int = 8
    dropout: float = 0.0
    dim_feedforward: int = 2048
    enc_layers: int = 0
    dec_layers: int = 10
    pre_norm: bool = False
    enforce_input_proj: bool = False
    size_divisibility: int = 32
    train_num_points: int = 160000
    matcher_num_points: int = 0
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    point_sampling: str = "iid"  # "iid" | "lattice"
    loss_strategy: str = "masks-only"
    distillation_loss_strategy: str = "masks-only"
    kd_class_weight: float = 0.0
    kd_mask_weight: float = 5.0
    kd_dice_weight: float = 5.0
    kd_weight_scheduler: str = "constant"  # constant | linear | cosine
    kd_min_weight: float = 0.1
    supervised_min_weight: float = 0.1
    kd_weight_decay_start: float = 0.0
    kd_weight_decay_end: float = -1.0
    decay_only_supervised_loss: bool = False
    decay_only_kd_loss: bool = False
    loss_weight_decay_step: float = 0.0
    detach_cls: bool = False
    ema_momentum: float = 0.999
    ema_momentum_schedule: bool = False
    ema_momentum_end: float = 0.999
    ema_momentum_until_step: int = 10000
    num_predictions_distillation: int = 100
    score_threshold_distillation: float = 0.75
    distillation_nms: bool = False
    sparse_class_weight: float = 0.0
    entropy_weight: float = 0.0
    no_class_match: bool = False
    mask_droploss: bool = False
    label_droploss: bool = False
    test: MaskFormerTestConfig = field(default_factory=MaskFormerTestConfig)


@dataclass(frozen=True)
class ModelConfig:
    meta_architecture: str = "KDVideoMaskFormer"
    weights: str = ""
    weight_list: Tuple[str, ...] = ()
    pixel_mean: Tuple[float, ...] = (123.675, 116.280, 103.530)
    pixel_std: Tuple[float, ...] = (58.395, 57.120, 57.375)
    mask_on: bool = True
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    resnets: ResNetsConfig = field(default_factory=ResNetsConfig)
    swin: SwinConfig = field(default_factory=SwinConfig)
    sem_seg_head: SemSegHeadConfig = field(default_factory=SemSegHeadConfig)
    mask_former: MaskFormerConfig = field(default_factory=MaskFormerConfig)


@dataclass(frozen=True)
class ClipGradientsConfig:
    enabled: bool = True
    clip_type: str = "full_model"
    clip_value: float = 0.01
    norm_type: float = 2.0


@dataclass(frozen=True)
class AMPConfig:
    enabled: bool = True


@dataclass(frozen=True)
class SolverConfig:
    ims_per_batch: int = 4
    base_lr: float = 1e-4
    steps: Tuple[int, ...] = (4000,)
    max_iter: int = 6000
    warmup_factor: float = 1.0
    warmup_iters: int = 10
    weight_decay: float = 0.05
    optimizer: str = "ADAMW"
    backbone_multiplier: float = 0.1
    accum_iter: int = 1
    gamma: float = 0.1
    lr_scheduler_name: str = "WarmupMultiStepLR"
    reference_world_size: int = 0
    checkpoint_period: int = 5000
    # recompute each deformable encoder layer in the backward pass
    grad_checkpoint: bool = True
    clip_gradients: ClipGradientsConfig = field(default_factory=ClipGradientsConfig)
    amp: AMPConfig = field(default_factory=AMPConfig)


@dataclass(frozen=True)
class CropConfig:
    enabled: bool = False
    type: str = "absolute_range"
    size: Tuple[int, ...] = (600, 720)


@dataclass(frozen=True)
class InputConfig:
    min_size_train: Tuple[int, ...] = (360, 480)
    min_size_train_sampling: str = "choice_by_clip"
    max_size_train: int = 1333
    min_size_test: int = 360
    max_size_test: int = 1333
    random_flip: str = "flip_by_clip"
    augmentations: Tuple[str, ...] = ()
    sampling_frame_num: int = 3
    sampling_frame_range: int = 20
    sampling_frame_shuffle: bool = False
    dense_annotation_selection: bool = True
    disentangle_distillation_loader: bool = False
    distillation_dense_annotation_selection: bool = True
    format: str = "RGB"
    crop: CropConfig = field(default_factory=CropConfig)


@dataclass(frozen=True)
class DataLoaderConfig:
    filter_empty_annotations: bool = True
    num_workers: int = 4
    copy_paste: bool = False
    copy_paste_rate: float = 1.0
    visualize_copy_paste: bool = False
    copy_paste_random_num: bool = False
    copy_paste_min_ratio: float = 0.8
    copy_paste_max_ratio: float = 1.0
    copy_paste_densify_sparse: bool = False


@dataclass(frozen=True)
class DatasetsConfig:
    train: Tuple[str, ...] = ("ytvis_2019_train",)
    test: Tuple[str, ...] = ("ytvis_2019_val",)


@dataclass(frozen=True)
class TestConfig:
    eval_period: int = 0
    expected_results: Tuple = ()


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: int = -1
    model_axis: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    input: InputConfig = field(default_factory=InputConfig)
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    datasets: DatasetsConfig = field(default_factory=DatasetsConfig)
    test: TestConfig = field(default_factory=TestConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    output_dir: str = "OUTPUT/"
    seed: int = -1
    version: int = 2


# --------------------------------------------------------------------------
# a reader for the YAML subset of configs/
# --------------------------------------------------------------------------

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOLS = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str) -> List[str]:
    """Split a flow list's body on the commas outside quotes and brackets."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return [s.strip() for s in items if s.strip()]


def _scalar(text: str) -> Any:
    """A YAML 1.1 scalar as PyYAML's safe loader resolves it (the forms the
    configs use): quoted strings, flow lists, null, bools, ints, floats;
    anything else is a plain string (e.g. `("a",)`, a yacs literal)."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        return [_scalar(item) for item in _split_flow(text[1:-1])]
    if text in ("", "~") or text.lower() == "null":
        return None
    if text.lower() in _BOOLS:
        return _BOOLS[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def parse_yaml(text: str) -> dict:
    """Nested block maps (indentation), scalars and flow lists."""
    root: dict = {}
    stack: List[Tuple[int, dict]] = [(-1, root)]
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep:
            raise ValueError(f"unsupported YAML line: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip():
            parent[key.strip()] = _scalar(rest)
        else:
            child: dict = {}
            parent[key.strip()] = child
            stack.append((indent, child))
    return root


# --------------------------------------------------------------------------
# loading (as s2d_tpu/config/loader.py)
# --------------------------------------------------------------------------


def _coerce(value: Any, target: Any, path: str) -> Any:
    """Coerce a YAML value to the type of the default field value."""
    if dataclasses.is_dataclass(target):
        if not isinstance(value, Mapping):
            raise TypeError(f"{path}: expected mapping, got {type(value).__name__}")
        return _merge_dataclass(target, value, path)
    if isinstance(value, str) and isinstance(target, (tuple, list)):
        value = ast.literal_eval(value)  # yacs-style '("a",)'
    if isinstance(target, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"{path}: expected bool, got {value!r}")
    if isinstance(target, int):
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, int):
            return value
        raise TypeError(f"{path}: expected int, got {value!r}")
    if isinstance(target, float):
        if isinstance(value, (int, float, str)):
            return float(value)
        raise TypeError(f"{path}: expected float, got {value!r}")
    if isinstance(target, tuple):
        if isinstance(value, (list, tuple)):
            return tuple(value)
        raise TypeError(f"{path}: expected sequence, got {value!r}")
    return value


def _merge_dataclass(obj: Any, updates: Mapping[str, Any], path: str = "") -> Any:
    fields = {f.name.lower(): f.name for f in dataclasses.fields(obj)}
    kwargs = {}
    for key, value in updates.items():
        lk = key.lower()
        if lk == "_base_":
            continue
        if lk not in fields:
            warnings.warn(f"Ignoring unknown config key {path + key!r}")
            continue
        name = fields[lk]
        kwargs[name] = _coerce(value, getattr(obj, name), path + key + ".")
    return dataclasses.replace(obj, **kwargs)


def _deep_update(dst: dict, src: Mapping) -> None:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def _load_yaml_with_base(filename: str) -> dict:
    with open(filename) as f:
        data = parse_yaml(f.read())
    base = data.pop("_BASE_", None) or data.pop("_base_", None)
    if base:
        base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(filename), base)
        merged = _load_yaml_with_base(base_path)
        _deep_update(merged, data)
        return merged
    return data


def _apply_opts(cfg: Config, opts: Sequence[str]) -> Config:
    """Apply ['KEY.SUBKEY', 'value', ...] pairs (detectron2 opts style)."""
    if len(opts) % 2 != 0:
        raise ValueError(f"opts must be key/value pairs, got {opts}")
    for key, raw in zip(opts[::2], opts[1::2]):
        parts = key.split(".")
        chain = []
        node: Any = cfg
        for part in parts:
            fields = {f.name.lower(): f.name for f in dataclasses.fields(node)}
            if part.lower() not in fields:
                raise KeyError(f"Unknown config key {key!r} (at {part!r})")
            chain.append((node, fields[part.lower()]))
            node = getattr(node, fields[part.lower()])
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = _coerce(value, node, key)
        for parent, name in reversed(chain):
            node = dataclasses.replace(parent, **{name: node})
        cfg = node
    return cfg


def load_config_tree(path: str | None = None, opts: Sequence[str] = ()) -> Config:
    """The whole configuration: defaults, an optional YAML file (with its
    `_BASE_` chain), then the `opts` overrides."""
    cfg = Config()
    if path:
        cfg = _merge_dataclass(cfg, _load_yaml_with_base(path))
    if opts:
        cfg = _apply_opts(cfg, list(opts))
    return cfg


# --------------------------------------------------------------------------
# the inference view
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class VideoConfig:
    # input: MODEL.PIXEL_MEAN/STD, SIZE_DIVISIBILITY, INPUT.MIN/MAX_SIZE_TEST
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    size_divisibility: int = 32
    min_size_test: int = 360
    max_size_test: int = 1333
    # network
    backbone_depth: int = 50
    num_classes: int = 1
    hidden_dim: int = 256
    mask_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 10  # config value: the decoder runs dec_layers - 1 rounds
    enc_layers: int = 6
    enc_dim_feedforward: int = 1024
    enc_n_points: int = 4
    # SOLVER.AMP.ENABLED: activations round to bf16 at the JAX cast points
    amp: bool = True
    # MASK_FORMER.TEST
    use_nms: bool = True
    num_predictions: int = 50
    nms_thresh: float = 0.75
    # MODEL.MASK_FORMER.TEST.EVAL_STUDENT: which network of a student/teacher
    # checkpoint is evaluated
    eval_student: bool = False
    weights: str = ""


def from_s2d_config(cfg) -> VideoConfig:
    """Project a configuration tree (this module's `Config`, or the JAX
    package's, which has the same fields) onto the inference view.

    Raises NotImplementedError for the architectures the port does not have
    yet (Swin backbone, the MaskFormer-v1 pixel decoders and decoder)."""
    mf = cfg.model.mask_former
    head = cfg.model.sem_seg_head
    if "swin" in cfg.model.backbone.name.lower():
        raise NotImplementedError("the port has no Swin backbone yet")
    if head.pixel_decoder_name != "MSDeformAttnPixelDecoder":
        raise NotImplementedError(f"pixel decoder {head.pixel_decoder_name!r}")
    if mf.transformer_decoder_name != "VideoMultiScaleMaskedTransformerDecoder":
        raise NotImplementedError(f"decoder {mf.transformer_decoder_name!r}")
    return VideoConfig(
        pixel_mean=tuple(float(v) for v in cfg.model.pixel_mean),
        pixel_std=tuple(float(v) for v in cfg.model.pixel_std),
        size_divisibility=mf.size_divisibility,
        min_size_test=cfg.input.min_size_test,
        max_size_test=cfg.input.max_size_test,
        backbone_depth=cfg.model.resnets.depth,
        num_classes=head.num_classes,
        hidden_dim=mf.hidden_dim,
        mask_dim=head.mask_dim,
        num_queries=mf.num_object_queries,
        nheads=mf.nheads,
        dim_feedforward=mf.dim_feedforward,
        dec_layers=mf.dec_layers,
        enc_layers=head.transformer_enc_layers,
        amp=cfg.solver.amp.enabled,
        use_nms=mf.test.use_nms,
        num_predictions=mf.test.num_predictions,
        nms_thresh=mf.test.nms_thresh,
        eval_student=mf.test.eval_student,
        weights=cfg.model.weights,
    )


def load_config(path: str | None = None, opts: Sequence[str] = ()) -> VideoConfig:
    """The inference view of the defaults, or of a YAML config with `opts`."""
    if not path and not opts:
        return VideoConfig()
    return from_s2d_config(load_config_tree(path, opts))
