"""The fields of the s2d_tpu configuration that the video-inference slice reads.

A frozen dataclass whose defaults are the values of
`configs/s2d_inference_kd_video_mask2former_R50_cls_agnostic.yaml` as
`s2d_tpu.config.load_config` resolves them (a CPU test pins the two
together). The main path needs no YAML parser: `load_config` reaches the
JAX package's loader lazily, only when a config file is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple


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
    weights: str = ""


def from_s2d_config(cfg) -> VideoConfig:
    """Project an `s2d_tpu.config.Config` onto the fields this slice reads.

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
        weights=cfg.model.weights,
    )


def load_config(path: str | None = None, opts: Sequence[str] = ()) -> VideoConfig:
    """The defaults, or a YAML config read through `s2d_tpu.config` (which
    needs PyYAML; imported only here)."""
    if not path and not opts:
        return VideoConfig()
    from s2d_tpu.config import load_config as load_s2d_config

    return from_s2d_config(load_s2d_config(path or None, list(opts)))
