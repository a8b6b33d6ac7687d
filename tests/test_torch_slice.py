"""The port's video-inference slice against the JAX package, module by module
and end to end, all f32 on the CPU.

One JAX run is shared: uint8 frames -> `preprocess_clip` ->
`VideoMaskFormer.apply` (capturing the backbone, pixel decoder and decoder
outputs) -> `postprocess_video(pack_bits=False)`. Weights are random
reference-layout torch weights (tests/torch_oracle.py) converted to flax
params by `convert_reference_network`, then to the port by
`params_from_jax`. Each port module gets the JAX module's own inputs, so a
fault shows in the module that has it.

Tolerances: rtol 1e-3 / atol 2e-3 for the network outputs, the golden
tolerance of tests/test_golden_parity.py (the two stacks reduce convs,
matmuls and resizes in other orders); the demo-protocol criterion of
tests/test_demo_parity.py for the post-processed predictions.
"""
import dataclasses

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import jax
import jax.numpy as jnp

from s2d_tpu.checkpoint.torch_import import convert_reference_network, extract_network
from s2d_tpu.evaluation.inference import postprocess_video as jax_postprocess
from s2d_tpu.models import VideoMaskFormer as JaxVideoMaskFormer
from s2d_tpu.models import preprocess_clip as jax_preprocess_clip
from s2d_tpu.models.transformer_decoder import (
    VideoMaskedTransformerDecoder as JaxDecoder,
)

from s2d_tpu_torch.checkpoint.from_jax import params_from_jax
from s2d_tpu_torch.config import VideoConfig
from s2d_tpu_torch.demo_video import VideoPredictor
from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, nms

from torch_oracle import TorchVideoMaskFormer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

HID, QUERIES, HEADS, FF, DEC, ENC = 64, 10, 4, 128, 4, 2
T, IN_H, IN_W = 2, 58, 90  # padded to 64 x 96 by preprocess_clip
OUT_SIZE = (116, 180)
NUM_PRED = 10
RTOL, ATOL = 1e-3, 2e-3
LOGIT_MARGIN = 5e-3  # band around the binarization threshold (test_demo_parity)

CFG = VideoConfig(
    hidden_dim=HID, mask_dim=HID, num_queries=QUERIES, nheads=HEADS,
    dim_feedforward=FF, dec_layers=DEC + 1, enc_layers=ENC, amp=False,
    num_predictions=NUM_PRED,
)


def _to_np(x):
    return np.array(x, dtype=np.float32)  # a writable copy for torch.from_numpy


@pytest.fixture(scope="module")
def flat_params():
    torch.manual_seed(3)
    oracle = TorchVideoMaskFormer(
        num_classes=1, hidden_dim=HID, mask_dim=HID, num_queries=QUERIES,
        nheads=HEADS, dim_ff=FF, dec_layers=DEC, enc_layers=ENC,
    )
    state = {k: v.numpy() for k, v in oracle.state_dict().items()}
    params = convert_reference_network(extract_network(state), dec_layers=DEC, enc_layers=ENC)
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(7).randint(0, 256, (T, IN_H, IN_W, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_run(flat_params, frames):
    from flax.traverse_util import unflatten_dict

    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat_params.items()})
    model = JaxVideoMaskFormer(
        num_classes=1, hidden_dim=HID, mask_dim=HID, num_queries=QUERIES, nheads=HEADS,
        dim_feedforward=FF, dec_layers=DEC + 1, transformer_enc_layers=ENC,
        compute_dtype=jnp.float32,
    )
    images, image_size = jax_preprocess_clip(frames, CFG.pixel_mean, CFG.pixel_std, 32)
    out, state = model.apply(
        params, images,
        capture_intermediates=lambda mdl, _: mdl.name in ("backbone", "pixel_decoder"),
        mutable=["intermediates"],
    )
    post = jax_postprocess(
        out["pred_logits"][0], out["pred_masks"][0],
        num_predictions=NUM_PRED, num_classes=1, image_size=image_size,
        output_size=OUT_SIZE, use_nms=True, nms_thresh=0.75,
        compute_dtype=jnp.float32, pack_bits=False,
    )
    inter = state["intermediates"]
    return {
        "params": params,
        "images": np.asarray(images),
        "image_size": image_size,
        "features": {k: _to_np(v) for k, v in inter["backbone"]["__call__"][0].items()},
        "pixel_decoder": inter["pixel_decoder"]["__call__"][0],
        "out": out,
        "post": {k: np.asarray(v) for k, v in post.items()},
    }


@pytest.fixture(scope="module")
def predictor(flat_params):
    return VideoPredictor(CFG, weights=flat_params, device="cpu")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def test_resnet_matches_jax(predictor, jax_run):
    images = torch.from_numpy(np.array(jax_run["images"][0])).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = predictor.model.backbone(images)
    for name, ref in jax_run["features"].items():
        np.testing.assert_allclose(
            got[name].permute(0, 2, 3, 1).numpy(), ref, rtol=RTOL, atol=ATOL, err_msg=name
        )


def test_pixel_decoder_matches_jax(predictor, jax_run):
    feats = {k: _nchw(v) for k, v in jax_run["features"].items()}
    with torch.no_grad():
        mask_features, outs = predictor.model.pixel_decoder(feats)
    ref_mask, ref_outs = jax_run["pixel_decoder"]
    np.testing.assert_allclose(
        mask_features.permute(0, 2, 3, 1).numpy(), _to_np(ref_mask), rtol=RTOL, atol=ATOL
    )
    assert len(outs) == len(ref_outs) == 3
    for got, ref in zip(outs, ref_outs):
        np.testing.assert_allclose(got.numpy(), _to_np(ref), rtol=RTOL, atol=ATOL)


def _decoder_inputs(jax_run):
    ref_mask, ref_outs = jax_run["pixel_decoder"]
    ms_video = [_to_np(f).reshape(1, T, *f.shape[1:]) for f in ref_outs]
    mask_features = _to_np(ref_mask).reshape(1, T, *ref_mask.shape[1:])
    return ms_video, mask_features


def _assert_outputs_close(got, ref):
    np.testing.assert_allclose(got["pred_logits"].numpy(), _to_np(ref["pred_logits"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["pred_masks"].numpy(), _to_np(ref["pred_masks"]),
                               rtol=RTOL, atol=ATOL)
    assert len(got["aux_pred_masks"]) == len(ref["aux_pred_masks"]) == DEC
    for g, r in zip(got["aux_pred_logits"], ref["aux_pred_logits"]):
        np.testing.assert_allclose(g.numpy(), _to_np(r), rtol=RTOL, atol=ATOL)
    for g, r in zip(got["aux_pred_masks"], ref["aux_pred_masks"]):
        np.testing.assert_allclose(g.numpy(), _to_np(r), rtol=RTOL, atol=ATOL)


def test_decoder_matches_jax(predictor, jax_run):
    ms_video, mask_features = _decoder_inputs(jax_run)
    with torch.no_grad():
        got = predictor.model.predictor(
            [torch.from_numpy(f) for f in ms_video],
            torch.from_numpy(np.ascontiguousarray(mask_features.transpose(0, 1, 4, 2, 3))),
        )
    _assert_outputs_close(got, jax_run["out"])


@pytest.mark.parametrize("flash", [False, True])
def test_decoder_with_pad_frame_matches_jax(predictor, jax_run, flash, monkeypatch):
    """T-bucket padding: frame 1 is a pad frame, its keys stay blocked in
    every cross-attention and its time phase does not advance. With `flash`
    the cross-attention goes through the K3 wrapper (its twin, on the CPU)."""
    monkeypatch.setattr(masked_attention_cuda, "LAUNCHES", 0)
    ms_video, mask_features = _decoder_inputs(jax_run)
    frame_valid = np.array([True, False])
    ref = JaxDecoder(
        num_classes=1, hidden_dim=HID, num_queries=QUERIES, nheads=HEADS,
        dim_feedforward=FF, dec_layers=DEC, mask_dim=HID,
    ).apply(
        {"params": jax_run["params"]["params"]["predictor"]},
        [jnp.asarray(f) for f in ms_video], jnp.asarray(mask_features),
        frame_valid=jnp.asarray(frame_valid),
    )
    decoder = predictor.model.predictor
    for i in range(decoder.dec_layers):
        monkeypatch.setattr(decoder.layers[i]["cross_attn"], "use_flash", flash)
    with torch.no_grad():
        got = decoder(
            [torch.from_numpy(f) for f in ms_video],
            torch.from_numpy(np.ascontiguousarray(mask_features.transpose(0, 1, 4, 2, 3))),
            frame_valid=torch.from_numpy(frame_valid),
        )
    _assert_outputs_close(got, ref)
    assert masked_attention_cuda.LAUNCHES == 0


def test_whole_slice_matches_jax(predictor, jax_run, frames, monkeypatch):
    """uint8 frames -> predictions, against the JAX pipeline; on the CPU no
    kernel launches."""
    for mod in (ms_deform_attn_cuda, masked_attention_cuda, nms):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    out, post = predictor.predict(frames, output_size=OUT_SIZE)
    _assert_outputs_close(out, jax_run["out"])
    ref = jax_run["post"]
    np.testing.assert_array_equal(post["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(post["scores"].numpy(), ref["scores"], atol=1e-4)
    np.testing.assert_array_equal(post["keep"].numpy(), ref["keep"])
    # binary masks equal away from the threshold band, < 0.5% boundary flips
    got_masks = np.empty_like(post["masks"].numpy())  # stored kept-first
    got_masks[post["order"].numpy()] = post["masks"].numpy()
    ref_masks = ref["masks"]
    assert got_masks.shape == ref_masks.shape == (NUM_PRED, T, *OUT_SIZE)
    from s2d_tpu.ops.resize import interpolate_bilinear as jax_resize

    h, w = jax_run["image_size"]
    jax_scores = jax.nn.softmax(jax_run["out"]["pred_logits"][0], axis=-1)[:, :-1]
    qidx = jax.lax.top_k(jax_scores.reshape(-1), NUM_PRED)[1]  # num_classes = 1
    sel = jax_run["out"]["pred_masks"][0][qidx]
    up = jax_resize(sel, (sel.shape[2] * 4, sel.shape[3] * 4))[:, :, :h, :w]
    ref_logits = np.asarray(jax_resize(up, OUT_SIZE))
    decided = np.abs(ref_logits) > LOGIT_MARGIN
    np.testing.assert_array_equal(got_masks[decided], ref_masks[decided])
    assert (got_masks != ref_masks).mean() < 5e-3
    assert decided.mean() > 0.95
    preds = predictor(frames, output_size=OUT_SIZE)
    assert preds["masks"].shape == (int(ref["keep"].sum()), T, *OUT_SIZE)
    np.testing.assert_array_equal(preds["labels"], ref["labels"][ref["keep"]])
    assert ms_deform_attn_cuda.LAUNCHES == masked_attention_cuda.LAUNCHES == nms.LAUNCHES == 0


def test_params_from_jax_maps_every_leaf(flat_params, predictor):
    state = params_from_jax(flat_params, predictor.model.state_dict())
    assert set(state) == set(predictor.model.state_dict())
    leftover = dict(flat_params)
    leftover["params/predictor/extra/kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(leftover, predictor.model.state_dict())
    missing = {k: v for k, v in flat_params.items() if "query_feat" not in k}
    with pytest.raises(KeyError, match="query_feat"):
        params_from_jax(missing, predictor.model.state_dict())


def test_amp_cast_points_match_jax_bf16(flat_params, frames):
    """The AMP eval path: JAX with compute_dtype=bf16 rounds activations at
    its cast points and computes in f32 between them (flax promotes bf16
    meeting f32 params); the port rounds at the same points. At the golden
    tolerance it matches JAX's bf16 forward, which f32 throughout does not."""
    from flax.traverse_util import unflatten_dict

    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat_params.items()})
    model = JaxVideoMaskFormer(
        num_classes=1, hidden_dim=HID, mask_dim=HID, num_queries=QUERIES, nheads=HEADS,
        dim_feedforward=FF, dec_layers=DEC + 1, transformer_enc_layers=ENC,
        compute_dtype=jnp.bfloat16,
    )
    images, _ = jax_preprocess_clip(frames, CFG.pixel_mean, CFG.pixel_std, 32)
    ref = model.apply(params, images)
    amp = VideoPredictor(dataclasses.replace(CFG, amp=True), weights=flat_params, device="cpu")
    out, _ = amp.predict(frames)
    for key in ("pred_logits", "pred_masks"):
        assert ref[key].dtype == jnp.float32  # promoted, not bf16
        np.testing.assert_allclose(out[key].numpy(), _to_np(ref[key]), rtol=RTOL, atol=ATOL)
    f32 = VideoPredictor(CFG, weights=flat_params, device="cpu")
    out32, _ = f32.predict(frames)
    assert np.abs(out32["pred_masks"].numpy() - _to_np(ref["pred_masks"])).max() > ATOL
