"""The port's CoTracker (`s2d_tpu_torch/keymask/cotracker.py`) against the
JAX package's, on the CPU, with the tiny net of tests/test_cotracker.py
(latent 16, dim 32, 4 heads, depth 1, 2 iterations, 2 levels, radius 1)
and JAX's init carried across by `checkpoint/from_jax.py`.

Tolerances (float32 in both; in brackets the differences at these inputs on
an x86 CPU):
the bilinear resize 1e-6 [2.4e-7]; the feature pyramid atol 1e-4 on values
of ~3 [6.7e-6]; tracks rtol 1e-4 / atol 1e-4 px [2.3e-5 px] and visibility
atol 1e-5 [1.5e-6]. An upstream-shaped .pth loads to the same parameters in
both packages exactly, and a missing, unmapped or misshapen key raises."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from s2d_tpu.keymask import cotracker as jc
from s2d_tpu_torch.checkpoint.from_jax import load_params_from_jax, params_from_jax
from s2d_tpu_torch.keymask import cotracker as pc

TINY = dict(latent_dim=16, dim=32, heads=4, depth=1, iters=2, levels=2, radius=1)
TRACK_TOL = dict(rtol=1e-4, atol=1e-4)
VIS_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the tests run beside others in parallel workers,
    where OpenMP threads of every worker would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


@pytest.fixture(scope="module")
def nets():
    jnet = jc.CoTrackerNet(**TINY)
    params = jax.jit(lambda key: jnet.init(key, jnp.zeros((3, 64, 64, 3)), jnp.zeros((8, 2)), 0))(
        jax.random.PRNGKey(0))
    pnet = pc.CoTrackerNet(**TINY)
    load_params_from_jax(pnet, _flat(params))
    return jnet, params, pnet.eval()


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(1).rand(3, 64, 64, 3).astype(np.float32)


def _jax_encode(jnet, params, frames):
    return jax.jit(lambda p, f: jnet.apply(p, f, method="encode"))(params, jnp.asarray(frames))


def test_resize_is_jax_bilinear():
    rng = np.random.RandomState(0)
    for src, dst in [((32, 32), (16, 16)), ((8, 8), (16, 16)), ((90, 160), (48, 64)),
                     ((33, 47), (20, 30)), ((720, 1280), (384, 512))]:
        x = rng.rand(1, *src, 3).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 3), "bilinear"))
        got = pc.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


def test_encoder_pyramid(nets, frames):
    jnet, params, pnet = nets
    want = _jax_encode(jnet, params, frames)
    with torch.no_grad():
        got = pnet.encode(torch.from_numpy(frames).permute(0, 3, 1, 2))
    assert len(got) == len(want) == TINY["levels"]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_refine_batched_sets_with_padding(nets, frames):
    """Three sets of 5, 3 and 8 points over one pyramid in one call, padded
    to 8 and masked, against JAX's refine of the same padded sets (vmapped,
    `_refine_net_vmapped`); and each set alone in the port gives what it
    gives in the batch."""
    jnet, params, pnet = nets
    rng = np.random.RandomState(2)
    sizes, seeds = (5, 3, 8), (1, 0, 2)
    sets = [rng.uniform(0, 63, (n, 2)).astype(np.float32) for n in sizes]
    q = np.zeros((3, 8, 2), np.float32)
    valid = np.zeros((3, 8), bool)
    for i, s in enumerate(sets):
        q[i, :len(s)] = s
        valid[i, :len(s)] = True
    tj, vj = jc._refine_net_vmapped(jnet, params, _jax_encode(jnet, params, frames),
                                    jnp.asarray(q), jnp.asarray(seeds), jnp.asarray(valid))
    with torch.no_grad():
        pyramid = pnet.encode(torch.from_numpy(frames).permute(0, 3, 1, 2))
        tracks, vis = pnet.refine(pyramid, torch.from_numpy(q), torch.tensor(seeds),
                                  torch.from_numpy(valid))
        for i, (s, f) in enumerate(zip(sets, seeds)):
            n = len(s)
            np.testing.assert_allclose(tracks[i, :, :n].numpy(), np.asarray(tj)[i, :, :n],
                                       **TRACK_TOL)
            np.testing.assert_allclose(vis[i, :, :n].numpy(), np.asarray(vj)[i, :, :n], rtol=0,
                                       atol=VIS_ATOL)
            np.testing.assert_array_equal(tracks[i, f, :n].numpy(), s)  # anchored
            alone, vis_alone = pnet.refine(pyramid, torch.from_numpy(s)[None], torch.tensor([f]))
            np.testing.assert_allclose(alone[0].numpy(), tracks[i, :, :n].numpy(), rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(vis_alone[0].numpy(), vis[i, :, :n].numpy(), rtol=0,
                                       atol=VIS_ATOL)


def test_tracker_track_batch(nets, monkeypatch):
    """The trackers end to end: a uint8 video resized to 64x64, queries in
    the source pixels, sets of different sizes and seed frames; and the
    pyramid cache."""
    jnet, params, pnet = nets
    rng = np.random.RandomState(3)
    video = rng.randint(0, 255, (3, 48, 96, 3), np.uint8)
    sets = [rng.uniform(0, [95, 47], (n, 2)).astype(np.float32) for n in (4, 7, 1)]
    seeds = [0, 2, 1]
    jt = jc.CoTrackerTracker(params=params, net=jnet, interp_h=64, interp_w=64, point_bucket=8,
                             batch_chunk=2)
    monkeypatch.setattr(pc, "INTERP_HW", (64, 64))
    pt = pc.CoTrackerTracker(pnet, device="cpu")
    want = jt.track_batch(video, sets, seeds)
    got = pt.track_batch(video, sets, seeds)
    assert len(got) == len(want) == 3
    for (tg, vg), (tw, vw), s in zip(got, want, sets):
        assert tg.shape == (3, len(s), 2) and vg.shape == (3, len(s))
        np.testing.assert_allclose(tg, tw, **TRACK_TOL)
        np.testing.assert_allclose(vg, vw, rtol=0, atol=VIS_ATOL)
    assert pt.point_frames == 3 * (4 + 7 + 1) and pt.seconds > 0
    cached = pt._pyramid_cache._value
    one = pt.track(video, sets[1], query_frame=2)
    assert pt._pyramid_cache._value is cached  # a hit: encoded once a video
    np.testing.assert_allclose(one[0], got[1][0], rtol=0, atol=1e-5)
    pt.track(rng.randint(0, 255, (3, 48, 96, 3), np.uint8), sets[0], 0)
    assert pt._pyramid_cache._value is not cached
    assert pt.track_batch(video, [], []) == []


def test_chunks_do_not_change_results(nets, monkeypatch):
    """Sets refined one chunk at a time give the results of one chunk."""
    _, _, pnet = nets
    rng = np.random.RandomState(4)
    video = rng.randint(0, 255, (3, 40, 40, 3), np.uint8)
    sets = [rng.uniform(0, 39, (n, 2)).astype(np.float32) for n in (3, 6, 2, 5)]
    monkeypatch.setattr(pc, "INTERP_HW", (64, 64))
    pt = pc.CoTrackerTracker(pnet, device="cpu")
    whole = pt.track_batch(video, sets, [0, 1, 2, 1])
    pt._chunk = lambda t, p: 1
    for (a, va), (b, vb) in zip(whole, pt.track_batch(video, sets, [0, 1, 2, 1])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        np.testing.assert_allclose(va, vb, rtol=0, atol=VIS_ATOL)
    assert pt.set_bytes(24, 640) > pt.set_bytes(24, 64) > 0


def test_upstream_checkpoint_loads_to_the_same_numbers(nets, tmp_path):
    """JAX's upstream-shaped state_dict, saved as a .pth with the "model."
    prefix of `scaled_offline.pth`, loads into both packages to the same
    parameters, bit for bit; the port's own table writes the same
    state_dict."""
    jnet, params, pnet = nets
    sd = jc.to_torch_state_dict(params)
    path = tmp_path / "scaled_offline.pth"
    torch.save({"model." + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               str(path))
    jax_params = jc.load_cotracker_checkpoint(str(path), jnet, params)
    port = pc.load_cotracker_checkpoint(str(path), pc.CoTrackerNet(**TINY))
    want = params_from_jax(_flat(jax_params), port.state_dict())
    got = port.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mine = pc.to_torch_state_dict(pnet.state_dict())
    assert set(mine) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(mine[k], sd[k], err_msg=k)
    assert pc.torch_key_for("updateformer.space0.mlp2.bias") == \
        "updateformer.space_virtual_blocks.0.mlp.fc2.bias"
    assert pc.torch_key_for("fnet.layer2.downsample.weight") == "fnet.layer2.0.downsample.weight"


def test_checkpoint_key_faults_raise(nets):
    _, _, pnet = nets
    ref = pnet.state_dict()
    sd = pc.to_torch_state_dict(ref)
    missing = dict(sd)
    missing.pop("updateformer.time_blocks.0.attn.qkv.weight")
    missing.pop("fnet.conv1.bias")
    with pytest.raises(ValueError, match="key mismatch") as err:
        pc.convert_cotracker_state_dict(missing, ref)
    assert "fnet.conv1.bias" in str(err.value) and "attn.qkv.weight" in str(err.value)
    with pytest.raises(ValueError, match=r"unmapped in checkpoint: \['updateformer.vis_head"):
        pc.convert_cotracker_state_dict(dict(sd, **{"updateformer.vis_head.weight":
                                                    np.zeros(3)}), ref)
    bad = dict(sd, **{"time_emb": np.zeros((63, TINY["dim"]), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch for time_emb"):
        pc.convert_cotracker_state_dict(bad, ref)


def test_seeded_init():
    a = pc.init_params(pc.CoTrackerNet(**TINY), seed=0).state_dict()
    b = pc.init_params(pc.CoTrackerNet(**TINY), seed=0).state_dict()
    c = pc.init_params(pc.CoTrackerNet(**TINY), seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet.conv1.weight"], c["fnet.conv1.weight"])
    w = a["updateformer.time0.mlp1.weight"]
    assert abs(w.std().item() - (1 / TINY["dim"]) ** 0.5) < 0.2 * (1 / TINY["dim"]) ** 0.5
    assert (a["fnet.norm1.weight"] == 1).all() and (a["input_proj.bias"] == 0).all()
