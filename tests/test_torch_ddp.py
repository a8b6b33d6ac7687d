"""The KD train step in a process group of 2 ranks (gloo on the CPU), each on
its half of the global batch, against JAX's `make_train_step` on the whole
batch and against the port's step in one process.

JAX computes the step over the global batch of SOLVER.IMS_PER_BATCH. Here
each rank takes one clip of a batch of 2 (`tests/ddp_ranks.py`); the step
all-reduces the criteria's normalizers (num_masks, loss_ce's weight sum)
and the gradients (`train/trainer.py`, `parallel/dist.py`). The two clips
hold different numbers of valid targets (3 and 1), where the mean of the
ranks' own normalized losses (DDP's convention) is not JAX's loss: the
test shows it missing by far more than the tolerance.

Networks: tests/test_torch_train_option_steps.py's stand-in in jnp and
torch for the comparisons with JAX (the R50 step takes about half a minute
to compile in JAX), and the port's own network at a small width (2 encoder
layers, 2 decoder layers, hidden 64) against the port's one-process step.
JAX's random draws are rebuilt from its keys and each rank is handed its
clip's rows (`draws=`); DROPOUT is 0.

Tolerances, as tests/test_torch_train.py: losses and metrics rtol 1e-4,
clipped gradients rtol 1e-3 / atol 1e-7 against JAX; against the port's
one-process step rtol 1e-5 / atol 1e-9 (the same f32 arithmetic, only the
batch's sums split across the ranks). The ranks' parameters after a step
are bit-identical.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from s2d_tpu.config import load_config as jax_load_config
from s2d_tpu.train import TrainState as JaxTrainState
from s2d_tpu.train import build_optimizer as jax_build_optimizer
from s2d_tpu.train import make_train_step as jax_make_train_step

import ddp_ranks
from s2d_tpu_torch.config import load_config_tree
from s2d_tpu_torch.losses.criterion import draw_bernoulli, draw_pool
from s2d_tpu_torch.train import trainer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

B, T, H, W, N, Q = 2, 2, 32, 40, 3, 8
STANDIN = ["MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", str(Q), "MODEL.MASK_FORMER.DEC_LAYERS", "3",
           "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "SOLVER.AMP.ENABLED", "False",
           "MODEL.MASK_FORMER.DROPOUT", "0.0", "SOLVER.IMS_PER_BATCH", str(B)]
SMALL = ["MODEL.MASK_FORMER.HIDDEN_DIM", "64", "MODEL.SEM_SEG_HEAD.MASK_DIM", "64",
         "MODEL.SEM_SEG_HEAD.CONVS_DIM", "64", "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", str(Q),
         "MODEL.MASK_FORMER.NHEADS", "4", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "128",
         "MODEL.MASK_FORMER.DEC_LAYERS", "2", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "2",
         "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "SOLVER.AMP.ENABLED", "False",
         "MODEL.MASK_FORMER.DROPOUT", "0.0", "SOLVER.IMS_PER_BATCH", str(B)]
SEED = 3


def standin_params():
    """tests/test_torch_train_option_steps.py's stand-in parameters: an
    ellipse a query, queries 0-3 over the distillation threshold."""
    rng = np.random.RandomState(0)
    h4, w4 = H // 4, W // 4
    yy, xx = np.mgrid[:h4, :w4]
    centres = [(2, 2), (2, 2), (5, 7), (2, 7), (5, 2), (4, 4), (6, 8), (1, 5)]
    bias = np.stack([4 * (1 - ((yy - cy) / 1.7) ** 2 - ((xx - cx) / 2.2) ** 2)
                     for cy, cx in centres]).clip(-6, 6)
    b_cls = np.zeros((Q, 2))
    b_cls[:4, 0], b_cls[4:, 0] = 2.0, -1.0
    return {"w_mask": 0.2 * rng.randn(Q, 3), "bias": bias, "w_cls": 0.05 * rng.randn(3, 2),
            "b_cls": b_cls, "scale": np.array([0.7, 1.0])}


def jax_forward(p, images):
    b, t, h, w, _ = images.shape
    pooled = images.reshape(b, t, h // 4, 4, w // 4, 4, 3).mean(axis=(3, 5))
    base = jnp.einsum("bthwc,qc->bqthw", pooled, p["w_mask"]) + p["bias"][None, :, None]
    logits = (pooled.mean(axis=(1, 2, 3)) @ p["w_cls"])[:, None, :] + p["b_cls"][None]
    layers = [(logits * s, base * s) for s in p["scale"]]
    return {"pred_logits": layers[-1][0], "pred_masks": layers[-1][1],
            "aux_pred_logits": [l for l, _ in layers[:-1]],
            "aux_pred_masks": [m for _, m in layers[:-1]]}


class JaxStandIn:
    def apply(self, variables, images, deterministic=True, rngs=None, frame_valid=None):
        return jax_forward(variables["params"], images)


def make_batch():
    """B=2 clips: 3 valid targets in the first, 1 in the second, and an
    empty frame (DropLoss)."""
    rng = np.random.RandomState(1)
    images = rng.randn(B, T, H, W, 3).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    cy, cx = rng.uniform(8, 24, (B, N, T, 1, 1)), rng.uniform(8, 32, (B, N, T, 1, 1))
    masks = ((yy - cy) / 6) ** 2 + ((xx - cx) / 8) ** 2 < 1
    masks[0, 0, 1] = False
    valid = np.array([[True, True, True], [True, False, False]])
    return images, masks, valid


def rank_draws(draws, world=2):
    """Each rank's share of the global batch's draws: the shared pool, and
    its clip's rows of each Bernoulli draw."""
    return [{"pool": draws["pool"],
             "bern": {r // world: bern[k * r // world:(k + 1) * r // world]
                      for r, bern in draws["bern"].items()}} for k in range(world)]


def jax_draws(key):
    """JAX's criterion draws of its step 0 from `key`: the pool and a
    Bernoulli draw a row count (JAX's trainer.py:256, criterion.py:406)."""
    k_sup = jax.random.split(jax.random.fold_in(key, 0), 3)[1]
    _, k_pool, k_bern = jax.random.split(k_sup, 3)
    num_random = 64 - int(0.75 * 64)
    return {"pool": torch.from_numpy(np.array(jax.random.uniform(k_pool, (192, 2)))),
            "bern": {r: torch.from_numpy(np.array(jax.random.uniform(k_bern, (r, 192))
                                                  < num_random / 192))
                     for r in (B * N * T, B * Q * T)}}


def jax_step(key):
    """JAX's step over the global batch: its metrics and clipped gradients
    (from Adam's first moment: mu = 0.1 g after one step)."""
    images, masks, valid = make_batch()
    cfg = jax_load_config(None, STANDIN)
    params = {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                               standin_params())}
    tx = jax_build_optimizer(cfg, params)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params, teacher_params=params,
                          opt_state=tx.init(params))
    after, metrics = jax.jit(jax_make_train_step(JaxStandIn(), cfg, tx))(
        state, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(valid), key)
    mu = {"/".join(k[1:]): np.asarray(v) / np.float32(0.1)
          for k, v in flatten_dict(after.opt_state[1].mu).items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": mu}


def model_draws():
    """Draws of the small network's step over the global batch (torch's)."""
    cfg = trainer.make_train_step(load_config_tree(None, SMALL), kernels=False).crit_cfg
    gen = torch.Generator().manual_seed(SEED)
    return {"pool": draw_pool(cfg, gen, "cpu"),
            "bern": {r: draw_bernoulli(cfg, r, gen, "cpu", 192) for r in (B * N * T, B * Q * T)}}


def one_process_step():
    """The port's step over the whole batch in one process: the small
    network's metrics and clipped gradients."""
    images, masks, valid = make_batch()
    cfg = load_config_tree(None, SMALL)
    state = trainer.create_train_state(cfg, seed=SEED, device="cpu", kernels=False)
    metrics, clipped = ddp_ranks.run_step(
        state, trainer.make_train_step(cfg, kernels=False),
        [torch.from_numpy(a) for a in (images, masks, valid)], model_draws())
    return {"metrics": metrics, "clipped": dict(zip(state.optimizer.names, clipped))}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """One start of 2 ranks, which run the stand-in's step (global
    normalizers), the same with each rank's own means averaged, the step
    with a NaN in rank 1's clip, and the small network's step; meanwhile
    this process runs JAX's step and the port's one-process step."""
    key = jax.random.PRNGKey(2)
    images, masks, valid = make_batch()
    bad = images.copy()
    bad[1, 0, 0, 0, 0] = np.nan
    standin = {"network": "standin", "opts": STANDIN, "params": standin_params(),
               "draws": rank_draws(jax_draws(key))}
    job = {"runs": {
        "global": {**standin, "batch": (images, masks, valid)},
        "local_mean": {**standin, "batch": (images, masks, valid), "local_mean": True},
        "nan_on_rank1": {**standin, "batch": (bad, masks, valid)},
        "model": {"network": "model", "opts": SMALL, "seed": SEED,
                  "batch": (images, masks, valid), "draws": rank_draws(model_draws())},
    }}
    out_dir = str(tmp_path_factory.mktemp("ddp"))
    running = ddp_ranks.start(job, 2, out_dir)
    found = {"jax": jax_step(key), "one": one_process_step()}
    return {**found, "ranks": ddp_ranks.results(running, 2, out_dir)}


def test_ddp_step_matches_jax_global_batch(case):
    """Each rank's logged metrics are JAX's over the global batch; the
    gradients the optimizer takes, clipped, are JAX's."""
    jax_step = case["jax"]
    for rank in case["ranks"]:
        got = rank["global"]
        for k, v in got["metrics"].items():
            np.testing.assert_allclose(v, jax_step["metrics"][k], rtol=1e-4, err_msg=k)
        for name, g in got["clipped"].items():
            np.testing.assert_allclose(g, jax_step["grads"][name], rtol=1e-3, atol=1e-7,
                                       err_msg=name)
        assert got["after"] != got["before"] and got["step"] == 1


def test_ranks_hold_bit_identical_parameters(case):
    ranks = case["ranks"]
    for run in ("global", "model", "nan_on_rank1"):
        assert ranks[0][run]["after"] == ranks[1][run]["after"], run


def test_unequal_target_counts_need_global_normalizers(case):
    """The clips hold 3 and 1 valid targets: the mean of the ranks' own
    normalized losses misses JAX's loss_mask and gradients by far more
    than the tolerance that the global normalizers meet."""
    jax_step = case["jax"]
    local, ref = case["ranks"][0]["local_mean"], jax_step["metrics"]
    assert abs(local["metrics"]["loss_mask"] - ref["loss_mask"]) > 100 * 1e-4 * abs(ref["loss_mask"])
    worst = max(np.abs(g - jax_step["grads"][n]).max() / (np.abs(jax_step["grads"][n]).max() + 1e-30)
                for n, g in local["clipped"].items())
    assert worst > 0.05


def test_nonfinite_loss_on_one_rank_skips_both(case):
    """A NaN in rank 1's clip makes the global loss non-finite: both ranks
    skip the update (parameters held, the step counted)."""
    for rank in case["ranks"]:
        got = rank["nan_on_rank1"]
        assert got["metrics"]["grad_finite"] == 0.0
        assert got["after"] == got["before"] and got["step"] == 1


def test_ddp_step_matches_one_process_step(case):
    """The small network: the ranks' step equals the port's step over the
    whole batch in one process, from the same seeded state and draws."""
    got, one = case["ranks"][0]["model"], case["one"]
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, one["metrics"][k], rtol=1e-5, err_msg=k)
    for name, g in one["clipped"].items():
        np.testing.assert_allclose(got["clipped"][name], g.numpy(), rtol=1e-5, atol=1e-9,
                                   err_msg=name)
    assert got["after"] != got["before"]
