"""The ranks of tests/test_torch_ddp.py: `start(job, world, out_dir)`
starts `world` processes joined by gloo on localhost, each running
`rank_main` on the job (a dict of what to run and its inputs) and saving
what it found for the test to read (`results`). Torch only: the ranks import neither JAX nor s2d_tpu,
and run torch on one thread."""
import hashlib
import os
import socket

import numpy as np
import torch
import torch.multiprocessing as mp

from s2d_tpu_torch.config import load_config_tree
from s2d_tpu_torch.parallel import dist
from s2d_tpu_torch.train import trainer
from s2d_tpu_torch.train.optim import KDOptimizer


class StandIn(torch.nn.Module):
    """tests/test_torch_train_option_steps.py's stand-in network in torch:
    per query an ellipse of mask logits at stride 4 plus a linear map of
    the 4x4-pooled colours, a class head on the pooled mean, aux layers
    scaling the outputs."""

    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(torch.tensor(v, dtype=torch.float32)))

    def forward(self, images, generator=None, frame_valid=None):
        b, t, h, w, _ = images.shape
        pooled = images.reshape(b, t, h // 4, 4, w // 4, 4, 3).mean(dim=(3, 5))
        base = torch.einsum("bthwc,qc->bqthw", pooled, self.w_mask) + self.bias[None, :, None]
        logits = (pooled.mean(dim=(1, 2, 3)) @ self.w_cls)[:, None, :] + self.b_cls[None]
        layers = [(logits * s, base * s) for s in self.scale]
        return {"pred_logits": layers[-1][0], "pred_masks": layers[-1][1],
                "aux_pred_logits": [l for l, _ in layers[:-1]],
                "aux_pred_masks": [m for _, m in layers[:-1]]}


def standin_state(cfg, params):
    student = StandIn(params)
    teacher = StandIn(params).eval().requires_grad_(False)
    return trainer.TrainState(0, student, teacher, KDOptimizer(list(student.named_parameters()), cfg))


def params_hash(state) -> str:
    digest = hashlib.sha256()
    for p in state.optimizer.params:
        digest.update(p.detach().numpy().tobytes())
    return digest.hexdigest()


def run_step(state, step_fn, batch, draws):
    """One step; returns (metrics, the gradients the optimizer took, clipped)."""
    taken = []
    own = state.optimizer.step
    state.optimizer.step = lambda grads: (taken.append(list(grads)), own(grads))
    try:
        _, metrics = step_fn(state, *batch, draws=draws)
    finally:
        del state.optimizer.step
    clipped = state.optimizer.clip_gradients(taken[0]) if taken else None
    return {k: float(v) for k, v in metrics.items()}, clipped


def rank_main(rank: int, world: int, port: int, job: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    group, _ = dist.init("cpu")
    out = {}
    try:
        mine = lambda batch: [torch.from_numpy(np.ascontiguousarray(a[rank::world]))  # noqa: E731
                              for a in batch]
        for name, run in job["runs"].items():
            cfg = load_config_tree(None, run["opts"])
            if run["network"] == "standin":
                state = standin_state(cfg, run["params"])
            else:
                state = trainer.create_train_state(cfg, seed=run["seed"], device="cpu",
                                                   kernels=False)
            if run["network"] == "standin":  # (the seeded network is the same on every rank)
                group.broadcast_(trainer.state_tensors(state))
            before = params_hash(state)
            batch = mine(run["batch"])
            if run.get("local_mean"):  # DDP's convention: each rank's own means, averaged
                _, metrics, grads = trainer.make_train_step(cfg, kernels=False).loss_and_grads(
                    state, *batch, draws=run["draws"][rank])
                summed = group.all_reduce_sum([*grads, *(v.reshape(1) for v in metrics.values())])
                grads = [g / world for g in summed[:len(grads)]]
                metrics = {k: float(v) / world for k, v in zip(metrics, summed[len(grads):])}
                clipped = state.optimizer.clip_gradients(grads)
            else:
                metrics, clipped = run_step(state, trainer.make_train_step(
                    cfg, kernels=False, group=group), batch, run["draws"][rank])
            out[name] = {"metrics": metrics, "before": before, "after": params_hash(state),
                         "step": state.step,
                         "clipped": None if clipped is None or (rank and run["network"] != "standin")
                         else {n: g.numpy() for n, g in zip(state.optimizer.names, clipped)}}
    finally:
        dist.shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(job: dict, world: int, out_dir: str):
    """Starts `job` in `world` ranks and returns at once; `results` waits."""
    return mp.start_processes(rank_main, args=(world, free_port(), job, out_dir), nprocs=world,
                              start_method="spawn", join=False)


def results(context, world: int, out_dir: str) -> list:
    """Waits for the ranks of `start`; returns each rank's results."""
    while not context.join():
        pass
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
