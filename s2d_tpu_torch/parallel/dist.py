"""The job's process group: the counterpart of `s2d_tpu/parallel/mesh.py`
(the train step written over the global batch, data-parallel over the
devices) and of `s2d_tpu/utils/jax_setup.py`'s `maybe_init_distributed` and
`multihost_barrier`.

Launch one process per card with torchrun, on one node or several:

    python -m torch.distributed.run --nproc-per-node W \\
        -m s2d_tpu_torch.train_net_video --config-file cfg.yaml ...
    python -m torch.distributed.run --nnodes 2 --node-rank R --nproc-per-node 8 \\
        --master-addr HOST0 --master-port 29500 -m s2d_tpu_torch.train_net_video ...

`init` reads torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT): rank r runs on `cuda:LOCAL_RANK`, over NCCL for
a CUDA device and gloo for the CPU; `backend=` overrides the choice (the
tests, and two ranks sharing one card, take gloo over CUDA tensors). A CUDA
rank whose NCCL set-up fails raises: it never goes on over gloo or on the
CPU. At a world size of 1 nothing is initialized and `init` returns no group.

`ProcessGroup` is what the train step and the CLI's loop and evals hold: `rank`, `size`, `is_main`, `barrier(name)`,
`all_reduce_sum(tensors)` (one flat bucket a dtype, as DDP's gradient
buckets) and `broadcast_(tensors)` (rank 0's values into every rank's).
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# a barrier waits for the slowest rank (an eval shard, a checkpoint write)
TIMEOUT = datetime.timedelta(minutes=30)


def _flat_groups(tensors: Sequence[torch.Tensor]):
    """Indices of `tensors` grouped by (dtype, device), in order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return groups.values()


class ProcessGroup:
    """The default torch.distributed group of this job, and its device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = dist.get_backend()

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self, name: str) -> None:
        """Every rank waits here until all have come (a checkpoint written,
        the eval shards on disk); `name` names it in a timeout's error."""
        try:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()
        except RuntimeError as err:
            raise RuntimeError(f"barrier {name!r} on rank {self.rank}: {err}") from err

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sums over the ranks of `tensors` (new tensors), through one
        flat bucket for each dtype."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for idx in _flat_groups(tensors):
            bucket = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(bucket, op=dist.ReduceOp.SUM)
            for i, part in zip(idx, bucket.split([tensors[i].numel() for i in idx])):
                out[i] = part.view_as(tensors[i])
        return out

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Rank `src`'s values of `tensors` into every rank's, in place."""
        with torch.no_grad():
            for idx in _flat_groups(tensors):
                bucket = torch.cat([tensors[i].reshape(-1) for i in idx])
                dist.broadcast(bucket, src=src)
                for i, part in zip(idx, bucket.split([tensors[i].numel() for i in idx])):
                    tensors[i].copy_(part.view_as(tensors[i]))


def init(device: str = "cuda", backend: Optional[str] = None) -> tuple:
    """(group, device) of this process: the group (None at a world size of
    1) and its device, `cuda:LOCAL_RANK` for "cuda". A first collective runs
    here, so that a backend that cannot reach the other ranks fails now."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = torch.device(device)
    if world <= 1:
        return None, dev
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        return ProcessGroup(dev), dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]), timeout=TIMEOUT, **kwargs)
    group = ProcessGroup(dev)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"process group check: {int(probe.item())} ranks answered, not {world}")
    return group, dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
