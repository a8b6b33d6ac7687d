"""Config scaling rules of the reference trainer, as `s2d_tpu/train/scaling.py`.

  * `auto_scale_workers`: when REFERENCE_WORLD_SIZE differs from the worker
    count, scale the total batch and the LR with it and the iterations,
    warmup and milestones inversely (detectron2's rule);
  * `apply_accum_lr_scale`: BASE_LR *= effective batch / 2 when ACCUM_ITER > 1.
"""
from __future__ import annotations

import dataclasses

from ..config import Config


def auto_scale_workers(cfg: Config, num_workers: int) -> Config:
    old = cfg.solver.reference_world_size
    if old == 0 or old == num_workers:
        return cfg
    if cfg.solver.ims_per_batch % old:
        raise ValueError(f"IMS_PER_BATCH {cfg.solver.ims_per_batch} not divisible by "
                         f"REFERENCE_WORLD_SIZE {old}")
    scale = num_workers / old
    solver = dataclasses.replace(
        cfg.solver,
        ims_per_batch=cfg.solver.ims_per_batch // old * num_workers,
        base_lr=cfg.solver.base_lr * scale,
        max_iter=int(round(cfg.solver.max_iter / scale)),
        warmup_iters=int(round(cfg.solver.warmup_iters / scale)),
        steps=tuple(int(round(s / scale)) for s in cfg.solver.steps),
        reference_world_size=num_workers,
    )
    return dataclasses.replace(cfg, solver=solver)


def apply_accum_lr_scale(cfg: Config) -> Config:
    if cfg.solver.accum_iter <= 1:
        return cfg
    effective = cfg.solver.ims_per_batch * cfg.solver.accum_iter
    solver = dataclasses.replace(cfg.solver, base_lr=cfg.solver.base_lr * effective / 2.0)
    return dataclasses.replace(cfg, solver=solver)
