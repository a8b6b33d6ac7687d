"""Training schedules as functions of the step, as `s2d_tpu/train/schedules.py`:
the warmup multi-step learning rate, the supervised / KD loss-weight factors
and the EMA momentum. Computed in float32 with the JAX package's
association, so that the port's optimizer steps by the same rates.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

from ..config import Config

f32 = np.float32


def warmup_multistep_lr(
    base_lr: float,
    steps: Sequence[int],
    gamma: float = 0.1,
    warmup_iters: int = 10,
    warmup_factor: float = 1.0,
) -> Callable[[int], np.float32]:
    """d2's WarmupMultiStepLR: base_lr * gamma^(milestones passed), times a
    linear warmup from warmup_factor over warmup_iters."""
    milestones = np.asarray(sorted(steps), np.float32)

    def schedule(step: int) -> np.float32:
        step = f32(step)
        decay = f32(gamma) ** f32(np.sum(step >= milestones))
        alpha = np.clip(step / f32(max(warmup_iters, 1)), f32(0.0), f32(1.0))
        warmup = f32(1.0) if step >= warmup_iters else f32(warmup_factor) * (f32(1.0) - alpha) + alpha
        return f32(base_lr) * decay * warmup

    return schedule


def _schedule_q(step, start, end):
    q = (f32(step) - f32(start)) / f32(max(end - start, 1.0))
    return np.clip(q, f32(0.0), f32(1.0))


def loss_weight_factors(cfg: Config, max_iter: int) -> Callable[[int], Tuple[np.float32, np.float32]]:
    """fn(step) -> (supervised factor, KD factor)."""
    mf = cfg.model.mask_former
    start = float(mf.kd_weight_decay_start)
    end = float(mf.kd_weight_decay_end)
    if end < 0:
        end = float(max_iter)
    sup_min = f32(mf.supervised_min_weight)
    kd_min = f32(mf.kd_min_weight)
    scheduler = mf.kd_weight_scheduler
    decay_step = float(mf.loss_weight_decay_step)

    def factors(step: int):
        if scheduler == "linear":
            q = _schedule_q(step, start, end)
        elif scheduler == "cosine":
            q = (f32(1.0) - np.cos(f32(np.pi) * _schedule_q(step, start, end))) / f32(2.0)
        if scheduler in ("linear", "cosine"):
            sup = sup_min + (f32(1.0) - sup_min) * (f32(1.0) - q)
            kd = kd_min + (f32(1.0) - kd_min) * q
            if mf.decay_only_supervised_loss:
                kd = f32(1.0)
            if mf.decay_only_kd_loss:
                sup = f32(1.0)
        else:
            sup, kd = f32(1.0), f32(1.0)
        if decay_step > 0 and step >= decay_step:
            sup = sup * sup_min
        return f32(sup), f32(kd)

    return factors


def ema_momentum_schedule(cfg: Config) -> Callable[[int], np.float32]:
    """The teacher's EMA momentum: constant, or cosine from EMA_MOMENTUM to
    EMA_MOMENTUM_END over EMA_MOMENTUM_UNTIL_STEP steps."""
    mf = cfg.model.mask_former
    m_start = f32(mf.ema_momentum)
    if not mf.ema_momentum_schedule:
        return lambda step: m_start
    m_end = f32(mf.ema_momentum_end)
    t_end = f32(max(mf.ema_momentum_until_step, 1))

    def schedule(step: int) -> np.float32:
        t = min(f32(step), t_end)
        return m_end - (m_end - m_start) * (np.cos(f32(np.pi) * t / t_end) + f32(1.0)) / f32(2.0)

    return schedule
