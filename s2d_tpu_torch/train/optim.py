"""The KD optimizer, as `s2d_tpu/train/optim.py`: AdamW with d2-style groups.

The update is the JAX package's optax chain, step for step:

  clip by global norm (SOLVER.CLIP_GRADIENTS, over EVERY gradient, FrozenBN
  affines included: they are flax params there)
  -> Adam(0.9, 0.999, eps 1e-8) with bias correction
  -> + WEIGHT_DECAY * param on conv/linear kernels and biases
  -> x the group multiplier (BACKBONE_MULTIPLIER for the backbone, 0 for
     the FrozenBN affines)
  -> x -lr(count), the warmup multi-step schedule of the update count,

and with ACCUM_ITER > 1 it is wrapped as `optax.MultiSteps`: the gradients
of ACCUM_ITER micro-steps are averaged (a running mean) and the chain runs
on the average every ACCUM_ITER-th call; the other calls leave the
parameters as they are. The state is updated in place.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from .schedules import warmup_multistep_lr

NORM_SUFFIXES = ("_gn", "_norm", "norm", "norm0", "norm1", "norm2", "norm3")
EMBED_LEAVES = ("query_feat", "query_embed", "level_embed",
                "relative_position_bias_table", "absolute_pos_embed")
B1, B2, EPS = 0.9, 0.999, 1e-8


def label_params(names: Sequence[str], frozen_backbone_norms: bool = True) -> Dict[str, str]:
    """Label each parameter name: 'frozen' | '<group>_decay' |
    '<group>_nodecay', group in {backbone, head}. The port's names follow
    the flax tree, so the JAX package's rules apply to them unchanged."""
    labels = {}
    for name in names:
        parts = name.split(".")
        in_backbone = "backbone" in parts
        parent = parts[-2] if len(parts) >= 2 else ""
        is_norm = parent.endswith(NORM_SUFFIXES) or parent == "norm"
        if in_backbone and is_norm and frozen_backbone_norms:
            labels[name] = "frozen"  # FrozenBN affine
        elif parts[-1] in EMBED_LEAVES or is_norm:
            labels[name] = "backbone_nodecay" if in_backbone else "head_nodecay"
        else:
            labels[name] = "backbone_decay" if in_backbone else "head_decay"
    return labels


class KDOptimizer:
    """AdamW of the KD trainer over `named_params` (held in this order)."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]], cfg: Config):
        solver = cfg.solver
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        labels = label_params(
            self.names, frozen_backbone_norms="swin" not in cfg.model.backbone.name.lower())
        table = {"frozen": 0.0, "backbone_decay": solver.backbone_multiplier,
                 "backbone_nodecay": solver.backbone_multiplier, "head_decay": 1.0,
                 "head_nodecay": 1.0}
        self.labels = [labels[n] for n in self.names]
        self.multipliers = [table[lab] for lab in self.labels]
        self.decay = [lab.endswith("_decay") for lab in self.labels]
        self.weight_decay = solver.weight_decay
        self.clip = solver.clip_gradients.clip_value if solver.clip_gradients.enabled else None
        self.schedule = warmup_multistep_lr(
            solver.base_lr, solver.steps, solver.gamma, solver.warmup_iters, solver.warmup_factor)
        self.accum_iter = max(solver.accum_iter, 1)
        with torch.no_grad():
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
            self.acc = ([torch.zeros_like(p) for p in self.params]
                        if self.accum_iter > 1 else None)
        self.count = 0  # Adam's update count (also the schedule's)
        self.mini_step = 0

    def state_dict(self) -> dict:
        """Adam's moments, the accumulator (ACCUM_ITER > 1), the update count
        and the micro-step; the tensors in parameter order, by reference."""
        return {"names": list(self.names), "mu": list(self.mu), "nu": list(self.nu),
                "acc": None if self.acc is None else list(self.acc),
                "count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` of an optimizer over the same parameters in."""
        if list(state["names"]) != self.names:
            raise ValueError("the optimizer state names other parameters than this optimizer's")
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("the optimizer state and this optimizer differ in ACCUM_ITER")
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc or [], state["acc"] or [])):
            for dst, src in zip(mine, theirs, strict=True):
                dst.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def clip_gradients(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: scale by max_norm / norm when the
        global norm is not below max_norm."""
        if self.clip is None:
            return list(grads)
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        if bool(norm < self.clip):
            return list(grads)
        return torch._foreach_mul(torch._foreach_div(grads, norm), self.clip)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """One call with this micro-step's gradients (one per parameter).
        Returns True where the parameters were updated."""
        grads = [g.float() for g in grads]
        if self.acc is not None:
            # running mean over the micro-steps (MultiSteps' use_grad_mean)
            n_acc = float(self.mini_step + 1)
            self.acc = [a + (g - a) / n_acc for g, a in zip(grads, self.acc)]
            self.mini_step = (self.mini_step + 1) % self.accum_iter
            if self.mini_step:
                return False
            grads, self.acc = self.acc, [torch.zeros_like(a) for a in self.acc]
        self._update(self.clip_gradients(grads))
        return True

    def _update(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(B1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(B2) ** c)
        # the schedule reads the count before this update
        neg_lr = float(-self.schedule(self.count - 1))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu, nu = self.mu[i], self.nu[i]
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            if self.multipliers[i] == 0.0:
                continue  # p + (-lr * 0 * u) = p
            u = (mu / bc1) / ((nu / bc2).sqrt() + EPS)
            if self.decay[i]:
                u = u + self.weight_decay * p
            if self.multipliers[i] != 1.0:
                u = u * self.multipliers[i]
            p.add_(neg_lr * u)
