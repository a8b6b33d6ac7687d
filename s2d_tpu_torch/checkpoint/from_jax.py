"""Load the JAX package's flax parameters into the port, and back.

The port's parameter names follow the flax tree, so each flax leaf maps to
exactly one port tensor:

  a/b/kernel (4-D, HWIO)  -> a.b.weight, transposed to OIHW
  a/b/kernel (2-D, in,out) -> a.b.weight, transposed to (out, in)
  a/out/kernel (3-D, heads, head_dim, out) and a/b/kernel (3-D, in, heads,
  head_dim): the output and input projections of flax's
  MultiHeadDotProductAttention -> a.out.weight (out, heads*head_dim) and
  a.b.weight (heads*head_dim, in), as torch Linears
  a/b/bias (2-D, heads, head_dim) -> a.b.bias, flattened
  a/b/scale               -> a.b.weight (LayerNorm, GroupNorm, FrozenBN)
  any other leaf          -> its own name (bias, level_embed, query_feat,
                             in_proj_weight, ...)

Input is the flax `variables` flattened to numpy with "/" separators, e.g.
`{"/".join(k): np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
variables).items()}` (a leading "params/" is accepted), or an .npz of it.
`params_to_jax` is the inverse for 2-D and 4-D kernels: the port's tensors
under their flax names (an attention projection's heads are not recovered).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _port_name(path: str) -> str:
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _port_value(path: str, value: np.ndarray) -> np.ndarray:
    parts = path.split("/")
    if parts[-1] == "bias" and value.ndim == 2:  # (heads, head_dim)
        return value.reshape(-1)
    if parts[-1] != "kernel":
        return value
    if value.ndim == 4:  # HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 2:  # (in, out) -> (out, in)
        return value.T
    if value.ndim == 3 and parts[-2] == "out":  # (heads, head_dim, out) -> (out, in)
        return value.reshape(-1, value.shape[-1]).T
    if value.ndim == 3:  # (in, heads, head_dim) -> (out, in)
        return value.reshape(value.shape[0], -1).T
    raise ValueError(f"{path}: kernel of rank {value.ndim}")


def params_from_jax(
    flat: Mapping[str, np.ndarray], reference: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> the port's state_dict (float32 CPU tensors).

    Raises on any leaf left over, any tensor of `reference` (a port model's
    `state_dict()`) missing, or any shape that disagrees."""
    state = {}
    for path, value in flat.items():
        name = _port_name(path)
        if name in state:
            raise KeyError(f"two flax leaves map to {name!r}")
        arr = np.ascontiguousarray(_port_value(path, np.asarray(value, dtype=np.float32)))
        state[name] = torch.from_numpy(arr)
    extra = sorted(set(state) - set(reference))
    missing = sorted(set(reference) - set(state))
    if extra or missing:
        raise KeyError(f"flax leaves with no port tensor: {extra}; "
                       f"port tensors with no flax leaf: {missing}")
    for name, tensor in state.items():
        if tuple(tensor.shape) != tuple(reference[name].shape):
            raise ValueError(f"{name}: flax {tuple(tensor.shape)} vs port "
                             f"{tuple(reference[name].shape)}")
    return state


def load_params_from_jax(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy flattened flax params into `model`, strictly (see params_from_jax)."""
    state = params_from_jax(flat, model.state_dict())
    model.load_state_dict(state, strict=True)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _jax_leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    parts = name.split(".")
    if parts[-1] == "weight":
        if value.ndim == 4:  # OIHW -> HWIO
            return "/".join(parts[:-1] + ["kernel"]), value.transpose(2, 3, 1, 0)
        if value.ndim == 2:  # (out, in) -> (in, out)
            return "/".join(parts[:-1] + ["kernel"]), value.T
        return "/".join(parts[:-1] + ["scale"]), value
    return "/".join(parts), value


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's state_dict -> flattened flax params ("params/..." keys,
    float32 numpy), the inverse of `params_from_jax`."""
    flat = {}
    for name, tensor in state.items():
        path, value = _jax_leaf(name, tensor.detach().float().cpu().numpy())
        flat["params/" + path] = np.ascontiguousarray(value)
    return flat
