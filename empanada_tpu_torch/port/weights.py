"""Weight bridge from the JAX package's flax variables to the port's
modules.

The port names its submodules after the flax modules, so a flax leaf
``params/<a>/<b>/.../<leaf>`` maps to the state-dict key ``a.b....<name>``:

- conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise (k, k, 1, C) -> (C, 1, k, k));
- ``ConvTranspose`` kernel (a ``tconv`` module) HWIO -> ``weight`` IOHW,
  flipped in space: flax's ``ConvTranspose`` (``transpose_kernel=False``)
  computes ``y[s*i + a] = x[i] k[s - 1 - a]`` where torch's
  ``conv_transpose2d`` computes ``y[s*i + a] = x[i] W[a]``;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- ``bias`` -> ``bias``; BatchNorm ``scale`` -> ``weight``;
- ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flatten_variables", "from_flax", "load_flax"]

_RENAME = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "fusion_weights"): "fusion_weights",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def flatten_variables(variables, prefix=()) -> dict:
    """Nested flax variables (dicts of arrays) -> {path tuple: array}."""
    flat = {}
    for k, v in variables.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(flatten_variables(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _convert(module: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and a.ndim == 4 and module == "tconv":
        return np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
    if leaf == "kernel" and a.ndim == 4:
        return np.transpose(a, (3, 2, 0, 1))
    if leaf == "kernel" and a.ndim == 2:
        return a.T
    return a


def from_flax(variables, model: torch.nn.Module) -> dict:
    """A state dict for ``model`` from flax ``variables`` (numpy leaves).

    Raises on a flax leaf that maps to no parameter of ``model``, on a
    parameter of ``model`` that no leaf sets, and on a shape mismatch.
    """
    expected = model.state_dict()
    state = {}
    for path, a in flatten_variables(variables).items():
        col, *mods, leaf = path
        if (col, leaf) not in _RENAME:
            raise KeyError(f"flax leaf {'/'.join(path)} has no port counterpart")
        key = ".".join(mods + [_RENAME[col, leaf]])
        if key not in expected:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: not a port parameter")
        if key in state:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: set twice")
        a = _convert(mods[-1] if mods else "", leaf, np.asarray(a))
        t = torch.from_numpy(np.array(a, order="C"))
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: flax shape {tuple(t.shape)} != port shape "
                             f"{tuple(expected[key].shape)}")
        state[key] = t
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port parameters left unset by the flax variables: {missing}")
    return state


def load_flax(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax ``variables`` into ``model`` (any device and dtype)."""
    model.load_state_dict(from_flax(variables, model))
    return model
