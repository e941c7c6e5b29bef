"""Weight bridge: a JAX (flax) parameter tree → the port's ``state_dict``.

The tree arrives as nested dicts of numpy arrays (``model.init(...)`` pulled
through ``jax.device_get``), optionally under a top-level ``"params"`` key.
Paths map by name, because the port's modules carry the flax names
(``transformer/layers_0_attn/to_qkv/kernel`` →
``transformer.layers_0_attn.to_qkv.weight``):

* a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``;
* a LayerNorm ``scale`` becomes ``weight``;
* a ``bias`` stays ``bias``.

Only numpy is needed on the way in, so this imports where JAX is absent.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["convert_params"]


def _flatten_tree(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    """``{path tuple: array}`` over the leaves of a nested mapping."""
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def convert_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax parameter tree onto the port's ``state_dict`` names."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, value in _flatten_tree(params).items():
        *module, leaf = path
        if leaf == "kernel":
            if value.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: only Dense kernels are "
                                 f"mapped, got shape {value.shape}")
            name, value = "weight", value.T
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"{'/'.join(path)}: no mapping for leaf {leaf!r}")
        state[".".join([*module, name])] = torch.tensor(
            np.asarray(value, dtype=np.float32))
    return state
