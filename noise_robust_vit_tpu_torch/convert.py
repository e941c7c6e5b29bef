"""Weight bridge: a JAX (flax) variable tree → the port's ``state_dict``.

The tree arrives as nested dicts of numpy arrays (``model.init(...)`` pulled
through ``jax.device_get``): the parameters alone, or the variables
``{"params": ..., "batch_stats": ...}`` of a model with BatchNorm.
Paths map by name, because the port's modules carry the flax names
(``transformer/layers_0_attn/to_qkv/kernel`` →
``transformer.layers_0_attn.to_qkv.weight``):

* a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``
  (also inside Swin v2's ``cpb_fc1`` / ``cpb_fc2``);
* a Conv ``kernel`` HWIO ``[kh, kw, in, out]`` becomes torch's OIHW
  ``[out, in, kh, kw]``;
* a LayerNorm or BatchNorm ``scale`` becomes ``weight``;
* a ``bias`` stays ``bias``;
* a BatchNorm's ``batch_stats`` ``mean`` and ``var`` become the buffers
  ``running_mean`` and ``running_var``;
* any other named leaf is a parameter of the module itself and keeps its
  name and layout (Swin's ``relative_position_bias_table``, v2's
  ``qkv_bias`` and ``logit_scale``, LeViT's ``attention_biases``, CaiT's
  LayerScale ``scale_attn_{i}`` / ``scale_ff_{i}``, its head mixes
  ``mix_heads_pre_attn`` / ``mix_heads_post_attn``, ``pos_embedding`` and
  ``cls_token``; the VisionTransformer's ``encoder/pos_embedding``
  ``[1, N + 1, D]`` and ``class_token`` ``[1, 1, D]``).

A ``FusedLayerNorm`` takes the same ``weight`` and ``bias`` as a LayerNorm.
The VisionTransformer's tree maps whole: its patchify ``conv_proj`` or stem
``conv_bn_relu_{i}_conv`` / ``conv_last`` kernels as Conv kernels, its stem
``conv_bn_relu_{i}_bn`` scales and ``batch_stats``, and every Dense
(``self_attention/to_qkv``, ``to_out``, ``mlp/fc1``, ``fc2``,
``pre_logits``, ``head``).

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


_STATS = {"mean": "running_mean", "var": "running_var"}


def convert_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax parameter tree, or a ``{"params", "batch_stats"}``
    variable tree, onto the port's ``state_dict`` names."""
    state = {}
    if set(params) <= {"params", "batch_stats"} and "params" in params:
        for path, value in _flatten_tree(params.get("batch_stats", {})).items():
            *module, leaf = path
            state[".".join([*module, _STATS[leaf]])] = torch.tensor(
                np.ascontiguousarray(value, dtype=np.float32))
        params = params["params"]
    for path, value in _flatten_tree(params).items():
        *module, leaf = path
        name = leaf
        if leaf == "kernel":
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'/'.join(path)}: a kernel must be a Dense [in, out] "
                                 f"or a 2-D Conv HWIO, got shape {value.shape}")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        state[".".join([*module, name])] = torch.tensor(
            np.ascontiguousarray(value, dtype=np.float32))
    return state
