"""Torchvision-style VisionTransformer and its size builders (counterpart of
``noise_robust_vit_tpu/models/vision_transformer.py``, ref vit.py:178-519).

A conv patchify stem (``conv_proj``) or a conv-BN-ReLU stem
(``conv_bn_relu_{i}_conv`` / ``_bn`` + ``conv_last``), a zero-init class
token and a learned position embedding, pre-LN encoder blocks (``ln_1``,
``self_attention``, ``ln_2``, ``mlp``) and a final ``ln``, an optional
``pre_logits`` + tanh, and a zero-init ``head``. Input is NHWC. Every
LayerNorm has eps 1e-6 and is the plain one, at any width: the model
builds its own norms, so the shared blocks' width rule (``layers._ln_cls``)
does not reach it.

The attention is the shared ``Attention`` with biases on q/k/v and the
output, no pre-norm, and the vendored-MHA robust schedule: 4 Sinkhorn
iterations with no final row normalization (ref utils.py:218-224). At
vit_b_16's ``[B, 197, 2304]`` it takes the packed kernels.

``dropout`` and ``attention_dropout`` above 0 are refused: attention
dropout needs the attention-weights path, which is not ported yet, and the
port's train step carries no dropout generator. Builders
``vit_b_16/b_32/l_16/l_32/h_14`` per ref vit.py:377-519;
``interpolate_embeddings`` resizes the position embedding of a
``state_dict`` for a new image size (ref vit.py:522-603).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Sequence

import torch
from torch import nn

from .. import ops
from ..utils import (normal_init, resolve_device, trunc_normal_init, xavier_uniform_init,
                     zeros_init)
from .layers import Attention, BatchNorm, Conv, Dense, LayerNorm, PatchConv

__all__ = [
    "ConvStemConfig",
    "VisionTransformer",
    "interpolate_embeddings",
    "vit_b_16",
    "vit_b_32",
    "vit_h_14",
    "vit_l_16",
    "vit_l_32",
]


class ConvStemConfig(NamedTuple):
    out_channels: int
    kernel_size: int
    stride: int


class MLPBlock(nn.Module):
    """(ref vit.py:35-66) Dense → GELU → Dense; xavier-uniform kernels,
    normal(1e-6) biases."""

    def __init__(self, dim: int, mlp_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, kernel_init=xavier_uniform_init(),
                  bias_init=normal_init(1e-6))
        self.fc1 = Dense(dim, mlp_dim, **kw)
        self.fc2 = Dense(mlp_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(ops.gelu(self.fc1(x)))


class EncoderBlock(nn.Module):
    """(ref vit.py:87-130) pre-LN attention and pre-LN MLP with residuals."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int, robust: bool,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype, device=device)
        self.self_attention = Attention(
            hidden_dim, heads=num_heads, dim_head=hidden_dim // num_heads, robust=robust,
            qkv_bias=True, out_bias=True, pre_norm=False,
            # vendored-MHA schedule: 4 iterations, no final row norm
            sinkhorn_iters=4, final_row_norm=False, dtype=dtype, device=device)
        self.ln_2 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype, device=device)
        self.mlp = MLPBlock(hidden_dim, mlp_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Encoder(nn.Module):
    """(ref vit.py:133-176) learned position embedding ``[1, N + 1, D]``
    (normal(0.02)), the blocks ``layer_{i}``, the final ``ln``."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, robust: bool, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim, device=device))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderBlock(num_heads, hidden_dim, mlp_dim, robust,
                                                       dtype=dtype, device=device))
        self.ln = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype, device=device)
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        normal_init(0.02)(self.pos_embedding, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pos_embedding.to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.ln(x)


class VisionTransformer(nn.Module):
    """(ref vit.py:178-374), NHWC input of ``image_size`` pixels a side. On
    the card unless ``device`` says otherwise."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, num_classes: int = 1000,
                 representation_size: int | None = None,
                 conv_stem_configs: Sequence[ConvStemConfig] | None = None,
                 robust: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dropout > 0 or attention_dropout > 0:
            raise NotImplementedError(
                "VisionTransformer: dropout > 0 is not ported (attention dropout needs the "
                "attention-weights path, and the train step carries no dropout generator)")
        device = resolve_device(device)
        self.image_size, self.patch_size, self.hidden_dim = image_size, patch_size, hidden_dim
        self.conv_stem = conv_stem_configs is not None
        if self.conv_stem:
            # conv-BN-ReLU stem (ref vit.py:212-235), flax's SAME padding
            channels = 3
            for i, cfg in enumerate(conv_stem_configs):
                self.add_module(f"conv_bn_relu_{i}_conv", Conv(
                    channels, cfg.out_channels, cfg.kernel_size, stride=cfg.stride,
                    padding="SAME", dtype=dtype, device=device, use_bias=False))
                self.add_module(f"conv_bn_relu_{i}_bn",
                                BatchNorm(cfg.out_channels, dtype=dtype, device=device))
                channels = cfg.out_channels
            self.num_stem = len(conv_stem_configs)
            self.conv_last = Conv(channels, hidden_dim, 1, dtype=dtype, device=device)
        else:
            fan_in = 3 * patch_size * patch_size
            self.conv_proj = PatchConv(3, hidden_dim, (patch_size, patch_size), dtype=dtype,
                                       device=device,
                                       kernel_init=trunc_normal_init(std=math.sqrt(1 / fan_in)))
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim, device=device))
        self.encoder = Encoder((image_size // patch_size) ** 2 + 1, num_layers, num_heads,
                               hidden_dim, mlp_dim, robust, dtype=dtype, device=device)
        self.pre_logits = None
        width = hidden_dim
        if representation_size is not None:
            self.pre_logits = Dense(hidden_dim, representation_size, dtype=dtype, device=device,
                                    kernel_init=trunc_normal_init(std=math.sqrt(1 / hidden_dim)))
            width = representation_size
        # zero-init head (ref vit.py:304-306)
        self.head = Dense(width, num_classes, dtype=dtype, device=device,
                          kernel_init=zeros_init())

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            raise ValueError(f"expected {self.image_size}px input, got {tuple(x.shape)}")
        if self.conv_stem:
            for i in range(self.num_stem):
                x = getattr(self, f"conv_bn_relu_{i}_conv")(x)
                x = torch.relu(getattr(self, f"conv_bn_relu_{i}_bn")(x))
            x = self.conv_last(x)
        else:
            x = self.conv_proj(x)
        b = x.shape[0]
        x = x.reshape(b, -1, self.hidden_dim)
        cls = self.class_token.to(x.dtype).expand(b, 1, self.hidden_dim)
        x = self.encoder(torch.cat([cls, x], dim=1))
        x = x[:, 0]
        if return_features:
            return x
        if self.pre_logits is not None:
            x = torch.tanh(self.pre_logits(x))
        return self.head(x)


def _builder(patch: int, layers: int, heads: int, hidden: int, mlp: int):
    def build(*, num_classes: int = 1000, image_size: int = 224, robust: bool = False,
              dropout: float = 0.0, attention_dropout: float = 0.0,
              dtype: torch.dtype = torch.float32, device=None, **kw) -> VisionTransformer:
        return VisionTransformer(image_size=image_size, patch_size=patch, num_layers=layers,
                                 num_heads=heads, hidden_dim=hidden, mlp_dim=mlp,
                                 dropout=dropout, attention_dropout=attention_dropout,
                                 num_classes=num_classes, robust=robust, dtype=dtype,
                                 device=device, **kw)

    return build


vit_b_16 = _builder(16, 12, 12, 768, 3072)   # ref vit.py:377
vit_b_32 = _builder(32, 12, 12, 768, 3072)   # ref vit.py:406
vit_l_16 = _builder(16, 24, 16, 1024, 4096)  # ref vit.py:435
vit_l_32 = _builder(32, 24, 16, 1024, 4096)  # ref vit.py:464
vit_h_14 = _builder(14, 32, 16, 1280, 5120)  # ref vit.py:493


def interpolate_embeddings(state_dict: Mapping[str, torch.Tensor], new_image_size: int,
                           patch_size: int, interpolation_mode: str = "bicubic"
                           ) -> dict[str, torch.Tensor]:
    """A copy of ``state_dict`` whose ``…pos_embedding`` tables ``[1, N + 1,
    D]`` are resized to the token grid of ``new_image_size``
    (``ops.resize_posemb_grid``: jax.image.resize's bicubic, the class token
    carried through; ref vit.py:522-603)."""
    out = dict(state_dict)
    new_side = new_image_size // patch_size
    for key, value in state_dict.items():
        if key.rsplit(".", 1)[-1] == "pos_embedding":
            side = int(round((value.shape[1] - 1) ** 0.5))
            out[key] = ops.resize_posemb_grid(value, (new_side, new_side), (side, side),
                                              num_prefix_tokens=1, method=interpolation_mode)
    return out
