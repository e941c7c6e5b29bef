"""SimpleViT (Beyer et al., "Better plain ViT baselines"; counterpart of
``noise_robust_vit_tpu/models/simple_vit.py``, ref simple_vit.py:100-149).

2D sincos positional embedding, mean pooling, no CLS token or dropout.
``robust=True`` switches every attention to Sinkhorn normalization
(ref simple_vit.py:56-59). Input is NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import posemb_sincos_2d
from ..utils import pair, resolve_device
from .layers import Dense, LayerNorm, PatchEmbed, Transformer

__all__ = ["SimpleViT"]


class SimpleViT(nn.Module):
    """On the card unless ``device`` says otherwise."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, channels: int = 3,
                 dim_head: int = 64, robust: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.grid = (ih // ph, iw // pw)
        self.to_patch_embedding = PatchEmbed(dim, (ph, pw), channels=channels,
                                             flatten=True, dtype=dtype, device=device)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       robust=robust, dtype=dtype, device=device)
        self.head_norm = LayerNorm(dim, eps=1e-5, dtype=dtype, device=device)
        self.linear_head = Dense(dim, num_classes, dtype=dtype, device=device)
        # a constant table, not a parameter: kept out of the state_dict
        self.register_buffer(
            "pos_embedding",
            posemb_sincos_2d(self.grid[0], self.grid[1], dim, device=device),
            persistent=False)

    def forward(self, img: torch.Tensor, return_features: bool | str = False):
        x = self.to_patch_embedding(img)
        x = x + self.pos_embedding.to(x.dtype)[None]
        x = self.transformer(x)
        if return_features == "tokens":
            return x
        x = self.head_norm(x.mean(dim=1))
        if return_features:
            return x
        return self.linear_head(x)
