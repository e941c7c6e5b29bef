"""PyTorch + CUDA port of ``noise_robust_vit_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package imports ``torch`` and
never JAX. Its attention runs on hand-written CUDA kernels
(``ops/cuda/csrc``) for CUDA tensors and on their plain PyTorch versions for
CPU tensors.
"""

from .convert import convert_params
from .models import (CaiT, CvT, LeViT, MobileViT, SimpleViT, SwinTransformer, VisionTransformer,
                     create_model)
from .ops import (FusedLayerNorm, biased_attention, fused_attention, fused_layer_norm,
                  packed_attention, streaming_attention)

__all__ = ["CaiT", "CvT", "FusedLayerNorm", "LeViT", "MobileViT", "SimpleViT", "SwinTransformer",
           "VisionTransformer", "biased_attention", "convert_params", "create_model",
           "fused_attention", "fused_layer_norm", "packed_attention", "streaming_attention"]
