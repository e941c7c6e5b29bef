"""Compute ops of the port (counterpart of ``noise_robust_vit_tpu/ops``)."""

from .activations import gelu, silu
from .attention import (
    biased_attention,
    biased_dispatch,
    dot_product_attention,
    fused_attention,
    fused_dispatch,
    matmul_f32,
    packed_attention,
    packed_dispatch,
    streaming_attention,
    streaming_dispatch,
)
from .cuda.fused_ln import fused_layer_norm
from .norms import FusedLayerNorm
from .posemb import posemb_sincos_2d, resize_posemb_grid
from .regularizers import drop_path
from .sinkhorn import (
    robust_softmax,
    sinkhorn_attention,
    sinkhorn_normalize,
    sinkhorn_scalings,
    talking_heads_robust_softmax,
)

__all__ = [
    "FusedLayerNorm",
    "biased_attention",
    "biased_dispatch",
    "dot_product_attention",
    "drop_path",
    "fused_attention",
    "fused_dispatch",
    "fused_layer_norm",
    "gelu",
    "matmul_f32",
    "packed_attention",
    "packed_dispatch",
    "posemb_sincos_2d",
    "resize_posemb_grid",
    "robust_softmax",
    "sinkhorn_attention",
    "sinkhorn_normalize",
    "silu",
    "sinkhorn_scalings",
    "streaming_attention",
    "streaming_dispatch",
    "talking_heads_robust_softmax",
]
