"""Normalization modules of the port (counterpart of
``noise_robust_vit_tpu/ops/norms.py``; ``PartialBatchNorm`` and
``partial_relu`` are not ported yet)."""

from __future__ import annotations

import torch
from torch import nn

from .cuda.fused_ln import fused_layer_norm, fused_ln_supported

__all__ = ["FusedLayerNorm"]


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis on the fused kernels
    (``ops/cuda/fused_ln.py``), with the port's ``LayerNorm`` parameters
    (``weight`` and ``bias``, flax's ``scale`` and ``bias``), so weights carry
    across unchanged. The shared blocks and Swin take it at a feature width
    inside the gate (``models/layers.py::_ln_cls``: a multiple of 32 up to
    8192, where JAX's gate is a multiple of 128).

    As JAX's ``FusedLayerNorm``: the compute dtype is ``dtype or x.dtype``;
    a feature dim inside ``fused_ln_supported`` casts x to it *before* the
    kernels (CUDA tensors) or their plain versions (CPU tensors); any other
    normalizes the uncast x with the same two-pass float32 math and casts
    the result. The gate is a shape decided before the call, not a
    fallback: a kernel that fails raises. At a width that is a multiple of
    32 but not of 128 (Swin-T's 96 and 192) the port casts before the
    kernels where JAX's module, outside its gate, casts after: the two agree
    where x already has the compute dtype, as in every bf16 block."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        if fused_ln_supported(x.shape[-1]):
            return fused_layer_norm(x.to(dtype), self.weight, self.bias, self.eps)
        # JAX's branch outside the gate (norms.py:92-98): eager float32 math
        xf = x.float()
        xc = xf - xf.mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(dtype)
