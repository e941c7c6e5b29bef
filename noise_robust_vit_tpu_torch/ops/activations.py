"""Activation helpers (counterpart of ``noise_robust_vit_tpu/ops/activations.py``).

``gelu`` is dtype-aware exactly as the JAX package's: exact erf GELU in
float32, the tanh approximation under bfloat16/float16, where the erf-tanh
gap (~1e-3) is below half-precision rounding. ``silu`` is flax's
``nn.silu``, ``x·sigmoid(x)`` in the input's dtype (MobileViT's activation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu", "silu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    approx = x.dtype in (torch.bfloat16, torch.float16)
    return F.gelu(x, approximate="tanh" if approx else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
