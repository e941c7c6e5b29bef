"""Fixed 2D sincos positional embedding (counterpart of
``noise_robust_vit_tpu/ops/posemb.py::posemb_sincos_2d``, ref
simple_vit.py:15-28): a per-axis bank of ``dim // 4`` frequencies,
concatenated in the order (sin x, cos x, sin y, cos y)."""

from __future__ import annotations

import torch

__all__ = ["posemb_sincos_2d"]


def posemb_sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """``[h*w, dim]`` table, computed in float32 and cast to ``dtype``."""
    if dim % 4 != 0:
        raise ValueError("feature dimension must be multiple of 4 for sincos emb")
    y, x = torch.meshgrid(torch.arange(h, device=device),
                          torch.arange(w, device=device), indexing="ij")
    omega = torch.arange(dim // 4, device=device, dtype=torch.float32) / (dim // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    y = y.reshape(-1)[:, None].float() * omega[None, :]
    x = x.reshape(-1)[:, None].float() * omega[None, :]
    pe = torch.cat((torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)), dim=1)
    return pe.to(dtype)
