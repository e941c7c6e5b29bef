"""Positional embeddings (counterpart of ``noise_robust_vit_tpu/ops/posemb.py``):
the fixed 2D sincos table (``posemb_sincos_2d``, ref simple_vit.py:15-28: a
per-axis bank of ``dim // 4`` frequencies, concatenated in the order
(sin x, cos x, sin y, cos y)), and the resize of a learned table to a new
token grid (``resize_posemb_grid``)."""

from __future__ import annotations

import torch

__all__ = ["posemb_sincos_2d", "resize_posemb_grid"]


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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = −0.5 at distances ``x ≥ 0``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic}


def _resize_weights(n_in: int, n_out: int, kernel, device=None) -> torch.Tensor:
    """``[n_in, n_out]`` float32 weights of ``jax.image.resize`` along one
    axis (``jax._src.image.scale.compute_weight_mat``, antialiased, no
    translation): the kernel is widened by the downsampling factor, each
    output's weights are divided by their sum, and an output whose sample
    falls outside the input gets none."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=f32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(f32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize_posemb_grid(posemb: torch.Tensor, new_hw: tuple[int, int],
                       old_hw: tuple[int, int] | None = None, num_prefix_tokens: int = 1,
                       method: str = "bicubic") -> torch.Tensor:
    """Resize a learned positional-embedding table ``[num_prefix + h·w, dim]``
    (or with a leading batch dim of 1) to a new token grid, the prefix
    (class) tokens carried through. The grid part is resized as
    ``jax.image.resize`` does (the JAX package's ``resize_posemb_grid``):
    ``"bicubic"`` is Keys' cubic with a = −0.5, antialiased when it
    downsamples, with each output's weights normalized, which
    ``torch.nn.functional.interpolate`` (a = −0.75, clamped indices) is not;
    ``"bilinear"`` the triangle kernel likewise. Each resized axis is one
    product with its float32 weight matrix."""
    squeeze = posemb.ndim == 3
    if squeeze:
        posemb = posemb[0]
    prefix, grid = posemb[:num_prefix_tokens], posemb[num_prefix_tokens:]
    if old_hw is None:
        side = int(round(grid.shape[0] ** 0.5))
        if side * side != grid.shape[0]:
            raise ValueError(f"cannot infer square grid from {grid.shape[0]} tokens")
        old_hw = (side, side)
    dim = grid.shape[-1]
    grid = grid.reshape(old_hw[0], old_hw[1], dim)
    for axis, (n_in, n_out) in enumerate(zip(old_hw, new_hw)):
        if n_in == n_out:
            continue  # an identity axis is skipped, as in jax.image.resize
        if method not in _KERNELS:
            raise ValueError(f"unknown resize method {method!r}; known: {list(_KERNELS)}")
        w = _resize_weights(n_in, n_out, _KERNELS[method], grid.device).to(grid.dtype)
        grid = torch.einsum("hwd,hH->Hwd" if axis == 0 else "hwd,wW->hWd", grid, w)
    out = torch.cat([prefix, grid.reshape(-1, dim)], dim=0)
    return out[None] if squeeze else out
