"""Stochastic regularizers (counterpart of
``noise_robust_vit_tpu/ops/regularizers.py``; so far ``drop_path``)."""

from __future__ import annotations

import torch

__all__ = ["drop_path"]


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None,
              deterministic: bool = False, scale_by_keep: bool = True) -> torch.Tensor:
    """Per-sample stochastic depth (ref utils.py:1078-1097): zero a residual
    branch with probability ``rate`` independently per sample, rescaling the
    survivors by ``1/keep`` so the expectation is unchanged. The mask is
    drawn from ``generator`` (on ``x``'s device; None takes torch's default
    one), as the JAX version draws it from an explicit key."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.empty(shape, dtype=torch.float32, device=x.device)
    mask = mask.bernoulli_(keep, generator=generator).to(x.dtype)
    if scale_by_keep:
        mask = mask / keep
    return x * mask
