"""Optimizer of the train step (counterpart of the
``optax.adamw(1e-3, weight_decay=0.05)`` in ``bench.py:57``).

``torch.optim.AdamW`` has optax.adamw's semantics: bias-corrected moments,
``eps`` added outside the square root (optax ``eps_root = 0``), and weight
decay decoupled from the gradient and applied to every parameter,
``p ← p − lr·(m̂ / (√v̂ + eps) + wd·p)``. torch applies ``p ← p·(1 − lr·wd)``
before the Adam term, which is the same update since the Adam term does not
depend on ``p``.
"""

from __future__ import annotations

from collections.abc import Iterable

import torch

__all__ = ["adamw"]


def adamw(params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
          weight_decay: float = 0.05, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)
