"""Small shared helpers (counterpart of ``noise_robust_vit_tpu/utils``)."""

from __future__ import annotations

__all__ = ["pair"]


def pair(t):
    """``t`` as an ``(h, w)`` pair (ref simple_vit.py:11-12)."""
    return t if isinstance(t, tuple) else (t, t)
