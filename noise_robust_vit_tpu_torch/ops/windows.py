"""Windowed-attention geometry (Swin family; counterpart of
``noise_robust_vit_tpu/ops/windows.py``, ref swin.py:115-271).

The relative-position index, the v2 coordinate table and the shift mask
are numpy, built once per static shape (a copy of the JAX package's, which
this package does not import); the caller moves them to its device once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "cyclic_shift",
    "relative_coords_table",
    "relative_position_index",
    "shift_attn_mask",
    "window_partition",
    "window_reverse",
]


def window_partition(x: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, wh·ww, C] (ref swin.py:167-179). H, W must be
    multiples of the window size (pad first)."""
    b, h, w, c = x.shape
    wh, ww = window
    x = x.reshape(b, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, c)


def window_reverse(x: torch.Tensor, window: tuple[int, int], hw: tuple[int, int],
                   batch: int) -> torch.Tensor:
    """Inverse of :func:`window_partition` (ref swin.py:254-261)."""
    h, w = hw
    wh, ww = window
    c = x.shape[-1]
    x = x.reshape(batch, h // wh, w // ww, wh, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(batch, h, w, c)


@functools.lru_cache(maxsize=32)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[wh·ww · wh·ww] flat index into a (2wh-1)(2ww-1) bias table
    (ref swin.py:321-343)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).reshape(-1)


@functools.lru_cache(maxsize=32)
def relative_coords_table(wh: int, ww: int) -> np.ndarray:
    """Swin-v2 log-spaced continuous relative-coordinate table
    [1, 2wh-1, 2ww-1, 2] (ref swin.py:409-434)."""
    ch = np.arange(-(wh - 1), wh, dtype=np.float32)
    cw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"))
    table = table.transpose(1, 2, 0)[None]
    table[:, :, :, 0] /= max(wh - 1, 1)
    table[:, :, :, 1] /= max(ww - 1, 1)
    table *= 8
    return np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0


@functools.lru_cache(maxsize=64)
def shift_attn_mask(pad_h: int, pad_w: int, window: tuple[int, int],
                    shift: tuple[int, int]) -> np.ndarray | None:
    """Additive attention mask [nW, N, N] (0 / -100) preventing attention
    across the cyclic-shift seam (ref swin.py:202-237), or None when unshifted."""
    if sum(shift) == 0:
        return None
    wh, ww = window
    img = np.zeros((pad_h, pad_w), np.float32)
    h_slices = ((0, pad_h - wh), (pad_h - wh, pad_h - shift[0]), (pad_h - shift[0], pad_h))
    w_slices = ((0, pad_w - ww), (pad_w - ww, pad_w - shift[1]), (pad_w - shift[1], pad_w))
    count = 0
    for h0, h1 in h_slices:
        for w0, w1 in w_slices:
            img[h0:h1, w0:w1] = count
            count += 1
    img = img.reshape(pad_h // wh, wh, pad_w // ww, ww)
    img = img.transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def cyclic_shift(x: torch.Tensor, shift: tuple[int, int], reverse: bool = False) -> torch.Tensor:
    """``torch.roll`` over the two spatial dims of [B, H, W, C] (ref
    swin.py:163-165)."""
    if sum(shift) == 0:
        return x
    sh = (shift[0], shift[1]) if reverse else (-shift[0], -shift[1])
    return torch.roll(x, sh, dims=(1, 2))
