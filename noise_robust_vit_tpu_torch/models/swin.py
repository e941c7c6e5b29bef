"""Swin Transformer v1/v2 with Sinkhorn-robust windowed attention
(counterpart of ``noise_robust_vit_tpu/models/swin.py``; ref swin.py,
torchvision-style).

Structure: patchify (a stride = kernel convolution, ref swin.py:632-643) →
4 stages of SwinTransformerBlocks with alternating window shift,
PatchMerging between stages (v1: norm before reduction, v2: after),
linearly scheduled stochastic depth, final LayerNorm → global average
pool → head. Input is NHWC, as in the JAX package. Every LayerNorm is the
shared blocks' class by width (``layers._ln_cls``): Swin-T's 29 norms, at
96 to 1536, run on the fused LayerNorm kernels.

Window attention: pad to window multiples, cyclic shift, window partition,
qkv, relative-position bias (v1: learned table; v2: log-CPB MLP ×
16·sigmoid, with cosine attention and a clamped per-head logit scale),
additive -100 shift mask, then softmax, or softmax + 3 Sinkhorn iterations
+ final row norm when ``robust``. A robust attention inside the biased
kernels' gate runs them with the relative-position bias and the shift mask
merged into one float32 ``[nW, H, N, N]`` bias; everything else (vanilla,
attention dropout in training, shapes outside the gate) runs batched
matmuls and a softmax, as the JAX package leaves them to XLA. Module and
parameter names follow the flax tree (``stage0_block0.attn.qkv.weight``)
for ``convert.convert_params``.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..ops.windows import (
    cyclic_shift,
    relative_coords_table,
    relative_position_index,
    shift_attn_mask,
    window_partition,
    window_reverse,
)
from ..utils import normal_init, resolve_device, trunc_normal_init, xavier_uniform_init
from .layers import Dense, DropPath, PatchConv, _ln_cls

__all__ = [
    "SwinTransformer",
    "swin_b",
    "swin_s",
    "swin_t",
    "swin_v2_b",
    "swin_v2_s",
    "swin_v2_t",
]


# The geometry tables on the device, built once per shape and device.
@functools.lru_cache(maxsize=64)
def _index(wh: int, ww: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(wh, ww)).to(device)


@functools.lru_cache(maxsize=64)
def _coords_table(wh: int, ww: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_coords_table(wh, ww)).to(device)


@functools.lru_cache(maxsize=64)
def _shift_mask(ph: int, pw: int, window: tuple[int, int], shift: tuple[int, int],
                device: torch.device) -> torch.Tensor | None:
    mask = shift_attn_mask(ph, pw, window, shift)
    return None if mask is None else torch.from_numpy(mask).to(device)


class ShiftedWindowAttention(nn.Module):
    """v1 (``version=1``) or v2 (``version=2``) shifted-window attention
    over ``[B, H, W, C]``."""

    def __init__(self, dim: int, window_size: tuple[int, int], shift_size: tuple[int, int],
                 num_heads: int, qkv_bias: bool = True, proj_bias: bool = True,
                 attention_dropout: float = 0.0, dropout: float = 0.0,
                 robust: bool = False, version: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.attention_dropout, self.dropout = attention_dropout, dropout
        self.robust, self.version = robust, version
        wh, ww = self.window_size
        trunc = trunc_normal_init(0.02)
        self.qkv_bias = None
        if version == 2 and qkv_bias:
            # v2 zeroes the key bias every call (ref swin.py:184-187): the
            # bias is its own parameter, and its key third is masked
            self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype, device=device,
                             kernel_init=trunc)
            self.qkv_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
            kb_mask = torch.ones(3 * dim, device=device)
            kb_mask[dim:2 * dim] = 0.0
            self.register_buffer("kb_mask", kb_mask, persistent=False)
        else:
            self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, device=device,
                             kernel_init=trunc)
        if version == 2:
            self.logit_scale = nn.Parameter(torch.empty(num_heads, 1, 1, device=device))
            self.cpb_fc1 = Dense(2, 512, dtype=torch.float32, device=device)
            self.cpb_fc2 = Dense(512, num_heads, bias=False, dtype=torch.float32,
                                 device=device)
        else:
            self.relative_position_bias_table = nn.Parameter(
                torch.empty((2 * wh - 1) * (2 * ww - 1), num_heads, device=device))
        self.proj = Dense(dim, dim, bias=proj_bias, dtype=dtype, device=device,
                          kernel_init=trunc)
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        if self.version == 2:
            self.logit_scale.fill_(math.log(10.0))
            if self.qkv_bias is not None:
                self.qkv_bias.zero_()
        else:
            trunc_normal_init(0.02)(self.relative_position_bias_table, generator)

    def _relative_bias(self, n: int, device) -> torch.Tensor:
        """``[1, H, N, N]`` float32 relative-position bias."""
        wh, ww = self.window_size
        heads = self.num_heads
        idx = _index(wh, ww, device)
        if self.version == 2:
            cpb = self.cpb_fc2(F.relu(self.cpb_fc1(_coords_table(wh, ww, device))))
            cpb = cpb.reshape(-1, heads)
            rel = cpb[idx].reshape(n, n, heads).permute(2, 0, 1)[None]
            return 16.0 * torch.sigmoid(rel)
        table = self.relative_position_bias_table
        return table[idx].reshape(n, n, heads).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        wh, ww = self.window_size
        heads = self.num_heads
        dh = c // heads

        pad_b = (wh - h % wh) % wh
        pad_r = (ww - w % ww) % ww
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        ph, pw = h + pad_b, w + pad_r
        # no shift when the window covers the (padded) map
        shift = (0 if wh >= ph else self.shift_size[0],
                 0 if ww >= pw else self.shift_size[1])

        x = cyclic_shift(x, shift)
        xw = window_partition(x, (wh, ww))  # [B·nW, N, C]
        bw, n, _ = xw.shape
        num_windows = bw // b

        qkv = self.qkv(xw)
        if self.qkv_bias is not None:
            qkv = qkv + (self.qkv_bias * self.kb_mask).to(qkv.dtype)
        q, k, v = qkv.reshape(bw, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)

        if self.version == 2:
            # cosine attention with a clamped per-head logit scale
            qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
            kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
            scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        rel_bias = self._relative_bias(n, x.device)
        mask = _shift_mask(ph, pw, (wh, ww), shift, x.device)

        use_fused = (self.robust
                     and (self.attention_dropout == 0.0 or not self.training)
                     and ops.biased_dispatch(self.robust, bw, heads, n, dh, dh,
                                             num_windows))
        if use_fused:
            # the relative-position bias and the shift mask as one bias
            bias_total = rel_bias.float().expand(num_windows, heads, n, n)
            if mask is not None:
                bias_total = bias_total + mask[:, None]
            if self.version == 2:
                # the logit scale is folded into the normalized q, so that
                # the kernel's scale is a constant
                out = ops.biased_attention(qn * scale.to(qn.dtype), kn, v, bias_total,
                                           scale=1.0, robust=True, num_windows=num_windows)
            else:
                out = ops.biased_attention(q, k, v, bias_total, scale=dh ** -0.5,
                                           robust=True, num_windows=num_windows)
        else:
            if self.version == 2:
                attn = ops.matmul_f32(qn, kn.transpose(-1, -2)) * scale.float()
            else:
                attn = ops.matmul_f32(q, k.transpose(-1, -2)) * dh ** -0.5
            attn = attn + rel_bias.float()
            if mask is not None:
                attn = attn.reshape(b, num_windows, heads, n, n) + mask[None, :, None]
                attn = attn.reshape(bw, heads, n, n)
            attn = ops.robust_softmax(attn, robust=self.robust)
            attn = F.dropout(attn, self.attention_dropout, self.training)
            out = torch.matmul(attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(bw, n, c)
        out = F.dropout(self.proj(out), self.dropout, self.training)
        out = window_reverse(out, (wh, ww), (ph, pw), b)
        out = cyclic_shift(out, shift, reverse=True)
        return out[:, :h, :w, :]


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout: float,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, kernel_init=xavier_uniform_init(),
                  bias_init=normal_init(1e-6))
        self.fc1 = Dense(dim, hidden, **kw)
        self.fc2 = Dense(hidden, dim, **kw)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.dropout(ops.gelu(self.fc1(x)), self.dropout, self.training)
        return F.dropout(self.fc2(x), self.dropout, self.training)


class SwinTransformerBlock(nn.Module):
    """(ref swin.py:469-531 v1; :534-581 v2: the norms' placement differs.)"""

    def __init__(self, dim: int, num_heads: int, window_size: tuple[int, int],
                 shift_size: tuple[int, int], mlp_ratio: float = 4.0,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 stochastic_depth_prob: float = 0.0, robust: bool = False,
                 version: int = 1, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.version = version
        self.attn = ShiftedWindowAttention(
            dim, window_size, shift_size, num_heads, attention_dropout=attention_dropout,
            dropout=dropout, robust=robust, version=version, dtype=dtype, device=device)
        self.norm1 = _ln_cls(dim)(dim, eps=1e-5, dtype=dtype, device=device)
        self.norm2 = _ln_cls(dim)(dim, eps=1e-5, dtype=dtype, device=device)
        self.mlp = _MLP(dim, int(dim * mlp_ratio), dropout, dtype=dtype, device=device)
        self.drop_path = DropPath(stochastic_depth_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sd = self.drop_path
        if self.version == 2:
            x = x + sd(self.norm1(self.attn(x)))
            return x + sd(self.norm2(self.mlp(x)))
        x = x + sd(self.attn(self.norm1(x)))
        return x + sd(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """(ref swin.py:61-85 v1, :88-113 v2.)"""

    def __init__(self, dim: int, version: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.version = version
        width = 4 * dim if version == 1 else 2 * dim
        self.norm = _ln_cls(width)(width, eps=1e-5, dtype=dtype, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype, device=device,
                               kernel_init=trunc_normal_init(0.02))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        if self.version == 2:
            return self.norm(self.reduction(x))
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """(ref swin.py:584-726.) On the card unless ``device`` says otherwise."""

    def __init__(self, patch_size: Sequence[int], embed_dim: int, depths: Sequence[int],
                 num_heads: Sequence[int], window_size: Sequence[int],
                 mlp_ratio: float = 4.0, dropout: float = 0.0,
                 attention_dropout: float = 0.0, stochastic_depth_prob: float = 0.1,
                 num_classes: int = 1000, robust: bool = False, version: int = 1,
                 channels: int = 3, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.depths = tuple(depths)
        trunc = trunc_normal_init(0.02)
        self.patch_embed = PatchConv(channels, embed_dim, tuple(patch_size), dtype=dtype,
                                     device=device, kernel_init=trunc)
        self.patch_norm = _ln_cls(embed_dim)(embed_dim, eps=1e-5, dtype=dtype, device=device)
        total_blocks = sum(self.depths)
        block_id = 0
        for i_stage, depth in enumerate(self.depths):
            dim = embed_dim * 2 ** i_stage
            for i_layer in range(depth):
                sd_prob = stochastic_depth_prob * float(block_id) / max(total_blocks - 1, 1)
                shift = tuple(0 if i_layer % 2 == 0 else wsz // 2 for wsz in window_size)
                self.add_module(f"stage{i_stage}_block{i_layer}", SwinTransformerBlock(
                    dim, num_heads[i_stage], window_size=tuple(window_size),
                    shift_size=shift, mlp_ratio=mlp_ratio, dropout=dropout,
                    attention_dropout=attention_dropout, stochastic_depth_prob=sd_prob,
                    robust=robust, version=version, dtype=dtype, device=device))
                block_id += 1
            if i_stage < len(self.depths) - 1:
                self.add_module(f"downsample{i_stage}",
                                PatchMerging(dim, version=version, dtype=dtype, device=device))
        num_features = embed_dim * 2 ** (len(self.depths) - 1)
        self.norm = _ln_cls(num_features)(num_features, eps=1e-5, dtype=dtype, device=device)
        self.head = Dense(num_features, num_classes, dtype=dtype, device=device,
                          kernel_init=trunc)

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        x = self.patch_norm(self.patch_embed(x))
        for i_stage, depth in enumerate(self.depths):
            for i_layer in range(depth):
                x = getattr(self, f"stage{i_stage}_block{i_layer}")(x)
            if i_stage < len(self.depths) - 1:
                x = getattr(self, f"downsample{i_stage}")(x)
        x = self.norm(x).mean(dim=(1, 2))
        if return_features:
            return x
        return self.head(x)


def _swin(patch, embed, depths, heads, window, sd, version, *, device=None, **kw):
    kw.setdefault("num_classes", 1000)
    kw.pop("image_size", None)  # any size works; accepted for the factory
    return SwinTransformer(patch_size=patch, embed_dim=embed, depths=depths,
                           num_heads=heads, window_size=window, stochastic_depth_prob=sd,
                           version=version, device=device, **kw)


def swin_t(**kw):
    """(ref swin.py:727-759.) On the card unless ``device`` says otherwise."""
    return _swin([4, 4], 96, [2, 2, 6, 2], [3, 6, 12, 24], [7, 7], 0.2, 1, **kw)


def swin_s(**kw):
    """(ref swin.py:760-791.)"""
    return _swin([4, 4], 96, [2, 2, 18, 2], [3, 6, 12, 24], [7, 7], 0.3, 1, **kw)


def swin_b(**kw):
    """(ref swin.py:792-824.)"""
    return _swin([4, 4], 128, [2, 2, 18, 2], [4, 8, 16, 32], [7, 7], 0.5, 1, **kw)


def swin_v2_t(**kw):
    """(ref swin.py:825-859.)"""
    return _swin([4, 4], 96, [2, 2, 6, 2], [3, 6, 12, 24], [8, 8], 0.2, 2, **kw)


def swin_v2_s(**kw):
    """(ref swin.py:860-894.)"""
    return _swin([4, 4], 96, [2, 2, 18, 2], [3, 6, 12, 24], [8, 8], 0.3, 2, **kw)


def swin_v2_b(**kw):
    """(ref swin.py:895-926.)"""
    return _swin([4, 4], 128, [2, 2, 18, 2], [4, 8, 16, 32], [8, 8], 0.5, 2, **kw)
