"""LeViT: a convolutional stem, then stages of attention + MLP residual
blocks built from Linear+BatchNorm pairs, with stride-2 subsampling
attention between stages (counterpart of
``noise_robust_vit_tpu/models/levit.py``; ref levit.py).

Stem ``b16``: four stride-2 Conv-BN layers with hard-swish between them
(ref levit.py:166-176), over NHWC input; the map is flattened to tokens in
row-major order. Attention biases are learned tables indexed by the
absolute offset between two positions (ref levit.py:225-238, :336-355),
gathered per call. The head is a mean pool, BatchNorm and Linear.

``robust`` applies the 3-iteration + final-row Sinkhorn schedule in both
attention types (ref levit.py:271-278, :393-400). The square attention
runs the biased kernels with the bias table as the single window's bias,
in every block of every LeViT, as the JAX package does (LeViT-192/256/384's
stage 0, N = 196 with DV = 64, included); a shape outside their gate would
take the plain path, float32 logits + bias → ``robust_softmax``. The
subsample's rectangular logits go through ``robust_softmax`` to the
rectangular logits-interface kernel. Vanilla attention is a softmax.
BatchNorm is flax's (``layers.BatchNorm``); module and parameter names
follow the flax tree for ``convert.convert_params``.
"""

from __future__ import annotations

import functools
import itertools
from collections.abc import Mapping
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..utils import resolve_device
from .layers import BatchNorm, Conv, Dense, DropPath

__all__ = [
    "LeViT",
    "LeViT_128",
    "LeViT_128S",
    "LeViT_192",
    "LeViT_256",
    "LeViT_384",
    "fuse_levit_variables",
    "levit_flops",
    "levit_macs_per_image",
    "specification",
]

specification = {
    "LeViT_128S": {"C": "128_256_384", "D": 16, "N": "4_6_8", "X": "2_3_4", "drop_path": 0},
    "LeViT_128": {"C": "128_256_384", "D": 16, "N": "4_8_12", "X": "4_4_4", "drop_path": 0},
    "LeViT_192": {"C": "192_288_384", "D": 32, "N": "3_5_6", "X": "4_4_4", "drop_path": 0},
    "LeViT_256": {"C": "256_384_512", "D": 32, "N": "4_6_8", "X": "4_4_4", "drop_path": 0},
    "LeViT_384": {"C": "384_512_768", "D": 32, "N": "6_9_12", "X": "4_4_4", "drop_path": 0.1},
}


@functools.lru_cache(maxsize=64)
def _bias_index_square(resolution: int) -> tuple[np.ndarray, int]:
    """(ref levit.py:225-238.)"""
    points = list(itertools.product(range(resolution), range(resolution)))
    offsets: dict[tuple, int] = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return np.asarray(idxs, np.int64).reshape(n, n), len(offsets)


@functools.lru_cache(maxsize=64)
def _bias_index_subsample(resolution: int, resolution_: int,
                          stride: int) -> tuple[np.ndarray, int]:
    """(ref levit.py:336-355.)"""
    points = list(itertools.product(range(resolution), range(resolution)))
    points_ = list(itertools.product(range(resolution_), range(resolution_)))
    offsets: dict[tuple, int] = {}
    idxs = []
    for p1 in points_:
        for p2 in points:
            off = (abs(p1[0] * stride - p2[0]), abs(p1[1] * stride - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    return np.asarray(idxs, np.int64).reshape(len(points_), len(points)), len(offsets)


class ConvBN(nn.Module):
    """Conv (with a zero bias for the fusion) + BN (ref levit.py:57-83). NHWC."""

    def __init__(self, cin: int, out: int, ks: int = 1, stride: int = 1, pad: int = 0,
                 bn_weight_init: float = 1.0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.c = Conv(cin, out, ks, stride, pad, dtype=dtype, device=device)
        self.bn = BatchNorm(out, scale_init=bn_weight_init, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.c(x))


class LinearBN(nn.Module):
    """Linear + BN over channels (ref levit.py:105-133)."""

    def __init__(self, cin: int, out: int, bn_weight_init: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.c = Dense(cin, out, dtype=dtype, device=device)
        self.bn = BatchNorm(out, scale_init=bn_weight_init, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.c(x))


class _BiasTable(nn.Module):
    """The learned ``attention_biases [H, n_offsets]`` (zeros at init) and
    the fixed index map that gathers them into a ``[H, NQ, NK]`` bias."""

    def __init__(self, heads: int, index: tuple[np.ndarray, int], device=None):
        super().__init__()
        idxs, n_off = index
        self.attention_biases = nn.Parameter(torch.zeros(heads, n_off, device=device))
        self.register_buffer("bias_idxs", torch.from_numpy(idxs).to(device), persistent=False)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        self.attention_biases.zero_()

    def attention_bias(self) -> torch.Tensor:
        return self.attention_biases[:, self.bias_idxs]


class LevitAttention(_BiasTable):
    """(ref levit.py:198-296.)"""

    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: int,
                 resolution: int, robust: bool, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(num_heads, _bias_index_square(resolution), device)
        self.key_dim, self.num_heads, self.robust = key_dim, num_heads, robust
        self.d = int(attn_ratio * key_dim)
        h, kd, d = num_heads, key_dim, self.d
        self.qkv = LinearBN(dim, h * (2 * kd + d), dtype=dtype, device=device)
        self.proj = LinearBN(h * d, dim, bn_weight_init=0.0, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        kd, h, d = self.key_dim, self.num_heads, self.d
        qkv = self.qkv(x).reshape(b, n, h, 2 * kd + d)
        q, k, v = (t.transpose(1, 2) for t in qkv.split([kd, kd, d], dim=-1))
        bias = self.attention_bias()  # [h, N, N]
        if self.robust and ops.biased_dispatch(True, b, h, n, kd, d, 1):
            # the bias table as the one window's bias (ref levit.py:271-278)
            out = ops.biased_attention(q, k, v, bias[None].float(), scale=kd ** -0.5,
                                       robust=True, num_windows=1)
        else:
            attn = ops.matmul_f32(q, k.transpose(-1, -2)) * kd ** -0.5
            attn = ops.robust_softmax(attn + bias[None].float(), robust=self.robust)
            out = torch.matmul(attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.proj(F.hardswish(out))


class LevitAttentionSubsample(_BiasTable):
    """Stride-2 downsampling cross-attention (ref levit.py:298-404): queries
    on the subsampled grid (``x[:, ::stride, ::stride]``, 14 → 7 → 4), keys
    and values on the full one."""

    def __init__(self, in_dim: int, out_dim: int, key_dim: int, num_heads: int,
                 attn_ratio: int, stride: int, resolution: int, resolution_: int,
                 robust: bool, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(num_heads, _bias_index_subsample(resolution, resolution_, stride),
                         device)
        self.key_dim, self.num_heads, self.robust = key_dim, num_heads, robust
        self.d = int(attn_ratio * key_dim)
        self.stride, self.resolution, self.resolution_ = stride, resolution, resolution_
        h, kd, d = num_heads, key_dim, self.d
        self.kv = LinearBN(in_dim, h * (kd + d), dtype=dtype, device=device)
        self.q = LinearBN(in_dim, h * kd, dtype=dtype, device=device)
        self.proj = LinearBN(h * d, out_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        kd, h, d = self.key_dim, self.num_heads, self.d
        n_ = self.resolution_ ** 2
        kv = self.kv(x).reshape(b, n, h, kd + d)
        k, v = (t.transpose(1, 2) for t in kv.split([kd, d], dim=-1))
        r, s = self.resolution, self.stride
        xs = x.reshape(b, r, r, c)[:, ::s, ::s].reshape(b, n_, c)
        q = self.q(xs).reshape(b, n_, h, kd).transpose(1, 2)
        attn = ops.matmul_f32(q, k.transpose(-1, -2)) * kd ** -0.5
        attn = ops.robust_softmax(attn + self.attention_bias()[None].float(),
                                  robust=self.robust)
        out = torch.matmul(attn.to(v.dtype), v).transpose(1, 2).reshape(b, n_, h * d)
        return self.proj(F.hardswish(out))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.fc1 = LinearBN(dim, hidden, dtype=dtype, device=device)
        self.fc2 = LinearBN(hidden, dim, bn_weight_init=0.0, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.hardswish(self.fc1(x)))


class LeViT(nn.Module):
    """(ref levit.py:406-528.) Input NHWC, as in the JAX package. On the
    card unless ``device`` says otherwise."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, num_classes: int = 1000,
                 embed_dim: Sequence[int] = (192,), key_dim: Sequence[int] = (64,),
                 depth: Sequence[int] = (12,), num_heads: Sequence[int] = (3,),
                 attn_ratio: Sequence[int] = (2,), mlp_ratio: Sequence[int] = (2,),
                 down_ops: Sequence[Sequence] = (), drop_path: float = 0.0,
                 robust: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.img_size, self.patch_size, self.num_classes = img_size, patch_size, num_classes
        self.embed_dim, self.key_dim, self.depth = tuple(embed_dim), tuple(key_dim), tuple(depth)
        self.num_heads, self.attn_ratio = tuple(num_heads), tuple(attn_ratio)
        self.mlp_ratio, self.down_ops = tuple(mlp_ratio), tuple(tuple(do) for do in down_ops)
        kw = dict(dtype=dtype, device=device)
        # b16 conv stem (ref levit.py:166-176)
        n0 = self.embed_dim[0]
        cin = 3  # RGB
        for i, ch in enumerate((n0 // 8, n0 // 4, n0 // 2, n0)):
            self.add_module(f"stem{i}", ConvBN(cin, ch, ks=3, stride=2, pad=1, **kw))
            cin = ch
        self.sd = DropPath(drop_path)
        # the residual branches in order: (name, whether a DropPath wraps it)
        self._branches: list[tuple[str, bool]] = []
        resolution = img_size // patch_size
        down = list(self.down_ops) + [("",)]
        blk = 0
        for i, (ed, kd, dpth, nh, ar, mr, do) in enumerate(
                zip(self.embed_dim, self.key_dim, self.depth, self.num_heads,
                    self.attn_ratio, self.mlp_ratio, down)):
            for _ in range(dpth):
                self._add(f"block{blk}_attn", True, LevitAttention(
                    ed, kd, nh, ar, resolution, robust, **kw))
                if mr > 0:
                    self._add(f"block{blk}_mlp", True, _MLP(ed, int(ed * mr), **kw))
                blk += 1
            if do[0] == "Subsample":
                resolution_ = (resolution - 1) // do[5] + 1
                self._add(f"downsample{i}", False, LevitAttentionSubsample(
                    ed, self.embed_dim[i + 1], key_dim=do[1], num_heads=do[2],
                    attn_ratio=do[3], stride=do[5], resolution=resolution,
                    resolution_=resolution_, robust=robust, **kw))
                resolution = resolution_
                if do[4] > 0:
                    nxt = self.embed_dim[i + 1]
                    self._add(f"downsample{i}_mlp", True, _MLP(nxt, int(nxt * do[4]), **kw))
        if num_classes > 0:
            self.head_bn = BatchNorm(self.embed_dim[-1], **kw)
            self.head = Dense(self.embed_dim[-1], num_classes, **kw)

    def _add(self, name: str, residual: bool, module: nn.Module) -> None:
        self.add_module(name, module)
        self._branches.append((name, residual))

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        for i in range(4):
            x = getattr(self, f"stem{i}")(x)
            if i < 3:
                x = F.hardswish(x)
        x = x.reshape(x.shape[0], -1, self.embed_dim[0])
        for name, residual in self._branches:
            y = getattr(self, name)(x)
            x = x + self.sd(y) if residual else y
        x = x.mean(dim=1)
        if return_features or self.num_classes <= 0:
            return x
        return self.head(self.head_bn(x))


def _factory(C, D, X, N, drop_path, num_classes, robust, img_size=224, **kw):
    """(ref levit.py:531-557.)"""
    embed_dim = [int(v) for v in C.split("_")]
    num_heads = [int(v) for v in N.split("_")]
    depth = [int(v) for v in X.split("_")]
    return LeViT(
        img_size=img_size, patch_size=16, embed_dim=embed_dim, num_heads=num_heads,
        key_dim=(D,) * 3, depth=depth, attn_ratio=(2, 2, 2), mlp_ratio=(2, 2, 2),
        down_ops=(("Subsample", D, embed_dim[0] // D, 4, 2, 2),
                  ("Subsample", D, embed_dim[1] // D, 4, 2, 2)),
        num_classes=num_classes, drop_path=drop_path, robust=robust, **kw)


def _make_builder(name):
    def build(num_classes=1000, robust=False, image_size=224, device=None, **kw):
        kw.setdefault("img_size", image_size)
        return _factory(**specification[name], num_classes=num_classes, robust=robust,
                        device=device, **kw)

    build.__name__ = name
    build.__doc__ = (f"{name} (ref levit.py:560-587). On the card unless ``device`` "
                     "says otherwise.")
    return build


LeViT_128S = _make_builder("LeViT_128S")
LeViT_128 = _make_builder("LeViT_128")
LeViT_192 = _make_builder("LeViT_192")
LeViT_256 = _make_builder("LeViT_256")
LeViT_384 = _make_builder("LeViT_384")


@torch.no_grad()
def fuse_levit_variables(variables: nn.Module | Mapping[str, torch.Tensor],
                         eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """Fold every BN that follows a conv or dense (``X.c`` then ``X.bn``)
    into it and reset the BN to the identity: the reference's ``fuse()``
    inference transform (ref levit.py:86-102, :119-127; JAX
    ``fuse_levit_variables``). Takes a LeViT or its ``state_dict`` and
    returns a new state dict; loaded into the same model it computes the
    fused function in eval mode. ``head_bn`` has no conv or dense before it
    and stays."""
    state = variables.state_dict() if isinstance(variables, nn.Module) else variables
    out = {k: v.clone() for k, v in state.items()}
    for key in state:
        if not key.endswith("bn.running_mean"):
            continue
        p = key[:-len("bn.running_mean")]
        if p + "c.weight" not in state:
            continue
        w = state[p + "bn.weight"] / torch.sqrt(state[p + "bn.running_var"] + eps)
        kernel = state[p + "c.weight"]
        # the output channel is dim 0 of a Linear [out, in] and a Conv OIHW
        out[p + "c.weight"] = kernel * w.reshape(-1, *([1] * (kernel.ndim - 1)))
        out[p + "c.bias"] = state[p + "c.bias"] * w + state[p + "bn.bias"] - state[key] * w
        out[p + "bn.weight"] = torch.ones_like(w)
        out[p + "bn.bias"] = torch.zeros_like(w)
        out[p + "bn.running_mean"] = torch.zeros_like(w)
        # sqrt(var + eps) == 1 exactly after fusion
        out[p + "bn.running_var"] = torch.ones_like(w) - eps
    return out


def _stages(model: LeViT):
    """(stage, embed dim, key dim, depth, heads, attn ratio, mlp ratio, down
    op, resolution) for each stage."""
    resolution = model.img_size // model.patch_size
    down = list(model.down_ops) + [("",)]
    for i, row in enumerate(zip(model.embed_dim, model.key_dim, model.depth,
                                model.num_heads, model.attn_ratio, model.mlp_ratio, down)):
        yield (i, *row, resolution)
        if row[-1][0] == "Subsample":
            resolution = (resolution - 1) // row[-1][5] + 1


def levit_flops(model: LeViT) -> int:
    """Analytic attention FLOPs (the reference's FLOPS_COUNTER semantics,
    ref levit.py:240-246, :357-366: attention terms; JAX ``levit_flops``)."""
    total = 0
    for _, _, kd, dpth, nh, ar, _, do, resolution in _stages(model):
        d = int(ar * kd)
        total += dpth * (nh * resolution ** 4 * kd + nh * resolution ** 4
                         + nh * d * resolution ** 4)
        if do[0] == "Subsample":
            r_ = (resolution - 1) // do[5] + 1
            dd = int(do[3] * do[1])
            total += (do[2] * resolution ** 2 * r_ ** 2 * do[1]
                      + do[2] * resolution ** 2 * r_ ** 2
                      + do[2] * resolution ** 2 * r_ ** 2 * dd)
    return total


def levit_macs_per_image(model: LeViT) -> int:
    """Forward multiply-adds of one image (the unit of the LeViT paper's
    "FLOPs", 305 M for LeViT-128S at 224): the stem convolutions, every
    Linear, q·kᵀ and attn·v of both attention types, and the head. BatchNorm,
    activations, the bias gather and the Sinkhorn passes are not counted."""
    n0 = model.embed_dim[0]
    size, cin, macs = model.img_size, 3, 0
    for ch in (n0 // 8, n0 // 4, n0 // 2, n0):
        size = (size + 2 - 3) // 2 + 1
        macs += size * size * 9 * cin * ch
        cin = ch
    for i, ed, kd, dpth, nh, ar, mr, do, res in _stages(model):
        n, d = res * res, int(ar * kd)
        per_block = (n * ed * nh * (2 * kd + d) + nh * n * n * (kd + d) + n * nh * d * ed
                     + 2 * n * ed * int(ed * mr))
        macs += dpth * per_block
        if do[0] == "Subsample":
            r_ = (res - 1) // do[5] + 1
            n_, nxt = r_ * r_, model.embed_dim[i + 1]
            h, kd_, d_ = do[2], do[1], int(do[3] * do[1])
            macs += (n * ed * h * (kd_ + d_) + n_ * ed * h * kd_ + h * n_ * n * (kd_ + d_)
                     + n_ * h * d_ * nxt)
            if do[4] > 0:
                macs += 2 * n_ * nxt * int(nxt * do[4])
    return macs + model.embed_dim[-1] * max(model.num_classes, 0)
