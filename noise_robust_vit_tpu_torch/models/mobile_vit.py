"""MobileViT (counterpart of ``noise_robust_vit_tpu/models/mobile_vit.py``,
ref mobile_vit.py).

A conv stem, a stack of MobileNetV2 blocks, then three (MV2 downsample,
MobileViT block) pairs; a MobileViT block lifts the map to one token
sequence per position inside the 2×2 patch, runs a transformer across the
patches, folds back, and fuses with its input through concat and a conv
(ref mobile_vit.py:148-180). Head: 1×1 conv-BN-SiLU, global mean, bias-free
linear (ref :243-247). NHWC maps end to end; the module names are the flax
tree's (``conv1``, ``stem0..3``, ``trunk{i}_mv2``, ``trunk{i}_mvit``,
``transformer``, ``to_logits_conv``, ``head``).

The transformers have 4 heads of width 8, which the packed kernels' gate
refuses, so their attention takes ``ops.dot_product_attention``: robust
calls reach the fused q/k/v kernels (``ops.fused_attention``), as the JAX
package routes them to its ``fused_attention``; vanilla calls stay on the
vector form.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .. import ops
from ..utils import pair, resolve_device
from .layers import BatchNorm, Conv, Dense, Transformer

__all__ = ["MobileViT", "mobile_vit_macs_per_image"]

HEADS, DIM_HEAD = 4, 8
MLP_MULTS = (2, 4, 4)


class _ConvBnSilu(nn.Module):
    """Conv (no bias; padding 1 at kernel 3, else 0) → BatchNorm → SiLU."""

    def __init__(self, inp: int, out: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = Conv(inp, out, kernel, stride, 1 if kernel == 3 else 0, dtype=dtype,
                         device=device, use_bias=False)
        self.bn = BatchNorm(out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.silu(self.bn(self.conv(x)))


class _MV2Block(nn.Module):
    """(ref mobile_vit.py:101-146.) ``in_channels`` is the input's channel
    count where it differs from ``inp`` (flax infers it from the input; the
    hidden width and the residual follow ``inp``)."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expansion: int = 4,
                 dtype: torch.dtype = torch.float32, device=None, in_channels: int | None = None):
        super().__init__()
        hidden = int(inp * expansion)
        cin = inp if in_channels is None else in_channels
        self.use_res = stride == 1 and inp == oup
        self.expand = expansion != 1
        kw = dict(dtype=dtype, device=device)
        if self.expand:
            self.pw = Conv(cin, hidden, 1, use_bias=False, **kw)
            self.bn0 = BatchNorm(hidden, **kw)
            cin = hidden
        self.dw = Conv(cin, hidden, 3, stride, 1, groups=hidden, use_bias=False, **kw)
        self.bn1 = BatchNorm(hidden, **kw)
        self.pw_linear = Conv(hidden, oup, 1, use_bias=False, **kw)
        self.bn2 = BatchNorm(oup, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.silu(self.bn0(self.pw(x))) if self.expand else x
        y = ops.silu(self.bn1(self.dw(y)))
        y = self.bn2(self.pw_linear(y))
        return x + y if self.use_res else y


class _MobileViTBlock(nn.Module):
    """(ref mobile_vit.py:148-180.) Local convs, the transformer over the
    2×2-patch token sequences, the fold back and the fusion with the input."""

    def __init__(self, inp: int, dim: int, depth: int, channel: int, kernel_size: int,
                 patch_size: tuple[int, int], mlp_dim: int, robust: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _ConvBnSilu(inp, channel, kernel_size, **kw)
        self.conv2 = _ConvBnSilu(channel, dim, 1, **kw)
        self.transformer = Transformer(dim, depth, HEADS, DIM_HEAD, mlp_dim, robust=robust,
                                       out_bias=True, ff_act=ops.silu, **kw)
        self.conv3 = _ConvBnSilu(dim, channel, 1, **kw)
        self.conv4 = _ConvBnSilu(channel + inp, channel, kernel_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.patch_size
        y = x
        x = self.conv2(self.conv1(x))
        b, h, w, d = x.shape
        # 'b d (h ph) (w pw) -> b (ph pw) (h w) d' (ref :170-171)
        x = x.reshape(b, h // ph, ph, w // pw, pw, d)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b * ph * pw, -1, d)
        x = self.transformer(x)
        x = x.reshape(b, ph, pw, h // ph, w // pw, d)
        x = x.permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, d)
        x = self.conv3(x)
        return self.conv4(torch.cat([x, y], dim=-1))


class MobileViT(nn.Module):
    """(ref mobile_vit.py:182-252.) On the card unless ``device`` says
    otherwise. ``channels`` has 11 entries and ``dims`` 3; the MLP widths
    are ``dims × (2, 4, 4)``. Any image whose side is a multiple of 64 runs
    (the last map, 1/32 of it, must split into 2×2 patches); the JAX
    module's ``image_size`` field is not used there either, so it has no
    counterpart here."""

    def __init__(self, dims: Sequence[int], channels: Sequence[int], num_classes: int,
                 expansion: int = 4, kernel_size: int = 3, patch_size=(2, 2),
                 depths: Sequence[int] = (2, 4, 3), robust: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        ch = list(channels)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _ConvBnSilu(3, ch[0], 3, 2, **kw)
        self.stem0 = _MV2Block(ch[0], ch[1], 1, expansion, **kw)
        self.stem1 = _MV2Block(ch[1], ch[2], 2, expansion, **kw)
        self.stem2 = _MV2Block(ch[2], ch[3], 1, expansion, **kw)
        # the reference's quirk (ref :144-145): stem3 is built as ch[2] → ch[3]
        self.stem3 = _MV2Block(ch[2], ch[3], 1, expansion, in_channels=ch[3], **kw)
        for i in range(3):
            self.add_module(f"trunk{i}_mv2", _MV2Block(ch[3 + 2 * i], ch[4 + 2 * i], 2,
                                                       expansion, **kw))
            self.add_module(f"trunk{i}_mvit", _MobileViTBlock(
                ch[4 + 2 * i], dims[i], depths[i], ch[5 + 2 * i], kernel_size,
                tuple(pair(patch_size)), int(dims[i] * MLP_MULTS[i]), robust=robust, **kw))
        self.to_logits_conv = _ConvBnSilu(ch[9], ch[-1], 1, **kw)
        self.head = Dense(ch[-1], num_classes, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        for name in ("stem0", "stem1", "stem2", "stem3"):
            x = getattr(self, name)(x)
        for i in range(3):
            x = getattr(self, f"trunk{i}_mvit")(getattr(self, f"trunk{i}_mv2")(x))
        x = self.to_logits_conv(x).mean(dim=(1, 2))
        return self.head(x)


def mobile_vit_macs_per_image(model: MobileViT, image_size: int = 256) -> int:
    """Forward multiply-adds of one ``image_size`` image: every convolution
    (a depthwise one at one input channel an output), every Dense of the
    transformers, q·kᵀ and attn·v, and the head. BatchNorm, LayerNorm and
    the activations are not counted."""

    def conv(c: Conv, size: int) -> int:  # [out, in/groups, kh, kw] at size × size
        return size * size * c.weight.numel()

    size = image_size // 2
    macs = conv(model.conv1.conv, size)
    for i in range(7):
        name = f"stem{i}" if i < 4 else f"trunk{i - 4}_mv2"
        block = getattr(model, name)
        if block.expand:
            macs += conv(block.pw, size)
        size //= block.dw.stride
        macs += conv(block.dw, size) + conv(block.pw_linear, size)
        if i < 4:
            continue
        mvit = getattr(model, f"trunk{i - 4}_mvit")
        ph, pw = mvit.patch_size
        tokens = size * size
        macs += sum(conv(getattr(mvit, f"conv{j}").conv, size) for j in range(1, 5))
        tf = mvit.transformer
        for d in range(tf.depth):
            attn, ff = getattr(tf, f"layers_{d}_attn"), getattr(tf, f"layers_{d}_ff")
            inner = attn.heads * attn.dim_head
            macs += tokens * (attn.to_qkv.weight.numel() + attn.to_out.weight.numel()
                              + ff.fc1.weight.numel() + ff.fc2.weight.numel())
            macs += 2 * tokens * (tokens // (ph * pw)) * inner  # q·kᵀ, attn·v
    return macs + conv(model.to_logits_conv.conv, size) + model.head.weight.numel()
