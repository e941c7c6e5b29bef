"""Shared building blocks (counterpart of ``noise_robust_vit_tpu/models/layers.py``).

The bf16 semantics follow the JAX package's flax modules: parameters stay
float32, every module has a compute ``dtype``, and parameters are cast to it
at use, as flax's ``dtype=`` does. Module and parameter names follow the
flax tree (``layers_0_attn/to_qkv/kernel`` ↔ ``layers_0_attn.to_qkv.weight``)
so that ``convert.convert_params`` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..ops.cuda.fused_ln import fused_ln_supported
from ..ops.norms import FusedLayerNorm
from ..utils import lecun_normal_init, zeros_init

__all__ = ["Attention", "BatchNorm", "Conv", "Dense", "DropPath", "FeedForward",
           "LayerNorm", "PatchConv", "PatchEmbed", "Transformer", "init_params"]


class Dense(nn.Linear):
    """``nn.Linear`` whose input, weight and bias are cast to ``dtype`` at use
    (flax ``nn.Dense(dtype=...)``). ``kernel_init`` and ``bias_init`` are
    the flax module's initializers (``utils``), applied by ``init_params``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 kernel_init: Callable | None = None, bias_init: Callable | None = None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype
        self.kernel_init = kernel_init or lecun_normal_init()
        self.bias_init = bias_init or zeros_init()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32 and cast to ``dtype`` (flax
    ``nn.LayerNorm(dtype=...)`` normalizes in at least float32)."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(dim, eps=eps, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


def _ln_cls(dim: int) -> type[nn.Module]:
    """LayerNorm class of the shared blocks (``FeedForward.norm``,
    ``Attention.norm``, ``Transformer.norm``) and of Swin's norms at feature
    width ``dim``: ``FusedLayerNorm``, on the fused LayerNorm kernels
    (compute-dtype x in and y out, float32 moments), where ``dim`` is inside
    their gate (``fused_ln_supported``: a multiple of 32, at most 8192;
    JAX's is a multiple of 128), else ``LayerNorm``. The two have the same
    parameters. Outside the gate ``FusedLayerNorm`` would run an eager
    float32 chain slower than ``F.layer_norm``, so the rule is decided here,
    once a module is built."""
    return FusedLayerNorm if fused_ln_supported(dim) else LayerNorm


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (``[..., C]``), which is not
    ``nn.BatchNorm2d``: the statistics are computed in float32 whatever the
    dtype, the variance as E[x²] − E[x]² clipped at 0 (flax's fast variance),
    and in training mode the running averages move as
    ``0.99·old + 0.01·batch`` with the *biased* batch variance. eps 1e-5.
    ``weight`` and ``bias`` are flax's ``scale`` and ``bias``; the buffers
    ``running_mean`` and ``running_var`` its ``batch_stats`` ``mean`` and
    ``var``. There is no ``num_batches_tracked``. The output is cast to
    ``dtype``."""

    momentum = 0.99
    eps = 1e-5

    def __init__(self, features: int, scale_init: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.scale_init = scale_init
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        self.weight.fill_(self.scale_init)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` (lecun-normal kernel unless ``kernel_init`` names
    another, zero bias) over NHWC images, with a stride and flax's explicit
    symmetric padding (an int ``padding`` pads every spatial side by it);
    NHWC out. ``padding="SAME"`` is flax's default: the total padding of an
    axis is max((out − 1)·stride + kernel − in, 0) with out = ⌈in / stride⌉,
    its smaller half before and the rest after (so a 3×3 stride-2 conv over
    an even side pads only after). The weight is kept OIHW, as torch's
    convolutions keep it.
    Inside, the NHWC tensor is viewed as a channels-last NCHW one, so the
    layout changes cost no copy. ``groups`` is flax's
    ``feature_group_count`` (a depthwise conv when it equals the channels:
    the weight ``[C, 1, kh, kw]``), and ``use_bias=False`` leaves out the
    ``bias`` parameter, as flax's tree has none."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | tuple[int, int], stride: int | tuple[int, int] = 1,
                 padding: int | str = 0, dtype: torch.dtype = torch.float32, device=None,
                 kernel_init: Callable | None = None, groups: int = 1, use_bias: bool = True):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride, self.padding, self.groups = stride, padding, groups
        self.compute_dtype = dtype
        self.kernel_init = kernel_init or lecun_normal_init()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kh, kw,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device)) if use_bias
                     else None)
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        # the init reads fans from a Dense-shaped [out, kh·kw·in/groups] view
        self.kernel_init(self.weight.view(self.weight.shape[0], -1), generator)
        if self.bias is not None:
            self.bias.zero_()

    def _same_pads(self, h: int, w: int) -> tuple[int, int, int, int]:
        """``F.pad``'s (left, right, top, bottom) for SAME padding."""
        pads = []
        sh, sw = (self.stride, self.stride) if isinstance(self.stride, int) else self.stride
        for size, k, st in ((w, self.weight.shape[3], sw), (h, self.weight.shape[2], sh)):
            total = max((-(-size // st) - 1) * st + k - size, 0)
            pads += [total // 2, total - total // 2]
        return tuple(pads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt).permute(0, 3, 1, 2)
        padding = self.padding
        if padding == "SAME":
            x = F.pad(x, self._same_pads(x.shape[2], x.shape[3]))
            padding = 0
        y = F.conv2d(x, self.weight.to(dt), bias, self.stride, padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """The flax modules' initializers, drawn from ``generator``: each Dense
    its own (lecun-normal kernels truncated at ±2σ and zero biases unless it
    names others), LayerNorm scale one and bias zero, and a module's own
    parameters through its ``init_own_params(generator)``."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.kernel_init(m.weight, generator)
            if m.bias is not None:
                m.bias_init(m.bias, generator)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if hasattr(m, "init_own_params"):
            m.init_own_params(generator)


class FeedForward(nn.Module):
    """LayerNorm → Dense → act → Dense (ref simple_vit.py:34-45)."""

    def __init__(self, dim: int, hidden_dim: int, act: Callable = ops.gelu,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm = _ln_cls(dim)(dim, eps=1e-5, dtype=dtype, device=device)
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype, device=device)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(self.norm(x))))


class Attention(nn.Module):
    """Pre-norm multi-head self-attention with optional Sinkhorn ("robust")
    normalization (ref simple_vit.py:48-76; robust branch :56-59). Shapes in
    the kernels' gate take the packed path (``ops.packed_attention``); the
    rest split q/k/v and take ``ops.dot_product_attention``. ``pre_norm=False``
    leaves out the LayerNorm (``norm``), for callers that normalize before
    it (``vision_transformer.EncoderBlock``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 robust: bool = False, qkv_bias: bool = False,
                 out_bias: bool = False, sinkhorn_iters: int = 3,
                 final_row_norm: bool = True, pre_norm: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.robust = robust
        self.sinkhorn_iters, self.final_row_norm = sinkhorn_iters, final_row_norm
        self.norm = (_ln_cls(dim)(dim, eps=1e-5, dtype=dtype, device=device) if pre_norm
                     else None)
        self.to_qkv = Dense(dim, inner * 3, bias=qkv_bias, dtype=dtype, device=device)
        self.to_out = Dense(inner, dim, bias=out_bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        b, n = x.shape[0], x.shape[1]
        qkv = self.to_qkv(x)
        kw = dict(scale=self.dim_head ** -0.5, robust=self.robust,
                  sinkhorn_iters=self.sinkhorn_iters,
                  final_row_norm=self.final_row_norm)
        if mask is None and ops.packed_dispatch(n, self.dim_head, self.heads, b,
                                                self.sinkhorn_iters):
            # packed path: reads the to_qkv layout in place, emits to_out's
            out = ops.packed_attention(qkv, self.heads, self.dim_head, **kw)
            return self.to_out(out)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        out = ops.dot_product_attention(q, k, v, mask=mask, **kw)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(out)


class Transformer(nn.Module):
    """Pre-norm residual stack of (Attention, FeedForward) pairs
    (ref simple_vit.py:79-97). Layers are named ``layers_{i}_attn`` and
    ``layers_{i}_ff`` as in the flax tree."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, robust: bool = False, final_norm: bool = False,
                 qkv_bias: bool = False, out_bias: bool = False,
                 ff_act: Callable = ops.gelu,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layers_{i}_attn", Attention(
                dim, heads=heads, dim_head=dim_head, robust=robust,
                qkv_bias=qkv_bias, out_bias=out_bias, dtype=dtype, device=device))
            self.add_module(f"layers_{i}_ff", FeedForward(
                dim, mlp_dim, act=ff_act, dtype=dtype, device=device))
        self.norm = (_ln_cls(dim)(dim, eps=1e-5, dtype=dtype, device=device)
                     if final_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"layers_{i}_attn")(x) + x
            x = getattr(self, f"layers_{i}_ff")(x) + x
        if self.norm is not None:
            x = self.norm(x)
        return x


def _patches(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """NHWC images → ``[B, H/ph, W/pw, ph·pw·C]`` patches, flattened in
    (p1, p2, c) order."""
    b, h, w, c = x.shape
    gh, gw = h // ph, w // pw
    x = x.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh, gw, ph * pw * c)


class PatchEmbed(nn.Module):
    """Patchify + linear embedding over NHWC images (ref simple_vit.py:126-131:
    ``Rearrange('b c (h p1) (w p2) -> b h w (p1 p2 c)')`` + Linear); the
    flattened patch's feature order is (p1, p2, c)."""

    def __init__(self, dim: int, patch_size: tuple[int, int], channels: int = 3,
                 bias: bool = True, flatten: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.flatten = flatten
        ph, pw = patch_size
        self.proj = Dense(ph * pw * channels, dim, bias=bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(_patches(x, *self.patch_size))
        if self.flatten:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
        return x


class PatchConv(Conv):
    """A ``Conv`` whose stride equals its kernel (flax ``nn.Conv`` with
    ``strides=kernel_size``, SAME padding, on an input that is a multiple of
    the kernel, so no padding): the same parameters and init, but ``forward``
    sends each patch, flattened in (p1, p2, c) order, through one Dense over
    the weight read as ``[out, ph·pw·c]``. Swin's patch embedding uses it; it
    keeps the products that its checks against the JAX package were made
    with."""

    def __init__(self, channels: int, dim: int, patch_size: tuple[int, int],
                 dtype: torch.dtype = torch.float32, device=None,
                 kernel_init: Callable | None = None):
        super().__init__(channels, dim, tuple(patch_size), stride=tuple(patch_size),
                         dtype=dtype, device=device, kernel_init=kernel_init)
        self.patch_size = tuple(patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        ph, pw = self.patch_size
        if h % ph or w % pw:
            raise ValueError(f"image {h}×{w} is not a multiple of the patch {ph}×{pw}")
        x = _patches(x, ph, pw)
        dt = self.compute_dtype
        weight = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(x.to(dt), weight.to(dt), self.bias.to(dt))


class DropPath(nn.Module):
    """Per-sample stochastic depth (ref utils.py:1100-1112): active in
    training mode, the identity in eval mode and at rate 0. The mask comes
    from ``generator`` (None takes torch's default generator of the device),
    which ``create_model`` sets to one seeded from its ``seed``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.drop_path(x, self.rate, self.generator, deterministic=not self.training)
