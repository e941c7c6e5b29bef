"""CaiT — Class-Attention in Image Transformers (counterpart of
``noise_robust_vit_tpu/models/cait.py``, ref cait.py).

Talking-heads attention (learned head mixes before and after the
normalization, ref cait.py:110-119), depth-dependent LayerScale
(ref cait.py:36-50), whole-layer dropout (ref cait.py:17-33), a
patch-transformer stage, then a class-attention stage in which the CLS
token attends to ``cat(cls, patches)`` (ref cait.py:178-235). Input is
NHWC, as in the JAX package.

``robust`` swaps the softmax for Sinkhorn between the two mixes
(ref cait.py:89-92). The reference's ``CaiT.__init__`` drops the ``robust``
its own Transformer supports; it is threaded here, as in JAX. The patch
stage's square logits take the talking-heads kernels
(``ops.talking_heads_robust_softmax``); the CLS stage's one query row takes
the vector form, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..utils import normal_init, pair, resolve_device
from .layers import Dense, LayerNorm, _patches

__all__ = ["CaiT", "cait_macs_per_image"]


class _TalkingHeadsAttention(nn.Module):
    """q from ``x``, k and v from ``cat(x, context)``; float32 logits
    scaled by ``dim_head**-0.5``; the fused sandwich when dropout is 0 or in
    eval mode, else the unfused one with dropout between the normalization
    and the post-mix (ref cait.py:56-72)."""

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float, robust: bool,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.dropout, self.robust = dropout, robust
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype, device=device)
        self.to_kv = Dense(dim, inner * 2, bias=False, dtype=dtype, device=device)
        self.to_out = Dense(inner, dim, dtype=dtype, device=device)
        self.mix_heads_pre_attn = nn.Parameter(torch.empty(heads, heads, device=device))
        self.mix_heads_post_attn = nn.Parameter(torch.empty(heads, heads, device=device))
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        normal_init(1.0)(self.mix_heads_pre_attn, generator)
        normal_init(1.0)(self.mix_heads_post_attn, generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        h, dh = self.heads, self.dim_head
        ctx = x if context is None else torch.cat([x, context], dim=1)
        b, n, m = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).reshape(b, n, h, dh).transpose(1, 2)
        k, v = (t.reshape(b, m, h, dh).transpose(1, 2) for t in self.to_kv(ctx).chunk(2, dim=-1))
        dots = ops.matmul_f32(q, k.transpose(-1, -2)) * dh ** -0.5
        pre, post = self.mix_heads_pre_attn, self.mix_heads_post_attn
        if self.dropout == 0.0 or not self.training:
            attn = ops.talking_heads_robust_softmax(dots, pre, post, robust=self.robust)
        else:
            dots = torch.einsum("bhij,hg->bgij", dots, pre.to(dots.dtype))
            attn = ops.robust_softmax(dots, robust=self.robust)
            attn = F.dropout(attn, self.dropout, self.training)
            attn = torch.einsum("bhij,hg->bgij", attn, post.to(attn.dtype))
        out = torch.matmul(attn.to(v.dtype), v).transpose(1, 2).reshape(b, n, h * dh)
        return F.dropout(self.to_out(out), self.dropout, self.training)


class _FeedForward(nn.Module):
    """fc1 → gelu → fc2, with dropout after each and no norm."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.dropout(ops.gelu(self.fc1(x)), self.dropout, self.training)
        return F.dropout(self.fc2(x), self.dropout, self.training)


def _layerscale_init(depth_ind: int) -> float:
    """(ref cait.py:38-44, per the CaiT paper §2.)"""
    if depth_ind <= 18:
        return 0.1
    if depth_ind <= 24:
        return 1e-5
    return 1e-6


class _Transformer(nn.Module):
    """Pre-norm (eps 1e-5) layers of talking-heads attention and
    feed-forward, each branch scaled by its LayerScale ``scale_attn_{i}`` /
    ``scale_ff_{i}`` (``[1, 1, dim]``). In training mode with
    ``layer_dropout > 0`` one draw per layer keeps or drops both branches
    (no rescale), from ``generator`` (None takes torch's default one of the
    device), which ``create_model`` seeds, as the JAX model draws from its
    ``dropout`` key."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float, layer_dropout: float, robust: bool,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.depth, self.layer_dropout = depth, layer_dropout
        self.generator: torch.Generator | None = None
        for i in range(depth):
            self.add_module(f"norm_attn_{i}", LayerNorm(dim, eps=1e-5, dtype=dtype,
                                                        device=device))
            self.add_module(f"attn_{i}", _TalkingHeadsAttention(
                dim, heads, dim_head, dropout, robust, dtype=dtype, device=device))
            self.add_module(f"norm_ff_{i}", LayerNorm(dim, eps=1e-5, dtype=dtype, device=device))
            self.add_module(f"ff_{i}", _FeedForward(dim, mlp_dim, dropout, dtype=dtype,
                                                    device=device))
            for name in (f"scale_attn_{i}", f"scale_ff_{i}"):
                self.register_parameter(name, nn.Parameter(torch.empty(1, 1, dim, device=device)))
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        for i in range(self.depth):
            getattr(self, f"scale_attn_{i}").fill_(_layerscale_init(i + 1))
            getattr(self, f"scale_ff_{i}").fill_(_layerscale_init(i + 1))

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        for i in range(self.depth):
            keep = 1.0
            if self.layer_dropout > 0.0 and self.training:
                keep = torch.empty((), device=x.device).bernoulli_(
                    1.0 - self.layer_dropout, generator=self.generator).to(x.dtype)
            h = getattr(self, f"attn_{i}")(getattr(self, f"norm_attn_{i}")(x), context=context)
            x = x + keep * h * getattr(self, f"scale_attn_{i}").to(x.dtype)
            f = getattr(self, f"ff_{i}")(getattr(self, f"norm_ff_{i}")(x))
            x = x + keep * f * getattr(self, f"scale_ff_{i}").to(x.dtype)
        return x


class CaiT(nn.Module):
    """On the card unless ``device`` says otherwise."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int, depth: int,
                 cls_depth: int, heads: int, mlp_dim: int, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, layer_dropout: float = 0.0,
                 channels: int = 3, robust: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.patch_size, self.dim, self.emb_dropout = (ph, pw), dim, emb_dropout
        n = (ih // ph) * (iw // pw)
        self.patch_proj = Dense(ph * pw * channels, dim, dtype=dtype, device=device)
        self.pos_embedding = nn.Parameter(torch.empty(1, n, dim, device=device))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device=device))
        stage = dict(heads=heads, dim_head=dim_head, mlp_dim=mlp_dim, dropout=dropout,
                     layer_dropout=layer_dropout, robust=robust, dtype=dtype, device=device)
        self.patch_transformer = _Transformer(dim, depth, **stage)
        self.cls_transformer = _Transformer(dim, cls_depth, **stage)
        self.head_norm = LayerNorm(dim, eps=1e-5, dtype=dtype, device=device)
        self.head = Dense(dim, num_classes, dtype=dtype, device=device)
        with torch.no_grad():
            self.init_own_params(None)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        normal_init(1.0)(self.pos_embedding, generator)
        normal_init(1.0)(self.cls_token, generator)

    def forward(self, img: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        b = img.shape[0]
        x = _patches(img, *self.patch_size)
        x = self.patch_proj(x.reshape(b, -1, x.shape[-1]))
        x = x + self.pos_embedding.to(x.dtype)
        x = F.dropout(x, self.emb_dropout, self.training)
        x = self.patch_transformer(x)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.dim)
        x = self.head_norm(self.cls_transformer(cls, context=x)[:, 0])
        if return_features:
            return x
        return self.head(x)


def cait_macs_per_image(model: CaiT) -> int:
    """Forward multiply-adds of one image: the patch projection, every Dense
    (the CLS stage's ``to_kv`` over N + 1 tokens), q·kᵀ and attn·v of both
    stages, and the head. The head mixes, the normalization, LayerNorm and
    the activations are not counted."""
    n, dim = model.pos_embedding.shape[1], model.dim
    macs = n * model.patch_proj.in_features * dim
    for stage, queries, keys in ((model.patch_transformer, n, n),
                                 (model.cls_transformer, 1, n + 1)):
        for i in range(stage.depth):
            attn, ff = getattr(stage, f"attn_{i}"), getattr(stage, f"ff_{i}")
            inner = attn.heads * attn.dim_head
            macs += (queries * dim * inner + keys * dim * 2 * inner
                     + 2 * attn.heads * queries * keys * attn.dim_head
                     + queries * inner * dim + 2 * queries * dim * ff.fc1.out_features)
    return macs + dim * model.head.out_features
