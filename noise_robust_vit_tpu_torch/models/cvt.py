"""CvT — Convolutions-to-Vision-Transformers (counterpart of
``noise_robust_vit_tpu/models/cvt.py``, ref cvt.py).

Three stages; each is a strided conv embedding, a channel LayerNorm and
transformer blocks whose q/k/v projections are a depthwise conv, a flax
BatchNorm and a 1×1 conv, with a stride on k/v that reduces the keys
(ref cvt.py:59-102); the feed-forward is two 1×1 convs (ref cvt.py:47-57).
NHWC maps end to end; the head is a global average pool and a linear
(ref cvt.py:168-177). ``dim_head`` is fixed at 64, as upstream.

Attention dispatch, as in JAX: a robust attention with no active dropout
whose shape passes ``ops.streaming_dispatch`` (more than 640 queries or
keys: stages 1 and 2 at 224 px) takes ``ops.streaming_attention``; the
rest take float32 logits and ``ops.robust_softmax`` (a rectangular robust
shape reaches the rect logits-interface kernels: stage 3 at 224 px), then
attn·v; vanilla takes a float32 einsum, softmax, einsum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..ops.cuda.fused_ln import fused_layer_norm, fused_ln_supported
from ..utils import resolve_device
from .layers import BatchNorm, Conv, Dense

__all__ = ["CvT", "cvt_macs_per_image"]

_STAGE_KEYS = ("emb_dim", "emb_kernel", "emb_stride", "proj_kernel", "kv_proj_stride",
               "heads", "depth", "mlp_mult")
# CvT-13 (Wu et al. 2021, Table 2; the JAX module's defaults)
_DEFAULTS = {1: (64, 7, 4, 3, 2, 1, 1, 4), 2: (192, 3, 2, 3, 2, 3, 2, 4),
             3: (384, 3, 2, 3, 2, 6, 10, 4)}
DIM_HEAD = 64


class _DWConvProj(nn.Module):
    """Depthwise conv (no bias) → BatchNorm → 1×1 conv (no bias)
    (ref cvt.py:59-68)."""

    def __init__(self, dim: int, dim_out: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dw = Conv(dim, dim, kernel, stride, kernel // 2, dtype=dtype, device=device,
                       groups=dim, use_bias=False)
        self.bn = BatchNorm(dim, dtype=dtype, device=device)
        self.pw = Conv(dim, dim_out, 1, dtype=dtype, device=device, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.bn(self.dw(x)))


class _CvtAttention(nn.Module):
    """(ref cvt.py:70-102.) The Sinkhorn schedule is the reference's fixed
    one, 3 iterations and a final row normalization, on both robust paths:
    ``robust_softmax`` has it built in, and the streaming call is given it."""

    sinkhorn_iters = 3
    final_row_norm = True

    def __init__(self, dim: int, proj_kernel: int, kv_proj_stride: int, heads: int,
                 dim_head: int, dropout: float, robust: bool,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.dropout, self.robust = dropout, robust
        self.to_q = _DWConvProj(dim, inner, proj_kernel, 1, dtype=dtype, device=device)
        self.to_kv = _DWConvProj(dim, 2 * inner, proj_kernel, kv_proj_stride, dtype=dtype,
                                 device=device)
        self.to_out = Conv(inner, dim, 1, dtype=dtype, device=device)

    def _heads_first(self, t: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = t.shape
        return t.reshape(b, h * w, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        scale = self.dim_head ** -0.5
        q = self._heads_first(self.to_q(x))
        k, v = (self._heads_first(t) for t in self.to_kv(x).chunk(2, dim=-1))
        # attention dropout acts on the matrix (ref cvt.py:95-97), so the
        # streaming path only serves when it is inactive
        if (self.robust and (not self.training or self.dropout == 0.0)
                and ops.streaming_dispatch(True, b, self.heads, q.shape[2], k.shape[2],
                                           self.dim_head, self.sinkhorn_iters)):
            out = ops.streaming_attention(q, k, v, scale=scale,
                                          sinkhorn_iters=self.sinkhorn_iters,
                                          final_row_norm=self.final_row_norm)
        else:
            dots = ops.matmul_f32(q, k.transpose(-1, -2)) * scale
            attn = ops.robust_softmax(dots, robust=self.robust)
            attn = F.dropout(attn, self.dropout, self.training)
            out = torch.matmul(attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, h, w, self.heads * self.dim_head)
        return F.dropout(self.to_out(out), self.dropout, self.training)


class _ChannelLN(nn.Module):
    """LayerNorm over the channel axis of an NHWC map with the biased
    variance (ref cvt.py:25-35); parameters ``g`` and ``b`` as in the flax
    tree. The map is NHWC, so this is a LayerNorm over the last axis: at a
    width inside the fused LayerNorm kernels' gate (CvT-13's 64, 192 and
    384) it runs them, float32 moments with y rounded once to x's dtype;
    elsewhere it computes in the input's dtype, as JAX's ``_ChannelLN`` does
    everywhere. In bf16 the fused math is the closer to the exact norm: a
    chosen difference from JAX."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim, device=device))
        self.b = nn.Parameter(torch.zeros(dim, device=device))

    def init_own_params(self, generator: torch.Generator | None) -> None:
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if fused_ln_supported(x.shape[-1]):
            return fused_layer_norm(x, self.g, self.b, self.eps)
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.g.to(x.dtype) + self.b.to(x.dtype)


class CvT(nn.Module):
    """On the card unless ``device`` says otherwise. Stage ``s`` takes the
    keyword arguments ``s{s}_emb_dim``, ``s{s}_emb_kernel``,
    ``s{s}_emb_stride``, ``s{s}_proj_kernel``, ``s{s}_kv_proj_stride``,
    ``s{s}_heads``, ``s{s}_depth`` and ``s{s}_mlp_mult``; the defaults are
    CvT-13's."""

    def __init__(self, num_classes: int, dropout: float = 0.0, robust: bool = False,
                 channels: int = 3, dtype: torch.dtype = torch.float32, device=None, **stages):
        super().__init__()
        device = resolve_device(device)
        self.stages = {}
        for s, values in _DEFAULTS.items():
            cfg = {key: stages.pop(f"s{s}_{key}", value) for key, value in zip(_STAGE_KEYS, values)}
            self.stages[s] = cfg
        if stages:
            raise TypeError(f"unknown CvT arguments: {sorted(stages)}")
        self.dropout = dropout
        cin = channels
        for s, cfg in self.stages.items():
            dim, kernel = cfg["emb_dim"], cfg["emb_kernel"]
            self.add_module(f"s{s}_embed", Conv(cin, dim, kernel, cfg["emb_stride"], kernel // 2,
                                                dtype=dtype, device=device))
            self.add_module(f"s{s}_norm", _ChannelLN(dim, device=device))
            for d in range(cfg["depth"]):
                p = f"s{s}_b{d}_"
                self.add_module(p + "norm1", _ChannelLN(dim, device=device))
                self.add_module(p + "attn", _CvtAttention(
                    dim, cfg["proj_kernel"], cfg["kv_proj_stride"], cfg["heads"], DIM_HEAD,
                    dropout, robust, dtype=dtype, device=device))
                self.add_module(p + "norm2", _ChannelLN(dim, device=device))
                self.add_module(p + "ff1", Conv(dim, dim * cfg["mlp_mult"], 1, dtype=dtype,
                                                device=device))
                self.add_module(p + "ff2", Conv(dim * cfg["mlp_mult"], dim, 1, dtype=dtype,
                                                device=device))
            cin = dim
        self.head = Dense(cin, num_classes, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        for s, cfg in self.stages.items():
            x = getattr(self, f"s{s}_norm")(getattr(self, f"s{s}_embed")(x))
            for d in range(cfg["depth"]):
                p = f"s{s}_b{d}_"
                x = x + getattr(self, p + "attn")(getattr(self, p + "norm1")(x))
                f = ops.gelu(getattr(self, p + "ff1")(getattr(self, p + "norm2")(x)))
                f = F.dropout(f, self.dropout, self.training)
                f = F.dropout(getattr(self, p + "ff2")(f), self.dropout, self.training)
                x = x + f
        x = x.mean(dim=(1, 2))
        if return_features:
            return x
        return self.head(x)


def cvt_macs_per_image(model: CvT, image_size: int = 224) -> int:
    """Forward multiply-adds of one ``image_size`` image: the conv
    embeddings, each block's depthwise and pointwise q and k/v projections,
    q·kᵀ and attn·v, ``to_out`` and the 1×1-conv feed-forward, and the head.
    BatchNorm, the LayerNorms and the activations are not counted."""

    def conv_out(size, kernel, stride):
        return (size + 2 * (kernel // 2) - kernel) // stride + 1

    size, cin, macs = image_size, model.s1_embed.weight.shape[1], 0
    for s, cfg in model.stages.items():
        dim, kernel = cfg["emb_dim"], cfg["emb_kernel"]
        size = conv_out(size, kernel, cfg["emb_stride"])
        n = size * size
        macs += n * kernel * kernel * cin * dim
        pk = cfg["proj_kernel"]
        m = conv_out(size, pk, cfg["kv_proj_stride"]) ** 2
        inner = cfg["heads"] * DIM_HEAD
        block = (n * pk * pk * dim + n * dim * inner            # to_q
                 + m * pk * pk * dim + m * dim * 2 * inner      # to_kv
                 + 2 * n * m * inner                            # q·kᵀ, attn·v
                 + n * inner * dim                              # to_out
                 + 2 * n * dim * dim * cfg["mlp_mult"])         # ff1, ff2
        macs += cfg["depth"] * block
        cin = dim
    return macs + cin * model.head.out_features
