"""Multi-head attention ops (counterpart of
``noise_robust_vit_tpu/ops/attention.py``): the plain vector-form path over
``[B, H, N, D]`` tensors, and the dispatch to the packed-qkv, biased,
streaming and fused q/k/v kernels.

Dispatch rule: a packed ``[B, N, 3·H·D]`` tensor whose shape passes the
packed kernels' gate goes to ``packed_attention``; a robust windowed
attention whose shape passes the biased kernels' gate goes to
``biased_attention``; a robust q/k/v attention with more than 640 queries
or keys (padded to 128, as JAX counts) inside the streaming kernels' gate
goes to ``streaming_attention``; a robust ``dot_product_attention`` call
that the JAX package's fused kernel takes and whose shape passes the fused
kernels' gate (MobileViT's 4 heads of width 8) goes to ``fused_attention``.
Each launches its CUDA kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor. A shape outside the gate
takes ``dot_product_attention`` (or the model's own plain path). The choice
is made on shape before the call, never after a kernel error.
"""

from __future__ import annotations

import torch

from .cuda.biased_attention import BiasedAttention, biased_attention_supported
from .cuda.fused_attention import FusedAttention, fused_attention_supported
from .cuda.packed_attention import PackedAttention, packed_attention_supported
from .cuda.streaming_attention import StreamingAttention, streaming_attention_supported
from .sinkhorn import sinkhorn_scalings

__all__ = ["biased_attention", "biased_dispatch", "dot_product_attention",
           "fused_attention", "fused_dispatch", "matmul_f32", "packed_attention",
           "packed_dispatch", "streaming_attention", "streaming_dispatch"]


class _Bf16MatmulF32(torch.autograd.Function):
    """``a [..., n, k] @ b [..., k, m]`` (batch dims broadcast), bf16 CUDA
    tensors, to float32 on the tensor cores (``aten::bmm.dtype``). Its
    backward, which that op lacks, is the upcast product's: the float32
    gradient against the operands cast up, summed over broadcast dims,
    rounded to bf16 once. (Splitting the gradient into bf16 hi + lo for
    tensor-core products moved the N×M gradient through memory three more
    times and slowed the host-bound vanilla steps: PERF.md §6.)"""

    @staticmethod
    def forward(ctx, a, b):
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        ctx.save_for_backward(a3, b3)
        ctx.shapes = (lead, a.shape, b.shape)
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
        return out.reshape(*lead, a.shape[-2], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a3, b3 = ctx.saved_tensors
        lead, a_shape, b_shape = ctx.shapes
        g3 = g.reshape(-1, *g.shape[-2:])
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g3, b3.transpose(1, 2).float()).reshape(*lead, *a_shape[-2:])
            ga = ga.sum_to_size(a_shape).to(a3.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a3.transpose(1, 2).float(), g3).reshape(*lead, *b_shape[-2:])
            gb = gb.sum_to_size(b_shape).to(b3.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over ``[..., n, k]`` and ``[..., k, m]`` (batch dims
    broadcast) as float32, as the JAX package's ``preferred_element_type=
    jnp.float32``: bf16 CUDA operands multiply straight into float32 on the
    tensor cores (a bf16 × bf16 product is exact in float32; only the order
    of the sum differs from the upcast product). Every other case upcasts
    and takes ``torch.matmul``: float32 operands, and CPU tensors, where the
    op is missing."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return _Bf16MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


# Whether the packed kernels serve a self-attention shape (vanilla and robust
# both take them): the kernels' own shape gate.
packed_dispatch = packed_attention_supported


def packed_attention(qkv: torch.Tensor, heads: int, dim_head: int, *,
                     scale: float | None = None, robust: bool = False,
                     sinkhorn_iters: int = 3, final_row_norm: bool = True,
                     ) -> torch.Tensor:
    """Fused attention over the packed ``[B, N, 3·H·D]`` qkv projection
    (q|k|v chunk order, ref simple_vit.py:66-68). Returns ``[B, N, H·D]``."""
    if scale is None:
        scale = dim_head ** -0.5
    return PackedAttention.apply(qkv, int(heads), int(dim_head), float(scale),
                                 bool(robust), int(sinkhorn_iters),
                                 bool(final_row_norm))


def biased_dispatch(robust: bool, bw: int, heads: int, n: int, d: int, dv: int,
                    num_windows: int, sinkhorn_iters: int = 3) -> bool:
    """Whether the biased kernels serve a windowed attention: the Sinkhorn
    path only, as in the JAX package (plain-softmax windowed models stay on
    batched matmuls and a softmax), and a shape inside the kernels' gate."""
    return robust and biased_attention_supported(bw, heads, n, d, dv, num_windows,
                                                 sinkhorn_iters)


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, *, scale: float | None = None,
                     robust: bool = False, sinkhorn_iters: int = 3,
                     final_row_norm: bool = True, num_windows: int = 1,
                     no_bias: bool = False) -> torch.Tensor:
    """Fused attention with an additive per-(window, head) logit bias:
    ``q/k [BW, H, N, D]``, ``v [BW, H, N, DV]``, ``bias [nW, H, N, N]``
    broadcast over the batch (window ``bw`` reads row ``bw % nW``).
    ``no_bias=True`` declares ``bias`` known to be zero: the kernels skip the
    bias add and the dbias sum, and its gradient is zero (Twins local
    attention). Returns ``[BW, H, N, DV]`` in ``v``'s dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return BiasedAttention.apply(q, k, v, bias, float(scale), bool(robust),
                                 int(sinkhorn_iters), bool(final_row_norm),
                                 int(num_windows), bool(no_bias))


def streaming_dispatch(robust: bool, b: int, heads: int, n: int, m: int, d: int,
                       sinkhorn_iters: int = 3) -> bool:
    """Whether the streaming kernels serve a q/k/v attention of ``n``
    queries and ``m`` keys: the JAX package's policy (the Sinkhorn path
    only, and the giant-N regime the logits-interface kernels refuse,
    ``max(round_up(n, 128), round_up(m, 128)) > 640``, which is
    ``max(n, m) > 640`` since 640 is a multiple of 128: CvT's stages 1 and 2
    at 224 px), inside the streaming kernels' gate."""
    return (robust and max(n, m) > 640
            and streaming_attention_supported(b, heads, n, m, d, sinkhorn_iters))


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, sinkhorn_iters: int = 3,
                        final_row_norm: bool = True) -> torch.Tensor:
    """Sinkhorn attention at the q/k/v interface, never forming the N×M
    matrix in device memory: ``q [B, H, N, D]``, ``k, v [B, H, M, D]`` →
    ``robust_softmax(scale·q·kᵀ) · v`` ``[B, H, N, D]`` in v's dtype (softmax
    and the Sinkhorn schedule in float32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return StreamingAttention.apply(q, k, v, float(scale), int(sinkhorn_iters),
                                    bool(final_row_norm))


def fused_dispatch(robust: bool, q_shape, k_shape, v_shape, has_bias: bool = False,
                   has_mask: bool = False, sinkhorn_iters: int = 3, dtype=None) -> bool:
    """Whether the fused q/k/v kernels serve a ``dot_product_attention``
    call: the JAX package's policy (the Sinkhorn path only, ``ops/
    attention.py::pallas_dispatch``) and its kernel's refusals
    (``sinkhorn_attention.py::fused_attention``: no bias or mask, q and k of
    one shape, ``round_up(N, 128) ≤ 1536``, D and DV ≤ 256), then the port's
    kernel gate (D and DV from 4 to 32, a shared-memory budget) and, with
    ``dtype``, its dtypes."""
    if not robust or has_bias or has_mask:
        return False
    if len(q_shape) < 2 or tuple(q_shape) != tuple(k_shape):
        return False
    n, d, dv = q_shape[-2], q_shape[-1], v_shape[-1]
    if (n + 127) // 128 * 128 > 1536 or d > 256 or dv > 256:
        return False
    return fused_attention_supported(n, d, dv, sinkhorn_iters, True, dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, robust: bool = False,
                    sinkhorn_iters: int = 3, final_row_norm: bool = True) -> torch.Tensor:
    """Fused attention at the q/k/v interface, never forming the N×N matrix
    in device memory: ``q, k [..., N, D]``, ``v [..., N, DV]`` →
    ``(softmax | Sinkhorn)(scale·q·kᵀ) · v`` ``[..., N, DV]`` in v's dtype
    (softmax and the Sinkhorn schedule in float32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FusedAttention.apply(q, k, v, float(scale), bool(robust), int(sinkhorn_iters),
                                bool(final_row_norm))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: float | None = None,
                          bias: torch.Tensor | None = None,
                          mask: torch.Tensor | None = None,
                          robust: bool = False, sinkhorn_iters: int = 3,
                          final_row_norm: bool = True) -> torch.Tensor:
    """``softmax(q·kᵀ·scale [+bias][mask])`` (optionally Sinkhorn-renormalized)
    ``· v`` over ``[..., N, D]``; returns ``v``'s dtype. Logits and the
    weights are float32, as the JAX package's ``preferred_element_type``.
    ``mask`` is boolean (True = attend). A call that ``fused_dispatch``
    accepts takes ``fused_attention``; the rest the vector form below."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.dtype == k.dtype == v.dtype and fused_dispatch(
            robust, q.shape, k.shape, v.shape, bias is not None, mask is not None,
            sinkhorn_iters, q.dtype):
        return fused_attention(q, k, v, scale=scale, robust=True, sinkhorn_iters=sinkhorn_iters,
                               final_row_norm=final_row_norm)
    logits = matmul_f32(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    attn = torch.softmax(logits, dim=-1)
    if mask is not None:
        attn = torch.where(mask, attn, torch.zeros_like(attn))
    if robust:
        # out = a ⊙ (A @ (b ⊙ v)); with no hard mask the rows are an exact
        # softmax, so the first row normalization is skipped
        a, b = sinkhorn_scalings(attn, num_iters=sinkhorn_iters,
                                 final_row_norm=final_row_norm,
                                 assume_row_stochastic=mask is None)
        v = v * b[..., :, None].to(v.dtype)
        out = matmul_f32(attn.to(v.dtype), v)
        return (out * a[..., :, None]).to(v.dtype)
    return matmul_f32(attn.to(v.dtype), v).to(v.dtype)
