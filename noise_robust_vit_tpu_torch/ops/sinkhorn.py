"""Sinkhorn (doubly-stochastic) attention normalization in plain torch
(counterpart of ``noise_robust_vit_tpu/ops/sinkhorn.py``).

Two schedules, as in the reference: softmax then 3 row/column
renormalizations plus a final row normalization (ref utils.py:1025-1037),
and softmax then 4 row/column renormalizations with no final row pass
(ref utils.py:218-224).
"""

from __future__ import annotations

import torch

__all__ = [
    "sinkhorn_scalings",
    "sinkhorn_normalize",
    "sinkhorn_attention",
    "robust_softmax",
    "talking_heads_robust_softmax",
]


def clamped_recip(x: torch.Tensor) -> torch.Tensor:
    """``1 / x`` with exact-zero sums mapped to 1 through a double ``where``
    (so the gradient stays NaN-free) and live sums clamped at 1e-8, which
    keeps the scaling vectors finite when training starves a key of mass."""
    safe = torch.where(x == 0.0, torch.ones_like(x), torch.clamp_min(x, 1e-8))
    return torch.where(x == 0.0, torch.ones_like(x), 1.0 / safe)


def sinkhorn_scalings(attn: torch.Tensor, num_iters: int = 3,
                      final_row_norm: bool = True,
                      assume_row_stochastic: bool = False,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sinkhorn-Knopp scaling vectors ``(a [..., N], b [..., M])`` such that
    ``diag(a) · attn · diag(b)`` equals the reference's alternating
    row/column rewrites. With ``assume_row_stochastic`` (``attn`` is a row
    softmax of the differentiated logits) the first row normalization is the
    identity in value and gradient and is skipped."""
    b = torch.ones(attn.shape[:-2] + (attn.shape[-1],), dtype=attn.dtype,
                   device=attn.device)
    a = torch.ones(attn.shape[:-2] + (attn.shape[-2],), dtype=attn.dtype,
                   device=attn.device)
    for i in range(num_iters):
        if not (i == 0 and assume_row_stochastic):
            a = clamped_recip(torch.einsum("...nm,...m->...n", attn, b))
        b = clamped_recip(torch.einsum("...nm,...n->...m", attn, a))
    if final_row_norm:
        a = clamped_recip(torch.einsum("...nm,...m->...n", attn, b))
    return a, b


def sinkhorn_normalize(attn: torch.Tensor, num_iters: int = 3,
                       final_row_norm: bool = True, eps: float = 0.0,
                       ) -> torch.Tensor:
    """Alternating row (sum over -1) / column (sum over -2) renormalization
    of a non-negative matrix. ``eps > 0`` takes the literal rewrite form."""
    if eps:
        for _ in range(num_iters):
            attn = attn / (attn.sum(-1, keepdim=True) + eps)
            attn = attn / (attn.sum(-2, keepdim=True) + eps)
        if final_row_norm:
            attn = attn / (attn.sum(-1, keepdim=True) + eps)
        return attn
    a, b = sinkhorn_scalings(attn, num_iters=num_iters, final_row_norm=final_row_norm)
    return attn * a[..., :, None] * b[..., None, :]


def sinkhorn_attention(logits: torch.Tensor, axis: int = -1, num_iters: int = 3,
                       final_row_norm: bool = True) -> torch.Tensor:
    """softmax then Sinkhorn renormalization, in float32, cast back to the
    input dtype (ref utils.py:1025-1037).

    Over the last axis, a square shape inside the square kernels' gate takes
    ``SinkhornSoftmax`` and a non-square one inside the rectangular gate
    ``SinkhornSoftmaxRect`` (the CUDA kernels for a CUDA tensor, their plain
    versions for a CPU one), as the JAX package routes them to its Pallas
    kernels; anything else takes the vector form below. The choice is made
    on shape and dtype before the call."""
    if axis in (-1, logits.ndim - 1):
        # imported here: the kernels' module imports this one
        from .cuda import sinkhorn_softmax as ss

        args = (logits.shape, num_iters, logits.dtype)
        if ss.sinkhorn_softmax_supported(*args):
            return ss.SinkhornSoftmax.apply(logits, int(num_iters), bool(final_row_norm))
        if ss.sinkhorn_softmax_rect_supported(*args):
            return ss.SinkhornSoftmaxRect.apply(logits, int(num_iters), bool(final_row_norm))
    attn = torch.softmax(logits.float(), dim=axis)
    attn = sinkhorn_normalize(attn, num_iters=num_iters, final_row_norm=final_row_norm)
    return attn.to(logits.dtype)


def robust_softmax(logits: torch.Tensor, robust: bool = False,
                   axis: int = -1) -> torch.Tensor:
    """Plain softmax, or softmax + Sinkhorn (3 iterations + final row norm)."""
    if not robust:
        return torch.softmax(logits, dim=axis)
    return sinkhorn_attention(logits, axis=axis, num_iters=3, final_row_norm=True)


def talking_heads_robust_softmax(dots: torch.Tensor, mix_pre: torch.Tensor,
                                 mix_post: torch.Tensor, robust: bool = False
                                 ) -> torch.Tensor:
    """CaiT's talking-heads sandwich (ref cait.py:110-119): pre-softmax head
    mix → (softmax | Sinkhorn, 3 iterations + final row norm) → post-softmax
    head mix, on ``dots [B, H, N, N]`` with ``mix_* [H, H]`` cast to the
    dots' dtype (counterpart of the JAX ``talking_heads_robust_softmax``).

    Robust shapes inside the talking-heads gate take ``TalkingHeadsSinkhorn``
    (the CUDA kernels for a CUDA tensor, the plain version for a CPU one);
    the rest, vanilla included, take einsum → ``robust_softmax`` → einsum.
    The choice is made on shape and dtype before the call. Callers with
    attention dropout between the normalization and the post-mix take the
    unfused path themselves: the fused one has no dropout point."""
    pre, post = mix_pre.to(dots.dtype), mix_post.to(dots.dtype)
    if robust:
        # imported here: the kernels' module imports this one
        from .cuda import talking_heads as th

        if th.talking_heads_supported(dots.shape, 3, dots.dtype):
            return th.TalkingHeadsSinkhorn.apply(dots, pre, post, 3, True)
    attn = robust_softmax(torch.einsum("bhij,hg->bgij", dots, pre), robust=robust)
    return torch.einsum("bhij,hg->bgij", attn, post)
