"""Fused q/k/v attention for narrow heads: ``q, k [K, N, D]``, ``v [K, N,
DV]`` → ``softmax(scale·q·kᵀ)·v``, or with the softmax Sinkhorn-normalized
(any number of iterations, with or without a final row norm), differentiable
in q, k and v. MobileViT's transformers (4 heads of width 8) are its first
callers.

Counterpart of ``noise_robust_vit_tpu/ops/pallas/sinkhorn_attention.py``
(``fused_attention``; its Pallas calls are ``_fused_attention_impl`` and
``_fused_attention_bwd_impl``). The JAX kernel pads N to 128 lanes and masks
the padded columns after the softmax; the kernels here need no padding, and
the residual stack is the JAX kernel's without it: ``vecs [K, R, N]``
float32, the a-rows, the b-rows and the softmax log-normalizer (robust), or
the log-normalizer alone (vanilla) (``plain.num_vecs``).

Three pieces live here, as in ``streaming_attention.py``: the plain PyTorch
versions (the kernels' algorithm in ``plain.py``, with no bias), the ctypes
wrappers of ``csrc/fused_attention_{fwd,bwd}.cu`` with a launch count, and
the autograd function ``FusedAttention``.
"""

from __future__ import annotations

import torch

from .build import LaunchCounts, by_device, check_operand, ptr, raise_on, stream
from .plain import attention_bwd_plain, attention_fwd_plain, num_vecs

__all__ = [
    "FusedAttention",
    "fused_attention_bwd",
    "fused_attention_bwd_cuda",
    "fused_attention_bwd_plain",
    "fused_attention_fwd",
    "fused_attention_fwd_cuda",
    "fused_attention_fwd_plain",
    "fused_attention_supported",
    "launches",
    "num_vecs",
]

# Gate. The kernels keep no N×N matrix: each item's q, k, v (and g) rows and
# its vectors sit in shared memory as float32, and every pass forms the
# entries it needs anew. 256 threads a block; the least power of two ≥ N
# of them serve one item, so a block holds 256 / P items side by side.
# csrc fused_{fwd,bwd}_item_floats and fused_check, mirrored below, plus the
# static shared memory (the rank-1 term offsets, 136 bytes; STATIC_SMEM
# keeps 1024).
MAX_D = 32
MAX_ITERS = 8
_THREADS = 256
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_STATIC_SMEM = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounts()


def _padded_ld(n: int) -> int:
    return (n + 3) // 4 * 4


def _threads_per_item(n: int) -> int:
    p = 1
    while p < n and p < _THREADS:
        p *= 2
    return p


def _smem_bytes(n: int, d: int, dv: int, it: int) -> int:
    """Shared memory of the larger direction's block (csrc
    fused_{fwd,bwd}_smem_bytes); ``it`` is the iterations when robust, else 0."""
    fwd = n * (2 * d + dv) + 3 * _padded_ld(n)
    bwd = n * (2 * d + 2 * dv) + (5 + 4 * it) * _padded_ld(n)
    return 4 * (_THREADS // _threads_per_item(n)) * max(fwd, bwd)


def fused_attention_supported(n: int, d: int, dv: int, iters: int = 3, robust: bool = True,
                              dtype=None) -> bool:
    """Shape gate of the kernels, decided before any call: at least one row,
    D and DV multiples of 4 from 4 to 32, 1 to 8 iterations when robust, and
    a block's items within one block's shared memory (N up to ~1150 at D =
    DV = 8 with 3 iterations); with ``dtype``, also whether the kernels take
    it (float32, bfloat16). The number of items does not count."""
    if n < 1 or min(d, dv) < 4 or max(d, dv) > MAX_D or d % 4 or dv % 4:
        return False
    if robust and not 1 <= iters <= MAX_ITERS:
        return False
    if dtype is not None and dtype not in _DTYPE_CODES:
        return False
    return _smem_bytes(n, d, dv, iters if robust else 0) + _STATIC_SMEM <= _SMEM_LIMIT


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def fused_attention_fwd_plain(q, k, v, scale, robust=False, iters=3, final_row=True):
    """Forward in eager torch: ``(out [K, N, DV]`` in v's dtype, ``vecs
    [K, R, N]`` float32)."""
    out, vecs = attention_fwd_plain(q.float(), k.float(), v.float(), scale, robust, iters,
                                    final_row)
    return out.to(v.dtype), vecs


def fused_attention_bwd_plain(q, k, v, g, vecs, scale, robust=False, iters=3, final_row=True):
    """Backward in eager torch from the residual rows: ``(dq, dk, dv)`` in
    q's, k's and v's dtypes."""
    dq, dk, dv, _ = attention_bwd_plain(q.float(), k.float(), v.float(), g.float(), vecs,
                                        scale, robust, iters, final_row)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# CUDA kernels (csrc/fused_attention_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(name, t, like, dtype=None, shape=None):
    check_operand("fused attention", name, t, like, dtype, shape)


def _check_inputs(q, k, v, robust, iters):
    if not q.is_cuda:
        raise ValueError("fused attention kernel: q must be a CUDA tensor")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused attention kernel: dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    if q.ndim != 3 or v.ndim != 3:
        raise ValueError("fused attention kernel: q, k must be [K, N, D] and v [K, N, DV]")
    kb, n, d = q.shape
    dv = v.shape[2]
    _check("q", q, q)
    _check("k", k, q, shape=q.shape)
    _check("v", v, q, shape=(kb, n, dv))
    if not fused_attention_supported(n, d, dv, iters, robust):
        raise ValueError(f"fused attention kernel: q {tuple(q.shape)}, v {tuple(v.shape)} "
                         f"with robust={robust}, iters={iters} is outside the gate")
    return kb, n, d, dv


def fused_attention_fwd_cuda(q, k, v, scale, robust=False, iters=3, final_row=True):
    """Launch the forward kernel; returns ``(out, vecs)`` like the plain
    version. Raises on anything the kernel does not take."""
    from .build import load_library

    kb, n, d, dv = _check_inputs(q, k, v, robust, iters)
    out = torch.empty_like(v)
    vecs = torch.empty(kb, num_vecs(iters, final_row, robust), n, dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        err = load_library().nrv_fused_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(vecs), _DTYPE_CODES[q.dtype], kb, n, d, dv,
            float(scale), int(robust), int(iters), int(final_row), stream(q.device))
    raise_on(err, "fused attention forward kernel")
    launches.fwd += 1
    return out, vecs


def fused_attention_bwd_cuda(q, k, v, g, vecs, scale, robust=False, iters=3, final_row=True):
    """Launch the backward kernel; returns ``(dq, dk, dv)``. No scratch: each
    item's vectors live in shared memory."""
    from .build import load_library

    kb, n, d, dv = _check_inputs(q, k, v, robust, iters)
    _check("g", g, q, shape=v.shape)
    _check("vecs", vecs, q, torch.float32, (kb, num_vecs(iters, final_row, robust), n))
    dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = load_library().nrv_fused_attention_bwd(
            ptr(q), ptr(k), ptr(v), ptr(g), ptr(vecs), ptr(dq), ptr(dk), ptr(dv_),
            _DTYPE_CODES[q.dtype], kb, n, d, dv, float(scale), int(robust), int(iters),
            int(final_row), stream(q.device))
    raise_on(err, "fused attention backward kernel")
    launches.bwd += 1
    return dq, dk, dv_


def fused_attention_fwd(q, k, v, scale, robust=False, iters=3, final_row=True):
    return by_device(fused_attention_fwd_cuda, fused_attention_fwd_plain, q, k, v, scale, robust,
                     iters, final_row)


def fused_attention_bwd(q, k, v, g, vecs, scale, robust=False, iters=3, final_row=True):
    return by_device(fused_attention_bwd_cuda, fused_attention_bwd_plain, q, k, v, g, vecs,
                     scale, robust, iters, final_row)


class FusedAttention(torch.autograd.Function):
    """``(q, k [..., N, D], v [..., N, DV], scale, robust, iters, final_row)``
    → the attention output ``[..., N, DV]`` in v's dtype, with the
    hand-derived backward from q, k, v and the residual rows (no N×N matrix
    kept)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, robust, iters, final_row):
        lead, n = q.shape[:-2], q.shape[-2]
        q, k = (t.reshape(-1, n, t.shape[-1]).contiguous() for t in (q, k))
        v = v.reshape(-1, n, v.shape[-1]).contiguous()
        out, vecs = fused_attention_fwd(q, k, v, scale, robust, iters, final_row)
        ctx.save_for_backward(q, k, v, vecs)
        ctx.cfg = (scale, robust, iters, final_row)
        ctx.lead = lead
        return out.reshape(*lead, n, v.shape[-1])

    @staticmethod
    def backward(ctx, g):
        q, k, v, vecs = ctx.saved_tensors
        g = g.reshape(v.shape).contiguous()
        dq, dk, dv = fused_attention_bwd(q, k, v, g, vecs, *ctx.cfg)
        n = q.shape[1]
        return (dq.reshape(*ctx.lead, n, q.shape[-1]), dk.reshape(*ctx.lead, n, k.shape[-1]),
                dv.reshape(*ctx.lead, n, v.shape[-1]), None, None, None, None)
