"""Softmax + Sinkhorn over precomputed logits: ``[..., NR, NC]`` logits in,
``sinkhorn_normalize(softmax(logits))`` out (same dtype, math in float32),
differentiable in the logits. Square matrices (self-attention) and
rectangular ones (LeViT's stride-2 subsample, cross-shaped attention) have a
kernel each.

Counterpart of ``noise_robust_vit_tpu/ops/pallas/sinkhorn_softmax.py``
(``sinkhorn_softmax`` and ``sinkhorn_softmax_rect``; their Pallas calls are
``_sinkhorn_softmax_fwd_impl`` / ``_sinkhorn_softmax_bwd_impl`` and
``_rect_fwd_impl`` / ``_rect_bwd_impl``). The math is JAX's
``_norm_fwd_math``, ``_norm_bwd_math``, ``_rect_fwd_math`` and
``_rect_bwd_math``: the unnormalized ``e = exp(s − m)`` with the row
normalizer folded into the scaling vectors, the first row normalization
skipped (rowsum(softmax) ≡ 1 in value and gradient), the clamped reciprocal
and the lean reverse chain (``plain._reverse_chain_inner``).

Residuals, over a leading ``K`` = (image × head) dim, float32, in JAX's
layouts without the TPU's padding: square, one stack ``vecs [K, R, N]``
(the a-rows, the b-rows, then lse, as ``plain.num_vecs``); rectangular,
``va [K, ka + 1, NR]`` (the a-rows, then lse) and ``vb [K, iters, NC]`` (the
b-rows), ``ka = iters − 1 + final_row``.

Three pieces live here, as in ``biased_attention.py``: the plain PyTorch
versions, the ctypes wrappers of ``csrc/sinkhorn_softmax_{fwd,bwd}.cu`` with
a launch count for each form, and the autograd functions
``SinkhornSoftmax`` and ``SinkhornSoftmaxRect``.
"""

from __future__ import annotations

import torch

from ..sinkhorn import clamped_recip
from .build import LaunchCounts, by_device, check_operand, ptr, raise_on, stream
from .plain import _reverse_chain_inner, num_vecs

__all__ = [
    "SinkhornSoftmax",
    "SinkhornSoftmaxRect",
    "launches",
    "launches_rect",
    "sinkhorn_softmax_bwd",
    "sinkhorn_softmax_bwd_cuda",
    "sinkhorn_softmax_bwd_plain",
    "sinkhorn_softmax_fwd",
    "sinkhorn_softmax_fwd_cuda",
    "sinkhorn_softmax_fwd_plain",
    "sinkhorn_softmax_rect_bwd",
    "sinkhorn_softmax_rect_bwd_cuda",
    "sinkhorn_softmax_rect_bwd_plain",
    "sinkhorn_softmax_rect_fwd",
    "sinkhorn_softmax_rect_fwd_cuda",
    "sinkhorn_softmax_rect_fwd_plain",
    "sinkhorn_softmax_rect_supported",
    "sinkhorn_softmax_supported",
]

# Gate. Each item's matrix is held whole, in shared memory where it fits
# (csrc: the matrix, rows padded to 4 floats, plus the backward's vectors,
# within the 227 KB a block may use: square N up to ~220) and in a global
# scratch slot per block above that; JAX's own bound is a padded N of 640.
# The chain's term offsets and partial sums take static shared memory
# (2184 bytes in the backward); STATIC_SMEM keeps room for them.
MAX_N = 640
MAX_ITERS = 8
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_STATIC_SMEM = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# blocks per SM of a grid whose matrices live in global scratch slots
_SCRATCH_BLOCKS_PER_SM = 2

launches = LaunchCounts()       # the square kernels
launches_rect = LaunchCounts()  # the rectangular kernels


def _padded_ld(n: int) -> int:
    return (n + 3) // 4 * 4


def _smem_bytes(nr: int, nc: int, iters: int, matrix_in_smem: bool) -> int:
    """The larger of ``sinkhorn_softmax_{fwd,bwd}_smem_bytes`` in csrc at
    the worst schedule of ``iters`` (a final row norm), plus the static
    shared memory."""
    ka = iters
    matrix = nr * _padded_ld(nc) if matrix_in_smem else 0
    fwd = matrix + 2 * nr + nc
    bwd = matrix + max(nr, nc) + (ka + iters + 5) * nr + (2 * iters + 1) * nc
    return 4 * max(fwd, bwd) + _STATIC_SMEM


def _matrix_in_smem(nr: int, nc: int, iters: int) -> bool:
    return _smem_bytes(nr, nc, iters, True) <= _SMEM_LIMIT


def _supported(nr: int, nc: int, num_iters: int, dtype) -> bool:
    return (2 <= nr <= MAX_N and 2 <= nc <= MAX_N and 1 <= num_iters <= MAX_ITERS
            and (dtype is None or dtype in _DTYPE_CODES)
            and _smem_bytes(nr, nc, num_iters, False) <= _SMEM_LIMIT)


def sinkhorn_softmax_supported(shape, num_iters: int, dtype=None) -> bool:
    """Shape gate of the square kernels (``[..., N, N]``, 2 ≤ N ≤ 640),
    decided before any call; with ``dtype``, also whether the kernels take
    it (float32, bfloat16)."""
    return len(shape) >= 2 and shape[-1] == shape[-2] and _supported(
        shape[-2], shape[-1], num_iters, dtype)


def sinkhorn_softmax_rect_supported(shape, num_iters: int, dtype=None) -> bool:
    """Shape gate of the rectangular kernels: ``[..., NR, NC]`` with NR ≠ NC,
    both from 2 to 640. Square shapes go to the square kernels."""
    return len(shape) >= 2 and shape[-1] != shape[-2] and _supported(
        shape[-2], shape[-1], num_iters, dtype)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _items(x: torch.Tensor) -> torch.Tensor:
    """``[..., NR, NC]`` → float32 ``[K, NR, NC]``."""
    return x.float().reshape(-1, x.shape[-2], x.shape[-1])


def _fwd_math(s, iters, final_row):
    """softmax + Sinkhorn chain on ``s [K, NR, NC]`` float32; returns the
    normalized matrix, the a-rows ``[K, 1, NR]``, the b-rows ``[K, 1, NC]``
    and the lse row ``[K, 1, NR]``."""
    kb, nr, nc = s.shape
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    r = e.sum(dim=-1, keepdim=True)
    lse_row = (m + torch.log(r)).reshape(kb, 1, nr)
    inv_r = 1.0 / r
    a_scale = inv_r
    b = torch.ones(kb, 1, nc, dtype=torch.float32, device=s.device)
    a_rows, b_rows = [], []
    for i in range(iters):
        # i == 0: rowsum(softmax) ≡ 1, so the first row norm is skipped
        if i > 0:
            a = clamped_recip((e * b).sum(-1, keepdim=True) * inv_r)
            a_rows.append(a.reshape(kb, 1, nr))
            a_scale = a * inv_r
        b = clamped_recip((e * a_scale).sum(-2, keepdim=True))
        b_rows.append(b)
    if final_row:
        a = clamped_recip((e * b).sum(-1, keepdim=True) * inv_r)
        a_rows.append(a.reshape(kb, 1, nr))
        a_scale = a * inv_r
    return e * a_scale * b, a_rows, b_rows, lse_row


def _bwd_math(s, g, a_rows, b_rows, lse, iters, final_row, want_out=False):
    """``ds [K, NR, NC]`` from the upstream gradient ``g`` on the normalized
    matrix and the stored rows (``a_rows [K, ka, NR]``, ``b_rows
    [K, iters, NC]``, ``lse [K, NR]``): the direct grads dA = a⊙g⊙bᵀ,
    da = (A⊙g)·b, db = (A⊙g)ᵀ·a, then the reverse chain. With
    ``want_out``, ``(ds, out)``: the normalized matrix a⊙A⊙bᵀ comes too."""
    kb, nr, nc = s.shape
    attn = torch.exp(s - lse[:, :, None])
    ones_r = torch.ones(kb, 1, nr, dtype=torch.float32, device=s.device)
    ones_c = torch.ones(kb, 1, nc, dtype=torch.float32, device=s.device)
    as_r = [ones_r] + [a_rows[:, j][:, None, :] for j in range(a_rows.shape[1])]
    bs_r = [ones_c] + [b_rows[:, j][:, None, :] for j in range(iters)]
    a_fin = as_r[-1].reshape(kb, nr, 1)
    b_fin = bs_r[-1]
    pm = attn * g
    da = (pm * b_fin).sum(-1, keepdim=True)
    db_row = (pm * a_fin).sum(-2, keepdim=True)
    dA = (a_fin * g) * b_fin
    inner = _reverse_chain_inner(attn, dA, da, db_row, a_fin * da, as_r, bs_r, iters,
                                 final_row)
    if want_out:
        return attn * inner, attn * a_fin * b_fin
    return attn * inner


def sinkhorn_softmax_fwd_plain(logits, iters=3, final_row=True):
    """Square forward in eager torch: ``(out [..., N, N]`` in the logits'
    dtype, ``vecs [K, R, N]`` float32)."""
    out, a_rows, b_rows, lse_row = _fwd_math(_items(logits), iters, final_row)
    return (out.reshape(logits.shape).to(logits.dtype),
            torch.cat(a_rows + b_rows + [lse_row], dim=1))


def sinkhorn_softmax_bwd_plain(logits, g, vecs, iters=3, final_row=True):
    """Square backward in eager torch from the stored stack: d logits in the
    logits' dtype."""
    ka = max(iters - 1, 0) + int(final_row)
    ds = _bwd_math(_items(logits), _items(g), vecs[:, :ka], vecs[:, ka:ka + iters],
                   vecs[:, -1], iters, final_row)
    return ds.reshape(logits.shape).to(logits.dtype)


def sinkhorn_softmax_rect_fwd_plain(logits, iters=3, final_row=True):
    """Rectangular forward in eager torch: ``(out, va [K, ka + 1, NR],
    vb [K, iters, NC])``."""
    out, a_rows, b_rows, lse_row = _fwd_math(_items(logits), iters, final_row)
    return (out.reshape(logits.shape).to(logits.dtype),
            torch.cat(a_rows + [lse_row], dim=1), torch.cat(b_rows, dim=1))


def sinkhorn_softmax_rect_bwd_plain(logits, g, va, vb, iters=3, final_row=True):
    """Rectangular backward in eager torch from ``va`` and ``vb``."""
    ds = _bwd_math(_items(logits), _items(g), va[:, :-1], vb, va[:, -1], iters, final_row)
    return ds.reshape(logits.shape).to(logits.dtype)


# --------------------------------------------------------------------------
# CUDA kernels (csrc/sinkhorn_softmax_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(name, t, like, dtype=None, shape=None):
    check_operand("sinkhorn softmax", name, t, like, dtype, shape)


def _check_logits(logits, iters, rect):
    if not logits.is_cuda:
        raise ValueError("sinkhorn softmax kernel: logits must be a CUDA tensor")
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"sinkhorn softmax kernel: dtype {logits.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    _check("logits", logits, logits)
    gate = sinkhorn_softmax_rect_supported if rect else sinkhorn_softmax_supported
    if not gate(logits.shape, iters):
        raise ValueError(f"sinkhorn softmax kernel: shape {tuple(logits.shape)} with "
                         f"iters={iters} is outside the {'rect' if rect else 'square'} gate")
    nr, nc = logits.shape[-2:]
    return logits.numel() // (nr * nc), nr, nc


def _scratch(logits, k, iters):
    """``(scratch, blocks)``: no scratch and one block an item when the
    matrix fits in shared memory, else a slot of NR × padded NC floats for
    each block of a grid that fills the card."""
    nr, nc = logits.shape[-2:]
    if _matrix_in_smem(nr, nc, iters):
        return None, k
    sms = torch.cuda.get_device_properties(logits.device).multi_processor_count
    blocks = min(k, _SCRATCH_BLOCKS_PER_SM * sms)
    return torch.empty(blocks, nr, _padded_ld(nc), dtype=torch.float32,
                       device=logits.device), blocks


def _launch(fn_name, what, logits, tensors, k, dims, iters, final_row):
    from .build import load_library

    scratch, blocks = _scratch(logits, k, iters)
    with torch.cuda.device(logits.device):
        err = getattr(load_library(), fn_name)(
            *(ptr(t) for t in tensors), ptr(scratch), _DTYPE_CODES[logits.dtype], k, *dims,
            int(iters), int(final_row), blocks, stream(logits.device))
    raise_on(err, what)


def sinkhorn_softmax_fwd_cuda(logits, iters=3, final_row=True):
    """Launch the square forward kernel; returns ``(out, vecs)`` like the
    plain version. Raises on anything the kernel does not take."""
    k, n, _ = _check_logits(logits, iters, rect=False)
    out = torch.empty_like(logits)
    vecs = torch.empty(k, num_vecs(iters, final_row, True), n, dtype=torch.float32,
                       device=logits.device)
    _launch("nrv_sinkhorn_softmax_fwd", "sinkhorn softmax forward kernel", logits,
            (logits, out, vecs), k, (n,), iters, final_row)
    launches.fwd += 1
    return out, vecs


def sinkhorn_softmax_bwd_cuda(logits, g, vecs, iters=3, final_row=True):
    """Launch the square backward kernel; returns d logits."""
    k, n, _ = _check_logits(logits, iters, rect=False)
    _check("g", g, logits, shape=logits.shape)
    _check("vecs", vecs, logits, torch.float32, (k, num_vecs(iters, final_row, True), n))
    ds = torch.empty_like(logits)
    _launch("nrv_sinkhorn_softmax_bwd", "sinkhorn softmax backward kernel", logits,
            (logits, g, vecs, ds), k, (n,), iters, final_row)
    launches.bwd += 1
    return ds


def _rect_rows(k, nr, nc, iters, final_row):
    ka = max(iters - 1, 0) + int(final_row)
    return (k, ka + 1, nr), (k, iters, nc)


def sinkhorn_softmax_rect_fwd_cuda(logits, iters=3, final_row=True):
    """Launch the rectangular forward kernel; returns ``(out, va, vb)``."""
    k, nr, nc = _check_logits(logits, iters, rect=True)
    shape_a, shape_b = _rect_rows(k, nr, nc, iters, final_row)
    out = torch.empty_like(logits)
    va = torch.empty(shape_a, dtype=torch.float32, device=logits.device)
    vb = torch.empty(shape_b, dtype=torch.float32, device=logits.device)
    _launch("nrv_sinkhorn_softmax_rect_fwd", "sinkhorn softmax rect forward kernel", logits,
            (logits, out, va, vb), k, (nr, nc), iters, final_row)
    launches_rect.fwd += 1
    return out, va, vb


def sinkhorn_softmax_rect_bwd_cuda(logits, g, va, vb, iters=3, final_row=True):
    """Launch the rectangular backward kernel; returns d logits."""
    k, nr, nc = _check_logits(logits, iters, rect=True)
    _check("g", g, logits, shape=logits.shape)
    for name, t, shape in zip(("va", "vb"), (va, vb), _rect_rows(k, nr, nc, iters, final_row)):
        _check(name, t, logits, torch.float32, shape)
    ds = torch.empty_like(logits)
    _launch("nrv_sinkhorn_softmax_rect_bwd", "sinkhorn softmax rect backward kernel",
            logits, (logits, g, va, vb, ds), k, (nr, nc), iters, final_row)
    launches_rect.bwd += 1
    return ds


def sinkhorn_softmax_fwd(logits, iters=3, final_row=True):
    return by_device(sinkhorn_softmax_fwd_cuda, sinkhorn_softmax_fwd_plain, logits, iters,
                      final_row)


def sinkhorn_softmax_bwd(logits, g, vecs, iters=3, final_row=True):
    return by_device(sinkhorn_softmax_bwd_cuda, sinkhorn_softmax_bwd_plain, logits, g, vecs,
                      iters, final_row)


def sinkhorn_softmax_rect_fwd(logits, iters=3, final_row=True):
    return by_device(sinkhorn_softmax_rect_fwd_cuda, sinkhorn_softmax_rect_fwd_plain, logits,
                      iters, final_row)


def sinkhorn_softmax_rect_bwd(logits, g, va, vb, iters=3, final_row=True):
    return by_device(sinkhorn_softmax_rect_bwd_cuda, sinkhorn_softmax_rect_bwd_plain, logits,
                      g, va, vb, iters, final_row)


class SinkhornSoftmax(torch.autograd.Function):
    """Square ``[..., N, N]`` logits → weights, with the hand-derived
    backward from the stored stack."""

    @staticmethod
    def forward(ctx, logits, iters, final_row):
        logits = logits.contiguous()
        out, vecs = sinkhorn_softmax_fwd(logits, iters, final_row)
        ctx.save_for_backward(logits, vecs)
        ctx.cfg = (iters, final_row)
        return out

    @staticmethod
    def backward(ctx, g):
        logits, vecs = ctx.saved_tensors
        return sinkhorn_softmax_bwd(logits, g.contiguous(), vecs, *ctx.cfg), None, None


class SinkhornSoftmaxRect(torch.autograd.Function):
    """Rectangular ``[..., NR, NC]`` logits → weights."""

    @staticmethod
    def forward(ctx, logits, iters, final_row):
        logits = logits.contiguous()
        out, va, vb = sinkhorn_softmax_rect_fwd(logits, iters, final_row)
        ctx.save_for_backward(logits, va, vb)
        ctx.cfg = (iters, final_row)
        return out

    @staticmethod
    def backward(ctx, g):
        logits, va, vb = ctx.saved_tensors
        return (sinkhorn_softmax_rect_bwd(logits, g.contiguous(), va, vb, *ctx.cfg),
                None, None)
