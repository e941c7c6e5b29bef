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
wrappers of the kernels with a launch count (``launches``, and by branch
``launches_resident`` / ``launches_recompute``), and the autograd function
``FusedAttention``.

Two branches of kernels compute the function, chosen by shape and dtype
before the call (``fused_branch``): the resident kernels
(``csrc/fused_resident_{fwd,bwd}.cu``: bf16, D = DV = 8, N ≤ 256; each
item's N×N matrix formed once a direction and held in registers in float32,
every product on the tensor cores) and the recompute kernels
(``csrc/fused_attention_{fwd,bwd}.cu``: every other shape the gate takes,
float32 included; no matrix, each pass forms its entries anew). A CUDA
tensor goes to one of them or raises.
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
    "fused_branch",
    "launches",
    "launches_recompute",
    "launches_resident",
    "num_vecs",
]

# Gate: the recompute kernels', which take every shape the resident ones
# do. They keep no N×N matrix: each item's q, k, v (and g) rows and its
# vectors sit in shared memory as float32, and every pass forms the
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
launches_resident = LaunchCounts()
launches_recompute = LaunchCounts()

# The resident branch (csrc/fused_resident.cuh, mirrored here: change one,
# change the other). A block is 8 warps of 16 rows; a warp holds its rows at
# _res_cols(N) columns; at N > 128 a cluster of two blocks holds an item,
# below it a block holds 8 // strips items.
_RES_D = 8
_RES_MAX_N = 256
_RES_WARPS = 8
_RES_ROWS = 16 * _RES_WARPS
_RES_STATIC = 1024
_RES_RANK_LD = 40  # kRankLd: the rank-1 column factors' row, floats


def _res_cols(n: int) -> int:
    """``res_cols``: N rounded up to a power of two, at least 16."""
    c = 16
    while c < n:
        c *= 2
    return c


def _res_items(n: int) -> int:
    """``res_items``: items a block holds."""
    return 1 if n > _RES_ROWS else _RES_WARPS // ((n + 15) // 16)


def _resident_fwd_smem(n: int) -> int:
    """``fwd_smem_bytes`` in csrc: dynamic shared memory of the forward."""
    ic = _res_items(n) * _res_cols(n)
    return 2 * 3 * ic * _RES_D * 2 + 4 * (_RES_WARPS * _res_cols(n) + 5 * ic)


def _resident_bwd_smem(n: int, it: int) -> int:
    """``bwd_smem_bytes`` (with ``bwd_part_floats``) in csrc: dynamic shared
    memory of the backward; ``it`` is the iterations when robust, else 0."""
    ic = _res_items(n) * _res_cols(n)
    part = max(_RES_WARPS * _res_cols(n) * _RES_D, ic * _RES_RANK_LD if it else 0)
    return 2 * 4 * ic * _RES_D * 2 + 4 * (part + 5 * ic * _RES_D + 4 * ic
                                          + 2 * ic * ((1 + 2 * it) + (2 + 2 * it)))


def _resident_fits(n: int, d: int, dv: int, robust: bool = True, iters: int = 3) -> bool:
    """``resident_fits`` in csrc: the shapes the resident kernels take."""
    if d != _RES_D or dv != _RES_D or not 1 <= n <= _RES_MAX_N:
        return False
    if robust and not 1 <= iters <= MAX_ITERS:
        return False
    it = iters if robust else 0
    return (_resident_fwd_smem(n) + _RES_STATIC <= _SMEM_LIMIT
            and _resident_bwd_smem(n, it) + _RES_STATIC <= _SMEM_LIMIT)


def fused_branch(n: int, d: int, dv: int, dtype: torch.dtype, robust: bool = True,
                 iters: int = 3) -> str:
    """The kernels a CUDA call of this shape and dtype goes to: "resident"
    (bf16 where ``_resident_fits``) or "recompute" (every other shape the
    gate takes)."""
    return ("resident" if dtype == torch.bfloat16 and _resident_fits(n, d, dv, robust, iters)
            else "recompute")


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
# CUDA kernels (csrc/fused_resident_{fwd,bwd}.cu, csrc/fused_attention_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(name, t, like, dtype=None, shape=None):
    check_operand("fused attention", name, t, like, dtype, shape)


def _check_inputs(q, k, v, robust, iters, branch):
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
    rule = fused_branch(n, d, dv, q.dtype, robust, iters)
    chosen = branch or rule
    if chosen not in ("resident", "recompute"):
        raise ValueError(f"fused attention kernel: no branch {chosen!r}")
    if chosen == "resident" and rule != "resident":
        raise ValueError(f"fused attention kernel: the resident branch does not take "
                         f"N={n} D={d} DV={dv} {q.dtype}")
    return kb, n, d, dv, chosen


def _count(chosen, direction):
    for c in (launches, launches_resident if chosen == "resident" else launches_recompute):
        setattr(c, direction, getattr(c, direction) + 1)


def fused_attention_fwd_cuda(q, k, v, scale, robust=False, iters=3, final_row=True,
                             branch=None):
    """Launch the forward kernel of the branch ``fused_branch`` picks (or
    ``branch``); returns ``(out, vecs)`` like the plain version. Raises on
    anything the kernel does not take."""
    from .build import load_library

    kb, n, d, dv, chosen = _check_inputs(q, k, v, robust, iters, branch)
    out = torch.empty_like(v)
    vecs = torch.empty(kb, num_vecs(iters, final_row, robust), n, dtype=torch.float32,
                       device=q.device)
    cfg = (float(scale), int(robust), int(iters), int(final_row), stream(q.device))
    with torch.cuda.device(q.device):
        if chosen == "resident":
            err = load_library().nrv_fused_resident_fwd(
                ptr(q), ptr(k), ptr(v), ptr(out), ptr(vecs), kb, n, d, dv, *cfg)
        else:
            err = load_library().nrv_fused_attention_fwd(
                ptr(q), ptr(k), ptr(v), ptr(out), ptr(vecs), _DTYPE_CODES[q.dtype], kb, n, d,
                dv, *cfg)
    raise_on(err, f"fused attention forward kernel ({chosen})")
    _count(chosen, "fwd")
    return out, vecs


def fused_attention_bwd_cuda(q, k, v, g, vecs, scale, robust=False, iters=3, final_row=True,
                             branch=None):
    """Launch the backward kernel of the branch, as the forward; returns
    ``(dq, dk, dv)``. No scratch: each item's vectors live in shared
    memory."""
    from .build import load_library

    kb, n, d, dv, chosen = _check_inputs(q, k, v, robust, iters, branch)
    _check("g", g, q, shape=v.shape)
    _check("vecs", vecs, q, torch.float32, (kb, num_vecs(iters, final_row, robust), n))
    dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (ptr(q), ptr(k), ptr(v), ptr(g), ptr(vecs), ptr(dq), ptr(dk), ptr(dv_))
    cfg = (float(scale), int(robust), int(iters), int(final_row), stream(q.device))
    with torch.cuda.device(q.device):
        if chosen == "resident":
            err = load_library().nrv_fused_resident_bwd(*ptrs, kb, n, d, dv, *cfg)
        else:
            err = load_library().nrv_fused_attention_bwd(*ptrs, _DTYPE_CODES[q.dtype], kb, n, d,
                                                         dv, *cfg)
    raise_on(err, f"fused attention backward kernel ({chosen})")
    _count(chosen, "bwd")
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
