"""Talking-heads Sinkhorn: CaiT's sandwich of a pre-normalization head mix,
softmax + Sinkhorn, and a post-normalization head mix, fused:

    y = postmix(sinkhorn(softmax(premix(dots)))),
    premix(x)_g = Σ_h pre[h, g]·x_h,  postmix(w)_q = Σ_g post[g, q]·w_g,

on square ``dots [B, H, N, N]`` (float32 or bfloat16, math in float32) with
``pre, post [H, H]``, differentiable in all three (ref cait.py:110-119
around ref utils.py:1025-1037).

Counterpart of ``noise_robust_vit_tpu/ops/pallas/talking_heads.py``
(``talking_heads_sinkhorn``; its Pallas calls are ``_th_fwd_impl`` and
``_th_bwd_impl``). The chain math is the logits-interface kernel's
(``sinkhorn_softmax._fwd_math`` / ``_bwd_math``), as JAX's kernel shares
``_norm_fwd_math`` / ``_norm_bwd_math``; the mixes are einsums here and
plane sums in the kernels.

Residuals: the dots, and one float32 stack ``vecs [B·H, R, N]`` per
(image, mixed head) item, the square logits-interface layout (the a-rows,
the b-rows, then lse). The backward recomputes ``m = premix(s)``.

Two branches of kernels compute the function, chosen by shape before the
call (``talking_heads_branch``): the cluster kernels
(``csrc/talking_heads_cluster_{fwd,bwd}.cu``: one thread-block cluster an
image, one block a head, the head mixes traded between the blocks through
distributed shared memory; H ≤ 8, N ≤ 200) and the plane kernels
(``csrc/talking_heads_{fwd,bwd}.cu``: one block an (image, mixed head)
item; everything else the gate takes, 16 heads, N up to 228). Both keep the
same residuals, so either backward takes either forward's.

Three pieces live here, as in ``sinkhorn_softmax.py``: the plain PyTorch
versions, the ctypes wrappers of both branches with a launch count
(``launches``, and by branch ``launches_cluster`` / ``launches_plane``),
and the autograd function ``TalkingHeadsSinkhorn``.
"""

from __future__ import annotations

import torch

from .build import LaunchCounts, by_device, check_operand, ptr, raise_on, stream
from .plain import num_vecs
from .sinkhorn_softmax import _bwd_math, _fwd_math

__all__ = [
    "TalkingHeadsSinkhorn",
    "launches",
    "launches_cluster",
    "launches_plane",
    "talking_heads_branch",
    "talking_heads_bwd",
    "talking_heads_bwd_cuda",
    "talking_heads_bwd_plain",
    "talking_heads_fwd",
    "talking_heads_fwd_cuda",
    "talking_heads_fwd_plain",
    "talking_heads_supported",
]

# Gate, the plane kernels' budget (the cluster kernels take a subset). Each
# (image, mixed head) item's N×N matrix lives in one block's shared memory
# (csrc: talking_heads_{fwd,bwd}_smem_bytes, the matrix with
# rows padded to 4 floats plus the forward's three vectors or the
# backward's, bwd_vector_floats), within the 227 KB a block may use: N up
# to 228 at 3 iterations. Shapes above take the unfused path, whose square
# logits-interface kernels hold larger matrices in global scratch. The
# kernels mix at most 16 heads (kMaxHeads). The static shared memory (the
# chain's term offsets and partial sums, the mixes' columns, the per-warp
# head sums: ~2.8 KB) is kept in STATIC_SMEM.
MAX_HEADS = 16
MAX_ITERS = 8
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_STATIC_SMEM = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounts()
launches_cluster = LaunchCounts()
launches_plane = LaunchCounts()

# The cluster branch (csrc/talking_heads_cluster.cuh: kMaxH, kMaxN, mirrored
# here: change one, change the other). A cluster holds one block a head, at
# most 8 (the portable cluster size); a block holds one N×N float32 plane
# beside the backward's vectors at 8 iterations, which bounds N.
CLUSTER_MAX_HEADS = 8
CLUSTER_MAX_N = 200
BRANCHES = ("cluster", "plane")


def _smem_bytes(n: int, iters: int) -> int:
    """The larger of the forward's and the backward's shared memory at the
    worst schedule of ``iters`` (a final row norm), plus the static."""
    matrix = n * ((n + 3) // 4 * 4)
    fwd = matrix + 3 * n
    ka = iters
    bwd = matrix + n + (ka + iters + 5) * n + (2 * iters + 1) * n
    return 4 * max(fwd, bwd) + _STATIC_SMEM


def talking_heads_supported(shape, num_iters: int, dtype=None) -> bool:
    """Shape gate, decided before any call: 4-D square ``[B, H, N, N]``,
    N ≥ 2, 1 ≤ H ≤ 16, 1 ≤ iterations ≤ 8, the matrix in shared memory;
    with ``dtype``, also whether the kernels take it (float32, bfloat16)."""
    if len(shape) != 4 or shape[-1] != shape[-2]:
        return False
    b, h, n, _ = shape
    return (b >= 1 and 1 <= h <= MAX_HEADS and n >= 2 and 1 <= num_iters <= MAX_ITERS
            and (dtype is None or dtype in _DTYPE_CODES)
            and _smem_bytes(n, num_iters) <= _SMEM_LIMIT)


def talking_heads_branch(shape, num_iters: int, dtype) -> str:
    """The kernels a CUDA call of this shape and dtype goes to: "cluster"
    (float32 or bfloat16, 1 ≤ H ≤ 8, 2 ≤ N ≤ 200, 1-8 iterations) or "plane"
    (every other shape the gate takes)."""
    if not talking_heads_supported(shape, num_iters, dtype):
        return "plane"
    h, n = shape[1], shape[2]
    return "cluster" if h <= CLUSTER_MAX_HEADS and n <= CLUSTER_MAX_N else "plane"


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _premix(x, pre):
    """``Σ_h pre[h, g]·x_h``: ``[B, H, N, N]`` → ``[B, G, N, N]``."""
    return torch.einsum("bhij,hg->bgij", x, pre)


def talking_heads_fwd_plain(dots, pre, post, iters=3, final_row=True):
    """Forward in eager torch: ``(out [B, H, N, N]`` in the dots' dtype,
    ``vecs [B·H, R, N]`` float32)."""
    b, h, n, _ = dots.shape
    m = _premix(dots.float(), pre.float())
    w, a_rows, b_rows, lse_row = _fwd_math(m.reshape(b * h, n, n), iters, final_row)
    y = _premix(w.reshape(b, h, n, n), post.float())
    return y.to(dots.dtype), torch.cat(a_rows + b_rows + [lse_row], dim=1)


def _strip_rows(n: int, strips: int):
    """Rows [k·n // strips, (k + 1)·n // strips) of strip k."""
    return [(k * n // strips, (k + 1) * n // strips) for k in range(strips)]


def _param_grad(eq: str, x, y, strips):
    """``einsum(eq)`` over the images and entries to ``[H, H]``: at once
    (``strips=None``), or as per-(image, strip) partials over each strip's
    rows, summed over the images and then over the strips (the cluster
    kernels' order)."""
    if strips is None:
        return torch.einsum(eq.replace("->b", "->"), x, y)
    parts = [torch.einsum(eq, x[:, :, r0:r1], y[:, :, r0:r1])
             for r0, r1 in _strip_rows(x.shape[2], strips)]
    return torch.stack(parts).sum(1).sum(0)


def talking_heads_bwd_plain(dots, g, vecs, pre, post, iters=3, final_row=True, strips=None):
    """Backward in eager torch from the stored stack: ``(d dots`` in the
    dots' dtype, ``d pre, d post`` float32 ``[H, H])``. Recomputes
    ``m = premix(s)``, forms ``gw = postmixᵀ(gy)``, runs the logits-interface
    backward to ``dm`` (and ``w``), then ``ds = premixᵀ(dm)``,
    ``dpre = Σ s_h·dm_g`` and ``dpost = Σ w_g·gy_q``. With ``strips``, d pre
    and d post are summed as the cluster kernels sum them (strips of rows,
    the kernels' count is H)."""
    b, h, n, _ = dots.shape
    s, gy = dots.float(), g.float()
    pre, post = pre.float(), post.float()
    m = _premix(s, pre)
    gw = torch.einsum("bqij,gq->bgij", gy, post)
    ka = max(iters - 1, 0) + int(final_row)
    dm, w = _bwd_math(m.reshape(b * h, n, n), gw.reshape(b * h, n, n), vecs[:, :ka],
                      vecs[:, ka:ka + iters], vecs[:, -1], iters, final_row, want_out=True)
    dm, w = dm.reshape(b, h, n, n), w.reshape(b, h, n, n)
    ds = torch.einsum("bgij,hg->bhij", dm, pre)
    dpre = _param_grad("bhij,bgij->bhg", s, dm, strips)
    dpost = _param_grad("bgij,bqij->bgq", w, gy, strips)
    return ds.to(dots.dtype), dpre, dpost


# --------------------------------------------------------------------------
# CUDA kernels (csrc/talking_heads_cluster_{fwd,bwd}.cu, csrc/talking_heads_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(name, t, like, dtype=None, shape=None):
    check_operand("talking heads", name, t, like, dtype, shape)


def _check_inputs(dots, pre, post, iters, branch):
    if dots.dtype not in _DTYPE_CODES:
        raise TypeError(f"talking heads kernel: dtype {dots.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    _check("dots", dots, dots)
    if not talking_heads_supported(dots.shape, iters):
        raise ValueError(f"talking heads kernel: shape {tuple(dots.shape)} with "
                         f"iters={iters} is outside the gate")
    h = dots.shape[1]
    _check("pre", pre, dots, torch.float32, (h, h))
    _check("post", post, dots, torch.float32, (h, h))
    rule = talking_heads_branch(dots.shape, iters, dots.dtype)
    chosen = branch or rule
    if chosen not in BRANCHES:
        raise ValueError(f"talking heads kernel: no branch {chosen!r}")
    if chosen == "cluster" and rule != "cluster":
        raise ValueError(f"talking heads kernel: the cluster branch does not take "
                         f"{tuple(dots.shape)} {dots.dtype}")
    if not dots.is_cuda:
        raise ValueError("talking heads kernel: dots must be a CUDA tensor")
    return (*dots.shape[:3], chosen)


def _count(chosen, direction):
    for c in (launches, launches_cluster if chosen == "cluster" else launches_plane):
        setattr(c, direction, getattr(c, direction) + 1)


def talking_heads_fwd_cuda(dots, pre, post, iters=3, final_row=True, branch=None):
    """Launch the forward kernels of the branch ``talking_heads_branch``
    picks (or ``branch``); returns ``(out, vecs)`` like the plain version.
    ``pre`` and ``post`` float32. Raises on anything the kernels do not
    take."""
    from .build import load_library

    b, h, n, chosen = _check_inputs(dots, pre, post, iters, branch)
    out = torch.empty_like(dots)
    vecs = torch.empty(b * h, num_vecs(iters, final_row, True), n, dtype=torch.float32,
                       device=dots.device)
    cfg = (_DTYPE_CODES[dots.dtype], b, h, n, int(iters), int(final_row), stream(dots.device))
    with torch.cuda.device(dots.device):
        if chosen == "cluster":
            err = load_library().nrv_talking_heads_cluster_fwd(
                ptr(dots), ptr(pre), ptr(post), ptr(out), ptr(vecs), *cfg)
        else:
            w = torch.empty(dots.shape, dtype=torch.float32, device=dots.device)
            err = load_library().nrv_talking_heads_fwd(
                ptr(dots), ptr(pre), ptr(post), ptr(out), ptr(vecs), ptr(w), *cfg)
    raise_on(err, f"talking heads forward kernel ({chosen})")
    _count(chosen, "fwd")
    return out, vecs


def talking_heads_bwd_cuda(dots, g, vecs, pre, post, iters=3, final_row=True, branch=None):
    """Launch the backward kernels of the branch, as the forward (either
    forward's ``vecs`` will do); returns ``(d dots, d pre, d post)``."""
    from .build import load_library

    b, h, n, chosen = _check_inputs(dots, pre, post, iters, branch)
    _check("g", g, dots, shape=dots.shape)
    _check("vecs", vecs, dots, torch.float32, (b * h, num_vecs(iters, final_row, True), n))
    ds = torch.empty_like(dots)
    dpre = torch.empty(h, h, dtype=torch.float32, device=dots.device)
    dpost = torch.empty_like(dpre)
    cfg = (_DTYPE_CODES[dots.dtype], b, h, n, int(iters), int(final_row), stream(dots.device))
    with torch.cuda.device(dots.device):
        if chosen == "cluster":
            part = torch.empty(2, b, h, h * h, dtype=torch.float32, device=dots.device)
            err = load_library().nrv_talking_heads_cluster_bwd(
                ptr(dots), ptr(g), ptr(vecs), ptr(pre), ptr(post), ptr(ds), ptr(dpre),
                ptr(dpost), ptr(part), *cfg)
        else:
            dm = torch.empty(dots.shape, dtype=torch.float32, device=dots.device)
            part = torch.empty(2, b * h, h, dtype=torch.float32, device=dots.device)
            err = load_library().nrv_talking_heads_bwd(
                ptr(dots), ptr(g), ptr(vecs), ptr(pre), ptr(post), ptr(ds), ptr(dpre),
                ptr(dpost), ptr(dm), ptr(part), *cfg)
    raise_on(err, f"talking heads backward kernel ({chosen})")
    _count(chosen, "bwd")
    return ds, dpre, dpost


def talking_heads_fwd(dots, pre, post, iters=3, final_row=True):
    return by_device(talking_heads_fwd_cuda, talking_heads_fwd_plain, dots, pre, post, iters,
                     final_row)


def talking_heads_bwd(dots, g, vecs, pre, post, iters=3, final_row=True):
    return by_device(talking_heads_bwd_cuda, talking_heads_bwd_plain, dots, g, vecs, pre, post,
                     iters, final_row)


class TalkingHeadsSinkhorn(torch.autograd.Function):
    """``(dots [B, H, N, N], mix_pre, mix_post [H, H], iters, final_row)`` →
    ``postmix(sinkhorn(softmax(premix(dots))))`` in the dots' dtype, with
    the hand-derived backward for the dots and both mixes."""

    @staticmethod
    def forward(ctx, dots, mix_pre, mix_post, iters, final_row):
        dots = dots.contiguous()
        pre, post = mix_pre.float().contiguous(), mix_post.float().contiguous()
        out, vecs = talking_heads_fwd(dots, pre, post, iters, final_row)
        ctx.save_for_backward(dots, vecs, pre, post)
        ctx.cfg = (iters, final_row)
        ctx.mix_dtypes = (mix_pre.dtype, mix_post.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        dots, vecs, pre, post = ctx.saved_tensors
        ds, dpre, dpost = talking_heads_bwd(dots, g.contiguous(), vecs, pre, post, *ctx.cfg)
        return ds, dpre.to(ctx.mix_dtypes[0]), dpost.to(ctx.mix_dtypes[1]), None, None
