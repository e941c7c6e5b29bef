"""Packed-qkv fused attention: softmax, or softmax + Sinkhorn in
scaling-vector form, read in place from the ``[B, N, 3·H·D]`` output of
``to_qkv`` and written as the ``[B, N, H·D]`` input of ``to_out``.

Counterpart of ``noise_robust_vit_tpu/ops/pallas/block_attention.py``
(``packed_attention``; its Pallas calls are ``_packed_fwd_impl`` and
``_packed_bwd_impl``).

Three pieces live here:

* the plain PyTorch versions ``packed_attention_fwd_plain`` and
  ``packed_attention_bwd_plain``: the kernels' algorithm (``plain.py``) on
  the heads split out of the packed layout. CPU tensors take them, and the
  card's checks compare the kernels against them;
* the ctypes wrappers ``packed_attention_fwd_cuda`` / ``_bwd_cuda``, which
  check what the kernels take, allocate outputs and scratch, launch on the
  current stream and count their launches in ``launches`` (and by branch
  in ``launches_resident`` / ``launches_scratch``);
* ``PackedAttention``, the ``torch.autograd.Function`` tying the two
  directions together.

The residual stack is ``[B, H, R, N]`` float32, rows as in ``plain.py``.

Two branches of kernels compute the function, chosen by shape and dtype
before the call (``packed_branch``): the resident kernels
(``csrc/packed_resident_{fwd,bwd}.cu``: bf16, D = 64, N up to
``RESIDENT_MAX_N``; the item's N×N matrix on chip, in shared memory in the
forward and in registers in the backward, TMA operand tiles, every product
on wgmma), and the scratch kernels
(``csrc/packed_attention_{fwd,bwd}.cu``: every other shape the gate takes,
float32 included; the matrices in a device-memory slot). A CUDA tensor goes
to one of them or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LaunchCounts, by_device, ptr, raise_on
from .plain import attention_bwd_plain, attention_fwd_plain, num_vecs

__all__ = [
    "PackedAttention",
    "RESIDENT_MAX_N",
    "launches",
    "launches_resident",
    "launches_scratch",
    "num_vecs",
    "packed_branch",
    "packed_attention_bwd",
    "packed_attention_bwd_cuda",
    "packed_attention_bwd_plain",
    "packed_attention_fwd",
    "packed_attention_fwd_cuda",
    "packed_attention_fwd_plain",
    "packed_attention_supported",
]

# Gate. Head widths the kernels are checked at; the GEMM tiles take any
# width, so this is a list of verified cases, not a hardware limit.
SUPPORTED_DIM_HEADS = (32, 64, 128)
# On the scratch branch the N×N matrices live in a global-memory scratch and
# what bounds N is the shared-memory vector workspace of the backward (see
# csrc/sinkhorn_chain.cuh).
MAX_N = 1024
MAX_ITERS = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# blocks per SM of the scratch kernels, as their __launch_bounds__ allow;
# each owns one scratch slot of N×N floats (on an H100 at N=196: 2 × 132 ×
# 154 KB, 41 MB; 1, 2, 3, 4, 8 and 24 slots per SM were timed, and 2 or
# more tie)
_BLOCKS_PER_SM = 2


# The resident branch (csrc/packed_resident.cuh, mirrored here: change one,
# change the other). Operand buffers of 208 rows × 64 bf16 columns (128
# bytes a row, the 128-byte swizzle), q row tiles of 64 rows; the forward's
# matrix with row stride _resident_ld and its vectors; the backward's ring
# of operand slots, staging regions and vectors; all within what a block
# may use on sm_90.
_RES_D = 64
_RES_NCOLS = 200  # the wgmma n of the S and G·Vᵀ tiles: N's cap before the budget
_RES_OP_BYTES = 208 * 128
_RES_TILE_BYTES = 64 * 128
_RES_ALIGN = 1024
_RES_STATIC = 256
_RES_WARPS = 8
_RES_BLOCK_ROWS = 128  # rows of the matrix a backward block holds
_RES_SLOT_BYTES = _RES_OP_BYTES + _RES_BLOCK_ROWS * 128  # a ring slot: k | q or v | dout
_RES_RING_SLOTS = 2
_RES_STAGE_BYTES = _RES_NCOLS * 128  # a staging region: one plane of a warpgroup's rows
_SMEM_LIMIT = 232448

launches = LaunchCounts()
launches_resident = LaunchCounts()
launches_scratch = LaunchCounts()


def _resident_ld(n: int) -> int:
    """Row stride of the resident matrix (``resident_ld`` in csrc): N
    rounded up to 8, then to ≡ 8 (mod 32)."""
    ld = (n + 7) // 8 * 8
    while ld % 32 != 8:
        ld += 8
    return ld


def _resident_fwd_smem(n: int) -> int:
    """``fwd_smem_bytes`` in csrc: dynamic shared memory of the forward."""
    return (_RES_ALIGN + 2 * _RES_OP_BYTES + 2 * _RES_TILE_BYTES
            + 4 * (n * _resident_ld(n) + 3 * n))


def _resident_bwd_smem() -> int:
    """``bwd_smem_bytes`` in csrc: dynamic shared memory of the backward,
    whatever N and the schedule (the matrix is in registers)."""
    return (_RES_ALIGN + _RES_RING_SLOTS * _RES_SLOT_BYTES + 4 * _RES_STAGE_BYTES
            + 4 * ((2 * MAX_ITERS + 1 + _RES_WARPS + 4) * _RES_NCOLS
                   + 2 * MAX_ITERS * _RES_BLOCK_ROWS))


def _resident_fits(n: int, dim_head: int) -> bool:
    """``resident_fits`` in csrc: the shapes the resident kernels take."""
    return (dim_head == _RES_D and 1 <= n <= _RES_NCOLS
            and _resident_fwd_smem(n) + _RES_STATIC <= _SMEM_LIMIT
            and _resident_bwd_smem() + _RES_STATIC <= _SMEM_LIMIT)


RESIDENT_MAX_N = max(n for n in range(1, _RES_NCOLS + 1) if _resident_fits(n, _RES_D))


def packed_branch(n: int, dim_head: int, dtype: torch.dtype) -> str:
    """The kernels a CUDA call of this shape and dtype goes to: "resident"
    (bf16 where ``_resident_fits``) or "scratch" (every other shape the gate
    takes)."""
    return "resident" if dtype == torch.bfloat16 and _resident_fits(n, dim_head) else "scratch"


def packed_attention_supported(n: int, dim_head: int, heads: int, batch: int,
                               sinkhorn_iters: int = 3) -> bool:
    """Shape gate of the packed kernels, decided before any call."""
    return (dim_head in SUPPORTED_DIM_HEADS and 1 <= n <= MAX_N
            and heads >= 1 and batch >= 1 and 1 <= sinkhorn_iters <= MAX_ITERS)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, parts: int, heads: int, dim_head: int):
    """``[B, N, parts·H·D]`` → ``parts`` float32 tensors ``[B·H, N, D]``."""
    b, n, _ = x.shape
    x = x.float().reshape(b, n, parts, heads, dim_head).permute(2, 0, 3, 1, 4)
    return [t.reshape(b * heads, n, dim_head) for t in x]


def _merge_heads(xs, b: int, heads: int, dtype: torch.dtype) -> torch.Tensor:
    """``[B·H, N, D]`` tensors → ``[B, N, len(xs)·H·D]`` in ``dtype``."""
    kb, n, d = xs[0].shape
    x = torch.stack([t.reshape(b, heads, n, d) for t in xs])  # [P,B,H,N,D]
    return x.permute(1, 3, 0, 2, 4).reshape(b, n, len(xs) * heads * d).to(dtype)


def packed_attention_fwd_plain(qkv, heads, dim_head, scale, robust=False,
                               iters=3, final_row=True):
    """Forward in eager torch; returns ``(out [B,N,H·D], vecs [B,H,R,N])``."""
    b, n, _ = qkv.shape
    q, k, v = _split_heads(qkv, 3, heads, dim_head)
    out, vecs = attention_fwd_plain(q, k, v, scale, robust, iters, final_row)
    return (_merge_heads([out], b, heads, qkv.dtype),
            vecs.reshape(b, heads, -1, n))


def packed_attention_bwd_plain(qkv, dout, vecs, heads, dim_head, scale,
                               robust=False, iters=3, final_row=True):
    """Backward in eager torch from the stored residuals; returns the packed
    gradient ``dqkv [B, N, 3·H·D]``."""
    b, n, _ = qkv.shape
    q, k, v = _split_heads(qkv, 3, heads, dim_head)
    (g,) = _split_heads(dout, 1, heads, dim_head)
    dq, dk, dv, _ = attention_bwd_plain(q, k, v, g, vecs.reshape(b * heads, -1, n),
                                        scale, robust, iters, final_row)
    return _merge_heads([dq, dk, dv], b, heads, qkv.dtype)


# --------------------------------------------------------------------------
# CUDA kernels (csrc/packed_attention_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check_qkv(qkv, heads, dim_head, iters):
    if not qkv.is_cuda:
        raise ValueError("packed attention kernel: qkv must be a CUDA tensor")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"packed attention kernel: dtype {qkv.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * dim_head:
        raise ValueError(f"packed attention kernel: qkv shape {tuple(qkv.shape)} "
                         f"is not [B, N, 3·{heads}·{dim_head}]")
    if not qkv.is_contiguous():
        raise ValueError("packed attention kernel: qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("packed attention kernel: qkv must be 16-byte aligned")
    b, n, _ = qkv.shape
    if not packed_attention_supported(n, dim_head, heads, b, iters):
        raise ValueError(f"packed attention kernel: shape B={b} N={n} H={heads} "
                         f"D={dim_head} iters={iters} is outside the gate")


def _padded_ld(n: int) -> int:
    """Row stride of the kernels' N×N scratch (``padded_ld`` in csrc)."""
    return (n + 3) // 4 * 4


def _n_slots(device: torch.device, kb: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(kb, sms * _BLOCKS_PER_SM))


def _branch_of(qkv, heads, dim_head, iters, branch):
    """Check ``qkv`` against the gate and return its branch: ``branch`` when
    given (a shape that branch cannot take raises), else ``packed_branch``."""
    _check_qkv(qkv, heads, dim_head, iters)
    n = qkv.shape[1]
    rule = packed_branch(n, dim_head, qkv.dtype)
    chosen = branch or rule
    if chosen not in ("resident", "scratch"):
        raise ValueError(f"packed attention kernel: no branch {chosen!r}")
    if chosen == "resident" and rule != "resident":
        raise ValueError(f"packed attention kernel: the resident branch does not take "
                         f"N={n} D={dim_head} {qkv.dtype}")
    return chosen


def _grid(device: torch.device, kb: int) -> int:
    """Persistent blocks of the resident kernels: at most one an SM (the
    backward launches as many clusters of its blocks as the card holds at
    once, within this)."""
    return max(1, min(kb, torch.cuda.get_device_properties(device).multi_processor_count))


def packed_attention_fwd_cuda(qkv, heads, dim_head, scale, robust=False,
                              iters=3, final_row=True, branch=None):
    """Launch the forward kernel of the branch ``packed_branch`` picks (or
    ``branch``); returns ``(out, vecs)`` like the plain version. Raises on
    anything the kernel does not take."""
    from .build import load_library

    chosen = _branch_of(qkv, heads, dim_head, iters, branch)
    b, n, _ = qkv.shape
    kb = b * heads
    out = torch.empty(b, n, heads * dim_head, dtype=qkv.dtype, device=qkv.device)
    vecs = torch.empty(b, heads, num_vecs(iters, final_row, robust), n,
                       dtype=torch.float32, device=qkv.device)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        if chosen == "resident":
            err = lib.nrv_packed_resident_fwd(
                ptr(qkv), ptr(out), ptr(vecs), b, n, heads, dim_head, float(scale),
                int(robust), int(iters), int(final_row), _grid(qkv.device, kb),
                ctypes.c_void_p(stream))
        else:
            slots = _n_slots(qkv.device, kb)
            scratch = torch.empty(slots, n * _padded_ld(n), dtype=torch.float32,
                                  device=qkv.device)
            err = lib.nrv_packed_attention_fwd(
                ptr(qkv), ptr(out), ptr(vecs), ptr(scratch),
                _DTYPE_CODES[qkv.dtype], b, n, heads, dim_head, float(scale),
                int(robust), int(iters), int(final_row), slots,
                ctypes.c_void_p(stream))
    raise_on(err, f"packed attention forward kernel ({chosen})")
    launches.fwd += 1
    (launches_resident if chosen == "resident" else launches_scratch).fwd += 1
    return out, vecs


def packed_attention_bwd_cuda(qkv, dout, vecs, heads, dim_head, scale,
                              robust=False, iters=3, final_row=True, branch=None):
    """Launch the backward kernel of the branch, as the forward; returns
    ``dqkv`` like the plain version."""
    from .build import load_library

    chosen = _branch_of(qkv, heads, dim_head, iters, branch)
    b, n, _ = qkv.shape
    kb = b * heads
    if (dout.device != qkv.device or dout.dtype != qkv.dtype
            or tuple(dout.shape) != (b, n, heads * dim_head)
            or not dout.is_contiguous() or dout.data_ptr() % 16):
        raise ValueError("packed attention kernel: dout must be a contiguous, "
                         f"16-byte aligned [{b}, {n}, {heads * dim_head}] {qkv.dtype} tensor on "
                         f"{qkv.device}, got {tuple(dout.shape)} {dout.dtype}")
    r = num_vecs(iters, final_row, robust)
    if (vecs.device != qkv.device or vecs.dtype != torch.float32
            or tuple(vecs.shape) != (b, heads, r, n) or not vecs.is_contiguous()):
        raise ValueError("packed attention kernel: vecs must be a contiguous "
                         f"float32 [{b}, {heads}, {r}, {n}] tensor")
    dqkv = torch.empty_like(qkv)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        if chosen == "resident":
            err = lib.nrv_packed_resident_bwd(
                ptr(qkv), ptr(dout), ptr(vecs), ptr(dqkv), ptr(None), b, n, heads,
                dim_head, float(scale), int(robust), int(iters), int(final_row),
                _grid(qkv.device, kb), ctypes.c_void_p(stream))
        else:
            slots = _n_slots(qkv.device, kb)
            scratch = torch.empty(slots, 2 * n * _padded_ld(n) + 2 * n * dim_head,
                                  dtype=torch.float32, device=qkv.device)
            err = lib.nrv_packed_attention_bwd(
                ptr(qkv), ptr(dout), ptr(vecs), ptr(dqkv), ptr(scratch),
                _DTYPE_CODES[qkv.dtype], b, n, heads, dim_head, float(scale),
                int(robust), int(iters), int(final_row), slots,
                ctypes.c_void_p(stream))
    raise_on(err, f"packed attention backward kernel ({chosen})")
    launches.bwd += 1
    (launches_resident if chosen == "resident" else launches_scratch).bwd += 1
    return dqkv


def packed_attention_fwd(qkv, heads, dim_head, scale, robust=False, iters=3,
                         final_row=True):
    """Forward by device: the kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    return by_device(packed_attention_fwd_cuda, packed_attention_fwd_plain, qkv, heads,
                     dim_head, scale, robust, iters, final_row)


def packed_attention_bwd(qkv, dout, vecs, heads, dim_head, scale, robust=False,
                         iters=3, final_row=True):
    """Backward by device, as ``packed_attention_fwd``."""
    return by_device(packed_attention_bwd_cuda, packed_attention_bwd_plain, qkv, dout, vecs,
                     heads, dim_head, scale, robust, iters, final_row)


class PackedAttention(torch.autograd.Function):
    """``[B, N, 3·H·D]`` → ``[B, N, H·D]`` with the hand-derived backward."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head, scale, robust, iters, final_row):
        out, vecs = packed_attention_fwd(qkv, heads, dim_head, scale, robust,
                                         iters, final_row)
        ctx.save_for_backward(qkv, vecs)
        ctx.cfg = (heads, dim_head, scale, robust, iters, final_row)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, vecs = ctx.saved_tensors
        dqkv = packed_attention_bwd(qkv, dout.contiguous(), vecs, *ctx.cfg)
        return dqkv, None, None, None, None, None, None
