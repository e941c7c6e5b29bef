"""Biased (windowed) fused attention: softmax, or softmax + Sinkhorn in
scaling-vector form, of ``scale·q·kᵀ + bias`` with an additive
per-(window, head) bias, for the windowed models (Swin, LeViT, MaxViT;
Twins' local attention with ``no_bias``).

Counterpart of ``noise_robust_vit_tpu/ops/pallas/biased_attention.py``
(``biased_attention``; its Pallas calls are ``_biased_fwd_impl`` and
``_biased_bwd_impl``). Layout, as there:

* ``q, k [BW, H, N, D]`` and ``v [BW, H, N, DV]`` (DV ≠ D for LeViT);
* ``bias [nW, H, N, N]`` float32, broadcast over the ``BW // nW`` images:
  window ``bw`` reads bias row ``bw % nW``;
* ``out [BW, H, N, DV]``, differentiable in q, k, v and the bias; the bias
  gradient sums over the images that share each row.

Three pieces live here, as in ``packed_attention.py``: the plain PyTorch
versions (the kernels' algorithm in ``plain.py`` plus the bias and the
dbias sum), the ctypes wrappers of the kernels with their launch counts
(``launches``, and by branch ``launches_resident`` / ``launches_shared``),
and ``BiasedAttention``, the autograd function.

Two branches of kernels compute the function, chosen by shape and dtype
before the call (``biased_branch``): the resident kernels
(``csrc/biased_resident_{fwd,bwd}.cu``: bf16, N ≤ 64, D and DV each 16, 32
or 64; each (image, head) matrix held in registers in float32, the bias row
loaded once for the images that share it, every product on the tensor
cores) and the shared-memory kernels (``csrc/biased_attention_{fwd,bwd}.cu``:
every other shape the gate takes, float32 and N up to 196 included; each
matrix in a block's shared memory). A CUDA tensor goes to one of them or
raises.
"""

from __future__ import annotations

import functools
import math

import torch

from .build import LaunchCounts, by_device, ptr, raise_on, stream
from .plain import attention_bwd_plain, attention_fwd_plain, num_vecs

__all__ = [
    "BiasedAttention",
    "biased_attention_bwd",
    "biased_attention_bwd_cuda",
    "biased_attention_bwd_plain",
    "biased_attention_fwd",
    "biased_attention_fwd_cuda",
    "biased_attention_fwd_plain",
    "biased_attention_supported",
    "biased_branch",
    "launches",
    "launches_resident",
    "launches_shared",
]

# Gate. Each (window, head) matrix lives in one block's shared memory, so N
# is bounded by what the backward holds there (csrc/biased_attention_bwd.cu:
# the N×N matrix, the GEMM tiles, the scaling vectors and o/a, t1 [N, DVC],
# DVC = DV or, where that does not fit, 32 columns at a time), which must
# fit the 227 KB a block may use on Hopper. Head widths are multiples of 8,
# as in the JAX gate, up to 128. N ≤ 196 and iters ≤ 8 are the checked
# cases: Swin (49, 64), MaxViT (49), Twins local (49, D 64) and LeViT's 196
# (D 16, DV 32; and D 32, DV 64 in column chunks), which fits for iters ≤ 4
# only.
MAX_N = 196
MAX_DIM = 128
MAX_ITERS = 8
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
# kGemmSmemFloats, and the static shared memory of the backward kernel
# (cols_partials' array and the chain's term offsets, 1168 bytes as ptxas
# reports them), as in csrc: the dynamic and the static share the limit
_GEMM_SMEM_FLOATS = 2 * 2304
_STATIC_SMEM = 1168

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# blocks of the backward grid to aim for (chunks × nW·H), per SM
_BWD_BLOCKS_PER_SM = 8

launches = LaunchCounts()
launches_resident = LaunchCounts()
launches_shared = LaunchCounts()

# The resident branch (csrc/biased_resident.cuh, mirrored here: change one,
# change the other). A warp holds 16 rows of an item at _res_cols(N)
# columns; an item takes NC / 16 warps of a 4-warp block, which holds
# 64 / NC items.
_RES_MAX_N = 64
_RES_WIDTHS = (16, 32, 64)
_RES_WARPS = 4
_RES_STATIC = 1024
_RES_RANK_LD = 40  # kRankLd: the rank-1 column factors' row, floats
# what a unit's start costs (its bias row, its dbias partial) in images of
# its walk, for the choice of chunks
_RES_UNIT_COST = 0.5


def _bwd_smem_bytes(n: int, dvc: int, iters: int, ka: int) -> int:
    """``biased_bwd_smem_bytes`` in csrc, plus the static shared memory."""
    head = (1 + ka + iters + 2) * n
    region = max((3 + 2 * iters) * n, 2 * n * dvc)
    return 4 * (n * ((n + 3) // 4 * 4) + _GEMM_SMEM_FLOATS + head + region) + _STATIC_SMEM


def _dv_chunk(n: int, dv: int, iters: int, ka: int) -> int:
    """``biased_bwd_dv_chunk`` in csrc: the o/a and t1 columns the backward
    forms at a time, DV or 32; 0 when neither fits."""
    for dvc in (dv, 32):
        if dv % dvc == 0 and _bwd_smem_bytes(n, dvc, iters, ka) <= _SMEM_LIMIT:
            return dvc
    return 0


def _res_cols(n: int) -> int:
    """``res_cols``: N rounded up to 16, 32 or 64."""
    return 16 if n <= 16 else 32 if n <= 32 else 64


def _res_items(n: int) -> int:
    """``res_items``: items a block holds."""
    return _RES_WARPS // (_res_cols(n) // 16)


def _resident_fwd_smem(n: int, d: int, dv: int) -> int:
    """``fwd_smem_bytes`` in csrc: dynamic shared memory of the forward."""
    nc = _res_cols(n)
    ic = _res_items(n) * nc
    return 2 * ic * (2 * d + dv) * 2 + 4 * (_RES_WARPS * 16 * nc + _RES_WARPS * nc + ic)


def _resident_bwd_smem(n: int, d: int, dv: int, it: int) -> int:
    """``bwd_smem_bytes`` (with ``bwd_part_floats``, ``res_vec_rows`` and
    ``bwd_comp_rows``) in csrc: dynamic shared memory of the backward; ``it``
    is the iterations when robust, else 0."""
    nc, items = _res_cols(n), _res_items(n)
    ic = items * nc
    part = max(nc * nc, nc * _RES_RANK_LD if it else 0)
    vec_rows = 2 * it + 1 if it else 1
    return 2 * ic * (2 * d + 2 * dv) * 2 + 4 * (_RES_WARPS * 16 * nc + items * part
                                                + 2 * ic * vec_rows + ic * (1 + 2 * it))


def _resident_fits(n: int, d: int, dv: int, robust: bool = True, iters: int = 3) -> bool:
    """``resident_fits`` in csrc: the shapes the resident kernels take."""
    if not 1 <= n <= _RES_MAX_N or d not in _RES_WIDTHS or dv not in _RES_WIDTHS:
        return False
    if robust and not 1 <= iters <= MAX_ITERS:
        return False
    it = iters if robust else 0
    return (_resident_fwd_smem(n, d, dv) + _RES_STATIC <= _SMEM_LIMIT
            and _resident_bwd_smem(n, d, dv, it) + _RES_STATIC <= _SMEM_LIMIT)


def biased_branch(n: int, d: int, dv: int, dtype: torch.dtype, robust: bool = True,
                  iters: int = 3) -> str:
    """The kernels a CUDA call of this shape and dtype goes to: "resident"
    (bf16 where ``_resident_fits``) or "shared" (every other shape the gate
    takes)."""
    return ("resident" if dtype == torch.bfloat16 and _resident_fits(n, d, dv, robust, iters)
            else "shared")


@functools.lru_cache(maxsize=1024)
def _res_chunks(imgs: int, pairs: int, slots: int) -> tuple[int, int]:
    """(chunks, images a chunk) of the resident walk: ``slots`` workers (a
    block's items times the persistent grid) each take whole units (chunk,
    window, head) of up to ``per`` images; the split whose busiest worker
    ends first, a unit's start counted as ``_RES_UNIT_COST`` images, and
    of two equal ones the fewer chunks."""
    best = None
    for per in range(imgs, 0, -1):
        chunks = -(-imgs // per)
        if (chunks - 1) * per >= imgs:
            continue  # a chunk would be empty
        cost = -(-(chunks * pairs) // slots) * (per + _RES_UNIT_COST)
        if best is None or cost < best[0]:
            best = (cost, chunks, per)
    return best[1], best[2]


def biased_attention_supported(bw: int, heads: int, n: int, d: int, dv: int,
                               nw: int, sinkhorn_iters: int = 3) -> bool:
    """Shape gate of the biased kernels, decided before any call (the worst
    schedule of ``sinkhorn_iters`` is assumed: a final row norm)."""
    if not (bw >= 1 and heads >= 1 and nw >= 1 and bw % nw == 0):
        return False
    if not (1 <= n <= MAX_N and 1 <= sinkhorn_iters <= MAX_ITERS):
        return False
    if any(x % 8 or not 8 <= x <= MAX_DIM for x in (d, dv)):
        return False
    return _dv_chunk(n, dv, sinkhorn_iters, sinkhorn_iters) > 0


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _items(x: torch.Tensor) -> torch.Tensor:
    """``[BW, H, N, X]`` → float32 ``[BW·H, N, X]``."""
    return x.float().reshape(-1, x.shape[-2], x.shape[-1])


def _full_bias(bias, bw, nw):
    """``[nW, H, N, N]`` → float32 ``[BW·H, N, N]``, window ``bw`` taking row
    ``bw % nW``."""
    _, h, n, _ = bias.shape
    return bias.float().unsqueeze(0).expand(bw // nw, nw, h, n, n).reshape(bw * h, n, n)


def biased_attention_fwd_plain(q, k, v, bias, scale, robust=False, iters=3,
                               final_row=True, nw=1, no_bias=False):
    """Forward in eager torch; returns ``(out [BW,H,N,DV], vecs [BW,H,R,N])``."""
    bw, h, n, _ = q.shape
    full = None if no_bias else _full_bias(bias, bw, nw)
    out, vecs = attention_fwd_plain(_items(q), _items(k), _items(v), scale, robust,
                                    iters, final_row, bias=full)
    return out.reshape(bw, h, n, -1).to(v.dtype), vecs.reshape(bw, h, -1, n)


def biased_attention_bwd_plain(q, k, v, bias, dout, vecs, scale, robust=False,
                               iters=3, final_row=True, nw=1, no_bias=False):
    """Backward in eager torch from the stored residuals; returns ``(dq, dk,
    dv, dbias)``, dbias float32 ``[nW, H, N, N]`` summed over the images
    (None when ``no_bias``)."""
    bw, h, n, d = q.shape
    full = None if no_bias else _full_bias(bias, bw, nw)
    dq, dk, dv, ds = attention_bwd_plain(
        _items(q), _items(k), _items(v), _items(dout), vecs.reshape(bw * h, -1, n),
        scale, robust, iters, final_row, bias=full)
    dbias = None if no_bias else ds.reshape(bw // nw, nw, h, n, n).sum(0)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype), dbias)


# --------------------------------------------------------------------------
# CUDA kernels (csrc/biased_resident_{fwd,bwd}.cu, csrc/biased_attention_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(q, k, v, bias, nw, robust, iters, no_bias, branch):
    """Raise unless the kernels take these operands; returns the branch
    (``branch`` if given and allowed, else ``biased_branch``'s)."""
    if not q.is_cuda:
        raise ValueError("biased attention kernel: q must be a CUDA tensor")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"biased attention kernel: dtype {q.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"biased attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not [BW, H, N, D] "
                         "and [BW, H, N, DV]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"biased attention kernel: {name} must be a contiguous, "
                             f"16-byte aligned {q.dtype} tensor on {q.device}")
    bw, h, n, d = q.shape
    dv = v.shape[-1]
    if not no_bias and (bias.device != q.device or bias.dtype != torch.float32
                        or tuple(bias.shape) != (nw, h, n, n)
                        or not bias.is_contiguous()):
        raise ValueError(f"biased attention kernel: bias must be a contiguous float32 "
                         f"[{nw}, {h}, {n}, {n}] tensor on {q.device}")
    if not biased_attention_supported(bw, h, n, d, dv, nw, iters):
        raise ValueError(f"biased attention kernel: shape BW={bw} H={h} N={n} D={d} "
                         f"DV={dv} nW={nw} iters={iters} is outside the gate")
    rule = biased_branch(n, d, dv, q.dtype, robust, iters)
    chosen = branch or rule
    if chosen not in ("resident", "shared"):
        raise ValueError(f"biased attention kernel: no branch {chosen!r}")
    if chosen == "resident" and rule != "resident":
        raise ValueError(f"biased attention kernel: the resident branch does not take "
                         f"N={n} D={d} DV={dv} {q.dtype}")
    return chosen


def _count(chosen, direction):
    for c in (launches, launches_resident if chosen == "resident" else launches_shared):
        setattr(c, direction, getattr(c, direction) + 1)


@functools.lru_cache(maxsize=256)
def _res_blocks(device_index: int, n: int, d: int, dv: int, robust: bool, iters: int,
                bwd: bool) -> int:
    """Blocks of a resident kernel resident on the card at once (the
    library's ``nrv_biased_resident_blocks``): its persistent grid."""
    from .build import load_library

    with torch.cuda.device(device_index):
        blocks = load_library().nrv_biased_resident_blocks(n, d, dv, int(robust), int(iters),
                                                           int(bwd))
    if blocks < 1:
        raise_on(-blocks, "biased attention resident kernel: occupancy query")
    return blocks


def _res_walk(q, v, nw, robust, iters, bwd):
    """(chunks, images a chunk) of a resident launch over these operands."""
    bw, h, n, d = q.shape
    blocks = _res_blocks(q.device.index, n, d, v.shape[-1], bool(robust), int(iters), bwd)
    return _res_chunks(bw // nw, nw * h, blocks * _res_items(n))


def biased_attention_fwd_cuda(q, k, v, bias, scale, robust=False, iters=3,
                              final_row=True, nw=1, no_bias=False, branch=None):
    """Launch the forward kernel of the branch ``biased_branch`` picks (or
    ``branch``); returns ``(out, vecs)`` like the plain version. Raises on
    anything the kernel does not take."""
    from .build import load_library

    nw = 1 if no_bias else nw
    chosen = _check(q, k, v, bias, nw, robust, iters, no_bias, branch)
    bw, h, n, d = q.shape
    dv = v.shape[-1]
    out = torch.empty_like(v)
    vecs = torch.empty(bw, h, num_vecs(iters, final_row, robust), n,
                       dtype=torch.float32, device=q.device)
    ptrs = (ptr(q), ptr(k), ptr(v), ptr(None if no_bias else bias), ptr(out), ptr(vecs))
    cfg = (float(scale), int(robust), int(iters), int(final_row))
    lib = load_library()
    with torch.cuda.device(q.device):
        if chosen == "resident":
            chunks, per = _res_walk(q, v, nw, robust, iters, False)
            err = lib.nrv_biased_resident_fwd(*ptrs, bw, h, n, d, dv, nw, *cfg, chunks, per,
                                              stream(q.device))
        else:
            err = lib.nrv_biased_attention_fwd(*ptrs, _DTYPE_CODES[q.dtype], bw, h, n, d, dv,
                                               nw, *cfg, stream(q.device))
    raise_on(err, f"biased attention forward kernel ({chosen})")
    _count(chosen, "fwd")
    return out, vecs


def _chunks(device, pairs: int, imgs: int) -> tuple[int, int]:
    """Split each bias row's ``imgs`` images into chunks so that the
    shared-memory backward's grid (pairs × chunks) fills the card; returns
    (chunks, images per chunk), no chunk empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(imgs, math.ceil(sms * _BWD_BLOCKS_PER_SM / pairs)))
    per = math.ceil(imgs / want)
    return math.ceil(imgs / per), per


def biased_attention_bwd_cuda(q, k, v, bias, dout, vecs, scale, robust=False,
                              iters=3, final_row=True, nw=1, no_bias=False, branch=None):
    """Launch the backward kernel of the branch, as the forward (and the
    kernel that sums the dbias partials); returns ``(dq, dk, dv, dbias)``
    like the plain version."""
    from .build import load_library

    nw = 1 if no_bias else nw
    chosen = _check(q, k, v, bias, nw, robust, iters, no_bias, branch)
    bw, h, n, d = q.shape
    dv_dim = v.shape[-1]
    if (dout.device != q.device or dout.dtype != q.dtype or dout.shape != v.shape
            or not dout.is_contiguous() or dout.data_ptr() % 16):
        raise ValueError("biased attention kernel: dout must be a contiguous, 16-byte "
                         f"aligned {tuple(v.shape)} {q.dtype} tensor on {q.device}")
    r = num_vecs(iters, final_row, robust)
    if (vecs.device != q.device or vecs.dtype != torch.float32
            or tuple(vecs.shape) != (bw, h, r, n) or not vecs.is_contiguous()):
        raise ValueError("biased attention kernel: vecs must be a contiguous "
                         f"float32 [{bw}, {h}, {r}, {n}] tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if chosen == "resident":
        chunks, per = _res_walk(q, v, nw, robust, iters, True)
    else:
        chunks, per = _chunks(q.device, nw * h, bw // nw)
    dbias = partial = None
    if not no_bias:
        dbias = torch.empty(nw, h, n, n, dtype=torch.float32, device=q.device)
        if chunks > 1:
            partial = torch.empty(chunks, nw, h, n, n, dtype=torch.float32,
                                  device=q.device)
    ptrs = (ptr(q), ptr(k), ptr(v), ptr(None if no_bias else bias), ptr(dout), ptr(vecs),
            ptr(dq), ptr(dk), ptr(dv), ptr(partial), ptr(dbias))
    cfg = (float(scale), int(robust), int(iters), int(final_row), chunks, per)
    lib = load_library()
    with torch.cuda.device(q.device):
        if chosen == "resident":
            err = lib.nrv_biased_resident_bwd(*ptrs, bw, h, n, d, dv_dim, nw, *cfg,
                                              stream(q.device))
        else:
            err = lib.nrv_biased_attention_bwd(*ptrs, _DTYPE_CODES[q.dtype], bw, h, n, d,
                                               dv_dim, nw, *cfg, stream(q.device))
    raise_on(err, f"biased attention backward kernel ({chosen})")
    _count(chosen, "bwd")
    return dq, dk, dv, dbias


def biased_attention_fwd(q, k, v, bias, scale, robust=False, iters=3,
                         final_row=True, nw=1, no_bias=False):
    """Forward by device: the kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    return by_device(biased_attention_fwd_cuda, biased_attention_fwd_plain, q, k, v, bias,
                     scale, robust, iters, final_row, nw, no_bias)


def biased_attention_bwd(q, k, v, bias, dout, vecs, scale, robust=False,
                         iters=3, final_row=True, nw=1, no_bias=False):
    """Backward by device, as ``biased_attention_fwd``."""
    return by_device(biased_attention_bwd_cuda, biased_attention_bwd_plain, q, k, v, bias,
                     dout, vecs, scale, robust, iters, final_row, nw, no_bias)


class BiasedAttention(torch.autograd.Function):
    """``q, k, v, bias`` → ``out [BW, H, N, DV]`` with the hand-derived
    backward. q, k and v are made contiguous here: the views that
    ``qkv.split`` and a permute give are copied once each way."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, robust, iters, final_row, nw, no_bias):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        bias_c = None if no_bias else bias.float().contiguous()
        out, vecs = biased_attention_fwd(q, k, v, bias_c, scale, robust, iters,
                                         final_row, nw, no_bias)
        ctx.save_for_backward(q, k, v, bias_c, vecs)
        ctx.cfg = (scale, robust, iters, final_row, nw, no_bias)
        ctx.bias_dtype, ctx.bias_shape = bias.dtype, bias.shape
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, vecs = ctx.saved_tensors
        dq, dk, dv, dbias = biased_attention_bwd(q, k, v, bias, dout.contiguous(),
                                                 vecs, *ctx.cfg)
        if ctx.needs_input_grad[3]:
            # no_bias: the bias is known to be zero and its gradient is zero
            dbias = (torch.zeros(ctx.bias_shape, dtype=ctx.bias_dtype,
                                 device=q.device)
                     if dbias is None else dbias.to(ctx.bias_dtype))
        else:
            dbias = None
        return dq, dk, dv, dbias, None, None, None, None, None, None
