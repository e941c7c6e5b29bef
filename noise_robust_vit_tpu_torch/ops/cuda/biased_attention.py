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
dbias sum), the ctypes wrappers of ``csrc/biased_attention_{fwd,bwd}.cu``
with their launch counts, and ``BiasedAttention``, the autograd function.
"""

from __future__ import annotations

import math

import torch

from .build import LaunchCounts, ptr, raise_on, stream
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
    "launches",
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
# CUDA kernels (csrc/biased_attention_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(q, k, v, bias, nw, iters, no_bias):
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
    if not no_bias and (bias.device != q.device or bias.dtype != torch.float32
                        or tuple(bias.shape) != (nw, h, n, n)
                        or not bias.is_contiguous()):
        raise ValueError(f"biased attention kernel: bias must be a contiguous float32 "
                         f"[{nw}, {h}, {n}, {n}] tensor on {q.device}")
    if not biased_attention_supported(bw, h, n, d, v.shape[-1], nw, iters):
        raise ValueError(f"biased attention kernel: shape BW={bw} H={h} N={n} D={d} "
                         f"DV={v.shape[-1]} nW={nw} iters={iters} is outside the gate")


def biased_attention_fwd_cuda(q, k, v, bias, scale, robust=False, iters=3,
                              final_row=True, nw=1, no_bias=False):
    """Launch the forward kernel; returns ``(out, vecs)`` like the plain
    version. Raises on anything the kernel does not take."""
    from .build import load_library

    nw = 1 if no_bias else nw
    _check(q, k, v, bias, nw, iters, no_bias)
    bw, h, n, d = q.shape
    dv = v.shape[-1]
    out = torch.empty_like(v)
    vecs = torch.empty(bw, h, num_vecs(iters, final_row, robust), n,
                       dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.nrv_biased_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(None if no_bias else bias), ptr(out), ptr(vecs),
            _DTYPE_CODES[q.dtype], bw, h, n, d, dv, nw, float(scale), int(robust),
            int(iters), int(final_row), stream(q.device))
    raise_on(err, "biased attention forward kernel")
    launches.fwd += 1
    return out, vecs


def _chunks(device, pairs: int, imgs: int) -> tuple[int, int]:
    """Split each bias row's ``imgs`` images into chunks so that the
    backward grid (pairs × chunks) fills the card; returns (chunks,
    images per chunk), no chunk empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(imgs, math.ceil(sms * _BWD_BLOCKS_PER_SM / pairs)))
    per = math.ceil(imgs / want)
    return math.ceil(imgs / per), per


def biased_attention_bwd_cuda(q, k, v, bias, dout, vecs, scale, robust=False,
                              iters=3, final_row=True, nw=1, no_bias=False):
    """Launch the backward kernel (and the kernel that sums the dbias
    partials); returns ``(dq, dk, dv, dbias)`` like the plain version."""
    from .build import load_library

    nw = 1 if no_bias else nw
    _check(q, k, v, bias, nw, iters, no_bias)
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
    chunks, per = _chunks(q.device, nw * h, bw // nw)
    dbias = partial = None
    if not no_bias:
        dbias = torch.empty(nw, h, n, n, dtype=torch.float32, device=q.device)
        if chunks > 1:
            partial = torch.empty(chunks, nw, h, n, n, dtype=torch.float32,
                                  device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.nrv_biased_attention_bwd(
            ptr(q), ptr(k), ptr(v), ptr(None if no_bias else bias), ptr(dout),
            ptr(vecs), ptr(dq), ptr(dk), ptr(dv), ptr(partial), ptr(dbias),
            _DTYPE_CODES[q.dtype], bw, h, n, d, dv_dim, nw, float(scale), int(robust),
            int(iters), int(final_row), chunks, per, stream(q.device))
    raise_on(err, "biased attention backward kernel")
    launches.bwd += 1
    return dq, dk, dv, dbias


def biased_attention_fwd(q, k, v, bias, scale, robust=False, iters=3,
                         final_row=True, nw=1, no_bias=False):
    """Forward by device: the kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if q.is_cuda:
        return biased_attention_fwd_cuda(q, k, v, bias, scale, robust, iters,
                                         final_row, nw, no_bias)
    if q.device.type != "cpu":
        raise ValueError(f"biased attention: no path for device {q.device}")
    return biased_attention_fwd_plain(q, k, v, bias, scale, robust, iters,
                                      final_row, nw, no_bias)


def biased_attention_bwd(q, k, v, bias, dout, vecs, scale, robust=False,
                         iters=3, final_row=True, nw=1, no_bias=False):
    """Backward by device, as ``biased_attention_fwd``."""
    if q.is_cuda:
        return biased_attention_bwd_cuda(q, k, v, bias, dout, vecs, scale, robust,
                                         iters, final_row, nw, no_bias)
    if q.device.type != "cpu":
        raise ValueError(f"biased attention: no path for device {q.device}")
    return biased_attention_bwd_plain(q, k, v, bias, dout, vecs, scale, robust,
                                      iters, final_row, nw, no_bias)


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
