"""Streaming q/k/v-interface Sinkhorn attention: ``q [B, H, N, D]``,
``k, v [B, H, M, D]`` → ``sinkhorn(softmax(scale·q·kᵀ)) · v`` ``[B, H, N, D]``
(3 iterations and a final row norm, or any other schedule up to 8
iterations), differentiable in q, k and v, without ever holding the N×M
matrix in device memory. Built for the giant-N robust stages that the
logits-interface kernels refuse (CvT stage 1: 3136 queries × 784 keys).

Counterpart of ``noise_robust_vit_tpu/ops/pallas/streaming_sinkhorn.py``
(``streaming_attention``; its Pallas calls are ``_stream_fwd_impl`` and
``_stream_bwd_impl``). Every Sinkhorn reduction is a sweep over query tiles
that recomputes ``en = exp(scale·q·kᵀ − lse)``; a whole attention row lies
in one tile, so each row update rides the same sweep as the next column
accumulation:

* forward: sweep 0 forms each row's lse and the first column sum (the first
  row norm is the identity after a softmax and is skipped), one sweep for
  each further iteration, and an output sweep with the final row update;
* backward: sweep B1 (dv, the direct gradient of the last b, and
  ``go = rowsum(g ⊙ o)``, o recomputed), one fused sweep for each link of
  the reverse chain, and a final sweep applying the rank-1 stack plus the
  rank-D direct term, ``ds = en ⊙ (dA − ρ)``, to dq and dk;
* the clamped double-where reciprocal of ``ops/sinkhorn.py``.

Residuals, float32, row-major as in JAX without its padding: ``av
[B·H, 1 + n_av, N]`` (lse, then the ``n_av = iters − 1 + final_row``
a-vectors) and ``bv [B·H, iters, M]`` (the b-vectors); the output is not
kept. The plain versions run over query tiles of any size (the whole N by
default): padded rows carry ``lse = +BIG`` so that every recompute of them
is exactly zero, and padded key columns are masked to ``−BIG`` before the
exp, as in the Pallas kernel; tiles change no number beyond rounding.

Three pieces live here, as in ``sinkhorn_softmax.py``: the plain PyTorch
versions, the ctypes wrappers of ``csrc/streaming_attention_{fwd,bwd}.cu``
with a launch count, and the autograd function ``StreamingAttention``.
"""

from __future__ import annotations

import torch

from ..sinkhorn import clamped_recip
from .build import LaunchCounts, by_device, check_operand, ptr, raise_on, stream

__all__ = [
    "StreamingAttention",
    "launches",
    "streaming_attention_bwd",
    "streaming_attention_bwd_cuda",
    "streaming_attention_bwd_plain",
    "streaming_attention_fwd",
    "streaming_attention_fwd_cuda",
    "streaming_attention_fwd_plain",
    "streaming_attention_supported",
]

# Gate. A block holds one item's query tile of tq full rows of en (float32,
# rows padded to 4 floats) in shared memory, beside the GEMM tiles, the
# column vectors (the backward's: the running db, dcol, b_F and up to
# 2·iters rank-1 column factors) and the tile's row vectors; q, k, v and g
# are read from device memory (k and v stay in L2), and the backward's
# [M, D] accumulator (dv's, then dk's) is a float32 slot per item in device
# memory. tq is the largest of 64, 32, 16 whose footprint fits the 227 KB a
# block may use: csrc stream_{fwd,bwd}_smem_floats, mirrored below, plus the
# static shared memory (the column partials and the term pointers, ~1.2 KB;
# STATIC_SMEM keeps 4096 bytes).
MAX_ITERS = 8
_TILES = (64, 32, 16)
_GEMM_FLOATS = 2 * max(64 * (32 + 4), 32 * (64 + 8))  # kGemmSmemFloats
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_STATIC_SMEM = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30
_BIG = 1e30

launches = LaunchCounts()


def _padded_ld(n: int) -> int:
    return (n + 3) // 4 * 4


def _n_avecs(iters: int, final_row: bool) -> int:
    return max(iters - 1, 0) + int(final_row)


def _fwd_smem_floats(tq: int, m: int) -> int:
    return tq * _padded_ld(m) + _GEMM_FLOATS + 2 * m + 3 * tq


def _bwd_smem_floats(tq: int, m: int, d: int, iters: int) -> int:
    nt = 2 * iters  # rank-1 terms at the worst schedule of iters (a final row norm)
    return tq * _padded_ld(m) + _GEMM_FLOATS + tq * d + (3 + nt) * m + (6 + nt) * tq


def _tile(m: int, d: int, iters: int) -> int:
    """The kernels' query-tile rows for M keys of width d, or 0 where no
    tile fits."""
    for tq in _TILES:
        floats = max(_fwd_smem_floats(tq, m), _bwd_smem_floats(tq, m, d, iters))
        if 4 * floats + _STATIC_SMEM <= _SMEM_LIMIT:
            return tq
    return 0


def streaming_attention_supported(b: int, h: int, n: int, m: int, d: int, iters: int = 3,
                                  dtype=None) -> bool:
    """Shape gate of the kernels, decided before any call: at least one
    query and key, D a multiple of 4 (16-byte runs of q, k, v and g rows),
    1 to 8 iterations, and a query tile that fits one block's shared memory
    (M up to ~2000 at D = 64); with ``dtype``, also whether the kernels take
    it (float32, bfloat16). The caller applies the giant-N policy."""
    return (b >= 1 and h >= 1 and n >= 1 and m >= 1 and d >= 4 and d % 4 == 0
            and 1 <= iters <= MAX_ITERS and (dtype is None or dtype in _DTYPE_CODES)
            and _tile(m, d, iters) > 0)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def _pad_rows(x: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """``[K, n, ...]`` → ``[K, rows, ...]``, the new rows filled with ``value``."""
    if x.shape[1] == rows:
        return x
    pad = x.new_full((x.shape[0], rows - x.shape[1], *x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


class _Sweeps:
    """One call's float32 operands over ``K`` = (image × head) items, padded
    to whole query tiles (rows) and to a multiple of 8 keys, and the tile
    recompute ``en = exp(scale·q_t·kᵀ − lse_t)``."""

    def __init__(self, q, k, v, scale, tile):
        b, h, n, d = q.shape
        m = k.shape[2]
        self.shape, self.n, self.m, self.scale = (b, h, n, d), n, m, scale
        self.tq = n if tile is None else int(tile)
        self.n_pad, self.m_pad = _round_up(n, self.tq), _round_up(m, 8)
        self.q = _pad_rows(q.reshape(b * h, n, d).float(), self.n_pad)
        self.k = _pad_rows(k.reshape(b * h, m, d).float(), self.m_pad)
        self.v = _pad_rows(v.reshape(b * h, m, d).float(), self.m_pad)
        self.colmask = torch.arange(self.m_pad, device=q.device) < m

    def tiles(self):
        return range(0, self.n_pad, self.tq)

    def rowmask(self, t):
        return torch.arange(t, t + self.tq, device=self.q.device) < self.n

    def logits(self, t):
        s = torch.bmm(self.q[:, t:t + self.tq], self.k.transpose(1, 2)) * self.scale
        return torch.where(self.colmask, s, torch.full_like(s, _NEG))

    def en(self, t, lse):
        return torch.exp(self.logits(t) - lse[:, t:t + self.tq, None])


def streaming_attention_fwd_plain(q, k, v, scale, iters=3, final_row=True, tile=None):
    """Forward in eager torch over query tiles of ``tile`` rows (the whole
    N by default): ``(out [B, H, N, D]`` in v's dtype, ``av [B·H, 1 + n_av,
    N]``, ``bv [B·H, iters, M]`` float32)."""
    sw = _Sweeps(q, k, v, scale, tile)
    kb = sw.q.shape[0]
    zeros_m = lambda: torch.zeros(kb, sw.m_pad, dtype=torch.float32, device=q.device)  # noqa: E731
    # sweep 0: per-row lse and the first column sum (a-update skipped)
    lse = torch.empty(kb, sw.n_pad, dtype=torch.float32, device=q.device)
    bsum = zeros_m()
    for t in sw.tiles():
        s = sw.logits(t)
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx)
        sm = e.sum(-1, keepdim=True)
        rows = sw.rowmask(t)
        lse[:, t:t + sw.tq] = torch.where(rows, (mx + torch.log(sm))[..., 0], _BIG)
        bsum = bsum + torch.where(rows[:, None], e / sm, 0.0).sum(1)
    b = clamped_recip(bsum)
    b_rows, a_rows = [b], []
    # one sweep per further iteration: the row update feeds the column sum
    for _ in range(1, iters):
        bsum = zeros_m()
        a = torch.empty(kb, sw.n_pad, dtype=torch.float32, device=q.device)
        for t in sw.tiles():
            en = sw.en(t, lse)
            a_t = clamped_recip((en * b[:, None, :]).sum(-1))
            a[:, t:t + sw.tq] = a_t
            bsum = bsum + (en * a_t[..., None]).sum(1)
        a_rows.append(a)
        b = clamped_recip(bsum)
        b_rows.append(b)
    # output sweep: the final row update, if any, is complete in the tile
    out = torch.empty(kb, sw.n_pad, sw.shape[3], dtype=torch.float32, device=q.device)
    bv_ = sw.v * b[..., None]
    a_fin = torch.empty_like(lse) if final_row else None
    for t in sw.tiles():
        en = sw.en(t, lse)
        if final_row:
            a_t = clamped_recip((en * b[:, None, :]).sum(-1))
            a_fin[:, t:t + sw.tq] = a_t
        elif iters == 1:
            a_t = torch.ones_like(lse[:, t:t + sw.tq])
        else:
            a_t = a_rows[-1][:, t:t + sw.tq]
        out[:, t:t + sw.tq] = a_t[..., None] * torch.bmm(en, bv_)
    if final_row:
        a_rows.append(a_fin)
    av = torch.stack([lse] + a_rows, dim=1)[:, :, :sw.n]
    bv = torch.stack(b_rows, dim=1)[:, :, :sw.m]
    return out[:, :sw.n].reshape(q.shape).to(v.dtype), av.contiguous(), bv.contiguous()


def streaming_attention_bwd_plain(q, k, v, g, av, bv, scale, iters=3, final_row=True,
                                  tile=None):
    """Backward in eager torch from the residuals: ``(dq, dk, dv)`` in q's,
    k's and v's dtypes. Mirrors ``_stream_bwd_kernel``: B1, the reverse
    chain's fused sweeps, then the final sweep with the rank-1 stack."""
    sw = _Sweeps(q, k, v, scale, tile)
    kb, tq, d = sw.q.shape[0], sw.tq, sw.shape[3]
    n_av = _n_avecs(iters, final_row)
    g32 = _pad_rows(g.reshape(kb, sw.n, d).float(), sw.n_pad)
    lse = _pad_rows(av[:, 0], sw.n_pad, _BIG)
    a_rows = [_pad_rows(av[:, 1 + j], sw.n_pad, 1.0) for j in range(n_av)]
    b_rows = [_pad_rows(bv[:, i], sw.m_pad, 1.0) for i in range(iters)]
    ones_n = torch.ones(kb, sw.n_pad, dtype=torch.float32, device=q.device)
    a_f = a_rows[-1] if n_av else ones_n
    b_f = b_rows[-1]
    bfv = sw.v * b_f[..., None]
    zeros_m = lambda: torch.zeros(kb, sw.m_pad, dtype=torch.float32, device=q.device)  # noqa: E731

    # sweep B1: dv's accumulator T = enᵀ(a_F ⊙ g), go = rowsum(a_F·g ⊙ en·(b_F ⊙ v)),
    # and the final row norm's du_F with its column sum
    tacc = torch.zeros(kb, sw.m_pad, d, dtype=torch.float32, device=q.device)
    dcol = zeros_m()
    go = torch.empty_like(lse)
    du_f = torch.empty_like(lse)
    for t in sw.tiles():
        en = sw.en(t, lse)
        ag = a_f[:, t:t + tq, None] * g32[:, t:t + tq]
        tacc = tacc + torch.bmm(en.transpose(1, 2), ag)
        go_t = (ag * torch.bmm(en, bfv)).sum(-1)
        go[:, t:t + tq] = go_t
        if final_row:
            du_t = -go_t * a_f[:, t:t + tq]
            du_f[:, t:t + tq] = du_t
            dcol = dcol + torch.bmm(du_t[:, None, :], en)[:, 0]
    terms = [(du_f, b_f)] if final_row else []
    dv = b_f[..., None] * tacc
    db = (sw.v * tacc).sum(-1) + dcol  # the gradient of b_{iters-1}

    # reverse chain: one fused sweep per b_i (i = iters-1 … 1)
    for i in range(iters - 1, 0, -1):
        dw = -db * b_rows[i] * b_rows[i]
        a_prev = a_rows[i - 1]
        terms.append((a_prev, dw))
        head = not final_row and i == iters - 1
        bcur = zeros_m()
        du = torch.empty_like(lse)
        for t in sw.tiles():
            en = sw.en(t, lse)
            da = torch.bmm(en, dw[..., None])[..., 0]
            if head:  # the output's own seed, daF = go / a_F
                da = da + go[:, t:t + tq] / a_f[:, t:t + tq]
            a_t = a_prev[:, t:t + tq]
            du_t = -da * a_t * a_t
            du[:, t:t + tq] = du_t
            bcur = bcur + torch.bmm(du_t[:, None, :], en)[:, 0]
        terms.append((du, b_rows[i - 1]))
        db = bcur
    terms.append((ones_n, -db * b_rows[0] * b_rows[0]))  # b_0 = recip(colsum(en))

    # final sweep: ds = en ⊙ (rank-1 stack + rank-D term − ρ)
    pt = torch.stack([u for u, _ in terms], dim=2)  # [K, Np, T]
    qs = torch.stack([w for _, w in terms], dim=1)  # [K, T, Mp]
    dq = torch.empty_like(sw.q)
    dk = torch.zeros_like(sw.k)
    for t in sw.tiles():
        en = sw.en(t, lse)
        pt_t = pt[:, t:t + tq]
        rho = (pt_t * torch.bmm(en, qs.transpose(1, 2))).sum(-1) + go[:, t:t + tq]
        ag = a_f[:, t:t + tq, None] * g32[:, t:t + tq]
        de = torch.bmm(pt_t, qs) + torch.bmm(ag, bfv.transpose(1, 2))
        ds = en * (de - rho[..., None])
        dq[:, t:t + tq] = scale * torch.bmm(ds, sw.k)
        dk = dk + scale * torch.bmm(ds.transpose(1, 2), sw.q[:, t:t + tq])
    return (dq[:, :sw.n].reshape(q.shape).to(q.dtype),
            dk[:, :sw.m].reshape(k.shape).to(k.dtype),
            dv[:, :sw.m].reshape(v.shape).to(v.dtype))


# --------------------------------------------------------------------------
# CUDA kernels (csrc/streaming_attention_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(name, t, like, dtype=None, shape=None):
    check_operand("streaming attention", name, t, like, dtype, shape)


def _check_inputs(q, k, v, iters):
    if not q.is_cuda:
        raise ValueError("streaming attention kernel: q must be a CUDA tensor")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"streaming attention kernel: dtype {q.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("streaming attention kernel: q, k, v must be [B, H, *, D]")
    b, h, n, d = q.shape
    m = k.shape[2]
    _check("q", q, q)
    _check("k", k, q, shape=(b, h, m, d))
    _check("v", v, q, shape=(b, h, m, d))
    if not streaming_attention_supported(b, h, n, m, d, iters):
        raise ValueError(f"streaming attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} with iters={iters} is outside the gate")
    return b * h, n, m, d


def _residual_shapes(kb, n, m, iters, final_row):
    return (kb, 1 + _n_avecs(iters, final_row), n), (kb, iters, m)


def streaming_attention_fwd_cuda(q, k, v, scale, iters=3, final_row=True):
    """Launch the forward kernel; returns ``(out, av, bv)`` like the plain
    version. Raises on anything the kernel does not take."""
    from .build import load_library

    kb, n, m, d = _check_inputs(q, k, v, iters)
    out = torch.empty_like(q)
    shape_a, shape_b = _residual_shapes(kb, n, m, iters, final_row)
    av = torch.empty(shape_a, dtype=torch.float32, device=q.device)
    bv = torch.empty(shape_b, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = load_library().nrv_streaming_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(av), ptr(bv), _DTYPE_CODES[q.dtype], kb, n,
            m, d, float(scale), int(iters), int(final_row), _tile(m, d, iters),
            stream(q.device))
    raise_on(err, "streaming attention forward kernel")
    launches.fwd += 1
    return out, av, bv


def streaming_attention_bwd_cuda(q, k, v, g, av, bv, scale, iters=3, final_row=True):
    """Launch the backward kernel; returns ``(dq, dk, dv)``. Scratch: the
    [M, D] float32 accumulator of each item and its row vectors (go and up
    to ``iters`` du-vectors), in device memory."""
    from .build import load_library

    kb, n, m, d = _check_inputs(q, k, v, iters)
    _check("g", g, q, shape=q.shape)
    for name, t, shape in zip(("av", "bv"), (av, bv),
                              _residual_shapes(kb, n, m, iters, final_row)):
        _check(name, t, q, torch.float32, shape)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    acc = torch.empty(kb, m, d, dtype=torch.float32, device=q.device)
    rows = torch.empty(kb, 1 + iters, n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = load_library().nrv_streaming_attention_bwd(
            ptr(q), ptr(k), ptr(v), ptr(g), ptr(av), ptr(bv), ptr(dq), ptr(dk), ptr(dv),
            ptr(acc), ptr(rows), _DTYPE_CODES[q.dtype], kb, n, m, d, float(scale), int(iters),
            int(final_row), _tile(m, d, iters), stream(q.device))
    raise_on(err, "streaming attention backward kernel")
    launches.bwd += 1
    return dq, dk, dv


def streaming_attention_fwd(q, k, v, scale, iters=3, final_row=True):
    return by_device(streaming_attention_fwd_cuda, streaming_attention_fwd_plain, q, k, v,
                     scale, iters, final_row)


def streaming_attention_bwd(q, k, v, g, av, bv, scale, iters=3, final_row=True):
    return by_device(streaming_attention_bwd_cuda, streaming_attention_bwd_plain, q, k, v, g,
                     av, bv, scale, iters, final_row)


class StreamingAttention(torch.autograd.Function):
    """``(q [B, H, N, D], k, v [B, H, M, D], scale, iters, final_row)`` →
    the Sinkhorn attention output ``[B, H, N, D]``, with the hand-derived
    backward from q, k, v and the residual vectors (no N×M matrix, no
    output kept)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, iters, final_row):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, av, bv = streaming_attention_fwd(q, k, v, scale, iters, final_row)
        ctx.save_for_backward(q, k, v, av, bv)
        ctx.cfg = (scale, iters, final_row)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, av, bv = ctx.saved_tensors
        dq, dk, dv = streaming_attention_bwd(q, k, v, g.contiguous(), av, bv, *ctx.cfg)
        return dq, dk, dv, None, None, None
