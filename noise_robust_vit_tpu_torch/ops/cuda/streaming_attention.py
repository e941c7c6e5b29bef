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

Two branches of kernels compute the function, chosen by shape and dtype
before the call (``streaming_branch``): the split kernels
(``csrc/streaming_split_{fwd,bwd}.cu``; bf16, D = 64, 1 to 8 iterations: an
item's query rows split over many blocks, the column sums as per-split
partials summed in split order, every product on the tensor cores) and the
tile kernels (``csrc/streaming_attention_{fwd,bwd}.cu``; every other shape
and dtype the gate takes: one block an item, walking its query tiles).
Both write the same residuals, so either backward takes either forward's.
``splits=`` makes the plain versions mirror the split kernels' order of
sums: per-split column partials added in split order, the ``[M, D]``
gradients (dv's T, dk) and dv's column term key-major, over every query at
once.

Three pieces live here, as in ``sinkhorn_softmax.py``: the plain PyTorch
versions, the ctypes wrappers of both branches' kernels with launch counts
(``launches``, and by branch ``launches_split`` / ``launches_tile``), and
the autograd function ``StreamingAttention``.
"""

from __future__ import annotations

import torch

from ..sinkhorn import clamped_recip
from .build import LaunchCounts, by_device, check_operand, ptr, raise_on, stream

__all__ = [
    "StreamingAttention",
    "launches",
    "launches_split",
    "launches_tile",
    "streaming_attention_bwd",
    "streaming_attention_bwd_cuda",
    "streaming_attention_bwd_plain",
    "streaming_attention_fwd",
    "streaming_attention_fwd_cuda",
    "streaming_attention_fwd_plain",
    "streaming_attention_supported",
    "streaming_branch",
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
launches_split = LaunchCounts()
launches_tile = LaunchCounts()

# The split branch (csrc/streaming_split.cuh): bf16, D = 64; the rank-1
# terms of the backward (nt = 2·iters − 1 + final_row, at most kTerms = 16,
# each factor row split into bf16 hi + lo). The library says how many
# splits of the query rows its sweeps make (nrv_streaming_split_splits).
_SPLIT_D = 64
_SPLIT_TERMS = 2 * MAX_ITERS


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


def streaming_branch(n: int, m: int, d: int, dtype: torch.dtype, iters: int = 3) -> str:
    """The kernels a CUDA call of this shape and dtype goes to: "split"
    (bf16, D = 64, 1 to 8 iterations, any N and M the gate takes: M up to
    ~2000 at D = 64) or "tile" (every other call the gate takes: float32,
    other widths)."""
    return ("split" if dtype == torch.bfloat16 and d == _SPLIT_D and 1 <= iters <= MAX_ITERS
            else "tile")


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


def _split_bounds(n: int, splits: int) -> list[tuple[int, int]]:
    rows = -(-n // int(splits))
    return [(a, min(n, a + rows)) for a in range(0, n, rows)]


def _split_colsum(x, bounds):
    """Σ over the rows of ``x [K, N, M]`` as one partial a split, the
    partials added in split order."""
    total = None
    for a, b in bounds:
        part = x[:, a:b].sum(1)
        total = part if total is None else total + part
    return total


def _fwd_split_plain(q, k, v, scale, iters, final_row, splits):
    """The forward in the split kernels' order of sums: whole rows, column
    sums as per-split partials."""
    sw = _Sweeps(q, k, v, scale, None)
    bounds = _split_bounds(sw.n, splits)
    s = sw.logits(0)
    mx = s.amax(-1, keepdim=True)
    lse = (mx + torch.log(torch.exp(s - mx).sum(-1, keepdim=True)))[..., 0]
    en = torch.exp(s - lse[..., None])
    b = clamped_recip(_split_colsum(en, bounds))
    b_rows, a_rows = [b], []
    for _ in range(1, iters):
        a = clamped_recip((en * b[:, None, :]).sum(-1))
        a_rows.append(a)
        b = clamped_recip(_split_colsum(en * a[..., None], bounds))
        b_rows.append(b)
    if final_row:
        a_rows.append(clamped_recip((en * b[:, None, :]).sum(-1)))
    a_out = a_rows[-1] if a_rows else torch.ones_like(lse)
    out = a_out[..., None] * torch.bmm(en, sw.v * b[..., None])
    av = torch.stack([lse] + a_rows, dim=1)
    bv = torch.stack(b_rows, dim=1)[:, :, :sw.m]
    return out.reshape(q.shape).to(v.dtype), av.contiguous(), bv.contiguous()


def streaming_attention_fwd_plain(q, k, v, scale, iters=3, final_row=True, tile=None,
                                  splits=None):
    """Forward in eager torch over query tiles of ``tile`` rows (the whole
    N by default): ``(out [B, H, N, D]`` in v's dtype, ``av [B·H, 1 + n_av,
    N]``, ``bv [B·H, iters, M]`` float32). With ``splits``, the split
    kernels' order of sums over that many splits of the rows instead."""
    if splits is not None:
        return _fwd_split_plain(q, k, v, scale, iters, final_row, splits)
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


def _bwd_split_plain(q, k, v, g, av, bv, scale, iters, final_row, splits):
    """The backward in the split kernels' order of sums: T, dv's column term
    and dk key-major (every query at once), the chain's column sums as
    per-split partials, ρ as Σ_j en·(the rank-1 stack)."""
    sw = _Sweeps(q, k, v, scale, None)
    bounds = _split_bounds(sw.n, splits)
    kb, d = sw.q.shape[0], sw.shape[3]
    n_av = _n_avecs(iters, final_row)
    g32 = g.reshape(kb, sw.n, d).float()
    lse = av[:, 0]
    a_rows = [av[:, 1 + j] for j in range(n_av)]
    b_rows = [_pad_rows(bv[:, i], sw.m_pad, 1.0) for i in range(iters)]
    a_f = a_rows[-1] if n_av else torch.ones_like(lse)
    b_f = b_rows[-1]
    bfv = sw.v * b_f[..., None]
    en = sw.en(0, lse)
    ag = a_f[..., None] * g32
    go = (ag * torch.bmm(en, bfv)).sum(-1)
    tacc = torch.bmm(en.transpose(1, 2), ag)
    dv = b_f[..., None] * tacc
    db = (sw.v * tacc).sum(-1)
    terms = []
    if final_row:
        du_f = -go * a_f
        db = db + torch.bmm(du_f[:, None, :], en)[:, 0]
        terms.append((du_f, b_f))
    for i in range(iters - 1, 0, -1):
        dw = -db * b_rows[i] * b_rows[i]
        a_prev = a_rows[i - 1]
        terms.append((a_prev, dw))
        da = torch.bmm(en, dw[..., None])[..., 0]
        if not final_row and i == iters - 1:
            da = da + go / a_f
        du = -da * a_prev * a_prev
        terms.append((du, b_rows[i - 1]))
        db = _split_colsum(en * du[..., None], bounds)
    terms.append((torch.ones_like(lse), -db * b_rows[0] * b_rows[0]))
    r1 = torch.bmm(torch.stack([u for u, _ in terms], dim=2),
                   torch.stack([w for _, w in terms], dim=1))
    rho = (en * r1).sum(-1) + go
    ds = en * (r1 + torch.bmm(ag, bfv.transpose(1, 2)) - rho[..., None])
    dq = scale * torch.bmm(ds, sw.k)
    dk = scale * torch.bmm(ds.transpose(1, 2), sw.q)
    return (dq.reshape(q.shape).to(q.dtype), dk[:, :sw.m].reshape(k.shape).to(k.dtype),
            dv[:, :sw.m].reshape(v.shape).to(v.dtype))


def streaming_attention_bwd_plain(q, k, v, g, av, bv, scale, iters=3, final_row=True,
                                  tile=None, splits=None):
    """Backward in eager torch from the residuals: ``(dq, dk, dv)`` in q's,
    k's and v's dtypes. Mirrors ``_stream_bwd_kernel``: B1, the reverse
    chain's fused sweeps, then the final sweep with the rank-1 stack. With
    ``splits``, the split kernels' order of sums instead."""
    if splits is not None:
        return _bwd_split_plain(q, k, v, g, av, bv, scale, iters, final_row, splits)
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
# CUDA kernels (csrc/streaming_split_{fwd,bwd}.cu, csrc/streaming_attention_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(name, t, like, dtype=None, shape=None):
    check_operand("streaming attention", name, t, like, dtype, shape)


def _check_inputs(q, k, v, iters, branch):
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
    rule = streaming_branch(n, m, d, q.dtype, iters)
    chosen = branch or rule
    if chosen not in ("split", "tile"):
        raise ValueError(f"streaming attention kernel: no branch {chosen!r}")
    if chosen == "split" and rule != "split":
        raise ValueError(f"streaming attention kernel: the split branch does not take "
                         f"N={n} M={m} D={d} {q.dtype} iters={iters}")
    if not q.is_cuda:
        raise ValueError("streaming attention kernel: q must be a CUDA tensor")
    return b * h, n, m, d, chosen


def _count(chosen, direction):
    for c in (launches, launches_split if chosen == "split" else launches_tile):
        setattr(c, direction, getattr(c, direction) + 1)


def _residual_shapes(kb, n, m, iters, final_row):
    return (kb, 1 + _n_avecs(iters, final_row), n), (kb, iters, m)


def streaming_attention_fwd_cuda(q, k, v, scale, iters=3, final_row=True, branch=None):
    """Launch the forward kernels of the branch ``streaming_branch`` picks
    (or ``branch``); returns ``(out, av, bv)`` like the plain version.
    Raises on anything the kernels do not take. Scratch of the split
    branch: the column partials [K, S, M] float32."""
    from .build import load_library

    kb, n, m, d, chosen = _check_inputs(q, k, v, iters, branch)
    out = torch.empty_like(q)
    shape_a, shape_b = _residual_shapes(kb, n, m, iters, final_row)
    av = torch.empty(shape_a, dtype=torch.float32, device=q.device)
    bv = torch.empty(shape_b, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        if chosen == "split":
            splits = load_library().nrv_streaming_split_splits(n)
            part = torch.empty(kb, splits, m, dtype=torch.float32, device=q.device)
            err = load_library().nrv_streaming_split_fwd(
                ptr(q), ptr(k), ptr(v), ptr(out), ptr(av), ptr(bv), ptr(part), kb, n, m, d,
                float(scale), int(iters), int(final_row), stream(q.device))
        else:
            err = load_library().nrv_streaming_attention_fwd(
                ptr(q), ptr(k), ptr(v), ptr(out), ptr(av), ptr(bv), _DTYPE_CODES[q.dtype], kb,
                n, m, d, float(scale), int(iters), int(final_row), _tile(m, d, iters),
                stream(q.device))
    raise_on(err, f"streaming attention forward kernel ({chosen})")
    _count(chosen, "fwd")
    return out, av, bv


def streaming_attention_bwd_cuda(q, k, v, g, av, bv, scale, iters=3, final_row=True,
                                 branch=None):
    """Launch the backward kernels of the branch, as the forward; returns
    ``(dq, dk, dv)``. Scratch, float32: the tile branch's [M, D]
    accumulator of each item and its row vectors (go and up to ``iters``
    du-vectors); the split branch's column partials [K, S, M], rank-1
    factors [K, nt, N] and [K, nt, M], go and ρ [K, N], and in bf16 the
    factors split into hi + lo rows [K, N, 32] and [K, M, 32]."""
    from .build import load_library

    kb, n, m, d, chosen = _check_inputs(q, k, v, iters, branch)
    _check("g", g, q, shape=q.shape)
    for name, t, shape in zip(("av", "bv"), (av, bv),
                              _residual_shapes(kb, n, m, iters, final_row)):
        _check(name, t, q, torch.float32, shape)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        if chosen == "split":
            nt = 2 * iters - 1 + int(final_row)
            part = torch.empty(kb, load_library().nrv_streaming_split_splits(n), m, **f32)
            u, w = torch.empty(kb, nt, n, **f32), torch.empty(kb, nt, m, **f32)
            go, rho = torch.empty(kb, n, **f32), torch.empty(kb, n, **f32)
            us = torch.empty(kb, n, 2 * _SPLIT_TERMS, dtype=torch.bfloat16, device=q.device)
            ws = torch.empty(kb, m, 2 * _SPLIT_TERMS, dtype=torch.bfloat16, device=q.device)
            err = load_library().nrv_streaming_split_bwd(
                ptr(q), ptr(k), ptr(v), ptr(g), ptr(av), ptr(bv), ptr(dq), ptr(dk), ptr(dv),
                ptr(part), ptr(u), ptr(w), ptr(go), ptr(rho), ptr(us), ptr(ws), kb, n, m, d,
                float(scale), int(iters), int(final_row), stream(q.device))
        else:
            acc = torch.empty(kb, m, d, **f32)
            rows = torch.empty(kb, 1 + iters, n, **f32)
            err = load_library().nrv_streaming_attention_bwd(
                ptr(q), ptr(k), ptr(v), ptr(g), ptr(av), ptr(bv), ptr(dq), ptr(dk), ptr(dv),
                ptr(acc), ptr(rows), _DTYPE_CODES[q.dtype], kb, n, m, d, float(scale),
                int(iters), int(final_row), _tile(m, d, iters), stream(q.device))
    raise_on(err, f"streaming attention backward kernel ({chosen})")
    _count(chosen, "bwd")
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
