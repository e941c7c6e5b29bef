"""The kernels' algorithm in eager PyTorch, over a leading ``K`` = (image ×
head) dim: the plain versions that CPU tensors take and that the card's
checks hold the CUDA kernels against.

Counterpart of ``noise_robust_vit_tpu/ops/pallas/sinkhorn_attention.py``
(``_fwd_math_batched``, ``_add_bias``, ``_restore_vec_rows``,
``_reverse_chain_inner``, ``_bwd_math_batched``) at ``n == n_pad``: the
same unnormalized ``e = exp(s − m)`` with the row normalizer folded into the
scaling vectors, the same residual rows and the same hand-derived reverse
chain as the kernels. ``s = scale·q·kᵀ + bias``, the bias added after the
scale.

The residual stack is ``[K, R, N]`` float32: the Sinkhorn a-rows
(``iters − 1`` iteration rows, plus the final row when ``final_row``), the
``iters`` b-rows, and the softmax log-normalizer as the last row (robust);
the log-normalizer alone (vanilla).
"""

from __future__ import annotations

import torch

from ..sinkhorn import clamped_recip

__all__ = ["attention_bwd_plain", "attention_fwd_plain", "num_vecs"]


def num_vecs(iters: int, final_row: bool, robust: bool) -> int:
    """Residual rows (``block_attention.py::_num_vecs``)."""
    if not robust:
        return 1
    return max(iters - 1, 0) + int(final_row) + iters + 1


def _logits(q, k, scale, bias):
    s = torch.bmm(q, k.transpose(1, 2)) * scale
    return s if bias is None else s + bias


def attention_fwd_plain(q, k, v, scale, robust=False, iters=3, final_row=True,
                        bias=None):
    """``q, k [K, N, D]``, ``v [K, N, DV]`` float32, ``bias [K, N, N]`` or
    None; returns ``(out [K, N, DV], vecs [K, R, N])`` in float32."""
    kb, n, _ = q.shape
    s = _logits(q, k, scale, bias)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    r = e.sum(dim=-1, keepdim=True)  # [K, N, 1]
    lse_row = (m + torch.log(r)).reshape(kb, 1, n)
    inv_r = 1.0 / r
    a_scale = inv_r
    a_rows, b_rows = [], []
    if robust:
        b_row = torch.ones(kb, 1, n, dtype=torch.float32, device=q.device)
        for i in range(iters):
            # i == 0: rowsum(softmax) ≡ 1, so the first row norm is skipped
            if i > 0:
                a = clamped_recip((e * b_row).sum(-1, keepdim=True) * inv_r)
                a_rows.append(a.reshape(kb, 1, n))
                a_scale = a * inv_r
            b_row = clamped_recip((e * a_scale).sum(-2, keepdim=True))
            b_rows.append(b_row)
        if final_row:
            a = clamped_recip((e * b_row).sum(-1, keepdim=True) * inv_r)
            a_rows.append(a.reshape(kb, 1, n))
            a_scale = a * inv_r
        v = v * b_row.reshape(kb, n, 1)
    out = torch.bmm(e, v) * a_scale
    return out, torch.cat(a_rows + b_rows + [lse_row], dim=1)


def _reverse_chain_inner(attn, dA, da, db_row, row_direct, as_r, bs_r, iters,
                         final_row):
    """``sinkhorn_attention.py::_reverse_chain_inner`` (default path): returns
    ``inner`` with ``ds = attn ⊙ inner`` for ``attn [K, NR, NC]``. ``as_r``
    are ROW vectors ``[K, 1, NR]`` and ``bs_r`` ``[K, 1, NC]``; the rank-1
    terms are collected and applied in one bmm."""
    kb, nr = attn.shape[0], attn.shape[1]
    a_fin = as_r[-1].reshape(kb, nr, 1)
    terms = []
    svec = torch.zeros_like(da)
    da_live = not final_row
    if final_row:
        tmp = da * a_fin
        dr = -(tmp * a_fin)
        terms.append((dr.reshape(kb, 1, nr), bs_r[-1]))
        svec = -tmp
        db_row = db_row + (attn * dr).sum(-2, keepdim=True)
    for t in range(iters - 1, -1, -1):
        dc = db_row * -(bs_r[t + 1] * bs_r[t + 1])
        m_dc = (attn * dc).sum(-1, keepdim=True)
        terms.append((as_r[t], dc))
        if t == 0:
            svec = svec + m_dc
            break
        a_t = as_r[t].reshape(kb, nr, 1)
        svec = svec + a_t * m_dc
        da_eff = (da + m_dc) if (da_live and t == iters - 1) else m_dc
        tmp = da_eff * a_t
        svec = svec - tmp
        dr = -(tmp * a_t)
        terms.append((dr.reshape(kb, 1, nr), bs_r[t]))
        db_row = (attn * dr).sum(-2, keepdim=True)
    row_term = row_direct + svec
    u_mat = torch.cat([u for u, _ in terms], dim=1)  # [K, T, N]
    v_mat = torch.cat([w for _, w in terms], dim=1)
    return (dA - row_term) + torch.bmm(u_mat.transpose(1, 2), v_mat)


def attention_bwd_plain(q, k, v, g, vecs, scale, robust=False, iters=3,
                        final_row=True, bias=None):
    """Backward from the stored residuals (``vecs [K, R, N]``), float32
    ``[K, N, *]`` operands as the forward's and ``g [K, N, DV]``; returns
    ``(dq, dk, dv, ds)`` with ``ds [K, N, N]`` the logits' gradient (the
    bias's, before any sum over images). Mirrors ``_bwd_math_batched``."""
    kb, n, _ = q.shape
    attn = torch.exp(_logits(q, k, scale, bias) - vecs[:, -1][:, :, None])
    if not robust:
        dv = torch.bmm(attn.transpose(1, 2), g)
        dA = torch.bmm(g, v.transpose(1, 2))
        ds = attn * (dA - (dA * attn).sum(-1, keepdim=True))
    else:
        ka = max(iters - 1, 0) + int(final_row)
        ones = torch.ones(kb, 1, n, dtype=torch.float32, device=q.device)
        as_r = [ones] + [vecs[:, j][:, None, :] for j in range(ka)]
        bs_r = [ones] + [vecs[:, ka + j][:, None, :] for j in range(iters)]
        a_fin = as_r[-1].reshape(kb, n, 1)
        b_fin = bs_r[-1].reshape(kb, n, 1)
        bv = b_fin * v
        o_over_a = torch.bmm(attn, bv)
        ag = a_fin * g
        t1 = torch.bmm(attn.transpose(1, 2), ag)  # Aᵀ(a⊙G)
        dv = b_fin * t1
        dA = torch.bmm(ag, bv.transpose(1, 2))
        da = (g * o_over_a).sum(-1, keepdim=True)
        db = (t1 * v).sum(-1, keepdim=True)
        row_direct = a_fin * da
        inner = _reverse_chain_inner(attn, dA, da, db.reshape(kb, 1, n),
                                     row_direct, as_r, bs_r, iters, final_row)
        ds = attn * inner
    dq = scale * torch.bmm(ds, k)
    dk = scale * torch.bmm(ds.transpose(1, 2), q)
    return dq, dk, dv, ds
