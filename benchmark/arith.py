"""The benchmark's arithmetic: the H100's peaks, the attention calls' least
times (roofline bounds), percentiles and spreads, and the union of device
intervals. Nothing here touches a device or imports the program.

The bound arithmetic is a copy of ``chip_smoke.py``'s ``chain_passes``,
``bound_ms`` and ``attention_work``, with its streaming and rect Sinkhorn
calls' bytes and passes (``phase_stream_times``, ``phase_sinkhorn_times``),
and the residual-row counts a copy of the port's ``num_vecs``, ``_n_avecs``
and ``_rect_rows``; they are kept here so that the yardstick does not move
when the program does.
"""

from __future__ import annotations

import math
import statistics

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): bf16 on the
# tensor cores, float32 outside them, device memory
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def chain_passes(robust: bool, iters: int, final_row: bool) -> tuple[int, int, int]:
    """N² passes of the Sinkhorn chain over each matrix: (forward, reverse,
    rank-1 terms of the reverse)."""
    if not robust:
        return 0, 0, 0
    return iters - 1 + final_row + iters, final_row + 2 * iters - 1, final_row + 2 * iters - 1


def residual_rows(robust: bool, iters: int, final_row: bool) -> int:
    """Float32 rows of N a (image, head) item keeps for the backward: the
    log-sum-exp, and with Sinkhorn the row and column scalings of each
    pass."""
    if not robust:
        return 1
    return max(iters - 1, 0) + int(final_row) + iters + 1


def bound_ms(nbytes: float, mma_flops: float, f32_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rates (products on the
    bf16 tensor cores, the elementwise and reduction passes in float32),
    and which of the two binds."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = mma_flops / PEAK_BF16 + f32_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_work(items, n, d, dv, in_bytes, out_bytes, robust, iters, final_row,
                   bias_add, m=None):
    """(fwd, bwd) bounds of one attention call over ``items`` (image, head)
    matrices of n queries and m keys (m = n by default): the bytes each
    direction must move once, its products (fwd q·kᵀ and attn·v; bwd the
    q·kᵀ recompute, dV, dA, dQ, dK, and o/a when robust), each counted once
    whatever a kernel recomputes, and its float32 passes over the n·m
    entries (scale and bias, softmax, the chain, the softmax vjp, the rank-1
    terms)."""
    fp, bp, nt = chain_passes(robust, iters, final_row)
    nm = items * n * (n if m is None else m)
    fwd = bound_ms(in_bytes[0] + out_bytes[0], 2 * nm * (d + dv),
                   nm * (4 + bias_add + 2 * fp))
    bwd_products = 3 * d + (3 if robust else 2) * dv
    bwd = bound_ms(in_bytes[1] + out_bytes[1], 2 * nm * bwd_products,
                   nm * (3 + bias_add + 2 * bp + 4 + 2 * nt))
    return fwd, bwd


def call_bounds(call: dict, robust: bool, iters: int, final_row: bool, act_bytes: int = 2):
    """(fwd, bwd) bounds of one attention call described by the data of a
    configuration file. ``kind`` "packed": q|k|v read from one ``[batch,
    tokens, 3·heads·dim]`` tensor, ``[batch, tokens, heads·dim]`` out.
    ``kind`` "windowed": q, k, v ``[windows_total, heads, tokens, dim]``
    apart, a float32 ``[windows, heads, tokens, tokens]`` bias added to the
    logits, and its gradient written back. ``kind`` "streaming": q ``[batch,
    heads, tokens, dim]``, k and v ``[batch, heads, keys, dim]``, out like
    q, and the float32 residuals ``[batch·heads, 1 + rows, tokens]`` and
    ``[batch·heads, iters, keys]`` (the streaming kernels'). ``kind``
    "rect": the Sinkhorn softmax alone, float32 logits ``[batch, heads,
    tokens, keys]`` in and weights out (their gradients back), with the
    same residuals, and no products."""
    kind, h, n = call["kind"], call["heads"], call["tokens"]
    if kind == "packed":
        b, d = call["batch"], call["dim"]
        qkv = b * n * 3 * h * d * act_bytes
        out = b * n * h * d * act_bytes
        vecs = b * h * residual_rows(robust, iters, final_row) * n * 4
        return attention_work(b * h, n, d, d, (qkv, qkv + out + vecs), (out + vecs, qkv),
                              robust, iters, final_row, 0)
    if kind == "windowed":
        bw, d = call["windows_total"], call["dim"]
        qk = 2 * bw * h * n * d * act_bytes
        v = bw * h * n * d * act_bytes
        vecs = bw * h * residual_rows(robust, iters, final_row) * n * 4
        bias = call["windows"] * h * n * n * 4
        return attention_work(bw * h, n, d, d, (qk + v + bias, qk + 2 * v + vecs + bias),
                              (v + vecs, qk + v + bias), robust, iters, final_row, 1)
    if kind in ("streaming", "rect"):
        items, m = call["batch"] * h, call["keys"]
        # rows over the queries: the log-sum-exp and each row pass's
        # scaling; over the keys: each column pass's
        rows, cols = (max(iters - 1, 0) + int(final_row), iters) if robust else (0, 0)
        vecs = items * ((1 + rows) * n + cols * m) * 4
        if kind == "rect":
            mat, nm = items * n * m * 4, items * n * m
            fp, bp, nt = chain_passes(robust, iters, final_row)
            return (bound_ms(2 * mat + vecs, 0, nm * (4 + 2 * fp)),
                    bound_ms(3 * mat + vecs, 0, nm * (3 + 2 * bp + 4 + 2 * nt)))
        d = call["dim"]
        qkv = items * (n + 2 * m) * d * act_bytes
        out = items * n * d * act_bytes
        return attention_work(items, n, d, d, (qkv, qkv + out + vecs), (out + vecs, qkv),
                              robust, iters, final_row, 0, m=m)
    raise ValueError(f"unknown attention call kind {kind!r}")


def step_attention_bound_ms(calls: list[dict], robust: bool, iters: int,
                            final_row: bool) -> float:
    """The least time of one train step's attention calls, forward and
    backward, each call ``count`` times."""
    total = 0.0
    for call in calls:
        (fwd, _), (bwd, _) = call_bounds(call, robust, iters, final_row)
        total += call["count"] * (fwd + bwd)
    return total


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of ``[start, end]`` that no interval covers."""
    out, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(s, e) for s, e in out if e > s]
