"""The least time of the biased calls (kind "biased" in a configuration:
the biased kernels over one float32 bias ``[1, heads, tokens, tokens]``
that the whole batch shares, where v and the output may be wider than q
and k: ``dim`` for q and k, ``dim_v`` for v). ``arith.call_bounds``'s kind
"windowed" takes one width for q, k and v, so it would misstate the bytes
and the attention·v products here; this is the same count with v's own
width, built from ``arith``'s pieces."""

from benchmark import arith


def call_bounds(call: dict, robust: bool, iters: int, final_row: bool, act_bytes: int = 2):
    """(fwd, bwd) bounds of one biased call: q and k ``[batch, heads,
    tokens, dim]`` and v ``[batch, heads, tokens, dim_v]`` in, with the bias
    read once for the batch; out ``[batch, heads, tokens, dim_v]`` and the
    float32 residual rows. The backward reads q, k, v, the output's
    gradient, the rows and the bias, and writes dq, dk, dv and the bias's
    gradient."""
    b, h, n, d, dv = call["batch"], call["heads"], call["tokens"], call["dim"], call["dim_v"]
    qk = 2 * b * h * n * d * act_bytes
    v = b * h * n * dv * act_bytes  # v, the output and their gradients alike
    vecs = b * h * arith.residual_rows(robust, iters, final_row) * n * 4
    bias = h * n * n * 4
    return arith.attention_work(b * h, n, d, dv, (qk + v + bias, qk + 2 * v + vecs + bias),
                                (v + vecs, qk + v + bias), robust, iters, final_row, 1)


def step_bound_ms(calls: list[dict], robust: bool, iters: int, final_row: bool) -> float:
    """The least time of one train step's biased calls, forward and
    backward, each call ``count`` times."""
    total = 0.0
    for call in calls:
        (fwd, _), (bwd, _) = call_bounds(call, robust, iters, final_row)
        total += call["count"] * (fwd + bwd)
    return total
