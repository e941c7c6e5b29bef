"""The rect calls' least time (kind "rect": float32 logits in and weights
out, and their gradients, once over 3.35 TB/s, or the float32 passes over
67 TFLOP/s, the larger, forward and backward) over ``rect_ms``, in %. A
profiled step must hold the configured count of forward and backward
calls."""

from benchmark.metrics._by_kind import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "rect")
