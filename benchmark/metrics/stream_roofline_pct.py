"""The streaming calls' least time (kind "streaming": bytes once over
3.35 TB/s, or products over 989 TFLOP/s plus float32 passes over 67 TFLOP/s,
the larger, forward and backward) over ``stream_ms``, in %. A profiled step
must hold the configured count of forward and backward calls."""

from benchmark.metrics._by_kind import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "streaming")
