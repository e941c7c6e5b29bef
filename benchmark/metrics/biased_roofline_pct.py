"""The biased calls' least time (kind "biased": bytes once over 3.35 TB/s,
or products over 989 TFLOP/s plus float32 passes over 67 TFLOP/s, the
larger, forward and backward; ``_biased_bound``) over ``biased_ms``, in %.
A profiled step must hold the configured count of forward and backward
calls; none at all leaves the metric out (the op left the path)."""

from benchmark.metrics._biased_bound import step_bound_ms
from benchmark.metrics._by_kind import calls_of, functions_of


def read(ctx):
    calls = calls_of(ctx, "biased")
    if not calls:
        return None
    functions = functions_of(calls, "biased")
    ms = ctx.trace.device_ms(functions)
    counts = [ctx.trace.host_op_count(name) for name in functions]
    if ms <= 0 or not any(counts):
        return None
    want = sum(c["count"] for c in calls)
    if any(n != want for n in counts):
        raise RuntimeError(f"a profiled step holds {counts} calls of {functions}, "
                           f"not {want} each")
    sched = ctx.cfg["sinkhorn"]
    bound = step_bound_ms(calls, ctx.mix["attention"] == "sinkhorn", sched["iters"],
                          sched["final_row_norm"])
    return 100.0 * bound / ms
