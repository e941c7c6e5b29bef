"""The attention calls' least time (the configuration's calls: bytes once
over 3.35 TB/s, or products over 989 TFLOP/s plus float32 passes over
67 TFLOP/s, the larger, forward and backward) over their measured device
time a step, in %. The profiled steps must hold exactly the configured
number of forward and backward Function calls; none at all leaves the
metric out (the op left the path)."""

from benchmark import arith
from benchmark.harness import attention_of


def read(ctx):
    att = attention_of(ctx.cfg, ctx.mix)
    if att is None:
        return None
    ms = ctx.trace.device_ms(att["functions"])
    calls = [ctx.trace.host_op_count(name) for name in att["functions"]]
    if ms <= 0 or not any(calls):
        return None
    want = sum(c["count"] for c in att["calls"])
    if any(c != want for c in calls):
        raise RuntimeError(f"a profiled step holds {calls} calls of {att['functions']}, "
                           f"not {want} each")
    sched = ctx.cfg["sinkhorn"]
    bound = arith.step_attention_bound_ms(att["calls"], ctx.mix["attention"] == "sinkhorn",
                                          sched["iters"], sched["final_row_norm"])
    return 100.0 * bound / ms
