"""The whole step's share of the card's dense bf16 peak by the device's own
time: the configuration's analytic train FLOPs a step over the device's
busy time a step (the profile of device activity alone, as
``device_step_ms``), over 989 TFLOP/s, in %. Beside the kernels' rooflines
that move ``device_step_ms``, it bounds what taking a kernel off the path
can claim. None where the profile holds no device op."""

from benchmark import arith
from benchmark.harness import reference_module


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    flops = reference_module(ctx.cfg).train_flops_per_image(ctx.cfg) * ctx.cfg["batch"]
    return 100.0 * flops * ctx.trace.steps / ctx.trace.busy_s / arith.PEAK_BF16
