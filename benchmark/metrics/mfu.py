"""The whole step's share of the card's dense bf16 peak: the configuration's
analytic train FLOPs per image times the unprofiled stretch's images per
second, over 989 TFLOP/s, in %."""

from benchmark import arith
from benchmark.harness import reference_module


def read(ctx):
    if not ctx.stretch["steps"]:
        return None
    flops = reference_module(ctx.cfg).train_flops_per_image(ctx.cfg)
    rate = ctx.stretch["images"] / ctx.stretch["wall_s"]
    return 100.0 * flops * rate / arith.PEAK_BF16
