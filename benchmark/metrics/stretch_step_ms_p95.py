"""The 95th percentile of the intervals between the step events of the
traced run's unprofiled stretch, in ms: the window's step tail, kept
without a bound where the host binds the step and slips in episodes."""

from benchmark import arith


def read(ctx):
    return arith.percentile(ctx.stretch["step_ms"], 95) if ctx.stretch["steps"] else None
