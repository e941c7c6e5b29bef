"""Kernel launches a step in the profiled stretch (memory copies and sets
not counted)."""


def read(ctx):
    n = ctx.trace.kernels_per_step()
    return n if n > 0 else None
