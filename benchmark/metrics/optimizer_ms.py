"""Device time a step of the kernels launched under AdamW's step
(``torch.optim``'s ``Optimizer.step#AdamW.step`` range)."""

SPAN = "Optimizer.step#AdamW.step"


def read(ctx):
    ms = ctx.trace.device_ms([SPAN])
    return ms if ms > 0 else None
