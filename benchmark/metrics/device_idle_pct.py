"""The share of the profiled steps in which the device is idle, in %: one
minus the device's busy time (the union of its device ops' intervals) over
the span from the first device op to the last, both from the profile of
device activity alone, so both from the same steps. Recording device
activity costs the host some time a launch, which stretches a step that the
host binds: in such a cell this reads above the idle share of an unprofiled
step. None where the profile holds no device op."""


def read(ctx):
    if ctx.trace.busy_s <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
