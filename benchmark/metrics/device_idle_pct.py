"""The share of a step in which the device is idle, in %: one minus the
device's busy time a profiled step (the union of its device ops' intervals,
from the profile of device activity alone) over the step period of the
traced run's unprofiled stretch (the sum of the intervals between its step
events over its steps). The two come from different steps of one run: the
profiler's own host cost stretches a step that the host binds, so the
profiled steps' own period (``device.busy_s`` against ``device.window_s``)
reads a higher idle share than a step of the window has."""


def read(ctx):
    if ctx.trace.busy_s <= 0 or not ctx.stretch["steps"]:
        return None
    step_ms = sum(ctx.stretch["step_ms"]) / ctx.stretch["steps"]
    return 100.0 * (1.0 - 1e3 * ctx.trace.busy_s / ctx.trace.steps / step_ms)
