"""Images a second of the traced run's unprofiled stretch, by the host's
clock: the cell's wall rate, read per layer where the host binds the step
and so sets the rate, which then follows the host's speed from run to run
too widely for an end-to-end bound."""


def read(ctx):
    if not ctx.stretch["steps"]:
        return None
    return ctx.stretch["images"] / ctx.stretch["wall_s"]
