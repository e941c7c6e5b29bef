"""Host time a step inside ``TrainState.train_step``, over the traced run's
unprofiled stretch (host clock around each call). When the device is behind,
the host waits in the launch queue and this reads near the step time."""


def read(ctx):
    if not ctx.stretch["steps"]:
        return None
    return 1e3 * ctx.stretch["host_s"] / ctx.stretch["steps"]
