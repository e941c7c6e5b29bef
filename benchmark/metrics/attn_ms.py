"""Device time a step of the kernels launched under the configuration's
attention autograd Functions and their backward nodes (the names in the
configuration file, under the mix's attention mode), copies inside them
included."""

from benchmark.harness import attention_of


def read(ctx):
    att = attention_of(ctx.cfg, ctx.mix)
    if att is None:
        return None
    ms = ctx.trace.device_ms(att["functions"])
    return ms if ms > 0 else None
