"""Device time a step of the biased attention calls (kind "biased" in the
configuration: the biased kernels, B 3, on either branch), under their
autograd Function and its backward node, copies inside them included."""

from benchmark.metrics._by_kind import device_ms


def read(ctx):
    return device_ms(ctx, "biased")
