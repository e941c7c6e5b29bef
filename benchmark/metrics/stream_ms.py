"""Device time a step of the streaming attention calls (kind "streaming" in
the configuration: the split streaming kernels, B 7), under their autograd
Function and its backward node, copies inside them included."""

from benchmark.metrics._by_kind import device_ms


def read(ctx):
    return device_ms(ctx, "streaming")
