"""Device time a step of the rectangular Sinkhorn softmax calls (kind "rect"
in the configuration: the rect logits-interface kernels, B 5), under their
autograd Function and its backward node, copies inside them included."""

from benchmark.metrics._by_kind import device_ms


def read(ctx):
    return device_ms(ctx, "rect")
