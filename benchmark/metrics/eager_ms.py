"""Device time a step of everything but the optimizer and the attention
Functions: the models' GEMMs, convolutions, LayerNorms, copies, casts,
rolls and the loss."""

from benchmark.harness import attention_of
from benchmark.metrics.optimizer_ms import SPAN


def read(ctx):
    total = ctx.trace.device_ms()
    if total <= 0:
        return None
    att = attention_of(ctx.cfg, ctx.mix)
    attn = ctx.trace.device_ms(att["functions"]) if att else 0.0
    return total - ctx.trace.device_ms([SPAN]) - attn
