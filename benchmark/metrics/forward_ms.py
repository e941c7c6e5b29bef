"""The median over the traced stretch's steps of the device interval
``begin → forward_end`` of the port's step tracer, in ms: the model's
forward and the loss, the device's idle time within them included."""

import statistics

from benchmark.spans import phase_ms, records_of


def read(ctx):
    records = records_of(ctx)
    return statistics.median(phase_ms(records, "forward")) if records else None
