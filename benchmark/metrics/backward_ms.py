"""The median over the traced stretch's steps of the device interval
``forward_end → backward_end`` of the port's step tracer, in ms:
``zero_grad`` and the backward, the device's idle time within them
included."""

import statistics

from benchmark.spans import phase_ms, records_of


def read(ctx):
    records = records_of(ctx)
    return statistics.median(phase_ms(records, "backward")) if records else None
