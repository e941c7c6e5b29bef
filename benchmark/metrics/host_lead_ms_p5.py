"""The 5th percentile of the host's lead over the device, in ms, at every
boundary of the port's step tracer (``begin``, ``forward_end``,
``backward_end``, ``optimizer_end``) of the traced stretch's steps but its
first 5 (the launch queue filling after the opening synchronise): the
device's time of a boundary, on the host's clock, minus the host's. Near 0,
the device waited for the host at 5% of the boundaries or more."""

from benchmark import arith
from benchmark.spans import leads_ms, records_of


def read(ctx):
    leads = leads_ms(records_of(ctx))
    return arith.percentile(leads, 5) if leads else None
