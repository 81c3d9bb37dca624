"""Milliseconds a spotless major of the power method (span
``spotless.power_method``, once a call; it ends in its last readback)."""

from harness.program import host_ms, per_unit, tracer


def read(ctx):
    t = tracer()
    ms = None if t is None else host_ms(t[0], {"spotless.power_method"})
    return None if ms is None else per_unit(ctx, ms)
