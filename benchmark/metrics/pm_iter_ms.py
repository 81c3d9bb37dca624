"""Milliseconds a power-method iteration: the ``spotless.power_method``
span over the iterations counted under ``pm.iters`` (each ends in its
convergence readback, so the host time covers the device's)."""

from harness.program import host_ms, per_count, tracer


def read(ctx):
    t = tracer()
    return None if t is None else \
        per_count(t, host_ms(t[0], {"spotless.power_method"}), "pm.iters")
