"""Device milliseconds of the adjoint's spread and fold (K4 + K5) an
application of the stacked pg Hessian: the CUDA-event intervals of the
``pg.spread_fold`` spans (every band) over the applications counted
under ``pg.applications``."""

from harness.program import device_ms, per_count, tracer


def read(ctx):
    t = tracer()
    return None if t is None else \
        per_count(t, device_ms(t[0], "pg.spread_fold"), "pg.applications")
