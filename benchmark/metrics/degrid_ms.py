"""Device milliseconds of the forward degridding (K6 and the scatter of
its output to the visibilities) an application of the stacked pg
Hessian: the CUDA-event intervals of the ``pg.degrid`` spans (every
band) over the applications counted under ``pg.applications``."""

from harness.program import device_ms, per_count, tracer


def read(ctx):
    t = tracer()
    return None if t is None else \
        per_count(t, device_ms(t[0], "pg.degrid"), "pg.applications")
