"""Device milliseconds of the w-plane work an application of the
stacked pg Hessian: the CUDA-event intervals of the ``pg.wplanes``
spans (w screens and plane transforms, both ways, every band) over the
applications counted under ``pg.applications``."""

from harness.program import device_ms, per_count, tracer


def read(ctx):
    t = tracer()
    return None if t is None else \
        per_count(t, device_ms(t[0], "pg.wplanes"), "pg.applications")
