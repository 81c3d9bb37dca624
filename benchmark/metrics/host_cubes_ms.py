"""Host milliseconds a unit of the workers' numpy stages: the cubes
from the dataset store (``*.cubes``) and the work between device stages
(``*.host``: rms, eps, best model, reweighting rms, write-back)."""

from harness.program import host_ms, per_unit, tracer

NAMES = {"spotless.cubes", "spotless.host", "fluxmop.cubes", "fluxmop.host"}


def read(ctx):
    t = tracer()
    ms = None if t is None else host_ms(t[0], NAMES)
    return None if ms is None else per_unit(ctx, ms)
