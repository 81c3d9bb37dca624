"""Host seconds of the pg plans (span ``pg.plan.host``: w geometry,
tiles, the binning of native/plan.cc) a construction of the exact
Hessian (a worker's ``spotless.plan`` or ``fluxmop.plan`` span)."""

from harness.program import host_ms, tracer

PLANS = {"spotless.plan", "fluxmop.plan"}


def read(ctx):
    t = tracer()
    if t is None:
        return None
    ms = host_ms(t[0], {"pg.plan.host"})
    n = sum(r.name in PLANS for r in t[0])
    return 1e-3 * ms / n if ms is not None and n else None
