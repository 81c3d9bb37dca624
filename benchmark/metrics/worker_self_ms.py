"""Milliseconds a unit (a spotless major, a fluxmop call) of the
workers' root spans (``spotless.call``, ``fluxmop.call``) that their
direct children do not cover: the worker's time that no stage span
names."""

from harness.program import per_unit, tracer

ROOTS = ("spotless.call", "fluxmop.call")


def read(ctx):
    t = tracer()
    if t is None:
        return None
    recs = t[0]
    roots = {r.id: r for r in recs if r.parent is None and r.name in ROOTS}
    if not roots:
        return None
    covered = sum(r.host_ms for r in recs if r.parent in roots)
    return per_unit(ctx, sum(r.host_ms for r in roots.values()) - covered)
