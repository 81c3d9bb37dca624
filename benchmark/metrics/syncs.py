"""Blocking readbacks a unit: the sum of the program's ``sync.*``
counters (a solver's convergence test, the worker's copies, the pg
gridder's per-spread copy)."""

from harness.program import per_unit, tracer


def read(ctx):
    t = tracer()
    n = None if t is None else \
        [v for k, v in t[1].items() if k.startswith("sync.")]
    return per_unit(ctx, sum(n)) if n else None
