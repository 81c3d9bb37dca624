"""Milliseconds a PCG iteration of the fluxmop call: its ``fluxmop.pcg``
span less the construction of the PCG operator inside it (the
``fluxmop.plan`` span whose ``which`` is "pcg") over the iterations
counted under ``pcg.iters`` (each ends in its convergence readback)."""

from harness.program import host_ms, per_count, tracer


def read(ctx):
    t = tracer()
    if t is None:
        return None
    ms = host_ms(t[0], {"fluxmop.pcg"})
    if ms is not None:
        ms -= sum(r.host_ms for r in t[0] if r.name == "fluxmop.plan"
                  and r.attrs.get("which") == "pcg")
    return per_count(t, ms, "pcg.iters")
