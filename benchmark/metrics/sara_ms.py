"""Device milliseconds of SARA a primal-dual iteration: the CUDA-event
intervals of the ``sara.analysis``, ``sara.prox`` and ``sara.synthesis``
spans over the iterations counted under ``pd.iters``."""

from harness.program import device_ms, per_count, tracer


def read(ctx):
    t = tracer()
    return None if t is None else \
        per_count(t, device_ms(t[0], "sara."), "pd.iters")
