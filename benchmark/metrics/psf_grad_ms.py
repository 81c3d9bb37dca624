"""Device milliseconds of the primal-dual gradient (the PSF Hessian, K1
on the spotless cell) an iteration: the CUDA-event intervals of the
``pd.grad`` spans over the iterations counted under ``pd.iters``."""

from harness.program import device_ms, per_count, tracer


def read(ctx):
    t = tracer()
    return None if t is None else \
        per_count(t, device_ms(t[0], "pd.grad"), "pd.iters")
