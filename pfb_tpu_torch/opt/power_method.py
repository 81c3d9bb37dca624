"""Power method for the spectral norm of the Hessian approximation
(counterpart of pfb_tpu/opt/power_method.py). A Python loop replaces
the JAX while_loop; the convergence test reads eps every iteration
(counted, while a torch profiler runs, under ``pm.iters`` and
``sync.pm.eps``: utils/profiling.py)."""

import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.utils.logging import get_logger
from pfb_tpu_torch.utils.profiling import count


def power_method(A, imsize, b0=None, tol=1e-5, maxit=250, generator=None,
                 dtype=torch.float64, device=None, verbosity=0,
                 report_freq=100):
    """Dominant eigenvalue (and eigenvector) of the symmetric operator A:
    b <- A(b_prev); beta = <b_prev, b> / <b_prev, b_prev>; b <- b/|b|;
    eps = |beta - beta_prev| / beta_prev. The start vector is ``b0`` or
    normal draws from ``generator`` (a seeded torch.Generator on
    ``device``, None meaning the card when there is one; seed 42 when
    None)."""
    if b0 is None:
        device = as_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(42)
        b = torch.randn(imsize, generator=generator, dtype=dtype,
                        device=device)
    else:
        b = b0.to(dtype)
    b = b / torch.linalg.vector_norm(b)
    beta = torch.ones((), dtype=dtype, device=b.device)
    eps = 1.0
    k = 0
    log = get_logger("PM")
    while eps > tol and k < maxit:
        bnew = A(b)
        bnorm = torch.linalg.vector_norm(bnew)
        betap = beta
        beta = torch.sum(b * bnew) / torch.sum(b * b)
        b = bnew / bnorm
        count("pm.iters")
        count("sync.pm.eps")
        eps = float(torch.abs(beta - betap) / betap)
        k += 1
        if verbosity > 1 and report_freq and k % report_freq == 0:
            log.info(f"pm: iter {k}  eps {eps:.3e}")
    if verbosity >= 1:
        log.info(f"pm: done at iter {k}, eps {eps:.3e}")
    return beta, b


def make_power_method_fused(apply, tol=1e-5, maxit=250, verbosity=0,
                            report_freq=100):
    """Power method around ``apply(x, consts)`` (the shape of the JAX
    package's fused solver): ``pm(b0, consts)`` returns (beta, b), run in
    the operator's output dtype."""
    def pm(b0, consts):
        out_dt = apply(b0, consts).dtype
        return power_method(lambda z: apply(z, consts), tuple(b0.shape),
                            b0=b0.to(out_dt), tol=tol, maxit=maxit,
                            dtype=out_dt, device=b0.device,
                            verbosity=verbosity, report_freq=report_freq)
    return pm
