"""Primal-dual (Chambolle-Pock) solver with positivity for the SARA
backward step (counterpart of pfb_tpu/opt/primal_dual.py).

Solves argmin_x (xbar - x).H A (xbar - x)/2 + lam ||Psi.H x||_21,
optionally s.t. x >= 0. Step sizes:
    sigma = L / (2 gamma) / nu
    tau   = 0.9 / (L / (2 gamma) + sigma nu^2)
:func:`primal_dual` tests convergence every iteration, as the JAX
while_loop does; :func:`primal_dual_hostloop` every ``check_freq``
iterations, as the JAX package's host loop does (the solver spotless
runs on the general PSF kernel K11 and on the fft fallback of
``engine="pallas"``).

While a torch profiler runs (utils/profiling.py) each iteration counts
under ``pd.iters``, each readback of eps under ``sync.pd.eps``, and the
iteration's parts are device spans: ``sara.analysis`` (psiH),
``sara.prox`` (the dual update), ``sara.synthesis`` (psi) and
``pd.grad`` (the Hessian).
"""

import torch

from pfb_tpu_torch.ops.prox import dual_update_21m
from pfb_tpu_torch.utils.logging import get_logger
from pfb_tpu_torch.utils.profiling import count, span


def norm_diff(x, xp):
    """Relative change sqrt(|x-xp|^2 / (1e-12 + |x|^2))
    (counterpart of pfb_tpu/opt/pcg.py:norm_diff)."""
    return torch.sqrt(torch.sum((x - xp) ** 2) / (1e-12 + torch.sum(x**2)))


def apply_positivity(x, positivity):
    """0 - none; 1 - clip negatives; 2 - zero every pixel column where
    any band is <= 0."""
    if positivity == 1:
        return torch.clamp(x, min=0.0)
    if positivity == 2:
        msk = torch.any(x <= 0.0, dim=0, keepdim=True)
        return torch.where(msk, torch.zeros_like(x), x)
    return x


def _pd_steps(L, gamma, nu, sigma):
    """Chambolle-Pock step sizes (sigma, tau)."""
    L = float(L)
    sigma = L / (2.0 * gamma) / nu if sigma is None else float(sigma)
    return sigma, 0.9 / (L / (2.0 * gamma) + sigma * nu**2)


def _pd_iterate(x, v, w, lam, psiH, psi, grad, sigma, tau, positivity):
    """One iteration: (x, v, eps) with eps the relative change of x, a
    device scalar."""
    count("pd.iters")
    dev = x.device
    # a span a part; each temporary goes where the one expression
    # vnew = ...(psiH(x)); xout = psi(2 vnew - v) + grad(x) dropped it,
    # so the peak memory stays that expression's
    with span("sara.analysis", device=dev):
        coeffs = psiH(x)
    with span("sara.prox", device=dev):
        vnew = dual_update_21m(v, coeffs, lam, sigma=sigma, weight=w)
    del coeffs
    with span("sara.synthesis", device=dev):
        xout = psi(2.0 * vnew - v)
    with span("pd.grad", device=dev):
        g = grad(x)
    xout = xout + g
    del g
    xnew = apply_positivity(x - tau * xout, positivity)
    return xnew, vnew, norm_diff(xnew, x)


def primal_dual(x, v, lam, psiH, psi, L, l1weight, grad, reweighter=None,
                nu=1.0, sigma=None, tol=1e-5, maxit=1000, positivity=1,
                gamma=1.0, maxreweight=50, verbosity=0, report_freq=50):
    """Returns (x, v, l1weight, niters). When the relative change drops
    below tol and a reweighter is given, the l1 weights are refreshed
    (up to maxreweight times) and iteration continues."""
    sigma, tau = _pd_steps(L, gamma, nu, sigma)
    lam = float(lam)
    log = get_logger("PD")
    w = l1weight
    nrw = 0
    k = 0
    eps = 1.0
    while k < maxit:
        x, v, eps_t = _pd_iterate(x, v, w, lam, psiH, psi, grad, sigma, tau,
                                  positivity)
        count("sync.pd.eps")
        eps = float(eps_t)
        k += 1
        if verbosity > 1 and report_freq and k % report_freq == 0:
            log.info(f"pd: iter {k}  eps {eps:.3e}")
        if eps < tol:
            if reweighter is not None and nrw < maxreweight:
                w = reweighter(x)
                nrw += 1
            else:
                break
    if verbosity >= 1:
        log.info(f"pd: done at iter {k}, eps {eps:.3e}")
    return x, v, w, k


def primal_dual_hostloop(x, v, lam, psiH, psi, L, l1weight, grad,
                         reweighter=None, nu=1.0, sigma=None, tol=1e-5,
                         maxit=1000, positivity=1, gamma=1.0,
                         maxreweight=50, verbosity=0, report_freq=50,
                         check_freq=4):
    """:func:`primal_dual` with the convergence test (and so the
    reweight-on-converge restart) read from the device only every
    ``check_freq`` iterations and at the last one, never when ``tol <=
    0``: the solve may run up to ``check_freq - 1`` iterations past
    convergence before it reweights or stops. ``check_freq=1`` gives
    :func:`primal_dual`'s iterates."""
    sigma, tau = _pd_steps(L, gamma, nu, sigma)
    lam = float(lam)
    log = get_logger("PD")
    w = l1weight
    nrw = 0
    k = 0
    while k < maxit:
        x, v, eps = _pd_iterate(x, v, w, lam, psiH, psi, grad, sigma, tau,
                                positivity)
        k += 1
        if verbosity > 1 and report_freq and k % report_freq == 0:
            log.info(f"pd: iter {k}  eps {float(eps):.3e}")
        if tol > 0 and (k % check_freq == 0 or k == maxit):
            count("sync.pd.eps")
            if not float(eps) < tol:
                continue
            if reweighter is not None and nrw < maxreweight:
                w = reweighter(x)
                nrw += 1
            else:
                break
    if verbosity >= 1:
        log.info(f"pd: done at iter {k}")
    return x, v, w, k


def make_primal_dual_fused(apply, psiH, psi, nu, rmsfactor, alpha=4.0,
                           sigma=None, tol=1e-5, maxit=1000, positivity=1,
                           gamma=1.0, maxreweight=50, verbosity=0,
                           report_freq=50):
    """:func:`primal_dual` around a Hessian ``apply(x, consts)`` with the
    data term, l1 weights and coefficient rms as call arguments (the
    shape of the JAX package's fused solver).

    ``solve(x, v, data, l1weight, lam, L, rms_comps, consts,
    do_reweight=...)`` returns (x, v, l1weight, niters)."""
    def solve(x, v, data, l1weight, lam, L, rms_comps, consts, *,
              do_reweight=False):
        def grad(z):
            return apply(z, consts) - data

        reweighter = None
        if do_reweight:
            def reweighter(z):
                return l1reweight_func(psiH, rmsfactor, rms_comps, z,
                                       alpha)
        return primal_dual(x, v, lam, psiH, psi, L, l1weight, grad,
                           reweighter=reweighter, nu=nu, sigma=sigma,
                           tol=tol, maxit=maxit, positivity=positivity,
                           gamma=gamma, maxreweight=maxreweight,
                           verbosity=verbosity, report_freq=report_freq)
    return solve


def l1reweight_func(psiH, rmsfactor, rms_comps, model, alpha=4):
    """Weights ~1 for components well above the coefficient-space rms,
    growing toward (1+rmsfactor) for small ones."""
    mcomps = torch.abs(psiH(model).sum(dim=0))
    return (1 + rmsfactor) / (1 + mcomps**alpha / rms_comps**alpha)
