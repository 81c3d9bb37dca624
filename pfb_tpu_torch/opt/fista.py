"""FISTA: accelerated proximal gradient with backtracking (counterpart
of pfb_tpu/opt/fista.py; reference pfb/opt/fista.py:11-100, the legacy
NNLS initialisation). Solves min_x f(x) + lam g(x) given grad f and
prox_g. A Python loop replaces the JAX while_loops; the backtracking and
convergence tests read the device every iteration, as theirs do.
"""

import math

import torch

from pfb_tpu_torch.opt.primal_dual import norm_diff


def _rvdot(a, b):
    return torch.sum(a.conj() * b).real if a.is_complex() else \
        torch.sum(a * b)


def fista(fprime, prox, x0, beta, tol=1e-5, maxit=500):
    """Accelerated proximal-gradient iteration.

    fprime: x -> (fval, gradient) of the smooth term; prox: (x, step) ->
    prox step of the nonsmooth term; beta: Lipschitz estimate of grad f
    (step 1/beta), doubled by backtracking while the quadratic upper
    bound is violated, as the reference does. Returns x."""
    x = y = x0
    t = 1.0
    beta = float(beta)
    eps = 1.0
    k = 0
    while eps > tol and k < maxit:
        xp = x
        fid, gradn = fprime(y)

        def trial(beta):
            x_ = prox(y - gradn / beta, 1.0 / beta)
            fidn, _ = fprime(x_)
            delta = x_ - y
            flam = fid + _rvdot(gradn, delta) + \
                0.5 * beta * _rvdot(delta, delta)
            return x_, fidn, flam

        x, fidn, flam = trial(beta)
        while bool(fidn > flam):
            beta *= 2.0
            x, fidn, flam = trial(beta)

        tp = t
        t = (1.0 + math.sqrt(1.0 + 4.0 * tp**2)) / 2.0
        y = x + (tp - 1.0) / t * (x - xp)
        eps = float(norm_diff(x, xp))
        k += 1
    return x
