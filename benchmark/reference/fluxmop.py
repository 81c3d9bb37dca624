"""Plain fluxmop: one forward step with the exact vis-space Hessian.

From a zero model, solve (R.H W R / wsum + s I) u = residual by
conjugate gradients (at least ``minit`` and at most ``maxit``
iterations, stopping on the relative change of u below ``tol``; where a
step would raise r.r, its length is cut by 0.75 until it does not),
then model = gamma u and residual = dirty - R.H W R model / wsum.
"""

import torch

from reference.spotless import REFERENCE


def _vdot(a, b):
    return torch.sum(a * b)


def pcg(A, b, tol, maxit, minit):
    x = torch.zeros_like(b)
    r = -b
    p = -r
    eps, k = 1.0, 0
    while (eps > tol or k < minit) and k < maxit:
        xp, rp = x, r
        Ap = A(p)
        rnorm = _vdot(r, r)
        pAp = _vdot(p, Ap)
        alpha = rnorm / pAp if float(pAp) != 0 else torch.zeros_like(pAp)
        x = xp + alpha * p
        r = rp + alpha * Ap
        rnext = _vdot(r, r)
        while bool(rnext > rnorm):
            alpha = alpha * 0.75
            x = xp + alpha * p
            r = rp + alpha * Ap
            rnext = _vdot(r, r)
        beta = rnext / rnorm if float(rnorm) != 0 else torch.zeros_like(
            rnorm)
        p = beta * p - r
        eps = float(torch.sqrt(_vdot(x - xp, x - xp) /
                               (1e-12 + _vdot(x, x))))
        k += 1
    return x, k


def fluxmop(obs, sigmainv=1e-4, gamma=0.9, cg_tol=1e-5, cg_maxit=100,
            cg_minit=100, num=REFERENCE):
    """The model and residual cubes (float64 numpy) of one step from an
    :class:`reference.imaging.Observation`."""
    dt = num.dtype
    dirty = num.rnd(obs.dirty.to(dt))

    def A(x):
        return obs.hessian(x, num.rnd).to(dt) + sigmainv * x

    update, iters = pcg(A, dirty, cg_tol, cg_maxit, cg_minit)
    model = gamma * update
    residual = dirty - obs.hessian(model, num.rnd).to(dt)
    return dict(model=model.double().cpu().numpy(),
                residual=residual.double().cpu().numpy(),
                dirty_max=float(obs.dirty.abs().max()), cg_iters=iters)
