"""Conjugate-gradient solvers (counterpart of pfb_tpu/opt/pcg.py).

The JAX ``lax.while_loop``s are Python loops here; each iteration of
:func:`cg`, :func:`pcg` (one system, global inner products,
backtracking) and :func:`pcg_bands` (per-band step sizes, backtracking
and convergence freezing) reads its stopping test from the device.
:func:`pcg_bands_hostloop` reads it every ``check_freq`` iterations
only, and the fixed-iteration solvers (``tol <= 0``) and the CG-fused
loop of :func:`make_pcg_bands_fused` (on the PSF kernel K2) read nothing
inside the loop. Also :func:`pcg_psf`, the klean flux mop's solve, and
:func:`cg_dct` over dicts of grids.

While a torch profiler runs (utils/profiling.py), :func:`pcg` counts its
iterations under ``pcg.iters`` and its readbacks under
``sync.pcg.backtrack`` (the line search's test) and ``sync.pcg.eps``.
"""

import torch

from pfb_tpu_torch.ops.psf import hessian_psf_cube
from pfb_tpu_torch.opt.primal_dual import norm_diff
from pfb_tpu_torch.utils.logging import get_logger
from pfb_tpu_torch.utils.profiling import count

log = get_logger("PCG")


def _vdot(a, b):
    return torch.sum(a * b)


def cg(A, b, x0=None, tol=1e-5, maxit=500):
    """Textbook CG; converges on the absolute residual norm r.r, as the
    reference does."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = A(x) - b
    p = -r
    rnorm = _vdot(r, r)
    k = 0
    while float(rnorm) > tol and k < maxit:
        Ap = A(p)
        alpha = rnorm / _vdot(p, Ap)
        x = x + alpha * p
        r = r + alpha * Ap
        rnorm_next = _vdot(r, r)
        beta = rnorm_next / rnorm
        p = beta * p - r
        rnorm = rnorm_next
        k += 1
    return x


def _safe_div(num, den):
    """num / den where den != 0, else 0 (the JAX package's guard of the
    exactly converged case)."""
    one = torch.ones((), dtype=den.dtype, device=den.device)
    return torch.where(den != 0, num / torch.where(den == 0, one, den),
                       torch.zeros_like(num))


def _report(name, k, eps, report_freq, verbosity):
    if verbosity >= 2 and report_freq and k % report_freq == 0:
        log.info(f"{name}: iter {k}  eps {float(torch.max(eps)):.3e}")


def _grows(rnorm_next, rnorm):
    """The backtracking test, read from the device."""
    count("sync.pcg.backtrack")
    return bool(rnorm_next > rnorm)


def pcg(A, b, x0=None, M=None, tol=1e-5, maxit=500, minit=100,
        backtrack=True, return_resid=False, verbosity=0, report_freq=10,
        name="pcg"):
    """PCG with preconditioner M, at least ``minit`` iterations and a
    backtracking line search that shrinks alpha by 0.75 while the
    preconditioned residual norm grows; converges on the relative change
    of x (norm_diff)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        def M(v):
            return v
    r = A(x) - b
    y = M(r)
    p = -y
    eps = 1.0
    k = 0
    while (eps > tol or k < minit) and k < maxit:
        xp, rp = x, r
        Ap = A(p)
        rnorm = _vdot(r, y)
        alpha = _safe_div(rnorm, _vdot(p, Ap))
        x = xp + alpha * p
        r = rp + alpha * Ap
        y = M(r)
        rnorm_next = _vdot(r, y)
        while backtrack and _grows(rnorm_next, rnorm):
            alpha = alpha * 0.75
            x = xp + alpha * p
            r = rp + alpha * Ap
            y = M(r)
            rnorm_next = _vdot(r, y)
        beta = _safe_div(rnorm_next, rnorm)
        p = beta * p - y
        eps_t = norm_diff(x, xp)
        _report(name, k, eps_t, report_freq, verbosity)
        count("pcg.iters")
        count("sync.pcg.eps")
        eps = float(eps_t)
        k += 1
    if verbosity >= 1:
        log.info(f"{name}: done at iter {k}  eps {eps:.3e}")
    if return_resid:
        return x, r
    return x


def _band_vdot(a, b):
    """Per-band inner product over the trailing (nx, ny) axes."""
    return torch.sum(a * b, dim=(-2, -1), keepdim=True)


def pcg_bands(A, b, x0=None, M=None, tol=1e-5, maxit=500, minit=100,
              backtrack=True, verbosity=0, report_freq=10, name="pcg"):
    """Per-band PCG: nband independent systems at once (``A`` acts
    band-wise on (nband, nx, ny) cubes), each with its own alpha, beta,
    backtracking and convergence; a converged band freezes (zero step).
    ``tol <= 0`` runs ``maxit`` plain iterations with no freezing."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    has_M = M is not None
    r = A(x0) - b
    y = M(r) if has_M else r
    p = -y
    rnorm = _band_vdot(r, y)
    x = x0

    if tol <= 0:
        for _ in range(maxit):
            Ap = A(p)
            alpha = _safe_div(rnorm, _band_vdot(p, Ap))
            x = x + alpha * p
            r = r + alpha * Ap
            y = M(r) if has_M else r
            rnorm_next = _band_vdot(r, y)
            p = _safe_div(rnorm_next, rnorm) * p - y
            rnorm = rnorm_next
        if verbosity >= 1:
            log.info(f"{name}: done at iter {maxit}")
        return x

    dt = torch.promote_types(b.dtype, torch.float32)
    eps = torch.ones_like(b[:, :1, :1], dtype=dt)
    active = torch.ones_like(b[:, :1, :1], dtype=torch.bool)
    k = 0
    while k < maxit and bool(active.any()):
        xp = x
        Ap = A(p)
        actf = active.to(rnorm.dtype)
        alpha = _safe_div(rnorm, _band_vdot(p, Ap)) * actf

        def step(alpha):
            x_ = xp + alpha * p
            r_ = r + alpha * Ap
            y_ = M(r_) if has_M else r_
            return x_, r_, y_, _band_vdot(r_, y_)

        xn, rn, yn, rnorm_next = step(alpha)
        if backtrack:
            grow = active & (rnorm_next > rnorm)
            while bool(grow.any()):
                alpha = torch.where(grow, alpha * 0.75, alpha)
                xn, rn, yn, rnorm_next = step(alpha)
                grow = active & (rnorm_next > rnorm)

        beta = torch.where(active, _safe_div(rnorm_next, rnorm),
                           torch.ones_like(rnorm))
        p = beta * p - actf * yn
        num = torch.sum((xn - xp) ** 2, dim=(-2, -1), keepdim=True)
        den = 1e-12 + torch.sum(xn ** 2, dim=(-2, -1), keepdim=True)
        eps = torch.where(active, torch.sqrt(num / den), eps)
        active = active & ((eps > tol) | (k + 1 < minit))
        rnorm = torch.where(actf > 0, rnorm_next, rnorm)
        x, r, y = xn, rn, yn
        _report(name, k, eps, report_freq, verbosity)
        k += 1
    if verbosity >= 1:
        log.info(f"{name}: done at iter {k}  eps "
                 f"{float(torch.max(eps)):.3e}")
    return x


def pcg_bands_hostloop(A, b, x0=None, M=None, tol=1e-5, maxit=500,
                       minit=100, verbosity=0, report_freq=10, name="pcg",
                       check_freq=4):
    """Per-band PCG without backtracking or freezing, the convergence
    test read from the device only every ``check_freq`` iterations from
    ``minit`` on and at the last iteration (never when ``tol <= 0``).
    The solve may run up to ``check_freq - 1`` iterations past
    convergence; those only polish the solution."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        def M(v):
            return v
    r = A(x) - b
    y = M(r)
    p = -y
    k = 0
    for k in range(1, maxit + 1):
        Ap = A(p)
        rnorm = _band_vdot(r, y)
        alpha = _safe_div(rnorm, _band_vdot(p, Ap))
        xn = x + alpha * p
        r = r + alpha * Ap
        y = M(r)
        p = _safe_div(_band_vdot(r, y), rnorm) * p - y
        check = tol > 0 and k >= minit and \
            ((k - minit) % check_freq == 0 or k == maxit)
        report = verbosity > 1 and report_freq and k % report_freq == 0
        if check or report:
            num = torch.sum((xn - x) ** 2, dim=(-2, -1), keepdim=True)
            den = 1e-12 + torch.sum(xn ** 2, dim=(-2, -1), keepdim=True)
            eps = float(torch.max(torch.sqrt(num / den)))
            if report:
                log.info(f"{name}: iter {k}  eps {eps:.3e}")
        x = xn
        if check and eps < tol:
            break
    if verbosity >= 1:
        log.info(f"{name}: done at iter {k}")
    return x


def make_pcg_bands_fused(apply, M=None, tol=1e-5, maxit=500, minit=100,
                         backtrack=True, verbosity=0, report_freq=10,
                         name="pcg", apply_cg=None, cg_scale=None):
    """:func:`pcg_bands` around an operator ``apply(x, consts)`` with the
    operator's constants as a call argument (the shape of the JAX
    package's fused solver): ``solve = make_pcg_bands_fused(hess.apply)``,
    then ``x = solve(b, x0, hess.consts)``.

    With ``apply_cg`` (``make_psf_convolve_pallas`` exposes ``.apply_cg``
    and ``.cg_scale``), ``tol <= 0`` and no ``M``, the loop runs on the
    CG-fused PSF kernel K2: one launch forms the direction p = beta p_prev
    - r, conv(p) and the per-band [p . conv(p), p . p]; ``cg_scale =
    (wsum, sigmainv)`` folds the operator's scaling into alpha and the r
    update. The (nband, 1, 1) step sizes stay on the device and nothing
    is read from it inside the loop. The same arithmetic as
    :func:`pcg_bands`'s fixed-iteration loop."""
    if apply_cg is not None and tol <= 0 and M is None:
        ws, sig = cg_scale if cg_scale is not None else (None, None)

        def solve_cg(b, x0, consts):
            r = apply(x0, consts) - b
            rnorm0 = _band_vdot(r, r)
            rnorm = rnorm0
            x = x0
            p = torch.zeros_like(r)
            beta = torch.zeros_like(rnorm0)
            for k in range(maxit):
                pn, conv, pap = apply_cg(p, r, beta, consts)
                papc, ppc = pap[:, :, 0:1], pap[:, :, 1:2]
                if ws is not None:
                    papc = papc / ws
                    conv = conv / ws
                if sig is not None:
                    papc = papc + sig * ppc
                    conv = conv + sig * pn
                alpha = _safe_div(rnorm, papc)
                x = x + alpha * pn
                r = r + alpha * conv
                rnorm_next = _band_vdot(r, r)
                beta = _safe_div(rnorm_next, rnorm).contiguous()
                rnorm, p = rnorm_next, pn
                _report(name, k, _safe_div(rnorm, rnorm0), report_freq,
                        verbosity)
            if verbosity >= 1:
                eps = float(torch.max(_safe_div(rnorm, rnorm0)))
                log.info(f"{name}: done at iter {maxit}  eps {eps:.3e}")
            return x

        return solve_cg

    def solve(b, x0, consts):
        return pcg_bands(lambda z: apply(z, consts), b, x0=x0, M=M, tol=tol,
                         maxit=maxit, minit=minit, backtrack=backtrack,
                         verbosity=verbosity, report_freq=report_freq,
                         name=name)

    return solve


def _leaves(t):
    """Tensors of a nest of dicts, lists and tuples (dict keys sorted, as
    jax.tree orders them)."""
    if isinstance(t, dict):
        return [v for k in sorted(t) for v in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [v for u in t for v in _leaves(u)]
    return [t]


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *u) for u in zip(*trees))
    return fn(*trees)


def cg_dct(A, b, x, tol=1e-5, maxit=500):
    """CG over a nest of grids (dicts keyed on field, then (t, b)) for
    multi-field imaging: ``A`` maps and returns nests shaped like ``b``
    and ``x``; inner products add over every leaf. No preconditioner or
    backtracking; converges on the absolute r.r. Returns (x, r)."""
    def vdot(a, c):
        return sum(float(torch.sum(u.conj() * v).real)
                   for u, v in zip(_leaves(a), _leaves(c)))

    r = _tree_map(lambda ax, bx: ax - bx, A(x), b)
    p = _tree_map(lambda u: -u, r)
    rnorm = vdot(r, r)
    k = 0
    while rnorm > tol and k < maxit:
        Ap = A(p)
        alpha = rnorm / vdot(p, Ap)
        x = _tree_map(lambda u, v: u + alpha * v, x, p)
        r = _tree_map(lambda u, v: u + alpha * v, r, Ap)
        rnorm_next = vdot(r, r)
        beta = rnorm_next / rnorm
        p = _tree_map(lambda u, v: beta * u - v, p, r)
        rnorm = rnorm_next
        k += 1
    return x, r


def pcg_psf(psfhat, b, x0, beam=None, lastsize=None, sigmainv=0.0, tol=1e-5,
            maxit=500, minit=100, backtrack=True, verbosity=0,
            report_freq=10):
    """Per-band PCG against the PSF Hessian (the klean flux mop):
    sigmainv > 0 adds Tikhonov regularisation and the diagonal
    preconditioner M(x) = x / sigmainv."""
    if lastsize is None:
        lastsize = psfhat.shape[-2]

    def A(x):
        return hessian_psf_cube(x, psfhat, beam=beam, lastsize=lastsize,
                                sigmainv=sigmainv)

    M = (lambda x: x / sigmainv) if sigmainv > 0 else None
    return pcg_bands(A, b, x0=x0, M=M, tol=tol, maxit=maxit, minit=minit,
                     backtrack=backtrack, verbosity=verbosity,
                     report_freq=report_freq)
