"""pfb_tpu_torch's host-loop and fused solvers against pfb_tpu:
pcg_bands_hostloop, make_pcg_bands_fused (the generic branch and the
CG-fused branch on the K2 plain version), primal_dual_hostloop, cg_dct
and fista, with equal iteration counts (operator calls counted on both
sides) and float64 iterates at 1e-8 relative unless stated."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops.fft import make_psfhat as make_psfhat_j
from pfb_tpu.ops.psf import hessian_psf_cube as hess_j
from pfb_tpu.ops.psf import make_psf_convolve_pallas as mpcp_j
from pfb_tpu.ops.psi import make_psi as make_psi_j
from pfb_tpu.ops.psi import psi_dot as psi_dot_j
from pfb_tpu.ops.psi import psi_hdot as psi_hdot_j
from pfb_tpu.opt.fista import fista as fista_j
from pfb_tpu.opt.pcg import cg_dct as cg_dct_j
from pfb_tpu.opt.pcg import make_pcg_bands_fused as fused_j
from pfb_tpu.opt.pcg import pcg_bands_hostloop as hostloop_j
from pfb_tpu.opt.primal_dual import l1reweight_func as rw_j
from pfb_tpu.opt.primal_dual import primal_dual as pd_j
from pfb_tpu.opt.primal_dual import primal_dual_hostloop as pdh_j
from pfb_tpu_torch.ops.fft import make_psfhat
from pfb_tpu_torch.ops.psf import hessian_psf_cube, make_psf_convolve_pallas
from pfb_tpu_torch.ops.psi import make_psi, psi_dot, psi_hdot
from pfb_tpu_torch.opt.fista import fista
from pfb_tpu_torch.opt.pcg import (cg_dct, make_pcg_bands_fused, pcg_bands,
                                   pcg_bands_hostloop)
from pfb_tpu_torch.opt.primal_dual import (l1reweight_func,
                                           primal_dual_hostloop)

torch.set_num_threads(1)
NB, NX = 2, 32


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _psf(nb, nx):
    xg = np.arange(2 * nx) - nx
    xx, yy = np.meshgrid(xg, xg, indexing="ij")
    psf = np.zeros((nb, 2 * nx, 2 * nx))
    for b in range(nb):
        psf[b] = 0.4 * np.exp(-0.5 * (xx**2 + yy**2) / (3.0 + b) ** 2)
        psf[b, nx, nx] += 0.6
    return psf


class Counted:
    """An operator that counts its applications."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a):
        self.n += 1
        return self.fn(*a)


@pytest.fixture(scope="module")
def hess():
    """The same Tikhonov PSF Hessian in both packages, and b = A(model)."""
    psf = _psf(NB, NX)
    ph_j = make_psfhat_j(jnp.asarray(psf))
    ph_t = make_psfhat(torch.as_tensor(psf))
    model = np.zeros((NB, NX, NX))
    model[:, NX // 3, NX // 2] = 1.0
    model[:, 2 * NX // 3, NX // 4] = 0.5

    def A_j(x):
        return hess_j(x, ph_j, lastsize=2 * NX, sigmainv=1e-3)

    def A_t(x):
        return hessian_psf_cube(x, ph_t, lastsize=2 * NX, sigmainv=1e-3)

    b = np.array(A_j(jnp.asarray(model)))
    return dict(A_j=A_j, A_t=A_t, b=b, model=model, ph_j=ph_j)


@pytest.mark.parametrize("tol,minit,maxit", [(1e-6, 5, 61), (0.0, 0, 12)])
def test_pcg_bands_hostloop_matches_jax(hess, tol, minit, maxit):
    """Convergence read every 4 iterations from minit (and at maxit): the
    same number of matvecs and the same solution."""
    Aj, At = Counted(hess["A_j"]), Counted(hess["A_t"])
    xj = hostloop_j(Aj, jnp.asarray(hess["b"]), tol=tol, minit=minit,
                    maxit=maxit)
    xt = pcg_bands_hostloop(At, torch.as_tensor(hess["b"]), tol=tol,
                            minit=minit, maxit=maxit)
    assert At.n == Aj.n
    if tol > 0:
        assert (At.n - 1 - minit) % 4 == 0 and At.n - 1 < maxit
    else:
        assert At.n == maxit + 1
    # CG carries the two FFT libraries' float64 rounding through ~60
    # iterations at a condition number of ~1e4 (sigmainv 1e-3)
    assert _rel(xt.numpy(), xj) < 1e-6


def test_make_pcg_bands_fused_matches_jax(hess):
    """The generic branch (tol > 0): pcg_bands around apply(x, consts),
    1e-6 as above."""
    kw = dict(tol=1e-10, maxit=60, minit=10, backtrack=False)
    solve_j = fused_j(lambda z, c: hess_j(z, c["ph"], lastsize=2 * NX,
                                          sigmainv=1e-3), **kw)
    solve_t = make_pcg_bands_fused(lambda z, c: c["A"](z), **kw)
    b = hess["b"]
    xj = solve_j(jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                 {"ph": hess["ph_j"]})
    xt = solve_t(torch.as_tensor(b), torch.zeros((NB, NX, NX),
                                                 dtype=torch.float64),
                 {"A": hess["A_t"]})
    assert _rel(xt.numpy(), xj) < 1e-6


def _cg_case(dtype):
    """tests/test_fused_solvers.py:169-201's problem: 2 bands at 128^2,
    per-band wsum, sigmainv 1e-2."""
    nband, nx = 2, 128
    psf = _psf(nband, nx).astype(np.float32)
    ws = np.array([1.0, 1.5], np.float32)[:, None, None]
    model = np.zeros((nband, nx, nx), np.float32)
    model[:, nx // 3, nx // 2] = 1.0
    conv = make_psf_convolve_pallas(torch.as_tensor(psf, dtype=dtype), nx,
                                    nx, sigmainv=1e-2,
                                    wsum=torch.as_tensor(ws, dtype=dtype))
    return psf, ws, model, conv


def test_cg_fused_matches_jax():
    """The CG-fused branch on K2's plain version (float32 on the CPU)
    against the JAX package's on its Pallas kernels in interpret mode,
    25 fixed iterations: 1e-4 of max."""
    psf, ws, model, conv = _cg_case(torch.float32)
    conv_j = mpcp_j(jnp.asarray(psf), 128, 128, sigmainv=1e-2,
                    wsum=jnp.asarray(ws))
    bj = conv_j(jnp.asarray(model))
    solve_j = fused_j(conv_j.apply, tol=0.0, maxit=25,
                      apply_cg=conv_j.apply_cg, cg_scale=conv_j.cg_scale)
    xj = np.asarray(solve_j(bj, jnp.zeros_like(bj), conv_j.consts))
    b = conv(torch.as_tensor(model))
    calls = Counted(conv.apply_cg)
    solve = make_pcg_bands_fused(conv.apply, tol=0.0, maxit=25,
                                 apply_cg=calls, cg_scale=conv.cg_scale)
    xt = solve(b, torch.zeros_like(b), conv.consts)
    assert calls.n == 25
    assert xt.dtype == torch.float32
    assert _rel(xt.numpy(), xj) < 1e-4


def test_cg_fused_matches_pcg_bands():
    """float64: the CG-fused loop is pcg_bands' fixed-iteration
    arithmetic (1e-10), and without apply_cg the solver takes the
    generic branch."""
    _, _, model, conv = _cg_case(torch.float64)
    b = conv(torch.as_tensor(model, dtype=torch.float64))
    x0 = torch.zeros_like(b)
    x_ref = pcg_bands(conv, b, x0=x0, tol=0.0, maxit=25)
    solve = make_pcg_bands_fused(conv.apply, tol=0.0, maxit=25,
                                 apply_cg=conv.apply_cg,
                                 cg_scale=conv.cg_scale)
    assert _rel(solve(b, x0, conv.consts).numpy(), x_ref.numpy()) < 1e-10
    plain = make_pcg_bands_fused(conv.apply, tol=0.0, maxit=25)
    assert _rel(plain(b, x0, conv.consts).numpy(), x_ref.numpy()) < 1e-12


@pytest.mark.parametrize("reweight", [False, True])
def test_primal_dual_hostloop_matches_jax(hess, reweight):
    """check_freq 4: the same iteration count (a multiple of 4 below
    maxit) as the JAX host loop, the same iterates and weights; the
    every-iteration solver stops elsewhere."""
    bases = ("self", "db1")
    p_j, p_t = make_psi_j(NX, NX, bases, 2), make_psi(NX, NX, bases, 2)
    psiH_j = partial(psi_dot_j, psi=p_j)
    psiF_j = partial(psi_hdot_j, psi=p_j)
    psiH_t = partial(psi_dot, psi=p_t)
    psiF_t = partial(psi_hdot, psi=p_t)
    nu = len(bases)
    data = hess["b"]
    v0 = np.zeros((NB, nu, p_j.Nymax, p_j.Nxmax))
    w0 = np.ones((nu, p_j.Nymax, p_j.Nxmax))
    rms = np.full((1, 1, 1), 0.05)
    kw = dict(nu=nu, tol=1e-3, maxit=300, positivity=1, gamma=1.0,
              maxreweight=2)
    L, lam = 38.0, 1e-3  # about 1.05 the Hessian's spectral norm (36.4)
    rwj = (lambda z: rw_j(psiH_j, 1.0, jnp.asarray(rms), z, 4.0)) \
        if reweight else None
    args_j = (jnp.zeros((NB, NX, NX)), jnp.asarray(v0), lam, psiH_j, psiF_j,
              L, jnp.asarray(w0),
              lambda z: hess["A_j"](z) - jnp.asarray(data))
    xj, _, wj, kj = pdh_j(*args_j, reweighter=rwj, **kw)
    _, _, _, kj_every = pd_j(*args_j, reweighter=rwj, **kw)
    rwt = (lambda z: l1reweight_func(psiH_t, 1.0, torch.as_tensor(rms), z,
                                     4.0)) if reweight else None
    dt = torch.as_tensor(data)
    xt, _, wt, kt = primal_dual_hostloop(
        torch.zeros((NB, NX, NX), dtype=torch.float64), torch.as_tensor(v0),
        lam, psiH_t, psiF_t, L, torch.as_tensor(w0),
        lambda z: hess["A_t"](z) - dt, reweighter=rwt, **kw)
    assert kt == int(kj) and kt % 4 == 0 and kt < kw["maxit"]
    assert kt != int(kj_every)
    assert _rel(xt.numpy(), xj) < 1e-8
    assert np.abs(wt.numpy() - np.asarray(wj)).max() < 1e-8


def test_cg_dct_matches_jax():
    """Two fields of (time, band)-keyed grids with a different SPD
    operator each: the same number of iterations, x and r."""
    rng = np.random.default_rng(5)
    keys = {"a": [(0, 0), (0, 1)], "b": [(0, 0)]}
    shapes = {"a": (16, 16), "b": (24, 8)}
    b = {f: {k: rng.normal(size=shapes[f]) for k in ks}
         for f, ks in keys.items()}
    diag = {f: 1.0 + rng.uniform(size=shapes[f]) for f in keys}

    def make_A(xp, to):
        d = {f: to(v) for f, v in diag.items()}

        def A(x):
            return {f: {k: d[f] * v + 0.1 * xp.roll(v, 1, 0)
                        + 0.1 * xp.roll(v, -1, 0) for k, v in g.items()}
                    for f, g in x.items()}
        return A

    Aj = Counted(make_A(jnp, jnp.asarray))
    At = Counted(make_A(_TorchRoll, torch.as_tensor))
    bj = {f: {k: jnp.asarray(v) for k, v in g.items()} for f, g in b.items()}
    bt = {f: {k: torch.as_tensor(v) for k, v in g.items()}
          for f, g in b.items()}
    xj, rj = cg_dct_j(Aj, bj, {f: {k: jnp.zeros_like(v) for k, v in g.items()}
                               for f, g in bj.items()}, tol=1e-12, maxit=50)
    xt, rt = cg_dct(At, bt, {f: {k: torch.zeros_like(v) for k, v in g.items()}
                             for f, g in bt.items()}, tol=1e-12, maxit=50)
    assert At.n == Aj.n and 2 < At.n < 50
    for f, ks in keys.items():
        for k in ks:
            assert _rel(xt[f][k].numpy(), xj[f][k]) < 1e-8


class _TorchRoll:
    @staticmethod
    def roll(v, s, axis):
        return torch.roll(v, s, dims=axis)


def test_fista_matches_jax():
    """Non-negative least squares with an l1 term: f = |Ax - y|^2 / 2,
    prox = soft threshold then clip; a start beta below the Lipschitz
    constant so the backtracking runs. The same x (the JAX loop is a
    lax.while_loop, so its operator calls are not countable)."""
    rng = np.random.default_rng(6)
    M = rng.normal(size=(40, 30))
    y = M @ np.maximum(rng.normal(size=30), 0.0)
    lam = 0.1

    def parts(xp, to):
        Mx, yx = to(M), to(y)

        def fprime(x):
            res = Mx @ x - yx
            return 0.5 * xp.sum(res * res), Mx.T @ res

        def prox(x, step):
            return xp.maximum(x - lam * step, 0.0 * x)
        return fprime, prox

    fj, pj = parts(jnp, jnp.asarray)
    ft, pt = parts(torch, torch.as_tensor)
    ft = Counted(ft)
    xj = fista_j(fj, pj, jnp.zeros(30), 1.0, tol=1e-8, maxit=300)
    xt = fista(ft, pt, torch.zeros(30, dtype=torch.float64), 1.0, tol=1e-8,
               maxit=300)
    assert ft.n > 20
    assert _rel(xt.numpy(), xj) < 1e-8
