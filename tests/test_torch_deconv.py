"""pfb_tpu_torch's CLEAN minor cycles (deconv/) and conjugate-gradient
solvers (opt/pcg.py) against pfb_tpu on the same numpy inputs, CPU,
float64.

- hogbom and clark on the sidelobed synthetic PSF problem of
  tests/test_deconv.py: model and residual at 1e-10 relative, the same
  status (the same iterations in the same order);
- pcg_psf (the klean flux mop) on a seeded PSF cube with a mop mask as
  beam and sigmainv > 0, pcg and cg on a small SPD operator: 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.deconv.clark import clark as clark_j
from pfb_tpu.deconv.hogbom import hogbom as hogbom_j
from pfb_tpu.ops.fft import make_psfhat as make_psfhat_j
from pfb_tpu.ops.fft import psf_convolve_cube as psf_convolve_cube_j
from pfb_tpu.opt import pcg as pcg_j
from pfb_tpu_torch.deconv.clark import clark as clark_t
from pfb_tpu_torch.deconv.hogbom import hogbom as hogbom_t
from pfb_tpu_torch.opt import pcg as pcg_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _t(a):
    return torch.as_tensor(np.array(a))


def _problem(nband=2, nx=64, ny=64, nsource=5, seed=0):
    """tests/test_deconv.py's problem: dirty = PSF conv model with a
    sharp main lobe and damped-cosine sidelobes, MFS PSF peak 1."""
    rng = np.random.default_rng(seed)
    nxp, nyp = 2 * nx, 2 * ny
    x = np.arange(nxp) - nxp // 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    r = np.sqrt(xx**2 + yy**2)
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        s = 0.6 + 0.1 * b
        psf[b] = (np.exp(-0.5 * r**2 / s**2) +
                  0.08 * np.cos(r / 2.0) * np.exp(-r / 15.0)) / nband
    psf /= psf.sum(axis=0)[nxp // 2, nyp // 2]
    model = np.zeros((nband, nx, ny))
    for _ in range(nsource):
        i, j = rng.integers(8, nx - 8), rng.integers(8, ny - 8)
        model[:, i, j] = (1.0 + rng.random()) * (1.0 + 0.1 * np.arange(nband))
    psfhat = make_psfhat_j(jnp.asarray(psf))
    dirty = np.asarray(psf_convolve_cube_j(jnp.asarray(model), psfhat, nyp))
    return dirty, psf, np.asarray(psfhat), psf.max(axis=(1, 2))


@pmp("seed,kw", [(0, dict(threshold=1e-4, gamma=0.1, pf=1e-5, maxit=10000)),
                 (2, dict(threshold=0.0, gamma=0.05, pf=1e-8, maxit=3))])
def test_hogbom_matches_jax(seed, kw):
    dirty, psf, _, _ = _problem(seed=seed)
    xj, rj, sj = hogbom_j(jnp.asarray(dirty), jnp.asarray(psf), **kw)
    xt, rt, st = hogbom_t(_t(dirty), _t(psf), **kw)
    assert np.abs(np.asarray(xj)).max() > 0
    assert st == int(sj)
    assert _rel(xt.numpy(), xj) < 1e-10
    assert _rel(rt.numpy(), rj) < 1e-10


@pmp("seed,kw", [(1, dict(threshold=1e-4, gamma=0.1, pf=1e-5, maxit=50,
                          subpf=0.5, submaxit=2000)),
                 (3, dict(threshold=0.0, gamma=0.05, pf=0.05, maxit=2,
                          subpf=0.5, submaxit=10))])
def test_clark_matches_jax(seed, kw):
    dirty, psf, psfhat, wsums = _problem(seed=seed)
    xj, rj, sj = clark_j(jnp.asarray(dirty), jnp.asarray(psf),
                         jnp.asarray(psfhat), jnp.asarray(wsums), **kw)
    xt, rt, st = clark_t(_t(dirty), _t(psf), _t(psfhat), _t(wsums), **kw)
    assert np.abs(np.asarray(xj)).max() > 0
    assert st == int(sj)
    assert _rel(xt.numpy(), xj) < 1e-10
    assert _rel(rt.numpy(), rj) < 1e-10


@pmp("sigmainv,backtrack", [(0.5, True), (2.0, False)])
def test_pcg_psf_matches_jax(sigmainv, backtrack):
    """The klean flux mop's solve: a seeded PSF cube, the mop mask as
    beam, sigmainv > 0 (diagonal preconditioner)."""
    rng = np.random.default_rng(5)
    dirty, psf, psfhat, _ = _problem(seed=4)
    mop = np.zeros((64, 64), bool)
    mop[20:40, 15:45] = rng.random((20, 30)) > 0.3
    mopf = np.broadcast_to(mop[None].astype(np.float64), dirty.shape)
    b = mopf * (dirty + 0.1 * rng.normal(size=dirty.shape))
    x0 = mopf * rng.normal(size=dirty.shape)
    kw = dict(sigmainv=sigmainv, tol=1e-8, maxit=60, minit=5,
              backtrack=backtrack)
    ref = pcg_j.pcg_psf(jnp.asarray(psfhat), jnp.asarray(b), jnp.asarray(x0),
                        beam=jnp.asarray(mopf), **kw)
    got = pcg_t.pcg_psf(_t(psfhat), _t(b), _t(x0), beam=_t(mopf), **kw)
    assert _rel(got.numpy(), ref) < 1e-10


def _spd(n=40, seed=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, n))
    return q @ q.T / n + np.eye(n), rng.normal(size=n)


@pmp("precond", [False, True])
def test_pcg_matches_jax(precond):
    A, b = _spd()
    d = np.diag(A)
    Mj = (lambda v: v / jnp.asarray(d)) if precond else None
    Mt = (lambda v: v / _t(d)) if precond else None
    kw = dict(tol=1e-10, maxit=100, minit=5)
    ref = pcg_j.pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=Mj, **kw)
    got = pcg_t.pcg(lambda v: _t(A) @ v, _t(b), M=Mt, **kw)
    assert _rel(got.numpy(), ref) < 1e-10
    assert np.abs(A @ got.numpy() - b).max() < 1e-6


def test_cg_matches_jax():
    A, b = _spd(seed=8)
    ref = pcg_j.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-20,
                   maxit=30)
    got = pcg_t.cg(lambda v: _t(A) @ v, _t(b), tol=1e-20, maxit=30)
    assert _rel(got.numpy(), ref) < 1e-10
