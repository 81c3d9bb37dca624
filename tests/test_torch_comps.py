"""pfb_tpu_torch's component model (models/comps.py, the mds contract)
against pfb_tpu's on the same numpy inputs (CPU, float64).

- fit_image_cube for ``poly`` and ``Legendre`` at (ntime, nband) = (1, 1),
  (1, 4), (3, 1) and (2, 3): coefficients at 1e-10 relative, the same
  pixel locations and the same parametrisation strings; the rendered cube
  (eval_coeffs_to_cube) at 1e-10 relative and, where the fit
  interpolates, reproducing the input cube (tests/test_models_io.py:31);
- eval_coeffs_to_slice onto the fit grid itself and onto a shifted,
  finer and larger grid at 1e-12 (tests/test_models_io.py:44);
- each package's ComponentModel renders the other's strings to the same
  pixels.
"""

import numpy as np
import pytest

from pfb_tpu.models import comps as comps_j
from pfb_tpu_torch.models import comps as comps_t

pmp = pytest.mark.parametrize


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _random_cube(ntime=1, nband=4, nx=16, ny=16, ncomp=5, seed=0):
    """Power-law components whose flux also drifts in time."""
    rng = np.random.default_rng(seed)
    time = 5e9 + np.arange(ntime) * 100.0
    freq = 1e9 + np.arange(nband) * 1e8
    img = np.zeros((ntime, nband, nx, ny))
    Ix = rng.integers(0, nx, ncomp)
    Iy = rng.integers(0, ny, ncomp)
    for i in range(ncomp):
        flux = 1 + rng.random()
        alpha = -0.7 + 0.1 * rng.standard_normal()
        drift = 1.0 + 0.05 * rng.standard_normal() * np.arange(ntime)
        img[:, :, Ix[i], Iy[i]] = flux * drift[:, None] * \
            (freq / freq.mean())[None, :] ** alpha
    return time, freq, img


@pmp("method", ["poly", "Legendre"])
@pmp("ntime, nband", [(1, 1), (1, 4), (3, 1), (2, 3)])
def test_fit_eval_matches_jax(method, ntime, nband):
    time, freq, img = _random_cube(ntime=ntime, nband=nband, seed=ntime +
                                   7 * nband)
    fj = comps_j.fit_image_cube(time, freq, img, method=method)
    ft = comps_t.fit_image_cube(time, freq, img, method=method)
    assert _rel(ft[0], fj[0]) < 1e-10
    np.testing.assert_array_equal(ft[1], fj[1])
    np.testing.assert_array_equal(ft[2], fj[2])
    assert ft[3:] == fj[3:]
    nx, ny = img.shape[-2:]
    cj = comps_j.eval_coeffs_to_cube(time, freq, nx, ny, *fj)
    ct = comps_t.eval_coeffs_to_cube(time, freq, nx, ny, *ft)
    assert ct.shape == (ntime, nband, nx, ny)
    assert _rel(ct, cj) < 1e-10
    # with nbasist = ntime and nbasisf = nband the fit interpolates when
    # one axis is single (the additive basis cannot hold a (t, f) cross
    # term otherwise); the monomials of t / t[0] at t ~ 5e9 s differ by
    # 1e-8 across the samples, too ill-conditioned to interpolate
    if nband == 1 and ntime > 1 and method == "poly":
        return
    if ntime == 1 or nband == 1:
        np.testing.assert_allclose(1 + ct, 1 + img, rtol=1e-9)


def test_fit_weights_ridge_and_basis_count_match_jax():
    """Weighted ridge fit with fewer basis functions than samples."""
    time, freq, img = _random_cube(ntime=3, nband=4, seed=5)
    wgt = np.random.default_rng(1).random((3, 4)) + 0.5
    kw = dict(wgt=wgt, nbasist=2, nbasisf=3, method="Legendre",
              sigmasq=1e-3)
    fj = comps_j.fit_image_cube(time, freq, img, **kw)
    ft = comps_t.fit_image_cube(time, freq, img, **kw)
    assert _rel(ft[0], fj[0]) < 1e-10
    assert ft[3:] == fj[3:]
    with pytest.raises(ValueError):
        comps_t.fit_image_cube(time, freq, img, nbasisf=5)
    with pytest.raises(NotImplementedError):
        comps_t.fit_image_cube(time, freq, img, method="spline")


@pmp("grid", ["same", "shifted finer larger"])
def test_eval_slice_matches_jax(grid):
    time, freq, img = _random_cube(nx=16, ny=16)
    fit = comps_t.fit_image_cube(time, freq, img, method="Legendre")
    cell = 1e-5
    src = (16, 16, cell, cell, 0.0, 0.0)
    if grid == "same":
        dst = src
    else:
        dst = (40, 36, 0.5 * cell, 0.5 * cell, 3.0 * cell, -2.0 * cell)
    args = (time[0], freq[1]) + tuple(fit) + src + dst
    oj = comps_j.eval_coeffs_to_slice(*args)
    ot = comps_t.eval_coeffs_to_slice(*args)
    assert ot.shape == dst[:2]
    assert np.abs(ot).max() > 0
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-12 * np.abs(oj).max())
    if grid == "same":
        np.testing.assert_allclose(ot, img[0, 1], atol=1e-12)


@pmp("method", ["poly", "Legendre"])
def test_component_models_read_each_others_strings(method):
    """The mds strings of either package render to the same pixels in
    the other's ComponentModel."""
    time, freq, img = _random_cube(ntime=2, nband=3, seed=3)
    fj = comps_j.fit_image_cube(time, freq, img, method=method)
    ft = comps_t.fit_image_cube(time, freq, img, method=method)
    for t in (time[0], time.mean(), time[-1] + 50.0):
        for f in (freq[0], freq.mean(), 1.05 * freq[-1]):
            a = comps_j.ComponentModel(*ft).render(t, f, 16, 16)
            b = comps_t.ComponentModel(*fj).render(t, f, 16, 16)
            c = comps_j.ComponentModel(*fj).render(t, f, 16, 16)
            assert _rel(a, c) < 1e-10
            assert _rel(b, c) < 1e-10
