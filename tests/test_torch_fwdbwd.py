"""pfb_tpu_torch's fwdbwd worker and the operators beside it (ops/gauss.py,
ops/mask.py, utils/spi.py) against pfb_tpu on the CPU in float64.

Tolerances:
- fwdbwd's model, param and residual after ``niter=2`` from the dirty
  image: 1e-8 of max for 'id', 1e-6 for 'exp' (whose mode removal takes
  a histogram's bin edges on the host; both packages get the same edges
  from the same parameter, so it reads ~1e-12 here). Both power methods
  start from the JAX package's draw (``jax.random.normal(PRNGKey(42))``,
  fed to the port's ``power_method`` as ``b0``): the eigenvalue each
  returns at ``pm_tol`` 1e-4 depends on the start vector at about that
  level, and the primal-dual steps scale with it;
- setup_parametrisation, mask, gauss: 1e-12 relative;
- spi's alpha and i0: 1e-10 relative.

Each section also runs the port's counterparts of the reference tests:
tests/test_fwdbwd.py, tests/test_misc_ops.py:8,
tests/test_aux_workers.py:76 and tests/test_spi.py.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pfb_tpu.utils.ms import simulate_ms
from pfb_tpu.workers.fwdbwd import _fwdbwd as fwdbwd_j
from pfb_tpu.workers.fwdbwd import setup_parametrisation as setup_j
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu_torch.utils import dstore as dstore_t
from pfb_tpu_torch.workers import fwdbwd as fwdbwd_mod
from pfb_tpu_torch.workers.fwdbwd import _fwdbwd as fwdbwd_t
from pfb_tpu_torch.workers.fwdbwd import setup_parametrisation as setup_t
from pfb_tpu_torch.workers.grid import _grid as grid_t
from pfb_tpu_torch.workers.init import _init as init_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
FOV = 0.2
GRID = dict(field_of_view=FOV, robustness=0.0, psf=True, residual=False,
            write=False)
FB = dict(niter=2, rmsfactor=0.3, gamma=1.0, bases="self,db1", nlevels=2,
          verbose=0)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("fwdbwd")
    ms = str(d / "t.npz")
    simulate_ms(ms, nant=8, ntime=6, nchan=2, nsource=3, fov_deg=FOV,
                seed=31)
    xj = init_j(ms=ms, write=False, channels_per_image=1)
    xt = init_t(ms=ms, write=False, channels_per_image=1, device="cpu")
    return dict(dj=grid_j(xdsi=xj, **GRID),
                dt=grid_t(xdsi=xt, device="cpu", **GRID))


@pytest.fixture
def jax_start(monkeypatch):
    """The port's power method started from the JAX package's draw."""
    import jax

    from pfb_tpu_torch.opt.power_method import power_method

    def pm(A, imsize, b0=None, **kw):
        if b0 is None:
            b0 = torch.as_tensor(np.asarray(jax.random.normal(
                jax.random.PRNGKey(42), imsize, dtype=np.float64)))
        return power_method(A, imsize, b0=b0, **kw)

    monkeypatch.setattr(fwdbwd_mod, "power_method", pm)


@pmp("par,tol", [("id", 1e-8), ("exp", 1e-6)])
def test_fwdbwd_matches_jax(pipe, jax_start, tmp_path, par, tol):
    """Two major iterations from the dirty image, written back to a dds
    store: the returned model, param and residual and the stored PARAM,
    MODEL and RESIDUAL cubes at ``tol`` of max. The stored DUAL is held at
    1e-6: it is the l21 prox of the coefficients at the threshold, whose
    rounding shows more (4.2e-8 for 'id')."""
    kw = dict(FB, parametrisation=par)
    mj, pj, rj = fwdbwd_j(ddsi=[dict(d) for d in pipe["dj"]],
                          output_filename=str(tmp_path / "j"), **kw)
    st = {}
    mt, pt, rt = fwdbwd_t(ddsi=[dict(d) for d in pipe["dt"]],
                          output_filename=str(tmp_path / "t"),
                          device="cpu", stats=st, **kw)
    assert _rel(mt, mj) < tol
    assert _rel(pt, pj) < tol
    assert _rel(rt, rj) < tol
    assert len(st["hessnorm"]) == 2 and st["psinorm"] > 0
    from pfb_tpu.utils import dstore as dstore_j
    bj = dstore_j.read_store(str(tmp_path / "j_I_main.dds"))
    bt = dstore_t.read_store(str(tmp_path / "t_I_main.dds"))
    assert all(a["parametrisation"] == b["parametrisation"] == par
               for a, b in zip(bt, bj))

    def cube(dds, k):
        return np.stack([ds[k] for ds in dds])

    for k in ("PARAM", "MODEL", "RESIDUAL"):
        assert _rel(cube(bt, k), cube(bj, k)) < tol, k
    assert _rel(cube(bt, "DUAL"), cube(bj, "DUAL")) < 1e-6


@pmp("mode", ["id", "exp"])
def test_setup_parametrisation_matches_jax(mode):
    import jax.numpy as jnp
    freq = 1e9 + np.arange(4) * 1e8
    rng = np.random.default_rng(0)
    s, v, u = (rng.normal(size=(4, 8, 8)) for _ in range(3))
    ft = setup_t(mode=mode, freq=freq, minval=1e-3)
    fj = setup_j(mode=mode, freq=freq, minval=1e-3)
    T = torch.as_tensor
    x = np.asarray(fj[0](jnp.asarray(s)))
    assert _rel(ft[0](T(s)).numpy(), x) < 1e-12
    assert _rel(ft[1](T(x)).numpy(), np.asarray(fj[1](jnp.asarray(x)))) \
        < 1e-12
    for k in (2, 3):
        assert _rel(ft[k](T(s), T(v)).numpy(),
                    np.asarray(fj[k](jnp.asarray(s), jnp.asarray(v)))) \
            < 1e-12


def test_parametrisation_roundtrip():
    """tests/test_fwdbwd.py:14 on the port."""
    freq = 1e9 + np.arange(4) * 1e8
    for mode in ("id", "exp"):
        func, finv, dfunc, dhfunc = setup_t(mode=mode, freq=freq)
        rng = np.random.default_rng(0)
        s = torch.as_tensor(rng.normal(size=(4, 8, 8)))
        s2 = finv(func(s))
        if mode == "id":
            np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=1e-8)
        v = torch.as_tensor(rng.normal(size=(4, 8, 8)))
        u = torch.as_tensor(rng.normal(size=(4, 8, 8)))
        lhs = float(torch.sum(dfunc(s, v) * u))
        rhs = float(torch.sum(v * dhfunc(s, u)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_fwdbwd_reduces_residual(tmp_path):
    """tests/test_fwdbwd.py:36 on the port, at its size and settings."""
    ms_path = str(tmp_path / "t.npz")
    simulate_ms(ms_path, nant=8, ntime=6, nchan=2, nsource=3,
                fov_deg=0.3, seed=31)
    out = str(tmp_path / "o")
    xds = init_t(ms=ms_path, output_filename=out, channels_per_image=1,
                 device="cpu")
    dds = grid_t(xdsi=xds, output_filename=out, suffix="main",
                 field_of_view=0.3, robustness=0.0, psf=True,
                 residual=False, device="cpu")
    model, param, resid = fwdbwd_t(
        ddsi=[dict(d) for d in dds], output_filename=out, niter=4,
        parametrisation="id", rmsfactor=0.3, gamma=1.0,
        bases="self,db1", nlevels=2, verbose=0, device="cpu")
    dirty_mfs = np.sum([d["DIRTY"] for d in dds], axis=0)
    wsum = np.sum([d["WSUM"][0] for d in dds])
    assert np.abs(resid.sum(0)).max() < \
        0.5 * np.abs(dirty_mfs / wsum).max()
    dds2 = dstore_t.read_store(out + "_I_main.dds")
    assert "PARAM" in dds2[0]


# ops/mask.py


def test_mask_matches_jax():
    from pfb_tpu.ops.mask import Mask as MaskJ
    from pfb_tpu_torch.ops.mask import Mask
    rng = np.random.default_rng(5)
    m = rng.random((12, 9)) > 0.4
    x = rng.normal(size=(2, 3, 12, 9))
    Mt, Mj = Mask(m), MaskJ(m)
    assert Mt.n == Mj.n
    vt = Mt.dot(torch.as_tensor(x))
    vj = np.asarray(Mj.dot(x))
    assert _rel(vt.numpy(), vj) < 1e-12
    assert _rel(Mt.hdot(vt).numpy(), np.asarray(Mj.hdot(vj))) < 1e-12


def test_mask_operator_roundtrip():
    """tests/test_misc_ops.py:8 on the port."""
    from pfb_tpu_torch.ops.mask import Mask
    rng = np.random.default_rng(0)
    m = rng.random((8, 10)) > 0.5
    M = Mask(m)
    x = torch.as_tensor(rng.normal(size=(3, 8, 10)))
    v = M.dot(x)
    assert v.shape == (3, M.n)
    back = M.hdot(v)
    assert_allclose(back.numpy(), x.numpy() * m[None])
    assert_allclose(M.dot(back).numpy(), v.numpy())


# ops/gauss.py


def test_gauss_matches_jax():
    import jax.numpy as jnp

    from pfb_tpu.ops import gauss as gj
    from pfb_tpu_torch.ops import gauss as gt
    assert _rel(gt.make_kernel(16, 12, 1.5, 2.0),
                gj.make_kernel(16, 12, 1.5, 2.0)) < 1e-12
    t = np.linspace(0.0, 1.0, 7)
    assert _rel(gt.sq_exp_kernel(t, t[:5], 1.3, 0.4),
                gj.sq_exp_kernel(t, t[:5], 1.3, 0.4)) < 1e-12
    # convolve only on square images: make_kernel's kernel is
    # (ny_psf, nx_psf), so both packages fail on nx != ny
    for nx, ny, names in ((10, 10, ("convolve", "dot", "idot", "sqrtdot")),
                          (10, 8, ("dot", "idot", "sqrtdot"))):
        Gt = gt.Gauss(1.0, 3, nx, ny, length_scale=2.0)
        Gj = gj.Gauss(1.0, 3, nx, ny, length_scale=2.0)
        x = np.random.default_rng(6).normal(size=(3, nx, ny))
        for name in names:
            got = getattr(Gt, name)(torch.as_tensor(x)).numpy()
            ref = np.asarray(getattr(Gj, name)(jnp.asarray(x)))
            assert _rel(got, ref) < 1e-12, name


def test_gauss_kron_identities():
    """tests/test_aux_workers.py:76 on the port."""
    from pfb_tpu_torch.ops.gauss import Gauss, kron_matvec
    rng = np.random.default_rng(0)
    G = Gauss(1.0, 2, 8, 8, length_scale=2.0)
    x = torch.as_tensor(rng.normal(size=(2, 8, 8)))
    y = G.idot(G.dot(x))
    assert_allclose(y.numpy(), x.numpy(), rtol=1e-6, atol=1e-8)
    A = rng.normal(size=(3, 3))
    B = rng.normal(size=(4, 4))
    v = rng.normal(size=12)
    dense = np.kron(A, B) @ v
    got = kron_matvec((torch.as_tensor(A), torch.as_tensor(B)),
                      torch.as_tensor(v)).numpy()
    assert_allclose(got, dense, rtol=1e-10)


# utils/spi.py


def _spi_data(ncomp=6, nchan=8, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    freqs = 1e9 + np.arange(nchan) * 1e8
    alpha = -0.7 + 0.3 * rng.standard_normal(ncomp)
    i0 = 1.0 + rng.random(ncomp)
    data = i0[:, None] * (freqs[None, :] / freqs.mean()) ** alpha[:, None]
    return data + noise * rng.standard_normal(data.shape), freqs


@pmp("noise,wshape", [(0.0, "chan"), (0.02, "chan"), (0.02, "comp")])
def test_fit_spi_components_matches_jax(noise, wshape):
    """alpha and i0 at 1e-10 relative, the errors at 1e-8, with noisy
    data (where the fit has a residual) and per-component weights."""
    import jax.numpy as jnp

    from pfb_tpu.utils.spi import fit_spi_components as fit_j
    from pfb_tpu_torch.utils.spi import fit_spi_components as fit_t
    data, freqs = _spi_data(noise=noise)
    rng = np.random.default_rng(1)
    w = 0.5 + rng.random(freqs.size if wshape == "chan" else data.shape)
    got = fit_t(data, w, freqs, freqs.mean())
    ref = fit_j(jnp.asarray(data), jnp.asarray(w), jnp.asarray(freqs),
                freqs.mean())
    for k, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g.numpy(), np.asarray(r)) < (1e-10 if k % 2 == 0
                                                 else 1e-8), k


def test_fit_spi_map_matches_jax():
    from pfb_tpu.utils.spi import fit_spi as fit_spi_j
    from pfb_tpu_torch.utils.spi import fit_spi
    rng = np.random.default_rng(2)
    freqs = 1e9 + np.arange(4) * 1e8
    cube = np.zeros((4, 12, 12))
    pix = rng.integers(0, 12, size=(6, 2))
    for (ix, iy), a in zip(pix, rng.normal(-0.7, 0.2, size=6)):
        cube[:, ix, iy] = (1.0 + rng.random()) * (freqs / freqs.mean()) ** a
    at, it = fit_spi(cube, freqs, threshold=0.1, device="cpu")
    aj, ij = fit_spi_j(cube, freqs, threshold=0.1)
    np.testing.assert_array_equal(np.isnan(at), np.isnan(aj))
    ok = ~np.isnan(aj)
    assert _rel(at[ok], aj[ok]) < 1e-10 and _rel(it[ok], ij[ok]) < 1e-10


def test_fit_spi_components_recovers_alpha():
    """tests/test_spi.py:11 on the port."""
    from pfb_tpu_torch.utils.spi import fit_spi_components
    rng = np.random.default_rng(0)
    nchan, ncomp = 8, 5
    freqs = 1e9 + np.arange(nchan) * 1e8
    freq0 = freqs.mean()
    alpha = -0.7 + 0.1 * rng.standard_normal(ncomp)
    i0 = 1.0 + rng.random(ncomp)
    data = i0[:, None] * (freqs[None, :] / freq0) ** alpha[:, None]
    a, aerr, i0f, ierr = fit_spi_components(data, np.ones(nchan), freqs,
                                            freq0)
    assert_allclose(a.numpy(), alpha, atol=1e-6)
    assert_allclose(i0f.numpy(), i0, rtol=1e-6)


def test_convolve2gaussres_preserves_spi():
    """tests/test_spi.py:26 on the port's utils/misc.py."""
    from pfb_tpu_torch.utils.misc import Gaussian2D, convolve2gaussres
    nband, nx, ny = 4, 64, 64
    freqs = 1e9 + np.arange(nband) * 2e8
    freq0 = freqs.mean()
    alpha = -0.7
    x = np.arange(-(nx // 2), nx - nx // 2)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    gausspari = [(3.0 * freqs[0] / f, 3.0 * freqs[0] / f, 0.0)
                 for f in freqs]
    image = np.zeros((nband, nx, ny))
    for b in range(nband):
        image[b] = (freqs[b] / freq0) ** alpha * \
            Gaussian2D(xx, yy, gausspari[b], normalise=False)
    out = convolve2gaussres(image, xx, yy, (5.0, 5.0, 0.0),
                            gausspari=gausspari, norm_kernel=False)
    peak = out[:, nx // 2, ny // 2]
    alpha_fit = np.polyfit(np.log(freqs / freq0), np.log(peak), 1)[0]
    assert_allclose(alpha_fit, alpha, atol=5e-4)


def test_fit_spi_map():
    """tests/test_spi.py:58 on the port."""
    from pfb_tpu_torch.utils.spi import fit_spi
    nband, nx = 3, 16
    freqs = 1e9 + np.arange(nband) * 1e8
    cube = np.zeros((nband, nx, nx))
    cube[:, 8, 8] = 2.0 * (freqs / freqs.mean()) ** -0.5
    amap, i0map = fit_spi(cube, freqs, threshold=0.1, device="cpu")
    assert_allclose(amap[8, 8], -0.5, atol=1e-6)
    assert np.isnan(amap[0, 0])
