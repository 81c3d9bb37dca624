"""The port's mesh-resident workers against pfb_tpu on the same datasets:
_spotless_dist on band and band x space meshes (its routing included),
the band-sharded exact residual make_hessian_dds_dist (pg all planes,
pg w-plane-blocked, DFT), the row-sharded adjoint make_vis2dirty_rowdist
and _grid(row_shards). The datasets come from the JAX package's
simulate -> _init -> _grid, so both packages read the same arrays; the
JAX side runs on the 8 virtual CPU devices of tests/conftest.py, the port
on virtual CPU meshes. Tolerances per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pfb_tpu.parallel.dist import (make_hessian_dds_dist as hdist_j,
                                   make_vis2dirty_rowdist as rowdist_j)
from pfb_tpu.parallel.mesh import band_sharding, make_mesh as make_mesh_j
from pfb_tpu.utils.ms import simulate_ms
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu.workers.spotless import _spotless_dist as spotless_dist_j
from pfb_tpu_torch.parallel.dist import (make_hessian_dds_dist,
                                         make_vis2dirty_rowdist)
from pfb_tpu_torch.parallel.mesh import make_mesh
from pfb_tpu_torch.workers.grid import _grid as grid_t
from pfb_tpu_torch.workers.spotless import _spotless_dist

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _hessnorm(dds, nband, nx):
    """One spectral norm for both packages (tests/test_dist_fast.py)."""
    from pfb_tpu.ops.psf import make_psf_convolve
    from pfb_tpu.opt.power_method import power_method
    from pfb_tpu.workers.cubes import dds2cubes
    psfhat = dds2cubes(dds, nband, apparent=False)[4]
    conv = make_psf_convolve(jnp.asarray(psfhat), dds[0]["PSF"].shape[-1])
    beta, _ = power_method(conv, (nband, nx, nx), tol=1e-7, maxit=200,
                           dtype=np.float64)
    return float(beta) * 1.05


def _xds(tmp, seed, ntime, integrations):
    ms = str(tmp / "t.npz")
    simulate_ms(ms, nant=7, ntime=ntime, nchan=2, nsource=2, fov_deg=0.2,
                seed=seed)
    return init_j(ms=ms, write=False, channels_per_image=1,
                  integrations_per_image=integrations)


@pytest.fixture(scope="module")
def spot_dds(tmp_path_factory):
    """2 bands x 2 time chunks, Briggs 0, 128^2 (v3 supported): the
    sizes of tests/test_dist_fast.py's fast-engine spotless."""
    xds = _xds(tmp_path_factory.mktemp("sd"), 11, 4, 2)
    dds = grid_j(xdsi=xds, write=False, field_of_view=0.2, robustness=0.0,
                 psf=True, residual=False, nx=128, ny=128)
    nband = len({ds["bandid"] for ds in dds})
    return dds, nband, _hessnorm(dds, nband, 128)


SPOT = dict(niter=2, rmsfactor=0.5, gamma=1.0, bases="self,db1", nlevels=2,
            l1reweight_from=1, pd_tol=1e-6, pd_maxit=100, backend="pg",
            verbose=0, write=False)


@pytest.mark.parametrize("engine,nspace,tol", [
    ("pallas", 1, 1e-3),   # K1 (plain, float64) vs v3 Pallas (interpret, f32)
    ("pallas", 2, 1e-8),   # 128 % (2 * 128): both fall back to the fft
    ("fft", 2, 1e-8)])
def test_spotless_dist_matches_jax(spot_dds, engine, nspace, tol):
    """model and residual against the JAX package's _spotless_dist with
    the same hessnorm: 1e-3 of max where the JAX side runs its float32
    Pallas kernels (its own gate, tests/test_dist_fast.py), 1e-8 where
    both run float64 FFTs."""
    dds, nband, hessnorm = spot_dds
    kw = dict(SPOT, hessnorm=hessnorm, engine=engine)
    mj = make_mesh_j(nband=nband, nspace=nspace,
                     devices=jax.devices()[:nband * nspace])
    m_j, r_j = spotless_dist_j(mesh=mj, ddsi=[dict(d) for d in dds], **kw)
    mt = make_mesh(nband=nband, nspace=nspace,
                   devices=[CPU] * (nband * nspace))
    st = {}
    m_t, r_t = _spotless_dist(mesh=mt, ddsi=[dict(d) for d in dds],
                              stats=st, **kw)
    assert np.abs(m_j).max() > 0
    assert st["engine"] == ("pallas" if nspace == 1 and engine == "pallas"
                            else "fft")
    assert st["psi_method"] == ("local" if nspace == 1 else "halo")
    assert len(st["pd_iters"]) == 2
    assert _rel(m_t, m_j) < tol
    assert _rel(r_t, r_j) < tol


@pytest.fixture(scope="module")
def space_dds(tmp_path_factory):
    """2 bands, Briggs 0, 256^2: v3_space_supported holds on 2 space
    shards, so engine="pallas" takes K10 in the primal-dual gradient."""
    xds = _xds(tmp_path_factory.mktemp("sp"), 5, 4, 4)
    dds = grid_j(xdsi=xds, write=False, field_of_view=0.3, robustness=0.0,
                 psf=True, residual=False, nx=256, ny=256)
    nband = len({ds["bandid"] for ds in dds})
    return dds, nband, _hessnorm(dds, nband, 256)


def test_spotless_dist_space_k10_route_matches_band_route(space_dds):
    """At 256^2 on a 2 x 2 mesh v3_space_supported holds: the primal-dual
    gradient runs K10 (plain stages) with the halo Psi. Same run on a
    2 x 1 mesh (K1): float64, 1e-8 of max."""
    dds, nband, hessnorm = space_dds
    kw = dict(SPOT, niter=2, pd_maxit=20, hessnorm=hessnorm,
              engine="pallas")
    out = {}
    for ns in (1, 2):
        st = {}
        out[ns] = _spotless_dist(
            mesh=make_mesh(nband, ns, [CPU] * (nband * ns)),
            ddsi=[dict(d) for d in dds], stats=st, **kw)
        assert st["engine"] == "pallas"
        assert st["pd_engine"] == "pallas"
    assert st["psi_method"] == "halo"
    assert np.abs(out[1][0]).max() > 0
    assert _rel(out[2][0], out[1][0]) < 1e-8
    assert _rel(out[2][1], out[1][1]) < 1e-8


def test_spotless_dist_space_k10_route_matches_jax(space_dds):
    """The K10 route end to end against the JAX package: _spotless_dist
    (engine="pallas") on 2 x 2 meshes at 256^2, the JAX side running its
    K10 stages (psf_v3_stage_k1/k2/k3) in interpret mode in float32, the
    port its plain stages in float64, one hessnorm and a few PD
    iterations: model and residual within 1e-3 of max (the gate of
    tests/test_dist_fast.py)."""
    dds, nband, hessnorm = space_dds
    kw = dict(SPOT, niter=1, pd_maxit=8, hessnorm=hessnorm, engine="pallas")
    mj = make_mesh_j(nband=nband, nspace=2, devices=jax.devices()[:2 * nband])
    m_j, r_j = spotless_dist_j(mesh=mj, ddsi=[dict(d) for d in dds], **kw)
    st = {}
    m_t, r_t = _spotless_dist(mesh=make_mesh(nband, 2, [CPU] * (2 * nband)),
                              ddsi=[dict(d) for d in dds], stats=st, **kw)
    assert st["pd_engine"] == "pallas" and st["psi_method"] == "halo"
    assert np.abs(m_j).max() > 0
    assert _rel(m_t, m_j) < 1e-3
    assert _rel(r_t, r_j) < 1e-3


def test_spotless_dist_non_v3_shape_takes_fft_without_k11(tmp_path,
                                                          monkeypatch):
    """96^2 (NY = 192 fails v3): engine="pallas" falls back to the fft
    operator, as the JAX package does; the dist path has no route to the
    general PSF kernel K11 (nor K1), so neither is called. Against the
    JAX package: 1e-8."""
    import pfb_tpu_torch.ops.psf as psf_t

    def boom(*a, **k):
        raise AssertionError("a PSF kernel ran on the fft route")

    monkeypatch.setattr(psf_t, "psf_convolve_full", boom)
    monkeypatch.setattr(psf_t, "psf_convolve_h", boom)
    import pfb_tpu_torch.parallel.dist as dist_t
    monkeypatch.setattr(dist_t, "psf_convolve_h", boom)
    xds = _xds(tmp_path, 11, 4, 4)
    dds = grid_j(xdsi=xds, write=False, field_of_view=0.2, robustness=0.0,
                 psf=True, residual=False, nx=96, ny=96)
    nband = len({ds["bandid"] for ds in dds})
    kw = dict(SPOT, niter=1, hessnorm=_hessnorm(dds, nband, 96),
              engine="pallas")
    m_j, _ = spotless_dist_j(mesh=make_mesh_j(
        nband=nband, nspace=1, devices=jax.devices()[:nband]),
        ddsi=[dict(d) for d in dds], **kw)
    st = {}
    m_t, _ = _spotless_dist(mesh=make_mesh(nband, 1, [CPU] * nband),
                            ddsi=[dict(d) for d in dds], stats=st, **kw)
    assert st["engine"] == "fft" and st["pd_engine"] == "fft"
    assert _rel(m_t, m_j) < 1e-8


# ---------------------------------------------------------------------
# the band-sharded exact residual


@pytest.fixture(scope="module")
def multids(tmp_path_factory):
    """2 time chunks x 2 bands (tests/test_dist_fast.py's multids)."""
    tmp = tmp_path_factory.mktemp("md")
    ms = str(tmp / "t.npz")
    simulate_ms(ms, nant=7, ntime=6, nchan=2, nsource=2, fov_deg=0.25,
                seed=7)
    xds = init_j(ms=ms, write=False, channels_per_image=1,
                 integrations_per_image=3)
    dds = grid_j(xdsi=xds, write=False, field_of_view=0.25,
                 robustness=None, psf=False, residual=False)
    nband = len({ds["bandid"] for ds in dds})
    assert len(dds) == 2 * nband
    return dds, nband


@pytest.mark.parametrize("backend,plane_block,tol", [
    ("pg", None, 1e-10), ("pg", 3, 1e-10), ("dft", None, 1e-10)])
def test_hessian_dds_dist_matches_jax(multids, backend, plane_block, tol):
    """pg over plans with one shared geometry (all planes, or w-plane
    blocks of 3) and the exact DFT, against the JAX package's
    make_hessian_dds_dist on the same band mesh: float64, 1e-10."""
    dds, nband = multids
    nx = dds[0]["DIRTY"].shape[0]
    wsum = float(np.sum([d["WSUM"][0] for d in dds]))
    x = np.random.default_rng(3).normal(size=(nband, nx, nx))
    kw = dict(use_beam=False, backend=backend, plane_block=plane_block,
              sigmainv=0.1)
    mj = make_mesh_j(nband=nband, nspace=1, devices=jax.devices()[:nband])
    ref = np.asarray(hdist_j(mj, dds, nband, wsum, nx, nx, **kw)(
        jax.device_put(jnp.asarray(x), band_sharding(mj))))
    mt = make_mesh(nband, 1, [CPU] * nband)
    got = make_hessian_dds_dist(mt, dds, nband, wsum, nx, nx, **kw)(
        torch.as_tensor(x)).numpy()
    assert _rel(got, ref) < tol


def test_hessian_dds_dist_blocked_matches_all_planes_on_2x2_mesh(multids):
    """plane_block against all planes on a 2 x 2 mesh (one operator per
    band row): 1e-9 of max, tests/test_dist_fast.py's gate."""
    dds, nband = multids
    nx = dds[0]["DIRTY"].shape[0]
    wsum = float(np.sum([d["WSUM"][0] for d in dds]))
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(nband, nx,
                                                             nx)))
    mt = make_mesh(nband, 2, [CPU] * (2 * nband))
    ref = make_hessian_dds_dist(mt, dds, nband, wsum, nx, nx,
                                use_beam=False, backend="pg")(x)
    assert ref.parts[0] is ref.parts[1]  # one tensor per band row
    got = make_hessian_dds_dist(mt, dds, nband, wsum, nx, nx,
                                use_beam=False, backend="pg",
                                plane_block=3)(x)
    assert _rel(got.numpy(), ref.numpy()) <= 1e-9


# ---------------------------------------------------------------------
# row-sharded gridding


def test_vis2dirty_rowdist_matches_jax():
    """Row-sharded adjoint on the space axis of a 2 x 4 mesh against the
    JAX package's (tests/test_parallel.py's observation): 1e-10 of max."""
    from pfb_tpu.utils.simulation import image_size_for, simulate_obs
    obs = simulate_obs(nant=7, ntime=6, nchan=2, seed=3)
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(0)
    nrow, nchan = obs.uvw.shape[0], obs.freq.size
    vis = rng.normal(size=(nrow, nchan)) + 1j * rng.normal(size=(nrow,
                                                                 nchan))
    wgt = rng.random((nrow, nchan))
    kw = dict(nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=1e-7,
              do_wgridding=True)
    fj, _ = rowdist_j(make_mesh_j(nband=2, nspace=4), obs.uvw, obs.freq,
                      **kw)
    ref = np.asarray(fj(vis.real, vis.imag, wgt))
    mt = make_mesh(2, 4, [CPU] * 8)
    ft, split = make_vis2dirty_rowdist(mt, obs.uvw, obs.freq, **kw)
    got = ft(vis.real, vis.imag, wgt).numpy()
    assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    blocks = split(wgt)
    assert len(blocks) == 8 and blocks[0] is blocks[4]


def test_grid_row_shards_matches_jax(tmp_path):
    """_grid(row_shards=4) on four virtual CPU shards against the JAX
    package's _grid(row_shards=4) on its virtual devices: DIRTY, PSF,
    PSFHAT, WSUM, WEIGHT to 1e-10; with one device it warns and grids
    on it (the one-device grid, 1e-12)."""
    ms = str(tmp_path / "t.npz")
    simulate_ms(ms, nant=7, ntime=4, nchan=2, nsource=2, fov_deg=0.2,
                seed=5, gains=False)
    xds = init_j(ms=ms, write=False, channels_per_image=1)
    kw = dict(field_of_view=0.2, robustness=0.0, psf=True, residual=False,
              backend="pg", write=False)
    ref = grid_j(xdsi=[dict(d) for d in xds], row_shards=4, **kw)
    got = grid_t(xdsi=[dict(d) for d in xds], row_shards=4,
                 devices=[CPU] * 4, device=CPU, **kw)
    one = grid_t(xdsi=[dict(d) for d in xds], device=CPU, **kw)
    single = grid_t(xdsi=[dict(d) for d in xds], row_shards=4,
                    devices=[CPU], device=CPU, **kw)
    assert len(ref) == len(got)
    for r, g, o, s in zip(ref, got, one, single):
        for key in ("DIRTY", "PSF", "PSFHAT_real", "PSFHAT_imag", "WSUM",
                    "WEIGHT"):
            scale = max(1.0, np.abs(r[key]).max())
            assert_allclose(g[key], r[key], rtol=1e-10, atol=1e-10 * scale,
                            err_msg=key)
            assert_allclose(g[key], o[key], rtol=1e-10, atol=1e-10 * scale,
                            err_msg=key)
            # the one-device pg grid itself repeats to ~1e-15 on the CPU
            assert_allclose(s[key], o[key], rtol=1e-12, atol=1e-12 * scale,
                            err_msg=key)
