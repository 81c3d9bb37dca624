"""The port's main paths, simulate -> _init -> _grid(wgrid, or pg with
Briggs weights) -> _spotless or _klean (the pg residual all-planes or
w-plane-blocked), against pfb_tpu on the same observation (CPU, float64
unless stated); spotless(engine="pallas")'s routing outside v3 (the
general PSF kernel K11 and primal_dual_hostloop) and at unaligned shapes;
plus the import boundary of pfb_tpu_torch."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfb_tpu.utils.ms import simulate_ms as simulate_ms_j
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu.workers.klean import _klean as klean_j
from pfb_tpu.workers.spotless import _spotless as spotless_j
from pfb_tpu_torch.utils.ms import simulate_ms as simulate_ms_t
from pfb_tpu_torch.workers.grid import _grid as grid_t
from pfb_tpu_torch.workers.init import _init as init_t
from pfb_tpu_torch.workers.klean import _klean as klean_t
from pfb_tpu_torch.workers.spotless import _spotless as spotless_t

torch.set_num_threads(1)
NX = 128
SIM = dict(nant=7, ntime=4, nchan=2, nsource=3, fov_deg=0.2, seed=3)
GRID = dict(suffix="main", field_of_view=0.2, psf=True, residual=False,
            nx=NX, ny=NX, backend="wgrid", epsilon=1e-5)
SPOT = dict(niter=2, rmsfactor=0.8, l1reweight_from=1, pd_maxit=30,
            verbose=0, write=False, backend="wgrid", epsilon=1e-5)
KLEAN = dict(niter=2, epsilon=1e-5, verbose=0, write=False, minor_maxit=20,
             cg_maxit=20)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    ms = str(d / "obs.npz")
    truth_j = simulate_ms_j(ms, **SIM)
    truth_t = simulate_ms_t(str(d / "obs_t.npz"), **SIM)
    xj = init_j(ms=ms, output_filename=str(d / "j"), channels_per_image=1)
    xt = init_t(ms=ms, channels_per_image=1, write=False, device="cpu")
    dj = grid_j(xdsi=xj, output_filename=str(d / "j"), **GRID)
    dt = grid_t(xdsi=xt, write=False, device="cpu", **GRID)
    # one shared spectral norm so the fft runs compare iterate by iterate
    st = {}
    spotless_t(ddsi=[dict(x) for x in dt], engine="fft", stats=st,
               **dict(SPOT, niter=1, pd_maxit=1))
    return dict(d=d, ms=ms, truth_j=truth_j, truth_t=truth_t, xj=xj,
                xt=xt, dj=dj, dt=dt, hessnorm=st["hessnorm"])


def test_simulate_init_grid_match_jax(run):
    d = run["d"]
    a = np.load(run["ms"])
    b = np.load(str(d / "obs_t.npz"))
    assert _rel(b["DATA"], a["DATA"]) < 1e-10
    np.testing.assert_array_equal(b["UVW"], a["UVW"])
    for p, q in zip(run["xj"], run["xt"]):
        assert _rel(q["VIS"], p["VIS"]) < 1e-12
        np.testing.assert_allclose(q["WEIGHT"], p["WEIGHT"], rtol=1e-12)
    for p, q in zip(run["dj"], run["dt"]):
        for key in ("DIRTY", "PSF", "PSFHAT_real", "PSFHAT_imag"):
            assert _rel(q[key], p[key]) < 1e-10, key
        assert q["WSUM"][0] == pytest.approx(p["WSUM"][0], rel=1e-12)


def test_spotless_fft_matches_jax(run):
    """engine="fft", float64, same hessnorm: model and residual at 1e-8
    relative."""
    kw = dict(SPOT, engine="fft", hessnorm=run["hessnorm"])
    mj, rj = spotless_j(ddsi=[dict(x) for x in run["dj"]], **kw)
    mt, rt = spotless_t(ddsi=[dict(x) for x in run["dt"]], device="cpu",
                        **kw)
    assert np.abs(mj).max() > 0
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8


def test_spotless_pallas_matches_own_fft(run):
    """The kernel engine (its plain version on the CPU, float64 here)
    against the fft engine: 1e-6 relative. This PSF carries a w term, so
    it is not even and real_transfer="auto" keeps the complex H (checked
    below): the two engines compute the same operator."""
    from pfb_tpu_torch.ops.psf import make_psf_convolve_pallas
    from pfb_tpu_torch.workers.cubes import dds2cubes
    psf = dds2cubes(run["dt"], 2)[3]
    assert not make_psf_convolve_pallas(torch.as_tensor(psf), NX,
                                        NX).real_transfer
    kw = dict(SPOT, hessnorm=run["hessnorm"])
    st = {}
    mp, rp = spotless_t(ddsi=[dict(x) for x in run["dt"]], engine="pallas",
                        stats=st, **kw)
    mf, rf = spotless_t(ddsi=[dict(x) for x in run["dt"]], engine="fft",
                        **kw)
    assert st["engine"] == "pallas"
    assert _rel(mp, mf) < 1e-6
    assert _rel(rp, rf) < 1e-6


def test_spotless_pallas_matches_jax_pallas(run):
    """Port engine="pallas" against the JAX Pallas engine in interpret
    mode (float32 pipeline there): the 1e-3 bound of
    tests/test_fused_solvers.py."""
    kw = dict(SPOT, engine="pallas", hessnorm=run["hessnorm"])
    mj, _ = spotless_j(ddsi=[dict(x) for x in run["dj"]], **kw)
    mt, _ = spotless_t(ddsi=[dict(x) for x in run["dt"]], device="cpu",
                       **kw)
    assert np.abs(mt).max() > 0
    assert _rel(mt, mj) < 1e-3


def test_port_deconvolves_store_written_by_jax(run, tmp_path):
    """pfb_tpu._grid writes the dds store (PSFHAT_real/imag included);
    both packages deconvolve from their own copy of it."""
    src = Path(f"{run['d']}/j_I_main.dds")
    for name in ("a", "b"):
        shutil.copytree(src, tmp_path / f"{name}_I_main.dds")
    kw = dict(SPOT, engine="fft", hessnorm=run["hessnorm"], write=True)
    mj, rj = spotless_j(output_filename=str(tmp_path / "a"), **kw)
    mt, rt = spotless_t(output_filename=str(tmp_path / "b"), device="cpu",
                        **kw)
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8
    from pfb_tpu_torch.utils import dstore
    back = dstore.read_store(str(tmp_path / "b_I_main.dds"))
    assert back[0]["niters"] == SPOT["niter"]
    assert _rel(np.stack([ds["MODEL"] for ds in back]), mt) < 1e-12


@pytest.fixture(scope="module")
def run_pg(run):
    """The pg path on the same xds: Briggs 0, epsilon 1e-5."""
    kw = dict(GRID, backend="pg", robustness=0.0)
    dj = grid_j(xdsi=run["xj"], output_filename=str(run["d"] / "jpg"), **kw)
    dt = grid_t(xdsi=run["xt"], write=False, device="cpu", **kw)
    return dict(dj=dj, dt=dt)


def test_pg_grid_matches_jax(run_pg):
    """pg DIRTY/PSF/WEIGHT against JAX pg (its Pallas kernels in
    interpret mode): 1e-10 relative."""
    for p, q in zip(run_pg["dj"], run_pg["dt"]):
        for key in ("DIRTY", "PSF", "PSFHAT_real", "PSFHAT_imag", "WEIGHT",
                    "COUNTS"):
            assert _rel(q[key], p[key]) < 1e-10, key
        assert q["WSUM"][0] == pytest.approx(p["WSUM"][0], rel=1e-12)


def test_pg_spotless_matches_jax(run, run_pg):
    """spotless with the pg residual (2 datasets: the shared-geometry
    Hessian), engine="fft", same hessnorm: model and residual at 1e-8
    relative."""
    kw = dict(SPOT, backend="pg", engine="fft", hessnorm=run["hessnorm"])
    mj, rj = spotless_j(ddsi=[dict(x) for x in run_pg["dj"]], **kw)
    mt, rt = spotless_t(ddsi=[dict(x) for x in run_pg["dt"]], device="cpu",
                        **kw)
    assert np.abs(mj).max() > 0
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8


def _pg_blocks(dds):
    """The blocked plans of a plane_block=2 residual on these datasets."""
    from pfb_tpu_torch.ops.gridder import make_hessian_dds
    return [(bp["nw"], bp["B"], bp["nblocks"]) for bp in make_hessian_dds(
        dds, 2, 1.0, NX, NX, backend="pg", epsilon=1e-5, plane_block=2,
        device="cpu").plans]


def test_pg_spotless_plane_block_matches_jax(run, run_pg):
    """spotless with the w-plane-blocked pg residual (plane_block=2, one
    blocked plan per dataset), engine="fft", same hessnorm: model and
    residual at 1e-8 relative."""
    assert all(nb > 1 and B == 2 for _, B, nb in _pg_blocks(run_pg["dt"]))
    kw = dict(SPOT, backend="pg", engine="fft", plane_block=2,
              hessnorm=run["hessnorm"])
    mj, rj = spotless_j(ddsi=[dict(x) for x in run_pg["dj"]], **kw)
    mt, rt = spotless_t(ddsi=[dict(x) for x in run_pg["dt"]], device="cpu",
                        **kw)
    assert np.abs(mj).max() > 0
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8


def test_pg_klean_plane_block_matches_jax(run_pg):
    """klean with the w-plane-blocked pg residual (plane_block=2): Clark
    minor cycles, the exact residual, the flux mop at the last
    iteration; model and residual at 1e-8 relative."""
    assert all(nb > 1 for _, _, nb in _pg_blocks(run_pg["dt"]))
    kw = dict(KLEAN, backend="pg", plane_block=2)
    mj, rj = klean_j(ddsi=[dict(x) for x in run_pg["dj"]], **kw)
    st = {}
    mt, rt = klean_t(ddsi=[dict(x) for x in run_pg["dt"]], device="cpu",
                     stats=st, **kw)
    assert np.abs(mj).max() > 0
    assert len(st["rms"]) == KLEAN["niter"]
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8


@pytest.fixture(scope="module")
def run_general(run):
    """wgrid DIRTY and a 3x oversized PSF (384^2): 128-aligned, but no v3
    shape, so engine="pallas" takes the general PSF kernel (K11) in both
    packages; and the port's hessnorm of that PSF."""
    kw = dict(GRID, psf_oversize=3.0)
    dj = grid_j(xdsi=run["xj"], output_filename=str(run["d"] / "jk11"), **kw)
    dt = grid_t(xdsi=run["xt"], write=False, device="cpu", **kw)
    st = {}
    spotless_t(ddsi=[dict(x) for x in dt], engine="fft", stats=st,
               **dict(SPOT, niter=1, pd_maxit=1))
    return dict(dj=dj, dt=dt, hessnorm=st["hessnorm"])


def test_spotless_pallas_general_route_matches_jax(run_general,
                                                   monkeypatch):
    """engine="pallas" at a 128-aligned shape outside v3 (PSF 3x the
    image): both packages run the general PSF kernel (the port's plain
    K11 in float64, JAX's Pallas pipeline in interpret mode, float32) and
    primal_dual_hostloop, which tests convergence every 4 iterations. With
    no reweighting PD converges before pd_maxit in the second major
    iteration, where the every-iteration primal_dual stops earlier: the
    same pd_iters as the JAX package, model within 1e-3 (the bound of
    test_spotless_pallas_matches_jax_pallas)."""
    import pfb_tpu.workers.spotless as spotless_mod
    iters_j = []

    def recording(*a, **k):
        out = hostloop_j(*a, **k)
        iters_j.append(int(out[3]))
        return out

    hostloop_j = spotless_mod.primal_dual_hostloop
    monkeypatch.setattr(spotless_mod, "primal_dual_hostloop", recording)
    kw = dict(SPOT, engine="pallas", l1reweight_from=5, pd_maxit=60,
              pd_tol=1e-2, hessnorm=run_general["hessnorm"])
    assert run_general["dt"][0]["PSF"].shape == (3 * NX, 3 * NX)
    mj, _ = spotless_j(ddsi=[dict(x) for x in run_general["dj"]], **kw)
    st, st_fft = {}, {}
    mt, _ = spotless_t(ddsi=[dict(x) for x in run_general["dt"]],
                       device="cpu", stats=st, **kw)
    spotless_t(ddsi=[dict(x) for x in run_general["dt"]], device="cpu",
               stats=st_fft, **dict(kw, engine="fft"))
    assert st["engine"] == "pallas"
    assert st["pd_solver"] == "primal_dual_hostloop"
    assert st_fft["pd_solver"] == "primal_dual"
    assert st["pd_iters"] == iters_j
    assert iters_j[-1] < kw["pd_maxit"] and iters_j[-1] % 4 == 0
    assert st_fft["pd_iters"][-1] != iters_j[-1]
    assert np.abs(mj).max() > 0
    assert _rel(mt, mj) < 1e-3


def test_spotless_pallas_unaligned_falls_back_with_host_loop(run, caplog):
    """engine="pallas" at an image that is not 128-aligned: the fft
    operator with a logged warning, and still primal_dual_hostloop, as
    the JAX package does (workers/spotless.py:75-87, 206-215)."""
    dt = grid_t(xdsi=run["xt"], write=False, device="cpu",
                **dict(GRID, nx=120, ny=120))
    st = {}
    with caplog.at_level("WARNING"):
        spotless_t(ddsi=dt, device="cpu", stats=st,
                   **dict(SPOT, engine="pallas", niter=1, pd_maxit=8,
                          hessnorm=run["hessnorm"]))
    assert st["engine"] == "fft"
    assert st["pd_solver"] == "primal_dual_hostloop"
    assert "falling back to engine='fft'" in caplog.text


def test_import_leaves_jax_out(tmp_path):
    """Importing pfb_tpu_torch (and the port's lab scripts) and running
    its CPU path imports neither jax nor pfb_tpu."""
    scripts = Path(__file__).resolve().parents[1] / "scripts"
    code = f"""
import sys
import pfb_tpu_torch.workers.spotless, pfb_tpu_torch.workers.grid
import pfb_tpu_torch.parallel.dist, pfb_tpu_torch.parallel.dwt_halo
import pfb_tpu_torch.parallel.runtime
import pfb_tpu_torch.ops.pallas_fft, pfb_tpu_torch.utils.fits
import pfb_tpu_torch.ops.memlab, pfb_tpu_torch.models
import pfb_tpu_torch.workers.model2comps, pfb_tpu_torch.workers.degrid
import pfb_tpu_torch.workers.restore, pfb_tpu_torch.workers.fluxmop
import pfb_tpu_torch.utils.restoration
import pfb_tpu_torch.utils.astrometry, pfb_tpu_torch.utils.spi
import pfb_tpu_torch.ops.gauss, pfb_tpu_torch.ops.mask
import pfb_tpu_torch.workers.concat, pfb_tpu_torch.workers.fwdbwd
import pfb_tpu_torch.workers.fastim, pfb_tpu_torch.workers.smoovie
import pfb_tpu_torch.ops.mmgridder
sys.path.insert(0, {str(scripts)!r})
import torch_kernel_lab, torch_g2i_lab, torch_capacity_lab, chip_smoke
from pfb_tpu_torch.utils.ms import simulate_ms
from pfb_tpu_torch.workers.init import _init
from pfb_tpu_torch.workers.grid import _grid
from pfb_tpu_torch.workers.spotless import _spotless
from pfb_tpu_torch.workers.klean import _klean
ms = {str(tmp_path / 'o.npz')!r}
simulate_ms(ms, nant=5, ntime=2, nchan=1, nsource=1, fov_deg=0.1, seed=1)
xds = _init(ms=ms, write=False, device="cpu")
dds = _grid(xdsi=xds, write=False, device="cpu", nx=128, backend="wgrid",
            psf=True, residual=False)
_spotless(ddsi=dds, write=False, device="cpu", engine="pallas", niter=1,
          pd_maxit=2, pm_maxit=3, backend="wgrid", verbose=0)
dds = _grid(xdsi=xds, write=False, device="cpu", nx=128, backend="pg",
            robustness=0.0, psf=True, residual=False)
_spotless(ddsi=dds, write=False, device="cpu", engine="pallas", niter=1,
          pd_maxit=2, pm_maxit=3, backend="pg", verbose=0)
model, _ = _klean(ddsi=dds, write=False, device="cpu", niter=1,
                  backend="pg", plane_block=2, minor_maxit=2, cg_maxit=3,
                  verbose=0)
from pfb_tpu_torch.workers.model2comps import _model2comps
from pfb_tpu_torch.workers.degrid import _degrid
from pfb_tpu_torch.workers.restore import _restore
from pfb_tpu_torch.workers.fluxmop import _fluxmop
for ds in dds:
    ds["MODEL"] = model[ds["bandid"]]
mds = _model2comps(ddsi=dds)
_degrid(ms=ms, mds=mds, backend="pg", write=False, device="cpu")
_grid(xdsi=xds, write=False, device="cpu", nx=128, backend="pg", psf=False,
      transfer_model_from=mds)
_restore(ddsi=dds, output_filename={str(tmp_path / 'r')!r}, outputs="i")
_fluxmop(ddsi=dds, write=False, device="cpu", backend="pg", cg_maxit=2,
         space_shards=2, devices=["cpu"] * 2, verbose=0)
from pfb_tpu_torch.parallel.mesh import make_mesh
from pfb_tpu_torch.workers.spotless import _spotless_dist
_spotless_dist(mesh=make_mesh(1, 2, ["cpu"] * 2), ddsi=dds, write=False,
               engine="pallas", niter=1, pd_maxit=2, pm_maxit=3,
               backend="pg", verbose=0)
dds = _grid(xdsi=xds, write=False, device="cpu", nx=128, backend="wgrid",
            psf_oversize=3.0, psf=True, residual=False)
_spotless(ddsi=dds, write=False, device="cpu", engine="pallas", niter=1,
          pd_maxit=2, pm_maxit=3, backend="wgrid", verbose=0)
from pfb_tpu_torch.workers.fwdbwd import _fwdbwd
from pfb_tpu_torch.workers.fastim import _fastim
from pfb_tpu_torch.workers.smoovie import _smoovie
_fwdbwd(ddsi=dds, write=False, device="cpu", backend="wgrid", niter=1,
        parametrisation="exp", pd_maxit=2, pm_maxit=3, cg_maxit=2,
        verbose=0)
fds = _fastim(ms=ms, write=False, device="cpu", nx=64, backend="pg",
              mds=mds, robustness=0.0)
_smoovie(fdsi=fds, output_filename={str(tmp_path / 'm')!r})
_init(ms=ms, write=False, device="cpu", radec="Sun", site_latitude=-0.5)
_grid(xdsi=xds, write=False, device="cpu", nx=64, target="Sun",
      concat_row=True, nband=1, psf=False)
dds = _grid(xdsi=xds, write=False, device="cpu", nx=64, backend="mm",
            psf=True, residual=False)
_spotless(ddsi=dds, write=False, device="cpu", engine="pallas", niter=1,
          pd_maxit=2, pm_maxit=3, backend="mm", verbose=0)
from pfb_tpu_torch.ops.gridder import make_hess_vis_dct
make_hess_vis_dct([dict(dds[0], key="k")],
                  {{"f": dict(nx=64, ny=64, cell_rad=dds[0]["cell_rad"])}},
                  backend="mm", device="cpu")
import pfb_tpu_torch.workers.pipeline, pfb_tpu_torch.parser.schemas
import pfb_tpu_torch.utils.profiling
from pfb_tpu_torch.workers.main import cli
assert cli.main(["--help"], standalone_mode=False) == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "pfb_tpu")]
assert not bad, bad
print("clean")
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1]) + \
        os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout
