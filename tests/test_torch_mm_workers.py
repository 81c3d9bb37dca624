"""pfb_tpu_torch's workers with backend="mm" (which runs the pg gridder,
ops/gridder.py:ROUTES) and the multi-field joint Hessian
(ops/gridder.py:make_hess_vis_dct), CPU, float64, on the simulation of
tests/test_e2e_backends.py:23-33 (9 antennas, 6 integrations, 2
channels, 3 sources, 64^2).

- _grid(backend="mm"): the pg products within 1e-12 of max (the pg
  gridder's own run-to-run spread on the CPU is ~1e-15); DIRTY, PSF and
  PSFHAT within 2e-6 of max of the JAX package's _grid(backend="mm")
  (two gridders each within 1e-6 of the exact operator), WEIGHT and
  WSUM at 1e-10 / 1e-12;
- _klean through mm against the port's exact-DFT run: the model within
  1e-4 of its peak and the residual within 1e-3 of its peak
  (tests/test_e2e_backends.py:61);
- the residual round trips of tests/test_e2e_backends.py:83 through mm:
  grid(transfer_model_from) and degrid -> DATA-MODEL_DATA -> regrid,
  each within 1e-4 of the klean residual's peak;
- _degrid, _spotless, _fluxmop, _fwdbwd and _fastim through mm: the
  same calls through pg within 1e-12 relative (the pg runs are held to the JAX
  package by their own tests);
- --backend mm through the port's CLI (in process and as
  ``python -m pfb_tpu_torch.workers.main``): the grid step's DIRTY within
  1e-10 of _grid's;
- make_hess_vis_dct + cg_dct on tests/test_ingest.py:134's two fields
  (one offset by 60 field widths), for every backend: the matvec against
  the JAX package's same backend at 1e-10 (mm: the port's pg at 1e-12
  and the JAX package's mm within 2e-6 of max), H(truth) consistent with
  the data at 1e-8, self-adjoint at 1e-8, and the joint CG residual
  below 1e-3 of b.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pfb_tpu.ops.gridder import make_hess_vis_dct as hess_vis_j
from pfb_tpu.utils.ms import simulate_ms
from pfb_tpu.utils.simulation import image_size_for, simulate_obs
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu_torch.ops.gridder import get_backend
from pfb_tpu_torch.ops.gridder import make_hess_vis_dct as hess_vis_t
from pfb_tpu_torch.opt.pcg import cg_dct
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.workers.degrid import _degrid
from pfb_tpu_torch.workers.fastim import _fastim
from pfb_tpu_torch.workers.fluxmop import _fluxmop
from pfb_tpu_torch.workers.fwdbwd import _fwdbwd
from pfb_tpu_torch.workers.grid import _grid
from pfb_tpu_torch.workers.init import _init
from pfb_tpu_torch.workers.klean import _klean
from pfb_tpu_torch.workers.main import cli
from pfb_tpu_torch.workers.model2comps import _model2comps
from pfb_tpu_torch.workers.spotless import _spotless

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
CPU = "cpu"
FOV = 0.25
GRID = dict(suffix="main", field_of_view=FOV, robustness=0.0, psf=True,
            residual=False, write=False)
KLEAN = dict(niter=3, threshold=1e-5, gamma=0.1, peak_factor=0.75,
             sub_peak_factor=0.75, mop_flux=False, dirosion=0, verbose=0,
             write=False)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _mfs(dds, key, wsum):
    out = np.zeros((len(dds),) + dds[0][key].shape)
    for ds in dds:
        out[ds["bandid"]] += ds[key] / wsum
    return out


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm_workers")
    ms = str(d / "test.npz")
    model, Ix, Iy, nx, cell_rad, _ = simulate_ms(
        ms, nant=9, ntime=6, nchan=2, nsource=3, fov_deg=FOV, seed=99,
        gains=False)
    xds = _init(ms=ms, write=False, channels_per_image=1, device=CPU)
    return dict(d=d, ms=ms, nx=nx, xds=xds,
                dds={b: _grid(xdsi=xds, backend=b, device=CPU, **GRID)
                     for b in ("dft", "mm", "pg")})


@pytest.fixture(scope="module")
def klean_dft(sim):
    return _klean(ddsi=[dict(ds) for ds in sim["dds"]["dft"]],
                  backend="dft", device=CPU, **KLEAN)


IMG = ("DIRTY", "PSF", "PSFHAT_real", "PSFHAT_imag")
SAME = 1e-12


def test_grid_mm_matches_jax(sim):
    xj = init_j(ms=sim["ms"], write=False, channels_per_image=1)
    dj = grid_j(xdsi=xj, backend="mm", **GRID)
    for p, q, r in zip(dj, sim["dds"]["mm"], sim["dds"]["pg"]):
        for key in IMG:
            assert _rel(q[key], r[key]) < SAME, key
            assert _rel(q[key], p[key]) < 2e-6, key
        assert _rel(q["WEIGHT"], p["WEIGHT"]) < 1e-10
        assert q["WSUM"][0] == pytest.approx(p["WSUM"][0], rel=1e-12)


def test_klean_through_mm_tracks_dft(sim, klean_dft):
    rec, resid = _klean(ddsi=[dict(ds) for ds in sim["dds"]["mm"]],
                        backend="mm", device=CPU, **KLEAN)
    rec_ref, resid_ref = klean_dft
    assert np.abs(rec_ref).max() > 0
    assert _rel(rec, rec_ref) < 1e-4
    assert _rel(resid, resid_ref) < 1e-3


def test_degrid_regrid_residual_consistency_mm(sim, klean_dft, tmp_path):
    """The R / R.H round trip through mm: the klean model fitted to
    components, then (a) grid(transfer_model_from) and (b) degrid into
    MODEL_DATA, init(DATA-MODEL_DATA) and regrid; both reproduce the
    deconvolver's residual."""
    import shutil
    rec, resid = klean_dft
    dds = [dict(ds) for ds in sim["dds"]["mm"]]
    wsum = np.sum([ds["WSUM"][0] for ds in dds])
    for ds in dds:
        ds["MODEL"] = rec[ds["bandid"]]
    mds = _model2comps(ddsi=dds, nbasisf=rec.shape[0], fit_mode="Legendre")
    scale = np.abs(resid).max()

    kw = dict(GRID, psf=False, backend="mm", device=CPU)
    dds_t = _grid(xdsi=sim["xds"], transfer_model_from=mds,
                  **dict(kw, residual=True))
    res_t = _mfs(dds_t, "RESIDUAL", wsum)
    assert np.abs(res_t - resid).max() < 1e-4 * scale

    ms = str(tmp_path / "copy.npz")
    shutil.copy(sim["ms"], ms)
    _degrid(ms=ms, mds=mds, backend="mm", channels_per_image=1, device=CPU)
    xds2 = _init(ms=ms, write=False, data_column="DATA-MODEL_DATA",
                 channels_per_image=1, device=CPU)
    res_r = _mfs(_grid(xdsi=xds2, **kw), "DIRTY", wsum)
    assert np.abs(res_r - resid).max() < 1e-4 * scale


def test_degrid_mm_matches_pg(sim, klean_dft, tmp_path):
    rec, _ = klean_dft
    dds = [dict(ds, MODEL=rec[ds["bandid"]]) for ds in sim["dds"]["mm"]]
    mds = _model2comps(ddsi=dds, nbasisf=rec.shape[0])
    kw = dict(ms=sim["ms"], mds=mds, channels_per_image=1, epsilon=1e-7,
              write=False, device=CPU)
    assert _rel(_degrid(backend="mm", **kw), _degrid(backend="pg", **kw)) \
        < SAME


SPOT = dict(niter=2, rmsfactor=0.8, l1reweight_from=1, pd_maxit=30,
            verbose=0, write=False, epsilon=1e-7, engine="fft", hessnorm=1.0)
MOP = dict(sigmainv=1e-4, gamma=0.9, cg_maxit=20, cg_minit=5, verbose=0,
           epsilon=1e-7, use_psf=False, write=False)
FB = dict(niter=2, rmsfactor=0.3, gamma=1.0, bases="self,db1", nlevels=2,
          verbose=0, write=False, epsilon=1e-7)


@pmp("worker", ["spotless", "fluxmop", "fwdbwd"])
def test_deconvolvers_through_mm_match_pg(sim, worker):
    fn, kw = {"spotless": (_spotless, SPOT), "fluxmop": (_fluxmop, MOP),
              "fwdbwd": (_fwdbwd, FB)}[worker]
    out = {b: fn(ddsi=[dict(ds) for ds in sim["dds"]["pg"]], backend=b,
                 device=CPU, **kw) for b in ("mm", "pg")}
    assert np.abs(out["pg"][0]).max() > 0
    for a, b in zip(out["mm"], out["pg"]):
        assert _rel(a, b) < SAME


def test_fastim_through_mm_matches_pg(sim):
    kw = dict(ms=sim["ms"], epsilon=1e-7, integrations_per_image=2,
              field_of_view=FOV, write=False, device=CPU,
              precision="double")
    fm = _fastim(backend="mm", **kw)
    fp = _fastim(backend="pg", **kw)
    assert len(fm) == len(fp) == 3
    for a, b in zip(fm, fp):
        assert _rel(a["RESIDUAL"], b["RESIDUAL"]) < SAME


def test_cli_backend_mm(sim, tmp_path):
    """init and grid --backend mm through the CLI, in process and as a
    module run: the stored DIRTY within 1e-10 of _grid's."""
    out = str(tmp_path / "out")
    pre = ["--device", "cpu"]
    for args in (["init", "-ms", sim["ms"], "-o", out,
                  "--channels-per-image", "1"],
                 ["grid", "-o", out, "-fov", str(FOV), "-rob", "0.0",
                  "--backend", "mm", "--no-psf"]):
        r = CliRunner().invoke(cli, pre + args)
        assert r.exit_code == 0, (r.output, r.exception)
    got = dstore.read_store(out + "_I_main.dds")
    ref = sim["dds"]["mm"]
    for p, q in zip(ref, got):
        assert _rel(q["DIRTY"], p["DIRTY"]) < 1e-10
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-m", "pfb_tpu_torch.workers.main", *pre, "grid",
         "-o", out, "-fov", str(FOV), "-rob", "0.0", "--backend", "mm",
         "--no-psf", "--suffix", "mod"], cwd=root, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = dstore.read_store(out + "_I_mod.dds")
    for p, q in zip(ref, got):
        assert _rel(q["DIRTY"], p["DIRTY"]) < 1e-10


@pytest.fixture(scope="module")
def fields():
    """tests/test_ingest.py:134's two fields: one snapshot, the second
    field 60 field widths from the first; a point source in each."""
    obs = simulate_obs(nant=9, ntime=6, nchan=1, seed=2)
    nx, cell = image_size_for(obs, fov_deg=0.15)
    nx = min(nx, 32)
    geom = {
        "f0": dict(nx=nx, ny=nx, cell_rad=cell, x0=0.0, y0=0.0),
        "f1": dict(nx=nx, ny=nx, cell_rad=cell, x0=60 * nx * cell, y0=0.0),
    }
    truth = {}
    for f in geom:
        im = np.zeros((nx, nx))
        im[nx // 2 + (3 if f == "f1" else -4), nx // 2] = \
            1.0 if f == "f0" else 0.7
        truth[f] = im
    wgt = np.ones((obs.uvw.shape[0], 1))
    ds = dict(key="t0b0", UVW=obs.uvw, FREQ=obs.freq, WEIGHT=wgt,
              MASK=np.ones_like(wgt))
    return dict(obs=obs, geom=geom, truth=truth, ds=ds, nx=nx)


def _dot(a, c):
    return sum(float((a[f]["t0b0"] * c[f]["t0b0"]).sum()) for f in a)


@pmp("backend", ["dft", "wgrid", "pg", "mm"])
def test_hess_vis_dct_joint_solve_matches_jax(fields, backend):
    geom, ds, nx = fields["geom"], fields["ds"], fields["nx"]
    sigmainv = 1e-6
    ht = hess_vis_t([ds], geom, sigmainv=sigmainv, backend=backend,
                    device=CPU)
    hj = hess_vis_j([ds], geom, sigmainv=sigmainv, backend=backend)

    rng = np.random.default_rng(0)
    u = {f: {"t0b0": rng.normal(size=(nx, nx))} for f in geom}
    v = {f: {"t0b0": rng.normal(size=(nx, nx))} for f in geom}
    ut = {f: {k: torch.as_tensor(a) for k, a in s.items()}
          for f, s in u.items()}
    vt = {f: {k: torch.as_tensor(a) for k, a in s.items()}
          for f, s in v.items()}
    Huj = hj({f: {k: jnp.asarray(a) for k, a in s.items()}
              for f, s in u.items()})
    Hu, Hv = ht(ut), ht(vt)
    if backend == "mm":
        Hp = hess_vis_t([ds], geom, sigmainv=sigmainv, backend="pg",
                        device=CPU)(ut)
    for f in geom:
        if backend == "mm":
            assert _rel(Hu[f]["t0b0"], Hp[f]["t0b0"]) < SAME
            assert _rel(Hu[f]["t0b0"], Huj[f]["t0b0"]) < 2e-6
        else:
            assert _rel(Hu[f]["t0b0"], Huj[f]["t0b0"]) < 1e-10
    # self-adjointness across the field coupling
    assert abs(_dot(vt, Hu) - _dot(Hv, ut)) < 1e-8 * abs(_dot(vt, Hu))

    # H(truth) == b + sigmainv truth (the same R / R.H built the data)
    d2v, v2d = get_backend(backend)
    t = {k: torch.as_tensor(ds[k]) for k in ("UVW", "FREQ", "WEIGHT")}
    truth = {f: {"t0b0": torch.as_tensor(a)}
             for f, a in fields["truth"].items()}
    vis = sum(d2v(t["UVW"], t["FREQ"], truth[f]["t0b0"], g["cell_rad"],
                  g["cell_rad"], x0=g["x0"], y0=g["y0"])
              for f, g in geom.items())
    b = {f: {"t0b0": v2d(t["UVW"], t["FREQ"], vis, wgt=t["WEIGHT"], nx=nx,
                         ny=nx, cellx=g["cell_rad"], celly=g["cell_rad"],
                         x0=g["x0"], y0=g["y0"])} for f, g in geom.items()}
    Ht = ht(truth)
    for f in geom:
        err = (Ht[f]["t0b0"] - b[f]["t0b0"]
               - sigmainv * truth[f]["t0b0"]).abs().max()
        assert float(err) < 1e-8 * float(b[f]["t0b0"].abs().max())

    # joint CG drives the coupled residual down
    x0 = {f: {"t0b0": torch.zeros((nx, nx), dtype=torch.float64)}
          for f in geom}
    _, r = cg_dct(ht, b, x0, tol=1e-10, maxit=100)
    assert _dot(r, r) < 1e-3 * _dot(b, b)


@pmp("widths", [4, 60])
def test_far_field_float32_matches_float64(fields, widths):
    """The pg gridder in float32 (the card's type, here on the CPU) at a
    phase centre ``widths`` field widths away, as the joint Hessian's
    second field is, against float64: R.H and R within 1e-5 of max. The
    centre-shift phase there runs to thousands of turns, so the plans
    keep uvw in float64 and form it there."""
    from pfb_tpu_torch.ops.pgridder import dirty2vis_pg, vis2dirty_pg
    obs, nx = fields["obs"], fields["nx"]
    cell = fields["geom"]["f0"]["cell_rad"]
    rng = np.random.default_rng(1)
    vis = rng.normal(size=(obs.uvw.shape[0], 1)) + \
        1j * rng.normal(size=(obs.uvw.shape[0], 1))
    img = rng.normal(size=(nx, nx))
    kw = dict(epsilon=1e-5, x0=widths * nx * cell, y0=0.0)
    out = {}
    for cdt, rdt in ((torch.complex64, torch.float32),
                     (torch.complex128, torch.float64)):
        uvw, freq = torch.as_tensor(obs.uvw), torch.as_tensor(obs.freq)
        out[rdt] = (
            vis2dirty_pg(uvw, freq, torch.as_tensor(vis).to(cdt), nx=nx,
                         ny=nx, cellx=cell, celly=cell, **kw),
            dirty2vis_pg(uvw, freq, torch.as_tensor(img).to(rdt), cell, cell,
                         **kw))
    for a, b in zip(out[torch.float32], out[torch.float64]):
        assert a.dtype in (torch.float32, torch.complex64)
        assert _rel(a.to(b.dtype), b) < 1e-5
