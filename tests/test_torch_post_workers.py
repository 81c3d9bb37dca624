"""pfb_tpu_torch's post-deconvolution workers (model2comps, degrid,
restore, fluxmop, grid's transfer_model_from) and their host helpers
against pfb_tpu on the same observation (CPU, float64), at the size of
tests/test_aux_workers.py:10 (8 antennas, 6 integrations, 2 channels,
108^2).

- model2comps with ``min_val`` and the json and store formats: the same
  mds (coefficients 1e-10 relative; tests/test_aux_workers.py:281);
- degrid (``dft``, ``pg``): the model column at 1e-10 relative, the gate
  of tests/test_torch_pgridder.py::test_pg_operators_match_jax;
- per backend (``dft``, ``wgrid``, ``pg``) the two residual paths of
  tests/test_models_io.py:71 and tests/test_e2e_backends.py:83: degrid ->
  DATA-MODEL_DATA -> regrid, and grid(transfer_model_from), each within
  1e-4 of the residual peak of the exact residual, and the transfer
  residual against the JAX package's at 1e-8 relative;
- restore: every product array at 1e-10 relative and the same FITS file
  names, with ``residual_name`` (tests/test_models_io.py:126,
  tests/test_aux_workers.py:305);
- the misc helpers (tests/test_misc2.py:9, 25, 35, tests/test_spi.py:26):
  1e-12;
- fluxmop: model and residual at 1e-8 relative for use_psf True / False
  and dft / pg, the mask options, and space_shards=2 on a 2 x 2 virtual
  CPU mesh against the single-program step; which Hessian its PCG ran
  (stats["hessian"]) on a (1, 4) mesh and on the fallback;
- grid's ``target``, ``concat_row`` and ``nband`` re-binning:
  DIRTY, PSF (and RESIDUAL with a model) at 1e-10 relative.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pfb_tpu.utils import dstore as dstore_j
from pfb_tpu.utils.ms import read_ms, simulate_ms
from pfb_tpu.workers.degrid import _degrid as degrid_j
from pfb_tpu.workers.fluxmop import _fluxmop as fluxmop_j
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu.workers.model2comps import _model2comps as m2c_j
from pfb_tpu.workers.restore import _restore as restore_j
from pfb_tpu_torch.ops.gridder import make_hessian_dds
from pfb_tpu_torch.utils import dstore as dstore_t
from pfb_tpu_torch.workers.degrid import _degrid as degrid_t
from pfb_tpu_torch.workers.fluxmop import _fluxmop as fluxmop_t
from pfb_tpu_torch.workers.grid import _grid as grid_t
from pfb_tpu_torch.workers.init import _init as init_t
from pfb_tpu_torch.workers.model2comps import _model2comps as m2c_t
from pfb_tpu_torch.workers.restore import _restore as restore_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
FOV = 0.3
GRID = dict(field_of_view=FOV, robustness=0.0, psf=True, residual=False,
            write=False)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _copies(dds, model=None):
    out = [dict(ds) for ds in dds]
    if model is not None:
        for ds in out:
            ds["MODEL"] = model[ds["bandid"]].copy()
    return out


def _mfs(dds, key):
    wsum = sum(float(ds["WSUM"][0]) for ds in dds)
    return sum(ds[key] for ds in dds) / wsum


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("post")
    ms = str(d / "t.npz")
    model, Ix, Iy, nx, cell_rad, _ = simulate_ms(
        ms, nant=8, ntime=6, nchan=2, nsource=3, fov_deg=FOV, seed=21)
    xj = init_j(ms=ms, write=False, channels_per_image=1)
    xt = init_t(ms=ms, write=False, channels_per_image=1, device="cpu")
    dj = grid_j(xdsi=xj, **GRID)
    dt = grid_t(xdsi=xt, device="cpu", **GRID)
    # a deconvolved model: 0.8 of the truth at the true pixels
    return dict(d=d, ms=ms, model=0.8 * model, nx=nx, xj=xj, xt=xt, dj=dj,
                dt=dt)


def _ms_copy(pipe, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copy(pipe["ms"], dst)
    return dst


def _mds(pipe, **kw):
    mj = m2c_j(ddsi=_copies(pipe["dj"], pipe["model"]), **kw)
    mt = m2c_t(ddsi=_copies(pipe["dt"], pipe["model"]), **kw)
    return mj, mt


def _same_mds(mt, mj):
    assert set(mt) == set(mj)
    for k in mj:
        if k == "coefficients":
            assert _rel(mt[k], mj[k]) < 1e-10
        elif isinstance(mj[k], np.ndarray):
            np.testing.assert_array_equal(mt[k], mj[k])
        else:
            assert mt[k] == mj[k], k


def test_model2comps_minval_json_matches_jax(pipe, tmp_path):
    dds_j, dds_t = _copies(pipe["dj"]), _copies(pipe["dt"])
    for d in dds_j + dds_t:
        m = np.zeros_like(d["DIRTY"])
        m[10, 10] = 1.0
        m[20, 20] = 1e-4
        d["MODEL"] = m
    kw = dict(min_val=1e-2, out_format="json")
    mj = m2c_j(ddsi=dds_j, output_filename=str(tmp_path / "j"), **kw)
    mt = m2c_t(ddsi=dds_t, output_filename=str(tmp_path / "t"), **kw)
    assert len(mt["location_x"]) == 1  # weak source thresholded away
    _same_mds(mt, mj)
    names = sorted(os.listdir(tmp_path))
    assert names == ["j_I_main_model.mds.json", "t_I_main_model.mds.json"]
    with open(tmp_path / names[0]) as f:
        sj = json.load(f)
    with open(tmp_path / names[1]) as f:
        st = json.load(f)
    assert set(st) == set(sj)
    assert st["parametrisation"] == sj["parametrisation"]
    assert _rel(st["coefficients"], sj["coefficients"]) < 1e-10
    with pytest.raises(ValueError):
        m2c_t(ddsi=dds_t, min_val=10.0)


@pmp("fit_mode", ["poly", "Legendre"])
def test_model2comps_store_matches_jax(pipe, tmp_path, fit_mode):
    """The zarr-layout mds store: each package reads the other's."""
    kw = dict(fit_mode=fit_mode, nbasisf=2, use_wsum=fit_mode == "poly")
    mj = m2c_j(ddsi=_copies(pipe["dj"], pipe["model"]),
               output_filename=str(tmp_path / "j"), **kw)
    mt = m2c_t(ddsi=_copies(pipe["dt"], pipe["model"]),
               output_filename=str(tmp_path / "t"), **kw)
    _same_mds(mt, mj)
    back_j = dstore_j.read_store(str(tmp_path / "t_I_main_model.mds"))[0]
    back_t = dstore_t.read_store(str(tmp_path / "j_I_main_model.mds"))[0]
    for back in (back_j, back_t):
        assert back["parametrisation"] == mj["parametrisation"]
        assert _rel(back["coefficients"], mj["coefficients"]) < 1e-10


@pmp("backend", ["dft", "pg"])
def test_degrid_matches_jax(pipe, tmp_path, backend):
    mj, mt = _mds(pipe, fit_mode="Legendre")
    msj = _ms_copy(pipe, tmp_path, "j.npz")
    mst = _ms_copy(pipe, tmp_path, "t.npz")
    kw = dict(backend=backend, channels_per_image=1, epsilon=1e-7)
    vj = degrid_j(ms=msj, mds=mj, **kw)
    stats = {}
    vt = degrid_t(ms=mst, mds=mt, device="cpu", stats=stats, **kw)
    assert vt.shape == vj.shape and vt.dtype == np.complex128
    assert _rel(vt, vj) < 1e-10
    np.testing.assert_array_equal(read_ms(mst)["MODEL_DATA"], vt)
    assert stats["nimages"] == 2
    assert (stats["plan_s"] > 0) == (backend == "pg")
    # accumulate adds the existing column
    v2 = degrid_t(ms=mst, mds=mt, device="cpu", accumulate=True, **kw)
    np.testing.assert_allclose(v2, 2 * vt, rtol=1e-14)


@pmp("backend", ["dft", "wgrid", "pg"])
def test_residual_round_trips(pipe, tmp_path, backend):
    """The deconvolver's exact residual, from the mds two ways: grid with
    transfer_model_from, and degrid -> DATA-MODEL_DATA -> regrid."""
    kw = dict(GRID, psf=False, backend=backend, epsilon=1e-7)
    model = pipe["model"]
    dds = grid_t(xdsi=pipe["xt"], device="cpu", **kw)
    nband = len(dds)
    wsum = sum(float(ds["WSUM"][0]) for ds in dds)
    hess = make_hessian_dds(dds, nband, wsum, pipe["nx"], pipe["nx"],
                            use_beam=False, backend=backend, epsilon=1e-7,
                            device="cpu")
    dirty = np.stack([ds["DIRTY"] for ds in dds]) / wsum
    resid = dirty - hess(torch.as_tensor(model)).numpy()
    scale = np.abs(resid).max()
    mj, mt = _mds(pipe, fit_mode="Legendre")

    # (a) transfer_model_from: the residual made at grid time
    dds_a = grid_t(xdsi=pipe["xt"], device="cpu", transfer_model_from=mt,
                   **dict(kw, residual=True))
    res_a = np.stack([ds["RESIDUAL"] for ds in dds_a]) / wsum
    assert np.abs(res_a - resid).max() < 1e-4 * scale
    np.testing.assert_allclose(np.stack([ds["MODEL"] for ds in dds_a]),
                               model, atol=1e-12)
    dds_aj = grid_j(xdsi=pipe["xj"], transfer_model_from=mj,
                    **dict(kw, residual=True))
    assert _rel(res_a, np.stack([ds["RESIDUAL"] for ds in dds_aj]) / wsum) \
        < 1e-8

    # (b) degrid, subtract, regrid: DIRTY(DATA - MODEL_DATA) == residual
    ms = _ms_copy(pipe, tmp_path, "r.npz")
    degrid_t(ms=ms, mds=str(_write_mds(mt, tmp_path)), backend=backend,
             channels_per_image=1, epsilon=1e-7, device="cpu")
    xds2 = init_t(ms=ms, write=False, data_column="DATA-MODEL_DATA",
                  channels_per_image=1, device="cpu")
    dds_b = grid_t(xdsi=xds2, device="cpu", **kw)
    res_b = np.stack([ds["DIRTY"] for ds in dds_b]) / wsum
    assert np.abs(res_b - resid).max() < 1e-4 * scale


def _write_mds(mds, tmp_path):
    name = tmp_path / "m.mds"
    dstore_t.write_store(str(name), [mds])
    return name


def test_grid_target_matches_jax(pipe):
    """_grid(target=...): each dataset's image recentred through (x0, y0)
    from radec_to_lm of the target (reference grid.py:371), with a model
    so the residual's degrid runs off-centre too; DIRTY, PSF and
    RESIDUAL at 1e-10 relative, x0 / y0 and BEAM exact to 1e-12."""
    ra, dec = pipe["xt"][0]["ra"], pipe["xt"][0]["dec"]
    kw = dict(GRID, target=f"{ra + 1e-3},{dec - 7e-4}", residual=True)
    freqs = sorted({ds["freq_out"] for ds in pipe["xt"]})
    xt, xj = ([dict(ds, MODEL=pipe["model"][freqs.index(ds["freq_out"])])
               for ds in x] for x in (pipe["xt"], pipe["xj"]))
    dt = grid_t(xdsi=xt, device="cpu", **kw)
    dj = grid_j(xdsi=xj, **kw)
    assert dt[0]["x0"] != 0.0 and dt[0]["y0"] != 0.0
    for a, b in zip(dt, dj):
        assert abs(a["x0"] - b["x0"]) <= 1e-12 * abs(b["x0"])
        assert abs(a["y0"] - b["y0"]) <= 1e-12 * abs(b["y0"])
        assert _rel(a["BEAM"], b["BEAM"]) < 1e-12
        for k in ("DIRTY", "PSF", "RESIDUAL"):
            assert _rel(a[k], b[k]) < 1e-10, k


@pytest.fixture(scope="module")
def xds4(tmp_path_factory):
    """Single-channel xds of a 4-channel observation in 2 time chunks:
    4 bands x 2 times, from both packages."""
    ms = str(tmp_path_factory.mktemp("concat") / "t.npz")
    simulate_ms(ms, nant=7, ntime=6, nchan=4, nsource=2, fov_deg=FOV,
                seed=5)
    kw = dict(write=False, channels_per_image=1, integrations_per_image=3)
    return init_t(ms=ms, device="cpu", **kw), init_j(ms=ms, **kw)


@pmp("opt", [dict(concat_row=True), dict(nband=2),
             dict(nband=2, concat_row=True)])
def test_grid_concat_matches_jax(xds4, opt):
    """_grid(concat_row=True) joins each band's time chunks into one
    dataset and _grid(nband=2) re-bins the 4 single-channel bands into 2
    (workers/concat.py, reference grid.py:203-214); the datasets' count,
    bands and times, and DIRTY and PSF at 1e-10 relative."""
    xt, xj = xds4
    kw = dict(GRID, **opt)
    dt = grid_t(xdsi=xt, device="cpu", **kw)
    dj = grid_j(xdsi=xj, **kw)
    nb = opt.get("nband", 4)
    assert len(dt) == len(dj) == nb * (1 if opt.get("concat_row") else 2)
    for a, b in zip(dt, dj):
        for k in ("bandid", "timeid", "freq_out", "time_out"):
            assert a[k] == b[k], k
        for k in ("DIRTY", "PSF", "WSUM"):
            assert _rel(a[k], b[k]) < 1e-10, k


def _files(d, prefix):
    return sorted(os.path.basename(p)[len(prefix):]
                  for p in glob.glob(str(d / (prefix + "*.fits"))))


def test_restore_matches_jax(pipe, tmp_path):
    dds_j = _copies(pipe["dj"], pipe["model"])
    dds_t = _copies(pipe["dt"], pipe["model"])
    for d in dds_j + dds_t:
        d["RESIDUAL"] = 0.5 * d["DIRTY"]
    outputs = "mMrRdDiIcCfF"
    rj = restore_j(ddsi=dds_j, output_filename=str(tmp_path / "j"),
                   outputs=outputs)
    rt = restore_t(ddsi=dds_t, output_filename=str(tmp_path / "t"),
                   outputs=outputs)
    assert set(rt) == set(rj) and "image_mfs" in rt and "cpsf" in rt
    for k in rj:
        d = rt[k] - rj[k]
        if "phase" in k:
            # angles of near-real coefficients may land on -pi or pi
            d = d - 2 * np.pi * np.round(d / (2 * np.pi))
        assert np.abs(d).max() < 1e-10 * np.abs(rj[k]).max(), k
    fj, ft = _files(tmp_path, "j"), _files(tmp_path, "t")
    assert ft == fj and len(ft) == 14


def test_restore_residual_name_matches_jax(pipe, tmp_path):
    dds_j, dds_t = _copies(pipe["dj"]), _copies(pipe["dt"])
    for d in dds_j + dds_t:
        d["MODEL"] = np.zeros_like(d["DIRTY"])
        d["UPDATE"] = np.ones_like(d["DIRTY"])
    kw = dict(outputs="rR", residual_name="UPDATE", nband=2)
    rj = restore_j(ddsi=dds_j, output_filename=str(tmp_path / "j"), **kw)
    rt = restore_t(ddsi=dds_t, output_filename=str(tmp_path / "t"), **kw)
    wsum = np.sum([d["WSUM"][0] for d in dds_t])
    assert np.allclose(rt["residual_mfs"], 2 / wsum)
    for k in rj:
        assert _rel(rt[k], rj[k]) < 1e-12
    assert _files(tmp_path, "t") == _files(tmp_path, "j")


def test_misc_helpers_match_jax():
    from pfb_tpu.ops.fft import get_padding_info as gpi_j
    from pfb_tpu.utils import misc as mj
    from pfb_tpu.utils.restoration import restore_image as ri_j
    from pfb_tpu_torch.ops.fft import get_padding_info as gpi_t
    from pfb_tpu_torch.utils import misc as mt
    from pfb_tpu_torch.utils.restoration import restore_image as ri_t

    rng = np.random.default_rng(4)
    A = [rng.standard_normal((3, 3)), rng.standard_normal((4, 4)),
         rng.standard_normal((5, 5))]
    b = rng.standard_normal((3, 4, 5))
    out = mt.kron_matvec(A, b)
    np.testing.assert_allclose(out, mj.kron_matvec(A, b), rtol=1e-14)
    full = np.kron(np.kron(A[0], A[1]), A[2]) @ b.ravel()
    np.testing.assert_allclose(out.ravel(), full, rtol=1e-12, atol=1e-12)

    for p, q, n, npsf in ((0, 0, 64, 128), (10, 50, 64, 128),
                          (63, 5, 64, 96), (7, 7, 20, 8)):
        assert mt.give_edges(p, q, n, n, npsf, npsf) == \
            mj.give_edges(p, q, n, n, npsf, npsf)
    assert mt.give_edges(0, 0, 64, 64, 128, 128) == \
        (slice(0, 64), slice(0, 64), slice(64, 128), slice(64, 128))

    x = np.zeros((32, 32))
    x[2:4, 2:4] = 1.0
    x[10:30, 10:30] = 1.0
    out = mt.remove_large_islands(x.copy(), max_island_size=100)
    np.testing.assert_array_equal(
        out, mj.remove_large_islands(x.copy(), max_island_size=100))
    assert out[2, 2] == 1.0 and out[20, 20] == 0.0

    for nx, ny, pfrac in ((64, 64, 0.5), (100, 36, 0.3), (7, 9, 1.0)):
        assert gpi_t(nx, ny, pfrac) == gpi_j(nx, ny, pfrac)

    # convolve to a common resolution, deconvolving each band's own
    # (tests/test_spi.py:26), and restore_image (tests/test_misc2.py:9)
    nband, n = 4, 64
    g = np.arange(-(n // 2), n - n // 2)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    gi = [(3.0 - 0.3 * k, 2.5 - 0.2 * k, 10.0 * k) for k in range(nband)]
    image = np.stack([mt.Gaussian2D(xx, yy, gi[k], normalise=False)
                      for k in range(nband)])
    for kw in (dict(gausspari=gi), dict(norm_kernel=True)):
        ct = mt.convolve2gaussres(image, xx, yy, (5.0, 4.0, 30.0), **kw)
        cj = mj.convolve2gaussres(image, xx, yy, (5.0, 4.0, 30.0), **kw)
        assert ct.shape == image.shape
        assert _rel(ct, cj) < 1e-12
    model = np.zeros((2, n, n))
    model[:, 32, 32] = 2.0
    psf_mfs = mt.Gaussian2D(xx, yy, (3.0, 3.0, 0.0), normalise=False)
    out = ri_t(model, 0.1 * model, psf_mfs=psf_mfs)
    assert _rel(out, ri_j(model, 0.1 * model, psf_mfs=psf_mfs)) < 1e-12
    np.testing.assert_allclose(out[:, 32, 32], 2.2, rtol=1e-3)
    with pytest.raises(ValueError):
        ri_t(model, model)


MOP = dict(sigmainv=1e-4, gamma=0.9, cg_maxit=20, cg_minit=5, verbose=0,
           epsilon=1e-7)


@pmp("use_psf", [True, False])
@pmp("backend", ["dft", "pg"])
def test_fluxmop_matches_jax(pipe, use_psf, backend):
    """From the dirty image (no MODEL): model and residual at 1e-8 of
    their peaks; the residual gate of tests/test_aux_workers.py:38."""
    kw = dict(MOP, use_psf=use_psf, backend=backend)
    mj, rj = fluxmop_j(ddsi=_copies(pipe["dj"]), **kw)
    mt, rt = fluxmop_t(ddsi=_copies(pipe["dt"]), device="cpu", **kw)
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8
    dirty = _mfs(pipe["dt"], "DIRTY")
    assert np.abs(rt.sum(0)).max() < 0.6 * np.abs(dirty).max()


@pmp("mask", ["model", "array"])
def test_fluxmop_masks_match_jax(pipe, tmp_path, mask):
    """mask "model" (the support of MODEL > min_model) and an array mask
    with zero_model_outside_mask, written back with MODELP / UPDATE and
    the FITS products."""
    n = pipe["nx"]
    if mask == "array":
        m = np.zeros((n, n))
        m[n // 4:3 * n // 4, n // 4:3 * n // 4] = 1.0
        mask = m
    kw = dict(MOP, mask=mask, zero_model_outside_mask=True, fits_mfs=True,
              fits_cubes=True)
    mj, rj = fluxmop_j(ddsi=_copies(pipe["dj"], pipe["model"]),
                       output_filename=str(tmp_path / "j"), **kw)
    mt, rt = fluxmop_t(ddsi=_copies(pipe["dt"], pipe["model"]),
                       output_filename=str(tmp_path / "t"), device="cpu",
                       **kw)
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8
    assert _files(tmp_path, "t") == _files(tmp_path, "j")
    back = dstore_t.read_store(str(tmp_path / "t_I_main.dds"))
    assert {"MODELP", "UPDATE"} <= set(back[0])
    for ds in back:
        np.testing.assert_array_equal(ds["MODEL"], mt[ds["bandid"]])
    if not isinstance(mask, str):
        assert not mt[:, mask < 1].any()


def test_fluxmop_space_shards_match_single_program(pipe, caplog):
    """space_shards=2 over four CPU devices: a (2, 2) mesh running the
    distributed-rFFT2 Hessian, against the single-program step (and the
    JAX package's); 5 shards on 4 devices fall back with a warning."""
    kw = dict(MOP, use_psf=True)
    m1, r1 = fluxmop_t(ddsi=_copies(pipe["dt"]), device="cpu", **kw)
    m2, r2 = fluxmop_t(ddsi=_copies(pipe["dt"]), device="cpu",
                       space_shards=2, devices=["cpu"] * 4, **kw)
    assert _rel(m2, m1) < 1e-10
    assert _rel(r2, r1) < 1e-10
    mj, _ = fluxmop_j(ddsi=_copies(pipe["dj"]), **kw)
    assert _rel(m2, mj) < 1e-8
    with caplog.at_level("WARNING"):
        m5, _ = fluxmop_t(ddsi=_copies(pipe["dt"]), device="cpu",
                          space_shards=5, devices=["cpu"] * 4, **kw)
    assert "single-program" in caplog.text
    np.testing.assert_array_equal(m5, m1)


@pmp("ndev,route", [(4, "psf space mesh (1, 4)"), (3, "psf")])
def test_fluxmop_space_route_is_observable(pipe, caplog, ndev, route):
    """space_shards=4: on four devices the conditions of
    workers/fluxmop.py:_psf_hessian_maybe_space hold (nx % 4 == 0, a
    (1, 4) mesh), so the PCG runs the mesh Hessian, which
    stats["hessian"] shows; on three devices it takes the single-program
    Hessian and warns."""
    assert pipe["nx"] % 4 == 0
    st = {}
    with caplog.at_level("WARNING"):
        fluxmop_t(ddsi=_copies(pipe["dt"]), device="cpu", space_shards=4,
                  devices=["cpu"] * ndev, stats=st,
                  **dict(MOP, use_psf=True, cg_maxit=6))
    assert st["hessian"] == route
    assert ("single-program" in caplog.text) == (ndev != 4)
