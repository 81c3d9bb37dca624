"""The port's FITS products against pfb_tpu's: the host copy
pfb_tpu_torch/utils/fits.py (round trip, byte-identical files), and the
``fits_mfs`` / ``fits_cubes`` products of _grid, _klean and _spotless on
one small observation (CPU, float64 up to the FITS files' float32).

The files hold float32, so two float64 images that agree to the parity
tolerance of tests/test_torch_slice.py (1e-10 for the grid, 1e-8 for the
deconvolution workers) agree in the files to that tolerance plus one
float32 rounding (2^-23 of max)."""

import numpy as np
import pytest
import torch

from pfb_tpu.utils import fits as fits_j
from pfb_tpu.utils.ms import simulate_ms
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu.workers.klean import _klean as klean_j
from pfb_tpu.workers.spotless import _spotless as spotless_j
from pfb_tpu_torch.utils import fits as fits_t
from pfb_tpu_torch.workers.grid import _grid as grid_t
from pfb_tpu_torch.workers.init import _init as init_t
from pfb_tpu_torch.workers.klean import _klean as klean_t
from pfb_tpu_torch.workers.spotless import _spotless as spotless_t

torch.set_num_threads(1)
NX = 128
F32 = 2.0 ** -23
SIM = dict(nant=7, ntime=4, nchan=2, nsource=3, fov_deg=0.2, seed=3)
GRID = dict(suffix="main", field_of_view=0.2, psf=True, residual=False,
            nx=NX, ny=NX, backend="pg", robustness=0.0, epsilon=1e-5)
DECONV = {
    "klean": dict(niter=1, epsilon=1e-5, verbose=0, minor_maxit=20,
                  cg_maxit=20, backend="pg"),
    "spotless": dict(niter=1, epsilon=1e-5, verbose=0, pd_maxit=20,
                     rmsfactor=0.8, l1reweight_from=1, backend="pg",
                     engine="fft"),
}


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _header(name):
    """The header blocks of a FITS file, through the END card."""
    raw = open(name, "rb").read()
    end = next(i for i in range(0, len(raw), 80)
               if raw[i:i + 80].startswith(b"END"))
    return raw[:end + 80]


def _products(d, prefix):
    return sorted(p.name[len(prefix):] for p in d.glob(f"{prefix}*.fits"))


def _compare(d, tol):
    """Same file names in both packages, equal headers, data within
    ``tol`` plus one float32 rounding of max; returns the names."""
    names = _products(d, "j_")
    assert names == _products(d, "t_")
    for n in names:
        a, b = str(d / f"j_{n}"), str(d / f"t_{n}")
        assert _header(a) == _header(b), n
        data_j, data_t = fits_j.load_fits(a), fits_t.load_fits(b)
        assert data_t.shape == data_j.shape
        assert np.abs(data_j).max() > 0, n
        assert _rel(data_t, data_j) <= tol + F32, n
    return names


def test_fits_roundtrip(tmp_path):
    """Counterpart of tests/test_models_io.py:test_fits_roundtrip."""
    rng = np.random.default_rng(1)
    cube = rng.normal(size=(2, 16, 20))
    hdr = fits_t.set_wcs(1e-3, 1e-3, 16, 20, [0.1, -0.5],
                         np.array([1e9, 1.1e9]))
    name = str(tmp_path / "test.fits")
    fits_t.save_fits(cube, name, hdr, dtype=np.float64)
    back = fits_t.load_fits(name)
    assert back.shape == (1, 2, 16, 20)
    np.testing.assert_allclose(back[0], cube, rtol=1e-12)


def _dds(rng, nband=3, nx=24, ny=20):
    return [{"bandid": b, "freq_out": 1e9 + 1e8 * b, "WSUM": np.array([
        2.0 + b]), "cell_rad": 1e-5, "ra": 0.3, "dec": -0.7,
        "DIRTY": rng.normal(size=(nx, ny)),
        "MODEL": rng.normal(size=(nx, ny))} for b in range(nband)]


@pytest.mark.parametrize("fn", ["dds2fits", "dds2fits_mfs"])
@pytest.mark.parametrize("norm_wsum", [True, False])
def test_dds2fits_byte_identical(tmp_path, fn, norm_wsum):
    """The port's dds2fits / dds2fits_mfs and the JAX package's on one
    numpy dds write the same bytes."""
    dds = _dds(np.random.default_rng(4))
    for col in ("DIRTY", "MODEL"):
        nj = getattr(fits_j, fn)(dds, col, str(tmp_path / "j"),
                                 norm_wsum=norm_wsum)
        nt = getattr(fits_t, fn)(dds, col, str(tmp_path / "t"),
                                 norm_wsum=norm_wsum)
        assert [n.replace("/t_", "/j_") for n in nt] == nj
        for a, b in zip(nj, nt):
            assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def gridded(tmp_path_factory):
    """One observation gridded (pg, Briggs 0) by both packages with
    write=True and both FITS flags, under the prefixes j and t."""
    d = tmp_path_factory.mktemp("fits")
    ms = str(d / "obs.npz")
    simulate_ms(ms, **SIM)
    xj = init_j(ms=ms, output_filename=str(d / "xj"), channels_per_image=1)
    xt = init_t(ms=ms, channels_per_image=1, write=False, device="cpu")
    kw = dict(GRID, fits_mfs=True, fits_cubes=True)
    dj = grid_j(xdsi=xj, output_filename=str(d / "j"), **kw)
    dt = grid_t(xdsi=xt, output_filename=str(d / "t"), device="cpu", **kw)
    return dict(d=d, dj=dj, dt=dt, names=_products(d, "j_"))


def test_grid_fits_products_match_jax(gridded):
    """DIRTY and PSF, MFS and one cube per band: the reference's names
    and headers, data at the grid parity tolerance."""
    names = _compare(gridded["d"], 1e-10)
    nband = len(gridded["dj"])
    assert nband == 2
    for col in ("dirty", "psf"):
        assert f"I_main_{col}_mfs.fits" in names
        assert sum(n.startswith(f"I_main_{col}_b") for n in names) == nband


@pytest.mark.parametrize("worker", ["klean", "spotless"])
def test_deconv_fits_products_match_jax(gridded, tmp_path, worker):
    """_klean / _spotless with output_filename, write=True and both
    flags in both packages, each on its own copy of its grid products:
    RESIDUAL and MODEL, MFS and cubes, with the reference's names and
    headers and data at the deconvolution parity tolerance."""
    kw = dict(DECONV[worker], fits_mfs=True, fits_cubes=True)
    if worker == "spotless":
        st = {}
        spotless_t(ddsi=[dict(x) for x in gridded["dt"]], write=False,
                   device="cpu", stats=st, **dict(kw, pd_maxit=1,
                                                  fits_mfs=False,
                                                  fits_cubes=False))
        kw["hessnorm"] = st["hessnorm"]
    run_j, run_t = {"klean": (klean_j, klean_t),
                    "spotless": (spotless_j, spotless_t)}[worker]
    mj, _ = run_j(ddsi=[dict(x) for x in gridded["dj"]],
                  output_filename=str(tmp_path / "j"), **kw)
    mt, _ = run_t(ddsi=[dict(x) for x in gridded["dt"]],
                  output_filename=str(tmp_path / "t"), device="cpu", **kw)
    assert _rel(mt, mj) < 1e-8
    names = _compare(tmp_path, 1e-8)
    for col in ("residual", "model"):
        assert f"I_main_{col}_mfs.fits" in names
        assert sum(n.startswith(f"I_main_{col}_b") for n in names) == 2
    assert not any("dirty" in n or "psf" in n for n in names)


@pytest.mark.parametrize("worker", ["klean", "spotless", "grid"])
def test_fits_flags_without_output_filename_write_nothing(
        gridded, tmp_path, monkeypatch, worker):
    """With output_filename None (and for _grid also with write=False)
    the flags write nothing and raise nothing, as in the reference."""
    monkeypatch.chdir(tmp_path)
    flags = dict(fits_mfs=True, fits_cubes=True)
    ddsi = [dict(x) for x in gridded["dt"]]
    if worker == "klean":
        klean_t(ddsi=ddsi, write=False, device="cpu",
                **dict(DECONV["klean"], **flags))
    elif worker == "spotless":
        spotless_t(ddsi=ddsi, write=False, device="cpu", hessnorm=1.0,
                   **dict(DECONV["spotless"], pd_maxit=2, **flags))
    else:
        xt = init_t(ms=str(gridded["d"] / "obs.npz"), channels_per_image=1,
                    write=False, device="cpu")
        grid_t(xdsi=xt, write=False, output_filename=str(tmp_path / "t"),
               device="cpu", **dict(GRID, **flags))
    assert list(tmp_path.iterdir()) == []
