"""pfb_tpu_torch/utils/astrometry.py and the options that use it, against
pfb_tpu on the CPU in float64.

- every function of the module on seeded inputs: 1e-12 relative (the
  port's copy is the JAX package's numpy code);
- the options: ``_init(radec=...)`` (the rephased VIS and UVW) and
  ``_init(site_latitude=...)`` (the parallactic-angle-averaged BEAM),
  ``interp_beam(utime=...)``: 1e-12 relative;
- the port's counterparts of tests/test_aux_workers.py:126, 163, 185,
  tests/test_misc_ops.py:44, 60 and tests/test_options.py:8, 23, with
  their own tolerances.
(``_grid(target=...)`` is held against pfb_tpu in
tests/test_torch_post_workers.py.)
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pfb_tpu.utils.astrometry as aj
import pfb_tpu_torch.utils.astrometry as at
from pfb_tpu.utils.beam import interp_beam as interp_beam_j
from pfb_tpu.utils.ms import simulate_ms
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu_torch.utils.beam import interp_beam as interp_beam_t
from pfb_tpu_torch.workers.init import _init as init_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _obs(seed=0, nant=6, ntime=4):
    rng = np.random.default_rng(seed)
    enu = rng.normal(scale=300.0, size=(nant, 3))
    a1, a2 = np.triu_indices(nant, 1)
    times = np.repeat(np.arange(ntime) * 600.0 + 5e9, a1.size)
    return enu, times, np.tile(a1, ntime), np.tile(a2, ntime)


def test_synthesize_uvw_matches_jax():
    enu, t, a1, a2 = _obs()
    args = (enu, t, a1, a2, (1.1, -0.6), -0.52)
    assert _rel(at.synthesize_uvw(*args, lst0=0.3),
                aj.synthesize_uvw(*args, lst0=0.3)) < TOL


@pmp("body", ["Sun", "Moon", "Mercury", "Venus", "Mars", "Jupiter",
              "Saturn", "Uranus", "Neptune"])
def test_get_coordinates_matches_jax(body):
    for t in (51544.5 * 86400.0, 5e9, np.array([5.1e9, 5.1e9 + 3600.0])):
        assert _rel(at.get_coordinates(t, target=body),
                    aj.get_coordinates(t, target=body)) < TOL


@pmp("target", ["12:00:00,-30:00:00", "-01:02:03.5,+45:30:00",
                "0.5,-0.3", "Sun", "Jupiter"])
def test_parse_target_matches_jax(target):
    assert _rel(at.parse_target(target, obs_time=5e9),
                aj.parse_target(target, obs_time=5e9)) < TOL


def test_angles_and_rephasing_match_jax():
    rng = np.random.default_rng(1)
    t = 5e9 + np.linspace(0.0, 7200.0, 9)
    assert _rel(at.parallactic_angle(t, 1.0, -0.5, -0.52, lst0=0.2),
                aj.parallactic_angle(t, 1.0, -0.5, -0.52, lst0=0.2)) < TOL
    A, B = (1.0, -0.6), (1.0 + 2e-3, -0.6 + 1.5e-3)
    assert _rel(at.radec_to_lm(B, A), aj.radec_to_lm(B, A)) < TOL
    vis = rng.normal(size=(12, 3, 2)) + 1j * rng.normal(size=(12, 3, 2))
    uvw = rng.normal(scale=500.0, size=(12, 3))
    freq = np.array([1.0e9, 1.1e9, 1.2e9])
    vt, ut = at.rephase_to(vis, uvw, A, B, freq)
    vj, uj = aj.rephase_to(vis, uvw, A, B, freq)
    assert _rel(vt, vj) < TOL and _rel(ut, uj) < TOL
    assert _rel(at.rephase_vis(vis[..., 0], uvw, A, B, freq),
                aj.rephase_vis(vis[..., 0], uvw, A, B, freq)) < TOL


@pmp("btype", ["cos3", "kbl", "npz"])
def test_interp_beam_utime_matches_jax(btype, tmp_path):
    """The parallactic-angle average (reference beam.py:16-83) of each
    beam family, held against the JAX package's host code."""
    if btype == "npz":
        btype = _asymmetric_beam(str(tmp_path / "beam.npz"))
    kw = dict(btype=btype, utime=np.linspace(0.0, 3600.0, 5),
              radec=(1.0, -0.5), lat=-0.52)
    got = interp_beam_t(1.28e9, 32, 32, 0.05, **kw)
    ref = interp_beam_j(1.28e9, 32, 32, 0.05, **kw)
    for g, r in zip(got, ref):
        assert _rel(g, r) < TOL


def _asymmetric_beam(path):
    """An elliptical measured beam, so a rotation average differs from
    the beam itself."""
    lb = np.linspace(-2.0, 2.0, 65)
    bl, bm = np.meshgrid(lb, lb, indexing="ij")
    np.savez(path, beam=np.exp(-0.5 * (bl**2 + bm**2 / 0.25)), l_beam=lb,
             m_beam=lb)
    return path


@pytest.fixture(scope="module")
def ms(tmp_path_factory):
    d = tmp_path_factory.mktemp("astro")
    path = str(d / "t.npz")
    simulate_ms(path, nant=7, ntime=6, nchan=2, nsource=2, fov_deg=0.3,
                seed=8)
    return path, _asymmetric_beam(str(d / "beam.npz"))


def _shift(path, dra, ddec):
    f = np.load(path)
    ra = float(np.atleast_1d(f["FIELD_RA"] if "FIELD_RA" in f.files
                             else f["RA"])[0])
    dec = float(np.atleast_1d(f["FIELD_DEC"] if "FIELD_DEC" in f.files
                              else f["DEC"])[0])
    return f"{ra + dra},{dec + ddec}"


@pmp("opt", ["radec", "site_latitude", "both"])
def test_init_astrometry_options_match_jax(ms, opt):
    """_init(radec=...) re-references VIS and UVW to the new centre on the
    host; _init(site_latitude=...) attaches the parallactic-angle-averaged
    beam of each time chunk (reference init.py:224-232, 291-293,
    370-375), with an elliptical measured beam."""
    ms, beam = ms
    kw = dict(channels_per_image=1, integrations_per_image=3,
              beam_model=beam, write=False)
    if opt in ("radec", "both"):
        kw["radec"] = _shift(ms, 2e-3, -1.5e-3)
    if opt in ("site_latitude", "both"):
        kw["site_latitude"] = -0.52
    xt = init_t(ms=ms, device="cpu", **kw)
    xj = init_j(ms=ms, **kw)
    assert len(xt) == len(xj) == 4
    for a, b in zip(xt, xj):
        for k in ("VIS", "WEIGHT", "UVW", "BEAM"):
            assert _rel(a[k], b[k]) < TOL, k
        assert (a["ra"], a["dec"]) == (b["ra"], b["dec"])
    if "radec" in kw:
        ra, dec = (float(v) for v in kw["radec"].split(","))
        assert np.allclose((xt[0]["ra"], xt[0]["dec"]), (ra, dec))
    if "site_latitude" in kw:
        plain = init_t(ms=ms, device="cpu", **dict(kw, site_latitude=None,
                                                    radec=kw.get("radec")))
        assert _rel(plain[0]["BEAM"], xt[0]["BEAM"]) > 1e-6


# the port's counterparts of the reference tests


def test_parallactic_beam_average(tmp_path):
    """tests/test_aux_workers.py:126 on the port."""
    nb = 65
    lb = np.linspace(-2.0, 2.0, nb)
    bl, bm = np.meshgrid(lb, lb, indexing="ij")
    bvals = np.exp(-0.5 * (bl**2 / 1.0 + bm**2 / 0.25))
    path = str(tmp_path / "beam.npz")
    np.savez(path, beam=bvals, l_beam=lb, m_beam=lb)
    utime = np.linspace(0.0, 3600.0, 5)
    ra, dec, lat = 1.0, -0.5, -0.52
    got, l, m = interp_beam_t(1e9, 32, 32, 0.05, btype=path, utime=utime,
                              radec=(ra, dec), lat=lat)
    from scipy.interpolate import RegularGridInterpolator
    interp = RegularGridInterpolator((lb, lb), bvals, bounds_error=False,
                                     fill_value=0.0)
    ll, mm = np.meshgrid(l, m, indexing="ij")
    pas = at.parallactic_angle(utime, ra, dec, lat)
    expect = np.mean([interp((np.cos(p) * ll + np.sin(p) * mm,
                              -np.sin(p) * ll + np.cos(p) * mm))
                      for p in pas], axis=0)
    assert_allclose(got, expect, rtol=1e-12)
    assert np.std(pas) > 0.01
    sym, _, _ = interp_beam_t(1e9, 32, 32, 0.05, btype="cos3", utime=utime,
                              radec=(ra, dec), lat=lat)
    stat, _, _ = interp_beam_t(1e9, 32, 32, 0.05, btype="cos3")
    assert_allclose(sym, stat, atol=1e-12)


def test_sun_ephemeris():
    """tests/test_aux_workers.py:163 on the port."""
    t_j2000 = 51544.5 * 86400.0
    ra, dec = at.get_coordinates(t_j2000)
    assert abs(np.rad2deg(dec) - (-23.03)) < 0.1
    assert abs(ra - np.deg2rad(281.3)) < np.deg2rad(0.2)
    with pytest.raises(ValueError, match="Unknown ephemeris body"):
        at.get_coordinates(t_j2000, target="Vulcan")


def _elongation(t, body):
    ra_s, dec_s = at.get_coordinates(t, "Sun")
    ra_b, dec_b = at.get_coordinates(t, body)
    cs = np.sin(dec_s) * np.sin(dec_b) + \
        np.cos(dec_s) * np.cos(dec_b) * np.cos(ra_s - ra_b)
    return np.rad2deg(np.arccos(np.clip(cs, -1, 1)))


def test_planet_ephemerides_invariants():
    """tests/test_aux_workers.py:185 on the port."""
    ts = (51544.5 + np.arange(0, 3650, 13.7)) * 86400.0
    merc = np.array([_elongation(t, "Mercury") for t in ts])
    ven = np.array([_elongation(t, "Venus") for t in ts])
    assert merc.max() < 29.0 and merc.max() > 15.0
    assert ven.max() < 48.5 and ven.max() > 40.0
    jup = np.array([_elongation(t, "Jupiter") for t in ts])
    assert jup.max() > 170.0 and jup.min() < 15.0
    eps = np.deg2rad(23.4393)
    for body, blim in (("Moon", 5.6), ("Saturn", 3.2), ("Mars", 7.0)):
        for t in ts[::7]:
            ra, dec = at.get_coordinates(t, body)
            beta = np.arcsin(np.sin(dec) * np.cos(eps)
                             - np.cos(dec) * np.sin(eps) * np.sin(ra))
            assert abs(np.rad2deg(beta)) < blim, body
    tm = (51544.5 + np.arange(0, 30, 0.5)) * 86400.0
    em = np.array([_elongation(t, "Moon") for t in tm])
    assert em.min() < 12.0 and em.max() > 168.0


def test_synthesize_uvw_matches_simulation():
    """tests/test_misc_ops.py:44 on the port."""
    from pfb_tpu_torch.utils.simulation import random_array_enu, simulate_obs
    obs = simulate_obs(nant=5, ntime=3, nchan=1, seed=9)
    enu = random_array_enu(5, extent=1000.0, seed=9)
    uvw = at.synthesize_uvw(enu, obs.time, obs.ant1, obs.ant2,
                            (0.0, obs.dec), lat=-0.52)
    assert uvw.shape == obs.uvw.shape
    uvw_sw = at.synthesize_uvw(enu, obs.time, obs.ant2, obs.ant1,
                               (0.0, obs.dec), lat=-0.52)
    assert_allclose(uvw_sw, -uvw, atol=1e-9)


def test_rephase_vis_identity():
    """tests/test_misc_ops.py:60 on the port."""
    rng = np.random.default_rng(2)
    vis = rng.normal(size=(10, 2)) + 1j * rng.normal(size=(10, 2))
    uvw = rng.normal(size=(10, 3)) * 100
    out = at.rephase_vis(vis, uvw, (0.1, -0.5), (0.1, -0.5),
                         freq=np.array([1e9, 1.2e9]))
    assert_allclose(out, vis)


def test_parse_target_formats():
    """tests/test_options.py:8 on the port."""
    ra, dec = at.parse_target("12:00:00,-30:00:00")
    assert np.isclose(ra, np.pi)
    assert np.isclose(dec, -np.pi / 6)
    assert at.parse_target("0.5,-0.3") == (0.5, -0.3)
    ra, dec = at.parse_target("Sun", obs_time=5e9)
    assert 0 <= ra < 2 * np.pi and abs(dec) < 0.42
    ra, dec = at.parse_target("Jupiter", obs_time=5e9)
    assert 0 <= ra < 2 * np.pi and abs(dec) < 0.45
    with pytest.raises(ValueError):
        at.parse_target("Vulcan", obs_time=5e9)


def test_rephase_to_matches_independent_uvw():
    """tests/test_options.py:23 on the port, with the port's DFT."""
    from pfb_tpu_torch.ops.dft import dirty2vis_dft
    rng = np.random.default_rng(0)
    nant = 5
    enu = rng.normal(scale=300.0, size=(nant, 3))
    enu[:, 2] *= 0.05
    a1, a2 = np.triu_indices(nant, 1)
    times = np.repeat(np.arange(3) * 600.0, a1.size)
    ant1, ant2 = np.tile(a1, 3), np.tile(a2, 3)
    lat = -0.5
    A = (1.0, -0.6)
    B = (1.0 + 2e-3, -0.6 + 1.5e-3)
    uvw_A = at.synthesize_uvw(enu, times, ant1, ant2, A, lat)
    uvw_B = at.synthesize_uvw(enu, times, ant1, ant2, B, lat)
    freq = np.linspace(1.0e9, 1.2e9, 3)
    nx, cell = 64, 4e-4 / 64
    src = (1.0 + 0.8e-3, -0.6 - 0.5e-3)

    def model_vis(uvw, centre):
        l, m = at.radec_to_lm(src, centre)
        img = np.zeros((nx, nx))
        img[nx // 2, nx // 2] = 1.0
        return dirty2vis_dft(torch.as_tensor(uvw), torch.as_tensor(freq),
                             torch.as_tensor(img), cell, cell, x0=l,
                             y0=m).numpy()

    vis_A = model_vis(uvw_A, A)
    vis_B = model_vis(uvw_B, B)
    vis_r, uvw_r = at.rephase_to(vis_A, uvw_A, A, B, freq)
    assert np.abs(uvw_r - uvw_B).max() < 1e-6 * np.abs(uvw_B).max()
    assert np.abs(vis_r - vis_B).max() < 1e-6
