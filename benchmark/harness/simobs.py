"""The traffic generator: a frozen copy of the program's observation
simulator (pfb_tpu_torch/utils/simulation.py: the array, earth-rotation
uvw tracks, channels and point-source sky; utils/ms.py: the exact DFT of
the sky at the visibilities; ops/fft.py: the image sizes), so that a
change to the program cannot move the yardstick. benchmark/tests/
test_bench_simobs.py holds the copy to the original at a small size.

:func:`observation` builds the measurement set's columns in memory, as
utils/ms.py:simulate_ms writes them for an observation without gains or
noise (two correlations, both the Stokes I visibility), so a run writes
no measurement set to disk.
"""

from dataclasses import dataclass

import numpy as np

LIGHTSPEED = 299792458.0


def good_size(n: int, even: bool = False) -> int:
    """Smallest 5-smooth number >= n (optionally even)."""
    if n <= 2:
        return max(n, 1) if not even else 2

    def smooth(m):
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while True:
        if smooth(m) and (not even or m % 2 == 0):
            return m
        m += 1


def good_even_size(n: int) -> int:
    """Smallest even 5-smooth number >= n (reference
    pfb/workers/grid.py:259-262 sizing loop)."""
    m = good_size(n)
    while m % 2:
        m = good_size(m + 1)
    return m



@dataclass
class SimObservation:
    uvw: np.ndarray        # (nrow, 3) metres
    time: np.ndarray       # (nrow,) seconds (synthetic epoch)
    ant1: np.ndarray       # (nrow,)
    ant2: np.ndarray       # (nrow,)
    freq: np.ndarray       # (nchan,) Hz
    ra: float              # rad
    dec: float             # rad


def random_array_enu(nant=12, extent=1000.0, seed=0):
    """Pseudo-random log-spiral array layout in ENU metres (compact core
    + outliers, loosely VLA-ish)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, nant)
    r = extent * rng.random(nant) ** 2
    e = r * np.cos(th)
    n = r * np.sin(th)
    u = rng.normal(0.0, 1.0, nant)  # small height scatter
    return np.stack([e, n, u], axis=1)


def enu_to_xyz(enu, lat):
    """Local ENU baseline -> equatorial XYZ at latitude lat."""
    e, n, u = enu[:, 0], enu[:, 1], enu[:, 2]
    x = -np.sin(lat) * n + np.cos(lat) * u
    y = e
    z = np.cos(lat) * n + np.sin(lat) * u
    return np.stack([x, y, z], axis=1)


def xyz_to_uvw(xyz, ha, dec):
    """Equatorial XYZ baseline -> uvw for hour angle ha, declination."""
    sH, cH = np.sin(ha), np.cos(ha)
    sd, cd = np.sin(dec), np.cos(dec)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    u = sH * x + cH * y
    v = -sd * cH * x + sd * sH * y + cd * z
    w = cd * cH * x - cd * sH * y + sd * z
    return np.stack([u, v, w], axis=1)


def simulate_obs(nant=12, ntime=16, nchan=4, duration_h=1.0,
                 freq0=1.0e9, bandwidth=0.4e9, dec=-0.5, lat=-0.52,
                 extent=1000.0, seed=0):
    """One scan of an earth-rotation synthesis observation."""
    enu = random_array_enu(nant, extent=extent, seed=seed)
    ap, aq = np.triu_indices(nant, 1)
    bl_xyz = enu_to_xyz(enu[ap] - enu[aq], lat)
    nbl = ap.size

    has = np.linspace(-duration_h / 2, duration_h / 2, ntime) * \
        (2 * np.pi / 24.0)
    t0 = 5.0e9  # arbitrary epoch, seconds
    dt = duration_h * 3600.0 / max(ntime - 1, 1)

    uvw = np.zeros((ntime * nbl, 3))
    time = np.zeros(ntime * nbl)
    ant1 = np.zeros(ntime * nbl, dtype=np.int32)
    ant2 = np.zeros(ntime * nbl, dtype=np.int32)
    for it, ha in enumerate(has):
        sl = slice(it * nbl, (it + 1) * nbl)
        uvw[sl] = xyz_to_uvw(bl_xyz, ha, dec)
        time[sl] = t0 + it * dt
        ant1[sl] = ap
        ant2[sl] = aq

    freq = freq0 + bandwidth * np.arange(nchan) / max(nchan, 1)
    return SimObservation(uvw=uvw, time=time, ant1=ant1, ant2=ant2,
                          freq=freq, ra=0.0, dec=dec)


def point_source_model(nx, ny, freq, nsource=10, seed=420,
                       margin=0, freq0=None):
    """Random point sources with power-law spectra on pixel centres —
    mirrors the upstream test ground truth (test_klean.py:71-78)."""
    rng = np.random.RandomState(seed)
    nchan = len(freq)
    if freq0 is None:
        freq0 = np.mean(freq)
    model = np.zeros((nchan, nx, ny))
    Ix = rng.randint(margin, nx - margin, nsource)
    Iy = rng.randint(margin, ny - margin, nsource)
    alpha = -0.7 + 0.1 * rng.randn(nsource)
    I0 = 1.0 + np.abs(rng.randn(nsource))
    for i in range(nsource):
        model[:, Ix[i], Iy[i]] = I0[i] * (freq / freq0) ** alpha[i]
    return model, Ix, Iy


def image_size_for(obs: SimObservation, fov_deg=1.0, srf=2.0):
    """Cell size from 1/(2 uv_max f_max / c) and an even 5-smooth image
    size covering the field of view (reference: workers/grid.py:242-264,
    init.py:183)."""
    uv_max = max(np.abs(obs.uvw[:, 0]).max(), np.abs(obs.uvw[:, 1]).max())
    cell_N = 1.0 / (2 * uv_max * obs.freq.max() / LIGHTSPEED)
    cell_rad = cell_N / srf
    cell_deg = np.rad2deg(cell_rad)
    npix = good_even_size(int(fov_deg / cell_deg))
    return npix, cell_rad


def _degrid_sparse(uvw, freq, cube, cell_rad):
    """(nrow, nchan) visibilities of a (nchan, nx, ny) model cube by the
    exact DFT over its nonzero pixels only, in float64: the sum of
    pfb_tpu/utils/ms.py's dense per-channel degrid, with the phase
    reduced mod 1 in cycles before the multiply by 2 pi."""
    nchan, nx, ny = cube.shape
    out = np.zeros((uvw.shape[0], nchan), np.complex128)
    for c in range(nchan):
        ii, jj = np.nonzero(cube[c])
        if ii.size == 0:
            continue
        sx = (ii - nx // 2).astype(np.float64)
        sy = (jj - ny // 2).astype(np.float64)
        l, m = sx * cell_rad, sy * cell_rad
        eps = l * l + m * m
        nm1 = -eps / (np.sqrt(1.0 - eps) + 1.0)
        s = freq[c] / LIGHTSPEED
        au = uvw[:, 0:1] * s * cell_rad
        av = uvw[:, 1:2] * s * cell_rad
        aw = uvw[:, 2:3] * s
        cyc = au * sx + av * sy + aw * nm1
        cyc = cyc - np.round(cyc)
        out[:, c] = np.exp(-2j * np.pi * cyc) @ cube[c, ii, jj]
    return out


def observation(cfg, seed):
    """(columns, truth) of a configuration's observation: the array,
    track and channels from the configuration (its ``layout_seed``), the
    sky's sources from ``seed``, on the pixels of an ``nx`` image of the
    configuration's super-resolution factor, as the program's smoke
    test simulates it."""
    obs = simulate_obs(nant=cfg["nant"], ntime=cfg["ntime"],
                       nchan=cfg["nchan"], duration_h=cfg["duration_h"],
                       freq0=cfg["freq0_hz"], bandwidth=cfg["bandwidth_hz"],
                       dec=cfg["dec_rad"], lat=cfg["lat_rad"],
                       extent=cfg["extent_m"], seed=cfg["layout_seed"])
    nx = cfg["nx"]
    _, cell = image_size_for(obs, fov_deg=1.0, srf=cfg["srf"])
    model, ix, iy = point_source_model(nx, nx, obs.freq,
                                       nsource=cfg["nsource"],
                                       seed=int(seed) % 2**32)
    vis = _degrid_sparse(obs.uvw, obs.freq, model, cell)
    data = np.stack([vis, vis], axis=-1)
    nrow = obs.uvw.shape[0]
    cols = dict(DATA=data, UVW=obs.uvw, TIME=obs.time, ANTENNA1=obs.ant1,
                ANTENNA2=obs.ant2, FLAG=np.zeros(data.shape, bool),
                WEIGHT_SPECTRUM=np.ones(data.shape), FREQ=obs.freq,
                FIELD_ID=np.zeros(nrow, np.int32),
                DATA_DESC_ID=np.zeros(nrow, np.int32),
                SCAN_NUMBER=np.zeros(nrow, np.int32), RA=np.array(obs.ra),
                DEC=np.array(obs.dec), POLTYPE=np.array("linear"))
    return cols, dict(model=model, ix=ix, iy=iy, cell=cell)
