"""UVW synthesis and coordinate helpers: a host copy of
pfb_tpu/utils/astrometry.py (numpy only; the port imports no JAX and
nothing of pfb_tpu, so it keeps its own copy).

Equivalent of pfb/utils/astrometry.py: the reference recomputes UVW with
casacore measures (fixvis-style, astrometry.py:19-103); here the same
textbook chain (antenna ITRF/ENU -> hour angle -> uvw) is implemented
directly. Ephemeris targets (``get_coordinates``) are computed from
built-in low-precision analytic ephemerides — supported bodies: Sun,
Moon, Mercury, Venus, Mars, Jupiter, Saturn, Uranus, Neptune (the
reference resolves arbitrary bodies via astropy,
pfb/utils/astrometry.py:104-137; anything outside this list raises).
"""

import numpy as np

from pfb_tpu_torch.ops.dft import LIGHTSPEED
from pfb_tpu_torch.utils.simulation import enu_to_xyz, xyz_to_uvw


def synthesize_uvw(ants_enu, time_s, ant1, ant2, phase_dir, lat,
                   lst0=0.0, earth_rate=2 * np.pi / 86164.0905):
    """Recompute UVW for given antenna ENU positions and times.

    phase_dir = (ra, dec) radians; lst approximated as
    lst0 + earth_rate * t (sidereal). Mirrors the role of the
    casacore-based synthesize_uvw (reference astrometry.py:19-103).
    """
    ra, dec = phase_dir
    xyz = enu_to_xyz(ants_enu, lat)
    utime, idx = np.unique(time_s, return_inverse=True)
    uvw = np.zeros((time_s.size, 3))
    for i, t in enumerate(utime):
        ha = lst0 + earth_rate * t - ra
        sel = idx == i
        bl = xyz[ant1[sel]] - xyz[ant2[sel]]
        uvw[sel] = xyz_to_uvw(bl, ha, dec)
    return uvw


# Keplerian elements + per-century rates for the major planets
# (E.M. Standish, "Keplerian Elements for Approximate Positions of
# the Major Planets", JPL, valid 1800-2050; heliocentric ecliptic
# J2000): a [au], e, I [deg], L [deg], long.peri [deg], long.node
# [deg]. 'earth' is the Earth-Moon barycentre.
_PLANET_ELEMENTS = {
    "mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350,
                 77.45779628, 48.33076593),
                (0.00000037, 0.00001906, -0.00594749, 149472.67411175,
                 0.16047689, -0.12534081)),
    "venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950,
               131.60246718, 76.67984255),
              (0.00000390, -0.00004107, -0.00078890, 58517.81538729,
               0.00268329, -0.27769418)),
    "earth": ((1.00000261, 0.01671123, -0.00001531, 100.46457166,
               102.93768193, 0.0),
              (0.00000562, -0.00004392, -0.01294668, 35999.37244981,
               0.32327364, 0.0)),
    "mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205,
              -23.94362959, 49.55953891),
             (0.00001847, 0.00007882, -0.00813131, 19140.30268499,
              0.44441088, -0.29257343)),
    "jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051,
                 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775,
                 0.21252668, 0.20469106)),
    "saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423,
                92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201,
                -0.41897216, -0.28867794)),
    "uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451,
                170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785,
                0.40805281, 0.04240589)),
    "neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969,
                 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325,
                 -0.32241464, -0.00508664)),
}


def _heliocentric_ecliptic(body, T):
    """Heliocentric ecliptic-J2000 position [au] from the Standish
    elements at T Julian centuries since J2000."""
    el, rate = _PLANET_ELEMENTS[body]
    a, e, I, L, wbar, O = (v + r * T for v, r in zip(el, rate))
    I, L, wbar, O = map(np.deg2rad, (I, L, wbar, O))
    w = wbar - O          # argument of perihelion
    M = (L - wbar) % (2 * np.pi)
    # Kepler's equation, Newton iterations
    E = M + e * np.sin(M)
    for _ in range(8):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1.0 - e * e) * np.sin(E)
    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(O), np.sin(O)
    cI, sI = np.cos(I), np.sin(I)
    x = (cw * cO - sw * sO * cI) * xp + (-sw * cO - cw * sO * cI) * yp
    y = (cw * sO + sw * cO * cI) * xp + (-sw * sO + cw * cO * cI) * yp
    z = (sw * sI) * xp + (cw * sI) * yp
    return np.array([x, y, z])


def _moon_ecliptic(T):
    """Geocentric ecliptic lon/lat [rad] and distance [earth radii] of
    the Moon — the Astronomical Almanac low-precision series
    (~0.3 deg), ample for pointing a beam or a movie phase centre."""
    d2r = np.deg2rad
    lam = 218.32 + 481267.881 * T \
        + 6.29 * np.sin(d2r(135.0 + 477198.87 * T)) \
        - 1.27 * np.sin(d2r(259.3 - 413335.36 * T)) \
        + 0.66 * np.sin(d2r(235.7 + 890534.22 * T)) \
        + 0.21 * np.sin(d2r(269.9 + 954397.74 * T)) \
        - 0.19 * np.sin(d2r(357.5 + 35999.05 * T)) \
        - 0.11 * np.sin(d2r(186.5 + 966404.03 * T))
    beta = 5.13 * np.sin(d2r(93.3 + 483202.02 * T)) \
        + 0.28 * np.sin(d2r(228.2 + 960400.89 * T)) \
        - 0.28 * np.sin(d2r(318.3 + 6003.15 * T)) \
        - 0.17 * np.sin(d2r(217.6 - 407332.21 * T))
    return d2r(lam % 360.0), d2r(beta)


def _ecliptic_to_radec(x, y, z, T=0.0):
    eps = np.deg2rad(23.439291 - 0.0130042 * T)
    ye = y * np.cos(eps) - z * np.sin(eps)
    ze = y * np.sin(eps) + z * np.cos(eps)
    ra = np.arctan2(ye, x) % (2 * np.pi)
    dec = np.arcsin(ze / np.sqrt(x * x + y * y + z * z))
    return float(ra), float(dec)


def get_coordinates(obs_time, target="Sun"):
    """Ephemeris target -> geocentric (ra, dec) radians at
    ``obs_time`` (MS TIME convention: seconds of MJD). The reference
    resolves bodies through astropy's builtin ephemeris
    (pfb/utils/astrometry.py:104-137); neither astropy nor casacore is a
    dependency, so the bodies are built in:
    the Sun via the Almanac low-precision solar series (~0.01 deg),
    the Moon via the Almanac low-precision lunar series (~0.3 deg),
    and the planets via the Standish JPL approximate Keplerian
    elements (1800-2050, ~arcmin) — all ample for pointing a
    primary-beam model or a movie phase centre."""
    mjd = np.mean(np.atleast_1d(obs_time)) / 86400.0
    n = mjd - 51544.5  # days since J2000 (TT ~ UTC at this precision)
    T = n / 36525.0
    body = target.lower()
    if body == "sun":
        L = np.deg2rad((280.460 + 0.9856474 * n) % 360.0)
        g = np.deg2rad((357.528 + 0.9856003 * n) % 360.0)
        lam = L + np.deg2rad(1.915) * np.sin(g) + \
            np.deg2rad(0.020) * np.sin(2 * g)
        x, y, z = np.cos(lam), np.sin(lam), 0.0
        return _ecliptic_to_radec(x, y, z, T)
    if body == "moon":
        lam, beta = _moon_ecliptic(T)
        x = np.cos(beta) * np.cos(lam)
        y = np.cos(beta) * np.sin(lam)
        z = np.sin(beta)
        return _ecliptic_to_radec(x, y, z, T)
    if body in _PLANET_ELEMENTS and body != "earth":
        p = _heliocentric_ecliptic(body, T)
        e = _heliocentric_ecliptic("earth", T)
        x, y, z = p - e  # geocentric
        return _ecliptic_to_radec(x, y, z, T)
    raise ValueError(
        f"Unknown ephemeris body {target!r}; built-in: Sun, Moon, "
        f"{', '.join(b for b in _PLANET_ELEMENTS if b != 'earth')}; "
        "or pass explicit radec.")


def parse_target(target, obs_time=None):
    """Resolve a --target string to (ra, dec) radians (reference
    grid.py target / fastim.py target semantics): either an ephemeris
    body name (see :func:`get_coordinates`) or 'HH:MM:SS,DD:MM:SS'
    (comma-delimited, as the reference documents), or 'rad,rad' when
    both fields are plain floats."""
    s = str(target).strip()
    if "," not in s:
        return get_coordinates(obs_time, target=s)
    a, b = (p.strip() for p in s.split(",", 1))

    def sexa(txt, hours):
        parts = [float(p) for p in txt.split(":")]
        while len(parts) < 3:
            parts.append(0.0)
        sign = -1.0 if txt.lstrip().startswith("-") else 1.0
        val = abs(parts[0]) + parts[1] / 60.0 + parts[2] / 3600.0
        deg = val * (15.0 if hours else 1.0)
        return sign * np.deg2rad(deg)

    if ":" in a or ":" in b:
        return sexa(a, hours=True), sexa(b, hours=False)
    return float(a), float(b)


def parallactic_angle(time_s, ra, dec, lat, lst0=0.0,
                      earth_rate=2 * np.pi / 86164.0905):
    """Parallactic angle (radians) per time sample for a source at
    (ra, dec) seen from latitude ``lat``; LST approximated as
    lst0 + earth_rate * t like :func:`synthesize_uvw`."""
    ha = lst0 + earth_rate * np.asarray(time_s, np.float64) - ra
    return np.arctan2(
        np.cos(lat) * np.sin(ha),
        np.sin(lat) * np.cos(dec) -
        np.cos(lat) * np.sin(dec) * np.cos(ha))


def radec_to_lm(radec_target, radec_phase_centre):
    """Direction cosines of a target w.r.t. the phase centre (SIN
    projection) — same convention as africanus' radec_to_lm used by the
    grid worker (reference grid.py:371)."""
    ra, dec = radec_target
    ra0, dec0 = radec_phase_centre
    dra = ra - ra0
    l = np.cos(dec) * np.sin(dra)
    m = (np.sin(dec) * np.cos(dec0) -
         np.cos(dec) * np.sin(dec0) * np.cos(dra))
    return l, m


def _uvw_basis(ra, dec):
    """Rows (u, v, w) of the uvw projection for phase centre
    (ra, dec): w along the source, u east, v north."""
    sa, ca = np.sin(ra), np.cos(ra)
    sd, cd = np.sin(dec), np.cos(dec)
    return np.array([[-sa, ca, 0.0],
                     [-sd * ca, -sd * sa, cd],
                     [cd * ca, cd * sa, sd]])


def rephase_to(vis, uvw, radec_in, radec_out, freq):
    """Exactly re-reference visibilities to a new phase centre
    (init.yaml radec; the reference raises NotImplementedError on this
    path, stokes2vis.py:162-165): rotate the uvw frame
    (uvw' = T(out) T(in)^T uvw, the fixvis operation) and counter-
    rotate the phases by the w change. Returns (vis', uvw')."""
    Tin = _uvw_basis(*radec_in)
    Tout = _uvw_basis(*radec_out)
    uvw_new = np.asarray(uvw) @ (Tout @ Tin.T).T
    # vis convention exp(-2pi i (u l + v m + w (n-1))) (ops/dft.py):
    # vis' = vis * exp(+2pi i (w_new - w_old) / lambda)
    dw = uvw_new[:, 2] - np.asarray(uvw)[:, 2]  # metres
    phase = dw[:, None] * (np.asarray(freq)[None, :] / LIGHTSPEED)
    vis = np.asarray(vis)
    if vis.ndim == 3:  # (row, chan, corr)
        phase = phase[..., None]
    return vis * np.exp(2j * np.pi * phase), uvw_new


def rephase_vis(vis, uvw, radec_in, radec_out, freq=None):
    """Phase-rotate visibilities to a new phase centre
    (reference misc.py:759-772). uvw in wavelengths if freq is None,
    else metres with per-channel scaling."""
    l_i, m_i = radec_to_lm(radec_in, radec_in)  # zero by construction
    l_o, m_o = radec_to_lm(radec_out, radec_in)
    n_i = 1.0
    n_o = np.sqrt(1.0 - l_o**2 - m_o**2)
    dl, dm, dn = l_o - l_i, m_o - m_i, n_o - n_i
    phase = uvw[:, 0] * dl + uvw[:, 1] * dm + uvw[:, 2] * dn
    if freq is not None:
        phase = phase[:, None] * (freq[None, :] / LIGHTSPEED)
    return vis * np.exp(2j * np.pi * phase)
