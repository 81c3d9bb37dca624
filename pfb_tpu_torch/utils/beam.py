"""Primary beam models and evaluation onto the image grid.

Equivalent of pfb/utils/beam.py: the reference evaluates katbeam
JimBeam ('kbl'/'kbuhf', MeerKAT L/UHF fits, beam.py:84-140) or a
measured .npz beam. Here 'kbl'/'kbuhf' evaluate :func:`jim_beam` — the
same cosine-tapered-aperture power pattern JimBeam is built on, with
the PUBLISHED MeerKAT beamwidth scaling (Mauch et al. 2020: Stokes-I
HPBW 57.5' x (1500 MHz / f), confirmed UHF via the common lambda/D
law). katbeam's per-polarisation squint/width polynomial refinements
need its (unavailable offline) coefficient tables; when katbeam IS
installed the test suite cross-validates against it
(tests/test_beam_models.py). 'cos3' keeps the cruder cosine-cubed
approximation. Measured beams load from npz with
(beam, l_beam, m_beam) arrays. ``eval_beam`` regrids with a
RegularGridInterpolator exactly like the reference (beam.py:143-154).
"""

import numpy as np
from scipy.interpolate import RegularGridInterpolator


def cos3_beam(l_deg, m_deg, freq_hz, dish_diameter=13.5,
              ref_freq=1.28e9):
    """Cosine-cubed primary beam: b = cos^3(min(theta_b, pi/2)) with
    theta_b ~ 1.18 theta r / theta_HPBW — the crude analytic
    approximation (use 'kbl'/'kbuhf' for the katbeam-class model)."""
    r = np.sqrt(l_deg**2 + m_deg**2)
    # HPBW in degrees ~ 1.18 lambda / D
    lam = 299792458.0 / freq_hz
    hpbw = np.rad2deg(1.18 * lam / dish_diameter)
    arg = 1.18866 * r / hpbw  # cos^3 hits 0.5 at arg ~ 0.5
    arg = np.minimum(arg * np.pi / 2 / 0.593, np.pi / 2)
    return np.cos(arg) ** 3


# Stokes-I half-power beamwidth at the reference frequency:
# L band 57.5 arcmin at 1500 MHz (Mauch et al. 2020, DEEP2); UHF by
# the lambda/D scaling of the same dish/illumination.
_JIM_HPBW_REF = {"l": (57.5 / 60.0, 1500.0e6),
                 "uhf": (57.5 / 60.0 * 1500.0 / 816.0, 816.0e6)}


def _cos_taper_voltage(x):
    """Voltage pattern of a cosine-illuminated circular aperture,
    V(x) = cos(pi x) / (1 - 4 x^2) — katbeam JimBeam's underlying
    pattern. The x = 1/2 singularity is removable (limit pi/4)."""
    x = np.asarray(x, float)
    den = 1.0 - 4.0 * x * x
    sing = np.abs(den) < 1e-6
    den_safe = np.where(sing, 1.0, den)
    v = np.cos(np.pi * x) / den_safe
    return np.where(sing, np.pi / 4.0, v)


def jim_beam(l_deg, m_deg, freq_hz, band="l"):
    """katbeam-JimBeam-class Stokes-I power beam: squared
    cosine-taper voltage pattern with x = 1.18896 r / HPBW(f) so the
    half-power point lands exactly at r = HPBW/2, HPBW scaling as
    1/f from the published reference widths (_JIM_HPBW_REF). Includes
    the pattern's real sidelobes (first ~ -23 dB), unlike cos3 which
    clips to zero (reference beam.py:107-117 evaluates
    JimBeam('MKAT-AA-{L,UHF}-JIM-2020').I)."""
    r = np.sqrt(np.asarray(l_deg) ** 2 + np.asarray(m_deg) ** 2)
    hpbw0, f0 = _JIM_HPBW_REF[band]
    hpbw = hpbw0 * (f0 / freq_hz)
    v = _cos_taper_voltage(1.18896 * r / hpbw)
    return v * v


_KATBEAM = {}


def _katbeam_eval(l_deg, m_deg, freq_hz, band):
    """Exact katbeam JimBeam evaluation when the package is present
    (reference beam.py:107-117), else None so the caller falls back to
    :func:`jim_beam`. The measured per-pol coefficient tables live
    ONLY inside katbeam's model strings ('MKAT-AA-{L,UHF}-JIM-2020');
    they are not published in a citable numeric form that could be
    vendored here without fabricating values, so offline the published
    -beamwidth analytic model is the supported stand-in and
    tests/test_beam_models.py cross-validates against katbeam whenever
    it is importable. Users with measured beams should pass an .npz
    (same contract as the reference)."""
    if band not in _KATBEAM:
        try:
            from katbeam import JimBeam  # optional dependency
            name = {"l": "MKAT-AA-L-JIM-2020",
                    "uhf": "MKAT-AA-UHF-JIM-2020"}[band]
            _KATBEAM[band] = JimBeam(name)
        except ImportError:
            _KATBEAM[band] = None
    jb = _KATBEAM[band]
    if jb is None:
        return None
    return jb.I(np.asarray(l_deg, float), np.asarray(m_deg, float),
                freq_hz / 1e6)


def interp_beam(freq, nx, ny, cell_deg, btype="kbl", l0=0.0, m0=0.0,
                dish_diameter=13.5, utime=None, radec=None, lat=None,
                lst0=0.0):
    """Evaluate a beam model for one frequency on a coarse grid,
    returning (beam, l_grid, m_grid) like the reference's interp_beam
    (pfb/utils/beam.py:84-140).

    When ``utime`` (array of time samples) plus ``radec`` and ``lat``
    are given, the beam is the TIME AVERAGE over the per-sample
    parallactic-angle rotations of the sky frame — the beam_cube_dde
    path of reference beam.py:16-83 (which carries a stray
    ipdb.set_trace upstream; rebuilt from design intent). Rotation is
    a no-op for circularly symmetric models but matters for measured
    .npz beams."""
    l = (-(nx // 2) + np.arange(nx)) * cell_deg + l0
    m = (-(ny // 2) + np.arange(ny)) * cell_deg + m0
    ll, mm = np.meshgrid(l, m, indexing="ij")

    interp = None
    if isinstance(btype, str) and btype.endswith(".npz"):
        # load + build the interpolator ONCE — model() runs per
        # parallactic-angle sample below
        with np.load(btype) as f:
            bvals = f["beam"]
            l_b = f["l_beam"]
            m_b = f["m_beam"]
        interp = RegularGridInterpolator((l_b, m_b), bvals,
                                         bounds_error=False,
                                         fill_value=0.0)

    def model(llg, mmg):
        if btype is None or btype == "none":
            return np.ones(llg.shape)
        bt = btype.lower().replace("-", "_") if isinstance(
            btype, str) else btype
        if bt in ("kbl", "kb_l", "katbeam_l"):
            kb = _katbeam_eval(llg, mmg, freq, band="l")
            return kb if kb is not None else jim_beam(
                llg, mmg, freq, band="l")
        if bt in ("kbuhf", "kb_uhf", "katbeam_uhf"):
            kb = _katbeam_eval(llg, mmg, freq, band="uhf")
            return kb if kb is not None else jim_beam(
                llg, mmg, freq, band="uhf")
        if bt == "cos3":
            return cos3_beam(llg, mmg, freq,
                             dish_diameter=dish_diameter)
        if interp is not None:
            return interp((llg, mmg))
        raise ValueError(f"Unknown beam model {btype}")

    if utime is None:
        return model(ll, mm), l, m

    from pfb_tpu_torch.utils.astrometry import parallactic_angle
    ra, dec = radec
    pas = parallactic_angle(np.atleast_1d(utime), ra, dec, lat,
                            lst0=lst0)
    beam = np.zeros((nx, ny))
    for pa in pas:
        c, s = np.cos(pa), np.sin(pa)
        beam += model(c * ll + s * mm, -s * ll + c * mm)
    return beam / pas.size, l, m


def eval_beam(beam, l_beam, m_beam, l_out, m_out):
    """Resample a beam from its native grid onto image coordinates
    (reference eval_beam, pfb/utils/beam.py:143-154)."""
    interp = RegularGridInterpolator((l_beam, m_beam), beam,
                                     bounds_error=False, fill_value=0.0)
    ll, mm = np.meshgrid(l_out, m_out, indexing="ij")
    return interp((ll, mm))
